"""The port's partials form and differentiable attention against the JAX
package, on the CPU.

Inputs are made with numpy from a seed and handed to both frameworks.
JAX runs its partials kernel (``flash_attention(return_partials=True)``)
in Pallas interpret mode; the port runs the kernel's plain version,
``flash_attention_partials_reference``.  Tolerances: f32 within 1e-5
absolute (the same f32 arithmetic summed in another order); bf16 within
2e-2 relative to the largest value (p is rounded to bf16 against a running
max in the Pallas kernel and against the final max in the plain version).
``attention_trainable``: values within 1e-5 and gradients within 1e-4
absolute, the tolerances of ``tests/test_attention_trainable.py``.

A row that no key is visible to has the partials ``(0, NEG_INF, 0)`` in
the port, while JAX's kernel leaves ``l`` counting the masked keys of the
tiles it visited (a number that depends on its 128-wide tiles, and that
the card's 64-wide tiles would not reproduce).  So ``(acc, m, l)`` are
compared on rows with a visible key only, and the port's empty partial is
checked to be neutral in ``combine_partials`` and 0 after
``finalize_partials``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubernetes_deep_learning_tpu.ops import attention as jax_attn
from kubernetes_deep_learning_tpu_torch.ops import attention as attn
from torch_threads import one_torch_thread  # noqa: F401

_DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _arrays(seed: int, shapes, dtype: str = "float32"):
    """(jax arrays, torch tensors) holding the same bf16/f32 values."""
    rng = np.random.default_rng(seed)
    jdt, tdt = _DTYPES[dtype]
    jx = [jnp.asarray(rng.normal(0, 1, s).astype(np.float32), jdt) for s in shapes]
    tx = [torch.from_numpy(np.array(a.astype(jnp.float32))).to(tdt) for a in jx]
    return jx, tx


def _close(got: torch.Tensor, want, dtype: str) -> None:
    got, want = got.float().numpy(), np.asarray(want, np.float32)
    assert got.shape == want.shape
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    else:
        rel = np.abs(got - want).max() / (np.abs(want).max() + 1e-6)
        assert rel < 2e-2, rel


# (sq, sk, d, causal, k_offset, kv_len): non-causal, causal, kv_len,
# cross-attention sq != sk, rows with no visible key, head dims 32 and 64.
_CASES = [
    (64, 64, 32, False, 0, None),
    (128, 128, 64, True, 0, None),
    (64, 128, 32, False, 0, 100),
    (128, 64, 64, False, 0, None),
    (64, 64, 32, True, 32, None),  # rows 0..31 see no key
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sq,sk,d,causal,k_offset,kv_len", _CASES)
def test_partials_reference_matches_jax_partials_kernel(dtype, sq, sk, d, causal, k_offset,
                                                        kv_len):
    (jq, jk, jv), (q, k, v) = _arrays(sq * sk + d, [(2, 2, sq, d), (2, 2, sk, d),
                                                    (2, 2, sk, d)], dtype)
    want = jax_attn.flash_attention(
        jq, jk, jv, causal=causal, k_offset=k_offset, kv_len=kv_len,
        block_q=jax_attn.pick_block(sq), block_k=jax_attn.pick_block(sk),
        interpret=True, return_partials=True)
    attn.reset_launch_counts()
    got = attn.flash_attention(q, k, v, causal=causal, k_offset=k_offset, kv_len=kv_len,
                               return_partials=True)
    assert attn.launch_counts() == {"flash_attention": 0, "flash_attention_partials": 0,
                                   "flash_gfold": 0}
    assert [t.dtype for t in got] == [torch.float32] * 3
    assert got[0].shape == (2, 2, sq, d) and got[1].shape == got[2].shape == (2, 2, sq)
    live = np.arange(sq) >= k_offset if causal else np.ones(sq, bool)
    for g, w in zip(got, want):
        _close(g[:, :, live], np.asarray(w)[:, :, live], dtype)
    acc, m, l = (t[:, :, ~live] for t in got)
    assert not acc.any() and not l.any() and bool((m == attn.NEG_INF).all())
    # The normalised output is the fused kernel's, 0 on the empty rows.
    fused = attn.flash_attention(q, k, v, causal=causal, k_offset=k_offset, kv_len=kv_len)
    _close(attn.finalize_partials(got).to(q.dtype), np.asarray(
        jax_attn.flash_attention(jq, jk, jv, causal=causal, k_offset=k_offset, kv_len=kv_len,
                                 block_q=jax_attn.pick_block(sq),
                                 block_k=jax_attn.pick_block(sk), interpret=True),
        np.float32), dtype)
    _close(attn.finalize_partials(got).to(q.dtype), fused.float().numpy(), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,k_offset", [(False, 0), (True, 0), (True, -32)])
def test_attend_block_combine_finalize_match_jax(dtype, causal, k_offset):
    """Partials of two KV halves, merged and normalised: each step against
    JAX, and the result against plain softmax attention."""
    (jq, jk, jv), (q, k, v) = _arrays(5, [(2, 2, 48, 32), (2, 2, 64, 32), (2, 2, 64, 32)],
                                      dtype)
    halves = []
    for lo, hi in ((0, 32), (32, 64)):
        want = jax_attn.attend_block(jq, jk[:, :, lo:hi], jv[:, :, lo:hi], causal=causal,
                                     k_offset=k_offset + lo)
        got = attn.attend_block(q, k[:, :, lo:hi], v[:, :, lo:hi], causal=causal,
                                k_offset=k_offset + lo)
        for g, w in zip(got, want):
            _close(g, w, dtype)
        halves.append((got, want))
    (ga, wa), (gb, wb) = halves
    merged, want = attn.combine_partials(ga, gb), jax_attn.combine_partials(wa, wb)
    for g, w in zip(merged, want):
        _close(g, w, dtype)
    _close(attn.finalize_partials(merged), jax_attn.finalize_partials(want), dtype)
    full = attn.mha_reference(q.float(), k.float(), v.float(), causal=causal, k_offset=k_offset)
    _close(attn.finalize_partials(merged), full.numpy(), dtype)


def test_empty_partial_is_neutral_and_finalizes_to_zero():
    """The port's partial of a row with no visible key, (0, NEG_INF, 0),
    merged with any real partial gives that partial back exactly."""
    _, (q, k, v) = _arrays(3, [(1, 2, 16, 32), (1, 2, 16, 32), (1, 2, 16, 32)])
    empty = attn.flash_attention(q, k, v, causal=True, k_offset=1_000, return_partials=True)
    assert not attn.finalize_partials(empty).any()
    real = attn.flash_attention(q, k, v, return_partials=True)
    for merged in (attn.combine_partials(empty, real), attn.combine_partials(real, empty)):
        for g, w in zip(merged, real):
            assert torch.equal(g, w)


def _jax_loss(fn, cot, causal):
    if cot is None:
        return lambda q, k, v: jnp.sum(fn(q, k, v, causal=causal) ** 2)
    return lambda q, k, v: jnp.sum(fn(q, k, v, causal=causal) * cot)


@pytest.mark.parametrize("sq,sk,d,causal,squared", [
    (32, 32, 16, False, False),
    (32, 32, 16, True, False),
    (32, 16, 8, False, True),    # cross-attention: each side tiles on its own
    (12, 12, 8, False, True),    # untiled: the attend_block forward, one KV block
    (24, 24, 32, True, True),    # causal, 2-D tiled backward (blocks of 8)
    (64, 64, 32, True, False),
])
def test_attention_trainable_matches_jax_values_and_grads(sq, sk, d, causal, squared):
    shapes = [(2, 3, sq, d), (2, 3, sk, d), (2, 3, sk, d), (2, 3, sq, d)]
    (jq, jk, jv, jcot), (q, k, v, cot) = _arrays(sq + sk + d, shapes)
    jcot = None if squared else jcot
    want = jax_attn.attention_trainable(jq, jk, jv, causal)
    jgrads = jax.grad(_jax_loss(jax_attn.attention_trainable, jcot, causal),
                      argnums=(0, 1, 2))(jq, jk, jv)
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    out = attn.attention_trainable(q, k, v, causal)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), rtol=0, atol=1e-5)
    loss = (out ** 2).sum() if squared else (out * cot).sum()
    loss.backward()
    for t, w, name in zip((q, k, v), jgrads, "qkv"):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), rtol=0, atol=1e-4,
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("causal", [False, True])
def test_attention_trainable_matches_autograd_through_plain_attention(causal):
    """Against torch's own autograd through ``mha_reference``, with q, k, v
    given as strided (B, S, H, D) views, as the ViT hands them over."""
    _, (q, k, v, cot) = _arrays(21, [(2, 64, 3, 32)] * 3 + [(2, 3, 64, 32)])
    leaves = [t.requires_grad_() for t in (q, k, v)]
    grads = []
    for fn in (attn.attention_trainable, attn.mha_reference):
        views = [t.transpose(1, 2) for t in leaves]
        out = fn(*views, causal=causal)
        grads.append((out, torch.autograd.grad((out * cot).sum(), leaves)))
    (out, g), (want, g_want) = grads
    torch.testing.assert_close(out, want, rtol=0, atol=1e-5)
    for a, b in zip(g, g_want):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-4)


def test_trainable_forward_routes_like_jax(monkeypatch):
    """Both sequences tileable: the partials form; else attend_block."""
    calls = []
    plain = attn.flash_attention_partials_reference
    monkeypatch.setattr(attn, "flash_attention_partials_reference",
                        lambda *a, **kw: calls.append(1) or plain(*a, **kw))
    _, (q, k, v) = _arrays(0, [(1, 2, 16, 8)] * 3)
    attn.attention_trainable(q, k, v)
    assert calls == [1]
    _, (q, k, v) = _arrays(0, [(1, 2, 12, 8)] * 3)
    attn.attention_trainable(q, k, v)
    assert calls == [1]
