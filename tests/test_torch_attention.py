"""The port's serving attention (plain versions) against the JAX package.

Inputs are made with numpy from a seed and handed to both frameworks.  JAX
runs its Pallas flash kernel in interpret mode.  Tolerances: f32 within
1e-5 absolute (the same f32 arithmetic summed in another order); bf16
within 2e-2 relative to the largest output (p is rounded to bf16 against a
running max in the kernel and against the final max in the plain version).
"""

from __future__ import annotations

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubernetes_deep_learning_tpu.ops import attention as jax_attn
from kubernetes_deep_learning_tpu_torch.ops import attention as attn
from torch_threads import one_torch_thread  # noqa: F401

_DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _qkv(seed: int, sq: int, sk: int, dtype: str, d: int = 32):
    """(jax q, k, v), (torch q, k, v): the same bf16/f32 values in both."""
    rng = np.random.default_rng(seed)
    jdt, tdt = _DTYPES[dtype]
    arrs = [rng.normal(0, 1, (2, 2, s, d)).astype(np.float32) for s in (sq, sk, sk)]
    jx = [jnp.asarray(a, jdt) for a in arrs]
    tx = [torch.from_numpy(np.array(a.astype(jnp.float32))).to(tdt) for a in jx]
    return jx, tx


def _check(got: torch.Tensor, want, dtype: str) -> None:
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    else:
        rel = np.abs(got - want).max() / (np.abs(want).max() + 1e-6)
        assert rel < 2e-2, rel


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("seq", [64, 128])
@pytest.mark.parametrize("causal,k_offset", [(False, 0), (True, 0), (True, -64)])
def test_flash_reference_matches_jax_flash(dtype, seq, causal, k_offset):
    (jq, jk, jv), (q, k, v) = _qkv(seq, seq, seq, dtype)
    block = jax_attn.pick_block(seq)
    want = jax_attn.flash_attention(jq, jk, jv, causal=causal, k_offset=k_offset,
                                    block_q=block, block_k=block, interpret=True)
    got = attn.flash_attention(q, k, v, causal=causal, k_offset=k_offset)
    assert got.dtype == q.dtype
    _check(got, want, dtype)
    _check(attn.flash_attention_reference(q, k, v, causal=causal, k_offset=k_offset), want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fully_masked_rows_are_exactly_zero(dtype):
    """k_offset pushes every key into the causal future: 0, not mean(v)."""
    (jq, jk, jv), (q, k, v) = _qkv(7, 64, 64, dtype)
    want = np.asarray(jax_attn.flash_attention(jq, jk, jv, causal=True, k_offset=10_000,
                                               block_q=64, block_k=64, interpret=True),
                      np.float32)
    got = attn.flash_attention(q, k, v, causal=True, k_offset=10_000)
    assert not want.any()
    assert not got.float().numpy().any()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [False, True])
def test_ragged_length_matches_jax_padded(dtype, causal):
    """S = 200 has no 8-aligned divisor <= 256: JAX pads to 256 and masks
    the pad keys with kv_len; the port masks by bounds."""
    (jq, jk, jv), (q, k, v) = _qkv(200, 200, 200, dtype)
    want = jax_attn.flash_attention_padded(jq, jk, jv, causal=causal, interpret=True)
    _check(attn.flash_attention_padded(q, k, v, causal=causal), want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kv_len_masks_keys_like_jax(dtype):
    """Sq != Sk, with the last keys masked by kv_len."""
    (jq, jk, jv), (q, k, v) = _qkv(3, 64, 128, dtype)
    want = jax_attn.flash_attention(jq, jk, jv, kv_len=100, block_q=64, block_k=128,
                                    interpret=True)
    _check(attn.flash_attention(q, k, v, kv_len=100), want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,k_offset", [(False, 0), (True, 0), (True, 16)])
def test_mha_reference_matches_jax(dtype, causal, k_offset):
    (jq, jk, jv), (q, k, v) = _qkv(11, 48, 48, dtype)
    want = jax_attn.mha_reference(jq, jk, jv, causal=causal, k_offset=k_offset)
    got = attn.mha_reference(q, k, v, causal=causal, k_offset=k_offset)
    assert got.dtype == q.dtype
    _check(got, want, dtype)


def test_routing_rule_and_tiling_match_jax():
    assert attn.EINSUM_MAX_SEQ == jax_attn.EINSUM_MAX_SEQ == 512
    assert attn.NEG_INF == jax_attn.NEG_INF
    for sq, sk in ((512, 512), (520, 520), (512, 520), (16, 1024), (576, 576)):
        assert attn.use_einsum_attention(sq, sk) == jax_attn.use_einsum_attention(sq, sk)
    assert attn.use_einsum_attention(512, 512) and not attn.use_einsum_attention(520, 520)
    assert [attn.pick_block(s) for s in range(1, 600)] == [
        jax_attn.pick_block(s) for s in range(1, 600)]


@pytest.mark.parametrize("seq", [64, 520])
def test_attention_serving_matches_jax_on_both_routes(seq):
    """Einsum route at 64 tokens, flash route (plain version on the CPU)
    at 520; the CPU path launches no kernel."""
    (jq, jk, jv), (q, k, v) = _qkv(seq, seq, seq, "bfloat16")
    attn.reset_launch_counts()
    got = attn.attention_serving(q, k, v)
    assert attn.launch_counts() == {"flash_attention": 0, "flash_attention_partials": 0,
                                   "flash_gfold": 0}
    _check(got, jax_attn.attention_serving(jq, jk, jv), "bfloat16")


def test_flash_attention_rejects_bad_operands():
    q = torch.zeros(1, 2, 8, 32)
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        attn.flash_attention(q.half(), q.half(), q.half())
    with pytest.raises(ValueError, match="disagree"):
        attn.flash_attention(q, torch.zeros(1, 3, 8, 32), torch.zeros(1, 3, 8, 32))
    with pytest.raises(ValueError, match="kv_len"):
        attn.flash_attention(q, q, q, kv_len=-1)


@pytest.fixture(scope="module")
def vit_attn_variants():
    """``exp/vit_attn_variants.py``, which holds E5 (``flash_gfold``)."""
    import os
    import sys

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                    "exp"))
    import vit_attn_variants

    return vit_attn_variants


@pytest.mark.parametrize("g", [1, 2, 4])
def test_flash_gfold_matches_jax_gfold(vit_attn_variants, g):
    """(2, 4, 48, 32) bf16: the port's K3G wrapper (its plain version on
    the CPU) against E5 in interpret mode at 16-row tiles; no launch."""
    rng = np.random.default_rng(g)
    jx = [jnp.asarray(rng.normal(0, 1, (2, 4, 48, 32)), jnp.bfloat16) for _ in range(3)]
    q, k, v = (torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16) for a in jx)
    want = vit_attn_variants.flash_gfold(*jx, g=g, block_q=16, block_k=16)
    attn.reset_launch_counts()
    got = attn.flash_gfold(q, k, v, g=g)
    assert attn.launch_counts()["flash_gfold"] == 0
    assert got.dtype == torch.bfloat16
    _check(got, want, "bfloat16")


def test_flash_gfold_rejects_a_fold_that_does_not_divide():
    q = torch.zeros(2, 3, 16, 32, dtype=torch.bfloat16)
    for g in (0, 4, 5, 12):
        with pytest.raises(ValueError, match="g must divide B\\*H = 6"):
            attn.flash_gfold(q, q, q, g=g)
    assert attn.flash_gfold(q, q, q, g=6).shape == q.shape


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 -> tf32, round to nearest with ties away from zero, on the bit
    pattern (what ``cvt.rna.tf32.f32`` computes)."""
    return ((x.view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)


def _matmul_3xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as the f32 kernel forms it: each operand split into
    big = tf32(x) and small = tf32(x - big), and small.big + big.small +
    big.big accumulated in f32 (the small.small term dropped)."""
    a_big, b_big = _tf32(a), _tf32(b)
    a_small, b_small = _tf32(a - a_big), _tf32(b - b_big)
    return torch.matmul(a_small, b_big) + torch.matmul(a_big, b_small) + torch.matmul(a_big, b_big)


def _partials_3xtf32(q, k, v, causal: bool):
    """The f32 kernel's (acc, m, l): 3xTF32 products, the running max in raw
    score units, exponentials as exp2(s * c - m * c) with c = scale *
    log2(e) in f32, l summed from the f32 p."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = _matmul_3xtf32(q, k.transpose(-1, -2))
    if causal:
        rows = torch.arange(q.shape[-2])[:, None]
        s = s.masked_fill(rows < torch.arange(k.shape[-2])[None, :], attn.NEG_INF)
    m = s.amax(dim=-1)
    c = torch.tensor(scale * math.log2(math.e), dtype=torch.float32)
    p = torch.exp2(s * c - (m * c)[..., None])
    return _matmul_3xtf32(p, v), m * torch.tensor(scale, dtype=torch.float32), p.sum(dim=-1)


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-6))


@pytest.mark.parametrize("d,causal", [(32, False), (64, False), (128, False), (32, True),
                                      (128, True)])
def test_3xtf32_partials_keep_the_f32_contract(d, causal):
    """The f32 kernel (K3P) forms its products as 3xTF32 on the tensor
    cores.  Emulated here in torch, its partials at (2, 3, 256, d) stay
    within 1e-5 relative (a tenth of the kernel's 1e-4 tolerance on the
    card) of the exact f32 plain version and of JAX's f32 attend_block."""
    _check_3xtf32(d, causal, std=1.0, tol=1e-5)


def test_3xtf32_partials_at_large_scores():
    """Inputs of std 8 (raw scores ~500): the exponent turns the split's
    ~2^-22 relative error of a score into ~4e-5 of the partials, so the
    emulation is held to the kernel's own 1e-4 here."""
    _check_3xtf32(64, False, std=8.0, tol=1e-4)


def _check_3xtf32(d: int, causal: bool, std: float, tol: float) -> None:
    rng = np.random.default_rng(d + 7 * causal + int(std))
    arrs = [rng.normal(0, std, (2, 3, 256, d)).astype(np.float32) for _ in range(3)]
    q, k, v = (torch.from_numpy(a) for a in arrs)
    got = _partials_3xtf32(q, k, v, causal)
    plain = attn.flash_attention_partials_reference(q, k, v, causal=causal)
    jax_p = jax_attn.attend_block(*(jnp.asarray(a) for a in arrs), causal=causal)
    for g, w, j in zip(got, plain, jax_p):
        assert g.dtype == torch.float32 and g.shape == w.shape
        assert _rel(g, w) < tol
        assert _rel(g, j) < tol
    # One TF32 pass alone would not hold the bound: the split is what does.
    one_pass = torch.matmul(_tf32(q), _tf32(k).transpose(-1, -2))
    assert _rel(one_pass, torch.matmul(q, k.transpose(-1, -2))) > 1e-5
