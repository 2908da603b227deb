"""The port's fused Xception entry segment (conv2 + block2) against the JAX
package's.

On the CPU the port's wrapper computes its plain PyTorch version.  It is
held against JAX's ``entry_block_reference``, the Pallas kernel
``fused_entry_block_t`` in interpret mode (batch padded to 8, as its
callers do), and the prototype in ``exp/fused_entry.py`` at Xception's own
geometry, on the same numpy-made inputs, with the JAX tests' tolerance
(rel < 2e-2: the port rounds where the Pallas body does, JAX's reference
also rounds the depthwise weights to bf16, and sums run in other orders).
The CUDA kernel itself is held against the plain version in
``test_torch_cuda.py``.
"""

from __future__ import annotations

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubernetes_deep_learning_tpu.ops import fused_entry as jax_entry
from kubernetes_deep_learning_tpu_torch import weights
from kubernetes_deep_learning_tpu_torch.ops import fused_entry as ops

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "exp"))
import fused_entry as e4  # noqa: E402  (exp/fused_entry.py, the B6 prototype)

_BF16_KEYS = ("conv2", "res", "pw1", "pw2")  # GEMM operands: bf16 in both kernels


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-6))


def _weights(w_np: dict) -> tuple[dict, dict]:
    """JAX's f32 weight dict and the port's kernel-ready one, on the same
    values: the GEMM operands are rounded to bf16 first, so both kernels
    multiply the same numbers."""
    w_np = dict(w_np)
    for k in _BF16_KEYS:
        w_np[k] = np.asarray(jnp.asarray(w_np[k], jnp.bfloat16), np.float32)
    w_j = {k: jnp.asarray(v) for k, v in w_np.items()}
    w_t = {k: torch.from_numpy(np.array(v, np.float32)) for k, v in w_np.items()}
    w_t["conv2"] = w_t["conv2"].reshape(-1, w_np["conv2"].shape[-1])
    for k in _BF16_KEYS:
        w_t[k] = w_t[k].to(torch.bfloat16).contiguous()
    return w_j, w_t


def _random_weights(rng, c_in, c_b, c_out) -> dict:
    """The JAX test's weight distributions (tests/test_fused_sepconv.py)."""
    f = np.float32
    return {
        "conv2": rng.normal(0, 0.2, (3, 3, c_in, c_b)).astype(f),
        "conv2_s": rng.uniform(0.8, 1.2, c_b).astype(f),
        "conv2_b": rng.normal(0, 0.1, c_b).astype(f),
        "res": rng.normal(0, 0.1, (c_b, c_out)).astype(f),
        "res_s": rng.uniform(0.8, 1.2, c_out).astype(f),
        "res_b": rng.normal(0, 0.1, c_out).astype(f),
        "dw1": rng.normal(0, 0.2, (3, 3, c_b)).astype(f),
        "pw1": rng.normal(0, 0.1, (c_b, c_out)).astype(f),
        "bn1_s": rng.uniform(0.8, 1.2, c_out).astype(f),
        "bn1_b": rng.normal(0, 0.1, c_out).astype(f),
        "dw2": rng.normal(0, 0.2, (3, 3, c_out)).astype(f),
        "pw2": rng.normal(0, 0.1, (c_out, c_out)).astype(f),
        "bn2_s": rng.uniform(0.8, 1.2, c_out).astype(f),
        "bn2_b": rng.normal(0, 0.1, c_out).astype(f),
    }


def _input(rng, shape) -> tuple[jax.Array, torch.Tensor]:
    """The same bf16 values for both frameworks."""
    j = jnp.asarray(rng.normal(0, 0.5, shape), jnp.bfloat16)
    return j, torch.from_numpy(np.asarray(j, np.float32)).to(torch.bfloat16)


# The JAX test's geometry: h_in 23 -> h_b 21 -> h_out 11 (a final partial
# row tile at rt=4), widths 8 -> 16 -> 32.
_SMALL = (23, 8, 16, 32)


@pytest.fixture(scope="module")
def small_weights():
    return _weights(_random_weights(np.random.default_rng(3), *_SMALL[1:]))


@pytest.mark.parametrize("jax_form", ["reference", "pallas_interpret"])
@pytest.mark.parametrize("batch", [1, 2, 3, 8])
def test_entry_block_matches_jax(small_weights, batch, jax_form):
    w_j, w_t = small_weights
    h_in, c_in, _, c_out = _SMALL
    x_j, x_t = _input(np.random.default_rng(batch), (batch, h_in, h_in, c_in))
    plain = ops.entry_block_reference(x_t, w_t)
    got = ops.fused_entry_block(x_t, w_t)
    assert got.dtype == torch.bfloat16 and got.shape == (batch, 11, 11, c_out)
    assert torch.equal(got, plain)
    if jax_form == "reference":
        want = jax_entry.entry_block_reference(x_j, w_j)
    else:
        pad = (-batch) % 8
        x_pad = jnp.pad(x_j, ((0, pad), (0, 0), (0, 0), (0, 0))).transpose(1, 2, 0, 3)
        want = jax.jit(lambda xt: jax_entry.fused_entry_block_t(xt, w_j, rt=4, interpret=True))(
            x_pad).transpose(2, 0, 1, 3)[:batch]
    assert _rel(got.float().numpy(), want) < 2e-2


def test_entry_block_matches_prototype_at_xception_geometry():
    """Batch 1 at 149x149x32 -> 74x74x128 against E4's reference and its
    Pallas kernel in interpret mode (one 37-row tile pair)."""
    rng = np.random.default_rng(0)
    w_j, w_t = _weights({k: np.asarray(v) for k, v in e4.make_weights(rng).items()})
    x_j, x_t = _input(rng, (1, e4.H_IN, e4.H_IN, e4.C_IN))
    got = ops.fused_entry_block(x_t, w_t)
    assert got.shape == (1, e4.H_OUT, e4.H_OUT, e4.C_OUT)
    want_ref = e4.entry_ref(x_j, w_j)
    assert _rel(got.float().numpy(), want_ref) < 2e-2
    want_kernel = jax.jit(lambda xt: e4.fused_entry(xt, w_j, rt=37, interpret=True))(
        x_j.transpose(1, 2, 0, 3)).transpose(2, 0, 1, 3)
    assert _rel(got.float().numpy(), want_kernel) < 2e-2


def test_entry_block_weights_match_jax():
    from kubernetes_deep_learning_tpu_torch.modelspec import ModelSpec
    from kubernetes_deep_learning_tpu_torch.models import init_variables

    spec = ModelSpec(name="w", family="xception", input_shape=(96, 96, 3), labels=("a", "b"))
    v = init_variables(spec, seed=7)
    want = jax_entry.entry_block_weights(v["params"], v["batch_stats"])
    got = weights.entry_block_weights(weights.from_jax_variables(v))
    assert sorted(got) == sorted(want) == sorted(ops.WEIGHT_KEYS)
    assert got["conv2"].shape == (9 * 32, 64) and got["res"].shape == (64, 128)
    for k, g in got.items():
        w = np.asarray(want[k], np.float32)
        if k in _BF16_KEYS:
            assert g.dtype == torch.bfloat16
            w = np.asarray(jnp.asarray(w, jnp.bfloat16), np.float32)
        else:
            assert g.dtype == torch.float32
        assert g.is_contiguous()
        np.testing.assert_allclose(g.float().numpy(), w.reshape(g.shape), rtol=1e-6, atol=1e-6)


def test_wrapper_rejects_bad_operands(small_weights):
    _, w = small_weights
    _, x = _input(np.random.default_rng(4), (1, 23, 23, 8))
    with pytest.raises(ValueError, match="bfloat16"):
        ops.fused_entry_block(x.float(), w)
    with pytest.raises(ValueError, match="H, W >= 3"):
        ops.fused_entry_block(x[:, :2], w)
    with pytest.raises(ValueError, match="conv2 must be"):
        ops.fused_entry_block(x[..., :4].contiguous(), w)
    with pytest.raises(ValueError, match="pw2 must be"):
        ops.fused_entry_block(x, {**w, "pw2": w["pw2"].float()})
    with pytest.raises(ValueError, match="dw1 must be"):
        ops.fused_entry_block(x, {**w, "dw1": w["dw1"][:2]})
    with pytest.raises(ValueError, match="missing weights"):
        ops.fused_entry_block(x, {k: t for k, t in w.items() if k != "res_b"})


def test_cpu_path_does_not_count_launches(small_weights):
    _, w = small_weights
    _, x = _input(np.random.default_rng(5), (2, 23, 23, 8))
    ops.reset_launch_counts()
    ops.fused_entry_block(x, w)
    assert ops.launch_counts() == {"fused_entry_block": 0}
