"""The port's fused MBConv block against the JAX package's.

On the CPU the port's wrapper computes its plain PyTorch version; it is
held against the JAX reference (``mbconv_block_reference``, < 1e-2
relative: the same rounding points, f32 sums in another order) and against
the Pallas kernel in interpret mode (< 2e-2 relative, the JAX tests'
tolerance: the Pallas body keeps the depthwise output in f32 through the
squeeze-excite and the gate, where the reference rounds it to bf16), on
the same numpy-made inputs.  The JAX reference has no ``residual=False``
form, so the stage-opener case is held against the Pallas kernel only.
The CUDA kernel itself is held against the plain version in
``test_torch_cuda.py``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubernetes_deep_learning_tpu.models.efficientnet import MBConvBlock
from kubernetes_deep_learning_tpu.ops import fused_mbconv as jax_ops
from kubernetes_deep_learning_tpu_torch import weights
from kubernetes_deep_learning_tpu_torch.ops import fused_mbconv as ops


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-6))


def _both(a: np.ndarray, dtype) -> tuple[jax.Array, torch.Tensor]:
    """The same values for both frameworks (bf16 rounded once, by JAX)."""
    j = jnp.asarray(a, dtype)
    t = torch.from_numpy(np.array(j, np.float32))
    return j, (t.to(torch.bfloat16) if dtype == jnp.bfloat16 else t)


def _weights(rng, c_in, c_mid, c_out, k, s):
    """Random block weights, as the JAX test's ``_random_weights`` makes them."""
    normal = lambda *shape: rng.normal(0, 0.15, shape)  # noqa: E731
    unit = lambda n: rng.uniform(0.8, 1.2, n)  # noqa: E731
    arrays = {
        "expand_w": (normal(c_in, c_mid), jnp.bfloat16),
        "expand_s": (unit(c_mid), jnp.float32),
        "expand_b": (normal(c_mid), jnp.float32),
        "dw": (normal(k, k, c_mid), jnp.float32),
        "dw_s": (unit(c_mid), jnp.float32),
        "dw_b": (normal(c_mid), jnp.float32),
        "se_r_w": (normal(c_mid, s), jnp.bfloat16),
        "se_r_b": (normal(s), jnp.float32),
        "se_e_w": (normal(s, c_mid), jnp.bfloat16),
        "se_e_b": (normal(c_mid), jnp.float32),
        "proj_w": (normal(c_mid, c_out), jnp.bfloat16),
        "proj_s": (unit(c_out), jnp.float32),
        "proj_b": (normal(c_out), jnp.float32),
    }
    pairs = {key: _both(a, dt) for key, (a, dt) in arrays.items()}
    return {key: j for key, (j, _) in pairs.items()}, {key: t for key, (_, t) in pairs.items()}


@pytest.mark.parametrize(
    "shape,c_mid,c_out,k,s,residual",
    [
        ((2, 6, 6, 32), 96, 32, 3, 8, True),      # k=3
        ((1, 5, 7, 40), 240, 40, 5, 10, True),    # k=5, batch 1, 40 = 8 x 5
        ((3, 6, 6, 24), 144, 24, 3, 6, True),     # batch 3, B0's S = 6
        ((3, 4, 4, 136), 816, 136, 5, 17, True),  # odd S, B3's widths
        ((2, 5, 5, 48), 288, 56, 5, 12, False),   # stage opener: C_out != C_in
    ],
    ids=["k3", "k5-b1-w40", "b3-s6", "odd-s", "opener"],
)
def test_block_matches_jax(shape, c_mid, c_out, k, s, residual):
    rng = np.random.default_rng(sum(shape) + k)
    x_j, x_t = _both(rng.normal(0, 1, shape), jnp.bfloat16)
    wj, wt = _weights(rng, shape[-1], c_mid, c_out, k, s)
    got = ops.fused_mbconv_block(x_t, wt, residual=residual)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (*shape[:3], c_out)
    got = got.float().numpy()
    if residual:
        assert _rel(got, jax_ops.mbconv_block_reference(x_j, wj)) < 1e-2
    kernel = jax.jit(lambda x: jax_ops.fused_mbconv_block(x, wj, residual=residual, interpret=True))
    assert _rel(got, kernel(x_j)) < 2e-2


def test_mbconv_block_weights_match_jax():
    """Weight extraction from a flax MBConvBlock's variables (non-trivial
    BN statistics), and the port's block on them against the flax block."""
    rng = np.random.default_rng(2)
    c = 40
    block = MBConvBlock(features=c, expand_ratio=6, kernel=5, strides=1,
                        se_features=max(1, c // 4), dtype=jnp.bfloat16, name="blk")
    x0 = rng.normal(0, 1, (2, 6, 6, c)).astype(np.float32)
    variables = jax.tree_util.tree_map(
        np.asarray, block.init(jax.random.PRNGKey(0), jnp.asarray(x0), train=False))
    stats = jax.tree_util.tree_map(
        lambda a: rng.uniform(0.5, 1.5, a.shape).astype(np.float32), variables["batch_stats"])
    variables = {"params": variables["params"], "batch_stats": stats}

    want = jax_ops.mbconv_block_weights({"blk": variables["params"]}, {"blk": stats}, "blk")
    params = weights.from_jax_variables(
        {"params": {"blk": variables["params"]}, "batch_stats": {"blk": stats}})
    got = weights.mbconv_block_weights(params, "blk")
    assert set(got) == set(want)
    for key, g in got.items():
        assert g.dtype == (torch.bfloat16 if key.endswith("_w") else torch.float32), key
        assert g.is_contiguous()
        np.testing.assert_allclose(g.float().numpy(), np.asarray(want[key], np.float32),
                                   rtol=1e-6, atol=1e-7, err_msg=key)

    x_j, x_t = _both(x0, jnp.bfloat16)
    flax_out = block.apply(variables, x_j, train=False)
    assert _rel(ops.fused_mbconv_block(x_t, got).float().numpy(), flax_out) < 2e-2


@pytest.mark.parametrize("h", [2, 10, 19, 38, 75, 150])
@pytest.mark.parametrize("c_mid", [96, 144, 288, 576, 1392, 2304])
def test_fusible_rule_is_the_jax_packages(h, c_mid):
    assert ops.fusible_as_in_jax(h, h, c_mid) == jax_ops.mbconv_fusible(h, h, c_mid)


def test_cpu_path_does_not_count_launches():
    rng = np.random.default_rng(3)
    _, x = _both(rng.normal(0, 1, (1, 4, 4, 16)), jnp.bfloat16)
    _, w = _weights(rng, 16, 64, 16, 3, 4)
    ops.reset_launch_counts()
    ops.fused_mbconv_block(x, w)
    assert ops.launch_counts() == {"fused_mbconv_block": 0}


def test_wrapper_rejects_bad_operands():
    rng = np.random.default_rng(4)
    _, x = _both(rng.normal(0, 1, (1, 4, 4, 16)), jnp.bfloat16)
    _, w = _weights(rng, 16, 64, 24, 3, 4)
    with pytest.raises(ValueError, match="bfloat16"):
        ops.fused_mbconv_block(x.float(), w, residual=False)
    with pytest.raises(ValueError, match="C_out == C_in"):
        ops.fused_mbconv_block(x, w)
    with pytest.raises(ValueError, match="dw must be"):
        ops.fused_mbconv_block(x, {**w, "dw": w["dw"][:, :, :32]}, residual=False)
    with pytest.raises(ValueError, match="se_e_w must be"):
        ops.fused_mbconv_block(x, {**w, "se_e_w": w["se_e_w"].float()}, residual=False)
    with pytest.raises(ValueError, match="keys"):
        ops.fused_mbconv_block(x, {k: v for k, v in w.items() if k != "proj_b"}, residual=False)
