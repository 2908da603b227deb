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
``test_torch_cuda.py``; here its order of work (row bands with their halo
recomputed, the expanded tile zero outside the image, band sums, the
projection over 64-row tiles gated row by row) is emulated in plain torch
and held against both references within one bf16 ulp of the largest
output (8e-3), with almost every output equal to the port's reference.
"""

from __future__ import annotations

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from kubernetes_deep_learning_tpu.models.efficientnet import MBConvBlock
from kubernetes_deep_learning_tpu.ops import fused_mbconv as jax_ops
from kubernetes_deep_learning_tpu_torch import weights
from kubernetes_deep_learning_tpu_torch.ops import fused_mbconv as ops
from torch_threads import one_torch_thread  # noqa: F401


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


def _gemm(a, b):
    return a.float() @ b.float()


def _banded_block(x, w, rows: int, pad_x: bool = False):
    """The CUDA kernel's order of work in plain torch, with its rounding
    points.  Per band of ``rows`` output rows: the expand over the band's
    input rows with the depthwise halo (clipped to the image) into a tile E
    that is zero outside the image, the depthwise from E, and the band's
    channel sums of the stored bf16 values; the gate from the band sums
    added in band order; then the projection over 64-row tiles of the
    flattened pixels, each row gated with its own image's gate (a tile
    straddles images).  ``pad_x`` pads x with zero rows and columns instead
    of E: the trap, since the expand of a zero pixel is silu(expand_b)."""
    bf = torch.bfloat16
    B, H, W, _ = x.shape
    k = w["dw"].shape[0]
    p = k // 2
    c_mid, c_out = w["expand_w"].shape[1], w["proj_w"].shape[1]

    def expand(t):
        return F.silu(_gemm(t, w["expand_w"]) * w["expand_s"] + w["expand_b"]).to(bf)

    y_dw = torch.empty((B, H, W, c_mid), dtype=bf)
    band_sums = []
    for h0 in range(0, H, rows):
        h1 = min(H, h0 + rows)
        if pad_x:
            xp = F.pad(x, (0, 0, p, p, p, p))
            e = expand(xp[:, h0 : h1 + 2 * p])
        else:
            hh0, hh1 = max(0, h0 - p), min(H, h1 + p)
            e = torch.zeros((B, h1 - h0 + 2 * p, W + 2 * p, c_mid), dtype=bf)
            e[:, hh0 - h0 + p : hh1 - h0 + p, p : p + W] = expand(x[:, hh0:hh1])
        acc = torch.zeros((B, h1 - h0, W, c_mid))
        for a in range(k):
            for b in range(k):
                acc = acc + e[:, a : a + h1 - h0, b : b + W].float() * w["dw"][a, b]
        band = F.silu(acc * w["dw_s"] + w["dw_b"]).to(bf)
        y_dw[:, h0:h1] = band
        band_sums.append(band.float().sum(dim=(1, 2)))
    total = band_sums[0]
    for t in band_sums[1:]:
        total = total + t
    r = F.silu(_gemm((total / (H * W)).to(bf), w["se_r_w"]) + w["se_r_b"])
    g = torch.sigmoid(_gemm(r.to(bf), w["se_e_w"]) + w["se_e_b"])

    flat = y_dw.reshape(B * H * W, c_mid)
    image = torch.arange(B * H * W) // (H * W)
    z = torch.empty((B * H * W, c_out), dtype=bf)
    for m0 in range(0, B * H * W, 64):
        tile = slice(m0, m0 + 64)
        gated = (flat[tile].float() * g[image[tile]]).to(bf)
        z[tile] = (_gemm(gated, w["proj_w"]) * w["proj_s"] + w["proj_b"]).to(bf)
    return x + z.reshape(B, H, W, c_out)


_ONE_ULP = 8e-3  # one bf16 ulp of the largest output, relative to it (<= 2**-7)
_BANDED_CASES = [
    ((3, 10, 10, 232), 1392, 5, 58, 4),  # 64-row tiles straddle images; bands 4, 4, 2
    ((2, 38, 38, 48), 288, 5, 12, 6),    # bands of 6 rows, a ragged last band of 2
]


@pytest.mark.parametrize("shape,c_mid,k,s,rows", _BANDED_CASES, ids=["10x10-232", "38x38-48"])
def test_banded_decomposition_matches_references(shape, c_mid, k, s, rows):
    rng = np.random.default_rng(sum(shape) + rows)
    x_j, x_t = _both(rng.normal(0, 1, shape), jnp.bfloat16)
    wj, wt = _weights(rng, shape[-1], c_mid, shape[-1], k, s)
    got = _banded_block(x_t, wt, rows).float().numpy()
    # The band sums add the same values in another order than either
    # reference's mean, which may move an output by one bf16 ulp: at most
    # 2**-7 of the largest output.  Against the port's reference, whose
    # rounding points the emulation shares, almost every output is equal
    # (measured: 3 of 69,600 and 0 of 138,624 differ).
    want = ops.mbconv_block_reference(x_t, wt).float().numpy()
    assert _rel(got, want) < _ONE_ULP
    assert (got != want).mean() < 1e-3
    assert _rel(got, jax_ops.mbconv_block_reference(x_j, wj)) < _ONE_ULP


def test_banded_decomposition_padding_x_instead_of_e_is_caught():
    """Zero padding of x, not of the expanded activation, gives
    silu(expand_b) at the border: the emulation then misses the reference
    by more than 1e-2 (measured 2.0e-2), so the test above catches it."""
    shape, c_mid, k, s, rows = _BANDED_CASES[1]
    rng = np.random.default_rng(sum(shape) + rows)
    _, x_t = _both(rng.normal(0, 1, shape), jnp.bfloat16)
    _, wt = _weights(rng, shape[-1], c_mid, shape[-1], k, s)
    want = ops.mbconv_block_reference(x_t, wt).float().numpy()
    assert _rel(_banded_block(x_t, wt, rows, pad_x=True).float().numpy(), want) > 1e-2


def test_ablation_script_finds_the_lines_it_ablates():
    """``mbconv_ablation.py`` edits the CUDA source by text: every ablation
    must still find its lines, so that it measures what it names."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "mbconv_ablation", os.path.join(root, "mbconv_ablation.py"))
    ablation = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ablation)
    with open(os.path.join(root, "kubernetes_deep_learning_tpu_torch", "ops", "csrc",
                           "fused_mbconv.cu")) as f:
        src = f.read()
    variants = ablation._variants(src)
    assert variants["kernel"] == (src, "")
    for name, (text, launch) in variants.items():
        if name != "kernel":
            assert text != src and launch in ablation.LAUNCHES, name
