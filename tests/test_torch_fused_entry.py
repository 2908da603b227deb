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
``test_torch_cuda.py``; here its order of work is emulated on the CPU
(strips with column halos, segments with warm-up rows, rolling rows of b
and c, the border masks, the -inf pool taps, r from b's even pixels) and
held against both references.
"""

from __future__ import annotations

import importlib.util
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubernetes_deep_learning_tpu.ops import fused_entry as jax_entry
from kubernetes_deep_learning_tpu_torch import weights
from kubernetes_deep_learning_tpu_torch.models.layers import same_pads
from kubernetes_deep_learning_tpu_torch.ops import fused_entry as ops

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "exp"))
import fused_entry as e4  # noqa: E402  (exp/fused_entry.py, the B6 prototype)
from torch_threads import one_torch_thread  # noqa: F401

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


_SLOTS = 64  # K5's column slots a row: one wgmma M


def _walk(x, w, p_cols: int, r_rows: int, masks: bool = True):
    """K5's walk (``csrc/fused_entry.cu``) in plain torch on the CPU, in the
    kernel's order and at its rounding points: for each strip of ``p_cols``
    output columns and segment of ``r_rows`` output rows, sub-step k makes
    b row k + 2 (conv2 over 64 column slots), c row k + 1 and d row k,
    starting four sub-steps early; b and c live in rings of three rows,
    d's pool-window max is carried row to row, r of output row i is taken
    at sub-step 2i from b row 2i's even slots.  ``masks=False`` leaves b and
    c outside the image as computed (relu of the shift) instead of 0."""
    bf = torch.bfloat16
    n_img, h, wd, c_in = x.shape
    h_b, w_b = h - 2, wd - 2
    h_o, w_o = (h_b + 1) // 2, (w_b + 1) // 2
    pt, pl = same_pads(h_b, 3, 2)[0], same_pads(w_b, 3, 2)[0]
    c_out = w["pw1"].shape[1]
    top, lead = 8, 4  # zero rows and columns around x: the kernel's zero fill
    xp = torch.zeros((n_img, h + 2 * top, wd + lead + _SLOTS + 8, c_in), dtype=bf)
    xp[:, top : top + h, lead : lead + wd] = x
    slots = torch.arange(_SLOTS)

    def gemm(a, m, s, t):
        return a.float() @ w[m].float() * w[s] + w[t]

    def depthwise(rows, taps):
        padded = [torch.nn.functional.pad(r, (0, 0, 1, 1)) for r in rows]  # slots -1, 64 read 0
        acc = torch.zeros(rows[0].shape)
        for a in range(3):
            for b in range(3):
                acc = acc + padded[a][:, b : b + _SLOTS].float() * taps[a, b]
        return acc.to(bf)

    out = torch.empty((n_img, h_o, w_o, c_out), dtype=bf)
    for j0 in range(0, w_o, p_cols):
        pj = min(p_cols, w_o - j0)
        cb0 = 2 * j0 - pl - 2  # the image column of slot 0
        col_ok = ((cb0 + slots >= 0) & (cb0 + slots < w_b))[None, :, None]
        for i0 in range(0, h_o, r_rows):
            i1 = min(h_o, i0 + r_rows)
            d0 = 2 * i0 - pt
            b_ring, c_ring, vm, r = {}, {}, None, None
            for k in range(d0 - 4, 2 * (i1 - 1) - pt + 3):
                kb = k + 2
                patches = torch.cat([xp[:, top + kb + dh, lead + cb0 + dw : lead + cb0 + dw + _SLOTS]
                                     for dh in range(3) for dw in range(3)], dim=-1)
                b = torch.relu(gemm(patches, "conv2", "conv2_s", "conv2_b")).to(bf)
                if masks:
                    b = torch.where(col_ok & (0 <= kb < h_b), b, torch.zeros((), dtype=bf))
                b_ring[kb % 3] = b
                if k >= d0 - 2:
                    kc = k + 1
                    c = depthwise([b_ring[(kc + e) % 3] for e in (-1, 0, 1)], w["dw1"])
                    c = torch.relu(gemm(c, "pw1", "bn1_s", "bn1_b")).to(bf)
                    if masks:
                        c = torch.where(col_ok & (0 <= kc < h_b), c, torch.zeros((), dtype=bf))
                    c_ring[kc % 3] = c
                if k < d0:
                    continue
                d = depthwise([c_ring[(k + e) % 3] for e in (-1, 0, 1)], w["dw2"])
                d = gemm(d, "pw2", "bn2_s", "bn2_b").to(bf)
                d = torch.where(col_ok & (0 <= k < h_b), d, torch.full((), float("-inf"), dtype=bf))
                first = (k - d0) % 2 == 0
                if first and k > d0:  # output row i: the pool's three rows are in
                    i = (k + pt - 2) // 2
                    pooled = torch.maximum(vm, d)
                    idx = 2 + 2 * torch.arange(pj)
                    m = torch.maximum(torch.maximum(pooled[:, idx], pooled[:, idx + 1]),
                                      pooled[:, idx + 2])
                    out[:, i, j0 : j0 + pj] = (m.float() + r[:, :pj].float()).to(bf)
                vm = d if first else torch.maximum(vm, d)
                if k % 2 == 0 and 2 * i0 <= k < 2 * i1:  # r of output row k / 2
                    s = 2 + pl + 2 * slots  # b column 2 * (j0 + jj)
                    a = torch.where((s < _SLOTS)[None, :, None], b_ring[k % 3][:, s.clamp(max=63)],
                                    torch.zeros((), dtype=bf))
                    r = gemm(a, "res", "res_s", "res_b").to(bf)
    return out


# (batch, H, W, C_in, C_b, C_out, strip columns, segment rows)
_WALKS = [
    (2, 23, 23, 8, 16, 32, 4, 3),   # odd sides: strips 4, 4, 3; segments 3, 3, 3, 2
    (2, 24, 19, 8, 16, 32, 5, 4),   # even h_b (no leading pool pad), odd w_b
    (1, 9, 9, 8, 16, 32, 29, 4),    # a single strip and segment
    (2, 23, 24, 8, 16, 32, 5, 2),   # even w_b, a last strip of one output column
    (1, 20, 21, 16, 24, 40, 6, 1),  # segments of one output row; K and N tails
    (1, 41, 41, 32, 64, 128, 29, 7),  # Xception's widths, the kernel's widest strip
]


@pytest.mark.parametrize("case", _WALKS, ids=lambda c: "x".join(map(str, c)))
def test_walk_matches_references(case):
    batch, h, wd, c_in, c_b, c_out, p_cols, r_rows = case
    rng = np.random.default_rng(sum(case))
    w_j, w_t = _weights(_random_weights(rng, c_in, c_b, c_out))
    x_j, x_t = _input(rng, (batch, h, wd, c_in))
    got = _walk(x_t, w_t, p_cols, r_rows).float().numpy()
    assert got.shape == (batch, (h - 1) // 2, (wd - 1) // 2, c_out)
    # The walk rounds where the port's reference does and differs only in
    # the GEMMs' row counts (measured: no output differs).
    want = ops.entry_block_reference(x_t, w_t).float().numpy()
    assert _rel(got, want) < 2e-2
    assert (got != want).mean() < 1e-3
    assert _rel(got, jax_entry.entry_block_reference(x_j, w_j)) < 2e-2


def test_walk_without_border_masks_is_caught():
    """b and c left at relu(shift) outside the image, instead of 0, reach
    the depthwise's SAME padding: the walk then misses the reference by
    more than 2e-2 (measured 4.5e-2; 3.7e-2 to 1.2e-1 over the cases
    above), so the test above would catch a kernel that forgot the
    masks."""
    batch, h, wd, c_in, c_b, c_out, p_cols, r_rows = _WALKS[0]
    rng = np.random.default_rng(sum(_WALKS[0]))
    _, w_t = _weights(_random_weights(rng, c_in, c_b, c_out))
    _, x_t = _input(rng, (batch, h, wd, c_in))
    want = ops.entry_block_reference(x_t, w_t).float().numpy()
    assert _rel(_walk(x_t, w_t, p_cols, r_rows).float().numpy(), want) < 2e-2
    assert _rel(_walk(x_t, w_t, p_cols, r_rows, masks=False).float().numpy(), want) > 2e-2


def test_ablation_script_finds_the_lines_it_ablates():
    """``entry_ablation.py`` edits the CUDA source by text: every ablation
    must still find its lines, so that it measures what it names."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "entry_ablation", os.path.join(root, "entry_ablation.py"))
    ablation = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ablation)
    with open(os.path.join(root, "kubernetes_deep_learning_tpu_torch", "ops", "csrc",
                           "fused_entry.cu")) as f:
        src = f.read()
    variants = ablation._variants(src)
    assert variants["kernel"] == src
    assert all(text != src for name, text in variants.items() if name != "kernel")
