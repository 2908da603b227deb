"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: these skip where there is no GPU (a CUDA kernel has no CPU
mode).  The file imports no JAX, so it also runs on a GPU machine without
it:  ``python -m pytest tests/test_torch_cuda.py -q``.  Tolerance: relative
max error < 2e-2 for bf16 (bf16 roundings of the same values, summed in
another order), < 1e-4 for the f32 flash-attention kernels, fused (K3)
and partials (K3P), and for the differentiable attention built on K3P
(f32 sums in another order, a fast exponential).  The MBConv kernel is
held at 2e-2 at every fused block shape of EfficientNet-B3 (300 px) and
B0 (224 px), at batch 17, at inputs of std 4, and replayed from a CUDA
graph bit-equal to its eager call; the entry-segment kernel (K5) at Xception's geometry
(batches 1, 3, 16 and 17, an even side of 150), a small ragged one,
with segments of one output row, and replayed from a CUDA graph
bit-equal to its eager call; the stage kernel at the entry path's block
3 and 4 shapes, and the (batch, head)-folded flash attention (K3G), all
at 2e-2.  The stage kernel is also held on a wide image (147x147, 64 and
128 channels), block14's 1536-wide
panel, bucket 1's N-split grid and an odd batch with the residual, and
must refuse a width that is not a multiple of 8 and an unaligned input.
The flash kernels (bf16 TMA + wgmma, f32 3xTF32) are held at head dims
32, 64 and 128, at 1, 192, 576 and 577 query rows (both sides of every
q-tile), on strided (B, S, H, D) views, and in f32 at inputs of std 8,
whose large scores stress the 3xTF32 split (still 1e-4).
The engine's dispatch pipeline is held on a 96-px Xception: depth + 2
batches in flight through the pinned staging slots equal their solo
predicts bit for bit, neither a dispatch nor a readback waits for
another batch, and a slot lent to a batcher is never handed out again
before its H2D copy has run (``torch.cuda._sleep`` holds the stream;
event queries, not timings).  K1 and K2 captured in a CUDA graph replay
their eager call's bits; each engine's per-bucket graphs (a 96-px
Xception, vit-tiny at 1024 tokens, efficientnet-b0 at 64 px; buckets 2
and 8, the latter fed 5 images) replay the eager forward's bits on the
same padded batch, and every replay credits its capture's launches; a
forward that syncs with the host fails warmup.  ResNet50 at 224 px
(cuDNN convolutions, no hand kernel) replays its bucket 1 and 16 graphs
bit-equal to its eager forward, and a card server with admission on
serves a request with budget left while it answers one whose budget is
spent with a JSON 504, the engine untouched.  Two engines' graphs
interleaved through one shared dispatcher equal each replayed alone; a
capture on one thread while another replays raises nothing and leaves
both bit-equal; and ``InferenceEngine.close()`` gives the device memory
back (within 16 MiB).  Observability: a bucket-16 batch's device time (its
handle's timing events) lies within 10% of its graph's replay timed alone,
the ``kdlt_mfu_pct`` and ``kdlt_device_busy_ratio`` gauges appear after
traffic, and a 1 s ``/debug/profile`` under traffic names the stage
kernel's symbol.  int8: Q1 and Q2 (``ops/csrc/int8_conv.cu``) equal their
plain versions exactly (max abs difference 0) at every shape of the 299-px
clothing model's w8a8 forward at batch 3 and at K- and N-tail shapes; a
96-px w8a8 engine passes its gate, launches 39 Q1 and 29 Q2 a replay and
replays bit-equal to eager; a miscalibrated one is refused, re-captured
weight-only on the capture thread, and gives its memory back on close.
The ingest path: the port's decoder and resize on this host equal the
committed fixtures' PIL pixels (``tests/ingest_fixtures``; these two need
no card and run anywhere), and a bytes-wire request on the card is served
by the bucket graphs' replays (no eager forward), 8 K1 and 2 K2 launches a
forward, with the tensor wire's logits for the same pixels; the decoder
gives every breadth fixture (``tests/ingest_fixtures/formats``: progressive
and 4-component JPEG, 4:4:0, 4:1:1, 16-bit and Adam7 PNG) its PIL digest.
Device-resize staging: the staged program's bucket graphs replay its eager
form's bits with 8 K1 and 2 K2 launches, the resize captured in a graph
stays within 1e-3 of its float64 products (no TF32), and closing a staged
engine gives its memory back.  The generative lane: a decode engine's
prefill and step graphs replay the eager programs (the cache within 1e-5,
the tokens above a 1e-4 top-2 margin), a continuous batch's streams equal
``decode_solo``'s, and a closed engine gives its memory back.
"""

from __future__ import annotations

import os

import numpy as np
import pytest
import torch

from kubernetes_deep_learning_tpu_torch.models.efficientnet import block_plan, se_features
from kubernetes_deep_learning_tpu_torch.models.efficientnet_fast import block_routes
from kubernetes_deep_learning_tpu_torch.ops import attention, fused_entry, fused_mbconv
from kubernetes_deep_learning_tpu_torch.ops import fused_sepconv as ops


def _rel(got, want) -> float:
    got, want = got.float().cpu(), want.float().cpu()
    return float((got - want).abs().max() / (want.abs().max() + 1e-6))


def _t(rng, shape, std=1.0, dtype=torch.float32):
    return torch.from_numpy(rng.normal(0, std, shape).astype(np.float32)).to(dtype).to("cuda")


def _stage(rng, c_in, c_out, pre, post):
    return dict(dw=_t(rng, (3, 3, c_in), 0.2), pw=_t(rng, (c_in, c_out), c_in ** -0.5, torch.bfloat16),
                scale=_t(rng, (c_out,), 0.1) + 1.0, shift=_t(rng, (c_out,), 0.1),
                pre_relu=pre, post_relu=post)


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 3, 16])
def test_cuda_kernels_match_plain_versions(batch):
    """The hand-written kernel against its plain version at the main path's
    widths (middle 19x19x728; exit chains 728->728->1024, 1024->1536->2048)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(batch)
    x = _t(rng, (batch, 19, 19, 728), dtype=torch.bfloat16)
    st = [_stage(rng, 728, 728, True, False) for _ in range(3)]
    w = (torch.stack([s["dw"] for s in st]), torch.stack([s["pw"] for s in st]),
         torch.stack([s["scale"] for s in st]), torch.stack([s["shift"] for s in st]))
    ops.reset_launch_counts()
    got = ops.fused_sepconv_block(x, *w)
    torch.cuda.synchronize()
    assert ops.launch_counts()["fused_sepconv_block"] == 1
    assert _rel(got, ops.sepconv_block_reference(x, *w)) < 2e-2
    for hw, widths, pre, post in ((19, (728, 728, 1024), True, False),
                                  (10, (1024, 1536, 2048), False, True)):
        xc = _t(rng, (batch, hw, hw, widths[0]), dtype=torch.bfloat16)
        stages = [_stage(rng, a, b, pre, post) for a, b in zip(widths, widths[1:])]
        got = ops.fused_sepconv_chain(xc, stages)
        torch.cuda.synchronize()
        assert _rel(got, ops.sepconv_chain_reference(xc, stages)) < 2e-2
    assert ops.launch_counts()["fused_sepconv_chain"] == 2


@pytest.mark.cuda
def test_cuda_kernel_ragged_shapes():
    """Widths that are not multiples of the tiles (K, N, pixels masked)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(5)
    x = _t(rng, (3, 5, 7, 40), dtype=torch.bfloat16)
    stages = [_stage(rng, 40, 200, True, True), _stage(rng, 200, 24, False, False)]
    got = ops.fused_sepconv_chain(x, stages)
    torch.cuda.synchronize()
    assert _rel(got, ops.sepconv_chain_reference(x, stages)) < 2e-2


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False


@pytest.mark.cuda
@pytest.mark.parametrize("batch,hw,stages", [
    (1, 147, ((64, 128, False, True), (128, 128, False, False))),  # a wide image (K5's old stages)
    (3, 147, ((64, 128, False, True), (128, 128, False, False))),
    (1, 10, ((1536, 2048, False, True),)),   # block14's second stage: the 192 KB panel
    (16, 10, ((1536, 2048, False, True),)),
    (1, 19, ((728, 728, True, False),)),     # bucket 1: 6 bands x 6 N groups
], ids=str)
def test_cuda_stage_kernel_shapes(batch, hw, stages):
    """One stage-kernel launch per stage on a wide image (147x147, the
    shapes K5 used before it kept its sepconvs on chip), at block14's and
    at bucket 1's, against the plain version."""
    _need_cuda()
    rng = np.random.default_rng(batch * hw + stages[0][0])
    x = _t(rng, (batch, hw, hw, stages[0][0]), dtype=torch.bfloat16)
    st = [_stage(rng, a, b, pre, post) for a, b, pre, post in stages]
    ops.reset_launch_counts()
    got = ops.fused_sepconv_chain(x, st)
    torch.cuda.synchronize()
    assert ops.launch_counts()["fused_sepconv_chain"] == 1
    assert got.shape == (batch, hw, hw, stages[-1][1]) and torch.isfinite(got.float()).all()
    assert _rel(got, ops.sepconv_chain_reference(x, st)) < 2e-2


@pytest.mark.cuda
def test_cuda_middle_block_odd_batch_with_residual():
    """The middle block at an odd batch (M = 7 * 361, not a multiple of the
    64-pixel band): the third stage adds the residual in its epilogue."""
    _need_cuda()
    rng = np.random.default_rng(7)
    x = _t(rng, (7, 19, 19, 728), dtype=torch.bfloat16)
    st = [_stage(rng, 728, 728, True, False) for _ in range(3)]
    w = tuple(torch.stack([s[k] for s in st]) for k in ("dw", "pw", "scale", "shift"))
    got = ops.fused_sepconv_block(x, *w)
    torch.cuda.synchronize()
    assert _rel(got, ops.sepconv_block_reference(x, *w)) < 2e-2


@pytest.mark.cuda
def test_cuda_stage_kernel_refuses_what_it_cannot_take():
    """A width that is not a multiple of 8 and an input that is not 16-byte
    aligned raise before any launch; the plain CPU path takes both."""
    _need_cuda()
    rng = np.random.default_rng(3)
    x = _t(rng, (2, 5, 5, 36), dtype=torch.bfloat16)
    odd = [_stage(rng, 36, 40, True, False)]
    ops.reset_launch_counts()
    with pytest.raises(ValueError, match="multiples of 8"):
        ops.fused_sepconv_chain(x, odd)
    flat = _t(rng, (2 * 5 * 5 * 40 + 1,), dtype=torch.bfloat16)
    unaligned = flat[1:].view(2, 5, 5, 40)  # contiguous, 2 bytes past an aligned base
    assert unaligned.is_contiguous() and unaligned.data_ptr() % 16
    with pytest.raises(ValueError, match="16-byte aligned"):
        ops.fused_sepconv_chain(unaligned, [_stage(rng, 40, 48, True, False)])
    with pytest.raises(ValueError, match="at most 1536"):
        ops.fused_sepconv_chain(_t(rng, (1, 2, 2, 2048), dtype=torch.bfloat16),
                                [_stage(rng, 2048, 8, False, False)])
    assert ops.launch_counts()["fused_sepconv_chain"] == 0
    cpu = [{k: v.cpu() if torch.is_tensor(v) else v for k, v in s.items()} for s in odd]
    assert ops.fused_sepconv_chain(x.cpu(), cpu).shape == (2, 5, 5, 40)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("sq,sk,causal,k_offset,kv_len", [
    (576, 576, False, 0, None),     # ViT-B/16 at 384 px
    (200, 200, False, 0, None),     # ragged, one partial tile
    (100, 300, True, -64, None),    # Sq != Sk, causal with earlier keys
    (128, 256, False, 0, 190),      # pad keys masked by kv_len
    (64, 64, True, 10_000, None),   # every key in the causal future: all 0
    (1, 300, False, 0, None),       # one query row
    (577, 577, True, 0, None),      # ragged past 576 (64-, 128- and 192-row q-tiles)
    (192, 320, False, 0, 250),      # exactly one 192-row q-tile, kv_len mid-tile
])
def test_cuda_flash_attention_matches_plain_version(dtype, d, sq, sk, causal, k_offset, kv_len):
    _need_cuda()
    rng = np.random.default_rng(sq + sk + d)
    q = _t(rng, (2, 3, sq, d), dtype=dtype)
    k, v = (_t(rng, (2, 3, sk, d), dtype=dtype) for _ in range(2))
    kw = dict(causal=causal, k_offset=k_offset, kv_len=kv_len)
    attention.reset_launch_counts()
    got = attention.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert attention.launch_counts()["flash_attention"] == 1
    assert got.dtype == dtype and got.shape == (2, 3, sq, d)
    want = attention.flash_attention_reference(q, k, v, **kw)
    if k_offset == 10_000:
        assert not got.any() and not want.any()
    else:
        assert _rel(got, want) < (2e-2 if dtype == torch.bfloat16 else 1e-4)


@pytest.mark.cuda
def test_cuda_flash_attention_reads_strided_views_and_rejects_head_dims():
    """(B, S, H, D) projections transposed to (B, H, S, D) views are read in
    place; a head dim the kernel has no instantiation for raises."""
    _need_cuda()
    rng = np.random.default_rng(9)
    q, k, v = (_t(rng, (2, 576, 12, 64), dtype=torch.bfloat16).transpose(1, 2) for _ in range(3))
    got = attention.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert _rel(got, attention.flash_attention_reference(q, k, v)) < 2e-2
    bad = _t(rng, (1, 2, 600, 48), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head dims"):
        attention.flash_attention(bad, bad, bad)


@pytest.mark.cuda
def test_cuda_vit_forward_launches_the_kernel_once_per_block():
    """vit-tiny at 256 px (1024 tokens, depth 2) on the card: 2 launches per
    forward, and the bf16 logits near the exact f32 graph."""
    _need_cuda()
    from kubernetes_deep_learning_tpu_torch.modelspec import ModelSpec
    from kubernetes_deep_learning_tpu_torch.models import build_forward, init_variables
    from kubernetes_deep_learning_tpu_torch.weights import from_jax_variables

    spec = ModelSpec(name="tiny-vit-long", family="vit-tiny", input_shape=(256, 256, 3),
                     labels=("a", "b"), preprocessing="tf")
    params = from_jax_variables(init_variables(spec, seed=0))
    imgs = torch.from_numpy(np.random.default_rng(1).integers(0, 256, (2, 256, 256, 3), np.uint8))
    attention.reset_launch_counts()
    with torch.inference_mode():
        fast = build_forward(spec, params, torch.bfloat16, "auto", "cuda")(imgs.cuda())
        torch.cuda.synchronize()
        assert attention.launch_counts()["flash_attention"] == 2
        exact = build_forward(spec, params, torch.float32, "auto", "cuda")(imgs.cuda())
    assert torch.isfinite(fast).all()
    assert _rel(fast, exact) < 5e-2


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("sq,sk,causal,k_offset,kv_len", [
    (256, 256, False, 0, None),     # ViT-B/16 at 256 px: the training path
    (200, 200, False, 0, None),     # ragged, one partial tile
    (100, 300, True, -64, None),    # Sq != Sk, causal with earlier keys
    (128, 256, False, 0, 190),      # pad keys masked by kv_len
    (64, 64, True, 32, None),       # rows 0..31 see no key: (0, NEG_INF, 0)
    (1, 300, False, 0, None),       # one query row
    (577, 577, True, 0, None),      # ragged past 576
    (192, 192, False, 0, None),     # exactly one 192-row q-tile
])
def test_cuda_flash_attention_partials_match_plain_version(dtype, d, sq, sk, causal, k_offset,
                                                           kv_len):
    """K3P's (acc, m, l) against its plain version on the rows with a
    visible key (relative to the largest value: < 2e-2 bf16, < 1e-4 f32);
    the rows without one exactly (0, NEG_INF, 0)."""
    _need_cuda()
    rng = np.random.default_rng(sq + sk + d + 1)
    q = _t(rng, (2, 3, sq, d), dtype=dtype)
    k, v = (_t(rng, (2, 3, sk, d), dtype=dtype) for _ in range(2))
    kw = dict(causal=causal, k_offset=k_offset, kv_len=kv_len)
    attention.reset_launch_counts()
    got = attention.flash_attention(q, k, v, return_partials=True, **kw)
    torch.cuda.synchronize()
    assert attention.launch_counts() == {"flash_attention": 0, "flash_attention_partials": 1,
                                         "flash_gfold": 0}
    want = attention.flash_attention_partials_reference(q, k, v, **kw)
    live = want[1] > attention.NEG_INF * 0.5
    assert bool(live.any())
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape
        assert _rel(g[live], w[live]) < (2e-2 if dtype == torch.bfloat16 else 1e-4)
    acc, m, l = (t[~live] for t in got)
    assert not acc.any() and not l.any() and bool((m == attention.NEG_INF).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_cuda_flash_attention_partials_read_strided_views(dtype):
    """K3P on (B, S, H, D) projections viewed as (B, H, S, D), as the ViT's
    training forward passes them: read in place, a ragged last tile taken
    from its own head only."""
    _need_cuda()
    rng = np.random.default_rng(41)
    q, k, v = (_t(rng, (2, 200, 12, 64), dtype=dtype).transpose(1, 2) for _ in range(3))
    assert not q.is_contiguous()
    got = attention.flash_attention(q, k, v, return_partials=True)
    torch.cuda.synchronize()
    want = attention.flash_attention_partials_reference(q, k, v)
    for g, w in zip(got, want):
        assert _rel(g, w) < (2e-2 if dtype == torch.bfloat16 else 1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128])
def test_cuda_flash_attention_f32_holds_at_large_scores(d):
    """Inputs of std 8 (raw scores ~500) stress the 3xTF32 split: the f32
    kernels, fused and partials, still within 1e-4 of the exact plain
    versions."""
    _need_cuda()
    rng = np.random.default_rng(43 + d)
    q, k, v = (_t(rng, (2, 3, 256, d), std=8.0) for _ in range(3))
    got = attention.flash_attention(q, k, v, return_partials=True)
    out = attention.flash_attention(q, k, v)
    torch.cuda.synchronize()
    for g, w in zip(got, attention.flash_attention_partials_reference(q, k, v)):
        assert _rel(g, w) < 1e-4
    assert _rel(out, attention.flash_attention_reference(q, k, v)) < 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [False, True])
def test_cuda_attention_trainable_matches_plain_autograd(causal):
    """attention_trainable with K3P's forward against torch autograd
    through plain f32 attention, on strided (B, S, H, D) views at the
    ViT-B/16 training shape (relative < 1e-4)."""
    _need_cuda()
    rng = np.random.default_rng(31)
    leaves = [_t(rng, (2, 256, 12, 64)).requires_grad_() for _ in range(3)]
    cot = _t(rng, (2, 12, 256, 64))
    results = []
    attention.reset_launch_counts()
    for fn in (attention.attention_trainable, attention.mha_reference):
        out = fn(*(t.transpose(1, 2) for t in leaves), causal=causal)
        results.append((out.detach(), torch.autograd.grad((out * cot).sum(), leaves)))
    torch.cuda.synchronize()
    assert attention.launch_counts()["flash_attention_partials"] == 1
    (out, grads), (want, want_grads) = results
    assert _rel(out, want) < 1e-4
    for g, w in zip(grads, want_grads):
        assert _rel(g, w) < 1e-4


def _fused_shapes(width: float, depth: float, stem_hw: int, stem_c: int) -> list[tuple]:
    """(h, c_in, c_mid, c_out, k, residual) of every fused block shape."""
    routes = block_routes(block_plan(width, depth), stem_hw, stem_hw, stem_c)
    return sorted({(b.h, b.c_in, b.c_in * b.expand, b.features, b.kernel, b.residual)
                   for b in routes if b.fused})


_B3_FUSED = _fused_shapes(1.2, 1.4, 150, 40)
_B3_BLOCK6 = (38, 48, 288, 48, 5, True)      # the 38x38 stage: bands of rows, a ragged last one
_B3_BLOCK25 = (10, 384, 2304, 384, 3, True)  # the widest: one band, 64-row tiles straddle images
_MBCONV_CASES = (
    [(batch, shape) for shape in _B3_FUSED for batch in (1, 3, 16)]
    + [(2, shape) for shape in _fused_shapes(1.0, 1.0, 112, 32)]
    + [(17, _B3_BLOCK6), (17, _B3_BLOCK25)]
)


def _mbconv_weights(rng, c_in, c_mid, c_out, k, s):
    bf = torch.bfloat16
    return dict(
        expand_w=_t(rng, (c_in, c_mid), c_in ** -0.5, bf), expand_s=_t(rng, (c_mid,), 0.1) + 1.0,
        expand_b=_t(rng, (c_mid,), 0.1), dw=_t(rng, (k, k, c_mid), 1.0 / k),
        dw_s=_t(rng, (c_mid,), 0.1) + 1.0, dw_b=_t(rng, (c_mid,), 0.1),
        se_r_w=_t(rng, (c_mid, s), c_mid ** -0.5, bf), se_r_b=_t(rng, (s,), 0.1),
        se_e_w=_t(rng, (s, c_mid), s ** -0.5, bf), se_e_b=_t(rng, (c_mid,), 0.1),
        proj_w=_t(rng, (c_mid, c_out), c_mid ** -0.5, bf), proj_s=_t(rng, (c_out,), 0.1) + 1.0,
        proj_b=_t(rng, (c_out,), 0.1))


def _mbconv_case(batch, shape, std=1.0):
    h, c_in, c_mid, c_out, k, residual = shape
    rng = np.random.default_rng(h + c_in + c_out + batch)
    x = _t(rng, (batch, h, h, c_in), std, torch.bfloat16)
    return x, _mbconv_weights(rng, c_in, c_mid, c_out, k, se_features(c_in)), residual


@pytest.mark.cuda
@pytest.mark.parametrize("batch,shape", _MBCONV_CASES, ids=str)
def test_cuda_mbconv_matches_plain_version(batch, shape):
    """The three-launch MBConv kernel against its plain version, and the
    same bits on a second call (the squeeze-excite sums are deterministic)."""
    _need_cuda()
    h, c_in, c_mid, c_out, k, residual = shape
    x, w, residual = _mbconv_case(batch, shape)
    fused_mbconv.reset_launch_counts()
    got = fused_mbconv.fused_mbconv_block(x, w, residual)
    again = fused_mbconv.fused_mbconv_block(x, w, residual)
    torch.cuda.synchronize()
    assert fused_mbconv.launch_counts()["fused_mbconv_block"] == 2
    assert got.shape == (batch, h, h, c_out) and torch.isfinite(got.float()).all()
    assert torch.equal(got, again)
    assert _rel(got, fused_mbconv.mbconv_block_reference(x, w, residual)) < 2e-2


@pytest.mark.cuda
@pytest.mark.parametrize("shape", _B3_FUSED, ids=str)
def test_cuda_mbconv_holds_at_large_inputs(shape):
    """Inputs of std 4 (large expanded values, band sums and gates near 0
    or 1): still within 2e-2 of the plain version, at batch 16."""
    _need_cuda()
    x, w, residual = _mbconv_case(16, shape, std=4.0)
    got = fused_mbconv.fused_mbconv_block(x, w, residual)
    torch.cuda.synchronize()
    assert torch.isfinite(got.float()).all()
    assert _rel(got, fused_mbconv.mbconv_block_reference(x, w, residual)) < 2e-2


@pytest.mark.cuda
@pytest.mark.parametrize("batch,shape", [(16, _B3_BLOCK6), (3, _B3_BLOCK25)], ids=str)
def test_cuda_mbconv_graph_replay_is_bit_equal(batch, shape):
    """The block captured in a CUDA graph (its scratch allocated inside the
    capture) and replayed gives the eager call's bits."""
    _need_cuda()
    x, w, residual = _mbconv_case(batch, shape)
    eager = fused_mbconv.fused_mbconv_block(x, w, residual)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fused_mbconv.fused_mbconv_block(x, w, residual)  # warm up outside the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = fused_mbconv.fused_mbconv_block(x, w, residual)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(captured, eager)


@pytest.mark.cuda
def test_cuda_efficientnet_fast_forward_launches_per_fused_block():
    """efficientnet-b0 at 64 px on the card: one launch per fused block (11
    per forward), and the fused route near the bf16 exact graph."""
    _need_cuda()
    from kubernetes_deep_learning_tpu_torch.modelspec import ModelSpec
    from kubernetes_deep_learning_tpu_torch.models import build_forward, init_variables
    from kubernetes_deep_learning_tpu_torch.weights import from_jax_variables

    spec = ModelSpec(name="tiny-effnet", family="efficientnet-b0", input_shape=(64, 64, 3),
                     labels=("a", "b", "c"), preprocessing="torch")
    params = from_jax_variables(init_variables(spec, seed=0))
    imgs = torch.from_numpy(np.random.default_rng(1).integers(0, 256, (5, 64, 64, 3), np.uint8))
    with torch.inference_mode():
        fwd = build_forward(spec, params, torch.bfloat16, "auto", "cuda")
        assert fwd.fast
        fused_mbconv.reset_launch_counts()
        fast = fwd(imgs.cuda())
        torch.cuda.synchronize()
        assert fused_mbconv.launch_counts()["fused_mbconv_block"] == 11
        exact = build_forward(spec, params, torch.bfloat16, False, "cuda")(imgs.cuda())
    assert torch.isfinite(fast).all()
    assert _rel(fast, exact) < 2e-2


def _entry_weights(rng, c_in, c_b, c_out):
    bf = torch.bfloat16
    return dict(
        conv2=_t(rng, (9 * c_in, c_b), (9 * c_in) ** -0.5, bf), conv2_s=_t(rng, (c_b,), 0.1) + 1.0,
        conv2_b=_t(rng, (c_b,), 0.1), res=_t(rng, (c_b, c_out), c_b ** -0.5, bf),
        res_s=_t(rng, (c_out,), 0.1) + 1.0, res_b=_t(rng, (c_out,), 0.1),
        dw1=_t(rng, (3, 3, c_b), 0.2), pw1=_t(rng, (c_b, c_out), c_b ** -0.5, bf),
        bn1_s=_t(rng, (c_out,), 0.1) + 1.0, bn1_b=_t(rng, (c_out,), 0.1),
        dw2=_t(rng, (3, 3, c_out), 0.2), pw2=_t(rng, (c_out, c_out), c_out ** -0.5, bf),
        bn2_s=_t(rng, (c_out,), 0.1) + 1.0, bn2_b=_t(rng, (c_out,), 0.1))


@pytest.mark.cuda
@pytest.mark.parametrize("batch,h,w,c_in,c_b,c_out", [
    (1, 149, 149, 32, 64, 128),   # Xception's entry segment
    (3, 149, 149, 32, 64, 128),
    (16, 149, 149, 32, 64, 128),
    (3, 24, 19, 16, 24, 40),      # even and odd sides, K and N tails
    (17, 149, 149, 32, 64, 128),  # not a multiple of 8; many work units
    (2, 150, 150, 32, 64, 128),   # even sides at Xception's widths: no leading pool pad
], ids=str)
def test_cuda_entry_block_matches_plain_version(batch, h, w, c_in, c_b, c_out):
    _need_cuda()
    rng = np.random.default_rng(batch + h + c_out)
    x = _t(rng, (batch, h, w, c_in), dtype=torch.bfloat16)
    wt = _entry_weights(rng, c_in, c_b, c_out)
    fused_entry.reset_launch_counts()
    got = fused_entry.fused_entry_block(x, wt)
    torch.cuda.synchronize()
    assert fused_entry.launch_counts()["fused_entry_block"] == 1
    assert got.shape == (batch, (h - 1) // 2, (w - 1) // 2, c_out)
    assert torch.isfinite(got.float()).all()
    assert _rel(got, fused_entry.entry_block_reference(x, wt)) < 2e-2


@pytest.mark.cuda
@pytest.mark.parametrize("batch,h,w,c_in,c_b,c_out,rows", [
    (2, 149, 149, 32, 64, 128, 1),  # segments of one output row: warm-up every row
    (3, 24, 19, 16, 24, 40, 1),
    (1, 149, 149, 32, 64, 128, 74),  # one segment an image
], ids=str)
def test_cuda_entry_block_segment_lengths(batch, h, w, c_in, c_b, c_out, rows):
    """The walk forced to segments of ``rows`` output rows gives the plain
    version's result (the launcher's choice is tested above)."""
    _need_cuda()
    rng = np.random.default_rng(batch + h + rows)
    x = _t(rng, (batch, h, w, c_in), dtype=torch.bfloat16)
    wt = _entry_weights(rng, c_in, c_b, c_out)
    got = fused_entry._launch(x, wt, rows)
    torch.cuda.synchronize()
    assert torch.isfinite(got.float()).all()
    assert _rel(got, fused_entry.entry_block_reference(x, wt)) < 2e-2


@pytest.mark.cuda
def test_cuda_entry_block_graph_replay_is_bit_equal():
    """K5 captured in a CUDA graph and replayed gives the eager call's bits."""
    _need_cuda()
    rng = np.random.default_rng(16)
    x = _t(rng, (16, 149, 149, 32), dtype=torch.bfloat16)
    wt = _entry_weights(rng, 32, 64, 128)
    eager = fused_entry.fused_entry_block(x, wt)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fused_entry.fused_entry_block(x, wt)  # warm up outside the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = fused_entry.fused_entry_block(x, wt)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(captured, eager)


@pytest.mark.cuda
@pytest.mark.parametrize("hw,widths", [(74, (128, 256, 256)), (37, (256, 728, 728))])
def test_cuda_chain_at_entry_path_shapes(hw, widths):
    """The stage kernel at blocks 3 and 4 of the entry-kernel path, batch 16."""
    _need_cuda()
    rng = np.random.default_rng(hw)
    x = _t(rng, (16, hw, hw, widths[0]), dtype=torch.bfloat16)
    stages = [_stage(rng, a, b, True, False) for a, b in zip(widths, widths[1:])]
    got = ops.fused_sepconv_chain(x, stages)
    torch.cuda.synchronize()
    assert _rel(got, ops.sepconv_chain_reference(x, stages)) < 2e-2


@pytest.mark.cuda
@pytest.mark.parametrize("g", [1, 4, 8])
@pytest.mark.parametrize("shape,dtype", [
    ((32, 12, 256, 64), torch.bfloat16),   # E5's own shape
    ((2, 4, 200, 64), torch.bfloat16),     # ragged: one partial tile
    ((2, 4, 100, 32), torch.float32),
    ((16, 12, 576, 64), torch.bfloat16),   # ViT-B/16-384's shape
    ((2, 4, 577, 128), torch.bfloat16),    # two swizzle atoms along D, a ragged q-tile
], ids=str)
def test_cuda_flash_gfold_matches_plain_version(g, shape, dtype):
    _need_cuda()
    rng = np.random.default_rng(g + shape[2])
    q, k, v = (_t(rng, shape, dtype=dtype) for _ in range(3))
    attention.reset_launch_counts()
    got = attention.flash_gfold(q, k, v, g=g)
    torch.cuda.synchronize()
    assert attention.launch_counts() == {"flash_attention": 0, "flash_attention_partials": 0,
                                         "flash_gfold": 1}
    assert got.dtype == dtype and got.shape == shape
    assert _rel(got, attention.flash_attention_reference(q, k, v)) < (
        2e-2 if dtype == torch.bfloat16 else 1e-4)


@pytest.mark.cuda
def test_cuda_entry_kernel_forward_launches():
    """The 96-px Xception with ``entry_kernel=True`` on the card: 1 K5, 8 K1
    and 4 K2 launches per forward (the default fused route: 0, 8, 2), and
    logits within 2e-2 of the default route."""
    _need_cuda()
    from kubernetes_deep_learning_tpu_torch.modelspec import ModelSpec
    from kubernetes_deep_learning_tpu_torch.models import (
        Forward,
        build_forward,
        create_model,
        init_variables,
    )
    from kubernetes_deep_learning_tpu_torch.models.xception_fast import XceptionFast
    from kubernetes_deep_learning_tpu_torch.weights import from_jax_variables

    spec = ModelSpec(name="tiny-xception", family="xception", input_shape=(96, 96, 3),
                     labels=("a", "b", "c"), preprocessing="tf")
    params = from_jax_variables(init_variables(spec, seed=0))
    imgs = torch.from_numpy(np.random.default_rng(1).integers(0, 256, (3, 96, 96, 3), np.uint8))
    with torch.inference_mode():
        default = build_forward(spec, params, torch.bfloat16, "auto", "cuda")
        model = create_model(spec, torch.bfloat16)
        model.load_state_dict(params)
        entry = Forward(spec, XceptionFast(model.to("cuda").eval(), entry_kernel=True), True)
        counts = []
        for fwd in (default, entry):
            ops.reset_launch_counts()
            fused_entry.reset_launch_counts()
            out = fwd(imgs.cuda())
            torch.cuda.synchronize()
            counts.append((fused_entry.launch_counts()["fused_entry_block"],
                           *ops.launch_counts().values()))
            assert torch.isfinite(out).all()
        want = default(imgs.cuda())
    assert counts == [(0, 8, 2), (1, 8, 4)]
    assert _rel(out, want) < 2e-2


def _tiny_engine(depth: int):
    """A warmed 96-px Xception engine on the card (buckets 1 and 4) whose
    staging free list starts with depth + 1 slots."""
    from kubernetes_deep_learning_tpu_torch.export.artifact import ModelArtifact
    from kubernetes_deep_learning_tpu_torch.modelspec import ModelSpec
    from kubernetes_deep_learning_tpu_torch.models import init_variables
    from kubernetes_deep_learning_tpu_torch.runtime import InferenceEngine

    spec = ModelSpec(name="tiny-xception", family="xception", input_shape=(96, 96, 3),
                     labels=("a", "b", "c"), preprocessing="tf")
    artifact = ModelArtifact(spec, init_variables(spec, seed=0), {"compute_dtype": "bfloat16"})
    engine = InferenceEngine(artifact, buckets=(1, 4), device="cuda", pipeline_depth=depth)
    engine.warmup()
    return engine


_HOLD_CYCLES = 10**9  # torch.cuda._sleep: about half a second of the stream


@pytest.mark.cuda
def test_cuda_staging_ring_never_refills_a_buffer_in_flight():
    """depth + 2 batches of different content dispatched back to back behind
    a held stream, so every one is in flight when the ring wraps: each
    handle's rows equal a solo predict of its own batch."""
    _need_cuda()
    depth = 2
    engine = _tiny_engine(depth)
    assert engine.fast
    rng = np.random.default_rng(5)
    batches = [rng.integers(0, 256, (3, 96, 96, 3), np.uint8) for _ in range(depth + 2)]
    solo = [engine.predict(b) for b in batches]
    torch.cuda._sleep(_HOLD_CYCLES)
    handles = [engine.predict_async(b) for b in batches]
    for (handle, n), want in zip(handles, solo):
        np.testing.assert_array_equal(np.asarray(handle)[:n], want)


@pytest.mark.cuda
def test_cuda_predict_async_and_readback_wait_for_no_other_batch():
    """A dispatch returns while the batch before it still waits on the
    device, and a readback returns while the batch after it does (event
    queries, not timings)."""
    _need_cuda()
    engine = _tiny_engine(2)
    rng = np.random.default_rng(6)
    a, b = (rng.integers(0, 256, (4, 96, 96, 3), np.uint8) for _ in range(2))
    want_a = engine.predict(a)
    torch.cuda._sleep(_HOLD_CYCLES)
    first, _ = engine.predict_async(a)
    second, _ = engine.predict_async(b)
    assert not first._done.query()  # the second dispatch did not wait for the first forward
    np.asarray(second)
    first, _ = engine.predict_async(a)
    torch.cuda._sleep(_HOLD_CYCLES)
    second, _ = engine.predict_async(b)
    rows = np.asarray(first)
    assert not second._done.query()  # the first readback did not wait for the second forward
    np.testing.assert_array_equal(rows, want_a)
    np.asarray(second)


@pytest.mark.cuda
def test_cuda_stage_kernels_replay_from_a_graph_bit_equal():
    """K1 (a middle block over its prepared stages) and K2 (block14's chain)
    captured in one CUDA graph and replayed give their eager calls' bits."""
    _need_cuda()
    rng = np.random.default_rng(8)
    x = _t(rng, (4, 19, 19, 728), dtype=torch.bfloat16)
    st = [_stage(rng, 728, 728, True, False) for _ in range(3)]
    block = ops.prepare_block(*(torch.stack([s[k] for s in st])
                                for k in ("dw", "pw", "scale", "shift")))
    xc = _t(rng, (4, 10, 10, 1024), dtype=torch.bfloat16)
    chain = [_stage(rng, a, b, False, True) for a, b in ((1024, 1536), (1536, 2048))]
    eager = (ops.fused_sepconv_block_stages(x, block), ops.fused_sepconv_chain(xc, chain))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        ops.fused_sepconv_block_stages(x, block)  # warm up outside the capture
        ops.fused_sepconv_chain(xc, chain)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = (ops.fused_sepconv_block_stages(x, block), ops.fused_sepconv_chain(xc, chain))
    ops.reset_launch_counts()
    for _ in range(2):
        graph.replay()
    torch.cuda.synchronize()
    assert ops.launch_counts() == {"fused_sepconv_block": 0, "fused_sepconv_chain": 0}
    for got, want in zip(captured, eager):
        assert torch.equal(got, want)


def _engine_case(name: str):
    """A small served model of each family on the card, the kernel module
    it launches and its launches per forward."""
    from kubernetes_deep_learning_tpu_torch.modelspec import ModelSpec

    return {
        "xception": (ModelSpec(name="graph-xception", family="xception",
                               input_shape=(96, 96, 3), labels=("a", "b", "c"),
                               preprocessing="tf"),
                     ops, {"fused_sepconv_block": 8, "fused_sepconv_chain": 2}),
        "vit": (ModelSpec(name="graph-vit", family="vit-tiny", input_shape=(256, 256, 3),
                          labels=("a", "b"), preprocessing="tf"),
                attention, {"flash_attention": 2}),
        "efficientnet": (ModelSpec(name="graph-effnet", family="efficientnet-b0",
                                   input_shape=(64, 64, 3), labels=("a", "b", "c"),
                                   preprocessing="torch"),
                         fused_mbconv, {"fused_mbconv_block": 11}),
    }[name]


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["xception", "vit", "efficientnet"])
def test_cuda_engine_bucket_graphs_replay_bit_equal_to_eager(name):
    """Buckets 2 and 8: 2 images, then 5 (3 of bucket 8's rows padding).  The
    replay's logits equal ``engine._forward`` on the same zero-padded batch
    bit for bit, and each replay credits the capture's launches."""
    _need_cuda()
    from kubernetes_deep_learning_tpu_torch.export.artifact import ModelArtifact
    from kubernetes_deep_learning_tpu_torch.models import init_variables
    from kubernetes_deep_learning_tpu_torch.runtime import InferenceEngine

    spec, counter, per_forward = _engine_case(name)
    artifact = ModelArtifact(spec, init_variables(spec, seed=0), {"compute_dtype": "bfloat16"})
    engine = InferenceEngine(artifact, buckets=(2, 8), device="cuda")
    engine.warmup()
    rng = np.random.default_rng(9)
    for n, bucket in ((2, 2), (5, 8)):
        imgs = rng.integers(0, 256, (n, *spec.input_shape), np.uint8)
        counter.reset_launch_counts()
        handle, got_n = engine.predict_async(imgs)
        rows = np.asarray(handle)
        assert got_n == n and rows.shape == (bucket, spec.num_classes)
        launches = counter.launch_counts()
        assert {k: v for k, v in launches.items() if v} == per_forward, launches
        padded = np.zeros((bucket, *spec.input_shape), np.uint8)
        padded[:n] = imgs
        with torch.inference_mode():
            eager = engine._forward(torch.from_numpy(padded).cuda()).cpu().numpy()
        assert np.isfinite(rows).all()
        np.testing.assert_array_equal(rows, eager)


@pytest.mark.cuda
def test_cuda_capture_fails_warmup_on_a_host_sync():
    """A forward that reads a value back to the host cannot be captured:
    warmup raises instead of serving eagerly."""
    _need_cuda()
    engine = _tiny_engine(2)
    forward = engine._forward

    def syncing(x):
        out = forward(x)
        return out * float(out.abs().max())  # a device-to-host read
    engine._forward = syncing
    engine._graphs.clear()
    with pytest.raises(RuntimeError):
        engine.warmup()


@pytest.mark.cuda
def test_cuda_lent_slot_is_never_handed_out_before_its_h2d():
    """A slot lent to a batcher and dispatched behind a held stream: while
    it is lent, no other dispatch or lend gets it; once handed back, the
    next lend of it returns only after its H2D copy has run, and every slot
    a lend returns has no H2D copy pending."""
    _need_cuda()
    from kubernetes_deep_learning_tpu_torch.runtime.engine import StagedBatch

    engine = _tiny_engine(2)
    rng = np.random.default_rng(10)
    imgs = rng.integers(0, 256, (3, 96, 96, 3), np.uint8)
    want = engine.predict(imgs)
    torch.cuda._sleep(_HOLD_CYCLES)
    lent = engine.lend_staging()
    lent.array[:3] = imgs
    handle, n = engine.predict_async(StagedBatch(lent, 3))
    assert not lent.copied.query()  # its H2D waits behind the held stream
    others = [engine.lend_staging() for _ in range(4)]  # every other slot, and new ones
    assert all(s is not lent and s.copied.query() for s in others)
    for s in others:
        engine.return_staging(s)
    engine.return_staging(lent)
    seen = [engine.lend_staging() for _ in range(5)]
    assert any(s is lent for s in seen) and all(s.copied.query() for s in seen)
    np.testing.assert_array_equal(np.asarray(handle)[:n], want)


@pytest.mark.cuda
def test_cuda_resnet50_graph_replay_is_bit_equal_to_eager():
    """``resnet50-imagenet`` at 224 px, bf16: buckets 1 and 16 (the stem's
    padded conv and max-pool captured) replay the eager forward's bits on
    the same padded batch, and launch none of the hand kernels."""
    _need_cuda()
    from kubernetes_deep_learning_tpu_torch.export.artifact import ModelArtifact
    from kubernetes_deep_learning_tpu_torch.models import init_variables
    from kubernetes_deep_learning_tpu_torch.modelspec import RESNET50_IMAGENET
    from kubernetes_deep_learning_tpu_torch.runtime import InferenceEngine

    spec = RESNET50_IMAGENET
    artifact = ModelArtifact(spec, init_variables(spec, seed=0), {"compute_dtype": "bfloat16"})
    engine = InferenceEngine(artifact, buckets=(1, 16), device="cuda")
    assert not engine.fast
    engine.warmup()
    rng = np.random.default_rng(12)
    counters = (ops, attention, fused_entry, fused_mbconv)
    for n, bucket in ((1, 1), (11, 16)):
        imgs = rng.integers(0, 256, (n, *spec.input_shape), np.uint8)
        for c in counters:
            c.reset_launch_counts()
        handle, _ = engine.predict_async(imgs)
        rows = np.asarray(handle)
        assert not any(v for c in counters for v in c.launch_counts().values())
        padded = np.zeros((bucket, *spec.input_shape), np.uint8)
        padded[:n] = imgs
        with torch.inference_mode():
            eager = engine._forward(torch.from_numpy(padded).cuda()).cpu().numpy()
        assert rows.shape == (bucket, 1000) and np.isfinite(rows).all()
        np.testing.assert_array_equal(rows, eager)


@pytest.mark.cuda
def test_cuda_server_admits_a_live_budget_and_sheds_a_spent_one(tmp_path):
    """The port server on the card with admission on: a request with budget
    left is served; one with ``X-Request-Deadline-Ms: 0`` gets a JSON 504
    before the engine is touched (its image counter does not move)."""
    _need_cuda()
    import json
    import re
    import urllib.error
    import urllib.request

    from kubernetes_deep_learning_tpu_torch.export import artifact as art
    from kubernetes_deep_learning_tpu_torch.modelspec import ModelSpec
    from kubernetes_deep_learning_tpu_torch.models import init_variables
    from kubernetes_deep_learning_tpu_torch.serving import protocol
    from kubernetes_deep_learning_tpu_torch.serving.model_server import ModelServer

    spec = ModelSpec(name="admit-xception", family="xception", input_shape=(96, 96, 3),
                     labels=("a", "b", "c"), preprocessing="tf")
    art.save_artifact(art.version_dir(str(tmp_path), spec.name, 1), spec,
                      init_variables(spec, seed=0), {"compute_dtype": "bfloat16"})
    server = ModelServer(str(tmp_path), port=0, buckets=(1, 4), device="cuda")
    body = protocol.encode_predict_request(np.zeros((1, 96, 96, 3), np.uint8))

    def post(budget_ms: str):
        req = urllib.request.Request(
            f"http://127.0.0.1:{server.port}/v1/models/{spec.name}:predict", data=body,
            method="POST", headers={"Content-Type": protocol.MSGPACK_CONTENT_TYPE,
                                    "X-Request-Deadline-Ms": budget_ms})
        try:
            with urllib.request.urlopen(req, timeout=60) as r:
                return r.status, r.read()
        except urllib.error.HTTPError as e:
            return e.code, e.read()

    def images() -> float:
        found = re.search(rf'^kdlt_engine_images_total{{model="{spec.name}",version="1"}} (\S+)$',
                          server.registry.render(), re.M)
        return float(found.group(1))

    try:
        server.start()
        server.warmup()
        assert server.admission.enabled and server.admission.limiter is not None
        status, reply = post("10000")
        assert status == 200
        logits, _ = protocol.decode_predict_response(reply, protocol.MSGPACK_CONTENT_TYPE)
        assert logits.shape == (1, 3) and np.isfinite(logits).all()
        before = images()
        status, reply = post("0")
        assert status == 504 and json.loads(reply)["shed_reason"] == "deadline_exhausted"
        assert images() == before == 1.0
    finally:
        server.shutdown()


def _warm_engine(name: str, seed: int = 0, buckets=(1, 4)):
    from kubernetes_deep_learning_tpu_torch.export.artifact import ModelArtifact
    from kubernetes_deep_learning_tpu_torch.models import init_variables
    from kubernetes_deep_learning_tpu_torch.runtime import InferenceEngine

    spec, _, _ = _engine_case(name)
    artifact = ModelArtifact(spec, init_variables(spec, seed=seed), {"compute_dtype": "bfloat16"})
    engine = InferenceEngine(artifact, buckets=buckets, device="cuda")
    engine.warmup()
    return engine


@pytest.mark.cuda
def test_cuda_two_engines_interleaved_on_one_dispatcher_equal_each_alone():
    """A Xception's and a ViT's bucket graphs replayed in turn through one
    shared dispatcher (depth 2: one batch of each model in flight at once,
    each engine its own pool) give each batch the bits of that model's
    batch replayed alone."""
    _need_cuda()
    from kubernetes_deep_learning_tpu_torch.runtime import InFlightDispatcher

    engines = {name: _warm_engine(name) for name in ("xception", "vit")}
    rng = np.random.default_rng(13)
    plan = [(name, rng.integers(0, 256, (n, *engines[name].spec.input_shape), np.uint8))
            for _ in range(3) for name, n in (("xception", 3), ("vit", 4), ("xception", 1),
                                              ("vit", 2))]
    solo = [engines[name].predict(imgs) for name, imgs in plan]
    dispatcher = InFlightDispatcher(None, depth=2)
    try:
        futs = [dispatcher.submit(imgs, engine=engines[name], model=name) for name, imgs in plan]
        for fut, want in zip(futs, solo):
            np.testing.assert_array_equal(fut.result(timeout=60), want)
    finally:
        dispatcher.close()


@pytest.mark.cuda
def test_cuda_capture_while_another_thread_replays():
    """One thread replays a warmed Xception engine's graphs back to back while
    another builds a ViT engine and captures its bucket graphs: nothing
    raises, every replay equals the Xception's solo bits, the ViT's graphs
    replay its eager forward's bits, and its capture recorded only its own
    launches (2 flash attentions a forward, none of the Xception's)."""
    _need_cuda()
    import threading

    busy = _warm_engine("xception")
    rng = np.random.default_rng(14)
    batches = [rng.integers(0, 256, (n, 96, 96, 3), np.uint8) for n in (1, 3, 4)]
    solo = [busy.predict(b) for b in batches]
    stop, errors, replays = threading.Event(), [], [0]

    def replay():
        try:
            while not stop.is_set():
                for b, want in zip(batches, solo):
                    np.testing.assert_array_equal(busy.predict(b), want)
                    replays[0] += 1
        except BaseException as e:  # noqa: BLE001 - reported below
            errors.append(e)

    t = threading.Thread(target=replay)
    t.start()
    try:
        fresh = _warm_engine("vit", buckets=(2, 8))
    finally:
        stop.set()
        t.join(60)
    assert not errors, errors
    assert replays[0] > 0
    for bucket, g in fresh._graphs.items():
        recorded = {k: v for counts in g.launches.values() for k, v in counts.items() if v}
        assert recorded == {"flash_attention": 2}, (bucket, g.launches)
    imgs = rng.integers(0, 256, (5, *fresh.spec.input_shape), np.uint8)
    padded = np.zeros((8, *fresh.spec.input_shape), np.uint8)
    padded[:5] = imgs
    rows = fresh.predict(imgs)
    with torch.inference_mode():
        eager = fresh._forward(torch.from_numpy(padded).cuda()).cpu().numpy()[:5]
    np.testing.assert_array_equal(rows, eager)


@pytest.mark.cuda
def test_cuda_engine_close_gives_its_device_memory_back():
    """A warmed engine that served a batch, closed: ``memory_allocated`` is
    back within 16 MiB of its value before the engine was built, its graph
    pool is gone, and a later predict raises ``EngineClosed``.  (A first
    engine is built and closed before the measurement: the capture
    stream's cuBLAS workspace lives as long as the process.)"""
    _need_cuda()
    from kubernetes_deep_learning_tpu_torch.runtime import EngineClosed

    _warm_engine("xception").close()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    engine = _warm_engine("xception", seed=1, buckets=(1, 4, 16))
    imgs = np.random.default_rng(15).integers(0, 256, (3, 96, 96, 3), np.uint8)
    engine.predict(imgs)
    loaded = torch.cuda.memory_allocated()
    assert engine.graph_memory_bytes() > 0 and loaded > before
    engine.close()
    after = torch.cuda.memory_allocated()
    assert abs(after - before) < 16 << 20, (before, loaded, after)
    assert engine.graph_memory_bytes() == 0
    with pytest.raises(EngineClosed):
        engine.predict(imgs)
    engine.close()  # idempotent


# --- observability on the card ----------------------------------------------


@pytest.mark.cuda
def test_cuda_batch_device_time_matches_its_graph_replay():
    """A bucket-16 batch's device time from its handle (a timing event just
    before the graph's replay to the event after its D2H copy) lies within
    10% of the bucket graph's replay timed alone (``clothing-model``, 299
    px)."""
    _need_cuda()
    from kubernetes_deep_learning_tpu_torch.export.artifact import ModelArtifact
    from kubernetes_deep_learning_tpu_torch.modelspec import CLOTHING_MODEL
    from kubernetes_deep_learning_tpu_torch.models import init_variables
    from kubernetes_deep_learning_tpu_torch.runtime import InferenceEngine

    artifact = ModelArtifact(CLOTHING_MODEL, init_variables(CLOTHING_MODEL, seed=0),
                             {"compute_dtype": "bfloat16"})
    engine = InferenceEngine(artifact, buckets=(16,), device="cuda")
    try:
        engine.warmup()
        imgs = np.random.default_rng(16).integers(0, 256, (16, 299, 299, 3), np.uint8)
        device_ms = []
        for _ in range(10):
            handle, _ = engine.predict_async(imgs)
            np.asarray(handle)
            device_ms.append(handle.device_seconds * 1e3)
        graph = engine._graphs[16].graph
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(10):
            graph.replay()
        end.record()
        end.synchronize()
        graph_ms = start.elapsed_time(end) / 10
        assert abs(float(np.median(device_ms)) / graph_ms - 1.0) < 0.1, (device_ms, graph_ms)
    finally:
        engine.close()


def _observed_server(tmp_path):
    """A started, warmed card server of the 96-px Xception (buckets 1, 4)
    and a one-image msgpack POST to it."""
    import urllib.request

    from kubernetes_deep_learning_tpu_torch.export import artifact as art
    from kubernetes_deep_learning_tpu_torch.models import init_variables
    from kubernetes_deep_learning_tpu_torch.serving import protocol
    from kubernetes_deep_learning_tpu_torch.serving.model_server import ModelServer

    spec, _, _ = _engine_case("xception")
    art.save_artifact(art.version_dir(str(tmp_path), spec.name, 1), spec,
                      init_variables(spec, seed=0), {"compute_dtype": "bfloat16"})
    server = ModelServer(str(tmp_path), port=0, buckets=(1, 4), device="cuda",
                         profile_base=str(tmp_path / "profiles"))
    server.start()
    server.warmup()
    body = protocol.encode_predict_request(np.zeros((1, *spec.input_shape), np.uint8))

    def post() -> int:
        req = urllib.request.Request(
            f"http://127.0.0.1:{server.port}/v1/models/{spec.name}:predict", data=body,
            method="POST", headers={"Content-Type": protocol.MSGPACK_CONTENT_TYPE})
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status

    return spec, server, post


@pytest.mark.cuda
def test_cuda_mfu_and_busy_gauges_appear_after_traffic(tmp_path):
    _need_cuda()
    import re

    spec, server, post = _observed_server(tmp_path)
    try:
        assert all(post() == 200 for _ in range(8))
        text = server.handle_get("/metrics")[1].decode()
        mfu = re.findall(rf'^kdlt_mfu_pct{{model="{spec.name}",version="1",bucket="(\d+)"}} (\S+)$',
                         text, re.M)
        assert mfu and all(0 < float(v) <= 100 for _, v in mfu), mfu
        busy = re.search(rf'^kdlt_device_busy_ratio{{model="{spec.name}",version="1"}} (\S+)$',
                         text, re.M)
        assert busy and 0 < float(busy.group(1)) <= 1
    finally:
        server.shutdown()


@pytest.mark.cuda
def test_cuda_debug_profile_under_traffic_names_the_stage_kernel(tmp_path):
    """A 1 s /debug/profile while a client sends requests: the reply's
    ``kernels`` summary names K1/K2's symbol, and trace.json parses."""
    _need_cuda()
    import json
    import os
    import threading

    spec, server, post = _observed_server(tmp_path)
    stop = threading.Event()
    statuses = []

    def load():
        while not stop.is_set():
            statuses.append(post())

    client = threading.Thread(target=load, daemon=True)
    try:
        client.start()
        status, body, _, _ = server.handle_get("/debug/profile?seconds=1")
        stop.set()
        client.join(timeout=30)
        assert status == 200 and statuses and set(statuses) == {200}
        got = json.loads(body)
        assert any("sepconv_stage_kernel" in k for k in got["kernels"]), got["kernels"]
        with open(os.path.join(got["trace_dir"], "trace.json")) as f:
            assert json.load(f)["traceEvents"]
    finally:
        stop.set()
        server.shutdown()


_TRACE_VS_KINETO = r"""
import json, sys, time
import torch
from torch.profiler import ProfilerActivity, profile
from kubernetes_deep_learning_tpu_torch.ops import _native

out_dir = sys.argv[1]
a = torch.randn(4096, 4096, device="cuda", dtype=torch.bfloat16)
host = torch.empty(4096, 1024, dtype=torch.bfloat16, pin_memory=True)


def work():
    for _ in range(16):
        torch.mm(a, a)
    host.copy_(a[:, :1024], non_blocking=True)
    torch.cuda.synchronize()


work()  # cuBLAS picks its kernels
with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
    work()
prof.export_chrome_trace(out_dir + "/kineto.json")
trace = _native.DeviceTrace()
t0 = time.time()
trace.start()
work()
trace.stop()
t1 = time.time()
summary = trace.write(out_dir + "/device.json", 10)
try:
    trace.write(out_dir + "/again.json", 10)
    again = "written twice"
except RuntimeError as e:
    again = str(e)
print(json.dumps({"t0": t0, "t1": t1, "summary": summary, "again": again}))
"""


@pytest.mark.cuda
def test_cuda_device_trace_reads_the_records_as_torch_profiler_does(tmp_path):
    """``native/cupti_trace.cc`` reads CUPTI's records through its own
    declarations of their layouts (the card has no cupti.h): in a fresh
    process, the same work recorded by torch.profiler (kineto) and then by
    ``DeviceTrace`` gives the same kernels with the same counts (16 GEMMs
    and a copy kernel), mean durations within 10%, the same copy's byte
    count, and timestamps inside the recording's wall window (kineto runs
    first and leaves CUPTI its own timestamp source, which the collector
    rescales).  A fresh process, because once the collector has registered
    its CUPTI callbacks, a later torch.profiler in that process misses
    records."""
    _need_cuda()
    import json
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    done = subprocess.run([sys.executable, "-c", _TRACE_VS_KINETO, str(tmp_path)],
                          capture_output=True, text=True, timeout=300, cwd=root,
                          env={**os.environ, "PYTHONPATH": root})
    assert done.returncode == 0, done.stderr[-3000:]
    res = json.loads(done.stdout.strip().splitlines()[-1])

    def events(path):
        with open(path) as f:
            trace = json.load(f)["traceEvents"]
        kernels: dict = {}
        for e in trace:
            if e.get("cat") == "kernel":
                kernels.setdefault(e["name"], []).append(e)
        copies = sorted(e["args"]["bytes"] for e in trace if e.get("cat") == "gpu_memcpy")
        return kernels, copies

    want, want_copies = events(tmp_path / "kineto.json")
    got, got_copies = events(tmp_path / "device.json")
    assert {k: len(v) for k, v in got.items()} == {k: len(v) for k, v in want.items()}
    assert sorted(len(v) for v in got.values())[-1] == 16
    assert got_copies == want_copies == [4096 * 1024 * 2]
    t0, t1 = res["t0"] * 1e6, res["t1"] * 1e6
    for name, evs in got.items():
        mean = np.mean([e["dur"] for e in evs])
        assert abs(mean / np.mean([e["dur"] for e in want[name]]) - 1) < 0.1, name
        assert all(t0 <= e["ts"] and e["ts"] + e["dur"] <= t1 for e in evs), name
        assert res["summary"][name]["count"] == len(evs)
    assert "no stopped device trace" in res["again"]


# --- int8 quantization: Q1 and Q2, the w8a8 engine --------------------------

# Every (side, C_in, C_out, k, stride, padding) at which clothing-model's
# w8a8 forward (299 px) launches Q1, and every (side, C) of Q2; then shapes
# with a K tail (C_in 40: K = 48 and 432 after the codes' 16-channel pad,
# neither a multiple of 128) and an N tail (C_out 24 and 200).  Q1's routes:
# 1x1/1 by 2-D TMA (the pointwise convs; C_in 34 pads to 48), a k x k
# gather (block1_conv2, the stem, the 3x3s), 1x1/2 by TMA on its sampled
# pixels (the residual convs), C_in 3 and 34 (not multiples of 16), M =
# batch (the squeeze-excite convs), and C_out 728 and 200 (a part N tile).
INT8_CONV_SHAPES = (
    (149, 32, 64, 3, 1, "VALID"),   # block1_conv2
    (147, 64, 128, 1, 2, "SAME"),   # residual convs, 1x1/2
    (74, 128, 256, 1, 2, "SAME"),
    (37, 256, 728, 1, 2, "SAME"),
    (19, 728, 1024, 1, 2, "SAME"),
    (147, 64, 128, 1, 1, "VALID"),  # pointwise convs
    (147, 128, 128, 1, 1, "VALID"),
    (74, 128, 256, 1, 1, "VALID"),
    (74, 256, 256, 1, 1, "VALID"),
    (37, 256, 728, 1, 1, "VALID"),
    (37, 728, 728, 1, 1, "VALID"),
    (19, 728, 728, 1, 1, "VALID"),
    (19, 728, 1024, 1, 1, "VALID"),
    (10, 1024, 1536, 1, 1, "VALID"),
    (10, 1536, 2048, 1, 1, "VALID"),
    (9, 40, 24, 1, 1, "VALID"),
    (11, 40, 200, 3, 2, "SAME"),
    (224, 3, 64, 7, 2, ((3, 3), (3, 3))),  # ResNet50's stem: C_in 3, explicit pads
    (56, 64, 64, 3, 1, "SAME"),             # ResNet50's 3x3s, its 1x1/2 projections
    (56, 256, 512, 1, 2, "SAME"),
    (1, 34, 816, 1, 1, "SAME"),             # EfficientNet-B3's squeeze-excite convs
    (1, 816, 34, 1, 1, "SAME"),
    (9, 34, 136, 1, 1, "VALID"),            # 1x1/1 by TMA on C_pad 48
    (17, 10, 40, 3, 2, "SAME"),             # a K chunk across two taps
    (12, 6, 20, 5, 1, ((2, 1), (0, 3))),    # asymmetric explicit pads
)
# (side, C, k, stride): Xception's 3x3s, then EfficientNet-B3's stride-2 5x5s
# at 300 px (symmetric pads) and on even sides (pads (1, 2)).
INT8_DEPTHWISE_SHAPES = (
    (37, 728, 3, 1), (19, 728, 3, 1), (10, 1024, 3, 1), (10, 1536, 3, 1), (9, 40, 3, 1),
    (75, 192, 5, 2), (19, 816, 5, 2), (20, 96, 5, 2), (19, 576, 5, 1), (16, 144, 3, 2),
    (10, 1392, 3, 1), (150, 24, 3, 1),
)
INT8_BATCHES = (3, 1)  # not multiples of 8
# Every Q1 GEMM instance (warpgroups, TMA for A), forced on a 1x1/1 shape
# (either route) and a 3x3 one (the gather).
INT8_INSTANCES = tuple((wg, tma) for wg in (1, 2) for tma in (True, False))


def _int8_operands(rng, c_in, c_out, k, groups=1):
    from kubernetes_deep_learning_tpu_torch.ops import int8 as int8_ops

    q = torch.from_numpy(rng.integers(-127, 128, (c_out, c_in // groups, k, k)).astype(np.int8))
    scale = torch.from_numpy(rng.uniform(1e-4, 1e-3, c_out).astype(np.float32)).cuda()
    packed = (int8_ops.pack_depthwise(q) if groups > 1 else int8_ops.pack_conv(q)).cuda()
    return q.cuda(), packed, scale


@pytest.mark.cuda
@pytest.mark.parametrize("batch", INT8_BATCHES)
@pytest.mark.parametrize("shape", INT8_CONV_SHAPES, ids=str)
def test_cuda_int8_conv_equals_its_plain_version(shape, batch):
    """Q1 (quantize pass, then the GEMM instance its shape takes): max abs
    difference 0 against ``int8_conv_reference`` (the quantize-in and
    epilogue are the same f32 operations and the int products exact), on
    inputs whose codes reach the clamp."""
    _need_cuda()
    from kubernetes_deep_learning_tpu_torch.ops import int8 as int8_ops

    side, c_in, c_out, k, stride, padding = shape
    rng = np.random.default_rng(side * c_out + batch)
    x = _t(rng, (batch, side, side, c_in), std=2.0)
    q, packed, scale = _int8_operands(rng, c_in, c_out, k)
    int8_ops.reset_launch_counts()
    got = int8_ops.int8_conv(x, packed, 0.0173, scale, (k, k), stride, padding)
    torch.cuda.synchronize()
    assert int8_ops.launch_counts() == {"int8_conv": 1, "int8_depthwise": 0}
    want = int8_ops.int8_conv_reference(x, q, 0.0173, scale, stride, padding)
    assert got.shape == want.shape
    assert torch.equal(got, want), (got - want).abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(13, 96, 208, 1, "VALID"), (9, 40, 208, 3, "SAME")], ids=str)
@pytest.mark.parametrize("instance", INT8_INSTANCES, ids=str)
def test_cuda_int8_conv_instances_equal_the_plain_version(instance, shape, monkeypatch):
    """Each GEMM instance, forced in place of ``q1_instance``'s choice, with
    a bias: bit-equal to the plain version (TMA for A only where the conv
    is 1x1/1: else the launch is refused)."""
    _need_cuda()
    from kubernetes_deep_learning_tpu_torch.ops import int8 as int8_ops

    side, c_in, c_out, k, padding = shape
    rng = np.random.default_rng(side * c_out)
    x = _t(rng, (3, side, side, c_in), std=2.0)
    q, packed, scale = _int8_operands(rng, c_in, c_out, k)
    bias = _t(rng, (c_out,), 0.5)
    monkeypatch.setattr(int8_ops, "q1_instance", lambda *args: instance)
    if instance[1] and k != 1:
        with pytest.raises(RuntimeError, match="int8 conv launch failed"):
            int8_ops.int8_conv(x, packed, 0.0173, scale, (k, k), 1, padding, bias)
        return
    got = int8_ops.int8_conv(x, packed, 0.0173, scale, (k, k), 1, padding, bias)
    torch.cuda.synchronize()
    want = int8_ops.int8_conv_reference(x, q, 0.0173, scale, 1, padding, bias=bias)
    assert torch.equal(got, want), (got - want).abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("sample", [None, (2, 0, 0, 6, 4), (2, 1, 1, 7, 5)], ids=str)
@pytest.mark.parametrize("c", [3, 34, 64, 728])
def test_cuda_int8_codes_equal_the_plain_version(c, sample):
    """Q1's quantize pass: ``quantize_input``'s codes bit for bit, the
    channel stride padded to 16 with code 0; sampled as a 1x1 conv of
    stride 2 reads them (top/left pads 0 and 1), code 0 outside."""
    _need_cuda()
    from kubernetes_deep_learning_tpu_torch.ops import int8 as int8_ops

    rng = np.random.default_rng(c)
    x = _t(rng, (3, 11, 7, c), std=2.0)
    codes = int8_ops.int8_codes(x, 0.0173, sample=sample)
    torch.cuda.synchronize()
    want = int8_ops.int8_codes(x.cpu(), 0.0173, sample=sample)
    assert codes.dtype == torch.int8 and codes.shape[-1] == int8_ops.code_width(c)
    assert torch.equal(codes.cpu(), want) and codes.abs().max().item() == 127
    if sample is None:
        assert torch.equal(codes[..., :c], int8_ops.quantize_input(x, 0.0173).to(torch.int8))


@pytest.mark.cuda
@pytest.mark.parametrize("batch", INT8_BATCHES)
@pytest.mark.parametrize("shape", INT8_DEPTHWISE_SHAPES, ids=str)
def test_cuda_int8_depthwise_equals_its_plain_version(shape, batch):
    _need_cuda()
    from kubernetes_deep_learning_tpu_torch.ops import int8 as int8_ops

    side, c, k, stride = shape
    rng = np.random.default_rng(side * c + batch)
    x = _t(rng, (batch, side, side, c), std=2.0)
    q, packed, scale = _int8_operands(rng, c, c, k, groups=c)
    int8_ops.reset_launch_counts()
    got = int8_ops.int8_depthwise(x, packed, 0.0173, scale, stride=stride)
    torch.cuda.synchronize()
    assert int8_ops.launch_counts() == {"int8_conv": 0, "int8_depthwise": 1}
    want = int8_ops.int8_conv_reference(x, q, 0.0173, scale, stride, "SAME", c)
    assert got.shape == want.shape
    assert torch.equal(got, want), (got - want).abs().max().item()


@pytest.mark.cuda
def test_cuda_int8_kernels_refuse_what_they_cannot_take():
    _need_cuda()
    from kubernetes_deep_learning_tpu_torch.ops import int8 as int8_ops

    rng = np.random.default_rng(0)
    _, packed, scale = _int8_operands(rng, 16, 16, 7, groups=16)
    with pytest.raises(ValueError, match="no int8 kernel"):
        int8_ops.int8_depthwise(_t(rng, (1, 9, 9, 16)), packed, 0.01, scale)
    _, packed, scale = _int8_operands(rng, 6, 6, 3, groups=6)
    with pytest.raises(ValueError, match="multiples of 4"):
        int8_ops.int8_depthwise(_t(rng, (1, 9, 9, 6)), packed, 0.01, scale)
    _, packed, scale = _int8_operands(rng, 16, 16, 3, groups=16)
    with pytest.raises(ValueError, match="no int8 kernel"):
        int8_ops.int8_depthwise(_t(rng, (1, 9, 9, 16)), packed, 0.01, scale, stride=3)


def _w8a8_engine(tmp_path, compute_dtype: str, miscalibrated: bool = False, buckets=(2, 8),
                 spec=None):
    """A model v1 (default the 96-px Xception) and its w8a8 version
    (calibrated on the card from 8 noise images at percentile 100), served
    by an engine on the card."""
    from kubernetes_deep_learning_tpu_torch.export import artifact as art
    from kubernetes_deep_learning_tpu_torch.models import init_variables
    from kubernetes_deep_learning_tpu_torch.ops import quantize
    from kubernetes_deep_learning_tpu_torch.runtime import InferenceEngine

    spec = spec or _engine_case("xception")[0]
    root = str(tmp_path)
    art.save_artifact(art.version_dir(root, spec.name, 1), spec, init_variables(spec, seed=1),
                      {"compute_dtype": compute_dtype})
    path = quantize.write_quantized_version(
        root, spec.name, quantize.SCHEME_W8A8,
        calib_images=quantize.representative_images(spec, 8, seed=7), percentile=100.0)
    artifact = art.load_artifact(path)
    if miscalibrated:
        def scaled(tree):
            if not isinstance(tree, dict):
                return tree
            out = {k: scaled(v) for k, v in tree.items()}
            if quantize.ACT_SCALE_KEY in tree:
                out[quantize.ACT_SCALE_KEY] = np.asarray(
                    tree[quantize.ACT_SCALE_KEY] * np.float32(1e3), np.float32)
            return out
        artifact.variables = scaled(artifact.variables)
    return InferenceEngine(artifact, buckets=buckets, device="cuda")


@pytest.mark.cuda
def test_cuda_w8a8_engine_replays_its_graphs_bit_equal_to_eager(tmp_path):
    """A w8a8 engine (float32 compute dtype, so the gate's reference is the
    exact graph): the gate passes, every replay launches 39 Q1 and 29 Q2
    and no stage kernel, and the replay equals the eager forward bit for
    bit."""
    _need_cuda()
    from kubernetes_deep_learning_tpu_torch.ops import int8 as int8_ops
    from kubernetes_deep_learning_tpu_torch.ops import quantize

    engine = _w8a8_engine(tmp_path, "float32")
    engine.warmup()
    assert engine.quantization_active == quantize.SCHEME_W8A8, engine.quant_gate_drift
    rng = np.random.default_rng(9)
    for n, bucket in ((2, 2), (5, 8)):
        imgs = rng.integers(0, 256, (n, 96, 96, 3), np.uint8)
        int8_ops.reset_launch_counts()
        ops.reset_launch_counts()
        rows = np.asarray(engine.predict_async(imgs)[0])
        assert int8_ops.launch_counts() == {"int8_conv": 39, "int8_depthwise": 29}
        assert not any(ops.launch_counts().values())
        padded = np.zeros((bucket, 96, 96, 3), np.uint8)
        padded[:n] = imgs
        with torch.inference_mode():
            eager = engine._forward(torch.from_numpy(padded).cuda()).cpu().numpy()
        assert np.isfinite(rows).all()
        np.testing.assert_array_equal(rows, eager)
    engine.close()


# family -> (side, preprocessing, Q1 and Q2 launches a forward)
W8A8_FAMILIES = {
    "resnet50": (64, "caffe", {"int8_conv": 53, "int8_depthwise": 0}),
    "efficientnet-b0": (64, "torch", {"int8_conv": 46, "int8_depthwise": 11}),
}


@pytest.mark.cuda
@pytest.mark.parametrize("family", list(W8A8_FAMILIES))
def test_cuda_w8a8_engine_of_another_family_replays_bit_equal_to_eager(tmp_path, family):
    """ResNet50 and EfficientNet-B0 as w8a8 (float32 compute dtype): the
    gate passes, every replay launches one Q1 or Q2 per calibrated layer and
    no K4, and equals the eager forward bit for bit."""
    _need_cuda()
    from kubernetes_deep_learning_tpu_torch.modelspec import ModelSpec
    from kubernetes_deep_learning_tpu_torch.ops import int8 as int8_ops
    from kubernetes_deep_learning_tpu_torch.ops import quantize

    side, preprocessing, per_forward = W8A8_FAMILIES[family]
    spec = ModelSpec(name=f"w8a8-{family}", family=family, input_shape=(side, side, 3),
                     labels=("a", "b", "c"), preprocessing=preprocessing)
    engine = _w8a8_engine(tmp_path, "float32", spec=spec)
    engine.warmup()
    assert engine.quantization_active == quantize.SCHEME_W8A8, engine.quant_gate_drift
    rng = np.random.default_rng(9)
    for n, bucket in ((2, 2), (5, 8)):
        imgs = rng.integers(0, 256, (n, side, side, 3), np.uint8)
        int8_ops.reset_launch_counts()
        fused_mbconv.reset_launch_counts()
        rows = np.asarray(engine.predict_async(imgs)[0])
        assert int8_ops.launch_counts() == per_forward
        assert not any(fused_mbconv.launch_counts().values())
        padded = np.zeros((bucket, side, side, 3), np.uint8)
        padded[:n] = imgs
        with torch.inference_mode():
            eager = engine._forward(torch.from_numpy(padded).cuda()).cpu().numpy()
        assert np.isfinite(rows).all()
        np.testing.assert_array_equal(rows, eager)
    engine.close()


@pytest.mark.cuda
def test_cuda_gate_refusal_recaptures_weight_only_and_close_gives_memory_back(tmp_path):
    """A miscalibrated w8a8 artifact (activation scales x1000): warmup
    refuses it, frees the w8a8 graphs and re-captures every bucket on the
    capture thread with the weight-only forward (8 K1 + 2 K2 a forward, no
    Q1/Q2); ``close()`` then gives the memory back within 16 MiB."""
    _need_cuda()
    import threading

    from kubernetes_deep_learning_tpu_torch.ops import int8 as int8_ops
    from kubernetes_deep_learning_tpu_torch.ops import quantize
    from kubernetes_deep_learning_tpu_torch.runtime import engine as engine_mod

    _warm_engine("xception").close()  # the capture stream's workspace lives on
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    engine = _w8a8_engine(tmp_path, "bfloat16", miscalibrated=True)
    threads = []
    capture = engine._capture

    def spy(bucket, staged):
        threads.append(threading.current_thread().name)
        return capture(bucket, staged)

    engine._capture = spy
    engine.warmup()
    assert engine.quant_gate_failed and engine.fast
    assert engine.quantization_active == quantize.SCHEME
    assert engine._m_quant["gate_failures"].value == 1.0
    assert len(threads) == 4 and all(t.startswith("kdlt-capture") for t in threads), threads
    assert engine_mod._capture_thread is not None
    imgs = np.random.default_rng(3).integers(0, 256, (5, 96, 96, 3), np.uint8)
    int8_ops.reset_launch_counts()
    ops.reset_launch_counts()
    engine.predict(imgs)
    assert ops.launch_counts() == {"fused_sepconv_block": 8, "fused_sepconv_chain": 2}
    assert not any(int8_ops.launch_counts().values())
    engine.close()
    after = torch.cuda.memory_allocated()
    assert abs(after - before) < 16 << 20, (before, after)


# --- the ingest path: decode and resize on this host, the bytes wire --------

_FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "ingest_fixtures")
_FIXTURE_FILES = sorted(f for f in os.listdir(_FIXTURES)
                        if not f.endswith(".npy") and os.path.isfile(os.path.join(_FIXTURES, f)))
_FORMATS = os.path.join(_FIXTURES, "formats")


def _format_digests() -> dict:
    import json

    with open(os.path.join(_FORMATS, "digests.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("name", _FIXTURE_FILES)
def test_host_decodes_the_committed_fixtures_to_pils_pixels(name):
    """The port's decoder on this machine's host (which has no PIL) gives
    the pixels PIL gave when the fixture was written (``test_torch_ingest``
    holds the ``.npy`` to PIL where PIL is).  Needs no card."""
    from kubernetes_deep_learning_tpu_torch.ops import preprocess

    with open(os.path.join(_FIXTURES, name), "rb") as f:
        got = preprocess.decode_image(f.read())
    np.testing.assert_array_equal(got, np.load(os.path.join(_FIXTURES, name + ".npy")))


@pytest.mark.parametrize("name", sorted(_format_digests()))
def test_host_decodes_the_format_fixtures_to_their_pil_digests(name):
    """Progressive and 4-component JPEG, 4:4:0, 4:1:1, 16-bit and Adam7 PNG
    (``tests/ingest_fixtures/formats``) decode on this host to the shape and
    pixel digest PIL gave (``test_torch_ingest_formats`` recomputes them
    with PIL).  Needs no card."""
    import hashlib

    from kubernetes_deep_learning_tpu_torch.ops import preprocess

    entry = _format_digests()[name]
    with open(os.path.join(_FORMATS, name), "rb") as f:
        got = preprocess.decode_image(f.read())
    assert list(got.shape) == entry["shape"]
    assert hashlib.sha256(got.tobytes()).hexdigest() == entry["sha256"]


@pytest.mark.parametrize("filter", ["nearest", "bilinear"])
def test_host_resize_equals_pils_on_the_committed_fixture(filter):
    """The port's resize on this host, up and down, against PIL's pixels."""
    import re

    from kubernetes_deep_learning_tpu_torch.ops import preprocess

    want = [f for f in os.listdir(_FIXTURES) if f".{filter}-" in f]
    assert len(want) == 2
    for f in want:
        h, w = map(int, re.search(r"-(\d+)x(\d+)\.npy$", f).groups())
        source = np.load(os.path.join(_FIXTURES, f.split(f".{filter}-")[0] + ".npy"))
        np.testing.assert_array_equal(preprocess.resize_uint8(source, (h, w), filter),
                                      np.load(os.path.join(_FIXTURES, f)))


@pytest.mark.cuda
def test_cuda_bytes_wire_replays_the_bucket_graphs(tmp_path):
    """A bytes-wire ``:predict`` (two encoded fixtures, decoded and resized
    by the server) on the card: served by the bucket graphs' replays (no
    eager forward after warmup), 8 K1 and 2 K2 launches a forward, and the
    same logits as the tensor wire for the locally decoded pixels."""
    _need_cuda()
    import json
    import urllib.request

    from kubernetes_deep_learning_tpu_torch.ops import preprocess
    from kubernetes_deep_learning_tpu_torch.serving import protocol

    spec, server, _ = _observed_server(tmp_path)
    try:
        engine = server.engines[spec.name]
        eager = []
        forward = engine._forward
        engine._forward = lambda x: (eager.append(x.shape), forward(x))[1]
        blobs = []
        for name in ("q90_444_37x29.jpg", "palette_23x17.png"):
            with open(os.path.join(_FIXTURES, name), "rb") as f:
                blobs.append(f.read())
        url = f"http://127.0.0.1:{server.port}/v1/models/{spec.name}:predict"

        def post(body, ctype):
            req = urllib.request.Request(url, data=body, method="POST",
                                         headers={"Content-Type": ctype})
            with urllib.request.urlopen(req, timeout=60) as r:
                return r.status, r.read(), r.headers.get("Content-Type", "")

        ops.reset_launch_counts()
        status, body, ctype = post(protocol.encode_bytes_predict_request(blobs),
                                   protocol.BYTES_CONTENT_TYPE)
        assert status == 200 and ctype == protocol.JSON_CONTENT_TYPE
        assert ops.launch_counts() == {"fused_sepconv_block": 8, "fused_sepconv_chain": 2}
        assert not eager
        got = np.asarray([list(p.values()) for p in json.loads(body)["predictions"]], np.float32)
        pixels = np.stack([preprocess.resize_uint8(preprocess.decode_image(b),
                                                   spec.input_shape[:2], spec.resize_filter)
                           for b in blobs])
        status, body, ctype = post(protocol.encode_predict_request(pixels),
                                   protocol.MSGPACK_CONTENT_TYPE)
        np.testing.assert_array_equal(got, protocol.decode_predict_response(body, ctype)[0])
    finally:
        server.shutdown()


# --- device-resize staging (KDLT_INGEST_DEVICE_RESIZE) ---------------------------


def _staged_engine(resize_filter: str = "bilinear", staging: str = "150x131"):
    """A warmed 96-px Xception engine on the card (buckets 1 and 4) with
    device-resize staging at ``staging``."""
    from kubernetes_deep_learning_tpu_torch.export.artifact import ModelArtifact
    from kubernetes_deep_learning_tpu_torch.modelspec import ModelSpec
    from kubernetes_deep_learning_tpu_torch.models import init_variables
    from kubernetes_deep_learning_tpu_torch.runtime import InferenceEngine

    spec = ModelSpec(name="tiny-staged", family="xception", input_shape=(96, 96, 3),
                     labels=("a", "b", "c"), preprocessing="tf", resize_filter=resize_filter)
    artifact = ModelArtifact(spec, init_variables(spec, seed=0), {"compute_dtype": "bfloat16"})
    engine = InferenceEngine(artifact, buckets=(1, 4), device="cuda", ingest_resize=staging)
    engine.warmup()
    return engine


@pytest.mark.cuda
@pytest.mark.parametrize("resize_filter", ["bilinear", "nearest"])
def test_cuda_staged_graph_replays_its_eager_form_bit_equal(resize_filter):
    """The staged program's bucket graphs (captured by warmup, one per
    bucket, beside the plain ones) replay the eager staged forward's bits
    on the same padded batch, and each replay credits 8 K1 and 2 K2
    launches: the forward inside it is the fused path."""
    _need_cuda()
    engine = _staged_engine(resize_filter)
    assert sorted(engine._staged_graphs) == sorted(engine._graphs) == [1, 4]
    imgs = np.random.default_rng(21).integers(0, 256, (3, 150, 131, 3), np.uint8)
    ops.reset_launch_counts()
    handle, n = engine.predict_ingest_async(imgs)
    got = np.asarray(handle)[:n]
    assert ops.launch_counts() == {"fused_sepconv_block": 8, "fused_sepconv_chain": 2}
    padded = np.concatenate([imgs, np.zeros((1, 150, 131, 3), np.uint8)])
    with torch.inference_mode():
        eager = engine._staged_forward(torch.from_numpy(padded).cuda()).float().cpu().numpy()
    np.testing.assert_array_equal(got, eager[:3])
    engine.close()


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["linear", "nearest"])
def test_cuda_resize_in_a_graph_stays_in_true_float32(method):
    """The resize captured into a CUDA graph, as the staged program holds
    it, against its float64 products on the CPU: within 1e-3 at 512 -> 299
    (TF32 products would miss by ~0.1 at pixel values up to 255)."""
    _need_cuda()
    from kubernetes_deep_learning_tpu_torch.ops import resize as resize_lib

    rz = resize_lib.Resize((512, 384), (299, 299), method, "cuda")
    x = torch.from_numpy(np.random.default_rng(5).integers(0, 256, (4, 512, 384, 3)).astype(
        np.float32)).cuda()
    rz(x)  # warm cuBLAS outside the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = rz(x)
    graph.replay()
    torch.cuda.synchronize()
    assert not torch.backends.cuda.matmul.allow_tf32
    if method == "linear":
        wh = torch.from_numpy(resize_lib.weight_matrix(512, 299)).double()
        ww = torch.from_numpy(resize_lib.weight_matrix(384, 299)).double()
        want = torch.einsum("nhwc,ho,wp->nopc", x.double().cpu(), wh, ww)
    else:
        hi = torch.from_numpy(resize_lib.nearest_indices(512, 299).copy())
        wi = torch.from_numpy(resize_lib.nearest_indices(384, 299).copy())
        want = x.double().cpu()[:, hi][:, :, wi]
    assert float((out.double().cpu() - want).abs().max()) < 1e-3


@pytest.mark.cuda
def test_cuda_engine_close_gives_the_staged_graphs_memory_back():
    """An engine with device-resize staging, warmed and served, closed:
    ``memory_allocated`` is back within 16 MiB of its value before it was
    built, and its plain and staged graphs are gone."""
    _need_cuda()
    from kubernetes_deep_learning_tpu_torch.runtime import EngineClosed

    _staged_engine().close()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    engine = _staged_engine(staging="512x512")
    imgs = np.random.default_rng(16).integers(0, 256, (3, 512, 512, 3), np.uint8)
    np.asarray(engine.predict_ingest_async(imgs)[0])
    assert engine.graph_memory_bytes() > 0 and torch.cuda.memory_allocated() > before
    engine.close()
    after = torch.cuda.memory_allocated()
    assert abs(after - before) < 16 << 20, (before, after)
    assert engine.graph_memory_bytes() == 0 and not engine._staged_graphs
    with pytest.raises(EngineClosed):
        engine.predict_ingest_async(imgs)


@pytest.mark.cuda
def test_cuda_xception_train_step_matches_the_cpu_step():
    """One f32 Xception train step (the clothing model's family at full
    width, a hidden head layer, 32 px, batch 16, SGD) on the card with TF32
    off (``create_train_state`` calls ``models.exact_float32``) against the
    same step on the CPU: the loss within 1e-5, every new running statistic
    within 1e-4 of its update, and each tensor's SGD update within 1e-3 of
    its largest element plus 2e-2 of the largest update in the model.
    These are ``tests/test_torch_training_bn_xception.py``'s tolerances
    against float64, the floor doubled: both sides here carry float32
    error (cuDNN and the CPU sum in other orders).  The images differ as
    photographs do, as in that file."""
    _need_cuda()
    import functools

    from kubernetes_deep_learning_tpu_torch.modelspec import ModelSpec
    from kubernetes_deep_learning_tpu_torch.models import init_variables
    from kubernetes_deep_learning_tpu_torch.training import build_train_step, create_train_state

    spec = ModelSpec(name="cuda-train-xception", family="xception", input_shape=(32, 32, 3),
                     labels=("a", "b", "c"), preprocessing="tf", head_hidden=(8,))
    tree = init_variables(spec, seed=3)
    rng = np.random.default_rng(1)
    yy, xx = np.meshgrid(np.linspace(-1, 1, 32), np.linspace(-1, 1, 32), indexing="ij")
    tilt = rng.uniform(-60, 60, (16, 2, 1, 1, 3))
    images = (rng.uniform(40, 215, (16, 1, 1, 3)) + tilt[:, 0] * yy[..., None]
              + tilt[:, 1] * xx[..., None] + rng.normal(0, 20, (16, 32, 32, 3)))
    images = np.clip(np.rint(images), 0, 255).astype(np.uint8)
    labels = rng.integers(0, 3, (16,), np.int32)
    tx = functools.partial(torch.optim.SGD, lr=0.5)
    out = {}
    for device in ("cpu", "cuda"):
        state = create_train_state(spec, tx, variables=tree, device=device)
        old = {k: t.detach().cpu().clone() for k, t in {**state.params,
                                                         **state.batch_stats}.items()}
        state, m = build_train_step(spec)(state, images, labels)
        new = {k: t.detach().cpu() for k, t in {**state.params, **state.batch_stats}.items()}
        out[device] = (float(m["loss"]), new)
    assert not torch.backends.cudnn.allow_tf32 and not torch.backends.cuda.matmul.allow_tf32
    (want_loss, want), (got_loss, got) = out["cpu"], out["cuda"]
    assert abs(got_loss - want_loss) <= 1e-5 * want_loss
    top = max(float((want[k] - old[k]).abs().max()) for k in want if "running" not in k)
    for k in want:
        step = float((want[k] - old[k]).abs().max())
        err = float((got[k] - want[k]).abs().max())
        if k.endswith(("running_mean", "running_var")):
            assert err <= 1e-4 * step, (k, err)
        else:
            assert err <= 1e-3 * step + 2e-2 * top, (k, err)


@pytest.mark.cuda
def test_cuda_h5lite_reads_the_smoke_writers_keras_file(tmp_path):
    """On the card's machine (no h5py): a 96-px Xception written as the
    reference .h5's layout by ``chip_smoke._write_h5`` and imported by
    ``models.keras_import`` (``h5lite``) gives back every leaf bit-equal."""
    _need_cuda()
    import chip_smoke
    from kubernetes_deep_learning_tpu_torch.models import init_variables
    from kubernetes_deep_learning_tpu_torch.models.keras_import import load_keras_h5
    from kubernetes_deep_learning_tpu_torch.modelspec import ModelSpec

    spec = ModelSpec(name="h5-cuda-xception", family="xception", input_shape=(96, 96, 3),
                     labels=("a", "b", "c"), preprocessing="tf", head_hidden=(16,))
    tree = init_variables(spec, seed=4)
    path = str(tmp_path / "model.h5")
    chip_smoke._write_h5(path, chip_smoke._keras_tree(tree))
    want, got = chip_smoke._flat_leaves(tree), chip_smoke._flat_leaves(load_keras_h5(spec, path))
    assert sorted(want) == sorted(got)
    for k, v in want.items():
        assert got[k].dtype == np.float32 and got[k].tobytes() == np.ascontiguousarray(v).tobytes()


@pytest.mark.cuda
def test_cuda_exported_artifact_serves_on_the_stage_kernels(tmp_path):
    """``kdlt-torch-export --seed`` (bf16 compute): the artifact serves on
    the card through its bucket graphs, 8 K1 and 2 K2 launches a forward,
    within 5e-2 (relative) of the same version on the exact float32 graph."""
    _need_cuda()
    from kubernetes_deep_learning_tpu_torch import modelspec
    from kubernetes_deep_learning_tpu_torch.export import artifact as art
    from kubernetes_deep_learning_tpu_torch.export import exporter
    from kubernetes_deep_learning_tpu_torch.runtime import InferenceEngine

    spec = modelspec.register_spec(modelspec.ModelSpec(
        name="cuda-export-xception", family="xception", input_shape=(96, 96, 3),
        labels=("a", "b", "c"), preprocessing="tf"))
    root = str(tmp_path)
    assert exporter.main(["--model", spec.name, "--seed", "2", "--output", root]) == 0
    a = art.load_artifact(art.version_dir(root, spec.name, 1))
    assert a.metadata["compute_dtype"] == "bfloat16" and a.metadata["init"] == "port-seeded"
    engine = InferenceEngine(a, buckets=(1, 4), device="cuda")
    engine.warmup()
    imgs = np.random.default_rng(5).integers(0, 256, (3, *spec.input_shape), np.uint8)
    ops.reset_launch_counts()
    got = engine.predict(imgs)
    assert ops.launch_counts() == {"fused_sepconv_block": 8, "fused_sepconv_chain": 2}
    exact = InferenceEngine(art.ModelArtifact(a.spec, a.variables, {"compute_dtype": "float32"}),
                            buckets=(4,), device="cuda", fast=False).predict(imgs)
    assert np.isfinite(got).all()
    assert np.abs(got - exact).max() <= 5e-2 * np.abs(exact).max()


@pytest.mark.cuda
def test_cuda_verify_golden_runs_both_checks_on_the_stage_kernels(tmp_path, monkeypatch):
    """``kdlt-torch-verify-golden``'s two engine checks on the card, both
    passing: a 96-px clothing-labelled Xception with its pants bias raised
    to lead by 8 (``chip_smoke._pants_leads``), written by
    ``chip_smoke._write_h5``, against its own exact float32 scores.  The
    served check (bfloat16, ``fast="auto"``) runs on K1/K2: a fresh engine's
    bucket-1 graph makes one forward before its capture and is credited one
    replay, so 2 x (8 K1 + 2 K2); the exact check launches neither."""
    _need_cuda()
    import chip_smoke
    from kubernetes_deep_learning_tpu_torch import modelspec
    from kubernetes_deep_learning_tpu_torch.models import build_forward, init_variables
    from kubernetes_deep_learning_tpu_torch.ops import preprocess
    from kubernetes_deep_learning_tpu_torch.weights import from_jax_variables

    spec = modelspec.ModelSpec(name="cuda-golden-xception", family="xception",
                               input_shape=(96, 96, 3), labels=modelspec.CLOTHING_MODEL.labels,
                               preprocessing="tf", head_hidden=(100,))
    image = str(tmp_path / "image.png")
    with open(image, "wb") as f:
        f.write(chip_smoke._png_bytes(
            np.random.default_rng(6).integers(0, 256, spec.input_shape, np.uint8)))
    with open(image, "rb") as f:
        pixels = torch.from_numpy(preprocess.preprocess_bytes(
            f.read(), spec.input_shape[:2], filter=spec.resize_filter)[None]).cuda()

    def exact(tree) -> np.ndarray:
        forward = build_forward(spec, from_jax_variables(tree), torch.float32, fast=False,
                                device="cuda")
        with torch.inference_mode():
            return forward(pixels)[0].cpu().numpy()

    variables = init_variables(spec, seed=7)
    raised = chip_smoke._pants_leads(spec, variables, exact(variables), 8.0)
    h5 = str(tmp_path / "golden.h5")
    chip_smoke._write_h5(h5, chip_smoke._keras_tree(raised))
    want = dict(zip(spec.labels, map(float, exact(raised))))
    monkeypatch.setattr(modelspec, "get_spec", lambda name: spec)
    ops.reset_launch_counts()
    code, text = chip_smoke._golden_both_checks(h5, image, want, "cuda")
    assert code == 0, text
    assert ops.launch_counts() == {"fused_sepconv_block": 16, "fused_sepconv_chain": 4}
    assert "OK: served config (bf16, fast=auto) within atol=0.2" in text


# --- the generative lane on the card -----------------------------------------


@pytest.mark.cuda
def test_cuda_decode_graphs_replay_the_eager_programs():
    """A 2-slot decode engine's warmup captures one graph per fitting
    prefill bucket and one step; each graph, fed the eager function's
    inputs, leaves the cache within 1e-5 of eager's (the trash page aside)
    and returns eager's greedy tokens wherever the top-2 margin is above
    1e-4; a closed engine gives its memory back (within 16 MiB)."""
    _need_cuda()
    from kubernetes_deep_learning_tpu_torch.runtime import decode

    # A first engine, warmed and run eager on this thread, then closed: the
    # cuBLAS workspaces of the capture stream and of this thread's stream
    # live as long as the process.
    first = decode.DecodeEngine("gen-cuda", max_slots=2, page_size=8, max_pages_per_seq=4)
    first.warmup()
    first.logits(decode.STEP, torch.from_numpy(first.step_inputs()).cuda(), first.cache.clone())
    first.close()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    engine = decode.DecodeEngine("gen-cuda", max_slots=2, page_size=8, max_pages_per_seq=4)
    assert engine.warmup()["graphs"] == engine.graphs_captured == 3  # buckets 16, 32 + step
    cache = engine.cache.clone()
    slots, wide = [], 0
    for prompt in ("abc", "a prompt of twenty-one"):
        tokens = decode.encode_prompt(prompt)
        slot = engine.acquire_slot(len(tokens) + 6)
        bucket, packed = engine.prefill_inputs(slot, tokens)
        logits = engine.logits(bucket, torch.from_numpy(packed).cuda(), cache)
        tok = int(engine.materialize(engine.prefill(slot, tokens)))
        if float(logits.topk(2).values.diff().abs()) > 1e-4:
            assert tok == int(logits.argmax())
            wide += 1
        engine.seed_token(slot, int(logits.argmax()))
        slots.append(slot)
    for _ in range(5):
        logits = engine.logits(decode.STEP, torch.from_numpy(engine.step_inputs()).cuda(), cache)
        toks = engine.materialize(engine.step_async())
        rel = (engine.cache[:, :, 1:] - cache[:, :, 1:]).abs().max() / cache[:, :, 1:].abs().max()
        assert float(rel) <= 1e-5
        for slot in slots:
            top2 = logits[slot].topk(2).values
            if float(top2[0] - top2[1]) > 1e-4:
                assert toks[slot] == int(logits[slot].argmax())
                wide += 1
            engine.seed_token(slot, int(logits[slot].argmax()))
    assert wide >= 10
    for slot in slots:
        engine.release_slot(slot)
    engine.close()
    del cache, logits
    torch.cuda.synchronize()
    after = torch.cuda.memory_allocated()
    assert abs(after - before) < 16 << 20, (before, after)
    with pytest.raises(RuntimeError, match="closed"):
        engine.step_async()


@pytest.mark.cuda
def test_cuda_decode_continuous_batch_streams_equal_solo():
    """JAX's five mixed-bucket, mixed-budget requests on the continuous
    scheduler over the graphs: every stream bit-identical to the same
    request's ``decode_solo``, every page back."""
    _need_cuda()
    import threading

    from kubernetes_deep_learning_tpu_torch.runtime import decode

    engine = decode.DecodeEngine("gen-cuda", max_slots=2, page_size=8, max_pages_per_seq=4)
    engine.warmup()
    requests = [("short", 10), ("a much longer prompt string", 4), ("mid-size prompt", 8),
                ("x", 12), ("long-ish prompt here", 6)]
    sched = decode.DecodeScheduler(engine, continuous=True)
    sched.start()
    streamed = {}

    def drive(i, prompt, budget):
        gen = sched.submit(prompt, budget)
        streamed[i] = [ev[2] for ev in gen.iter_events(timeout_s=60.0) if ev[0] == "token"]

    threads = [threading.Thread(target=drive, args=(i, *r)) for i, r in enumerate(requests)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120.0)
    sched.close()
    assert not any(t.is_alive() for t in threads)
    assert (engine.pages_in_use, engine.active_slots) == (0, 0)
    for i, (prompt, budget) in enumerate(requests):
        assert streamed[i] == engine.decode_solo(prompt, budget), i
    engine.close()
