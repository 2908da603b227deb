"""Fused MBConv block: EfficientNet's stride-1 inverted residual.

The port of ``kubernetes_deep_learning_tpu/ops/fused_mbconv.py``.  The
public function takes NHWC bf16 activations, as the JAX NHWC wrapper does:

``fused_mbconv_block(x, w, residual=True)``: 1x1 expand GEMM -> BN -> silu
-> kxk SAME depthwise (k = 3 or 5) -> BN -> silu -> squeeze-excite gate
(spatial mean -> reduce GEMM -> silu -> expand GEMM -> sigmoid) -> 1x1
project GEMM -> BN (-> + x), with ``w`` from ``weights.mbconv_block_weights``.
``residual=False`` serves the stride-1 stage openers whose width changes.

On a CUDA tensor the wrapper launches the hand-written kernels of
``csrc/fused_mbconv.cu`` (three launches: expand and depthwise fused, the
expanded tile kept in shared memory; squeeze-excite; gated projection) and
adds one to its launch count; on a CPU tensor it computes the
plain PyTorch version beside it, ``mbconv_block_reference``.  Both follow
the JAX ``mbconv_block_reference`` rounding point for rounding point:

- expand: bf16 operands, f32 sums, affine and silu in f32, round to bf16;
- depthwise: f32 taps over the bf16 values, affine and silu in f32, round
  to bf16;
- squeeze-excite: the f32 mean of those bf16 values, rounded to bf16 for
  the reduce GEMM (+ bias, silu), rounded to bf16 again for the expand
  GEMM (+ bias, sigmoid); the gate applied as bf16(f32(y) * g);
- project: bf16 operands, f32 sums, affine in f32, round to bf16, then the
  residual added in bf16.

The JAX Pallas kernel keeps the depthwise output in f32 through the
squeeze-excite and the gate; its reference, and so the port, rounds it to
bf16 first (the two agree to bf16 noise, < 2e-2 relative).
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from kubernetes_deep_learning_tpu_torch.ops._counts import LaunchCounts

_counts = LaunchCounts("fused_mbconv_block")
launch_counts = _counts.snapshot
reset_launch_counts = _counts.reset
credit_launches = _counts.credit
_count = _counts.count

# The JAX package fuses a block only where its smallest batch tile (8
# images) fits a VMEM budget: ~8 bytes of working set per expanded element
# against 32 MiB.  The port keeps the rule so it fuses the same blocks.
_JAX_BYTES_PER_ELEM = 8
_JAX_TILE_BUDGET = 32 << 20
_JAX_MIN_TILE = 8
# Depthwise kernel sizes the CUDA kernel is instantiated for.
_KERNEL_SIZES = (3, 5)
# The CUDA kernel's launches, as the bits of its ``phases`` mask.
PHASE_EXPAND_DW, PHASE_SE, PHASE_PROJECT = 1, 2, 4
PHASES_ALL = PHASE_EXPAND_DW | PHASE_SE | PHASE_PROJECT
_SCRATCH_ALIGN = 256  # bytes between the scratch tensor's parts


def fusible_as_in_jax(h: int, w: int, c_mid: int) -> bool:
    """The JAX package's routing rule (its ``mbconv_fusible``): whether a
    stride-1 block at h x w with ``c_mid`` expanded channels is fused.  A
    TPU VMEM limit, kept so both packages fuse the same blocks; the card
    has no such limit."""
    return h * w * _JAX_MIN_TILE * c_mid * _JAX_BYTES_PER_ELEM <= _JAX_TILE_BUDGET


# --- plain PyTorch version ----------------------------------------------------


def _gemm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """bf16 operands, f32 products and sums (a product of two bf16 values is
    exact in f32): the GEMM the tensor cores compute."""
    return a.float() @ b.float()


def mbconv_block_reference(x, w, residual: bool = True):
    """Plain semantics of ``fused_mbconv_block`` (NHWC bf16)."""
    bf16 = torch.bfloat16
    k = w["dw"].shape[0]
    pad = k // 2
    y = F.silu(_gemm(x, w["expand_w"]) * w["expand_s"] + w["expand_b"]).to(bf16)

    h, wd = y.shape[1], y.shape[2]
    yp = F.pad(y, (0, 0, pad, pad, pad, pad))
    acc = torch.zeros(y.shape, dtype=torch.float32, device=y.device)
    for a in range(k):
        for b in range(k):
            acc = acc + yp[:, a : a + h, b : b + wd, :].float() * w["dw"][a, b]
    y = F.silu(acc * w["dw_s"] + w["dw_b"]).to(bf16)

    m = y.float().mean(dim=(1, 2))  # (B, C_mid)
    r = F.silu(_gemm(m.to(bf16), w["se_r_w"]) + w["se_r_b"])
    g = torch.sigmoid(_gemm(r.to(bf16), w["se_e_w"]) + w["se_e_b"])
    y = (y.float() * g[:, None, None, :]).to(bf16)

    z = (_gemm(y, w["proj_w"]) * w["proj_s"] + w["proj_b"]).to(bf16)
    return x + z if residual else z


# --- kernel wrapper -----------------------------------------------------------

_SHAPES = {  # key -> (dims in terms of C_in, C_mid, C_out, S, k), dtype
    "expand_w": (("c_in", "c_mid"), torch.bfloat16),
    "expand_s": (("c_mid",), torch.float32),
    "expand_b": (("c_mid",), torch.float32),
    "dw": (("k", "k", "c_mid"), torch.float32),
    "dw_s": (("c_mid",), torch.float32),
    "dw_b": (("c_mid",), torch.float32),
    "se_r_w": (("c_mid", "s"), torch.bfloat16),
    "se_r_b": (("s",), torch.float32),
    "se_e_w": (("s", "c_mid"), torch.bfloat16),
    "se_e_b": (("c_mid",), torch.float32),
    "proj_w": (("c_mid", "c_out"), torch.bfloat16),
    "proj_s": (("c_out",), torch.float32),
    "proj_b": (("c_out",), torch.float32),
}
_ORDER = tuple(_SHAPES)  # the kernel's argument order


def _check(x, w, residual: bool) -> dict[str, int]:
    if x.dim() != 4 or x.dtype != torch.bfloat16:
        raise ValueError(f"x must be (B,H,W,C) bfloat16, got {tuple(x.shape)} {x.dtype}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")
    if set(w) != set(_SHAPES):
        raise ValueError(f"weights must have the keys {sorted(_SHAPES)}, got {sorted(w)}")
    dims = dict(c_in=x.shape[-1], c_mid=w["expand_w"].shape[-1], c_out=w["proj_w"].shape[-1],
                s=w["se_r_w"].shape[-1], k=w["dw"].shape[0])
    for key, (names, dtype) in _SHAPES.items():
        t, want = w[key], tuple(dims[n] for n in names)
        if tuple(t.shape) != want or t.dtype != dtype:
            raise ValueError(f"{key} must be {want} {dtype}, got {tuple(t.shape)} {t.dtype}")
        if t.device != x.device:
            raise ValueError(f"all operands must be on {x.device}, got {key} on {t.device}")
    if residual and dims["c_out"] != dims["c_in"]:
        raise ValueError(f"a residual block needs C_out == C_in, got {dims['c_in']}->{dims['c_out']}")
    return dims


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _launch(x, w, dims: dict[str, int], residual: bool, phases: int = PHASES_ALL):
    """The kernel's launches on ``x``'s stream.  ``phases`` picks a part
    (``PHASE_EXPAND_DW``, ``PHASE_SE``, ``PHASE_PROJECT``) only to time it:
    a part alone reads whatever scratch the earlier parts left."""
    from kubernetes_deep_learning_tpu_torch.ops import _build

    if not x.is_contiguous() or not all(t.is_contiguous() for t in w.values()):
        raise ValueError("the CUDA kernel takes contiguous tensors only")
    if dims["k"] not in _KERNEL_SIZES:
        raise ValueError(f"the CUDA kernel takes depthwise sizes {_KERNEL_SIZES}, got {dims['k']}")
    for n in ("c_in", "c_mid", "c_out"):
        if dims[n] % 8:
            raise ValueError(f"the CUDA kernel takes widths that are multiples of 8, got {n}={dims[n]}")
    lib = _build.load()
    b, h, wd, _ = x.shape
    c_mid, c_out = dims["c_mid"], dims["c_out"]
    # One scratch tensor: y_dw (B,H,W,C_mid) bf16, the per-band channel sums
    # (B, at most H bands, C_mid) f32 and the gate (B,C_mid) f32.
    sizes = (b * h * wd * c_mid * 2, b * h * c_mid * 4, b * c_mid * 4)
    offsets = [0]
    for n in sizes[:-1]:
        offsets.append(offsets[-1] + -(-n // _SCRATCH_ALIGN) * _SCRATCH_ALIGN)
    scratch = torch.empty(offsets[-1] + sizes[-1], dtype=torch.uint8, device=x.device)
    out = torch.empty((b, h, wd, c_out), dtype=torch.bfloat16, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    base = scratch.data_ptr()
    code = lib.kdlt_mbconv_block(
        x.data_ptr(), *(w[key].data_ptr() for key in _ORDER),
        *(base + off for off in offsets), out.data_ptr(),
        b, h, wd, dims["c_in"], c_mid, c_out, dims["s"], dims["k"],
        _sm_count(x.device.index or 0), int(residual), phases, stream,
    )
    _build.check(lib, code, "mbconv block")
    return out


def fused_mbconv_block(x, w, residual: bool = True):
    """One stride-1 MBConv block (see module doc); NHWC bf16 in and out."""
    dims = _check(x, w, residual)
    if x.device.type == "cpu":
        return mbconv_block_reference(x, w, residual)
    out = _launch(x, w, dims, residual)
    _count("fused_mbconv_block")
    return out
