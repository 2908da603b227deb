"""Fused separable-conv stages: the Xception middle block and exit chains.

The port of ``kubernetes_deep_learning_tpu/ops/fused_sepconv.py``.  Public
functions take NHWC bf16 activations, as the JAX functions' NHWC forms do:

- ``fused_sepconv_block(x, dw, pw, scale, shift)``: one middle block,
  x + 3 x [relu -> 3x3 SAME depthwise -> 1x1 GEMM -> affine], with
  dw (3,3,3,C) f32, pw (3,C,C) bf16, scale/shift (3,C) f32
  (``weights.middle_block_weights``); ``prepare_block`` slices and checks
  those stacked weights once, and ``fused_sepconv_block_stages(x, stages)``
  runs the block over what it returns, checking only ``x`` (the forward's
  per-call path);
- ``fused_sepconv_chain(x, stages)``: [optional relu -> depthwise -> GEMM
  C_in->C_out -> affine -> optional relu] per stage, no residual, no pool
  (``weights.sepconv_stage_weights``).

On a CUDA tensor each wrapper launches the hand-written kernel in
``csrc/fused_sepconv.cu`` (one launch per stage) and adds one to its launch
count; on a CPU tensor it computes the plain PyTorch version beside it
(``sepconv_block_reference`` / ``sepconv_chain_reference``), which rounds at
the same points as the kernel: depthwise in f32 -> bf16, GEMM of bf16
operands in f32, affine in f32 -> bf16.
"""

from __future__ import annotations

import torch

from kubernetes_deep_learning_tpu_torch.ops._counts import LaunchCounts

_counts = LaunchCounts("fused_sepconv_block", "fused_sepconv_chain")
launch_counts = _counts.snapshot
reset_launch_counts = _counts.reset
credit_launches = _counts.credit
_count = _counts.count


# --- plain PyTorch versions ---------------------------------------------------


def stage_reference(y, dw, pw, scale, shift, pre_relu: bool, post_relu: bool):
    """One stage of the stage kernel, plain (NHWC bf16 in and out)."""
    if pre_relu:
        y = torch.relu(y)
    h, w = y.shape[1], y.shape[2]
    yp = torch.nn.functional.pad(y, (0, 0, 1, 1, 1, 1))
    acc = torch.zeros(y.shape, dtype=torch.float32, device=y.device)
    for a in range(3):
        for b in range(3):
            acc = acc + yp[:, a : a + h, b : b + w, :].float() * dw[a, b].float()
    # bf16 operands, f32 products and sums (a product of two bf16 values is
    # exact in f32): the same GEMM the tensor cores compute.
    z = acc.to(torch.bfloat16).float() @ pw.float()
    z = z * scale + shift
    if post_relu:
        z = torch.relu(z)
    return z.to(torch.bfloat16)


def sepconv_block_reference(x, dw, pw, scale, shift):
    """Plain semantics of ``fused_sepconv_block`` (NHWC bf16)."""
    y = x
    for i in range(3):
        y = stage_reference(y, dw[i], pw[i], scale[i], shift[i], True, False)
    return x + y


def _block_stages_reference(x, stages):
    """``sepconv_block_reference`` over ``prepare_block``'s stages."""
    return x + sepconv_chain_reference(x, stages)


def sepconv_chain_reference(x, stages):
    """Plain semantics of ``fused_sepconv_chain`` (NHWC bf16)."""
    y = x
    for s in stages:
        y = stage_reference(
            y, s["dw"], s["pw"], s["scale"], s["shift"], s["pre_relu"], s["post_relu"]
        )
    return y


# --- kernel wrappers ----------------------------------------------------------


def _check_input(x) -> None:
    if x.dim() != 4 or x.dtype != torch.bfloat16:
        raise ValueError(f"x must be (B,H,W,C) bfloat16, got {tuple(x.shape)} {x.dtype}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")


def _check_stage(c_in: int, device, dw, pw, scale, shift) -> int:
    """Validate one stage's weights for a ``c_in``-channel input; returns C_out."""
    if pw.dim() != 2 or pw.shape[0] != c_in or pw.dtype != torch.bfloat16:
        raise ValueError(f"pw must be ({c_in}, C_out) bfloat16, got {tuple(pw.shape)} {pw.dtype}")
    c_out = pw.shape[1]
    if dw.shape != (3, 3, c_in) or dw.dtype != torch.float32:
        raise ValueError(f"dw must be (3,3,{c_in}) float32, got {tuple(dw.shape)} {dw.dtype}")
    for name, t in (("scale", scale), ("shift", shift)):
        if t.shape != (c_out,) or t.dtype != torch.float32:
            raise ValueError(f"{name} must be ({c_out},) float32, got {tuple(t.shape)} {t.dtype}")
    for t in (dw, pw, scale, shift):
        if t.device != device:
            raise ValueError(f"all operands must be on {device}, got one on {t.device}")
    return c_out


# The kernel's depthwise panel takes 8 KB of shared memory per 64 input
# channels; past 1536 channels two pointwise-weight stages no longer fit.
MAX_C_IN = 1536


def _check_aligned(tensors) -> None:
    if any(not t.is_contiguous() or t.data_ptr() % 16 for t in tensors):
        raise ValueError("the CUDA kernel takes contiguous, 16-byte aligned tensors only")


def _check_cuda_stages(stages) -> None:
    """What the CUDA kernel takes of the weights on top of ``_check_stage``:
    widths that are multiples of 8 (16-byte vectors, TMA row strides),
    C_in <= 1536, and contiguous 16-byte aligned tensors."""
    tensors = []
    for s in stages:
        c_in, c_out = s["pw"].shape
        if c_in % 8 or c_out % 8:
            raise ValueError(f"the CUDA kernel takes widths that are multiples of 8, got "
                             f"{c_in}->{c_out}")
        if c_in > MAX_C_IN:
            raise ValueError(f"the CUDA kernel takes at most {MAX_C_IN} input channels, got {c_in}")
        tensors += [s["dw"], s["pw"], s["scale"], s["shift"]]
    _check_aligned(tensors)


def _check_cuda(x, stages) -> None:
    """``_check_cuda_stages`` and an aligned input.  Checked before any launch."""
    _check_cuda_stages(stages)
    _check_aligned([x])


def _launch_stage(x, dw, pw, scale, shift, residual, pre_relu: bool, post_relu: bool):
    from kubernetes_deep_learning_tpu_torch.ops import _build

    lib = _build.load()
    b, h, w, c_in = x.shape
    c_out = pw.shape[1]
    out = torch.empty((b, h, w, c_out), dtype=torch.bfloat16, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    code = lib.kdlt_sepconv_stage(
        x.data_ptr(), dw.data_ptr(), pw.data_ptr(), scale.data_ptr(), shift.data_ptr(),
        residual.data_ptr() if residual is not None else None, out.data_ptr(),
        b, h, w, c_in, c_out, int(pre_relu), int(post_relu), stream,
    )
    _build.check(lib, code, "sepconv stage")
    return out


def prepare_block(dw, pw, scale, shift) -> tuple[dict, ...]:
    """A middle block's three stages as views of its stacked weights (see
    module doc), checked once, for the CUDA kernel too when they lie on the
    card: what ``fused_sepconv_block_stages`` takes."""
    if dw.shape[0] != 3 or pw.shape[0] != 3 or pw.shape[1] != pw.shape[2]:
        raise ValueError("a middle block stacks exactly 3 sepconvs of C->C")
    stages = tuple(dict(dw=dw[i], pw=pw[i], scale=scale[i], shift=shift[i],
                        pre_relu=True, post_relu=False) for i in range(3))
    for s in stages:
        _check_stage(pw.shape[1], pw.device, s["dw"], s["pw"], s["scale"], s["shift"])
    if pw.device.type == "cuda":
        _check_cuda_stages(stages)
    return stages


def fused_sepconv_block(x, dw, pw, scale, shift):
    """One Xception middle block (see module doc); NHWC bf16 in and out."""
    return fused_sepconv_block_stages(x, prepare_block(dw, pw, scale, shift))


def fused_sepconv_block_stages(x, stages):
    """``fused_sepconv_block`` over ``prepare_block(dw, pw, scale, shift)``:
    only ``x`` is checked here."""
    _check_input(x)
    pw = stages[0]["pw"]
    if x.shape[-1] != pw.shape[0] or x.device != pw.device:
        raise ValueError(f"x must have {pw.shape[0]} channels on {pw.device}, got "
                         f"{x.shape[-1]} on {x.device}")
    if x.device.type == "cpu":
        return _block_stages_reference(x, stages)
    _check_aligned([x])
    y = x
    for i, s in enumerate(stages):
        y = _launch_stage(y, s["dw"], s["pw"], s["scale"], s["shift"], x if i == 2 else None,
                          True, False)
    _count("fused_sepconv_block")
    return y


def fused_sepconv_chain(x, stages):
    """A chain of sepconv+BN stages (see module doc); NHWC bf16 in and out."""
    _check_input(x)
    if not stages:
        raise ValueError("empty chain")
    c = x.shape[-1]
    for s in stages:
        c = _check_stage(c, x.device, s["dw"], s["pw"], s["scale"], s["shift"])
    if x.device.type == "cpu":
        return sepconv_chain_reference(x, stages)
    _check_cuda(x, stages)
    y = x
    for s in stages:
        y = _launch_stage(
            y, s["dw"], s["pw"], s["scale"], s["shift"], None, s["pre_relu"], s["post_relu"]
        )
    _count("fused_sepconv_chain")
    return y
