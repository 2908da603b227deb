"""Fused Xception entry segment: conv2 + block2 (the port of
``kubernetes_deep_learning_tpu/ops/fused_entry.py``).

``fused_entry_block(x, w)`` computes, on NHWC bf16 ``x`` (B, H, W, C_in)::

    b = relu(BN(conv2 3x3 VALID (x)))                 C_in -> C_b
    r = BN(1x1 stride-2 conv (b))                     C_b -> C_out
    c = relu(BN(sepconv1 (b)))                        C_b -> C_out
    d = BN(sepconv2 (c))                              C_out -> C_out
    out = max-pool 3x3/2 SAME (d) + r                 (B, ceil((H-2)/2), ceil((W-2)/2), C_out)

with ``w`` from ``weights.entry_block_weights``: conv2 (9*C_in, C_b) bf16
(taps (dh, dw)-major, the TPU kernel's im2col order), res (C_b, C_out),
pw1 (C_b, C_out) and pw2 (C_out, C_out) bf16; dw1 (3,3,C_b) and dw2
(3,3,C_out) f32 taps; the folded-BN affine pairs conv2_s/_b, res_s/_b,
bn1_s/_b, bn2_s/_b in f32.  Xception's geometry is (149, 32, 64, 128).

On a CUDA tensor the wrapper launches the hand-written kernel K5
(``csrc/fused_entry.cu``) and adds one to its launch count; on a CPU
tensor it computes the plain PyTorch version, ``entry_block_reference``,
which rounds where the TPU kernel's Pallas body does: b to bf16 after an
f32 affine + relu; depthwise taps in f32 with f32 weights, then bf16;
GEMMs of bf16 operands summed in f32; each affine in f32, then bf16; d in
bf16 before the pool; ``pooled + r`` added in bf16.  (JAX's
``entry_block_reference`` rounds the depthwise weights to bf16 as well;
the tests hold the port against both at 2e-2.)  The JAX kernel's batch
padded to a multiple of 8 is a Mosaic rule and has no counterpart.
"""

from __future__ import annotations

import torch

from kubernetes_deep_learning_tpu_torch.models.layers import max_pool_same
from kubernetes_deep_learning_tpu_torch.ops._counts import LaunchCounts
from kubernetes_deep_learning_tpu_torch.ops.fused_sepconv import stage_reference

WEIGHT_KEYS = ("conv2", "conv2_s", "conv2_b", "res", "res_s", "res_b", "dw1", "pw1",
               "bn1_s", "bn1_b", "dw2", "pw2", "bn2_s", "bn2_b")

# The kernel's widths: conv2's K = 9 * C_in in five 64-deep boxes, C_b in one
# wgmma N, C_out in two (csrc/fused_entry.cu).
MAX_C_IN, MAX_C_B, MAX_C_OUT = 32, 64, 128

_counts = LaunchCounts("fused_entry_block")
launch_counts = _counts.snapshot
reset_launch_counts = _counts.reset
credit_launches = _counts.credit
_count = _counts.count


def entry_block_reference(x, w):
    """The plain version of ``fused_entry_block`` (see module doc)."""
    h_b, w_b = x.shape[1] - 2, x.shape[2] - 2
    patches = torch.cat(
        [x[:, dh : dh + h_b, dw : dw + w_b, :] for dh in range(3) for dw in range(3)], dim=-1
    )
    z = patches.float() @ w["conv2"].float()
    b = torch.relu(z * w["conv2_s"] + w["conv2_b"]).to(torch.bfloat16)
    r = b[:, ::2, ::2, :].float() @ w["res"].float()
    r = (r * w["res_s"] + w["res_b"]).to(torch.bfloat16)
    c = stage_reference(b, w["dw1"], w["pw1"], w["bn1_s"], w["bn1_b"], False, True)
    d = stage_reference(c, w["dw2"], w["pw2"], w["bn2_s"], w["bn2_b"], False, False)
    return max_pool_same(d) + r


def _check(x, w) -> tuple[int, int, int]:
    """Validate the operands; returns (C_in, C_b, C_out)."""
    if x.dim() != 4 or x.dtype != torch.bfloat16:
        raise ValueError(f"x must be (B,H,W,C_in) bfloat16, got {tuple(x.shape)} {x.dtype}")
    if x.shape[1] < 3 or x.shape[2] < 3:
        raise ValueError(f"conv2 3x3 VALID needs H, W >= 3, got {tuple(x.shape)}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")
    missing = [k for k in WEIGHT_KEYS if k not in w]
    if missing:
        raise ValueError(f"missing weights {missing}")
    c_in = x.shape[-1]
    c_b = w["conv2"].shape[-1]
    c_out = w["pw1"].shape[-1]
    bf16, f32 = torch.bfloat16, torch.float32
    want = {
        "conv2": ((9 * c_in, c_b), bf16), "res": ((c_b, c_out), bf16),
        "pw1": ((c_b, c_out), bf16), "pw2": ((c_out, c_out), bf16),
        "dw1": ((3, 3, c_b), f32), "dw2": ((3, 3, c_out), f32),
        "conv2_s": ((c_b,), f32), "conv2_b": ((c_b,), f32),
        **{k: ((c_out,), f32) for k in ("res_s", "res_b", "bn1_s", "bn1_b", "bn2_s", "bn2_b")},
    }
    for k, (shape, dtype) in want.items():
        t = w[k]
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"{k} must be {shape} {dtype}, got {tuple(t.shape)} {t.dtype}")
        if t.device != x.device:
            raise ValueError(f"all operands must be on {x.device}, got {k} on {t.device}")
    return c_in, c_b, c_out


def fused_entry_block(x, w):
    """conv2 + block2 of Xception's entry flow (see module doc); NHWC bf16
    in and out."""
    if x.device.type != "cpu":
        return _launch(x, w)
    _check(x, w)
    return entry_block_reference(x, w)


def _launch(x, w, rows: int = 0):
    """One launch of K5 on a CUDA tensor; ``rows`` > 0 forces the walk's
    segment length (output rows a work unit), 0 lets the launcher choose."""
    c_in, c_b, c_out = _check(x, w)
    if any(c % 8 for c in (c_in, c_b, c_out)) or c_in > MAX_C_IN or c_b > MAX_C_B or (
            c_out > MAX_C_OUT):
        raise ValueError(f"the CUDA kernel takes widths that are multiples of 8, C_in <= "
                         f"{MAX_C_IN}, C_b <= {MAX_C_B}, C_out <= {MAX_C_OUT}; got "
                         f"{(c_in, c_b, c_out)}")
    for t in (x, *(w[k] for k in WEIGHT_KEYS)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("the CUDA kernel takes contiguous, 16-byte aligned tensors only")
    from kubernetes_deep_learning_tpu_torch.ops import _build

    lib = _build.load()
    bsz, h, wd, _ = x.shape
    out = torch.empty((bsz, (h - 1) // 2, (wd - 1) // 2, c_out), dtype=torch.bfloat16,
                      device=x.device)
    code = lib.kdlt_entry_block(
        x.data_ptr(), *(w[k].data_ptr() for k in WEIGHT_KEYS), out.data_ptr(),
        bsz, h, wd, c_in, c_b, c_out, rows, torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(lib, code, "fused entry block")
    _count("fused_entry_block")
    return out
