"""int8 convolutions of the w8a8 serving path: Q1 (dense) and Q2 (depthwise).

Each computes one calibrated layer of the JAX package's w8a8 program
(``kubernetes_deep_learning_tpu/ops/quantize.py::build_w8a8_forward``) on
float32 NHWC activations, bit for bit:

    q   = clamp(round(x / s_act), -127, 127)          (int8 codes)
    acc = conv(q, q_w)                                (int32, exact)
    y   = float32(acc) * out_scale (+ bias)           (out_scale = s_act * s_w)

- ``int8_conv(x, packed, s_act, out_scale, kernel_size, stride, padding)``:
  a dense convolution (groups 1, any C_in and C_out; "VALID", TF "SAME" or
  explicit ((top, bottom), (left, right)) pads), the weight packed by
  ``pack_conv`` as int8 (C_out, K_pad), taps ordered (kh, kw, C_pad) with
  C_pad = ``code_width(C_in)`` (C_in rounded up to 16, the codes' channel
  stride) and zero past C_in and past K = kh*kw*C_pad up to a multiple of
  128;
- ``int8_depthwise(x, packed, s_act, out_scale, bias, stride)``: a k x k
  depthwise convolution, k 3 or 5, stride 1 or 2, TF "SAME", C a multiple
  of 4, the weight packed by ``pack_depthwise`` as int8 (k*k, C).

On a CUDA tensor each wrapper launches its hand-written kernels in
``csrc/int8_conv.cu`` (no TPU kernel: the JAX program runs XLA's int8
convolution) and adds one to its launch count; there is no fallback, and a
shape the kernels do not take raises.  Q1 is two launches: the quantize
pass ``int8_codes_kernel`` (``int8_codes``: the layer's input as int8 codes,
once) and ``int8_conv_kernel``, a wgmma s8 implicit GEMM on them, whose
instance ``q1_instance`` picks by shape.  Q2 is one,
``int8_depthwise_kernel``.  On a CPU tensor each computes the plain PyTorch
version, ``int8_conv_reference``: the products exactly, by a float64
convolution of the codes rounded to int32, and the quantize and epilogue
steps as the same float32 operations.  ``Int8Conv2d`` is the module
``ops.quantize.build_w8a8_forward`` puts in place of a calibrated conv.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
from torch import nn

from kubernetes_deep_learning_tpu_torch.models.layers import check_padding, conv2d_nhwc, same_pads
from kubernetes_deep_learning_tpu_torch.ops._counts import LaunchCounts

_counts = LaunchCounts("int8_conv", "int8_depthwise")
launch_counts = _counts.snapshot
reset_launch_counts = _counts.reset
_count = _counts.count

CODE_ALIGN = 16  # the codes' channel stride: whole 16-byte runs for Q1's gather and TMA
K_ALIGN = 128  # Q1's k step (one 128-byte swizzled row): the packed weight's rows pad to it
# Q1's GEMM instances: consumer warpgroups, each an M tile of 64 rows, over
# an N tile of Q1_BN output channels.
Q1_WARPGROUPS = (2, 1)
Q1_BN = 64


def code_width(c_in: int) -> int:
    """C_pad: the codes' channel stride, C_in rounded up to CODE_ALIGN."""
    return -(-c_in // CODE_ALIGN) * CODE_ALIGN


# --- packing ------------------------------------------------------------------


def packed_width(c_in: int, kh: int, kw: int) -> int:
    """K_pad: kh*kw*C_pad rounded up to K_ALIGN."""
    return -(-kh * kw * code_width(c_in) // K_ALIGN) * K_ALIGN


def pack_conv(q_w: torch.Tensor) -> torch.Tensor:
    """OIHW int8 -> (C_out, K_pad) int8, k ordered (kh, kw, C_pad), zero past
    C_in and past K = kh*kw*C_pad."""
    c_out, c_in, kh, kw = q_w.shape
    taps = torch.zeros((c_out, kh, kw, code_width(c_in)), dtype=torch.int8, device=q_w.device)
    taps[..., :c_in] = q_w.permute(0, 2, 3, 1)
    packed = torch.zeros((c_out, packed_width(c_in, kh, kw)), dtype=torch.int8,
                         device=q_w.device)
    packed[:, :taps[0].numel()] = taps.reshape(c_out, -1)
    return packed


def unpack_conv(packed: torch.Tensor, c_in: int, kh: int, kw: int) -> torch.Tensor:
    """``pack_conv``'s inverse: OIHW int8."""
    c_out, c_pad = packed.shape[0], code_width(c_in)
    taps = packed[:, :kh * kw * c_pad].reshape(c_out, kh, kw, c_pad)[..., :c_in]
    return taps.permute(0, 3, 1, 2).contiguous()


def pack_depthwise(q_w: torch.Tensor) -> torch.Tensor:
    """(C,1,k,k) int8 -> (k*k, C) int8, tap-major."""
    c, _, kh, kw = q_w.shape
    return q_w[:, 0].permute(1, 2, 0).reshape(kh * kw, c).contiguous()


def depthwise_size(packed: torch.Tensor) -> int:
    """k of a (k*k, C) packed depthwise weight."""
    k = math.isqrt(packed.shape[0])
    if k * k != packed.shape[0]:
        raise ValueError(f"a packed depthwise weight has k*k rows, got {packed.shape[0]}")
    return k


def unpack_depthwise(packed: torch.Tensor) -> torch.Tensor:
    """``pack_depthwise``'s inverse: (C,1,k,k) int8."""
    k = depthwise_size(packed)
    return packed.reshape(k, k, -1).permute(2, 0, 1).unsqueeze(1).contiguous()


# --- the plain PyTorch version ------------------------------------------------


def quantize_input(x: torch.Tensor, s_act: float) -> torch.Tensor:
    """clamp(round(x / s_act), -127, 127) in float32.  The divisor is a
    tensor on x's device: CUDA's division by a host scalar multiplies by its
    reciprocal, which is not IEEE division."""
    s = torch.full((1,), s_act, dtype=torch.float32, device=x.device)
    return torch.clamp(torch.round(x.float() / s), -127, 127)


def int8_accumulate_reference(q, q_w, stride: int = 1, padding="VALID",
                              groups: int = 1) -> torch.Tensor:
    """The int32 accumulators of a conv of int8 codes ``q`` (NHWC, any
    dtype holding them) with ``q_w`` (OIHW int8), exactly: a float64
    convolution (|acc| < 2^31 < 2^53) rounded to int32."""
    acc = conv2d_nhwc(q.double(), q_w.double(), stride, padding, groups)
    return torch.round(acc).to(torch.int32)


def int8_conv_reference(x, q_w, s_act: float, out_scale, stride: int = 1,
                        padding="VALID", groups: int = 1, bias=None):
    """One calibrated layer, plain: x f32 NHWC, q_w int8 OIHW (depthwise
    (C,1,kh,kw)), out_scale f32 (C_out,) -> f32 NHWC."""
    acc = int8_accumulate_reference(quantize_input(x, s_act), q_w, stride, padding, groups)
    y = acc.float() * out_scale
    return y + bias if bias is not None else y


# --- kernel wrappers ----------------------------------------------------------


def _check_x(x, c: int) -> None:
    if x.dim() != 4 or x.dtype != torch.float32 or x.shape[-1] != c:
        raise ValueError(f"x must be (B,H,W,{c}) float32, got {tuple(x.shape)} {x.dtype}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")


DEPTHWISE_SIZES = (3, 5)
DEPTHWISE_STRIDES = (1, 2)


def check_cuda_layer(c_in: int, c_out: int, kernel_size, stride: int, padding,
                     groups: int) -> str:
    """Which kernel takes the layer ("conv" Q1 or "depthwise" Q2), or raise:
    Q1 takes groups 1, any C_in and C_out, any kernel and stride and any
    padding (VALID, SAME, explicit); Q2 a k x k depthwise, k in
    DEPTHWISE_SIZES, stride in DEPTHWISE_STRIDES, SAME, C a multiple of 4
    (16-byte loads of 4 channels)."""
    padding = check_padding(padding)
    if min(c_in, c_out, stride, *kernel_size) < 1:
        raise ValueError(f"no int8 kernel takes {c_in}->{c_out} channels, "
                         f"{tuple(kernel_size)}/{stride}")
    if groups == 1:
        return "conv"
    kh, kw = kernel_size
    if (groups == c_in == c_out and kh == kw and kh in DEPTHWISE_SIZES
            and stride in DEPTHWISE_STRIDES and padding == "SAME"):
        if c_in % 4:
            raise ValueError(f"the int8 depthwise kernel takes widths that are multiples "
                             f"of 4, got {c_in}")
        return "depthwise"
    raise ValueError(f"no int8 kernel takes groups={groups} {tuple(kernel_size)}/{stride} "
                     f"{padding} on {c_in}->{c_out} channels")


def _check_cuda_tensors(tensors) -> None:
    if any(not t.is_contiguous() or t.data_ptr() % 16 for t in tensors):
        raise ValueError("the CUDA kernel takes contiguous, 16-byte aligned tensors only")


def _out_geometry(h: int, w: int, kh: int, kw: int, stride: int, padding):
    """(Ho, Wo, pad_top, pad_left) of a conv with XLA's padding rules: the
    bottom and right pads follow from Ho and Wo."""
    padding = check_padding(padding)
    if padding == "SAME":
        (top, bottom), (left, right) = same_pads(h, kh, stride), same_pads(w, kw, stride)
    elif padding == "VALID":
        (top, bottom), (left, right) = (0, 0), (0, 0)
    else:
        (top, bottom), (left, right) = padding
    ho = (h + top + bottom - kh) // stride + 1
    wo = (w + left + right - kw) // stride + 1
    if ho < 1 or wo < 1:
        raise ValueError(f"a {kh}x{kw}/{stride} conv of {h}x{w} padded {padding} is empty")
    return ho, wo, top, left


def _bias_ptr(bias):
    return bias.data_ptr() if bias is not None else None


@functools.cache
def q1_instance(m: int, c_out: int, k_pad: int, kernel_size, sms: int) -> tuple[int, bool]:
    """Q1's GEMM instance for a layer, by its shape: (warpgroups, TMA for
    A).  A block streams k_pad bytes of each of its M and N rows and writes
    its f32 tile; the busiest SM runs ceil(blocks / sms) of them, so the
    warpgroups with the fewest such bytes win (two on a tie).  A 1x1 conv's
    codes are an (M, C_pad) matrix (the quantize pass keeps only the pixels
    it reads), read by TMA; a k x k conv's are gathered."""
    def cost(warpgroups):
        bm = 64 * warpgroups
        blocks = -(-m // bm) * -(-c_out // Q1_BN)
        return -(-blocks // sms) * (k_pad * (bm + Q1_BN) + bm * Q1_BN * 4)

    return min(Q1_WARPGROUPS, key=cost), tuple(kernel_size) == (1, 1)


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def int8_codes(x, s_act: float, sample=None):
    """Q1's quantize pass: f32 NHWC -> int8 codes (N, H, W, C_pad), C_pad =
    ``code_width(C)``, the channels past C code 0 (``quantize_input``'s
    codes).  ``sample`` =
    (stride, top, left, Ho, Wo): only the pixels a 1x1 conv of that stride
    and top/left pads reads, codes[:, i, j] = q(x[:, i * stride - top, j *
    stride - left]) (0 outside the image), (N, Ho, Wo, C_pad).  One launch
    of ``int8_codes_kernel`` on a CUDA tensor (counted as part of Q1 by
    ``int8_conv``, not here); the plain version on a CPU one."""
    b, h, w, c = x.shape
    _check_x(x, c)
    c_pad = code_width(c)
    stride, top, left, hc, wc = sample or (1, 0, 0, h, w)
    if x.device.type == "cpu":
        rows, cols = torch.arange(hc) * stride - top, torch.arange(wc) * stride - left
        r_ok, c_ok = (rows >= 0) & (rows < h), (cols >= 0) & (cols < w)
        q = quantize_input(x, s_act).to(torch.int8)[:, rows[r_ok]][:, :, cols[c_ok]]
        codes = torch.zeros((b, hc, wc, c_pad), dtype=torch.int8)
        codes[:, r_ok.nonzero()[:, 0, None], c_ok.nonzero()[:, 0], :c] = q
        return codes
    x = x.contiguous()
    if x.numel() >= 2**31 or b * hc * wc * c_pad >= 2**31:
        raise ValueError("the CUDA kernel takes < 2^31 elements a tensor")
    codes = torch.empty((b, hc, wc, c_pad), dtype=torch.int8, device=x.device)
    _check_cuda_tensors([x, codes])
    from kubernetes_deep_learning_tpu_torch.ops import _build

    lib = _build.load()
    code = lib.kdlt_int8_codes(x.data_ptr(), codes.data_ptr(), float(s_act), b, h, w, c, c_pad,
                               hc, wc, stride, top, left,
                               torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, code, "int8 codes")
    return codes


def int8_conv(x, packed, s_act: float, out_scale, kernel_size, stride: int = 1,
              padding="VALID", bias=None):
    """Q1: one calibrated dense conv layer (see module doc); f32 NHWC in and
    out."""
    kh, kw = kernel_size
    c_out = packed.shape[0]
    c_in = x.shape[-1]
    _check_x(x, c_in)
    if packed.dtype != torch.int8 or packed.shape[1] != packed_width(c_in, kh, kw):
        raise ValueError(f"packed must be int8 (C_out, {packed_width(c_in, kh, kw)}), got "
                         f"{tuple(packed.shape)} {packed.dtype}")
    if x.device.type == "cpu":
        return int8_conv_reference(x, unpack_conv(packed, c_in, kh, kw), s_act, out_scale,
                                   stride, padding, 1, bias)
    check_cuda_layer(c_in, c_out, kernel_size, stride, padding, 1)
    b, h, w, _ = x.shape
    ho, wo, top, left = _out_geometry(h, w, kh, kw, stride, padding)
    if b * ho * wo * c_out >= 2**31:
        raise ValueError("the CUDA kernel takes < 2^31 elements a tensor")
    if (kh, kw) == (1, 1):  # the GEMM sees a 1x1/1 conv on the pixels it reads
        codes = int8_codes(x, s_act, (stride, top, left, ho, wo))
        h, w, stride, top, left = ho, wo, 1, 0, 0
    else:
        codes = int8_codes(x, s_act)
    c_pad = codes.shape[-1]
    y = torch.empty((b, ho, wo, c_out), dtype=torch.float32, device=x.device)
    _check_cuda_tensors([packed, out_scale, y] + ([bias] if bias is not None else []))
    from kubernetes_deep_learning_tpu_torch.ops import _build

    warpgroups, tma_a = q1_instance(b * ho * wo, c_out, packed.shape[1], (kh, kw),
                                    _sm_count(x.device.index))
    lib = _build.load()
    code = lib.kdlt_int8_conv(
        codes.data_ptr(), packed.data_ptr(), out_scale.data_ptr(), _bias_ptr(bias), y.data_ptr(),
        b, h, w, c_pad, ho, wo, c_out, kh, kw, stride, top, left, packed.shape[1], warpgroups,
        int(tma_a), torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(lib, code, "int8 conv")
    _count("int8_conv")
    return y


def int8_depthwise(x, packed, s_act: float, out_scale, bias=None, stride: int = 1):
    """Q2: one calibrated k x k depthwise layer, SAME (see module doc), k
    from the packed weight's k*k rows; f32 NHWC in and out."""
    c = x.shape[-1]
    _check_x(x, c)
    if packed.dtype != torch.int8 or packed.dim() != 2 or packed.shape[1] != c:
        raise ValueError(f"packed must be int8 (k*k, {c}), got {tuple(packed.shape)} "
                         f"{packed.dtype}")
    k = depthwise_size(packed)
    if x.device.type == "cpu":
        return int8_conv_reference(x, unpack_depthwise(packed), s_act, out_scale, stride,
                                   "SAME", c, bias)
    check_cuda_layer(c, c, (k, k), stride, "SAME", c)
    x = x.contiguous()
    b, h, w, _ = x.shape
    ho, wo, top, left = _out_geometry(h, w, k, k, stride, "SAME")
    if x.numel() >= 2**31 or b * ho * wo * c >= 2**31:
        raise ValueError("the CUDA kernel takes < 2^31 elements a tensor")
    y = torch.empty((b, ho, wo, c), dtype=torch.float32, device=x.device)
    _check_cuda_tensors([x, packed, out_scale, y] + ([bias] if bias is not None else []))
    from kubernetes_deep_learning_tpu_torch.ops import _build

    lib = _build.load()
    code = lib.kdlt_int8_depthwise(
        x.data_ptr(), packed.data_ptr(), out_scale.data_ptr(), _bias_ptr(bias), y.data_ptr(),
        float(s_act), b, h, w, c, ho, wo, k, stride, top, left,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(lib, code, "int8 depthwise")
    _count("int8_depthwise")
    return y


class Int8Conv2d(nn.Module):
    """A calibrated ``models.layers.Conv2dNHWC`` as int8: its weight packed
    once for its kernel, ``s_act`` and ``out_scale = s_act * s_w`` (f32,
    computed here on the host as the JAX program computes it).  Called on
    float32 NHWC activations (the exact graph's)."""

    def __init__(self, conv, q_w: torch.Tensor, w_scale: torch.Tensor, act_scale,
                 device: str | torch.device = "cpu"):
        super().__init__()
        self.kernel_size = tuple(conv.kernel_size)
        self.stride = conv.stride[0]
        self.padding = conv.tf_padding
        self.c_in, self.c_out = conv.in_channels, conv.out_channels
        self.kind = check_cuda_layer(self.c_in, self.c_out, self.kernel_size, self.stride,
                                     self.padding, conv.groups)
        if tuple(q_w.shape) != tuple(conv.weight.shape) or q_w.dtype != torch.int8:
            raise ValueError(f"q_w must be int8 {tuple(conv.weight.shape)}, got "
                             f"{tuple(q_w.shape)} {q_w.dtype}")
        act = np.float32(act_scale)
        self.s_act = float(act)
        out_scale = act * np.asarray(w_scale.cpu().numpy(), np.float32)
        packed = pack_depthwise(q_w) if self.kind == "depthwise" else pack_conv(q_w)
        self.register_buffer("packed", packed.to(device))
        self.register_buffer("out_scale", torch.from_numpy(out_scale).to(device))
        bias = conv.bias
        self.register_buffer("bias", None if bias is None else bias.detach().float().to(device))

    def forward(self, x):
        if self.kind == "depthwise":
            return int8_depthwise(x.float(), self.packed, self.s_act, self.out_scale, self.bias,
                                  self.stride)
        return int8_conv(x.float(), self.packed, self.s_act, self.out_scale, self.kernel_size,
                         self.stride, self.padding, self.bias)

    def extra_repr(self) -> str:
        return (f"{self.kind}, {self.c_in}->{self.c_out}, {self.kernel_size}/{self.stride} "
                f"{self.padding}, s_act={self.s_act:.6g}")
