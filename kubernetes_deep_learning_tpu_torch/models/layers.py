"""Shared building blocks, on NHWC tensors as in the JAX package.

Convolutions go through ``torch.nn.functional.conv2d`` on an NCHW view of
the NHWC tensor (a channels-last layout, which cuDNN takes as is).  Layers
hold float32 parameters and compute in the dtype they are called with,
as flax modules with ``dtype=`` do: operands are cast to the compute dtype,
except BatchNorm, which flax evaluates in float32 (its float32 statistics
promote the input) and casts back to the compute dtype.  BatchNorm and the
head take flax's ``train`` flag as a keyword.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from kubernetes_deep_learning_tpu_torch.weights import KERAS_BN_EPS


def same_pads(size: int, k: int, s: int) -> tuple[int, int]:
    """TF/XLA "SAME" padding (before, after) along one dim: the extra pixel
    of an odd total goes AFTER, e.g. (0, 1) for a 3x3/2 window on 74."""
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def _pad_nchw(x, k: int, s: int, value: float = 0.0):
    top, bottom = same_pads(x.shape[2], k, s)
    left, right = same_pads(x.shape[3], k, s)
    if top or bottom or left or right:
        x = F.pad(x, (left, right, top, bottom), value=value)
    return x


def check_padding(padding):
    """"VALID", "SAME", or flax's explicit ((top, bottom), (left, right)) as
    a tuple of tuples of non-negative ints."""
    if padding in ("VALID", "SAME"):
        return padding
    try:
        (top, bottom), (left, right) = padding
        pads = ((int(top), int(bottom)), (int(left), int(right)))
    except (TypeError, ValueError):
        raise ValueError(f"unknown padding {padding!r}") from None
    if min(pads[0] + pads[1]) < 0:
        raise ValueError(f"negative padding {padding!r}")
    return pads


def conv2d_nhwc(x, weight, stride: int = 1, padding="VALID", groups: int = 1):
    """NHWC conv with an OIHW weight; ``padding`` "VALID", TF "SAME", or
    explicit ((top, bottom), (left, right)) zero rows and columns."""
    padding = check_padding(padding)
    if not isinstance(padding, str):
        (top, bottom), (left, right) = padding
        x = F.pad(x, (0, 0, left, right, top, bottom))
    xc = x.permute(0, 3, 1, 2)
    if padding == "SAME":
        xc = _pad_nchw(xc, weight.shape[-1], stride)
    return F.conv2d(xc, weight, None, stride, 0, 1, groups).permute(0, 2, 3, 1)


def max_pool_same(x, k: int = 3, s: int = 2):
    """NHWC 3x3/2 max-pool with TF "SAME" padding, padded with -inf
    (torch's symmetric ``padding=1`` puts the window in the wrong place on
    even sides)."""
    xc = _pad_nchw(x.permute(0, 3, 1, 2), k, s, value=float("-inf"))
    return F.max_pool2d(xc, k, s).permute(0, 2, 3, 1)


class Conv2dNHWC(nn.Conv2d):
    """A flax ``nn.Conv`` called on NHWC tensors: ``conv2d_nhwc`` with its
    own stride, padding ("VALID", "SAME" or explicit, see ``conv2d_nhwc``)
    and groups, its float32 weight cast to the input's dtype, and its bias,
    if it has one, added after in that dtype.  The state-dict keys stay
    ``weight`` (OIHW) and ``bias``.  Being a module, the call has a path
    (``block5_sepconv1.pointwise``) and sees the unpadded input, as flax's
    method interceptor does: ``ops.quantize`` hooks it for calibration and
    replaces it for w8a8."""

    def __init__(self, c_in: int, c_out: int, k: int, stride: int = 1,
                 padding="VALID", groups: int = 1, bias: bool = False):
        super().__init__(c_in, c_out, k, stride=stride, groups=groups, bias=bias)
        self.tf_padding = check_padding(padding)

    def forward(self, x):
        dt = x.dtype
        y = conv2d_nhwc(x, self.weight.to(dt), self.stride[0], self.tf_padding, self.groups)
        return y if self.bias is None else y + self.bias.to(dt)


class Dense(nn.Linear):
    """A flax ``nn.Dense``: input, weight and bias cast to the input's dtype.
    A module, so ``ops.quantize`` hooks it for calibration as flax's
    interceptor sees ``nn.Dense``."""

    def forward(self, x):
        dt = x.dtype
        return F.linear(x, self.weight.to(dt), self.bias.to(dt))


class SeparableConv2D(nn.Module):
    """Depthwise 3x3 SAME + pointwise 1x1, both bias-free (Keras SeparableConv2D)."""

    def __init__(self, c_in: int, features: int):
        super().__init__()
        self.depthwise = Conv2dNHWC(c_in, c_in, 3, padding="SAME", groups=c_in)
        self.pointwise = Conv2dNHWC(c_in, features, 1)

    def forward(self, x):
        return self.pointwise(self.depthwise(x))


class BatchNorm(nn.Module):
    """flax ``BatchNorm`` over the last axis (Keras's epsilon unless the
    family gives its own), computed in float32 and returned in the input's
    dtype.

    ``train=False`` normalises with the running statistics.  ``train=True``
    normalises with the batch's own, as flax's ``use_running_average=False``:
    the mean and the variance ``max(0, mean(x^2) - mean(x)^2)`` (flax's fast
    variance) in float32 over every axis but the last, differentiated
    through.  The running statistics then take ``MOMENTUM * old + (1 -
    MOMENTUM) * batch`` with the batch's biased variance, in place and
    outside autograd (flax's ``mutable=["batch_stats"]``).  Not
    ``F.batch_norm(training=True)``: its running variance is the unbiased
    one and its momentum is 1 - flax's."""

    MOMENTUM = 0.99  # flax's, for the running statistics

    def __init__(self, c: int, eps: float = KERAS_BN_EPS):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))

    def forward(self, x, train: bool = False):
        mean, var = self.running_mean, self.running_var
        if train:
            xf = x.float()
            dims = tuple(range(x.dim() - 1))
            mean = xf.mean(dims)
            var = torch.clamp((xf * xf).mean(dims) - mean * mean, min=0.0)
            with torch.no_grad():
                m = self.MOMENTUM
                self.running_mean.copy_(m * self.running_mean + (1 - m) * mean)
                self.running_var.copy_(m * self.running_var + (1 - m) * var)
        mul = torch.rsqrt(var + self.eps) * self.weight
        return ((x.float() - mean) * mul + self.bias).to(x.dtype)


def lowp_batchnorms(cast: dict, dtype: torch.dtype,
                    eps: float = KERAS_BN_EPS) -> dict[str, tuple]:
    """Every BatchNorm in ``cast`` (parameters already in ``dtype``) as
    (mean, rsqrt(var + eps), scale, bias), all in ``dtype``: the JAX fast
    paths' BN, which computes in the compute dtype, not in float32.  ``eps``
    is the family's (Keras's 1e-3 for Xception and EfficientNet)."""
    out = {}
    for k in cast:
        if k.endswith(".running_mean"):
            name = k.removesuffix(".running_mean")
            eps_t = torch.tensor(eps, dtype=dtype, device=cast[k].device)
            out[name] = (
                cast[f"{name}.running_mean"],
                torch.rsqrt(cast[f"{name}.running_var"] + eps_t),
                cast[f"{name}.weight"],
                cast[f"{name}.bias"],
            )
    return out


def lowp_bn(x, stats: tuple):
    """(x - mean) * rsqrt(var + eps) * scale + bias in x's dtype."""
    mean, inv, scale, bias = stats
    return (x - mean) * inv * scale + bias


class ClassifierHead(nn.Module):
    """Global-average-pool head: hidden Dense+relu layers, then logits.

    ``dropout_rate`` is the JAX head's: flax applies dropout after each
    hidden layer only when ``train`` and the rate is above 0, and then needs
    a ``"dropout"`` PRNG key, which the JAX package's train step never
    passes (flax raises ``InvalidRngError``).  Such a train-mode call raises
    a ``ValueError`` here instead of training without the dropout."""

    def __init__(self, c_in: int, num_classes: int, hidden: tuple[int, ...] = (),
                 dropout_rate: float = 0.0):
        super().__init__()
        widths = (c_in, *hidden)
        for i, width in enumerate(hidden):
            self.add_module(f"hidden_{i}", Dense(widths[i], width))
        self.logits = Dense(widths[-1], num_classes)
        self.n_hidden = len(hidden)
        self.dropout_rate = dropout_rate

    def forward(self, x, train: bool = False):
        if train and self.dropout_rate > 0 and self.n_hidden:
            raise ValueError(
                f"head: dropout {self.dropout_rate} after hidden_0 in train mode is not "
                "trained: the JAX package's train step passes no 'dropout' PRNG key and "
                "fails there (flax InvalidRngError: Dropout_0 needs PRNG for \"dropout\")")
        x = x.mean(dim=(1, 2))
        for i in range(self.n_hidden):
            x = torch.relu(self._modules[f"hidden_{i}"](x))
        return self.logits(x)
