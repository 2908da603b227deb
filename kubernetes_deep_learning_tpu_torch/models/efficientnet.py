"""EfficientNet (B0-B7), the exact graph: the port of ``models/efficientnet.py``.

MBConv blocks with squeeze-excite and compound scaling (Tan & Le 2019),
with the flax module's names (``stem_conv``, ``block{i}.expand_conv``,
``.dw_bn``, ``.se.reduce``, ``.project_conv``, ``top_conv``,
``head.logits``, ...), so the flax variable tree maps onto it leaf for
leaf (``weights.from_jax_variables``).  Every convolution is a
``models.layers.Conv2dNHWC`` called through its module (so
``ops.quantize`` hooks and replaces it) and pads TF "SAME", as flax
``nn.Conv`` does by default: the 3x3/2 stem pads (0, 1) on 300.
Input is normalized float NHWC; the compute dtype is a constructor
argument; parameters stay float32.  ``forward(x, train=True)`` runs every
BatchNorm on batch statistics (``layers.BatchNorm``).  Like the JAX
package, it has no stochastic depth; the head carries the variant's
dropout rate, which only a head with hidden layers reaches, and which
fails in train mode in both packages (``layers.ClassifierHead``).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from kubernetes_deep_learning_tpu_torch.models.layers import (
    BatchNorm,
    ClassifierHead,
    Conv2dNHWC,
)

# EfficientNet-B0 base blocks: (expand_ratio, channels, repeats, stride, kernel).
_BASE_BLOCKS = (
    (1, 16, 1, 1, 3),
    (6, 24, 2, 2, 3),
    (6, 40, 2, 2, 5),
    (6, 80, 3, 2, 3),
    (6, 112, 3, 1, 5),
    (6, 192, 4, 2, 5),
    (6, 320, 1, 1, 3),
)
_SE_RATIO = 0.25

# Compound scaling, Tan & Le 2019 table 1: variant -> (width, depth, dropout).
SCALING = {
    "b0": (1.0, 1.0, 0.2),
    "b1": (1.0, 1.1, 0.2),
    "b2": (1.1, 1.2, 0.3),
    "b3": (1.2, 1.4, 0.3),
    "b4": (1.4, 1.8, 0.4),
    "b5": (1.6, 2.2, 0.4),
    "b6": (1.8, 2.6, 0.5),
    "b7": (2.0, 3.1, 0.5),
}


def round_filters(filters: int, width: float, divisor: int = 8) -> int:
    """Compound-scale a channel count, snapped to a multiple of 8."""
    filters *= width
    new = max(divisor, int(filters + divisor / 2) // divisor * divisor)
    if new < 0.9 * filters:  # never round down by more than 10%
        new += divisor
    return int(new)


def round_repeats(repeats: int, depth: float) -> int:
    return int(math.ceil(depth * repeats))


def block_plan(width: float, depth: float) -> list[tuple[str, int, int, int, int]]:
    """Every block of the network in order: (name, stride, kernel, features, expand)."""
    plan = []
    for expand, channels, repeats, stride, kernel in _BASE_BLOCKS:
        features = round_filters(channels, width)
        for rep in range(round_repeats(repeats, depth)):
            plan.append((f"block{len(plan)}", stride if rep == 0 else 1, kernel, features, expand))
    return plan


def se_features(c_in: int) -> int:
    """Squeeze-excite bottleneck width: a quarter of the block's INPUT width."""
    return max(1, int(c_in * _SE_RATIO))


def _conv(c_in: int, c_out: int, k: int, stride: int = 1, groups: int = 1,
          bias: bool = False) -> Conv2dNHWC:
    """A flax ``nn.Conv``: SAME padding, the bias (if any) added after."""
    return Conv2dNHWC(c_in, c_out, k, stride, "SAME", groups, bias)


class SqueezeExcite(nn.Module):
    """Global pool -> 1x1 reduce (silu) -> 1x1 expand (sigmoid) channel gate."""

    def __init__(self, c: int, features: int):
        super().__init__()
        self.reduce = _conv(c, features, 1, bias=True)
        self.expand = _conv(features, c, 1, bias=True)

    def forward(self, x):
        s = x.mean(dim=(1, 2), keepdim=True)
        s = F.silu(self.reduce(s))
        return x * torch.sigmoid(self.expand(s))


class MBConvBlock(nn.Module):
    """Inverted residual: 1x1 expand -> depthwise kxk -> SE -> 1x1 project."""

    def __init__(self, c_in: int, features: int, expand_ratio: int, kernel: int, stride: int):
        super().__init__()
        c_mid = c_in * expand_ratio
        self.residual = stride == 1 and c_in == features
        if expand_ratio != 1:
            self.expand_conv = _conv(c_in, c_mid, 1)
            self.expand_bn = BatchNorm(c_mid)
        self.dwconv = _conv(c_mid, c_mid, kernel, stride, groups=c_mid)
        self.dw_bn = BatchNorm(c_mid)
        self.se = SqueezeExcite(c_mid, se_features(c_in))
        self.project_conv = _conv(c_mid, features, 1)
        self.project_bn = BatchNorm(features)

    def forward(self, x, train: bool = False):
        y = x
        if "expand_conv" in self._modules:
            y = F.silu(self.expand_bn(self.expand_conv(y), train=train))
        y = F.silu(self.dw_bn(self.dwconv(y), train=train))
        y = self.se(y)
        y = self.project_bn(self.project_conv(y), train=train)
        return y + x if self.residual else y


class EfficientNet(nn.Module):
    def __init__(self, num_classes: int, width: float = 1.0, depth: float = 1.0,
                 head_hidden: tuple[int, ...] = (), dtype: torch.dtype = torch.float32,
                 dropout_rate: float = 0.0):
        super().__init__()
        self.dtype = dtype
        self.width, self.depth = width, depth
        c = round_filters(32, width)
        self.stem_conv = _conv(3, c, 3, stride=2)
        self.stem_bn = BatchNorm(c)
        self.plan = block_plan(width, depth)
        for name, stride, kernel, features, expand in self.plan:
            self.add_module(name, MBConvBlock(c, features, expand, kernel, stride))
            c = features
        top = round_filters(1280, width)
        self.top_conv = _conv(c, top, 1)
        self.top_bn = BatchNorm(top)
        self.head = ClassifierHead(top, num_classes, head_hidden, dropout_rate)

    def forward(self, x, train: bool = False):
        x = x.to(self.dtype)
        x = F.silu(self.stem_bn(self.stem_conv(x), train=train))
        for name, *_ in self.plan:
            x = self._modules[name](x, train=train)
        x = F.silu(self.top_bn(self.top_conv(x), train=train))
        return self.head(x, train=train)


def build_efficientnet(variant: str, num_classes: int, dtype: torch.dtype = torch.float32,
                       head_hidden: tuple[int, ...] = ()) -> EfficientNet:
    """Any B0-B7 variant by name ("b0".."b7")."""
    if variant not in SCALING:
        raise KeyError(f"unknown EfficientNet variant {variant!r}; supported: {sorted(SCALING)}")
    width, depth, dropout = SCALING[variant]
    return EfficientNet(num_classes, width, depth, head_hidden, dtype, dropout)
