"""ResNet50 (v1, bottleneck), the exact graph: the port of ``models/resnet.py``.

BASELINE config 3 (ResNet50/ImageNet through the same gateway path).  The
flax module's names are kept (``conv1_conv``, ``conv{s}_block{b}`` with
``{0,1,2,3}_{conv,bn}``, ``head``), so the flax variable tree maps onto it
leaf for leaf (``weights.from_jax_variables``); names that start with a
digit are registered through ``add_module``.  NHWC end to end; every
convolution is a ``models.layers.Conv2dNHWC`` called through its module
(so ``ops.quantize`` hooks and replaces it) and has a bias, as flax
``nn.Conv`` with ``use_bias=True``; every
BatchNorm takes ResNet's own epsilon, 1.001e-5, not Keras's 1e-3.  The JAX
package runs this family on XLA convolutions (no Pallas kernel), so the
port runs it on cuDNN convolutions.  Input is normalized float NHWC; the
compute dtype is a constructor argument; parameters stay float32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from kubernetes_deep_learning_tpu_torch.models.layers import (
    BatchNorm,
    ClassifierHead,
    Conv2dNHWC,
)

# Keras ResNet50 BatchNormalization epsilon (differs from Xception's 1e-3).
RESNET_BN_EPS = 1.001e-5

# stage -> (bottleneck width, block count); expansion is 4x.
STAGES = ((64, 3), (128, 4), (256, 6), (512, 3))


def _conv(c_in: int, c_out: int, k: int, stride: int = 1, padding="SAME") -> Conv2dNHWC:
    """A flax ``nn.Conv`` with bias (its padding defaults to "SAME")."""
    return Conv2dNHWC(c_in, c_out, k, stride, padding, bias=True)


class BottleneckBlock(nn.Module):
    """1x1 reduce -> 3x3 -> 1x1 expand, residual add, post-add relu."""

    def __init__(self, c_in: int, features: int, stride: int = 1, project: bool = False):
        super().__init__()
        self.project = project
        add = self.add_module
        if project:  # downsample/widen the shortcut with a 1x1 conv
            add("0_conv", _conv(c_in, 4 * features, 1, stride))
            add("0_bn", BatchNorm(4 * features, eps=RESNET_BN_EPS))
        add("1_conv", _conv(c_in, features, 1, stride))
        add("1_bn", BatchNorm(features, eps=RESNET_BN_EPS))
        add("2_conv", _conv(features, features, 3))
        add("2_bn", BatchNorm(features, eps=RESNET_BN_EPS))
        add("3_conv", _conv(features, 4 * features, 1))
        add("3_bn", BatchNorm(4 * features, eps=RESNET_BN_EPS))

    def forward(self, x, train: bool = False):
        m = self._modules

        def conv_bn(i, y):
            return m[f"{i}_bn"](m[f"{i}_conv"](y), train=train)

        shortcut = conv_bn(0, x) if self.project else x
        y = torch.relu(conv_bn(1, x))
        y = torch.relu(conv_bn(2, y))
        y = conv_bn(3, y)
        return torch.relu(y + shortcut)


class ResNet50(nn.Module):
    def __init__(self, num_classes: int, head_hidden: tuple[int, ...] = (),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        # Stem: 7x7/2 conv with explicit 3-pixel padding (Keras ZeroPadding2D).
        self.conv1_conv = _conv(3, 64, 7, 2, ((3, 3), (3, 3)))
        self.conv1_bn = BatchNorm(64, eps=RESNET_BN_EPS)
        self.blocks = []
        c = 64
        for stage, (features, n) in enumerate(STAGES, start=2):
            for block in range(1, n + 1):
                # The first block of each stage projects; stage 2 keeps stride 1
                # (the stem's max-pool already downsampled).
                stride = 2 if block == 1 and stage > 2 else 1
                name = f"conv{stage}_block{block}"
                self.add_module(name, BottleneckBlock(c, features, stride, project=block == 1))
                self.blocks.append(name)
                c = 4 * features
        self.head = ClassifierHead(c, num_classes, head_hidden)

    def forward(self, x, train: bool = False):
        """``train`` as flax's: BatchNorm on batch statistics, see
        ``layers.BatchNorm``."""
        x = x.to(self.dtype)
        # Stem: the padded 7x7/2 conv, then a 3x3/2 max-pool padded by 1 with
        # -inf (flax ``nn.max_pool``).
        x = torch.relu(self.conv1_bn(self.conv1_conv(x), train=train))
        x = F.max_pool2d(x.permute(0, 3, 1, 2), 3, 2, padding=1).permute(0, 2, 3, 1)
        for name in self.blocks:
            x = self._modules[name](x, train=train)
        return self.head(x, train=train)
