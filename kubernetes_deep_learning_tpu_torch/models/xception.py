"""Xception, the exact graph: the port of ``models/xception.py``.

The same architecture as keras.applications.xception and the flax module,
with the same module names (block1_conv1, block4_sepconv2_bn, ...), so the
flax variable tree maps onto it leaf for leaf (``weights.from_jax_variables``).
Input is normalized float NHWC; the compute dtype is a constructor argument
(float32 for exact parity, bfloat16 for serving); parameters stay float32.
Every one of its 74 convolutions is called through its module
(``models.layers.Conv2dNHWC``), the counterpart of a flax module's path:
``ops.quantize`` hooks them to calibrate and swaps them for int8 ones.
"""

from __future__ import annotations

import torch
from torch import nn

from kubernetes_deep_learning_tpu_torch.models.layers import (
    BatchNorm,
    ClassifierHead,
    Conv2dNHWC,
    SeparableConv2D,
    max_pool_same,
)

# Entry-flow residual block widths; block index -> features.
ENTRY_BLOCKS = ((2, 128), (3, 256), (4, 728))
MIDDLE_BLOCKS = tuple(range(5, 13))  # blocks 5..12, 728 features each


class Xception(nn.Module):
    def __init__(self, num_classes: int, head_hidden: tuple[int, ...] = (),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        add = self.add_module

        def conv(name, c_in, c_out, k, stride):
            add(name, Conv2dNHWC(c_in, c_out, k, stride))
            add(f"{name}_bn", BatchNorm(c_out))

        def sep(name, c_in, c_out):
            add(name, SeparableConv2D(c_in, c_out))
            add(f"{name}_bn", BatchNorm(c_out))

        conv("block1_conv1", 3, 32, 3, stride=2)
        conv("block1_conv2", 32, 64, 3, stride=1)
        c = 64
        for idx, feat in ENTRY_BLOCKS:
            add(f"block{idx}_res_conv", Conv2dNHWC(c, feat, 1, stride=2, padding="SAME"))
            add(f"block{idx}_res_bn", BatchNorm(feat))
            sep(f"block{idx}_sepconv1", c, feat)
            sep(f"block{idx}_sepconv2", feat, feat)
            c = feat
        for idx in MIDDLE_BLOCKS:
            for j in (1, 2, 3):
                sep(f"block{idx}_sepconv{j}", 728, 728)
        add("block13_res_conv", Conv2dNHWC(728, 1024, 1, stride=2, padding="SAME"))
        add("block13_res_bn", BatchNorm(1024))
        sep("block13_sepconv1", 728, 728)
        sep("block13_sepconv2", 728, 1024)
        sep("block14_sepconv1", 1024, 1536)
        sep("block14_sepconv2", 1536, 2048)
        self.head = ClassifierHead(2048, num_classes, head_hidden)

    def forward(self, x, train: bool = False):
        """``train`` as flax's: every BatchNorm on batch statistics (see
        ``layers.BatchNorm``) and the head in train mode."""
        m = self._modules

        def conv_bn(name, y, bn=None):
            return m[bn or f"{name}_bn"](m[name](y), train=train)

        x = x.to(self.dtype)
        # --- Entry flow ---
        x = torch.relu(conv_bn("block1_conv1", x))
        x = torch.relu(conv_bn("block1_conv2", x))
        for idx, _feat in ENTRY_BLOCKS:
            residual = conv_bn(f"block{idx}_res_conv", x, f"block{idx}_res_bn")
            if idx > 2:  # block2 has no leading activation (Keras quirk)
                x = torch.relu(x)
            x = conv_bn(f"block{idx}_sepconv1", x)
            x = torch.relu(x)
            x = conv_bn(f"block{idx}_sepconv2", x)
            x = max_pool_same(x) + residual

        # --- Middle flow: 8 residual blocks of 3 separable convs ---
        for idx in MIDDLE_BLOCKS:
            residual = x
            for j in (1, 2, 3):
                x = torch.relu(x)
                x = conv_bn(f"block{idx}_sepconv{j}", x)
            x = x + residual

        # --- Exit flow ---
        residual = conv_bn("block13_res_conv", x, "block13_res_bn")
        x = torch.relu(x)
        x = conv_bn("block13_sepconv1", x)
        x = torch.relu(x)
        x = conv_bn("block13_sepconv2", x)
        x = max_pool_same(x) + residual

        x = torch.relu(conv_bn("block14_sepconv1", x))
        x = torch.relu(conv_bn("block14_sepconv2", x))
        return self.head(x, train=train)
