"""EfficientNet fast path: the port of ``models/efficientnet_fast.py``.

The exact graph's stem, top, head and the blocks the kernel does not take
run on library convolutions in bf16, with the JAX fast path's bf16
BatchNorm (every operand in the compute dtype, not flax's f32 BN); the
stride-1 expanded blocks that the JAX package fuses run on
``ops.fused_mbconv.fused_mbconv_block``: the hand-written CUDA kernels on
the card, their plain PyTorch version on the CPU.  A fused stage opener
(stride 1, width changes) runs with ``residual=False``.

Which blocks are fused follows the JAX routing rule
(``fusible_as_in_jax``: stride 1, expand ratio > 1, and a TPU VMEM budget
that keeps the two high-resolution early stages off the kernel), so both
packages fuse the same blocks: 18 of EfficientNet-B3's 26 at 300 px.  The
JAX path's TPU-only schedule (the batch padded to a multiple of 8, the
(H, W, B, C) transposes around each fused run) has no counterpart: the
port stays NHWC throughout.  The kernel-ready weights are derived once,
when the module is built, from the exact graph's parameters.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from kubernetes_deep_learning_tpu_torch.models.efficientnet import EfficientNet
from kubernetes_deep_learning_tpu_torch.models.layers import (
    conv2d_nhwc,
    lowp_batchnorms,
    lowp_bn,
)
from kubernetes_deep_learning_tpu_torch.ops.fused_mbconv import (
    fused_mbconv_block,
    fusible_as_in_jax,
)
from kubernetes_deep_learning_tpu_torch.weights import mbconv_block_weights


class Block(NamedTuple):
    """One MBConv block as a forward meets it: its input is h x w x c_in."""

    name: str
    h: int
    w: int
    c_in: int
    features: int
    stride: int
    kernel: int
    expand: int
    fused: bool

    @property
    def residual(self) -> bool:
        return self.stride == 1 and self.c_in == self.features


def block_routes(plan, h: int, w: int, c: int) -> list[Block]:
    """Every block of ``plan`` (``efficientnet.block_plan``), entered at the
    stem's h x w x c output, with whether the fast path fuses it."""
    routes = []
    for name, stride, kernel, features, expand in plan:
        fused = stride == 1 and expand != 1 and fusible_as_in_jax(h, w, c * expand)
        routes.append(Block(name, h, w, c, features, stride, kernel, expand, fused))
        h, w, c = -(-h // stride), -(-w // stride), features  # SAME: ceil(h / stride)
    return routes


class EfficientNetFast(nn.Module):
    """``f(normalized NHWC float images) -> bf16 logits`` over ``model``'s
    parameters (read once, at construction)."""

    def __init__(self, model: EfficientNet, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        if dtype != torch.bfloat16:
            raise ValueError("the fused MBConv kernel computes in bfloat16 only")
        self.dtype = dtype
        self.plan = model.plan
        self.stem_features = model.stem_conv.out_channels
        p = {k: v.detach() for k, v in model.state_dict().items()}
        cast = {k: v.to(dtype) for k, v in p.items()}
        self._w = {k: v for k, v in cast.items() if ".running_" not in k}
        self._bn = lowp_batchnorms(cast, dtype)
        # Every block the kernel can take; the input size decides which run on it.
        self._fused_w = {name: mbconv_block_weights(p, name)
                         for name, stride, _, _, expand in self.plan if stride == 1 and expand != 1}
        self._n_hidden = model.head.n_hidden
        self._routes: dict[tuple[int, int], list[Block]] = {}

    def routes(self, h: int, w: int) -> list[Block]:
        """The blocks of a forward over h x w images."""
        if (h, w) not in self._routes:
            self._routes[h, w] = block_routes(self.plan, -(-h // 2), -(-w // 2),
                                              self.stem_features)
        return self._routes[h, w]

    def _conv(self, x, name, stride=1, groups=1):
        return conv2d_nhwc(x, self._w[f"{name}.weight"], stride, "SAME", groups)

    def _bn_apply(self, x, name):
        return lowp_bn(x, self._bn[name])

    def _mbconv(self, x, blk: Block):
        """The JAX fast path's ``mbconv_xla``: flax MBConvBlock semantics,
        every op in bf16."""
        n, bn = blk.name, self._bn_apply
        y = x
        if blk.expand != 1:
            y = F.silu(bn(self._conv(y, f"{n}.expand_conv"), f"{n}.expand_bn"))
        y = self._conv(y, f"{n}.dwconv", blk.stride, groups=y.shape[-1])
        y = F.silu(bn(y, f"{n}.dw_bn"))
        m = y.mean(dim=(1, 2), keepdim=True)
        r = F.silu(self._conv(m, f"{n}.se.reduce") + self._w[f"{n}.se.reduce.bias"])
        g = torch.sigmoid(self._conv(r, f"{n}.se.expand") + self._w[f"{n}.se.expand.bias"])
        y = bn(self._conv(y * g, f"{n}.project_conv"), f"{n}.project_bn")
        return y + x if blk.residual else y

    def forward(self, x):
        routes = self.routes(x.shape[1], x.shape[2])
        x = x.to(self.dtype)
        x = F.silu(self._bn_apply(self._conv(x, "stem_conv", stride=2), "stem_bn"))
        for blk in routes:
            if blk.fused:
                x = fused_mbconv_block(x.contiguous(), self._fused_w[blk.name], blk.residual)
            else:
                x = self._mbconv(x, blk)
        x = F.silu(self._bn_apply(self._conv(x, "top_conv"), "top_bn"))

        # --- head (ClassifierHead semantics) ---
        x = x.mean(dim=(1, 2))
        for i in range(self._n_hidden):
            x = torch.relu(F.linear(x, self._w[f"head.hidden_{i}.weight"],
                                    self._w[f"head.hidden_{i}.bias"]))
        return F.linear(x, self._w["head.logits.weight"], self._w["head.logits.bias"])
