"""Xception fast path: the port of ``models/xception_fast.py``.

The exact graph's entry flow on library convolutions (the JAX package
leaves it to XLA), the 8 middle blocks on ``ops.fused_sepconv.
fused_sepconv_block`` and the exit flow's two sepconv chains (block13
728->728->1024, block14 1024->1536->2048) on ``fused_sepconv_chain``: the
hand-written CUDA kernel on the card, its plain PyTorch version on the
CPU.  Numerics follow the JAX fast path op for op: bf16 compute, BN in bf16
in the entry flow, BN folded to an f32 affine inside the kernels, the
residual 1x1/2 conv of block13 as a bf16 matmul with an f32 affine.

``entry_kernel=True`` is the port of ``build_fast_forward(entry_kernel=
True)``: after conv1 (library ops, as above), conv2 + block2 run on
``ops.fused_entry.fused_entry_block`` and blocks 3 and 4 on
``fused_sepconv_chain`` (74x74 128->256->256, 37x37 256->728->728), each
with its residual and pool as block13's.  ``models.build_forward`` never
sets it, as JAX's does not: whether it pays on the card is a measurement
(``chip_smoke.py``).

The kernel-ready weights are derived once, when the module is built, from
the exact graph's parameters, and the middle blocks' stage views
(``fused_sepconv.prepare_block``) are sliced and checked then too.  The JAX path's TPU-only schedule rules
(batch padded to a multiple of 8, 16-image chunking) have no counterpart,
nor has ``conv1_t``: it computes conv1 in the TPU kernels' (H, W, B, C)
layout to spare a transpose, and the port is NHWC end to end.
"""

from __future__ import annotations

import torch
from torch import nn

from kubernetes_deep_learning_tpu_torch.models.layers import (
    conv2d_nhwc,
    lowp_batchnorms,
    lowp_bn,
    max_pool_same,
)
from kubernetes_deep_learning_tpu_torch.models.xception import (
    ENTRY_BLOCKS,
    MIDDLE_BLOCKS,
    Xception,
)
from kubernetes_deep_learning_tpu_torch.ops.fused_entry import fused_entry_block
from kubernetes_deep_learning_tpu_torch.ops.fused_sepconv import (
    fused_sepconv_block_stages,
    fused_sepconv_chain,
    prepare_block,
)
from kubernetes_deep_learning_tpu_torch.weights import (
    entry_block_weights,
    fold_bn,
    middle_block_weights,
    sepconv_stage_weights,
)


class XceptionFast(nn.Module):
    """``f(normalized NHWC float images) -> bf16 logits`` over ``model``'s
    parameters (read once, at construction)."""

    def __init__(self, model: Xception, dtype: torch.dtype = torch.bfloat16,
                 entry_kernel: bool = False):
        super().__init__()
        if dtype != torch.bfloat16:
            raise ValueError("the fused sepconv kernels compute in bfloat16 only")
        self.dtype = dtype
        self.entry_kernel = entry_kernel
        p = {k: v.detach() for k, v in model.state_dict().items()}
        # Entry flow and head run on library ops in the compute dtype.
        entry = tuple(f"block{i}_" for i in range(1, 5)) + ("head.",)
        cast = {k: v.to(dtype) for k, v in p.items() if k.startswith(entry)}
        self._w = {k: v for k, v in cast.items() if ".running_" not in k}
        # Entry-flow BN in the compute dtype, as the JAX fast path's bn().
        self._bn = lowp_batchnorms(cast, dtype)
        # Each middle block's stage views, sliced and checked once here
        # rather than on every forward.
        self._middle = [prepare_block(*middle_block_weights(p, f"block{i}"))
                        for i in MIDDLE_BLOCKS]
        self._down = {i: self._downsample_weights(p, f"block{i}")
                      for i in ((3, 4, 13) if entry_kernel else (13,))}
        self._entry = entry_block_weights(p) if entry_kernel else None
        self._block14 = [
            sepconv_stage_weights(p, f"block14_sepconv{j}", f"block14_sepconv{j}_bn",
                                  pre_relu=False, post_relu=True)
            for j in (1, 2)
        ]
        self._n_hidden = model.head.n_hidden

    def _downsample_weights(self, p, block):
        """Residual 1x1/2 (bf16 matrix, f32 affine) and the two relu-first
        sepconv stages of a downsampling block (3, 4, 13)."""
        res_scale, res_shift = fold_bn(p, f"{block}_res_bn")
        res = p[f"{block}_res_conv.weight"][:, :, 0, 0].t().to(self.dtype).contiguous()
        stages = [sepconv_stage_weights(p, f"{block}_sepconv{j}", f"{block}_sepconv{j}_bn",
                                        pre_relu=True, post_relu=False) for j in (1, 2)]
        return res, res_scale, res_shift, stages

    def _downsample(self, x, block: int):
        """``downsample_t``: residual 1x1/2 as a bf16 matmul with an f32
        affine, the fused two-stage chain, max-pool + residual."""
        w_res, res_scale, res_shift, stages = self._down[block]
        res = x[:, ::2, ::2] @ w_res
        res = (res.float() * res_scale + res_shift).to(self.dtype)
        y = fused_sepconv_chain(x, stages)
        return (max_pool_same(y) + res).contiguous()

    def _bn_apply(self, x, name):
        return lowp_bn(x, self._bn[name])

    def _conv(self, x, name, stride=1, padding="VALID"):
        return conv2d_nhwc(x, self._w[f"{name}.weight"], stride, padding)

    def _sepconv(self, x, name):
        x = conv2d_nhwc(x, self._w[f"{name}.depthwise.weight"], padding="SAME",
                        groups=x.shape[-1])
        return conv2d_nhwc(x, self._w[f"{name}.pointwise.weight"])

    def forward(self, x):
        bn = self._bn_apply
        x = x.to(self.dtype)
        # --- entry flow: library convolutions ---
        x = torch.relu(bn(self._conv(x, "block1_conv1", stride=2), "block1_conv1_bn"))
        if self.entry_kernel:
            # --- conv2 + block2 fused, blocks 3 and 4 as fused chains ---
            x = fused_entry_block(x.contiguous(), self._entry)
            x = self._downsample(self._downsample(x, 3), 4)
        else:
            x = self._entry_flow(x)

        # --- middle flow: 8 fused blocks, NHWC contiguous for the kernel ---
        x = x.contiguous()
        for stages in self._middle:
            x = fused_sepconv_block_stages(x, stages)

        # --- block13: residual 1x1/2 (matmul) + fused chain + pool ---
        x = self._downsample(x, 13)

        # --- block14: fused chain (sep -> bn -> relu, twice) ---
        x = fused_sepconv_chain(x, self._block14)

        # --- head (ClassifierHead semantics) ---
        x = x.mean(dim=(1, 2))
        for i in range(self._n_hidden):
            x = torch.relu(
                torch.nn.functional.linear(
                    x, self._w[f"head.hidden_{i}.weight"], self._w[f"head.hidden_{i}.bias"]
                )
            )
        return torch.nn.functional.linear(
            x, self._w["head.logits.weight"], self._w["head.logits.bias"]
        )

    def _entry_flow(self, x):
        """conv2 and blocks 2-4 on library ops (the exact graph's, bf16 BN)."""
        bn = self._bn_apply
        x = torch.relu(bn(self._conv(x, "block1_conv2"), "block1_conv2_bn"))
        for idx, _feat in ENTRY_BLOCKS:
            residual = bn(
                self._conv(x, f"block{idx}_res_conv", stride=2, padding="SAME"),
                f"block{idx}_res_bn",
            )
            if idx > 2:
                x = torch.relu(x)
            x = bn(self._sepconv(x, f"block{idx}_sepconv1"), f"block{idx}_sepconv1_bn")
            x = torch.relu(x)
            x = bn(self._sepconv(x, f"block{idx}_sepconv2"), f"block{idx}_sepconv2_bn")
            x = max_pool_same(x) + residual
        return x
