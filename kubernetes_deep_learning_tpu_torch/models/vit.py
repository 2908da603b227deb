"""Vision Transformer on NHWC input (the port of ``models/vit.py``).

The JAX package's ViT, module for module, so its flax variable tree loads
through ``weights.from_jax_variables``: a strided-conv patch embedding,
learned position embeddings, pre-LayerNorm blocks (multi-head attention,
then a tanh-GELU MLP), a final LayerNorm, a token mean (no cls token) and a
Dense head.  Numerics follow flax:

- LayerNorm (epsilon 1e-6) runs in f32 on an f32 copy of its input; the
  blocks cast the result back to the compute dtype;
- patch embedding, Dense and DenseGeneral layers cast input, kernel and
  bias to the compute dtype; ``pos_embed`` is cast before the add.  The
  patch embedding (``models.layers.Conv2dNHWC``) and the MLP's Dense layers
  (``models.layers.Dense``) are called through their modules, the
  counterparts of flax's ``nn.Conv`` and ``nn.Dense``, so ``ops.quantize``
  calibrates them as JAX's interceptor does;
- the final LayerNorm, token mean and head run in f32 (the head has no
  compute dtype).

``forward(x, train=False)`` threads ``train`` down to the attention, as
flax's ``ViT.apply(..., train=...)`` does: ``train=False`` goes through
``ops.attention.attention_serving`` (the einsum route up to 512 tokens,
flash attention, kernel K3 on CUDA, past it); ``train=True`` through
``ops.attention.attention_trainable`` (the partials kernel K3P on CUDA,
with the blockwise-recompute backward).  ``pos_embed``'s length is the
token count, so the module is built for one input size.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from kubernetes_deep_learning_tpu_torch.models.layers import Conv2dNHWC, Dense
from kubernetes_deep_learning_tpu_torch.ops import attention

FLAX_LN_EPS = 1e-6  # flax nn.LayerNorm's default (torch's is 1e-5)


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    patch: int
    width: int
    depth: int
    heads: int
    mlp_ratio: int = 4

    @property
    def head_dim(self) -> int:
        return self.width // self.heads


# Family registry: ModelSpec.family -> architecture hyperparameters.
VIT_CONFIGS: dict[str, ViTConfig] = {
    "vit-s16": ViTConfig(patch=16, width=384, depth=12, heads=6),
    "vit-b16": ViTConfig(patch=16, width=768, depth=12, heads=12),
    "vit-tiny": ViTConfig(patch=8, width=64, depth=2, heads=2),  # test scale
}


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm``: f32 in and out, epsilon 1e-6."""

    def __init__(self, c: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))

    def forward(self, x):
        return F.layer_norm(x.float(), (x.shape[-1],), self.weight, self.bias, FLAX_LN_EPS)


class DenseGeneral(nn.Module):
    """flax ``DenseGeneral`` with the kernel in flax's layout: ``kernel``
    (*in_shape, *out_shape), ``bias`` out_shape; the input's trailing
    ``len(in_shape)`` dims are contracted."""

    def __init__(self, in_shape: tuple[int, ...], out_shape: tuple[int, ...]):
        super().__init__()
        self.n_in = len(in_shape)
        self.out_shape = out_shape
        self.kernel = nn.Parameter(torch.zeros(*in_shape, *out_shape))
        self.bias = nn.Parameter(torch.zeros(*out_shape))

    def forward(self, x):
        dt = x.dtype
        lead = x.shape[: x.dim() - self.n_in]
        w = self.kernel.to(dt).reshape(-1, self.bias.numel())  # (in, out)
        y = F.linear(x.reshape(*lead, w.shape[0]), w.t(), self.bias.to(dt).reshape(-1))
        return y.reshape(*lead, *self.out_shape)


class SelfAttention(nn.Module):
    """Multi-head self-attention over (B, S, C) tokens."""

    def __init__(self, width: int, heads: int):
        super().__init__()
        head_dim = width // heads
        for name in ("query", "key", "value"):
            self.add_module(name, DenseGeneral((width,), (heads, head_dim)))
        self.out = DenseGeneral((heads, head_dim), (width,))

    def forward(self, x, train: bool = False):
        # (B, S, H, D) -> (B, H, S, D) views: the kernels read them in place.
        q, k, v = (self._modules[n](x).transpose(1, 2) for n in ("query", "key", "value"))
        if train:
            o = attention.attention_trainable(q, k, v)
        else:
            o = attention.attention_serving(q, k, v)
        return self.out(o.transpose(1, 2))


class TransformerBlock(nn.Module):
    """Pre-LayerNorm residual block: MHA then GELU MLP."""

    def __init__(self, width: int, heads: int, mlp_ratio: int):
        super().__init__()
        self.ln_attn = LayerNorm(width)
        self.attn = SelfAttention(width, heads)
        self.ln_mlp = LayerNorm(width)
        self.mlp_in = Dense(width, width * mlp_ratio)
        self.mlp_out = Dense(width * mlp_ratio, width)

    def forward(self, x, train: bool = False):
        x = x + self.attn(self.ln_attn(x).to(x.dtype), train=train)
        y = self.ln_mlp(x).to(x.dtype)
        y = F.gelu(self.mlp_in(y), approximate="tanh")  # flax nn.gelu
        return x + self.mlp_out(y)


class ViT(nn.Module):
    def __init__(self, num_classes: int, config: ViTConfig,
                 input_shape: tuple[int, int, int], dtype: torch.dtype = torch.float32):
        super().__init__()
        h, w, c = input_shape
        if h % config.patch or w % config.patch:
            raise ValueError(f"input {h}x{w} not divisible by patch size {config.patch}")
        self.config = config
        self.dtype = dtype
        self.grid = (h // config.patch, w // config.patch)
        self.patch_embed = Conv2dNHWC(c, config.width, config.patch, config.patch, bias=True)
        self.pos_embed = nn.Parameter(torch.zeros(1, self.grid[0] * self.grid[1], config.width))
        for i in range(config.depth):
            self.add_module(
                f"block_{i}", TransformerBlock(config.width, config.heads, config.mlp_ratio)
            )
        self.ln_final = LayerNorm(config.width)
        self.head = Dense(config.width, num_classes)

    def forward(self, x, train: bool = False):
        dt, cfg = self.dtype, self.config
        x = self.patch_embed(x.to(dt))
        if x.shape[1:3] != self.grid:
            raise ValueError(f"input gives a {tuple(x.shape[1:3])} patch grid, "
                             f"the model was built for {self.grid}")
        x = x.reshape(x.shape[0], -1, cfg.width) + self.pos_embed.to(dt)
        for i in range(cfg.depth):
            x = self._modules[f"block_{i}"](x, train=train)
        x = self.ln_final(x).mean(dim=1)  # f32 from here on
        return self.head(x)
