"""Model zoo entry point: ``build_forward`` (the port of ``models/__init__.py``).

``build_forward(spec, params, dtype, fast, device)`` returns a module
``f(images) -> float32 logits``: uint8 NHWC batches straight off the wire
are normalized on the device (``ops.preprocess.normalize``); float batches
are taken as already normalized.  Families: ``xception`` and
``efficientnet-*``, whose ``fast`` flag picks the fused-kernel path
(``models.xception_fast``, ``models.efficientnet_fast``) or the exact
graph (``models.xception``, ``models.efficientnet``); ``vit-*``
(``models.vit``), whose kernel sits inside its attention, so it has no
separate fast path; and ``resnet50`` (``models.resnet``), which the JAX
package runs on XLA convolutions with no Pallas kernel, so the port runs
it on cuDNN convolutions with no fast path.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from kubernetes_deep_learning_tpu_torch.modelspec import ModelSpec
from kubernetes_deep_learning_tpu_torch.ops.preprocess import normalize


def resolve_device(device: str | torch.device) -> torch.device:
    """A missing GPU is an error, never a silent move to the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' to run on the CPU")
    return device


def exact_float32(device: torch.device) -> None:
    """On CUDA, turn TF32 off for matmuls and convolutions: cuDNN runs
    float32 convolutions in TF32 by default, which keeps ~3 decimal digits
    and breaks the exact float32 graph's parity (serving and training); the
    bf16 path is unaffected."""
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False


def create_model(spec: ModelSpec, dtype: torch.dtype = torch.float32):
    """The exact-graph module for a spec (dtype = compute dtype): families
    ``xception``, ``resnet50``, ``efficientnet-b0``..``-b7`` and the ViTs
    of ``models.vit.VIT_CONFIGS``.  Every family trains through
    ``forward(x, train=True)``, flax's ``apply(..., train=True)``: the
    BatchNorm families on batch statistics (``layers.BatchNorm``)."""
    if spec.family == "xception":
        from kubernetes_deep_learning_tpu_torch.models.xception import Xception

        return Xception(spec.num_classes, head_hidden=spec.head_hidden, dtype=dtype)
    if spec.family == "resnet50":
        from kubernetes_deep_learning_tpu_torch.models.resnet import ResNet50

        return ResNet50(spec.num_classes, head_hidden=spec.head_hidden, dtype=dtype)
    if spec.family.startswith("efficientnet-"):
        from kubernetes_deep_learning_tpu_torch.models.efficientnet import build_efficientnet

        return build_efficientnet(spec.family.removeprefix("efficientnet-"), spec.num_classes,
                                  dtype=dtype, head_hidden=spec.head_hidden)
    from kubernetes_deep_learning_tpu_torch.models.vit import VIT_CONFIGS, ViT

    if spec.family in VIT_CONFIGS:
        return ViT(spec.num_classes, VIT_CONFIGS[spec.family], spec.input_shape, dtype=dtype)
    raise KeyError(f"model family {spec.family!r} is not ported yet")


def init_variables(spec: ModelSpec, seed: int = 0) -> dict:
    """Random variables in the flax tree layout (numpy), made from ``seed``:
    kernels N(0, 1/fan_in), BN/LayerNorm scale U(0.8, 1.2), shift and mean
    N(0, 0.05), var U(0.5, 1.5), ``pos_embed`` N(0, 0.02) as flax inits it
    -- for tests, smoke runs and benchmarks."""
    from kubernetes_deep_learning_tpu_torch.weights import to_jax_variables

    rng = np.random.default_rng(seed)
    params = {}
    for key, t in sorted(create_model(spec).state_dict().items()):
        shape = tuple(t.shape)
        if key.endswith("running_var"):
            arr = rng.uniform(0.5, 1.5, shape)
        elif key == "pos_embed":
            arr = rng.normal(0.0, 0.02, shape)
        elif key.endswith("kernel"):
            # DenseGeneral, flax layout (C, H, D) or (H, D, C) with H*D = C:
            # the fan-in is C, the square root of the size.
            arr = rng.normal(0.0, np.prod(shape) ** -0.25, shape)
        elif key.endswith("weight") and t.dim() == 1:  # BN / LayerNorm scale
            arr = rng.uniform(0.8, 1.2, shape)
        elif key.endswith("weight"):
            arr = rng.normal(0.0, 1.0 / np.sqrt(np.prod(shape[1:])), shape)
        else:  # biases, BN shift, running_mean
            arr = rng.normal(0.0, 0.05, shape)
        params[key] = torch.from_numpy(arr.astype(np.float32))
    return to_jax_variables(params)


def has_fast_forward(spec: ModelSpec) -> bool:
    """Whether a fused-kernel fast path exists for this family.

    Unlike the JAX package, which keeps EfficientNet on the exact graph
    (its fused MBConv kernel measured slower than XLA on a TPU), the port
    serves bf16 EfficientNet through its MBConv kernel on CUDA: no TPU
    measurement carries over to the card, and the kernel must be on a path
    the card runs.  ``fast=False`` keeps the exact graph for any caller."""
    return spec.family == "xception" or spec.family.startswith("efficientnet-")


def resolve_fast(spec: ModelSpec, dtype: torch.dtype, fast: bool | str,
                 device: str | torch.device) -> bool:
    """"auto" = the fused path when the family has one, the compute dtype is
    bfloat16 and the device is a GPU; True/False force it on/off."""
    if fast == "auto":
        return (
            has_fast_forward(spec)
            and dtype == torch.bfloat16
            and torch.device(device).type == "cuda"
        )
    return bool(fast) and has_fast_forward(spec)


class Forward(nn.Module):
    """uint8 or normalized-float NHWC images -> float32 logits."""

    def __init__(self, spec: ModelSpec, inner: nn.Module, fast: bool):
        super().__init__()
        self.spec = spec
        self.inner = inner
        self.fast = fast

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        if images.dtype == torch.uint8:
            x = normalize(images, self.spec.preprocessing)
        else:
            x = images.to(torch.float32)
        return self.inner(x).to(torch.float32)


def build_forward(spec: ModelSpec, params: dict, dtype: torch.dtype = torch.bfloat16,
                  fast: bool | str = "auto", device: str | torch.device = "cuda") -> Forward:
    """The forward module over ``params`` (``weights.from_jax_variables``)
    on ``device``, in eval mode."""
    device = resolve_device(device)
    exact_float32(device)
    use_fast = resolve_fast(spec, dtype, fast, device)
    model = create_model(spec, dtype=dtype)
    model.load_state_dict(params)
    model = model.to(device).eval()
    if use_fast and spec.family == "xception":
        from kubernetes_deep_learning_tpu_torch.models.xception_fast import XceptionFast

        inner = XceptionFast(model, dtype=dtype)
    elif use_fast:
        from kubernetes_deep_learning_tpu_torch.models.efficientnet_fast import EfficientNetFast

        inner = EfficientNetFast(model, dtype=dtype)
    else:
        inner = model
    return Forward(spec, inner, use_fast).eval()
