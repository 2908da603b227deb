"""PyTorch/CUDA port of the model-serving framework.

A package of its own beside ``kubernetes_deep_learning_tpu`` (the JAX
reference): it imports torch, numpy and the standard library only, reads
the same artifact directories, speaks the same wire protocol, and runs on
hand-written CUDA kernels for Hopper: the Xception middle and exit flows
(``ops/csrc/fused_sepconv.cu``), EfficientNet's stride-1 MBConv blocks
(``ops/csrc/fused_mbconv.cu``), ViT serving attention past 512 tokens
and ViT training attention (``ops/csrc/flash_attention.cu``, the fused
and the partials form).  ``training`` fits a ViT, checkpoints and resumes
it, and exports the result as a served version.  Entry points run on
``cuda`` unless the caller passes ``device="cpu"``.
"""

from kubernetes_deep_learning_tpu_torch.modelspec import (
    CLOTHING_MODEL,
    EFFICIENTNET_B3_IMAGENET,
    VIT_B16_IMAGENET,
    ModelSpec,
    get_spec,
    list_specs,
    register_spec,
)

__all__ = [
    "CLOTHING_MODEL",
    "EFFICIENTNET_B3_IMAGENET",
    "VIT_B16_IMAGENET",
    "ModelSpec",
    "get_spec",
    "list_specs",
    "register_spec",
]
