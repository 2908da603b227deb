"""PyTorch/CUDA port of the model-serving framework.

A package of its own beside ``kubernetes_deep_learning_tpu`` (the JAX
reference): it imports torch, numpy and the standard library only, reads
the same artifact directories, speaks the same wire protocol, and runs the
Xception middle and exit flows on hand-written CUDA kernels for Hopper
(``ops/csrc/fused_sepconv.cu``).  Entry points run on ``cuda`` unless the
caller passes ``device="cpu"``.
"""

from kubernetes_deep_learning_tpu_torch.modelspec import (
    CLOTHING_MODEL,
    ModelSpec,
    get_spec,
    list_specs,
    register_spec,
)

__all__ = ["CLOTHING_MODEL", "ModelSpec", "get_spec", "list_specs", "register_spec"]
