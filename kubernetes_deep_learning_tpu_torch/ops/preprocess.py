"""Device-side normalization: the server half of ``ops/preprocess.py``.

uint8 images arrive on the tensor wire already decoded and resized by the
gateway; the elementwise scale/shift runs on the device, in float32, with
the JAX package's constants (bit-equal to its numpy ``normalize``).
"""

from __future__ import annotations

import functools

import torch

#   tf    : x / 127.5 - 1            (Keras "tf" mode; Xception)
#   caffe : BGR, subtract ImageNet channel means (Keras "caffe" mode; ResNet50)
#   torch : x / 255, ImageNet mean/std (EfficientNet, torchvision convention)
_CAFFE_MEAN_BGR = (103.939, 116.779, 123.68)
_TORCH_MEAN = (0.485, 0.456, 0.406)
_TORCH_STD = (0.229, 0.224, 0.225)


@functools.lru_cache(maxsize=None)
def _const(values: tuple[float, ...], device: torch.device) -> torch.Tensor:
    """A constant made on ``device`` once: a forward captured into a CUDA
    graph must not copy one from pageable host memory."""
    return torch.tensor(values, dtype=torch.float32, device=device)


def normalize(x: torch.Tensor, mode: str) -> torch.Tensor:
    """uint8/float NHWC batch -> normalized float32 on ``x``'s device."""
    if mode == "none":
        return x
    x = x.to(torch.float32)
    if mode == "tf":
        return x / 127.5 - 1.0
    const = lambda v: _const(v, x.device)  # noqa: E731
    if mode == "caffe":
        return x.flip(-1) - const(_CAFFE_MEAN_BGR)
    if mode == "torch":
        return (x / 255.0 - const(_TORCH_MEAN)) / const(_TORCH_STD)
    raise ValueError(f"unknown preprocessing mode {mode!r}")
