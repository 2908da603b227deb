"""ModelSpec: the single source of truth for a served model.

The port's own copy of ``kubernetes_deep_learning_tpu.modelspec``: the same
dataclass and the same JSON form, so a ``spec.json`` written by the JAX
exporter loads here unchanged and a gateway of either package reads the
spec this server publishes.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    """Everything needed to serve and query one model."""

    name: str                       # served model name, e.g. "clothing-model"
    family: str                     # architecture family key
    input_shape: tuple[int, int, int]   # (H, W, C), batch dim excluded
    labels: tuple[str, ...]         # output class labels, index-aligned
    preprocessing: str = "tf"       # "tf" | "caffe" | "torch" | "none"
    resize_filter: str = "bilinear"  # "bilinear" | "nearest" (host resize filter)
    input_dtype: str = "uint8"      # wire dtype gateway -> server (normalize on device)
    input_name: str = "image"       # request tensor key
    output_name: str = "scores"     # response tensor key
    head_hidden: tuple[int, ...] = ()   # hidden Dense sizes between pool and logits
    description: str = ""
    compat_input_name: str = ""     # legacy TF-Serving tensor names
    compat_output_name: str = ""

    @property
    def num_classes(self) -> int:
        return len(self.labels)

    @property
    def batched_shape(self) -> tuple[int, ...]:
        return (-1, *self.input_shape)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, sort_keys=True)

    @classmethod
    def from_json(cls, s: str) -> "ModelSpec":
        d: dict[str, Any] = json.loads(s)
        d["input_shape"] = tuple(d["input_shape"])
        d["labels"] = tuple(d["labels"])
        d["head_hidden"] = tuple(d.get("head_hidden", ()))
        return cls(**d)


_REGISTRY: dict[str, ModelSpec] = {}


def register_spec(spec: ModelSpec) -> ModelSpec:
    _REGISTRY[spec.name] = spec
    return spec


def get_spec(name: str) -> ModelSpec:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown model spec {name!r}; known: {sorted(_REGISTRY)}"
        ) from None


def list_specs() -> list[str]:
    return sorted(_REGISTRY)


# The flagship model: the 10-class Xception clothing classifier,
# uint8 (-1, 299, 299, 3) in, (-1, 10) f32 logits out, head Dense(100).
CLOTHING_MODEL = register_spec(
    ModelSpec(
        name="clothing-model",
        family="xception",
        input_shape=(299, 299, 3),
        labels=(
            "dress",
            "hat",
            "longsleeve",
            "outwear",
            "pants",
            "shirt",
            "shoes",
            "shorts",
            "skirt",
            "t-shirt",
        ),
        preprocessing="tf",
        resize_filter="nearest",
        head_hidden=(100,),
        description="Xception clothing classifier (reference flagship model)",
        compat_input_name="input_8",
        compat_output_name="dense_7",
    )
)

_IMAGENET_LABELS = tuple(f"class_{i}" for i in range(1000))

# BASELINE config 3: ResNet50/ImageNet served through the same gateway path,
# 224x224, Keras "caffe" preprocessing.  The same spec as the JAX package's.
RESNET50_IMAGENET = register_spec(
    ModelSpec(
        name="resnet50-imagenet",
        family="resnet50",
        input_shape=(224, 224, 3),
        labels=_IMAGENET_LABELS,
        preprocessing="caffe",
        description="ResNet50 ImageNet classifier",
    )
)

# EfficientNet-B3 ImageNet classifier at its native 300x300, torchvision
# normalization.  The same spec as the JAX package's, so an artifact of
# either package loads in the other.
EFFICIENTNET_B3_IMAGENET = register_spec(
    ModelSpec(
        name="efficientnet-b3-imagenet",
        family="efficientnet-b3",
        input_shape=(300, 300, 3),
        labels=_IMAGENET_LABELS,
        preprocessing="torch",
        description="EfficientNet-B3 ImageNet classifier",
    )
)

# ViT-B/16 ImageNet classifier, 256x256 in: 16x16 patches give 256 tokens,
# so serving attention takes the einsum route.  The same spec as the JAX
# package's, so an artifact of either package loads in the other.
VIT_B16_IMAGENET = register_spec(
    ModelSpec(
        name="vit-b16-imagenet",
        family="vit-b16",
        input_shape=(256, 256, 3),
        labels=_IMAGENET_LABELS,
        preprocessing="tf",
        description="ViT-B/16 ImageNet classifier (Pallas flash attention)",
    )
)
