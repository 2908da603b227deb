"""Versioned model-artifact layout: ``<root>/<model-name>/<version>/``.

The same directory the JAX exporter writes (TF-Serving's
``/models/<name>/<n>`` convention): ``spec.json``, ``params.msgpack``
(flax's msgpack format: the ``{params, batch_stats}`` variable tree) and
``metadata.json``.  The port serves from the parameters alone; the
StableHLO modules an artifact may also hold are ignored.  Reading and
writing need neither flax nor the ``msgpack`` package (``msgpack_lite``).
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
from typing import Any

from kubernetes_deep_learning_tpu_torch import msgpack_lite
from kubernetes_deep_learning_tpu_torch.modelspec import ModelSpec

SPEC_FILE = "spec.json"
PARAMS_FILE = "params.msgpack"
META_FILE = "metadata.json"


@dataclasses.dataclass
class ModelArtifact:
    spec: ModelSpec
    variables: Any  # the flax variable tree: nested dicts of numpy arrays
    metadata: dict
    path: str = ""


def save_artifact(directory: str, spec: ModelSpec, variables: Any, metadata: dict) -> str:
    """Write one artifact dir (a flax-readable ``params.msgpack``)."""
    os.makedirs(directory, exist_ok=True)
    with open(os.path.join(directory, SPEC_FILE), "w") as f:
        f.write(spec.to_json())
    with open(os.path.join(directory, PARAMS_FILE), "wb") as f:
        f.write(msgpack_lite.packb(variables))
    with open(os.path.join(directory, META_FILE), "w") as f:
        json.dump(metadata, f, indent=2, sort_keys=True)
    return directory


def load_artifact(directory: str) -> ModelArtifact:
    with open(os.path.join(directory, SPEC_FILE)) as f:
        spec = ModelSpec.from_json(f.read())
    with open(os.path.join(directory, PARAMS_FILE), "rb") as f:
        variables = msgpack_lite.unpackb(f.read())
    metadata = {}
    meta_path = os.path.join(directory, META_FILE)
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            metadata = json.load(f)
    return ModelArtifact(spec, variables, metadata, path=directory)


def scan_versions(root: str, name: str) -> list[int]:
    """Numeric version dirs under <root>/<name>/, ascending (TF-Serving rule)."""
    model_dir = os.path.join(root, name)
    if not os.path.isdir(model_dir):
        return []
    return sorted(
        int(d) for d in os.listdir(model_dir)
        if re.fullmatch(r"\d+", d) and os.path.isdir(os.path.join(model_dir, d))
    )


def latest_version(root: str, name: str) -> int | None:
    versions = scan_versions(root, name)
    return versions[-1] if versions else None


def version_dir(root: str, name: str, version: int) -> str:
    return os.path.join(root, name, str(version))
