"""Artifact inspector: the ``saved_model_cli show`` equivalent, for the port.

The reference's workflow requires running ``saved_model_cli show --dir ...``
to discover signature/tensor names and then hand-copying them into the
gateway (reference guide.md:199-236).  Here the inspector renders what
``spec.json`` and ``metadata.json`` declare -- nothing needs to be
hand-copied because every consumer reads the same ModelSpec.  The port
serves from the parameters alone, so where the JAX inspector prints the
StableHLO module's lines this one says the artifact is params-only (and
ignores any module a JAX-written artifact also holds).

CLI (``kdlt-torch-inspect``)::

    python -m kubernetes_deep_learning_tpu_torch.export.inspect --dir models/clothing-model/1
    python -m kubernetes_deep_learning_tpu_torch.export.inspect --root models  # list all
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

from kubernetes_deep_learning_tpu_torch import msgpack_lite
from kubernetes_deep_learning_tpu_torch.export import artifact as art
from kubernetes_deep_learning_tpu_torch.modelspec import ModelSpec


def describe(directory: str) -> str:
    with open(os.path.join(directory, art.SPEC_FILE)) as f:
        spec = ModelSpec.from_json(f.read())
    metadata: dict = {}
    if os.path.exists(os.path.join(directory, art.META_FILE)):
        with open(os.path.join(directory, art.META_FILE)) as f:
            metadata = json.load(f)
    lines = [
        f"Artifact: {directory}",
        f"  model:         {spec.name} (family={spec.family})",
        f"  description:   {spec.description}",
        f"  input:         {spec.input_name} "
        f"(-1, {', '.join(map(str, spec.input_shape))}) {spec.input_dtype}",
        f"  output:        {spec.output_name} (-1, {spec.num_classes}) float32",
        f"  preprocessing: {spec.preprocessing} (resize={spec.resize_filter})",
        f"  labels:        {', '.join(spec.labels[:10])}"
        + (" ..." if len(spec.labels) > 10 else ""),
    ]
    with open(os.path.join(directory, art.PARAMS_FILE), "rb") as f:
        leaves = list(_leaves(msgpack_lite.unpackb(f.read())))
    n_params = sum(int(np.prod(v.shape)) for v in leaves)
    # Bytes as stored: a bfloat16 artifact's float leaves (every one, as
    # exporter.cast_params casts them) were widened to float32 on decode.
    bf16 = metadata.get("params_dtype") == "bfloat16"
    n_bytes = sum(v.size * 2 if bf16 and v.dtype == np.float32 else v.nbytes for v in leaves)
    lines.append(f"  params:        {n_params:,} ({n_bytes / 1e6:.1f} MB)")
    layout = metadata.get("module_layout", "params-only")
    lines.append(f"  module:        none served: params-only (module_layout={layout})")
    for k, v in sorted(metadata.items()):
        lines.append(f"  meta.{k}: {v}")
    return "\n".join(lines)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description="Inspect exported model artifacts (the PyTorch "
                                "port's)")
    p.add_argument("--dir", help="one artifact version directory")
    p.add_argument("--root", help="artifact root: list every model/version")
    args = p.parse_args(argv)
    if not args.dir and not args.root:
        p.error("pass --dir or --root")
    if args.dir:
        print(describe(args.dir))
    if args.root:
        for name in sorted(os.listdir(args.root)):
            for v in art.scan_versions(args.root, name):
                print(describe(art.version_dir(args.root, name, v)))
                print()
    return 0


if __name__ == "__main__":
    sys.exit(main())
