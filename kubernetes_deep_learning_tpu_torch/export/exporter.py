"""Export trained parameters as a served version (the params-only half of
``export/exporter.py::export_model``).

Writes ``<root>/<name>/<version>/`` through ``artifact.save_artifact``:
``spec.json``, a flax-readable ``params.msgpack`` and ``metadata.json``,
so the model servers of both packages load it.  There is no StableHLO
module: the port serves from the parameters, and the JAX engine traces
its forward from them.
"""

from __future__ import annotations

import os
import shutil

from kubernetes_deep_learning_tpu_torch.export import artifact as art
from kubernetes_deep_learning_tpu_torch.modelspec import ModelSpec

def export_model(spec: ModelSpec, variables: dict, root: str) -> str:
    """Export ``variables`` (a flax tree of numpy arrays) as the next
    version (the latest plus 1; 1 for a new model) under
    ``<root>/<name>/`` and return its directory.  The version is staged
    under a dot-name and renamed into place, so a server scanning the root
    never sees it half written; serving computes in bfloat16, the JAX
    exporter's default."""
    latest = art.latest_version(root, spec.name)
    version = 1 if latest is None else latest + 1
    metadata = {
        "compute_dtype": "bfloat16",
        "params_dtype": None,
        "platforms": [],
        "module_layout": "params-only",
        "exporter": "kubernetes_deep_learning_tpu_torch",
    }
    directory = art.version_dir(root, spec.name, version)
    staging = os.path.join(os.path.dirname(directory), f".tmp-{version}")
    shutil.rmtree(staging, ignore_errors=True)
    art.save_artifact(staging, spec, variables, metadata)
    os.rename(staging, directory)
    return directory
