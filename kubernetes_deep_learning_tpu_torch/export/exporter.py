"""Model exporter: the reference ``convert.py`` equivalent, for the port.

The reference exports Keras .h5 -> TF SavedModel (reference convert.py:4-6).
Here the export writes the trained parameters as a served version:
``<root>/<name>/<version>/`` through ``artifact.save_artifact``, with
``spec.json``, a flax-readable ``params.msgpack`` and ``metadata.json``
(``compute_dtype``, ``params_dtype``), so the model servers of both
packages load it.  There is no StableHLO module: the port serves from the
parameters, and the JAX engine traces its forward from them.

CLI (``kdlt-torch-export``; the JAX exporter's flags, ``--device`` for
``--platform``)::

    python -m kubernetes_deep_learning_tpu_torch.export.exporter \\
        --model clothing-model --weights model.h5 --output ./models [--calibrate 32]
"""

from __future__ import annotations

import argparse
import os
import shutil
import sys
import time
from typing import Any

import numpy as np

from kubernetes_deep_learning_tpu_torch import msgpack_lite
from kubernetes_deep_learning_tpu_torch.export import artifact as art
from kubernetes_deep_learning_tpu_torch.modelspec import ModelSpec, get_spec

DTYPES = ("bfloat16", "float32")


def dtype_name(dtype: Any) -> str:
    """``"bfloat16"``/``"float32"`` from a name, a torch or a numpy dtype."""
    name = str(dtype).removeprefix("torch.")
    if name not in DTYPES:
        name = np.dtype(dtype).name
    if name not in DTYPES:
        raise ValueError(f"unsupported dtype {dtype!r}; one of {DTYPES}")
    return name


def cast_params(variables: Any, dtype: Any) -> Any:
    """Cast float32 leaves (params + batch stats) to a storage dtype.

    bfloat16 storage halves the artifact size and load time; it is written
    as flax writes a bfloat16 array (``msgpack_lite.Bfloat16``, rounded to
    nearest even as ``astype(jnp.bfloat16)``) and widened back to float32,
    exactly, on load.  Non-float leaves pass through."""
    name = dtype_name(dtype)

    def cast(a):
        if isinstance(a, dict):
            return {k: cast(v) for k, v in a.items()}
        a = np.asarray(a)
        if a.dtype != np.float32 or name == "float32":
            return a
        return msgpack_lite.Bfloat16(a)

    return cast(variables)


def export_model(
    spec: ModelSpec,
    variables: Any,
    root: str,
    version: int | None = None,
    dtype: Any = "bfloat16",
    params_dtype: Any = None,
    init: str | None = None,
) -> str:
    """Export ``variables`` (a flax tree of numpy arrays) into
    ``<root>/<name>/<version>/`` and return the directory.  ``version``
    defaults to the latest plus 1 (1 for a new model).  ``dtype`` is the
    compute dtype the servers run (``compute_dtype``); ``params_dtype``
    optionally re-casts the stored variables (``cast_params``; None keeps
    them).  ``init`` records where the weights came from.  The version is
    staged under a dot-name and renamed into place, so a server scanning
    the root never sees it half written."""
    if version is None:
        latest = art.latest_version(root, spec.name)
        version = 1 if latest is None else latest + 1
    if params_dtype is not None:
        variables = cast_params(variables, params_dtype)
    metadata = {
        "compute_dtype": dtype_name(dtype),
        "params_dtype": None if params_dtype is None else dtype_name(params_dtype),
        "platforms": [],
        "module_layout": "params-only",
        "exporter": "kubernetes_deep_learning_tpu_torch",
    }
    if init is not None:
        metadata["init"] = init
    directory = art.version_dir(root, spec.name, version)
    staging = os.path.join(os.path.dirname(directory), f".tmp-{version}")
    shutil.rmtree(staging, ignore_errors=True)
    art.save_artifact(staging, spec, variables, metadata)
    os.rename(staging, directory)
    return directory


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description="Export a model for serving (the PyTorch port's)")
    p.add_argument("--model", required=True, help="ModelSpec name (e.g. clothing-model)")
    p.add_argument("--output", required=True, help="artifact root directory")
    p.add_argument("--weights", default=None,
                   help="Keras .h5 weights to import (read without h5py, by h5lite)")
    p.add_argument("--seed", type=int, default=None,
                   help="random-init seed (no .h5): the port's models.init_variables, which "
                   "cannot reproduce flax's PRNG, so the weights differ from the JAX "
                   "exporter's for the same seed (metadata init: port-seeded)")
    p.add_argument("--version", type=int, default=None, help="explicit version number")
    p.add_argument("--dtype", default="bfloat16", choices=list(DTYPES))
    p.add_argument("--params-dtype", default=None, choices=list(DTYPES),
                   help="storage dtype for variables (bfloat16 = half the artifact)")
    p.add_argument("--device", default="cuda",
                   help="torch device for --calibrate (cuda, cuda:1, cpu); the export itself "
                   "runs on the host")
    p.add_argument(
        "--calibrate", type=int, nargs="?", const=0, default=None,
        help="ALSO write a calibrated int8-w8a8 artifact as the NEXT version: run N "
        "representative uint8 images (default 32) through the float graph, record "
        "per-layer activation absmax under the percentile clip, and store the static "
        "scales next to the _q8 weight leaves.  Calibration happens HERE, at artifact "
        "build -- never at serving time; the engine gates activation with "
        "KDLT_QUANT_TOL at warmup",
    )
    p.add_argument("--calibrate-percentile", type=float, default=None,
                   help="percentile clip on |activation| for --calibrate (default 99.9; "
                   "100 = plain absmax)")
    p.add_argument("--calibrate-dir", default=None,
                   help="directory of representative images for --calibrate (default: "
                   "seeded noise; production should calibrate on real traffic samples)")
    p.add_argument("--calibrate-seed", type=int, default=0)
    args = p.parse_args(argv)

    spec = get_spec(args.model)
    if args.weights:
        from kubernetes_deep_learning_tpu_torch.models.keras_import import load_keras_h5

        variables = load_keras_h5(spec, args.weights)
        init = "keras-h5"
        print(f"imported Keras weights from {args.weights}")
    else:
        from kubernetes_deep_learning_tpu_torch.models import init_variables

        seed = 0 if args.seed is None else args.seed
        variables = init_variables(spec, seed=seed)
        init = "port-seeded"
        print(f"random-initialized weights (seed={seed}, port-seeded)")

    t0 = time.perf_counter()
    directory = export_model(spec, variables, args.output, version=args.version,
                             dtype=args.dtype, params_dtype=args.params_dtype, init=init)
    print(f"exported {spec.name} -> {directory} in {time.perf_counter() - t0:.3f} s")
    if args.calibrate is not None:
        # The w8a8 build step (ops.quantize): quantize the just-exported
        # float version and calibrate activation scales offline, landing
        # as the next version so the watcher hot-rolls it like any other.
        from kubernetes_deep_learning_tpu_torch.ops import quantize as quant_lib

        t0 = time.perf_counter()
        n = args.calibrate or quant_lib.DEFAULT_CALIB_IMAGES
        calib = quant_lib.representative_images(spec, n, seed=args.calibrate_seed,
                                                image_dir=args.calibrate_dir)
        percentile = (args.calibrate_percentile if args.calibrate_percentile is not None
                      else quant_lib.DEFAULT_CALIB_PERCENTILE)
        qdir = quant_lib.write_quantized_version(
            args.output, spec.name, scheme=quant_lib.SCHEME_W8A8, calib_images=calib,
            percentile=percentile, from_version=int(os.path.basename(directory)),
            device=args.device)
        print(f"calibrated int8-w8a8 ({n} images, p{percentile:g} clip) -> {qdir} in "
              f"{time.perf_counter() - t0:.3f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
