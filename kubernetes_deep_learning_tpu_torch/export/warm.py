"""kdlt-torch-warm: build the port's native libraries into a build directory
and warm every registry model once (a scale-up that compiles nothing).

On the card, what persists across processes is the native libraries: the
kernels' library ``ops._build`` compiles with nvcc from ``ops/csrc/*.cu``
and the host libraries ``ops._native`` compiles with g++ (the batch queue,
the image ops, the device trace), each in the build directory
(``$KDLT_TORCH_BUILD_DIR``, default ``ops/build/``) under a name hashed
from its sources.  CUDA graphs do not persist: every engine captures its
own at warmup.  So this pass, the counterpart of the JAX ``kdlt-warm``'s
compile-cache fill, fills a build directory for other processes, from
either of two call sites:

- **image build**: ``RUN kdlt-torch-warm --models /models --build-dir
  /var/cache/kdlt-torch`` bakes the libraries into the image layer;
- **pod init**: ``kdlt-torch-model-server --aot-warm`` runs the same pass
  against a persistent volume and exits.

(The JAX server's ``KDLT_AOT_WARM=1``, warm in-process and then serve, has
no counterpart: the graphs would be captured twice, and a server builds any
missing library on first load anyway.)

It builds the libraries into the directory it is given, then loads the
latest version of every model under the root (``serving.registry``'s scan
rule: exactly what a booted server would load) and warms it (every bucket's
graph captured once), reporting each model's seconds, or ``{"error": ...}``
for a model that fails while the rest are warmed all the same.  The model
pass only validates: the graphs it captures persist nothing.  A server
booted with ``KDLT_TORCH_BUILD_DIR`` on the warmed directory runs no nvcc
and no g++: its boot line and ``kdlt_native_builds`` on /metrics say 0.
With the generative lane on (``--decode`` or ``KDLT_DECODE=1``, the switch
the servers read) the pass also runs the lane's decode ladder once
(``warm_decode``: every prefill bucket's graph and the step's captured,
then freed) and reports its grid; a failed ladder is an error entry, the
image models are warmed all the same.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

# The libraries a server may load, by the loader that builds each.
CUDA_LIBRARIES = ("kernels",)
HOST_LIBRARIES = ("batchqueue", "hostops", "trace")


def _loaders() -> dict:
    from kubernetes_deep_learning_tpu_torch.ops import _build, _native

    return {"kernels": _build.load, "batchqueue": _native.load,
            "hostops": _native.load_hostops, "trace": _native.load_trace}


def build_libraries(names) -> dict:
    """Build (or find built) each named library in the build directory, all
    at once (one compiler process each); ``{name: {"seconds", "built"}}``
    or ``{name: {"error"}}``."""
    from concurrent.futures import ThreadPoolExecutor

    from kubernetes_deep_learning_tpu_torch.ops import _native

    loaders = _loaders()

    def one(name: str) -> dict:
        t0 = time.perf_counter()
        try:
            lib = loaders[name]()
        except Exception as e:  # noqa: BLE001 - report it, warm the models all the same
            print(f"kdlt-torch-warm: library {name} FAILED: {e}", file=sys.stderr)
            return {"error": str(e)}
        return {"seconds": round(time.perf_counter() - t0, 3),
                "built": os.path.basename(lib._name) in _native.built()}

    names = list(names)
    with ThreadPoolExecutor(max(1, len(names))) as pool:
        return dict(zip(names, pool.map(one, names)))


def warm_decode(engine_factory=None, device: str = "cuda") -> dict:
    """Run the generative lane's decode ladder once; returns its report.

    The ladder is one prefill graph per prompt-length bucket plus the one
    fixed-width step graph that serves every batch-slot composition: the
    grid is buckets x slots wide but only buckets + 1 programs deep.  The
    engine's device memory is given back afterwards.
    ``engine_factory(model=, device=)`` swaps the engine class (tests)."""
    from kubernetes_deep_learning_tpu_torch.serving.generate import decode_model

    if engine_factory is None:
        from kubernetes_deep_learning_tpu_torch.runtime.decode import DecodeEngine

        engine_factory = DecodeEngine
    engine = engine_factory(model=decode_model(), device=device)
    try:
        entry = dict(engine.warmup())
    finally:
        if hasattr(engine, "close"):
            engine.close()
    entry["grid"] = {"prompt_buckets": [int(b) for b in entry.get("buckets", {})],
                     "slots": int(getattr(engine, "max_slots", 0))}
    return entry


def warm_models(model_root: str, buckets=None, build_dir: str | None = None,
                device: str = "cuda", engine_factory=None, libraries=None,
                decode: bool | None = None, decode_engine_factory=None) -> dict:
    """Build the libraries (into ``build_dir``, default the build directory
    of ``$KDLT_TORCH_BUILD_DIR``), then warm every model under
    ``model_root``, and the decode ladder when ``decode`` (None =
    ``$KDLT_DECODE``); returns the report dict.  ``libraries`` (default:
    the kernels' library on a CUDA device, and the host libraries) names
    what to build; ``engine_factory(directory, buckets, device)`` and
    ``decode_engine_factory`` swap the engine classes (tests)."""
    from kubernetes_deep_learning_tpu_torch.ops import _build

    args = (model_root, buckets, device, engine_factory, libraries, decode,
            decode_engine_factory)
    if not build_dir:
        return _warm(*args)
    saved = os.environ.get(_build.BUILD_DIR_ENV)
    os.environ[_build.BUILD_DIR_ENV] = build_dir
    try:
        return _warm(*args)
    finally:
        if saved is None:
            os.environ.pop(_build.BUILD_DIR_ENV, None)
        else:
            os.environ[_build.BUILD_DIR_ENV] = saved


def _warm(model_root: str, buckets, device: str, engine_factory, libraries, decode,
          decode_engine_factory) -> dict:
    from kubernetes_deep_learning_tpu_torch.ops import _build, _native
    from kubernetes_deep_learning_tpu_torch.runtime.engine import DEFAULT_BUCKETS
    from kubernetes_deep_learning_tpu_torch.serving.registry import iter_latest_versions

    if libraries is None:
        libraries = (CUDA_LIBRARIES if str(device).startswith("cuda") else ()) + HOST_LIBRARIES
    buckets = tuple(buckets or DEFAULT_BUCKETS)
    report: dict = {"build_dir": _build.build_dir(), "buckets": list(buckets),
                    "libraries": build_libraries(libraries), "models": {}}
    report["failed_libraries"] = sorted(n for n, r in report["libraries"].items()
                                        if "error" in r)
    factory = engine_factory or _default_factory
    for name, version, directory in iter_latest_versions(model_root):
        t0 = time.perf_counter()
        engine = None
        try:
            engine = factory(directory, buckets, device)
            engine.warmup()
        except Exception as e:  # noqa: BLE001 - warm the REST of the fleet
            report["models"][name] = {"version": version, "error": str(e)}
            print(f"kdlt-torch-warm: {name} v{version} FAILED: {e}", file=sys.stderr)
            continue
        finally:  # give the device memory back before the next model
            if hasattr(engine, "close"):
                engine.close()
        entry = {"version": version, "seconds": round(time.perf_counter() - t0, 3),
                 "buckets": list(buckets)}
        report["models"][name] = entry
        print(f"kdlt-torch-warm: {name} v{version}: {entry['seconds']}s "
              f"({len(buckets)} bucket graphs captured)", file=sys.stderr)
    from kubernetes_deep_learning_tpu_torch.serving.generate import decode_enabled

    if decode_enabled(decode):
        t0 = time.perf_counter()
        try:
            report["decode"] = warm_decode(decode_engine_factory, device)
        except Exception as e:  # noqa: BLE001 - the image models are warmed all the same
            report["decode"] = {"error": str(e)}
            print(f"kdlt-torch-warm: decode ladder FAILED: {e}", file=sys.stderr)
        else:
            grid = report["decode"]["grid"]
            print(f"kdlt-torch-warm: decode {report['decode'].get('model')}: "
                  f"{round(time.perf_counter() - t0, 3)}s (prefill buckets "
                  f"{grid['prompt_buckets']} x {grid['slots']} slots + step)", file=sys.stderr)
    report["built"] = _native.built()
    return report


def _default_factory(directory: str, buckets, device: str):
    from kubernetes_deep_learning_tpu_torch.export.artifact import load_artifact
    from kubernetes_deep_learning_tpu_torch.runtime.engine import InferenceEngine

    return InferenceEngine(load_artifact(directory), buckets=buckets, device=device)


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(
        description="build the port's native libraries into a build directory and warm "
        "every registry model once (run at image build or pod init)")
    p.add_argument("--models", default=os.environ.get("KDLT_MODEL_ROOT", "/models"),
                   help="artifact root (the model server's --model-root; default "
                   "$KDLT_MODEL_ROOT or /models)")
    p.add_argument("--build-dir", default=None,
                   help="where the libraries go (default $KDLT_TORCH_BUILD_DIR or the "
                   "package's ops/build/); boot servers with KDLT_TORCH_BUILD_DIR on it")
    p.add_argument("--buckets", default=None,
                   help="comma-separated bucket ladder to warm (default: the serving "
                   "DEFAULT_BUCKETS)")
    p.add_argument("--device", default="cuda", help="torch device (cuda, cuda:1, cpu)")
    p.add_argument("--decode", action="store_true", default=None,
                   help="also warm the generative lane's decode ladder (every prompt-length "
                   "bucket's prefill and the step; default $KDLT_DECODE=1)")
    p.add_argument("--json", action="store_true",
                   help="print the full warm report as JSON on stdout")
    args = p.parse_args(argv)
    buckets = None
    if args.buckets:
        buckets = tuple(sorted({int(b) for b in args.buckets.split(",") if b.strip()}))
    report = warm_models(args.models, buckets=buckets, build_dir=args.build_dir,
                         device=args.device, decode=args.decode)
    if args.json:
        print(json.dumps(report, indent=2))
    failed = [n for n, m in report["models"].items() if "error" in m]
    if "error" in report.get("decode", {}):
        failed.append("decode")
    if not report["models"]:
        print(f"kdlt-torch-warm: no models under {args.models}", file=sys.stderr)
        return 1
    return 1 if failed or report["failed_libraries"] else 0


if __name__ == "__main__":
    sys.exit(main())
