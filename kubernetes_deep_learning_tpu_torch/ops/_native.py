"""Build and load the port's native batch queue (``native/batchqueue.cc``).

The queue is plain C++ (no CUDA, no Python headers), bound with ``ctypes``.
It is built with ``g++`` (or ``$CXX``) at first use, from the package's own
source, into the CUDA library's build directory (``ops/build/`` or
``$KDLT_TORCH_BUILD_DIR``), named by a hash of the source, the compiler and
the flags, so an edited source never loads a stale library.  A failed
build raises: ``runtime.create_batcher("native")`` then fails, and
``"auto"`` logs it and takes the Python batcher, as the JAX package's
``create_batcher`` does when its native library will not load.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

from kubernetes_deep_learning_tpu_torch.ops import _build

SOURCE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "native", "batchqueue.cc"
)
CXX_ENV = "CXX"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared", "-Wall", "-Wextra", "-pthread")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def _library_path(cxx: str) -> str:
    h = hashlib.sha256()
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    h.update(" ".join((cxx, *CXX_FLAGS)).encode())
    return os.path.join(_build.build_dir(), f"kdlt_batchqueue-{h.hexdigest()[:16]}.so")


def _compile(cxx: str, target: str) -> None:
    os.makedirs(os.path.dirname(target), exist_ok=True)
    tmp = f"{target}.{os.getpid()}.{threading.get_ident()}.tmp"
    try:
        done = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, SOURCE], capture_output=True,
                              text=True, timeout=300)
    except OSError as e:  # no such compiler
        raise RuntimeError(f"cannot run {cxx!r} to build the batch queue: {e}") from e
    if done.returncode != 0:
        raise RuntimeError(f"{cxx} failed ({done.returncode}) building {SOURCE}:\n"
                           f"{done.stdout}{done.stderr}")
    os.replace(tmp, target)  # atomic: a concurrent loader sees all or nothing


def load() -> ctypes.CDLL:
    """The batch queue's shared library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            cxx = os.environ.get(CXX_ENV) or "g++"
            path = _library_path(cxx)
            if not os.path.exists(path):
                _compile(cxx, path)
            lib = ctypes.CDLL(path)  # every call releases the interpreter lock
            ptr, i32, i64, f64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_double
            u8p = ctypes.POINTER(ctypes.c_uint8)
            f32p = ctypes.POINTER(ctypes.c_float)
            i64p = ctypes.POINTER(ctypes.c_int64)
            for name, args, ret in (
                ("kdlt_bq_create", [i32, i64, i32], ptr),
                ("kdlt_bq_destroy", [ptr], None),
                ("kdlt_bq_submit", [ptr, u8p], i64),
                ("kdlt_bq_take", [ptr, ptr, i32, f64, f64, i64p], i32),
                ("kdlt_bq_complete", [ptr, i64p, i32, f32p, i32], None),
                ("kdlt_bq_fail", [ptr, i64p, i32], None),
                ("kdlt_bq_wait", [ptr, i64, f32p, f64], i32),
                ("kdlt_bq_close", [ptr], None),
                ("kdlt_bq_abort", [ptr], None),
                ("kdlt_bq_set_max_pending", [ptr, i32], None),
                ("kdlt_bq_pending", [ptr], i32),
            ):
                fn = getattr(lib, name)
                fn.argtypes = args
                fn.restype = ret
            _lib = lib
        return _lib
