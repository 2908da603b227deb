"""Build and load the port's CUDA kernels (``csrc/*.cu``) with ``nvcc``.

The kernels have a plain C interface and are bound with ``ctypes``: no
PyTorch headers, so a build takes seconds.  Every ``csrc/*.cu`` is compiled
to an object by its own ``nvcc``, all started together, and the objects are
linked into one shared library.  It is built at first use from the
package's own sources into a build directory (default ``ops/build/`` beside
this file, listed in ``.gitignore``; override with
``$KDLT_TORCH_BUILD_DIR``), named by a hash of every source, every header
(``csrc/*.cuh``) and the flags, so an edited source or header never loads
a stale library.  A failed build raises:
there is no fallback to another implementation.  ``BUILT`` lists the
kernels' library if this process compiled it: empty in a process that
found it built (``export.warm``).
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading

CSRC_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR_ENV = "KDLT_TORCH_BUILD_DIR"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
build_log: str = ""  # nvcc's output of the last build (ptxas registers/spills)
BUILT: list[str] = []  # the kernels' library, if this process compiled it


def sources() -> list[str]:
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))


def headers() -> list[str]:
    """``csrc/*.cuh``: included by the sources, so part of the library's key."""
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cuh")))


def build_dir() -> str:
    return os.environ.get(BUILD_DIR_ENV) or os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "build"
    )


def _nvcc() -> str:
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels cannot be built")
    return found


def _library_path() -> str:
    h = hashlib.sha256()
    for src in sources() + headers():
        h.update(os.path.basename(src).encode())
        with open(src, "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(build_dir(), f"kdlt_kernels-{h.hexdigest()[:16]}.so")


def _run(procs: list[tuple[list[str], subprocess.Popen]]) -> str:
    """Wait for every process; raise on the first that failed, after
    stopping the others."""
    logs = []
    try:
        for cmd, proc in procs:
            out, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{out}")
            logs.append(out)
    finally:
        for _, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return "".join(logs)


def _start(cmd: list[str]) -> tuple[list[str], subprocess.Popen]:
    return cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def _compile(target: str) -> str:
    os.makedirs(os.path.dirname(target), exist_ok=True)
    tmp = f"{target}.{os.getpid()}.tmp"
    nvcc = _nvcc()
    objects = [f"{tmp}.{os.path.basename(src)}.o" for src in sources()]
    try:
        log = _run([_start([nvcc, *NVCC_FLAGS, "-c", "-o", obj, src])
                    for src, obj in zip(sources(), objects)])
        log += _run([_start([nvcc, "-shared", "-o", tmp, *objects])])
    finally:
        for obj in objects:
            if os.path.exists(obj):
                os.remove(obj)
    os.replace(tmp, target)  # atomic: a concurrent loader sees all or nothing
    BUILT.append(os.path.basename(target))
    return log


def load() -> ctypes.CDLL:
    """The kernels' shared library, built on first use."""
    global _lib, build_log
    with _lock:
        if _lib is None:
            path = _library_path()
            if not os.path.exists(path):
                build_log = _compile(path)
            lib = ctypes.CDLL(path)
            ptr = ctypes.c_void_p
            i32 = ctypes.c_int
            i64 = ctypes.c_longlong
            lib.kdlt_sepconv_stage.argtypes = [ptr] * 7 + [i32] * 7 + [ptr]
            lib.kdlt_sepconv_stage.restype = i32
            lib.kdlt_mbconv_block.argtypes = [ptr] * 18 + [i32] * 11 + [ptr]
            lib.kdlt_mbconv_block.restype = i32
            lib.kdlt_flash_attention.argtypes = (
                [ptr] * 4 + [i32] * 5 + [i64] * 9 + [i32] * 4 + [ctypes.c_float, ptr]
            )
            lib.kdlt_flash_attention.restype = i32
            lib.kdlt_flash_attention_partials.argtypes = (
                [ptr] * 6 + [i32] * 5 + [i64] * 9 + [i32] * 4 + [ctypes.c_float, ptr]
            )
            lib.kdlt_flash_attention_partials.restype = i32
            lib.kdlt_flash_attention_gfold.argtypes = (
                [ptr] * 4 + [i32] * 5 + [i64] * 9 + [i32] * 2 + [ctypes.c_float, ptr]
            )
            lib.kdlt_flash_attention_gfold.restype = i32
            lib.kdlt_flash_attention_q_tile.argtypes = [i32] * 5
            lib.kdlt_flash_attention_q_tile.restype = i32
            lib.kdlt_flash_map_encode_us.argtypes = [ptr] + [i32] * 5
            lib.kdlt_flash_map_encode_us.restype = ctypes.c_double
            lib.kdlt_entry_block.argtypes = [ptr] * 16 + [i32] * 7 + [ptr]
            lib.kdlt_entry_block.restype = i32
            lib.kdlt_entry_block_rows.argtypes = [i32] * 3
            lib.kdlt_entry_block_rows.restype = i32
            f32 = ctypes.c_float
            lib.kdlt_int8_codes.argtypes = [ptr, ptr, f32] + [i32] * 10 + [ptr]
            lib.kdlt_int8_codes.restype = i32
            lib.kdlt_int8_conv.argtypes = [ptr] * 5 + [i32] * 15 + [ptr]
            lib.kdlt_int8_conv.restype = i32
            lib.kdlt_int8_depthwise.argtypes = [ptr] * 5 + [f32] + [i32] * 10 + [ptr]
            lib.kdlt_int8_depthwise.restype = i32
            lib.kdlt_error_string.argtypes = [i32]
            lib.kdlt_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    if code != 0:
        msg = lib.kdlt_error_string(code).decode(errors="replace")
        raise RuntimeError(f"{what} launch failed: CUDA error {code} ({msg})")
