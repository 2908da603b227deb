"""Build and load the port's native host libraries (``native/``).

Plain C++ libraries (no Python headers), bound with ``ctypes``, which
releases the interpreter lock for every call:

- the batch queue (``batchqueue.cc``), ``load()``;
- the host image ops (``hostops.cc``, the PIL-exact resize, and
  ``imagedec.cc``, the JPEG decoder and the PNG row filters),
  ``load_hostops()``, wrapped by ``resize_nearest``, ``resize_bilinear``,
  ``decode_jpeg`` and ``png_unfilter`` below;
- the device trace (``cupti_trace.cc``: CUPTI activity recording, the
  chrome trace and the kernel summary written in C++), ``DeviceTrace``;
  it builds anywhere and records only where CUDA and torch's libcupti are
  (the card).

Each is built with ``g++`` (or ``$CXX``) at first use, from the package's
own sources, into the CUDA library's build directory (``ops/build/`` or
``$KDLT_TORCH_BUILD_DIR``), named by a hash of the sources, the compiler and
the flags, so an edited source never loads a stale library.  A failed build
raises: ``runtime.create_batcher("native")`` then fails, and ``"auto"`` logs
it and takes the Python batcher, as the JAX package's ``create_batcher``
does when its native library will not load.  The image ops have no
fallback: an image is never handed to a different decoder.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

from kubernetes_deep_learning_tpu_torch.ops import _build

NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "native")
SOURCE = os.path.join(NATIVE_DIR, "batchqueue.cc")
HOSTOPS_SOURCES = tuple(os.path.join(NATIVE_DIR, s) for s in ("hostops.cc", "imagedec.cc"))
TRACE_SOURCES = (os.path.join(NATIVE_DIR, "cupti_trace.cc"),)
CXX_ENV = "CXX"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared", "-Wall", "-Wextra", "-pthread")

# One lock per library, so kdlt-torch-warm builds them side by side.
_lock = threading.Lock()
_hostops_lock = threading.Lock()
_trace_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
BUILT: list[str] = []  # the host libraries this process compiled (file names)
_hostops_lib: ctypes.CDLL | None = None
_trace_lib: ctypes.CDLL | None = None


def _library_path(cxx: str, stem: str = "kdlt_batchqueue",
                  sources: tuple[str, ...] = (SOURCE,), extra: tuple[str, ...] = ()) -> str:
    h = hashlib.sha256()
    for src in sources:
        with open(src, "rb") as f:
            h.update(f.read())
    h.update(" ".join((cxx, *CXX_FLAGS, *extra)).encode())
    return os.path.join(_build.build_dir(), f"{stem}-{h.hexdigest()[:16]}.so")


def _compile(cxx: str, target: str, sources: tuple[str, ...] = (SOURCE,),
             extra: tuple[str, ...] = ()) -> None:
    os.makedirs(os.path.dirname(target), exist_ok=True)
    tmp = f"{target}.{os.getpid()}.{threading.get_ident()}.tmp"
    try:
        done = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, *sources, *extra],
                              capture_output=True, text=True, timeout=300)
    except OSError as e:  # no such compiler
        raise RuntimeError(f"cannot run {cxx!r} to build {', '.join(sources)}: {e}") from e
    if done.returncode != 0:
        raise RuntimeError(f"{cxx} failed ({done.returncode}) building {', '.join(sources)}:\n"
                           f"{done.stdout}{done.stderr}")
    os.replace(tmp, target)  # atomic: a concurrent loader sees all or nothing
    BUILT.append(os.path.basename(target))


def built() -> list[str]:
    """Every native library this process compiled: the kernels' (nvcc) and
    the host ones (g++).  Empty after a boot against a warmed build
    directory."""
    return [*_build.BUILT, *BUILT]


def _bind(stem: str, sources: tuple[str, ...], symbols,
          extra: tuple[str, ...] = ()) -> ctypes.CDLL:
    cxx = os.environ.get(CXX_ENV) or "g++"
    path = _library_path(cxx, stem, sources, extra)
    if not os.path.exists(path):
        _compile(cxx, path, sources, extra)
    lib = ctypes.CDLL(path)
    for name, args, ret in symbols:
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = ret
    return lib


_ptr, _i32, _i64, _f64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_double
_u8p = ctypes.POINTER(ctypes.c_uint8)
_f32p = ctypes.POINTER(ctypes.c_float)
_i64p = ctypes.POINTER(ctypes.c_int64)
_i32p = ctypes.POINTER(ctypes.c_int)


def load() -> ctypes.CDLL:
    """The batch queue's shared library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = _bind("kdlt_batchqueue", (SOURCE,), (
                ("kdlt_bq_create", [_i32, _i64, _i32], _ptr),
                ("kdlt_bq_destroy", [_ptr], None),
                ("kdlt_bq_submit", [_ptr, _u8p], _i64),
                ("kdlt_bq_take", [_ptr, _ptr, _i32, _f64, _f64, _i64p], _i32),
                ("kdlt_bq_complete", [_ptr, _i64p, _i32, _f32p, _i32], None),
                ("kdlt_bq_fail", [_ptr, _i64p, _i32], None),
                ("kdlt_bq_wait", [_ptr, _i64, _f32p, _f64], _i32),
                ("kdlt_bq_close", [_ptr], None),
                ("kdlt_bq_abort", [_ptr], None),
                ("kdlt_bq_set_max_pending", [_ptr, _i32], None),
                ("kdlt_bq_pending", [_ptr], _i32),
            ))
        return _lib


def load_hostops() -> ctypes.CDLL:
    """The host image ops' shared library, built on first use."""
    global _hostops_lib
    with _hostops_lock:
        if _hostops_lib is None:
            _hostops_lib = _bind("kdlt_hostops", HOSTOPS_SOURCES, (
                ("kdlt_resize_bilinear", [_u8p, _i32, _i32, _i32, _u8p, _i32, _i32], _i32),
                ("kdlt_resize_nearest", [_u8p, _i32, _i32, _i32, _u8p, _i32, _i32], _i32),
                ("kdlt_jpeg_header", [ctypes.c_char_p, _i64, _i32p, _i32p, ctypes.c_char_p,
                                      _i32], _i32),
                ("kdlt_jpeg_decode", [ctypes.c_char_p, _i64, _u8p, _i32, _i32,
                                      ctypes.c_char_p, _i32], _i32),
                ("kdlt_png_unfilter", [ctypes.c_char_p, _i32, _i64, _i32, _u8p], _i32),
            ))
        return _hostops_lib


def _checked_hwc(img: np.ndarray) -> np.ndarray:
    img = np.ascontiguousarray(img)
    if img.dtype != np.uint8 or img.ndim != 3:
        raise ValueError(f"expected a uint8 HWC array, got {img.dtype} {img.shape}")
    return img


def _resize(name: str, img: np.ndarray, h: int, w: int) -> np.ndarray:
    img = _checked_hwc(img)
    out = np.empty((h, w, img.shape[2]), np.uint8)
    rc = getattr(load_hostops(), name)(img.ctypes.data_as(_u8p), img.shape[0], img.shape[1],
                                       img.shape[2], out.ctypes.data_as(_u8p), h, w)
    if rc != 0:
        raise ValueError(f"{name} failed (rc={rc}) for {img.shape} -> ({h}, {w})")
    return out


def resize_bilinear(img: np.ndarray, h: int, w: int) -> np.ndarray:
    """PIL-exact bilinear resize of a uint8 HWC image (``hostops.cc``)."""
    return _resize("kdlt_resize_bilinear", img, h, w)


def resize_nearest(img: np.ndarray, h: int, w: int) -> np.ndarray:
    """PIL-exact nearest resize of a uint8 HWC image (``hostops.cc``)."""
    return _resize("kdlt_resize_nearest", img, h, w)


_ERR_LEN = 256


def decode_jpeg(data: bytes) -> np.ndarray:
    """JPEG bytes (baseline, extended or progressive; 1, 3 or 4
    components; any integral sampling) -> RGB uint8 (H, W, 3), byte-equal
    to PIL's ``convert("RGB")`` (``imagedec.cc``).  Raises ValueError
    naming what is unsupported (arithmetic, lossless, hierarchical, 12-bit,
    a progressive file libjpeg-turbo would block-smooth) or corrupt.  Both
    native calls release the interpreter lock."""
    lib = load_hostops()
    err = ctypes.create_string_buffer(_ERR_LEN)
    h, w = ctypes.c_int(0), ctypes.c_int(0)
    if lib.kdlt_jpeg_header(data, len(data), ctypes.byref(h), ctypes.byref(w), err, _ERR_LEN):
        raise ValueError(err.value.decode(errors="replace"))
    out = np.empty((h.value, w.value, 3), np.uint8)
    if lib.kdlt_jpeg_decode(data, len(data), out.ctypes.data_as(_u8p), h.value, w.value, err,
                            _ERR_LEN):
        raise ValueError(err.value.decode(errors="replace"))
    return out


def png_unfilter(raw: bytes, height: int, rowbytes: int, bpp: int) -> np.ndarray:
    """Inflated PNG scanlines (a filter byte, then ``rowbytes``, per row) ->
    the unfiltered (height, rowbytes) bytes."""
    if len(raw) < height * (rowbytes + 1):
        raise ValueError("truncated PNG: image data is shorter than its header says")
    out = np.empty((height, rowbytes), np.uint8)
    row = load_hostops().kdlt_png_unfilter(raw, height, rowbytes, max(1, bpp),
                                           out.ctypes.data_as(_u8p))
    if row:
        raise ValueError(f"corrupt PNG: row {row - 1} has an unknown filter type")
    return out


def load_trace() -> ctypes.CDLL:
    """The device trace's shared library (``cupti_trace.cc``), built on
    first use."""
    global _trace_lib
    with _trace_lock:
        if _trace_lib is None:
            cp, i32 = ctypes.c_char_p, _i32
            _trace_lib = _bind("kdlt_trace", TRACE_SOURCES, (
                ("kdlt_trace_start", [cp, i32], i32),
                ("kdlt_trace_stop", [cp, i32], i32),
                ("kdlt_trace_write", [cp, i32, cp, i32, cp, i32], i32),
            ), ("-ldl",))
        return _trace_lib


class DeviceTrace:
    """One recording of the card's kernels, copies and sets (CUPTI
    activity).  ``stop`` ends it and flushes CUPTI's buffers into it;
    ``write`` then writes the chrome trace to ``path`` and returns the
    ``top`` device operations by total time, ``{name: {"count",
    "total_us"}}``.  All three run in C++ with the interpreter lock
    released."""

    _SUMMARY_BYTES = 1 << 20

    def __init__(self):
        self._lib = load_trace()

    def _call(self, fn, *args) -> None:
        err = ctypes.create_string_buffer(_ERR_LEN)
        if fn(*args, err, _ERR_LEN):
            raise RuntimeError(err.value.decode(errors="replace"))

    def start(self) -> None:
        self._call(self._lib.kdlt_trace_start)

    def stop(self) -> None:
        self._call(self._lib.kdlt_trace_stop)

    def write(self, path: str, top: int) -> dict:
        import json

        summary = ctypes.create_string_buffer(self._SUMMARY_BYTES)
        self._call(self._lib.kdlt_trace_write, os.fsencode(path), top, summary,
                   self._SUMMARY_BYTES)
        return json.loads(summary.value.decode())
