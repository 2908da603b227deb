"""A small msgpack codec on the standard library and numpy.

The port reads and writes two msgpack formats without the ``msgpack``
package (which the GPU machines do not carry):

- flax's ``params.msgpack`` (``flax.serialization.msgpack_serialize``):
  ndarrays as ext type 1 holding msgpack ``(shape, dtype name, bytes)``,
  numpy scalars as ext type 3 in the same form;
- the serving wire (``serving.protocol``): maps, strings, lists and raw
  ``bin`` tensor payloads.

Only what those formats use is implemented: nil, bool, int, float, str,
bin, array, map and ext.  bfloat16 arrays (which numpy cannot hold) are
widened to float32 on decode, exactly, and written from a
:class:`Bfloat16` (a float32 array rounded to nearest even, as
``astype(jnp.bfloat16)`` rounds it).
"""

from __future__ import annotations

import struct
from typing import Any

import numpy as np

EXT_NDARRAY = 1
EXT_NPSCALAR = 3


# --- encoder ------------------------------------------------------------------


class Bfloat16:
    """A float32 array to be written as a bfloat16 ndarray: the top half of
    each value rounded to nearest even (NaN stays a quiet NaN)."""

    def __init__(self, arr: np.ndarray):
        arr = np.asarray(arr, np.float32)
        u = arr.view(np.uint32).astype(np.uint64)
        bits = ((u + 0x7FFF + ((u >> 16) & 1)) >> 16).astype(np.uint16)
        nan = np.isnan(arr)
        bits[nan] = ((u[nan] >> 16) | 0x40).astype(np.uint16)
        self.shape = arr.shape
        self.bits = bits


def packb(obj: Any) -> bytes:
    out = bytearray()
    _pack(obj, out)
    return bytes(out)


def _pack_len(n: int, out: bytearray, fix_base: int | None, fix_max: int, codes) -> None:
    if fix_base is not None and n <= fix_max:
        out.append(fix_base | n)
    elif codes[0] is not None and n < 1 << 8:
        out += struct.pack(">BB", codes[0], n)
    elif n < 1 << 16:
        out += struct.pack(">BH", codes[1], n)
    elif n < 1 << 32:
        out += struct.pack(">BI", codes[2], n)
    else:
        raise ValueError(f"msgpack object too large ({n})")


def _pack_int(v: int, out: bytearray) -> None:
    if 0 <= v < 0x80:
        out.append(v)
    elif -32 <= v < 0:
        out.append(v & 0xFF)
    elif 0 <= v < 1 << 64:
        out += b"\xcf" + struct.pack(">Q", v)
    elif -(1 << 63) <= v < 0:
        out += b"\xd3" + struct.pack(">q", v)
    else:
        raise ValueError(f"integer out of msgpack range: {v}")


def _pack_ext(code: int, data: bytes, out: bytearray) -> None:
    _pack_len(len(data), out, None, 0, (0xC7, 0xC8, 0xC9))
    out += struct.pack(">b", code)
    out += data


def _ndarray_payload(arr: np.ndarray) -> bytes:
    # tobytes() is C-ordered whatever the layout; the shape is the array's
    # own (np.ascontiguousarray would turn a 0-d array into shape (1,)).
    return packb((list(arr.shape), arr.dtype.name, arr.tobytes()))


def _pack(o: Any, out: bytearray) -> None:
    if o is None:
        out.append(0xC0)
    elif o is True:
        out.append(0xC3)
    elif o is False:
        out.append(0xC2)
    elif isinstance(o, int):
        _pack_int(o, out)
    elif isinstance(o, float):
        out += b"\xcb" + struct.pack(">d", o)
    elif isinstance(o, str):
        b = o.encode()
        _pack_len(len(b), out, 0xA0, 31, (0xD9, 0xDA, 0xDB))
        out += b
    elif isinstance(o, (bytes, bytearray, memoryview)):
        b = bytes(o)
        _pack_len(len(b), out, None, 0, (0xC4, 0xC5, 0xC6))
        out += b
    elif isinstance(o, np.ndarray):
        _pack_ext(EXT_NDARRAY, _ndarray_payload(o), out)
    elif isinstance(o, Bfloat16):
        _pack_ext(EXT_NDARRAY, packb((list(o.shape), "bfloat16", o.bits.tobytes())), out)
    elif isinstance(o, np.generic):
        _pack_ext(EXT_NPSCALAR, _ndarray_payload(np.asarray(o)), out)
    elif isinstance(o, (list, tuple)):
        _pack_len(len(o), out, 0x90, 15, (None, 0xDC, 0xDD))
        for v in o:
            _pack(v, out)
    elif isinstance(o, dict):
        _pack_len(len(o), out, 0x80, 15, (None, 0xDE, 0xDF))
        for k, v in o.items():
            _pack(k, out)
            _pack(v, out)
    else:
        raise TypeError(f"cannot msgpack-encode {type(o).__name__}")


# --- decoder ------------------------------------------------------------------


def _ndarray_from_payload(data: bytes) -> np.ndarray:
    shape, dtype_name, buf = unpackb(data)
    if isinstance(dtype_name, bytes):
        dtype_name = dtype_name.decode()
    if dtype_name == "bfloat16":
        # bf16 is the top half of an f32: widen bit-exactly.
        bits = np.frombuffer(buf, np.uint16).astype(np.uint32) << 16
        return bits.view(np.float32).reshape(shape)
    return np.frombuffer(buf, np.dtype(dtype_name)).reshape(shape)


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        chunk = self.data[self.pos : self.pos + n]
        self.pos += n
        return chunk

    def unpack(self, fmt: str) -> Any:
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def obj(self) -> Any:
        t = self.take(1)[0]
        if t <= 0x7F:
            return t
        if t >= 0xE0:
            return t - 0x100
        if 0x80 <= t <= 0x8F:
            return self.map(t & 0x0F)
        if 0x90 <= t <= 0x9F:
            return [self.obj() for _ in range(t & 0x0F)]
        if 0xA0 <= t <= 0xBF:
            return str(self.take(t & 0x1F), "utf-8")
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if t in simple:
            return simple[t]
        if t in (0xC4, 0xC5, 0xC6):
            n = self.unpack({0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}[t])
            return bytes(self.take(n))
        if t in (0xC7, 0xC8, 0xC9):
            n = self.unpack({0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}[t])
            return self.ext(n)
        if t in (0xD4, 0xD5, 0xD6, 0xD7, 0xD8):
            return self.ext(1 << (t - 0xD4))
        ints = {
            0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
            0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q",
        }
        if t in ints:
            return self.unpack(ints[t])
        if t in (0xD9, 0xDA, 0xDB):
            n = self.unpack({0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}[t])
            return str(self.take(n), "utf-8")
        if t in (0xDC, 0xDD):
            n = self.unpack(">H" if t == 0xDC else ">I")
            return [self.obj() for _ in range(n)]
        if t in (0xDE, 0xDF):
            return self.map(self.unpack(">H" if t == 0xDE else ">I"))
        raise ValueError(f"unsupported msgpack type byte 0x{t:02x}")

    def map(self, n: int) -> dict:
        d = {}
        for _ in range(n):
            k = self.obj()
            d[k] = self.obj()
        return d

    def ext(self, n: int) -> Any:
        code = self.unpack(">b")
        data = bytes(self.take(n))
        if code == EXT_NDARRAY:
            return _ndarray_from_payload(data)
        if code == EXT_NPSCALAR:
            return _ndarray_from_payload(data)[()]
        raise ValueError(f"unsupported msgpack ext type {code}")


def unpackb(data: bytes) -> Any:
    r = _Reader(data)
    obj = r.obj()
    if r.pos != len(r.data):
        raise ValueError("trailing bytes after msgpack object")
    return obj
