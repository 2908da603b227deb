"""A reader of the HDF5 subset Keras writes, on the standard library and numpy.

The port reads Keras ``.h5`` weight files without ``h5py`` (which the GPU
machines do not carry).  :func:`read_keras_h5` walks the file as the JAX
package's ``models/keras_import.py::read_keras_h5`` walks it through
``h5py``: every dataset, depth first in name order, under
``model_weights`` when the file has it; the weight is the dataset's name
without its ``:0`` suffix, the layer its parent group's name.

What it reads (HDF5 file format specification, version 3.0):

- superblocks 0 and 1 (``h5py.File(path, "w")``, Keras 2), with 4- or
  8-byte offsets and lengths, behind a user block or not; superblocks 2
  and 3 (``libver="latest"``) whose groups keep their links compact;
- version-1 object headers with their continuation blocks; version-2
  (``OHDR``/``OCHK``) object headers in superblock 2 and 3 files;
- symbol-table groups: a version-1 B-tree of group nodes of any depth,
  symbol-table nodes (``SNOD``) and the local heap; link messages of
  compact (version-2) groups;
- datatype and dataspace messages: IEEE floats of 2, 4 and 8 bytes and
  integers of 1, 2, 4 and 8 bytes in either byte order; scalar (0-d) and
  simple dataspaces, empty ones included;
- contiguous and compact data layouts.

Attribute messages are skipped (Keras's ``model_config`` attribute may be
large and sit in a continuation block).  Everything else raises a
``ValueError`` that names the feature: dense link storage (a fractal
heap), chunked or filtered layouts, external storage, a version-2 object
header in a superblock-0 or -1 file, variable-length and other
datatypes, soft and external links, and a truncated file.  Nothing is
skipped silently.
"""

from __future__ import annotations

import numpy as np

SIGNATURE = b"\x89HDF\r\n\x1a\n"

# Object header message types (specification section IV.A.2).
MSG_NIL = 0x0000
MSG_DATASPACE = 0x0001
MSG_LINK_INFO = 0x0002
MSG_DATATYPE = 0x0003
MSG_FILL_OLD = 0x0004
MSG_FILL = 0x0005
MSG_LINK = 0x0006
MSG_EXTERNAL = 0x0007
MSG_LAYOUT = 0x0008
MSG_BOGUS = 0x0009
MSG_GROUP_INFO = 0x000A
MSG_FILTERS = 0x000B
MSG_ATTRIBUTE = 0x000C
MSG_COMMENT = 0x000D
MSG_MTIME_OLD = 0x000E
MSG_SHARED_TABLE = 0x000F
MSG_CONTINUATION = 0x0010
MSG_SYMBOL_TABLE = 0x0011
MSG_MTIME = 0x0012
MSG_BTREE_K = 0x0013
MSG_DRIVER_INFO = 0x0014
MSG_ATTRIBUTE_INFO = 0x0015
MSG_REFCOUNT = 0x0016
MSG_FILE_SPACE_INFO = 0x0017

# Messages that carry nothing the walk needs.
_IGNORED = frozenset((MSG_NIL, MSG_FILL_OLD, MSG_FILL, MSG_BOGUS, MSG_GROUP_INFO, MSG_ATTRIBUTE,
                      MSG_COMMENT, MSG_MTIME_OLD, MSG_SHARED_TABLE, MSG_MTIME, MSG_BTREE_K,
                      MSG_DRIVER_INFO, MSG_ATTRIBUTE_INFO, MSG_REFCOUNT, MSG_FILE_SPACE_INFO))

_DATATYPE_CLASSES = {2: "time", 3: "fixed-length string", 4: "bitfield", 5: "opaque",
                     6: "compound", 7: "reference", 8: "enumerated", 9: "variable-length",
                     10: "array"}
# IEEE binary16/32/64: (exponent location, exponent size, mantissa location,
# mantissa size, exponent bias) by size in bytes.
_IEEE = {2: (10, 5, 0, 10, 15), 4: (23, 8, 0, 23, 127), 8: (52, 11, 0, 52, 1023)}


class _Object:
    """One object's header messages: ``[(type, flags, body)]``."""

    def __init__(self, messages: list[tuple[int, int, bytes]]):
        self.messages = messages

    def find(self, kind: int) -> bytes | None:
        for t, _, body in self.messages:
            if t == kind:
                return body
        return None

    def has(self, kind: int) -> bool:
        return any(t == kind for t, _, _ in self.messages)


class H5File:
    """An HDF5 file's bytes, parsed on demand (the whole file is read)."""

    def __init__(self, path: str):
        with open(path, "rb") as f:
            self.data = f.read()
        self.path = path
        self._superblock()

    # --- primitives ---------------------------------------------------------

    def _bytes(self, pos: int, n: int) -> bytes:
        if pos < 0 or n < 0 or pos + n > len(self.data):
            raise ValueError(f"{self.path}: truncated file (needs bytes {pos}..{pos + n}, "
                             f"has {len(self.data)})")
        return self.data[pos:pos + n]

    @staticmethod
    def _uint(buf: bytes, pos: int, n: int) -> int:
        if pos + n > len(buf):
            raise ValueError("truncated file: a structure ends early")
        return int.from_bytes(buf[pos:pos + n], "little")

    def _undefined(self, address: int) -> bool:
        return address == (1 << (8 * self.offset_size)) - 1

    def _addr(self, value: int) -> int:
        """A file address (relative to the base address) as a position."""
        return self.base + value

    # --- superblock ---------------------------------------------------------

    def _superblock(self) -> None:
        pos = 0
        while True:  # the superblock sits at 0, 512, 1024, 2048, ...
            if pos + 8 > len(self.data):
                raise ValueError(f"{self.path}: not an HDF5 file (no superblock signature)")
            if self.data[pos:pos + 8] == SIGNATURE:
                break
            pos = 512 if pos == 0 else pos * 2
        head = self._bytes(pos, 16)
        self.version = head[8]
        if self.version in (0, 1):
            self.offset_size, self.length_size = head[13], head[14]
            o = self.offset_size
            q = pos + 24 + (4 if self.version == 1 else 0)
            fields = self._bytes(q, 4 * o)
            base, _, eof, _ = (self._uint(fields, i * o, o) for i in range(4))
            entry = self._bytes(q + 4 * o, self.length_size + o + 24)
            root = self._uint(entry, self.length_size, o)
        elif self.version in (2, 3):
            self.offset_size, self.length_size = head[9], head[10]
            o = self.offset_size
            fields = self._bytes(pos + 12, 4 * o)
            base, _, eof, root = (self._uint(fields, i * o, o) for i in range(4))
        else:
            raise ValueError(f"{self.path}: superblock version {self.version} is not supported")
        if self.offset_size not in (2, 4, 8) or self.length_size not in (2, 4, 8):
            raise ValueError(f"{self.path}: offsets of {self.offset_size} and lengths of "
                             f"{self.length_size} bytes are not supported")
        self.base = base
        if eof > len(self.data):  # the end-of-file address counts the user block
            raise ValueError(f"{self.path}: truncated file ({len(self.data)} bytes, the "
                             f"superblock says {eof})")
        self.root = root

    # --- object headers -----------------------------------------------------

    def object(self, address: int) -> _Object:
        pos = self._addr(address)
        if self._bytes(pos, 4) == b"OHDR":
            if self.version < 2:
                raise ValueError(f"{self.path}: a version-2 object header (OHDR) in a "
                                 f"superblock-{self.version} file is not supported")
            return _Object(self._messages_v2(pos))
        return _Object(self._messages_v1(pos))

    def _messages_v1(self, pos: int) -> list:
        head = self._bytes(pos, 16)
        if head[0] != 1:
            raise ValueError(f"{self.path}: object header version {head[0]} at {pos} is not "
                             "supported")
        count = self._uint(head, 2, 2)
        blocks = [(pos + 16, self._uint(head, 8, 4))]
        out: list = []
        while blocks and len(out) < count:
            start, size = blocks.pop(0)
            block = self._bytes(start, size)
            p = 0
            while p + 8 <= size and len(out) < count:
                kind, n, flags = (self._uint(block, p, 2), self._uint(block, p + 2, 2),
                                  block[p + 4])
                body = block[p + 8:p + 8 + n]
                if len(body) < n:
                    raise ValueError(f"{self.path}: truncated file: an object header message "
                                     "runs past its block")
                p += 8 + n
                out.append(self._message(kind, flags, body, blocks))
        return out

    def _messages_v2(self, pos: int) -> list:
        head = self._bytes(pos, 6)
        if head[4] != 2:
            raise ValueError(f"{self.path}: OHDR version {head[4]} is not supported")
        flags = head[5]
        p = pos + 6 + (16 if flags & 0x20 else 0) + (4 if flags & 0x10 else 0)
        width = 1 << (flags & 3)
        size = self._uint(self._bytes(p, width), 0, width)
        blocks = [(p + width, size)]
        out: list = []
        order = 2 if flags & 0x04 else 0
        first = True
        while blocks:
            start, size = blocks.pop(0)
            if not first:  # a continuation block: OCHK, messages, checksum
                if self._bytes(start, 4) != b"OCHK":
                    raise ValueError(f"{self.path}: continuation block at {start} has no OCHK "
                                     "signature")
                start, size = start + 4, size - 8
            first = False
            block = self._bytes(start, size)
            p = 0
            while p + 4 + order <= size:  # what is left after the last message is a gap
                kind, n, mflags = block[p], self._uint(block, p + 1, 2), block[p + 3]
                body = block[p + 4 + order:p + 4 + order + n]
                if len(body) < n:
                    raise ValueError(f"{self.path}: truncated file: an object header message "
                                     "runs past its block")
                p += 4 + order + n
                out.append(self._message(kind, mflags, body, blocks))
        return out

    def _message(self, kind: int, flags: int, body: bytes, blocks: list) -> tuple:
        if kind == MSG_CONTINUATION:
            o, n = self.offset_size, self.length_size
            blocks.append((self._addr(self._uint(body, 0, o)), self._uint(body, o, n)))
        elif flags & 0x02 and kind == MSG_DATATYPE:
            raise ValueError(f"{self.path}: a shared (committed) datatype is not supported")
        return kind, flags, body

    # --- groups -------------------------------------------------------------

    def links(self, obj: _Object) -> list[tuple[str, int]]:
        """A group's hard links, ``[(name, object header address)]``, in
        name order (strcmp, as HDF5 orders its name index)."""
        found: list[tuple[bytes, int]] = []
        stab = obj.find(MSG_SYMBOL_TABLE)
        if stab is not None:
            o = self.offset_size
            btree, heap = self._uint(stab, 0, o), self._uint(stab, o, o)
            found += self._btree_links(btree, self._local_heap(heap))
        info = obj.find(MSG_LINK_INFO)
        if info is not None:
            p = 2 + (8 if info[1] & 1 else 0)
            fheap = self._uint(info, p, self.offset_size)
            if not self._undefined(fheap):
                raise ValueError(f"{self.path}: dense link storage (a fractal heap) is not "
                                 "supported: the group has more links than fit in its header")
        for kind, _, body in obj.messages:
            if kind == MSG_LINK:
                found.append(self._link(body))
        return [(name.decode("utf-8"), addr) for name, addr in sorted(found)]

    def _local_heap(self, address: int) -> bytes:
        pos = self._addr(address)
        n, o = self.length_size, self.offset_size
        head = self._bytes(pos, 8 + 2 * n + o)
        if head[:4] != b"HEAP":
            raise ValueError(f"{self.path}: no local heap at {pos}")
        size = self._uint(head, 8, n)
        return self._bytes(self._addr(self._uint(head, 8 + 2 * n, o)), size)

    @staticmethod
    def _heap_name(heap: bytes, offset: int) -> bytes:
        end = heap.find(b"\x00", offset)
        if end < 0:
            raise ValueError("truncated file: a local heap name has no terminator")
        return heap[offset:end]

    def _btree_links(self, address: int, heap: bytes) -> list[tuple[bytes, int]]:
        o, n = self.offset_size, self.length_size
        pos = self._addr(address)
        head = self._bytes(pos, 8 + 2 * o)
        if head[:4] != b"TREE":
            raise ValueError(f"{self.path}: no B-tree node at {pos}")
        if head[4] != 0:
            raise ValueError(f"{self.path}: B-tree node type {head[4]} in a group")
        level, used = head[5], self._uint(head, 6, 2)
        body = self._bytes(pos + 8 + 2 * o, used * (n + o) + n)
        out: list = []
        for i in range(used):
            child = self._uint(body, n + i * (n + o), o)
            if level > 0:
                out += self._btree_links(child, heap)
            else:
                out += self._snod_links(child, heap)
        return out

    def _snod_links(self, address: int, heap: bytes) -> list[tuple[bytes, int]]:
        o, n = self.offset_size, self.length_size
        pos = self._addr(address)
        head = self._bytes(pos, 8)
        if head[:4] != b"SNOD":
            raise ValueError(f"{self.path}: no symbol table node at {pos}")
        count = self._uint(head, 6, 2)
        size = n + o + 24
        body = self._bytes(pos + 8, count * size)
        out = []
        for i in range(count):
            name = self._heap_name(heap, self._uint(body, i * size, n))
            if self._uint(body, i * size + n + o, 4) == 2:  # cache type 2: a soft link
                raise ValueError(f"{self.path}: {name.decode('utf-8', 'replace')} is a soft "
                                 "link: only hard links are supported")
            out.append((name, self._uint(body, i * size + n, o)))
        return out

    def _link(self, body: bytes) -> tuple[bytes, int]:
        flags = body[1]
        p = 2
        kind = 0
        if flags & 0x08:
            kind = body[p]
            p += 1
        if flags & 0x04:
            p += 8
        if flags & 0x10:
            p += 1
        width = 1 << (flags & 3)
        length = self._uint(body, p, width)
        p += width
        name = body[p:p + length]
        p += length
        if kind != 0:
            what = {1: "a soft link", 64: "an external link"}.get(kind, f"link type {kind}")
            raise ValueError(f"{self.path}: {name.decode('utf-8', 'replace')} is {what}: "
                             "only hard links are supported")
        return name, self._uint(body, p, self.offset_size)

    # --- datasets -----------------------------------------------------------

    def dtype(self, body: bytes) -> np.dtype:
        cls = body[0] & 0x0F
        bits = body[1] | body[2] << 8 | body[3] << 16
        size = self._uint(body, 4, 4)
        if cls == 0:
            if size not in (1, 2, 4, 8):
                raise ValueError(f"{self.path}: {size}-byte integers are not supported")
            offset, precision = self._uint(body, 8, 2), self._uint(body, 10, 2)
            if offset != 0 or precision != 8 * size:
                raise ValueError(f"{self.path}: integers with padding bits are not supported")
            kind = "i" if bits & 0x08 else "u"
        elif cls == 1:
            if bits & 0x40:
                raise ValueError(f"{self.path}: VAX-order floats are not supported")
            props = (body[12], body[13], body[14], body[15], self._uint(body, 16, 4))
            if size not in _IEEE or props != _IEEE[size] or self._uint(body, 8, 2) != 0:
                raise ValueError(f"{self.path}: a non-IEEE {size}-byte float is not supported")
            kind = "f"
        else:
            name = _DATATYPE_CLASSES.get(cls, f"class {cls}")
            raise ValueError(f"{self.path}: {name} datatype is not supported "
                             f"({'variable-length data' if cls == 9 else 'numeric data only'})")
        order = ">" if bits & 0x01 else "<"
        return np.dtype(f"{order if size > 1 else '|'}{kind}{size}")

    def shape(self, body: bytes) -> tuple[int, ...]:
        version, rank = body[0], body[1]
        n = self.length_size
        if version == 1:
            start = 8
        elif version == 2:
            start = 4
            if body[3] == 2:
                raise ValueError(f"{self.path}: a null dataspace is not supported")
        else:
            raise ValueError(f"{self.path}: dataspace version {version} is not supported")
        return tuple(self._uint(body, start + i * n, n) for i in range(rank))

    def read(self, obj: _Object) -> np.ndarray:
        if obj.has(MSG_FILTERS):
            raise ValueError(f"{self.path}: a filtered (compressed) dataset is not supported: "
                             "its filter pipeline needs chunked storage")
        if obj.has(MSG_EXTERNAL):
            raise ValueError(f"{self.path}: external data storage is not supported")
        kinds = {MSG_DATASPACE: "dataspace", MSG_DATATYPE: "datatype", MSG_LAYOUT: "layout"}
        missing = [name for kind, name in kinds.items() if obj.find(kind) is None]
        if missing:
            raise ValueError(f"{self.path}: a dataset without a {missing[0]} message")
        dtype = self.dtype(obj.find(MSG_DATATYPE))
        shape = self.shape(obj.find(MSG_DATASPACE))
        nbytes = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
        raw = self._layout(obj.find(MSG_LAYOUT), nbytes)
        return np.frombuffer(raw, dtype).reshape(shape).copy()

    def _layout(self, body: bytes, nbytes: int) -> bytes:
        version = body[0]
        o = self.offset_size
        if version in (1, 2):
            rank, cls = body[1], body[2]
            p = 8
            if cls == 1:
                address = self._uint(body, p, o)
                return self._contiguous(address, nbytes)
            if cls == 0:
                p += 4 * rank
                size = self._uint(body, p, 4)
                return self._compact(body[p + 4:p + 4 + size], nbytes)
        elif version in (3, 4):
            cls = body[1]
            if cls == 0:
                size = self._uint(body, 2, 2)
                return self._compact(body[4:4 + size], nbytes)
            if cls == 1:
                return self._contiguous(self._uint(body, 2, o), nbytes)
        else:
            raise ValueError(f"{self.path}: data layout version {version} is not supported")
        what = {2: "chunked", 3: "virtual"}.get(cls, f"class {cls}")
        raise ValueError(f"{self.path}: a {what} data layout is not supported "
                         "(contiguous and compact only)")

    def _compact(self, raw: bytes, nbytes: int) -> bytes:
        if len(raw) < nbytes:
            raise ValueError(f"{self.path}: truncated file: compact data holds {len(raw)} of "
                             f"{nbytes} bytes")
        return raw[:nbytes]

    def _contiguous(self, address: int, nbytes: int) -> bytes:
        if nbytes == 0:
            return b""
        if self._undefined(address):
            raise ValueError(f"{self.path}: a dataset whose storage was never written")
        return self._bytes(self._addr(address), nbytes)

    # --- the walk -----------------------------------------------------------

    def visit(self, address: int | None = None, prefix: str = "", seen: set | None = None):
        """``(path, ndarray)`` of every dataset under the group at
        ``address`` (the root by default), as ``h5py``'s ``visititems``
        visits them: depth first, each group's links in name order, each
        object once."""
        seen = set() if seen is None else seen
        obj = self.object(self.root if address is None else address)
        for name, child in self.links(obj):
            if child in seen:
                continue
            seen.add(child)
            path = f"{prefix}{name}"
            sub = self.object(child)
            if sub.has(MSG_LAYOUT):
                yield path, self.read(sub)
            elif sub.has(MSG_SYMBOL_TABLE) or sub.has(MSG_LINK_INFO) or sub.has(MSG_LINK):
                yield from self.visit(child, path + "/", seen)
            elif sub.has(MSG_DATATYPE):
                raise ValueError(f"{self.path}: {path} is a committed datatype, which is "
                                 "not supported")
            else:
                unknown = sorted({t for t, _, _ in sub.messages} - _IGNORED)
                raise ValueError(f"{self.path}: {path} is neither a group nor a dataset "
                                 f"(message types {unknown})")

    def child(self, address: int, name: str) -> int | None:
        for n, a in self.links(self.object(address)):
            if n == name:
                return a
        return None


def read_keras_h5(path: str) -> dict[str, dict[str, np.ndarray]]:
    """Flatten a Keras .h5 into ``{layer_name: {weight_name: array}}``.

    Walks the file recursively, so both flat models and nested-submodel
    layouts (transfer learning: ``model_weights/xception/<layer>/<weight>:0``)
    work; arrays keep the file's dtype and byte order, as ``h5py`` returns
    them."""
    f = H5File(path)
    weights = f.child(f.root, "model_weights")
    layers: dict[str, dict[str, np.ndarray]] = {}
    for name, arr in f.visit(weights):
        parts = name.split("/")
        weight = parts[-1].split(":")[0]
        layer = parts[-2] if len(parts) >= 2 else parts[-1]
        layers.setdefault(layer, {})[weight] = arr
    return layers
