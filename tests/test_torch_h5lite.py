"""The port's HDF5 reader (``h5lite``) against ``h5py``, on the CPU.

Every file here is written by ``h5py`` (or, last, by ``chip_smoke.py``'s
writer, which ``h5py`` then reads).  For each readable case the port's
``read_keras_h5`` must equal the JAX package's (an ``h5py`` walk) exactly:
the same layers and weights in the same order, each array of the same
dtype (byte order included), shape and bytes.  Each unsupported feature
must raise a ``ValueError`` that names it.
"""

from __future__ import annotations

import ctypes
import glob
import os

import h5py
import numpy as np
import pytest

import chip_smoke
from kubernetes_deep_learning_tpu.models.keras_import import read_keras_h5 as jax_read
from kubernetes_deep_learning_tpu_torch import h5lite
from torch_threads import one_torch_thread  # noqa: F401


def _assert_same(got: dict, want: dict) -> None:
    assert list(got) == list(want)
    for layer in want:
        assert list(got[layer]) == list(want[layer]), layer
        for name, w in want[layer].items():
            g = got[layer][name]
            assert (g.dtype, g.shape) == (w.dtype, w.shape), (layer, name)
            assert g.tobytes() == w.tobytes(), (layer, name)


def _layers(f, n: int, rng, nested: bool = True) -> None:
    mw = f.create_group("model_weights")
    for i in range(n):
        g = mw.create_group(f"layer_{i}")
        if nested:
            g = g.create_group(f"layer_{i}")
        g.create_dataset("kernel:0", data=rng.standard_normal((3, 3, 2, 4)).astype(np.float32))
        g.create_dataset("bias:0", data=rng.standard_normal(4).astype(np.float32))


def _flat(path, rng):
    with h5py.File(path, "w") as f:
        _layers(f, 3, rng, nested=False)


def _nested(path, rng):
    with h5py.File(path, "w") as f:
        _layers(f, 4, rng)
        base = f["model_weights"].create_group("xception")
        for name in ("block1_conv1", "block1_conv1_bn"):
            base.create_group(name).create_group(name).create_dataset(
                "kernel:0", data=rng.standard_normal((2, 5)).astype(np.float32))


def _many(path, rng):
    """150 layers: a two-level group B-tree, dozens of symbol-table nodes,
    and a 60 KB root attribute (Keras's model_config) in a continuation."""
    with h5py.File(path, "w") as f:
        f.attrs["model_config"] = "x" * 60_000
        f.attrs["keras_version"] = "2.4.0"
        _layers(f, 150, rng)


def _dtypes(path, rng):
    with h5py.File(path, "w") as f:
        g = f.create_group("model_weights").create_group("misc").create_group("misc")
        for dt in ("<f2", "<f4", "<f8", ">f2", ">f4", ">f8"):
            g.create_dataset(f"w{dt[1:]}{'be' if dt[0] == '>' else ''}:0",
                             data=rng.standard_normal((3, 4)).astype(dt))
        for dt in ("<i1", "|u1", "<i2", ">i2", "<u4", "<i8", ">u8"):
            g.create_dataset(f"{dt}:0", data=np.arange(-3, 9).astype(dt))
        g.create_dataset("scalar:0", data=np.float32(2.5))
        g.create_dataset("scalar_i:0", data=np.int64(-7))
        g.create_dataset("empty:0", data=np.zeros((0, 3), np.float32))
        g.create_dataset("empty1:0", data=np.zeros((0,), np.float64))


def _sizes(offsets: int, lengths: int):
    def make(path, rng):
        fcpl = h5py.h5p.create(h5py.h5p.FILE_CREATE)
        fcpl.set_sizes(offsets, lengths)
        fid = h5py.h5f.create(os.fsencode(path), h5py.h5f.ACC_TRUNC, fcpl=fcpl)
        with h5py.File(fid) as f:
            _layers(f, 40, rng)
    return make


def _superblock1(path, rng):
    """A non-default indexed-storage K makes HDF5 write superblock 1 (h5py
    has no binding for it: call the library h5py loaded)."""
    lib = ctypes.CDLL(glob.glob(os.path.join(os.path.dirname(h5py.__file__), "..",
                                             "h5py.libs", "libhdf5-*.so*"))[0])
    fcpl = h5py.h5p.create(h5py.h5p.FILE_CREATE)
    assert lib.H5Pset_istore_k(ctypes.c_int64(fcpl.id), ctypes.c_uint(64)) >= 0
    fid = h5py.h5f.create(os.fsencode(path), h5py.h5f.ACC_TRUNC, fcpl=fcpl)
    with h5py.File(fid) as f:
        _layers(f, 20, rng)


def _userblock(path, rng):
    with h5py.File(path, "w", userblock_size=1024) as f:
        _layers(f, 5, rng)


def _compact(path, rng):
    with h5py.File(path, "w") as f:
        g = f.create_group("model_weights").create_group("c").create_group("c")
        dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
        dcpl.set_layout(h5py.h5d.COMPACT)
        arr = rng.standard_normal((4, 5)).astype(np.float32)
        dsid = h5py.h5d.create(g.id, b"kernel:0", h5py.h5t.IEEE_F32LE,
                               h5py.h5s.create_simple(arr.shape), dcpl=dcpl)
        dsid.write(h5py.h5s.ALL, h5py.h5s.ALL, arr)


def _latest(path, rng):
    """libver="latest": superblock 3, OHDR headers, links kept compact (at
    most 8 a group), a 70 KB attribute in dense attribute storage."""
    with h5py.File(path, "w", libver="latest") as f:
        f.attrs["model_config"] = "y" * 70_000
        _layers(f, 8, rng)


def _no_model_weights(path, rng):
    with h5py.File(path, "w") as f:
        f.create_group("dense").create_dataset("kernel:0", data=rng.standard_normal((2, 3)))
        f.create_dataset("top:0", data=np.arange(3.0))


READABLE = {"flat": _flat, "nested": _nested, "many": _many, "dtypes": _dtypes,
            "offsets4": _sizes(4, 4), "offsets4_lengths8": _sizes(4, 8),
            "offsets8_lengths4": _sizes(8, 4), "superblock1": _superblock1,
            "userblock": _userblock, "compact": _compact, "latest": _latest,
            "no_model_weights": _no_model_weights}


@pytest.mark.parametrize("case", sorted(READABLE))
def test_read_keras_h5_equals_jax(tmp_path, case):
    path = str(tmp_path / f"{case}.h5")
    READABLE[case](path, np.random.default_rng(sorted(READABLE).index(case)))
    _assert_same(h5lite.read_keras_h5(path), jax_read(path))


def test_many_layers_walk_a_deep_btree(tmp_path, monkeypatch):
    """The 150-layer group's B-tree has an internal level over its
    symbol-table nodes."""
    path = str(tmp_path / "many.h5")
    _many(path, np.random.default_rng(0))
    levels, snods = [], []
    btree, snod = h5lite.H5File._btree_links, h5lite.H5File._snod_links

    def spy_btree(self, address, heap):
        levels.append(self._bytes(self._addr(address), 8)[5])
        return btree(self, address, heap)

    def spy_snod(self, address, heap):
        snods.append(address)
        return snod(self, address, heap)

    monkeypatch.setattr(h5lite.H5File, "_btree_links", spy_btree)
    monkeypatch.setattr(h5lite.H5File, "_snod_links", spy_snod)
    assert len(h5lite.read_keras_h5(path)) == 150
    assert max(levels) >= 1 and len(snods) > 20


def _dense(path):
    with h5py.File(path, "w", libver="latest") as f:
        _layers(f, 9, np.random.default_rng(0))


def _chunked(path):
    with h5py.File(path, "w") as f:
        f.create_group("model_weights").create_dataset("k:0", data=np.ones((8, 8)),
                                                       chunks=(4, 4))


def _gzip(path):
    with h5py.File(path, "w") as f:
        f.create_group("model_weights").create_dataset("k:0", data=np.ones((8, 8)),
                                                       compression="gzip")


def _vlen(path):
    with h5py.File(path, "w") as f:
        f.create_group("model_weights").create_dataset("k:0", data=["ab", "c"],
                                                       dtype=h5py.string_dtype())


def _string(path):
    with h5py.File(path, "w") as f:
        f.create_group("model_weights").create_dataset("k:0", data=np.array([b"ab"]))


def _soft(path):
    with h5py.File(path, "w") as f:
        f.create_group("model_weights")["s"] = h5py.SoftLink("/elsewhere")


def _ohdr_in_superblock0(path):
    with h5py.File(path, "w", track_order=True) as f:
        _layers(f, 2, np.random.default_rng(0))


def _truncated(path):
    _many(path, np.random.default_rng(0))
    with open(path, "rb") as f:
        data = f.read()
    with open(path, "wb") as f:
        f.write(data[:len(data) // 2])


REFUSED = {"dense": (_dense, "dense link storage"),
           "chunked": (_chunked, "chunked data layout"),
           "gzip": (_gzip, "filtered"),
           "vlen": (_vlen, "variable-length"),
           "string": (_string, "string datatype"),
           "soft_link": (_soft, "soft link"),
           "ohdr_in_superblock0": (_ohdr_in_superblock0, "version-2 object header"),
           "truncated": (_truncated, "truncated file")}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_unsupported_features_raise_by_name(tmp_path, case):
    make, feature = REFUSED[case]
    path = str(tmp_path / f"{case}.h5")
    make(path)
    with pytest.raises(ValueError, match=feature):
        h5lite.read_keras_h5(path)


def test_h5py_reads_the_smoke_writer(tmp_path):
    """``chip_smoke._write_h5`` (the card's .h5, written without h5py):
    h5py reads back every array, by walk and by path lookup through the
    group B-tree; h5lite reads the same."""
    rng = np.random.default_rng(3)
    tree = {"model_weights": {
        "xception": {f"blk{i}": {f"blk{i}": {
            "kernel:0": rng.standard_normal((3, 3, 2, 4)).astype(np.float32),
            "bias:0": rng.standard_normal(4).astype(np.float16)}} for i in range(150)},
        "dense_5": {"dense_5": {"kernel:0": rng.standard_normal((8, 3)),
                                "bias:0": np.zeros(0, np.float32)}}}}
    path = str(tmp_path / "w.h5")
    size = chip_smoke._write_h5(path, tree)
    assert size == os.path.getsize(path)
    want = {"/".join(k): v for k, v in chip_smoke._flat_leaves(tree).items()}
    got: dict = {}
    with h5py.File(path, "r") as f:
        f.visititems(lambda n, o: got.__setitem__(n, np.asarray(o))
                     if isinstance(o, h5py.Dataset) else None)
        assert f["model_weights/xception/blk77/blk77/kernel:0"].shape == (3, 3, 2, 4)
        assert "blk150" not in f["model_weights/xception"]
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype and got[k].tobytes() == v.tobytes(), k
    _assert_same(h5lite.read_keras_h5(path), jax_read(path))
