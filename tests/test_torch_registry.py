"""The port's ``serving/registry.py`` against the JAX package's, on the CPU.

``artifact_hash`` and ``iter_latest_versions`` give the JAX functions'
answers on the same temporary root (byte for byte: a gateway compares
hashes across replicas of either server).  Then each package's
``ModelRegistry`` runs the same scan sequence over a stand-in loader: a
byte-identical re-export is adopted without a reload, a loader that
raises keeps the served version and is retried on the next scan, a
loader that declines is skipped, the superseded version is unloaded after
the swap, and ``status()`` answers the same keys and values for one
artifact.
"""

from __future__ import annotations

import os
import shutil
from types import SimpleNamespace

import numpy as np
import pytest

from kubernetes_deep_learning_tpu.serving import registry as jax_registry
from kubernetes_deep_learning_tpu_torch.serving import registry as port_registry
from torch_threads import one_torch_thread  # noqa: F401

_PKGS = {"jax": jax_registry, "port": port_registry}


def _write(directory, files: dict[str, bytes]) -> str:
    os.makedirs(directory, exist_ok=True)
    for name, data in files.items():
        with open(os.path.join(directory, name), "wb") as f:
            f.write(data)
    return str(directory)


def _root(tmp_path):
    """Three models: m-a with versions 1, 2 and 10 (numeric order, not
    lexical) plus non-numeric and file entries that do not count; m-b with
    a nested directory (ignored by the hash) and a 3 MiB file (hashed in
    chunks); m-empty with no version at all."""
    rng = np.random.default_rng(0)
    root = tmp_path / "root"
    for v in (1, 2, 10):
        _write(root / "m-a" / str(v), {"spec.json": b'{"v": %d}' % v,
                                       "params.msgpack": rng.bytes(1000)})
    _write(root / "m-a" / "tmp-export", {"spec.json": b"{}"})
    _write(root / "m-a", {"README": b"not a version"})
    _write(root / "m-b" / "3", {"params.msgpack": rng.bytes(3 << 20), "z": b"",
                                "a": b"\0\1"})
    _write(root / "m-b" / "3" / "nested", {"x": b"ignored"})
    (root / "m-empty").mkdir()
    return str(root)


def test_artifact_hash_and_latest_versions_match_jax(tmp_path):
    root = _root(tmp_path)
    latest = port_registry.iter_latest_versions(root)
    assert latest == jax_registry.iter_latest_versions(root)
    assert [(n, v) for n, v, _ in latest] == [("m-a", 10), ("m-b", 3)]
    for name, version, directory in latest:
        assert port_registry.artifact_hash(directory) == jax_registry.artifact_hash(directory)
    for v in (1, 2):
        d = os.path.join(root, "m-a", str(v))
        assert port_registry.artifact_hash(d) == jax_registry.artifact_hash(d)
    a1, a2 = (port_registry.artifact_hash(os.path.join(root, "m-a", str(v))) for v in (1, 2))
    assert a1 != a2
    copy = shutil.copytree(os.path.join(root, "m-b", "3"), tmp_path / "copy")
    shutil.rmtree(os.path.join(copy, "nested"))  # a subdirectory is not hashed
    assert port_registry.artifact_hash(str(copy)) == port_registry.artifact_hash(
        os.path.join(root, "m-b", "3"))
    assert port_registry.iter_latest_versions(str(tmp_path / "absent")) == []


class _Loader:
    """A stand-in for the server's loader: one served object per load,
    failing or declining on request."""

    def __init__(self):
        self.loads: list[tuple[str, int]] = []
        self.unloaded: list = []
        self.fail: set[tuple[str, int]] = set()
        self.decline: set[tuple[str, int]] = set()

    def load(self, name, version, directory):
        if (name, version) in self.fail:
            raise RuntimeError("half-written artifact")
        if (name, version) in self.decline:
            return None
        self.loads.append((name, version))
        engine = SimpleNamespace(
            ready=True, buckets=(1, 2, 4),
            sharding_info=lambda: {"sharding": "single", "model_parallel": 1,
                                   "mesh_shape": None})
        spec = SimpleNamespace(family="xception", labels=("x", "y"))
        return SimpleNamespace(version=version, engine=engine, name=name,
                               artifact=SimpleNamespace(spec=spec, metadata={}))

    def unload(self, served):
        self.unloaded.append((served.name, served.version))


def _version(root, name, v, data: bytes):
    return _write(os.path.join(root, name, str(v)), {"spec.json": b"{}", "params.msgpack": data})


@pytest.mark.parametrize("pkg", sorted(_PKGS))
def test_registry_scan_swap_dedupe_and_retry(tmp_path, pkg):
    root = str(tmp_path)
    loader = _Loader()
    reg = _PKGS[pkg].ModelRegistry(root, loader.load, loader.unload)
    _version(root, "a", 1, b"a1")
    _version(root, "b", 1, b"b1")
    assert reg.poll() == ["a v1", "b v1"]
    a1 = reg.get("a")
    assert "a" in reg and reg.poll() == []  # nothing new: no load
    # A byte-identical re-export under v2: adopted without a reload.
    shutil.copytree(os.path.join(root, "a", "1"), os.path.join(root, "a", "2"))
    assert reg.poll() == [] and reg.get("a") is a1 and a1.version == 2
    assert loader.loads == [("a", 1), ("b", 1)] and loader.unloaded == []
    # A loader that raises: v1 keeps serving, and the next scan retries.
    _version(root, "b", 2, b"b2")
    loader.fail.add(("b", 2))
    assert reg.poll() == [] and reg.get("b").version == 1
    loader.fail.clear()
    assert reg.poll() == ["b v2"] and reg.get("b").version == 2
    assert loader.unloaded == [("b", 1)]
    # A loader that declines (a spec whose name is not its directory's).
    _version(root, "a", 3, b"a3")
    loader.decline.add(("a", 3))
    assert reg.poll() == [] and reg.get("a") is a1
    loader.decline.clear()
    assert reg.poll() == ["a v3"] and reg.get("a").version == 3
    assert loader.unloaded == [("b", 1), ("a", 2)]
    status = reg.status()
    assert list(status) == ["a", "b"]
    assert status["a"]["artifact_hash"] == port_registry.artifact_hash(
        os.path.join(root, "a", "3"))
    assert reg.model_status("nope") is None


def test_registry_status_matches_jax_for_one_artifact(tmp_path):
    root = str(tmp_path)
    _version(root, "m", 4, b"weights")
    statuses = {}
    for pkg, mod in _PKGS.items():
        reg = mod.ModelRegistry(root, _Loader().load)
        assert reg.poll() == ["m v4"]
        statuses[pkg] = (reg.status(), reg.model_status("m"))
    assert statuses["port"] == statuses["jax"]
    status = statuses["port"][1]
    assert set(status) == {"version", "ready", "artifact_hash", "buckets", "family", "labels",
                           "quantization", "quantization_active", "sharding",
                           "model_parallel", "mesh_shape"}
    assert status["version"] == 4 and status["model_parallel"] == 1
    assert status["artifact_hash"] == jax_registry.artifact_hash(os.path.join(root, "m", "4"))
