"""ModelRegistry: every model under one artifact root, on one card.

The port of the JAX package's ``serving/registry.py``:

- scans ``<root>/<name>/<version>/`` for EVERY model's highest numeric
  version (the TF-Serving layout rule, per model);
- keys loaded artifacts by **artifact hash** (sha256 over the version
  dir's files, byte for byte the JAX package's, so replicas of either
  server report the same identity for the same directory): a re-export of
  byte-identical content under a new version number is adopted without a
  reload, so no warmup or graph capture is spent on the same weights;
- owns the ``name -> ServedModel`` map the server routes by (copy-on-write
  swaps; the loader warms a version before the swap);
- answers ``GET /v1/models`` (``status``) and ``GET
  /v1/models/<name>:status`` (``model_status``) with the JAX keys.

Construction policy stays with the caller: ``loader(name, version,
directory) -> served`` (None declines the directory) and ``unloader(served)``
for a superseded version, so this module owns only scan, swap and identity.
"""

from __future__ import annotations

import hashlib
import logging
import os
import threading

from kubernetes_deep_learning_tpu_torch.export import artifact as art

log = logging.getLogger(__name__)


def artifact_hash(directory: str) -> str:
    """sha256 over the version dir's file names and bytes (sorted, streamed).

    The identity key of a loaded artifact: stable across hosts for the
    same exported bytes, different for any weight, spec or module change.
    """
    h = hashlib.sha256()
    for entry in sorted(os.listdir(directory)):
        path = os.path.join(directory, entry)
        if not os.path.isfile(path):
            continue
        h.update(entry.encode())
        h.update(b"\0")
        with open(path, "rb") as f:
            for chunk in iter(lambda: f.read(1 << 20), b""):
                h.update(chunk)
        h.update(b"\1")
    return h.hexdigest()


def iter_latest_versions(model_root: str) -> list[tuple[str, int, str]]:
    """Every model's highest numeric version under ``model_root``, as
    (name, version, directory) tuples in name order."""
    out: list[tuple[str, int, str]] = []
    names = sorted(os.listdir(model_root)) if os.path.isdir(model_root) else []
    for name in names:
        version = art.latest_version(model_root, name)
        if version is not None:
            out.append((name, version, art.version_dir(model_root, name, version)))
    return out


class ModelRegistry:
    """Scan, compare and swap for every model under one artifact root.

    Thread contract: scans are serialized on a lock; the ``models`` dict is
    rebound copy-on-write, so handler threads holding a snapshot never see
    it change; a new version is loaded and warmed by the loader BEFORE the
    swap, and the superseded one is unloaded after it.
    """

    def __init__(self, model_root: str, loader, unloader=None):
        self.model_root = model_root
        self._loader = loader
        self._unloader = unloader
        self.models: dict = {}
        self._hashes: dict[str, str] = {}  # name -> served artifact hash
        self._lock = threading.Lock()

    def __contains__(self, name: str) -> bool:
        return name in self.models

    def get(self, name: str):
        return self.models.get(name)

    def poll(self) -> list[str]:
        """One scan of the artifact root: load any new model or higher
        version whose CONTENT changed.  Returns "name vN" per swap."""
        with self._lock:
            return self._poll_locked()

    def _poll_locked(self) -> list[str]:
        updated: list[str] = []
        for name, version, directory in iter_latest_versions(self.model_root):
            current = self.models.get(name)
            if current is not None and current.version >= version:
                continue
            try:
                digest = artifact_hash(directory)
            except OSError as e:
                log.warning("model registry: skipping %s v%d: %s", name, version, e)
                continue
            if current is not None and self._hashes.get(name) == digest:
                # Same bytes under a higher version number: adopt the
                # version without reloading -- the hash, not the directory
                # name, is the artifact's identity.  (The metric series keep
                # the loaded version's label; the artifact_hash is the join
                # key.)
                current.version = version
                log.info("model registry: %s v%d is byte-identical to the served artifact "
                         "(%s); adopted without reload", name, version, digest[:12])
                continue
            try:
                fresh = self._loader(name, version, directory)
            except Exception as e:  # noqa: BLE001 - a broken version must not stop serving
                # A half-written or broken version dir never takes down the
                # serving versions: skipped, and retried on the next poll.
                log.warning("version watcher: skipping %s v%d: %s", name, version, e)
                continue
            if fresh is None:  # the loader declined (spec/directory name mismatch)
                continue
            fresh.artifact_hash = digest
            old = self.models.get(name)
            self.models = {**self.models, name: fresh}
            self._hashes[name] = digest
            if old is not None and self._unloader is not None:
                self._unloader(old)
            updated.append(f"{name} v{version}")
            log.info("loaded %s v%d from %s", name, version, directory)
        return updated

    def status(self) -> dict:
        """GET /v1/models: per-model serving status, keyed by name."""
        return {name: self.model_status(name, m) for name, m in self.models.items()}

    def model_status(self, name: str, served=None) -> dict | None:
        """GET /v1/models/<name>:status, with the JAX server's keys: the
        engine's ``quantization`` (the artifact's scheme tag) and
        ``quantization_active`` (the scheme actually serving, after the
        warmup gate and $KDLT_QUANT_SCHEME), and its ``sharding_info``
        (one device: "single", 1, None)."""
        served = served if served is not None else self.models.get(name)
        if served is None:
            return None
        engine = served.engine
        metadata = getattr(served.artifact, "metadata", {}) or {}
        info_fn = getattr(engine, "sharding_info", None)
        info = info_fn() if callable(info_fn) else {}
        return {
            "version": served.version,
            "ready": bool(engine.ready),
            "artifact_hash": getattr(served, "artifact_hash", None) or self._hashes.get(name),
            "buckets": list(getattr(engine, "buckets", ())),
            "family": getattr(served.artifact.spec, "family", None),
            "labels": list(served.artifact.spec.labels),
            "quantization": getattr(engine, "quantization", None) or metadata.get("quantization"),
            "quantization_active": getattr(engine, "quantization_active",
                                           metadata.get("quantization")),
            "sharding": info.get("sharding"),
            "model_parallel": info.get("model_parallel", 1),
            "mesh_shape": info.get("mesh_shape"),
        }
