"""StubEngine: the serving host path with the device taken out.

The port's copy of the JAX package's ``runtime/stub.py``.  The stub has the
engine surface the server, the batchers and the scheduler consume (spec,
buckets, predict, predict_async, record_completed, registry) but
"computes" logits with a cheap function that still depends on each image:
``logits[i, j] = checksum(image_i) + j``.  Host-path tests and the
``host_ab.py`` A/Bs can then assert that replies are each image's own
result (nothing dropped or reordered) without paying for convolutions, and
can separate a policy of the port's from the card's host-bound regime.

``device_ms_per_batch`` simulates device latency with a sleep that releases
the interpreter lock.  ``async_device=True`` models the device as a SERIAL
queue behind ``predict_async``, the surface the in-flight dispatcher
overlaps with; ``host_ms_per_batch`` is then the dispatch stage's cost.
"""

from __future__ import annotations

import queue as queue_lib
import threading
import time

import numpy as np

from kubernetes_deep_learning_tpu_torch.runtime.engine import DEFAULT_BUCKETS
from kubernetes_deep_learning_tpu_torch.utils import metrics as metrics_lib


def stub_logits(images: np.ndarray, num_classes: int) -> np.ndarray:
    """Deterministic, cheap, per-image-distinct 'logits' (f32 (N, C)), equal
    to the JAX package's byte for byte.

    A sum over a fixed pixel subsample keeps the checksum cheap per image
    while still depending on the content, so misrouted replies are caught.
    """
    n = images.shape[0]
    flat = images.reshape(n, -1)
    sub = flat[:, ::1009].astype(np.int64)  # prime stride: ~220 B an image
    checksum = (sub.sum(axis=1) % 9973).astype(np.float32)
    return checksum[:, None] + np.arange(num_classes, dtype=np.float32)[None, :]


class _PendingLogits:
    """The handle ``predict_async`` returns: ``np.asarray()`` blocks until
    the simulated device has finished the batch."""

    device_seconds = None  # no device timing event: the MFU gauges skip it

    def __init__(self):
        self._ev = threading.Event()
        self._out: np.ndarray | None = None

    def _set(self, out: np.ndarray) -> None:
        self._out = out
        self._ev.set()

    def __array__(self, dtype=None, copy=None):
        self._ev.wait()
        out = self._out
        return out if dtype is None else out.astype(dtype)


class StubEngine:
    """Engine-shaped stand-in; see the module docstring.  Keyword arguments
    the real engine takes (``device``, ``pipeline_depth``, ...) are accepted
    and ignored, so a server's ``engine_factory`` can build either."""

    def __init__(self, artifact, buckets=DEFAULT_BUCKETS, registry=None,
                 device_ms_per_batch: float = 0.0, async_device: bool = False,
                 host_ms_per_batch: float = 0.0, **_ignored):
        self.spec = artifact.spec
        self.buckets = tuple(sorted(buckets))
        self.max_batch = self.buckets[-1]
        self.artifact_hash: str | None = None
        self._device_s = device_ms_per_batch / 1e3
        self._host_s = host_ms_per_batch / 1e3
        self._ready = threading.Event()
        self.registry = registry if registry is not None else metrics_lib.Registry()
        self._m_images = self.registry.counter(
            "kdlt_engine_images_total", "images predicted (stub engine)")
        self._dev_thread = None
        if async_device:
            # Serial device queue: one batch executes at a time, each taking
            # device_ms_per_batch; predict_async never waits for execution.
            # The caller's buffer must stay valid until materialization, as
            # with the real engine.
            self._dq: queue_lib.Queue = queue_lib.Queue()
            self._dev_thread = threading.Thread(target=self._device_loop, daemon=True,
                                                name="stub-device")
            self._dev_thread.start()
            self.predict_async = self._predict_async
            self.record_completed = self._record_completed

    def _predict_async(self, images: np.ndarray):
        if self._host_s:
            time.sleep(self._host_s)  # gather + H2D enqueue cost
        handle = _PendingLogits()
        self._dq.put((np.asarray(images), handle))
        return handle, images.shape[0]

    def _record_completed(self, n: int, seconds: float, device_s: float | None = None) -> None:
        self._m_images.inc(n)

    def _device_loop(self) -> None:
        while True:
            item = self._dq.get()
            if item is None:  # close() sentinel
                return
            images, handle = item
            if self._device_s:
                time.sleep(self._device_s)
            handle._set(stub_logits(images, self.spec.num_classes))

    def close(self) -> None:
        """Stop the simulated device's thread (async engines only)."""
        if self._dev_thread is not None:
            self._dq.put(None)
            self._dev_thread.join(timeout=5)
            self._dev_thread = None

    @property
    def ready(self) -> bool:
        return self._ready.is_set()

    def warmup(self) -> float:
        self._ready.set()
        return 0.0

    def bucket_for(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        return self.max_batch

    def bucket_audit(self) -> dict:
        return {}

    def predict(self, images: np.ndarray) -> np.ndarray:
        if self._host_s:
            time.sleep(self._host_s)  # dispatch-side host cost, serialized
        if self._device_s:
            time.sleep(self._device_s)  # releases the interpreter lock, like a device wait
        self._m_images.inc(images.shape[0])
        return stub_logits(images, self.spec.num_classes)

    # Without async_device there is no predict_async: the batchers and the
    # server take their synchronous path (hasattr checks), the honest host
    # cost when there is no device pipeline to overlap with.
