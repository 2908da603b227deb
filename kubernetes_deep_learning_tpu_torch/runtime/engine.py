"""Inference engine: bucketed batch padding around the forward module.

The port of ``runtime/engine.py``'s single-device ``InferenceEngine``.  A
request batch is padded up to the smallest bucket that holds it, so the
device only ever sees the bucket shapes that ``warmup()`` ran; warmup also
builds the CUDA kernels, and a kernel that fails to build or launch fails
warmup (there is no fallback to another graph).

Inputs:
- uint8 (N,H,W,C): the serving path, in the artifact's compute dtype
  (``metadata["compute_dtype"]``, default bfloat16) on the fused path when
  ``fast`` resolves to it;
- float32 (N,H,W,C), already normalized: the exact float32 graph, the
  debug/reference path (built on first use).
"""

from __future__ import annotations

import threading
import time
from typing import Sequence

import numpy as np
import torch

from kubernetes_deep_learning_tpu_torch import weights
from kubernetes_deep_learning_tpu_torch.export.artifact import ModelArtifact
from kubernetes_deep_learning_tpu_torch.models import build_forward, resolve_device

DEFAULT_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128)

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


class DeviceLogits:
    """An in-flight result: ``np.asarray(handle)`` waits for the device
    (a CUDA event recorded after the forward) and copies to the host."""

    def __init__(self, logits: torch.Tensor):
        self._logits = logits
        self._event = None
        if logits.device.type == "cuda":
            self._event = torch.cuda.Event()
            self._event.record(torch.cuda.current_stream(logits.device))

    def __array__(self, dtype=None, copy=None):
        if self._event is not None:
            self._event.synchronize()
        arr = self._logits.cpu().numpy()
        return arr if dtype is None else arr.astype(dtype)


class InferenceEngine:
    def __init__(self, artifact: ModelArtifact, buckets: Sequence[int] = DEFAULT_BUCKETS,
                 device: str | torch.device = "cuda", fast: bool | str = "auto"):
        self.spec = artifact.spec
        self.buckets = tuple(sorted(buckets))
        self.max_batch = self.buckets[-1]
        self.device = resolve_device(device)
        name = artifact.metadata.get("compute_dtype", "bfloat16")
        if name not in _DTYPES:
            raise ValueError(f"unsupported compute dtype {name!r}")
        self.compute_dtype = _DTYPES[name]
        self._params = weights.from_jax_variables(artifact.variables)
        self._forward = build_forward(
            self.spec, self._params, self.compute_dtype, fast, self.device
        )
        self.fast = self._forward.fast
        self._exact_f32 = None
        self._lock = threading.Lock()
        self._ready = threading.Event()

    @property
    def ready(self) -> bool:
        return self._ready.is_set()

    def warmup(self) -> float:
        """Run every bucket once (building the kernels); gate readiness."""
        t0 = time.perf_counter()
        for b in self.buckets:
            np.asarray(self.predict_async(np.zeros((b, *self.spec.input_shape), np.uint8))[0])
        dt = time.perf_counter() - t0
        self._ready.set()
        return dt

    def bucket_for(self, n: int) -> int:
        for b in self.buckets:
            if b >= n:
                return b
        raise ValueError(f"batch {n} exceeds max bucket {self.max_batch}")

    def _padded(self, images: np.ndarray, dtype) -> tuple[torch.Tensor, int]:
        images = np.asarray(images)
        if images.ndim != 4 or images.shape[1:] != tuple(self.spec.input_shape):
            raise ValueError(f"expected (N, {self.spec.input_shape}), got {images.shape}")
        if images.dtype != dtype:
            raise ValueError(f"expected {np.dtype(dtype).name} images, got {images.dtype}")
        n = images.shape[0]
        bucket = self.bucket_for(n)
        if bucket != n:
            pad = np.zeros((bucket - n, *self.spec.input_shape), images.dtype)
            images = np.concatenate([images, pad], axis=0)
        # Wire arrays are read-only views of the request body; torch wants a
        # writable buffer, so np.require copies those (and only those).
        return torch.from_numpy(np.require(images, requirements=["C", "W"])).to(self.device), n

    def predict_async(self, images: np.ndarray) -> tuple[DeviceLogits, int]:
        """Dispatch a uint8 batch without waiting; returns (handle, n).
        ``np.asarray(handle)[:n]`` materializes the logits."""
        batch, n = self._padded(images, np.uint8)
        with self._lock, torch.inference_mode():
            return DeviceLogits(self._forward(batch)), n

    def _exact_forward(self):
        with self._lock:
            if self._exact_f32 is None:
                self._exact_f32 = build_forward(
                    self.spec, self._params, torch.float32, False, self.device
                )
            return self._exact_f32

    def predict(self, images: np.ndarray) -> np.ndarray:
        """uint8 or normalized float32 (N,H,W,C) -> float32 logits (N, classes)."""
        images = np.asarray(images)
        if images.dtype == np.uint8:
            handle, n = self.predict_async(images)
            return np.asarray(handle)[:n]
        if images.dtype != np.float32:
            raise ValueError(
                f"dtype {images.dtype} unsupported: send uint8 pixels or "
                "float32 pre-normalized data"
            )
        fn = self._exact_forward()
        batch, n = self._padded(images, np.float32)
        with self._lock, torch.inference_mode():
            return np.asarray(DeviceLogits(fn(batch)))[:n]

    def predict_scores(self, images: np.ndarray) -> list[dict[str, float]]:
        """Labelled score dicts, the reference's response shape."""
        logits = self.predict(images)
        return [dict(zip(self.spec.labels, map(float, row))) for row in logits]
