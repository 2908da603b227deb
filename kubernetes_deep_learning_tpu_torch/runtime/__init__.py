"""The serving engine of the port, its dispatch pipeline, its batchers and
the multi-model scheduler."""

import logging
import os

from kubernetes_deep_learning_tpu_torch.runtime.batcher import (
    BatcherClosed,
    DynamicBatcher,
    QueueFull,
)
from kubernetes_deep_learning_tpu_torch.runtime.engine import (
    DEFAULT_BUCKETS,
    DispatcherClosed,
    DispatchStall,
    EngineClosed,
    InferenceEngine,
    InFlightDispatcher,
    resolve_pipeline_depth,
)
from kubernetes_deep_learning_tpu_torch.runtime.scheduler import UnifiedScheduler

log = logging.getLogger(__name__)

BATCHER_IMPLS = ("auto", "native", "python")


def create_batcher(engine, impl: str = "auto", dispatcher=None, **kwargs):
    """Pick the batching implementation, by the JAX package's rule.

    "native" -> the C++ queue (``runtime.native_batcher.NativeBatcher``,
    built with g++ at first use; a failed build raises); "python" -> the
    pure-Python ``DynamicBatcher``; "auto" -> native when the process may
    run on at least 2 cores (the affinity mask, not the host's count), else
    Python, and Python too, with a warning, when the queue will not build.
    The JAX package measured that on one core the native pipeline's
    cross-thread handoffs convoy on the interpreter lock.  Both share the
    policy, the surface and ``dispatcher`` (the served model's in-flight
    pipeline); ``kwargs`` go to the batcher.
    """
    if impl not in BATCHER_IMPLS:
        raise ValueError(f"unknown batcher impl {impl!r}")
    if impl == "auto":
        try:
            cores = len(os.sched_getaffinity(0))
        except (AttributeError, OSError):  # not Linux
            cores = os.cpu_count() or 1
        if cores < 2:
            impl = "python"
    if impl in ("auto", "native"):
        from kubernetes_deep_learning_tpu_torch.runtime.native_batcher import NativeBatcher

        try:
            return NativeBatcher(engine, dispatcher=dispatcher, **kwargs)
        except (OSError, RuntimeError):
            if impl == "native":
                raise
            log.warning("the native batch queue is unavailable; using the Python batcher",
                        exc_info=True)
    return DynamicBatcher(engine, dispatcher=dispatcher, **kwargs)


__all__ = [
    "DEFAULT_BUCKETS",
    "BatcherClosed",
    "DispatchStall",
    "DispatcherClosed",
    "DynamicBatcher",
    "EngineClosed",
    "InFlightDispatcher",
    "InferenceEngine",
    "QueueFull",
    "UnifiedScheduler",
    "create_batcher",
    "resolve_pipeline_depth",
]
