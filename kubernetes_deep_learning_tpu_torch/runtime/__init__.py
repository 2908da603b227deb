"""The serving engine of the port, its dispatch pipeline, its batchers and
the multi-model scheduler."""

import importlib
import logging
import os

from kubernetes_deep_learning_tpu_torch.runtime.errors import BatcherClosed, QueueFull

# The rest loads on first use (PEP 562), so that importing the package for
# its errors (the gateway does) does not import torch.
_LAZY = {
    "DynamicBatcher": "batcher",
    "DEFAULT_BUCKETS": "engine",
    "DispatcherClosed": "engine",
    "DispatchStall": "engine",
    "EngineClosed": "engine",
    "InferenceEngine": "engine",
    "InFlightDispatcher": "engine",
    "resolve_pipeline_depth": "engine",
    "UnifiedScheduler": "scheduler",
}


def __getattr__(name: str):
    if name in _LAZY:
        return getattr(importlib.import_module(f"{__name__}.{_LAZY[name]}"), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


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
    from kubernetes_deep_learning_tpu_torch.runtime.batcher import DynamicBatcher

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
