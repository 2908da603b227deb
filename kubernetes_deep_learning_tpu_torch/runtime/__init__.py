"""The serving engine of the port, its dispatch pipeline and its batcher."""

from kubernetes_deep_learning_tpu_torch.runtime.batcher import (
    BatcherClosed,
    DynamicBatcher,
    QueueFull,
)
from kubernetes_deep_learning_tpu_torch.runtime.engine import (
    DEFAULT_BUCKETS,
    DispatcherClosed,
    DispatchStall,
    InferenceEngine,
    InFlightDispatcher,
    resolve_pipeline_depth,
)

__all__ = [
    "DEFAULT_BUCKETS",
    "BatcherClosed",
    "DispatchStall",
    "DispatcherClosed",
    "DynamicBatcher",
    "InFlightDispatcher",
    "InferenceEngine",
    "QueueFull",
    "resolve_pipeline_depth",
]
