"""The serving engine of the port."""

from kubernetes_deep_learning_tpu_torch.runtime.engine import DEFAULT_BUCKETS, InferenceEngine

__all__ = ["DEFAULT_BUCKETS", "InferenceEngine"]
