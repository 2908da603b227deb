"""The batchers' two failures, in a module that imports nothing, so that the
gateway (which raises and maps them too) runs without torch."""


class BatcherClosed(RuntimeError):
    """The batcher has been permanently shut down."""


class QueueFull(RuntimeError):
    """Transient overload: the request queue is at capacity (retryable)."""
