"""Shed: the typed rejection every admission decision point raises.

The port's copy of the JAX package's ``serving/admission/shed.py``.  A shed
is not an error in the request (4xx) and not a server fault (500): it is
the tier refusing work it cannot finish usefully (DAGOR-style overload
control).  Each shed carries a machine-readable ``reason`` (one of
``utils.metrics.ADMISSION_SHED_REASONS``), the HTTP status to map it to
(503 for retryable overload, 504 for an already-exhausted deadline budget)
and an optional ``retry_after_s`` hint, sent as ``Retry-After``.
"""

from __future__ import annotations

from kubernetes_deep_learning_tpu_torch.serving.protocol import (
    RETRY_AFTER_HEADER,
    retry_after_headers,
)

__all__ = ["RETRY_AFTER_HEADER", "Shed", "retry_after_headers"]


class Shed(RuntimeError):
    """The request was refused by admission control, not failed by it."""

    def __init__(self, reason: str, http_status: int = 503,
                 retry_after_s: float | None = None, detail: str = ""):
        super().__init__(detail or f"request shed ({reason})")
        self.reason = reason
        self.http_status = http_status
        self.retry_after_s = retry_after_s

    def headers(self) -> dict[str, str]:
        """The extra response headers this shed mandates."""
        return retry_after_headers(self.retry_after_s)
