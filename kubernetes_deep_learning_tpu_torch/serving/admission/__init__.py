"""Admission control and overload management for the port's two tiers.

The port's copy of the JAX package's ``serving/admission/``:

- ``deadline``: the request's remaining budget, from
  ``X-Request-Deadline-Ms``; every wait below is computed from what is
  left, and an exhausted request is rejected (504) before it touches the
  device;
- ``limiter``: an AIMD adaptive concurrency limiter with a bounded
  admission queue, per-model budgets and priority classes (503 + a derived,
  jittered ``Retry-After``, with a shed reason of its own);
- ``breaker``: the gateway's circuit breaker on the model tier, with
  half-open probing;
- ``controller``: the front door combining them, the ``kdlt_admission_*``
  series, and graceful drain (SIGTERM flips /readyz, sheds new work and
  lets admitted work finish).

The brownout controller comes with the brownout ladder (ROADMAP A12b).
"""

from kubernetes_deep_learning_tpu_torch.serving.admission.breaker import CircuitBreaker

from kubernetes_deep_learning_tpu_torch.serving.admission.controller import (
    AdmissionController,
    Ticket,
    admission_enabled,
    drain_timeout_s,
    install_sigterm_drain,
)
from kubernetes_deep_learning_tpu_torch.serving.admission.deadline import (
    DEADLINE_HEADER,
    WSGI_DEADLINE_KEY,
    Deadline,
)
from kubernetes_deep_learning_tpu_torch.serving.admission.limiter import (
    AdaptiveLimiter,
    env_budgets,
    env_max_limit,
    parse_budgets,
)
from kubernetes_deep_learning_tpu_torch.serving.admission.shed import (
    RETRY_AFTER_HEADER,
    Shed,
    retry_after_headers,
)

__all__ = [
    "AdaptiveLimiter",
    "AdmissionController",
    "CircuitBreaker",
    "DEADLINE_HEADER",
    "WSGI_DEADLINE_KEY",
    "Deadline",
    "RETRY_AFTER_HEADER",
    "Shed",
    "Ticket",
    "admission_enabled",
    "drain_timeout_s",
    "env_budgets",
    "env_max_limit",
    "install_sigterm_drain",
    "parse_budgets",
    "retry_after_headers",
]
