"""AdmissionController: the model tier's front door, and graceful drain.

The port's copy of the JAX package's ``serving/admission/controller.py``
(no brownout: that comes with the brownout ladder, ROADMAP A12b).  Per
request it applies, in order: drain refusal, deadline-exhausted rejection
(504) and the adaptive concurrency limiter's bounded queue, raising a
typed ``Shed`` for the transport to map to 503/504 + ``Retry-After``, and
it tracks the in-flight count that graceful drain waits on.  Every
decision lands in the ``kdlt_admission_*`` series under the tier's label.

``enabled=False`` (or ``KDLT_ADMISSION=0``) keeps the controller as an
in-flight tracker only: no limiter and no deadline rejection (the fixed
waits of a server without admission), but drain still works.
"""

from __future__ import annotations

import os
import signal
import threading
import time

from kubernetes_deep_learning_tpu_torch.serving.admission.deadline import Deadline
from kubernetes_deep_learning_tpu_torch.serving.admission.limiter import AdaptiveLimiter
from kubernetes_deep_learning_tpu_torch.serving.admission.shed import Shed
from kubernetes_deep_learning_tpu_torch.serving.protocol import DEFAULT_PRIORITY
from kubernetes_deep_learning_tpu_torch.utils import metrics as metrics_lib

ADMISSION_ENV = "KDLT_ADMISSION"
DRAIN_TIMEOUT_ENV = "KDLT_DRAIN_TIMEOUT_S"
# Inside the orchestrator's grace period (60 s on the model tier) less the
# pre-stop sleep, so the drain finishes before the kill.
DEFAULT_DRAIN_TIMEOUT_S = 25.0
DRAIN_RETRY_AFTER_S = 1.0  # "come back through a replica that is not stopping"

# The AIMD bands, as fractions of the deadline budget spent by the time the
# ticket is released: above CONGESTION a completion counts as congestion
# (the next request one slot further back will miss); below HEADROOM it
# earns an increase; between the two the limit holds.
LATENCY_CONGESTION_FRACTION = 0.5
LATENCY_HEADROOM_FRACTION = 0.25


def admission_enabled(explicit: bool | None = None) -> bool:
    """An explicit argument, else ``$KDLT_ADMISSION``, else on."""
    if explicit is not None:
        return bool(explicit)
    return os.environ.get(ADMISSION_ENV, "").strip().lower() not in ("0", "false", "off", "no")


class Ticket:
    """Proof of admission, released exactly once (in a ``finally``).

    ``mark_overloaded()`` before the release feeds the limiter's decrease:
    the handler met congestion (a deadline miss, a full batcher queue)
    while holding the slot.  A release that finds more than
    LATENCY_CONGESTION_FRACTION of the budget spent counts the same way.
    """

    __slots__ = ("_controller", "queue_wait_s", "_deadline", "_overloaded", "_released",
                 "model", "_t0")

    def __init__(self, controller: "AdmissionController", queue_wait_s: float,
                 deadline: Deadline | None = None, model: str | None = None):
        self._controller = controller
        self.queue_wait_s = queue_wait_s
        self._deadline = deadline
        self._overloaded = False
        self._released = False
        self.model = model
        self._t0 = time.monotonic()

    def mark_overloaded(self) -> None:
        self._overloaded = True

    def release(self) -> None:
        if self._released:
            return
        self._released = True
        overloaded, headroom = self._overloaded, True
        if self._deadline is not None:
            spent = 1.0 - self._deadline.remaining_s() / max(self._deadline.budget_s, 1e-9)
            overloaded = overloaded or spent > LATENCY_CONGESTION_FRACTION
            headroom = spent < LATENCY_HEADROOM_FRACTION
        self._controller._release(self.queue_wait_s, overloaded, headroom, model=self.model,
                                  held_s=time.monotonic() - self._t0)


class AdmissionController:
    def __init__(self, registry: metrics_lib.Registry, tier: str,
                 enabled: bool | None = None, limiter: AdaptiveLimiter | None = None):
        self.tier = tier
        self.enabled = admission_enabled(enabled)
        self._limiter = limiter if limiter is not None else (
            AdaptiveLimiter() if self.enabled else None)
        self._tier_registry = registry.with_labels(tier=tier)
        self._m = metrics_lib.admission_metrics(self._tier_registry)
        self._class_m = metrics_lib.admission_class_metrics(self._tier_registry)
        # Per-model slices, made on first use for each model name a handler
        # passes, at most MODEL_LABEL_CAP of them (then the overflow value).
        self._model_m: dict[str, dict] = {}  # guarded-by: _model_m_lock
        self._model_m_lock = threading.Lock()
        if self._limiter is not None:
            self._m["limit"].set(self._limiter.limit)
        self._lock = threading.Lock()
        self._idle = threading.Condition(self._lock)
        self._inflight = 0  # guarded-by: _lock
        # One-way flag (False -> True): admit() reads it without the lock; a
        # request racing the flip is ordered either way.
        self._draining = False

    @property
    def draining(self) -> bool:
        return self._draining

    @property
    def inflight(self) -> int:
        with self._lock:
            return self._inflight

    @property
    def limit(self) -> float | None:
        return self._limiter.limit if self._limiter is not None else None

    @property
    def limiter(self) -> AdaptiveLimiter | None:
        return self._limiter

    def retry_after_s(self, fallback: float = 0.05) -> float:
        """A live Retry-After for a shed decided outside the limiter: the
        limiter's derived (jittered) hint when there is one, else
        ``fallback``."""
        if self._limiter is not None:
            return self._limiter.retry_after_s()
        return fallback

    def _model_metrics(self, model: str | None) -> dict | None:
        if model is None:
            return None
        with self._model_m_lock:
            if model not in self._model_m and len(self._model_m) >= metrics_lib.MODEL_LABEL_CAP:
                model = metrics_lib.MODEL_LABEL_OVERFLOW
            if model not in self._model_m:
                self._model_m[model] = metrics_lib.admission_model_metrics(
                    self._tier_registry, model)
            return self._model_m[model]

    def admit(self, deadline: Deadline | None = None, model: str | None = None,
              priority: str = DEFAULT_PRIORITY) -> Ticket:
        """Admit or raise Shed.  Order: drain, deadline, concurrency.

        ``model`` (a registered model's name) keys the per-model slice of
        the series and the limiter's budget; ``priority`` (normalized by
        ``protocol.parse_priority``) orders queue grants and eviction.
        """
        mm = self._model_metrics(model)
        self._m["requests"].inc()
        if mm is not None:
            mm["requests"].inc()
        if self._draining:
            self._shed(Shed("draining", 503, retry_after_s=DRAIN_RETRY_AFTER_S,
                            detail=f"{self.tier} is draining for shutdown"), priority)
        if self.enabled and deadline is not None and deadline.expired:
            self._shed(Shed("deadline_exhausted", 504, detail=(
                f"deadline budget exhausted before execution "
                f"({deadline.budget_s * 1e3:.0f}ms budget)")), priority)
        queue_wait = 0.0
        if self._limiter is not None:
            budget = deadline.remaining_s() if deadline is not None else None
            try:
                queue_wait = self._limiter.acquire(budget, model=model, priority=priority)
            except Shed as e:
                self._shed(e, priority)
            self._m["limit"].set(self._limiter.limit)
        self._m["queue_wait"].observe(queue_wait)
        if deadline is not None:
            self._m["deadline_remaining_ms"].observe(max(deadline.remaining_ms(), 0.0))
        self._m["admitted"].inc()
        if mm is not None:
            mm["admitted"].inc()
        cm = self._class_m.get(priority)
        if cm is not None:
            cm["admitted"].inc()
        with self._lock:
            self._inflight += 1
            self._m["inflight"].set(float(self._inflight))
        return Ticket(self, queue_wait, deadline if self.enabled else None, model=model)

    def _shed(self, e: Shed, priority: str | None = None) -> None:
        counter = self._m["shed"].get(e.reason)
        if counter is not None:
            counter.inc()
        cm = self._class_m.get(priority) if priority is not None else None
        if cm is not None:
            cm["shed"].inc()
        raise e

    def count_shed(self, reason: str, priority: str | None = None) -> None:
        """Record a shed decided outside ``admit()``: the gateway's circuit
        breaker refusing the upstream call, or a coalesced follower whose
        own budget ran out."""
        counter = self._m["shed"].get(reason)
        if counter is not None:
            counter.inc()
        cm = self._class_m.get(priority) if priority is not None else None
        if cm is not None:
            cm["shed"].inc()

    def class_stats(self) -> dict:
        """Per-priority-class admitted/shed counts."""
        return {cls: {"admitted": m["admitted"].value, "shed": m["shed"].value}
                for cls, m in self._class_m.items()}

    def count_coalesced(self, model: str | None = None) -> None:
        """Record a cache-coalesced follower: admitted but not dispatched.
        It is served (through the leader's flight), so it counts as seen
        and admitted, but it takes no limiter slot and no in-flight entry:
        the leader alone holds the tier's capacity for the flight."""
        mm = self._model_metrics(model)
        self._m["requests"].inc()
        self._m["admitted"].inc()
        if mm is not None:
            mm["requests"].inc()
            mm["admitted"].inc()

    def _release(self, queue_wait_s: float, overloaded: bool, headroom: bool,
                 model: str | None = None, held_s: float | None = None) -> None:
        if self._limiter is not None:
            self._limiter.release(queue_wait_s, overloaded=overloaded, headroom=headroom,
                                  model=model, held_s=held_s)
            self._m["limit"].set(self._limiter.limit)
        with self._lock:
            self._inflight = max(0, self._inflight - 1)
            self._m["inflight"].set(float(self._inflight))
            self._idle.notify_all()

    # --- graceful drain -------------------------------------------------------

    def begin_drain(self) -> None:
        """Stop admitting: every new request sheds "draining" and /readyz
        answers 503; admitted work runs to completion."""
        self._draining = True
        self._m["draining"].set(1.0)

    def wait_idle(self, timeout_s: float | None = None) -> bool:
        """Block until every admitted request has released (True) or the
        timeout passes (False)."""
        if timeout_s is None:
            timeout_s = drain_timeout_s()
        giveup = time.monotonic() + timeout_s
        with self._lock:
            while self._inflight > 0:
                remaining = giveup - time.monotonic()
                if remaining <= 0:
                    return False
                self._idle.wait(remaining)
        return True


def drain_timeout_s() -> float:
    raw = os.environ.get(DRAIN_TIMEOUT_ENV, "")
    try:
        return float(raw) if raw.strip() else DEFAULT_DRAIN_TIMEOUT_S
    except ValueError:
        return DEFAULT_DRAIN_TIMEOUT_S


def install_sigterm_drain(controller: AdmissionController, stop, timeout_s=None) -> None:
    """SIGTERM -> graceful drain -> ``stop()``.

    The handler flips drain at once (readiness fails, admission sheds) and
    hands the bounded wait for idle and the final ``stop()`` to a daemon
    thread: a signal handler runs between bytecodes of the main thread and
    must not block there.  The drain budget (``$KDLT_DRAIN_TIMEOUT_S``, 25 s
    by default) fits inside the orchestrator's grace period.
    """

    def _finish():
        controller.wait_idle(timeout_s)
        stop()

    def _handler(signum, frame):  # noqa: ARG001 - signal signature
        controller.begin_drain()
        threading.Thread(target=_finish, name="kdlt-drain", daemon=True).start()

    signal.signal(signal.SIGTERM, _handler)
