"""Adaptive concurrency limiter with a bounded admission queue (AIMD),
per-model budgets and priority classes.

The port's copy of the JAX package's ``serving/admission/limiter.py``, with
the same environment variables, defaults and decisions.  The limiter
learns the sustainable concurrency the way TCP learns a path's bandwidth:

- **Additive increase**: every clean completion grows the limit by
  ``1/limit`` (about +1 per round of in-flight completions).
- **Multiplicative decrease**: an overload signal -- the caller saw a
  deadline miss or a full downstream queue while holding the slot
  (``Ticket.mark_overloaded``), or the admission-queue wait exceeded an
  explicit target (``KDLT_ADMISSION_TARGET_QUEUE_MS``, off by default) --
  shrinks the limit by ``decrease`` (x0.9), at most once per
  ``cooldown_s``, so one burst of misses counts as one congestion event.

The limit is partitioned into per-model budgets (``KDLT_ADMIT_BUDGETS``;
its weights default to ``KDLT_SCHED_WEIGHTS``, as in JAX): a model's share
is ``limit * w_m / sum(w of the ACTIVE models)``, so a single-model tier's
share is the whole limit, and a model past its share may still borrow
slots nobody waits for.  Grants go to under-share waiters first, then the
higher priority class, then FIFO; at the waiter cap the evicted victim is
the most over-share waiter, then the lowest class, then the youngest.

A request past the limit waits in a bounded queue, but at most
``queue_wait_fraction`` (a quarter) of its remaining budget, so an
admitted request keeps the bulk of its budget for execution.  Past the
waiter cap or the wait bound it sheds with a reason of its own.

``Retry-After`` hints come from live state -- the waiters ahead of a
retry times the observed slot-hold EWMA over the limit -- with +-25%
jitter, so a herd of retriers decorrelates.  The jitter's randomness is
the ``rng`` a caller passes (a ``random.Random``), by default the
``random`` module's.
"""

from __future__ import annotations

import os
import random
import threading
import time

from kubernetes_deep_learning_tpu_torch.serving.admission.shed import Shed
from kubernetes_deep_learning_tpu_torch.serving.protocol import DEFAULT_PRIORITY, PRIORITY_RANK

MAX_CONCURRENCY_ENV = "KDLT_ADMISSION_MAX_CONCURRENCY"
MIN_CONCURRENCY_ENV = "KDLT_ADMISSION_MIN_CONCURRENCY"
INITIAL_CONCURRENCY_ENV = "KDLT_ADMISSION_INITIAL_CONCURRENCY"
QUEUE_CAP_ENV = "KDLT_ADMISSION_QUEUE_CAP"
TARGET_QUEUE_MS_ENV = "KDLT_ADMISSION_TARGET_QUEUE_MS"
MAX_QUEUE_WAIT_MS_ENV = "KDLT_ADMISSION_MAX_QUEUE_WAIT_MS"
# Per-model budget weights: "model=weight,..." gives explicit weights,
# "0"/"off" turns partitioning off (one shared limit), anything else --
# unset included -- takes the weights of KDLT_SCHED_WEIGHTS (1.0 a model
# by default), as the JAX package does.
BUDGETS_ENV = "KDLT_ADMIT_BUDGETS"
SCHED_WEIGHTS_ENV = "KDLT_SCHED_WEIGHTS"

_FALSY = {"0", "off", "false", "no"}
_TRUTHY = {"", "1", "on", "true", "yes", "auto"}
# Retry-After bounds: never under 50 ms (a tight loop of instant retries),
# never over 10 s (a confused EWMA must not park clients).
RETRY_AFTER_MIN_S = 0.05
RETRY_AFTER_MAX_S = 10.0
RETRY_AFTER_JITTER = 0.25
_HOLD_EWMA_ALPHA = 0.2

_ENV_SENTINEL = object()


def _env_float(name: str, default: float) -> float:
    raw = os.environ.get(name, "")
    try:
        return float(raw) if raw.strip() else default
    except ValueError:
        return default


def env_max_limit(default: float = 64.0) -> float:
    """The operator's concurrency ceiling, for callers that reconcile it
    with a floor of their own before making the limiter (the model
    server's batch-formation floor)."""
    return _env_float(MAX_CONCURRENCY_ENV, default)


def parse_budgets(raw: str | None) -> dict[str, float]:
    """"model=weight,..." -> weights (malformed entries skipped, weights
    floored at 1e-3)."""
    out: dict[str, float] = {}
    for part in (raw or "").split(","):
        name, sep, w = part.strip().partition("=")
        name = name.strip()
        if not sep or not name:
            continue
        try:
            out[name] = max(float(w), 1e-3)
        except ValueError:
            continue
    return out


def env_budgets() -> dict[str, float] | None:
    """``KDLT_ADMIT_BUDGETS``: None turns partitioning off; a dict --
    possibly empty, every model then weighing 1.0 -- turns it on."""
    raw = os.environ.get(BUDGETS_ENV, "").strip()
    if raw.lower() in _FALSY:
        return None
    if raw.lower() in _TRUTHY:
        raw = os.environ.get(SCHED_WEIGHTS_ENV, "")
    return parse_budgets(raw)


class _Waiter:
    """One queued request: its model and class, when it arrived, how it left
    the queue (granted a slot, or shed by an evictor), and the condition
    (on the limiter's lock) that wakes it, and only it."""

    __slots__ = ("model", "priority", "rank", "enq_t", "granted", "shed", "wake")

    def __init__(self, model: str | None, priority: str, enq_t: float,
                 lock: threading.Lock):
        self.model = model
        self.priority = priority
        self.rank = PRIORITY_RANK.get(priority, 0)
        self.enq_t = enq_t
        self.granted = False
        self.shed: Shed | None = None
        self.wake = threading.Condition(lock)


class AdaptiveLimiter:
    def __init__(
        self,
        min_limit: float | None = None,
        max_limit: float | None = None,
        initial: float | None = None,
        target_wait_s: float | None = None,
        queue_cap: int | None = None,
        max_queue_wait_s: float | None = None,
        queue_wait_fraction: float = 0.25,
        decrease: float = 0.9,
        cooldown_s: float = 0.1,
        budgets: dict[str, float] | None = _ENV_SENTINEL,  # type: ignore[assignment]
        rng: random.Random | None = None,
    ):
        self.min_limit = min_limit if min_limit is not None else max(
            1.0, _env_float(MIN_CONCURRENCY_ENV, 1.0))
        self.max_limit = max_limit if max_limit is not None else _env_float(
            MAX_CONCURRENCY_ENV, 64.0)
        # A floor above the ceiling would make the AIMD decrease clamp UP to
        # the floor while acquire clamps down to the ceiling: the explicit
        # floor wins.
        self.max_limit = max(self.max_limit, self.min_limit)
        self._limit = float(  # guarded-by: _lock
            initial if initial is not None else _env_float(INITIAL_CONCURRENCY_ENV, 8.0))
        self._limit = min(max(self._limit, self.min_limit), self.max_limit)
        # 0 (the default) turns the absolute queue-wait signal off: the
        # budget-relative signals adapt to each request's own deadline.
        self.target_wait_s = (target_wait_s if target_wait_s is not None
                              else _env_float(TARGET_QUEUE_MS_ENV, 0.0) / 1e3)
        self.queue_cap = int(queue_cap if queue_cap is not None
                             else _env_float(QUEUE_CAP_ENV, 128))
        # The absolute ceiling bounds a request that carries no deadline.
        self.max_queue_wait_s = (max_queue_wait_s if max_queue_wait_s is not None
                                 else _env_float(MAX_QUEUE_WAIT_MS_ENV, 10_000.0) / 1e3)
        self.queue_wait_fraction = queue_wait_fraction
        self._decrease = decrease
        self._cooldown_s = cooldown_s
        self._rng = rng
        self._last_decrease = 0.0    # guarded-by: _lock
        self._inflight = 0           # guarded-by: _lock
        self._inflight_by: dict[str, int] = {}  # guarded-by: _lock
        self._waiters: list[_Waiter] = []  # guarded-by: _lock
        # Each waiter sleeps on a condition of its own over this lock: a
        # grant or an eviction wakes the one waiter it concerns.  (The JAX
        # package wakes every waiter on each release; under the interpreter
        # lock, 128 waiters woken at ~850 releases/s take a whole core.)
        self._lock = threading.Lock()
        # Slot-hold EWMA (admit to release), behind the Retry-After hint.
        self._hold_ewma_s = 0.0      # guarded-by: _lock
        self.budgets: dict[str, float] | None = (
            env_budgets() if budgets is _ENV_SENTINEL else budgets)

    @property
    def limit(self) -> float:
        with self._lock:
            return self._limit

    @property
    def inflight(self) -> int:
        with self._lock:
            return self._inflight

    @property
    def queue_depth(self) -> int:
        with self._lock:
            return len(self._waiters)

    def _slots_full_locked(self) -> bool:
        return self._inflight >= max(1, int(self._limit))

    # --- per-model budgets -------------------------------------------------

    def _weight(self, model: str | None) -> float:
        if self.budgets is None or model is None:
            return 1.0
        return self.budgets.get(model, 1.0)

    def _active_locked(self) -> set:
        active = set(self._inflight_by)
        active.update(w.model for w in self._waiters if w.model is not None)
        return active

    def _share(self, model: str, active: set, total: float) -> float:
        """``model``'s weighted slice of the limit over the active models
        (in flight or queued; ``total`` their weight) and itself."""
        if model not in active:
            total += self._weight(model)
        return self._limit * self._weight(model) / total if total > 0 else self._limit

    def _over_share_fn_locked(self):
        """``over(model)``: whether the model holds its share or more.  The
        active set and its weight are taken once, so a decision over the
        whole queue costs one pass over it, not one a waiter (the JAX
        package's per-waiter pass holds the interpreter lock for ~1 ms a
        grant with 128 waiters)."""
        if self.budgets is None:
            return lambda model: False
        active = self._active_locked()
        total = sum(self._weight(m) for m in active)
        return lambda model: (model is not None and self._inflight_by.get(model, 0)
                              >= self._share(model, active, total))

    def _take_slot_locked(self, model: str | None) -> None:
        self._inflight += 1
        if model is not None:
            self._inflight_by[model] = self._inflight_by.get(model, 0) + 1

    def shares(self) -> dict[str, float]:
        """The active models' current budget shares."""
        with self._lock:
            if self.budgets is None:
                return {}
            active = self._active_locked()
            total = sum(self._weight(m) for m in active)
            return {m: self._share(m, active, total) for m in sorted(active)}

    # --- derived Retry-After ----------------------------------------------

    def _retry_after_locked(self) -> float:
        """The backlog's drain time: waiters ahead of a retry, served
        ``limit`` at a time, each holding a slot for the observed EWMA;
        clamped, then jittered +-25%."""
        hold = self._hold_ewma_s if self._hold_ewma_s > 0 else max(self.target_wait_s, 0.1)
        base = (len(self._waiters) + 1) / max(self._limit, 1.0) * hold
        base = min(max(base, RETRY_AFTER_MIN_S), RETRY_AFTER_MAX_S)
        rng = self._rng if self._rng is not None else random
        return base * rng.uniform(1.0 - RETRY_AFTER_JITTER, 1.0 + RETRY_AFTER_JITTER)

    def retry_after_s(self) -> float:
        with self._lock:
            return self._retry_after_locked()

    # --- queue arbitration ------------------------------------------------

    def _order_key_locked(self):
        """The queue's order: under-share waiters first, then the higher
        class, then FIFO (a grant takes the least, an eviction the most)."""
        over = self._over_share_fn_locked()
        return lambda w: (over(w.model), w.rank, w.enq_t)

    def _grant_waiters_locked(self) -> None:
        """Hand free slots to the best waiters and wake each of them."""
        while self._waiters and not self._slots_full_locked():
            w = min(self._waiters, key=self._order_key_locked())
            self._waiters.remove(w)
            w.granted = True
            self._take_slot_locked(w.model)
            w.wake.notify()

    def _evict_for_locked(self, model: str | None, rank: int) -> bool:
        """Make room at the waiter cap for a (model, rank) arrival by
        shedding the worst waiter -- most over-share, then lowest class,
        then youngest -- if it is strictly worse than the newcomer.  False
        when the newcomer is the worst (it sheds ``queue_full``)."""
        if not self._waiters:
            return False
        over_share, key = self._over_share_fn_locked(), self._order_key_locked()
        victim = max(self._waiters, key=key)
        if key(victim) <= (over_share(model), rank, time.monotonic()):
            return False
        over = over_share(victim.model)
        reason = "budget_exhausted" if over else "preempted"
        victim.shed = Shed(
            reason, retry_after_s=self._retry_after_locked(),
            detail=(f"evicted from the admission queue by a "
                    f"{'under-budget' if over else 'higher-class'} arrival "
                    f"(model={victim.model!r}, class={victim.priority})"))
        self._waiters.remove(victim)
        victim.wake.notify()
        return True

    def acquire(self, budget_s: float | None = None, model: str | None = None,
                priority: str = DEFAULT_PRIORITY) -> float:
        """Take a concurrency slot; returns the queue wait in seconds.

        ``budget_s`` is the request's remaining deadline: the wait is at
        most ``queue_wait_fraction`` of it (and ``max_queue_wait_s``).
        Raises Shed("queue_full") at the waiter cap with nobody worse to
        evict, Shed("budget_exhausted"/"preempted") when evicted, and
        Shed("queue_timeout") when no slot frees inside the bound.
        """
        rank = PRIORITY_RANK.get(priority, 0)
        with self._lock:
            if not self._slots_full_locked() and not self._waiters:
                # A free slot and no queue: take it (an over-share model
                # borrows capacity nobody waits for).
                self._take_slot_locked(model)
                return 0.0
            if len(self._waiters) >= self.queue_cap and not self._evict_for_locked(model, rank):
                raise Shed(
                    "queue_full", retry_after_s=self._retry_after_locked(),
                    detail=(f"admission queue at its {self.queue_cap}-waiter cap with no "
                            f"lower-class or over-budget waiter to evict"))
            bound = self.max_queue_wait_s
            if budget_s is not None:
                bound = min(bound, max(0.0, budget_s) * self.queue_wait_fraction)
            t0 = time.monotonic()
            giveup = t0 + bound
            w = _Waiter(model, priority, t0, self._lock)
            self._waiters.append(w)
            # A slot may be free right now (between a grant sweep and this
            # arrival): sweep so it is taken at once.
            self._grant_waiters_locked()
            while True:
                if w.granted:
                    return time.monotonic() - t0
                if w.shed is not None:
                    raise w.shed
                remaining = giveup - time.monotonic()
                if remaining <= 0:
                    self._waiters.remove(w)
                    raise Shed(
                        "queue_timeout", retry_after_s=self._retry_after_locked(),
                        detail=(f"no concurrency slot freed within {bound * 1e3:.0f}ms "
                                f"(limit {self._limit:.1f})"))
                w.wake.wait(remaining)

    def release(self, queue_wait_s: float = 0.0, overloaded: bool = False,
                headroom: bool = True, model: str | None = None,
                held_s: float | None = None) -> None:
        """Free the slot and feed the AIMD controller.

        ``overloaded`` is the caller's congestion signal (a deadline miss,
        a full queue); a queue wait above the explicit target is the local
        one.  ``headroom=False`` marks a completion that made it without
        budget to spare: it neither grows nor shrinks the limit (the hold
        band that keeps the equilibrium below the deadline).  ``held_s``
        (admit to release) feeds the Retry-After hold EWMA.
        """
        with self._lock:
            self._inflight = max(0, self._inflight - 1)
            if model is not None and model in self._inflight_by:
                left = self._inflight_by[model] - 1
                if left > 0:
                    self._inflight_by[model] = left
                else:
                    del self._inflight_by[model]
            if held_s is not None and held_s >= 0:
                self._hold_ewma_s = (
                    held_s if self._hold_ewma_s <= 0
                    else (1 - _HOLD_EWMA_ALPHA) * self._hold_ewma_s + _HOLD_EWMA_ALPHA * held_s)
            now = time.monotonic()
            if overloaded or (self.target_wait_s > 0 and queue_wait_s > self.target_wait_s):
                if now - self._last_decrease >= self._cooldown_s:
                    self._limit = max(self.min_limit, self._limit * self._decrease)
                    self._last_decrease = now
            elif headroom:
                self._limit = min(self.max_limit, self._limit + 1.0 / max(self._limit, 1.0))
            self._grant_waiters_locked()
