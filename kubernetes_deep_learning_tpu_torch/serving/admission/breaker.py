"""Circuit breaker for the gateway -> model-tier hop, with half-open probing.

The port's copy of the JAX package's ``serving/admission/breaker.py``.

When the model tier is down or persistently shedding, every gateway request
otherwise pays a full connect/read timeout against a dead upstream before
failing -- tying up gateway threads exactly when the system most needs them
free.  The breaker converts that into a fast local 503: after
``failure_threshold`` consecutive upstream failures it OPENs (all calls
refused with a Retry-After equal to the remaining cool-down), after
``reset_timeout_s`` it goes HALF_OPEN and lets ``half_open_probes`` real
requests through as probes; a probe failure re-opens, a full set of probe
successes closes.

Deliberately consecutive-failure-triggered (not a windowed error rate): the
gateway's per-request 503 retry already absorbs one-off shed responses, so
N consecutive failures genuinely means the tier is unhealthy, and the
counter resets on any success.
"""

from __future__ import annotations

import os
import threading
import time

FAILURES_ENV = "KDLT_BREAKER_FAILURES"
RESET_S_ENV = "KDLT_BREAKER_RESET_S"
PROBES_ENV = "KDLT_BREAKER_HALF_OPEN_PROBES"

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half_open"


def _env_float(name: str, default: float) -> float:
    raw = os.environ.get(name, "")
    try:
        return float(raw) if raw.strip() else default
    except ValueError:
        return default


class CircuitBreaker:
    def __init__(
        self,
        failure_threshold: int | None = None,
        reset_timeout_s: float | None = None,
        half_open_probes: int | None = None,
        clock=time.monotonic,
    ):
        # ``clock`` is injectable so state-machine tests don't sleep.
        self.failure_threshold = int(
            failure_threshold if failure_threshold is not None
            else _env_float(FAILURES_ENV, 5)
        )
        self.reset_timeout_s = (
            reset_timeout_s if reset_timeout_s is not None
            else _env_float(RESET_S_ENV, 2.0)
        )
        self.half_open_probes = int(
            half_open_probes if half_open_probes is not None
            else _env_float(PROBES_ENV, 1)
        )
        self._clock = clock
        self._lock = threading.Lock()
        self.state = CLOSED          # guarded-by: _lock
        self._consecutive_failures = 0  # guarded-by: _lock
        self._opened_at = 0.0        # guarded-by: _lock
        self._probes_issued = 0      # guarded-by: _lock
        self._probe_successes = 0    # guarded-by: _lock

    def allow(self) -> bool:
        """May a request go upstream right now?  HALF_OPEN consumes a probe
        slot per True, so callers must follow up with record_success/
        record_failure for the probe accounting to close the loop."""
        with self._lock:
            if self.state == CLOSED:
                return True
            if self.state == OPEN:
                if self._clock() - self._opened_at < self.reset_timeout_s:
                    return False
                self.state = HALF_OPEN
                self._probes_issued = 0
                self._probe_successes = 0
            # HALF_OPEN: a bounded number of live probes, everyone else sheds.
            if self._probes_issued < self.half_open_probes:
                self._probes_issued += 1
                return True
            return False

    def record_success(self) -> None:
        with self._lock:
            if self.state == HALF_OPEN:
                self._probe_successes += 1
                if self._probe_successes >= self.half_open_probes:
                    self.state = CLOSED
                    self._consecutive_failures = 0
            else:
                self._consecutive_failures = 0

    def record_failure(self) -> None:
        with self._lock:
            if self.state == HALF_OPEN:
                self._trip_locked()
                return
            self._consecutive_failures += 1
            if self.state == CLOSED and (
                self._consecutive_failures >= self.failure_threshold
            ):
                self._trip_locked()

    def _trip_locked(self) -> None:
        self.state = OPEN
        self._opened_at = self._clock()
        self._consecutive_failures = 0

    def reset(self) -> None:
        """Force CLOSED with clean counters: out-of-band recovery evidence
        (the upstream pool's active /healthz probe succeeding) supersedes
        the time-based cool-down -- failover recovery must not wait out an
        OPEN window on a replica already proven healthy."""
        with self._lock:
            self.state = CLOSED
            self._consecutive_failures = 0
            self._probes_issued = 0
            self._probe_successes = 0

    def retry_after_s(self) -> float:
        """Remaining cool-down before half-open probing (0 when not OPEN)."""
        with self._lock:
            if self.state != OPEN:
                return 0.0
            return max(0.0, self._opened_at + self.reset_timeout_s - self._clock())
