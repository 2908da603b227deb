"""Propagated deadline budgets: one clock from the client's edge to the batcher.

The port's copy of the JAX package's ``serving/admission/deadline.py``.  A
request carries its REMAINING budget in ``X-Request-Deadline-Ms`` (the JAX
gateway sends it on every upstream call); the model server turns it into
an absolute monotonic deadline, rejects an exhausted one before it touches
the device, and bounds every wait below (the batcher's, the chunk
futures') by what is left, so a request never holds a handler thread or a
batch slot after its caller has given up.

An absent or unparsable header falls back to the default budget
(``KDLT_ADMISSION_DEFAULT_DEADLINE_MS``, 20 s: the reference's gRPC
deadline); a client's value is capped (``KDLT_ADMISSION_MAX_DEADLINE_MS``,
300 s) so a hostile header cannot pin server resources.
"""

from __future__ import annotations

import math
import os
import time

DEADLINE_HEADER = "X-Request-Deadline-Ms"
WSGI_DEADLINE_KEY = "HTTP_X_REQUEST_DEADLINE_MS"  # the header's WSGI environ key

DEFAULT_DEADLINE_MS_ENV = "KDLT_ADMISSION_DEFAULT_DEADLINE_MS"
MAX_DEADLINE_MS_ENV = "KDLT_ADMISSION_MAX_DEADLINE_MS"
DEFAULT_DEADLINE_MS = 20_000.0
MAX_DEADLINE_MS = 300_000.0


def _env_ms(name: str, default: float) -> float:
    raw = os.environ.get(name, "")
    try:
        return float(raw) if raw.strip() else default
    except ValueError:
        return default


class Deadline:
    """An absolute monotonic deadline, made from a remaining-ms budget:
    absolute inside the process (time spent anywhere is charged against
    it), relative on the wire (clock skew between tiers cannot corrupt it)."""

    __slots__ = ("budget_s", "_deadline")

    def __init__(self, budget_s: float, now: float | None = None):
        self.budget_s = budget_s
        self._deadline = (time.monotonic() if now is None else now) + budget_s

    @classmethod
    def default(cls) -> "Deadline":
        return cls(_env_ms(DEFAULT_DEADLINE_MS_ENV, DEFAULT_DEADLINE_MS) / 1e3)

    @classmethod
    def from_header(cls, raw: str | None) -> "Deadline":
        """Parse ``X-Request-Deadline-Ms``: absent or garbage -> the default
        budget, an oversized value capped, a non-positive one an already
        exhausted deadline (the sender spent the budget upstream)."""
        if raw is None or not str(raw).strip():
            return cls.default()
        try:
            ms = float(raw)
        except (TypeError, ValueError):
            return cls.default()
        if not math.isfinite(ms):
            # "nan" parses but slides through min()/max(): a deadline that
            # never expires and defeats the cap.  Garbage -> the default.
            return cls.default()
        ms = min(ms, _env_ms(MAX_DEADLINE_MS_ENV, MAX_DEADLINE_MS))
        return cls(max(ms, 0.0) / 1e3)

    def remaining_s(self) -> float:
        return self._deadline - time.monotonic()

    def remaining_ms(self) -> float:
        return self.remaining_s() * 1e3

    @property
    def expired(self) -> bool:
        return self.remaining_s() <= 0.0

    def header_value(self) -> str:
        """The remaining budget as the wire header's value (measured now)."""
        return f"{max(self.remaining_ms(), 0.0):.1f}"

    def clamp(self, timeout_s: float, floor_s: float = 0.001) -> float:
        """``timeout_s`` shrunk to the remaining budget, never below
        ``floor_s`` (a zero or negative timeout means "wait forever" or
        raises, and neither is "fail fast")."""
        return max(floor_s, min(timeout_s, self.remaining_s()))
