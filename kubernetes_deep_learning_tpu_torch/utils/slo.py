"""Per-model SLO accounting: sliding windows, multi-window burn rates.

The port's copy of the JAX package's ``utils/slo.py``.  Admission and the
scheduler *enforce* deadlines (admission sheds what cannot finish, the
scheduler orders by effective deadline); this module is the layer that
*reports* whether any model is actually meeting its objective -- the
signal an autoscaler, an alert, or an operator consumes.
The methodology is the SRE-workbook multi-window burn rate (Beyer et al.,
"The Site Reliability Workbook", ch. 5): against a configured target
fraction of in-deadline completions (``KDLT_SLO_TARGET``), each model's
**burn rate** is how fast it is consuming its error budget::

    burn_rate(w) = bad_fraction(w) / (1 - target)

1.0 means burning exactly at the sustainable rate; 14.4 over 5 m means the
30-day budget would be gone in ~2 days (the classic page threshold).  Two
windows (5 m and 1 h) are tracked so a burst and a slow leak are both
visible, and alerts can require BOTH to fire (fast window for reaction
time, slow window to de-bounce).

Outcome classes, decided at the same boundary as the existing
``kdlt_admission_*`` / request-latency series (the handler's finally
block, so the numbers reconcile against those counters):

- ``good``   -- 200 inside its deadline budget (and the optional
  ``KDLT_SLO_LATENCY_MS`` latency objective);
- ``late``   -- 200, but the deadline budget or latency objective was
  violated by completion time (delivered, but not goodput);
- ``shed``   -- 503/504: the tier refused it (admission, overload, drain);
- ``error``  -- 5xx/connection failure: the serving path broke it;
- ``client`` -- 4xx: the caller's fault, excluded from the SLO entirely
  (standard practice: a bad URL must not page the serving on-call).

Events land in per-second bins per model (bounded memory: one small count
row per second per model, pruned past the widest window), so record() is
O(1) on the hot path and a snapshot is a short sum.  Gauges
(``kdlt_slo_*``, minted centrally in utils.metrics) are refreshed on
scrape; ``/debug/slo`` serves the same snapshot as JSON, and the JAX
gateway's endpoint merges every model-tier replica's view
(``merge_model_views``).
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque

from kubernetes_deep_learning_tpu_torch.utils import metrics as metrics_lib

SLO_ENABLED_ENV = "KDLT_SLO"
SLO_TARGET_ENV = "KDLT_SLO_TARGET"
SLO_LATENCY_MS_ENV = "KDLT_SLO_LATENCY_MS"
DEFAULT_SLO_TARGET = 0.99

# (label, seconds): the multi-window pair.  5 m is the reaction-time window
# (a burst shows within minutes), 1 h the de-bounce window (a blip that
# stopped does not keep paging).  The labels are the bounded ``window``
# label values on every kdlt_slo_* gauge.
WINDOWS = (("5m", 300.0), ("1h", 3600.0))

# Bin columns, in storage order.
_COLS = ("total", "good", "late", "shed", "error", "client")
_COL_IDX = {c: i for i, c in enumerate(_COLS)}


def slo_enabled(explicit: bool | None = None) -> bool:
    """Explicit arg > $KDLT_SLO > enabled-by-default (the layer is the
    point of this subsystem; the env kill switch exists for overhead A/Bs
    and emergencies)."""
    if explicit is not None:
        return bool(explicit)
    raw = os.environ.get(SLO_ENABLED_ENV, "").strip().lower()
    return raw not in ("0", "false", "off", "no")


def resolve_target(explicit: float | None = None) -> float:
    """Explicit arg > $KDLT_SLO_TARGET > 0.99, clamped to (0, 1): a target
    of 1.0 would make every burn rate infinite (zero error budget), and a
    malformed env value degrades to the default rather than killing
    serving."""
    target = explicit
    if target is None:
        raw = os.environ.get(SLO_TARGET_ENV, "").strip()
        try:
            target = float(raw) if raw else DEFAULT_SLO_TARGET
        except ValueError:
            target = DEFAULT_SLO_TARGET
    return min(max(float(target), 1e-6), 1.0 - 1e-6)


def resolve_latency_objective_ms(explicit: float | None = None) -> float | None:
    """Optional per-request latency objective (ms).  None = deadline-only
    accounting (requests without a deadline budget are good unless shed or
    errored)."""
    if explicit is not None:
        return float(explicit)
    raw = os.environ.get(SLO_LATENCY_MS_ENV, "").strip()
    if not raw:
        return None
    try:
        value = float(raw)
    except ValueError:
        return None
    return value if value > 0 else None


def classify(status: int, deadline_exceeded: bool,
             latency_violated: bool = False) -> str:
    """Map one finished request to its outcome class (module docstring)."""
    if status == 200:
        return "late" if (deadline_exceeded or latency_violated) else "good"
    if status in (503, 504):
        return "shed"
    if 400 <= status < 500:
        return "client"
    return "error"


def derive(counts: dict, target: float) -> dict:
    """The per-window derived figures from one raw count row.

    An empty window reports goodput 1.0 / burn 0.0 (nothing happened, so
    nothing burned) -- the quiet state an alert must not fire on.
    """
    counted = counts["total"] - counts["client"]
    if counted <= 0:
        ratios = {"goodput_ratio": 1.0, "burn_rate": 0.0,
                  "shed_ratio": 0.0, "error_ratio": 0.0}
    else:
        good = counts["good"] / counted
        ratios = {
            "goodput_ratio": round(good, 6),
            "burn_rate": round((1.0 - good) / (1.0 - target), 4),
            "shed_ratio": round(counts["shed"] / counted, 6),
            "error_ratio": round(counts["error"] / counted, 6),
        }
    return {**counts, **ratios}


def merge_model_views(views: list[dict], target: float) -> dict:
    """Sum several tiers'/replicas' per-model raw counts and re-derive the
    ratios -- the gateway's fleet-wide view.  Each ``views`` entry is a
    snapshot's ``models`` dict ({model: {window: row}})."""
    merged: dict[str, dict[str, dict]] = {}
    for view in views:
        for model, windows in (view or {}).items():
            dst = merged.setdefault(model, {})
            for window, row in windows.items():
                cell = dst.setdefault(window, {c: 0 for c in _COLS})
                for c in _COLS:
                    cell[c] += int(row.get(c, 0))
    return {
        model: {w: derive(cell, target) for w, cell in windows.items()}
        for model, windows in merged.items()
    }


class SloEngine:
    """One tier's SLO accountant: record() on the hot path, refresh() on
    scrape, snapshot() for /debug/slo.

    ``clock`` is injectable (tests drive synthetic request streams through
    hours of window time without sleeping); it must be monotonic.
    """

    def __init__(
        self,
        registry: metrics_lib.Registry,
        tier: str,
        enabled: bool | None = None,
        target: float | None = None,
        latency_objective_ms: float | None = None,
        windows=WINDOWS,
        clock=time.monotonic,
    ):
        self.tier = tier
        self.enabled = slo_enabled(enabled)
        self.target = resolve_target(target)
        self.latency_objective_ms = resolve_latency_objective_ms(
            latency_objective_ms
        )
        self.windows = tuple(windows)
        self._max_window_s = max(s for _, s in self.windows)
        self._clock = clock
        self._lock = threading.Lock()
        # model -> deque of [bin_second, c_total, c_good, ...]; bins append
        # at the right, prune from the left past the widest window.
        self._bins: dict[str, deque] = {}
        self._registry = registry.with_labels(tier=tier)
        self._gauges: dict[tuple[str, str], dict] = {}
        if self.enabled:
            self._m = metrics_lib.slo_tier_metrics(self._registry)
            self._m["target"].set(self.target)

    # --- hot path -----------------------------------------------------------

    def record(
        self,
        model: str,
        status: int,
        latency_s: float,
        deadline_exceeded: bool = False,
    ) -> None:
        """Account one finished request.  Call from the handler's finally
        block -- the same boundary as the tier's request-latency histogram,
        so /debug/slo reconciles against /metrics."""
        if not self.enabled or not model:
            return
        violated = (
            self.latency_objective_ms is not None
            and latency_s * 1e3 > self.latency_objective_ms
        )
        outcome = classify(status, deadline_exceeded, violated)
        now_bin = int(self._clock())
        with self._lock:
            bins = self._bins.get(model)
            if bins is None:
                bins = self._bins[model] = deque()
            if not bins or bins[-1][0] != now_bin:
                bins.append([now_bin] + [0] * len(_COLS))
                # Prune past the widest window (+2 s slack for bin edges).
                horizon = now_bin - self._max_window_s - 2
                while bins and bins[0][0] < horizon:
                    bins.popleft()
            row = bins[-1]
            row[1 + _COL_IDX["total"]] += 1
            row[1 + _COL_IDX[outcome]] += 1

    # --- snapshots ----------------------------------------------------------

    def _window_counts(self, bins, now: float, window_s: float) -> dict:
        cutoff = now - window_s
        counts = [0] * len(_COLS)
        for row in reversed(bins):
            if row[0] < cutoff:
                break
            for i in range(len(_COLS)):
                counts[i] += row[1 + i]
        return dict(zip(_COLS, counts))

    def model_windows(self) -> dict[str, dict[str, dict]]:
        """{model: {window_label: derived row}} over the live bins."""
        now = self._clock()
        with self._lock:
            models = {m: list(b) for m, b in self._bins.items()}
        return {
            model: {
                label: derive(self._window_counts(bins, now, seconds),
                              self.target)
                for label, seconds in self.windows
            }
            for model, bins in models.items()
        }

    def refresh(self) -> dict:
        """Recompute every (model, window) cell and push it into the
        kdlt_slo_* gauges; returns the snapshot.  Called on scrape
        (/metrics) and on /debug/slo -- the gauges are as fresh as the last
        read, which is exactly a pull-model scraper's contract."""
        if not self.enabled:
            return {}
        per_model = self.model_windows()
        for model, windows in per_model.items():
            for window, row in windows.items():
                key = (model, window)
                gauges = self._gauges.get(key)
                if gauges is None:
                    gauges = metrics_lib.slo_model_window_metrics(
                        self._registry, model, window
                    )
                    self._gauges[key] = gauges
                gauges["goodput_ratio"].set(row["goodput_ratio"])
                gauges["burn_rate"].set(row["burn_rate"])
                gauges["shed_ratio"].set(row["shed_ratio"])
                gauges["error_ratio"].set(row["error_ratio"])
                gauges["requests"].set(
                    float(row["total"] - row["client"])
                )
        return per_model

    def debug_payload(self) -> dict:
        """The /debug/slo JSON body for this tier."""
        payload = {
            "tier": self.tier,
            "enabled": self.enabled,
            "target": self.target,
            "latency_objective_ms": self.latency_objective_ms,
            "windows": [label for label, _ in self.windows],
        }
        if self.enabled:
            payload["models"] = self.refresh()
        return payload
