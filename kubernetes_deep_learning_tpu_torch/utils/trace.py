"""Dapper-style per-request span tracing for the serving path.

The port's copy of the JAX package's ``utils/trace.py``: the same header
names, span vocabulary, retention classes and ``/debug/trace/<rid>``
payload, so the JAX gateway merges this tier's spans into its waterfall
unchanged.  Aggregate histograms (utils.metrics) answer "how slow is the
fleet"; they cannot answer "where did THIS request's 480 ms go" -- the
question tail debugging actually asks (Sigelman et al. 2010; Dean &
Barroso, "The Tail at Scale", 2013).  This module is the in-process
tracing core:

- a **trace id** rides the existing ``X-Request-Id`` propagation path (the
  sanitized request id IS the trace id -- one grep key for logs, headers,
  and traces);
- each tier records **spans** (name, start, duration, parent span id,
  tags) into a bounded in-process ring buffer (:class:`Tracer`), exposed
  at ``/debug/trace/<rid>``;
- the **parent span id** crosses tier boundaries in the
  ``X-Kdlt-Parent-Span`` header (gRPC: ``x-kdlt-parent-span`` metadata),
  so the model tier's spans nest under the exact gateway upstream attempt
  that carried them -- a hedged request shows BOTH attempts, each with its
  own subtree;
- every response carries a ``Server-Timing``-style ``X-Kdlt-Trace``
  summary header, so a curl sees the per-tier breakdown without a second
  round trip.

Timestamps come from one wall-anchored monotonic clock per process
(``now_s``): spans recorded by different threads of one process can never
be reordered by wall-clock steps, so child intervals derived from shared
perf-counter boundaries (the dispatcher's pipeline stages) are exactly
non-overlapping in the waterfall.
"""

from __future__ import annotations

import random
import re
import threading
import time
from collections import OrderedDict
from contextlib import contextmanager

from kubernetes_deep_learning_tpu_torch.utils import metrics as metrics_lib

# Response header: Server-Timing-style per-tier span summary.
TRACE_HEADER = "X-Kdlt-Trace"
# Request header: the caller's active span id, which becomes the parent of
# this tier's root span.  Rides next to X-Request-Id (the trace id).
PARENT_SPAN_HEADER = "X-Kdlt-Parent-Span"
GRPC_PARENT_SPAN_KEY = "x-kdlt-parent-span"  # gRPC metadata keys are lowercase

_SPAN_ID_RE = re.compile(r"[^A-Za-z0-9]")

# --- span-name vocabulary ---------------------------------------------------
# The single source of truth for every span name the tree records.  The
# waterfall renderers, the Server-Timing summary header, and the trace
# tooling all key on these exact strings, so the set is CLOSED and equal to
# the JAX package's (its gateway merges both tiers by these names): the
# gateway's, the generative lane's and the cross-host spans stay in it
# though this package records none of them.
SPAN_GATEWAY_REQUEST = "gateway.request"
SPAN_GATEWAY_ADMISSION = "gateway.admission"
SPAN_GATEWAY_PREPROCESS = "gateway.preprocess"
SPAN_GATEWAY_MICROBATCH = "gateway.microbatch"
SPAN_GATEWAY_CACHE = "gateway.cache"
SPAN_GATEWAY_UPSTREAM = "gateway.upstream"
SPAN_SERVER_REQUEST = "server.request"
SPAN_SERVER_ADMISSION = "server.admission"
SPAN_SERVER_DECODE = "server.decode"
# Raw-bytes ingest wire: the model tier's image-decode stage (JPEG/PNG
# decode + resize of the blobs a bytes-wire request carried).
SPAN_SERVER_INGEST_DECODE = "server.ingest_decode"
SPAN_SERVER_PREDICT = "server.predict"
SPAN_ENGINE_PREDICT = "engine.predict"
SPAN_BATCHER_QUEUE_WAIT = "batcher.queue_wait"
SPAN_BATCHER_WAIT = "batcher.wait"
SPAN_PIPELINE_ENQUEUE_WAIT = "pipeline.enqueue_wait"
SPAN_PIPELINE_DISPATCH = "pipeline.dispatch"
SPAN_PIPELINE_EXECUTE = "pipeline.execute"
SPAN_PIPELINE_READBACK = "pipeline.readback"
SPAN_CROSSHOST_BROADCAST = "crosshost.broadcast"
SPAN_CROSSHOST_COLLECTIVE = "crosshost.collective"
SPAN_CROSSHOST_GATHER = "crosshost.gather"
# Generative (decode) lane: the gateway proxy span, the model tier's
# handler span, and the decode engine's internal stages.  first_token
# covers admission-to-first-emission (the TTFT interval as the server saw
# it); stream covers the remainder of the token loop.
SPAN_GATEWAY_GENERATE = "gateway.generate"
SPAN_SERVER_GENERATE = "server.generate"
SPAN_DECODE_QUEUE_WAIT = "decode.queue_wait"
SPAN_DECODE_PREFILL = "decode.prefill"
SPAN_DECODE_FIRST_TOKEN = "decode.first_token"
SPAN_DECODE_STREAM = "decode.stream"

SPAN_NAMES = frozenset({
    SPAN_GATEWAY_REQUEST,
    SPAN_GATEWAY_ADMISSION,
    SPAN_GATEWAY_PREPROCESS,
    SPAN_GATEWAY_MICROBATCH,
    SPAN_GATEWAY_CACHE,
    SPAN_GATEWAY_UPSTREAM,
    SPAN_SERVER_REQUEST,
    SPAN_SERVER_ADMISSION,
    SPAN_SERVER_DECODE,
    SPAN_SERVER_INGEST_DECODE,
    SPAN_SERVER_PREDICT,
    SPAN_ENGINE_PREDICT,
    SPAN_BATCHER_QUEUE_WAIT,
    SPAN_BATCHER_WAIT,
    SPAN_PIPELINE_ENQUEUE_WAIT,
    SPAN_PIPELINE_DISPATCH,
    SPAN_PIPELINE_EXECUTE,
    SPAN_PIPELINE_READBACK,
    SPAN_CROSSHOST_BROADCAST,
    SPAN_CROSSHOST_COLLECTIVE,
    SPAN_CROSSHOST_GATHER,
    SPAN_GATEWAY_GENERATE,
    SPAN_SERVER_GENERATE,
    SPAN_DECODE_QUEUE_WAIT,
    SPAN_DECODE_PREFILL,
    SPAN_DECODE_FIRST_TOKEN,
    SPAN_DECODE_STREAM,
})

# One wall-anchored monotonic clock per process: perf_counter deltas on a
# wall-time anchor.  time.time() alone can step (NTP) mid-request, which
# would fabricate overlapping/negative child intervals.
_WALL0 = time.time()
_PERF0 = time.perf_counter()


def now_s() -> float:
    """Current wall time on the process's monotonic-anchored clock."""
    return _WALL0 + (time.perf_counter() - _PERF0)


def new_span_id() -> str:
    """8 hex characters (the JAX package's format).  From the process's
    PRNG rather than a uuid4, which reads the OS's entropy once a span:
    ids need only be unique within a trace, and a request records ten."""
    return f"{random.getrandbits(32):08x}"


def ensure_span_id(raw: str | None) -> str | None:
    """Sanitized inbound parent span id, or None (same hostile-header
    posture as tracing.ensure_request_id: a client-chosen value must not
    inject header or log structure)."""
    if not raw:
        return None
    sid = _SPAN_ID_RE.sub("", raw)[:32]
    return sid or None


class Span:
    """One recorded interval; mutable tags so e.g. a hedge winner can be
    marked after its attempt span was already recorded."""

    __slots__ = ("trace_id", "span_id", "parent_id", "name", "tier",
                 "start_s", "dur_s", "tags")

    def __init__(self, trace_id, span_id, parent_id, name, tier,
                 start_s, dur_s, tags=None):
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.name = name
        self.tier = tier
        self.start_s = start_s
        self.dur_s = dur_s
        self.tags = dict(tags or {})

    @property
    def end_s(self) -> float:
        return self.start_s + self.dur_s

    def to_dict(self) -> dict:
        return {
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "name": self.name,
            "tier": self.tier,
            "start_s": round(self.start_s, 6),
            "dur_ms": round(self.dur_s * 1e3, 3),
            "tags": {k: v for k, v in self.tags.items()},
        }


# Retention classes, most-protected first.  Eviction walks the ring oldest
# first but skips protected traces while any routine one remains: the
# traces tail debugging actually needs (errors, sheds, deadline misses, the
# slowest percentile) outlive the routine churn around them.  ``incident``
# outranks everything: the flight recorder (utils/flightrecorder.py) pins a
# captured bundle's causal traces so they survive until an operator reads
# the bundle -- an evicted trace would leave the bundle's trace ids dangling.
RETENTION_PRIORITY = {
    "incident": 5, "error": 4, "shed": 3, "deadline": 2, "slow": 1,
    "routine": 0,
}


def retention_class(status: int, deadline_exceeded: bool = False,
                    slow: bool = False) -> str:
    """A finished request's retention class from its observable outcome
    (shared by both tiers so the classes mean the same thing fleet-wide)."""
    if status in (503, 504):
        return "shed"
    if status < 0 or status >= 500:
        return "error"
    if status == 200 and deadline_exceeded:
        return "deadline"
    if slow:
        return "slow"
    return "routine"


class _TraceEntry:
    __slots__ = ("spans", "cls", "dropped_spans")

    def __init__(self):
        self.spans: list[Span] = []
        self.cls: str | None = None  # None = not yet classified
        self.dropped_spans = 0


class Tracer:
    """Bounded per-tier span buffer: an OrderedDict ring of recent traces.

    Eviction is by TRACE and **tail-biased**: when ``max_traces`` is
    exceeded, the oldest *routine* (or unclassified) trace goes first;
    error/shed/deadline-violating/slowest-percentile traces (see
    :func:`retention_class`, set via :meth:`classify`) are only evicted
    when nothing routine is left.  Each trace's span list is capped at
    ``max_spans`` -- excess spans are COUNTED (``dropped_spans``), never
    silently discarded, so a truncated waterfall is distinguishable from
    missing instrumentation.  All methods are thread-safe; record() is
    O(1) amortized -- cheap enough for the hot path unconditionally, so
    tracing needs no sampling knob at this scale.

    ``registry`` (optional) mints the retention accounting series
    ``kdlt_trace_{retained,dropped}_total{class=...}``.
    """

    def __init__(self, tier: str, max_traces: int = 512, max_spans: int = 128,
                 registry: metrics_lib.Registry | None = None):
        self.tier = tier
        self.max_traces = max_traces
        self.max_spans = max_spans
        self._traces: OrderedDict[str, _TraceEntry] = OrderedDict()
        self._lock = threading.Lock()
        self.evicted_traces = 0  # ring evictions (any class), process total
        self.dropped_spans = 0   # spans past a trace's span cap, process total
        self._m = (
            metrics_lib.trace_retention_metrics(registry)
            if registry is not None else None
        )

    def _evict_one_locked(self) -> None:
        """Drop one trace to make room: the oldest routine/unclassified one,
        or -- only when every resident trace is protected -- the oldest
        overall (the ring must stay bounded even under a pure error storm).
        """
        victim = None
        for trace_id, entry in self._traces.items():  # oldest first
            if entry.cls is None or entry.cls == "routine":
                victim = trace_id
                break
        if victim is None:
            victim, entry = next(iter(self._traces.items()))
        else:
            entry = self._traces[victim]
        del self._traces[victim]
        self.evicted_traces += 1
        if self._m is not None:
            counter = self._m["dropped"].get(entry.cls or "routine")
            if counter is not None:
                counter.inc()

    def record(
        self,
        trace_id: str,
        name: str,
        start_s: float,
        dur_s: float,
        parent_id: str | None = None,
        span_id: str | None = None,
        **tags,
    ) -> Span:
        span = Span(
            trace_id, span_id or new_span_id(), parent_id, name, self.tier,
            start_s, max(0.0, dur_s), tags,
        )
        self.record_spans(trace_id, [span])
        return span

    def record_spans(self, trace_id: str, spans: list[Span]) -> None:
        """Record finished spans of one trace, in order, under one
        acquisition of the lock (the cap and the ring as ``record``)."""
        with self._lock:
            entry = self._traces.get(trace_id)
            if entry is None:
                while len(self._traces) >= self.max_traces:
                    self._evict_one_locked()
                entry = self._traces[trace_id] = _TraceEntry()
            room = max(0, self.max_spans - len(entry.spans))
            entry.spans.extend(spans[:room])
            if len(spans) > room:
                entry.dropped_spans += len(spans) - room
                self.dropped_spans += len(spans) - room

    def classify(self, trace_id: str, cls: str) -> None:
        """Stamp a finished trace's retention class (handlers call this in
        their finally block).  Upgrades only: a trace already classified
        more severe (a hedged request whose first attempt errored) keeps
        the severer class."""
        if cls not in RETENTION_PRIORITY:
            cls = "routine"
        with self._lock:
            entry = self._traces.get(trace_id)
            if entry is None:
                return  # already evicted (or never recorded): nothing to keep
            prev = entry.cls
            if prev is not None and (
                RETENTION_PRIORITY[prev] >= RETENTION_PRIORITY[cls]
            ):
                return
            entry.cls = cls
        if self._m is not None:
            counter = self._m["retained"].get(cls)
            if counter is not None:
                counter.inc()

    def request_trace(self, trace_id: str, parent_id: str | None = None) -> "RequestTrace":
        """A RequestTrace rooted at a freshly minted span id; the caller
        records the root span itself (typically in its finally block) with
        ``span_id=rt.span_id, parent_id=rt.parent_id``."""
        return RequestTrace(self, trace_id, new_span_id(), parent_id)

    def spans(self, trace_id: str) -> list[dict] | None:
        with self._lock:
            entry = self._traces.get(trace_id)
            if entry is None:
                return None
            return [s.to_dict() for s in entry.spans]

    def trace_info(self, trace_id: str) -> dict | None:
        """The /debug/trace view of one trace: spans plus the retention
        class and this trace's dropped-span count (a nonzero count marks a
        TRUNCATED waterfall -- the instrumentation fired, the ring cap
        bit)."""
        with self._lock:
            entry = self._traces.get(trace_id)
            if entry is None:
                return None
            return {
                "spans": [s.to_dict() for s in entry.spans],
                "retention_class": entry.cls or "routine",
                "spans_dropped": entry.dropped_spans,
            }

    def stats(self) -> dict:
        """Tier-level ring accounting, surfaced on /debug/trace 404s so a
        missing trace reads as "probably evicted" vs "never instrumented"."""
        with self._lock:
            return {
                "traces_resident": len(self._traces),
                "max_traces": self.max_traces,
                "traces_evicted_total": self.evicted_traces,
                "spans_dropped_total": self.dropped_spans,
            }

    def summary(self, trace_id: str) -> str:
        """Server-Timing-style summary: ``name;dur=12.3, ...`` (ms), in
        record order.  Empty string when the trace is unknown."""
        with self._lock:
            entry = self._traces.get(trace_id)
            if entry is None or not entry.spans:
                return ""
            return ", ".join(
                f"{s.name};dur={s.dur_s * 1e3:.1f}" for s in entry.spans
            )


# Guards every carrier's deferred children (held for a list append or swap).
_DEFER_LOCK = threading.Lock()


class RequestTrace:
    """The per-request carrier plumbed down a tier's predict path.

    ``span_id`` is the currently-active span -- the parent every child
    recorded through this carrier nests under.  ``None`` is the universal
    no-trace value: every instrumented callee takes ``trace=None`` and
    stays zero-cost when tracing is not engaged for the request.

    Children measured on a thread every request shares (a batcher's queue
    wait, the dispatcher's stages) arrive through :meth:`defer`: the
    shared thread only appends their intervals, and the request's own
    thread records them when this carrier's span closes (:meth:`close`,
    ``span()``'s exit), before its reply; once closed, deferred children
    are recorded at once.  (The JAX package records them on the shared
    threads, which on a host-bound server delays every batch's results.)
    """

    __slots__ = ("tracer", "trace_id", "span_id", "parent_id", "tags", "_pending")

    def __init__(self, tracer: Tracer, trace_id: str, span_id: str,
                 parent_id: str | None = None):
        self.tracer = tracer
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.tags: dict = {}
        self._pending: list | None = []  # guarded-by: _DEFER_LOCK; None once closed

    def record(self, name: str, start_s: float, dur_s: float, **tags) -> Span:
        """Record a completed child interval under the active span."""
        return self.tracer.record(
            self.trace_id, name, start_s, dur_s, parent_id=self.span_id, **tags
        )

    def _child(self, name: str, start_s: float, dur_s: float, tags: dict) -> Span:
        return Span(self.trace_id, new_span_id(), self.span_id, name, self.tracer.tier,
                    start_s, max(0.0, dur_s), tags)

    def defer(self, children) -> None:
        """Child intervals ``(name, start_s, dur_s, tags)`` to record when
        this carrier closes (at once if it has)."""
        with _DEFER_LOCK:
            if self._pending is not None:
                self._pending.extend(children)
                return
        self.tracer.record_spans(self.trace_id, [self._child(*c) for c in children])

    def close(self) -> list[Span]:
        """Close the carrier: its deferred children as spans, for the caller
        to record; later ones are recorded at once."""
        with _DEFER_LOCK:
            pending, self._pending = self._pending, None
        return [self._child(*c) for c in pending or ()]

    @contextmanager
    def span(self, name: str, **tags):
        """Time a block as a child span; yields the child's RequestTrace so
        nested work (and cross-tier propagation) parents correctly.  The
        span records even when the block raises -- a shed or failed stage
        still belongs on the waterfall.  Extra tags set on the yielded
        carrier's ``tags`` dict are merged at record time."""
        child = RequestTrace(self.tracer, self.trace_id, new_span_id(), self.span_id)
        t0 = now_s()
        try:
            yield child
        finally:
            end = now_s()
            spans = child.close()
            spans.append(Span(self.trace_id, child.span_id, self.span_id, name,
                              self.tracer.tier, t0, end - t0, {**tags, **child.tags}))
            self.tracer.record_spans(self.trace_id, spans)


# --- waterfall rendering --------------------------------------------------


def sort_spans(spans: list[dict]) -> list[dict]:
    return sorted(spans, key=lambda s: (s.get("start_s", 0.0), -s.get("dur_ms", 0.0)))


def span_children(spans: list[dict]) -> dict:
    """parent span_id -> children (start-ordered); key None = roots
    (spans whose parent is absent from the set count as roots too)."""
    ids = {s["span_id"] for s in spans}
    out: dict = {}
    for s in sort_spans(spans):
        parent = s.get("parent_id")
        key = parent if parent in ids else None
        out.setdefault(key, []).append(s)
    return out


def render_waterfall(spans: list[dict], width: int = 40) -> str:
    """ASCII waterfall of a merged trace: indent = parent depth, bar =
    position/extent on the trace's global timeline."""
    if not spans:
        return "(no spans)"
    t0 = min(s["start_s"] for s in spans)
    t1 = max(s["start_s"] + s["dur_ms"] / 1e3 for s in spans)
    total = max(t1 - t0, 1e-9)
    children = span_children(spans)
    lines = [
        f"trace {spans[0]['trace_id']}: {len(spans)} spans, "
        f"{total * 1e3:.1f} ms total"
    ]

    def emit(span: dict, depth: int) -> None:
        off = int((span["start_s"] - t0) / total * width)
        n = max(1, int(span["dur_ms"] / 1e3 / total * width))
        bar = " " * off + "#" * min(n, width - off)
        label = "  " * depth + f"[{span['tier']}] {span['name']}"
        tags = "".join(
            f" {k}={v}" for k, v in sorted(span.get("tags", {}).items())
        )
        lines.append(
            f"{label:<44s} |{bar:<{width}s}| {span['dur_ms']:9.2f} ms{tags}"
        )
        for c in children.get(span["span_id"], ()):
            emit(c, depth + 1)

    for root in children.get(None, ()):
        emit(root, 0)
    return "\n".join(lines)
