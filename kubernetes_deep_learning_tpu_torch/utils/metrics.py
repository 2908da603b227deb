"""Minimal thread-safe metrics: counters, gauges, histograms, Prometheus text.

The port's own trimmed copy of the JAX package's ``utils/metrics.py``: the
metric types and registry, the two helpers the dispatch pipeline mints
its series through (``pipeline_stage_histograms``,
``dispatch_stall_counter``), the admission controller's
(``admission_metrics``, ``admission_class_metrics``,
``admission_model_metrics``, ``batcher_budget_histogram``), the bounded
``model`` label (``model_registry``), a served version's child registry
(``model_version_registry``, dropped with ``Registry.remove`` when the
version is unloaded), the scheduler's lane series
(``scheduler_lane_metrics``, ``kdlt_sched_*``), the per-model request
count (``model_request_counter``) and the observability layer's series:
the SLO engine's (``slo_tier_metrics``, ``slo_model_window_metrics``), the
tracer's retention counters (``trace_retention_metrics``), the flight
recorder's (``incident_metrics``) and the live MFU and device-busy gauges
(``mfu_bucket_gauge``, ``device_busy_gauge``), with the same series names
and buckets.  Histograms carry OpenMetrics exemplars behind
``KDLT_METRICS_EXEMPLARS=1``.  ``Registry.render`` is the model server's
``/metrics`` page.
"""

from __future__ import annotations

import bisect
import os
import threading
import time

# Default latency buckets in seconds (sub-ms to 20 s, the reference's
# implicit deadline ceiling).
DEFAULT_BUCKETS = (
    0.001, 0.0025, 0.005, 0.01, 0.015, 0.025, 0.05, 0.1,
    0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 20.0,
)

# Pipeline-stage buckets reach below the request buckets: the dispatch and
# readback stages of a well-overlapped pipeline are tens of microseconds to
# single-digit milliseconds, which DEFAULT_BUCKETS would collapse into its
# first bin.
PIPELINE_STAGE_BUCKETS = (
    0.00005, 0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01,
    0.025, 0.05, 0.1, 0.25, 1.0, 5.0,
)

# The in-flight dispatch pipeline's stages (runtime.engine.InFlightDispatcher),
# in hot-path order:
#
# - enqueue_wait: submit() blocked waiting for an in-flight slot -- the
#   backpressure stage; nonzero means the device (not the host) is the
#   bottleneck, which is the healthy steady state.
# - dispatch: staging into pinned memory, the H2D copy and the forward's
#   kernel launches (the predict_async call).  Everything is enqueued on
#   the stream without waiting for the device, so this is host cost -- the
#   part pipelining hides.
# - execute: dispatch-return -> readback-start on the completion thread.
#   Under overlap this is the time the batch waited in flight while the
#   device worked (on it or its predecessors).
# - readback: the wait for the batch's event (forward + the D2H copy
#   enqueued behind it) and the hand-over of the host rows.
PIPELINE_STAGES = (
    ("enqueue_wait", "submit blocked on the in-flight depth limit (backpressure)"),
    ("dispatch", "host batch staging + H2D copy and kernel enqueue (predict_async)"),
    ("execute", "in-flight wait: dispatch return to readback start (overlapped device execution)"),
    ("readback", "blocking device sync + D2H materialization"),
)


def pipeline_stage_histograms(registry: "Registry", model: str | None = None) -> dict:
    """The per-stage histograms every in-flight dispatcher emits
    (``kdlt_pipeline_<stage>_seconds``), keyed by stage name.  ``model``
    mints them under the bounded ``model`` label (the scheduler's shared
    dispatcher attributes each batch's stage times to its model), once per
    model child."""

    def mint(reg: "Registry") -> dict:
        return {
            stage: reg.histogram(
                f"kdlt_pipeline_{stage}_seconds", help, buckets=PIPELINE_STAGE_BUCKETS
            )
            for stage, help in PIPELINE_STAGES
        }

    if model is None:
        return mint(registry)
    return _memo_on_child(model_registry(registry, model), "_kdlt_pipeline_stages", mint)


def dispatch_stall_counter(registry: "Registry") -> "Counter":
    """In-flight dispatch handles the watchdog declared stuck and failed."""
    return registry.counter(
        "kdlt_dispatch_stall_total",
        "in-flight dispatches failed by the engine watchdog as stuck",
    )


# Admission control (serving.admission): every way the model tier can refuse
# work, as the ``shed_reason`` label on kdlt_admission_shed_total.  The JAX
# package's set, so one dashboard query covers both servers (the breaker's
# and brownout's reasons belong to the gateway and stay at 0 here).
ADMISSION_SHED_REASONS = (
    ("deadline_exhausted", "the deadline budget was spent before execution (504)"),
    ("queue_timeout", "no concurrency slot freed within the bounded queue wait"),
    ("queue_full", "the admission queue's waiter cap was reached"),
    ("breaker_open", "the model-tier circuit breaker refused the call"),
    ("draining", "the tier is draining for shutdown"),
    ("budget_exhausted", "the model's per-tenant admission budget was spent "
                         "and no borrowed slot could be reclaimed"),
    ("preempted", "a queued waiter was evicted by a higher-priority or "
                  "under-budget arrival (borrowed slots shed first)"),
    ("brownout", "rejected by the brownout controller's staged class "
                 "shedding (429: the caller's class is out of budget, not "
                 "a server failure)"),
)

# The bounded value set of the ``class`` label (serving.protocol.PRIORITY_CLASSES).
ADMISSION_PRIORITY_CLASSES = ("interactive", "batch", "best-effort")

# At most this many distinct ``model`` label values per admission
# controller (and per root registry, through ``model_registry``); every
# further name shares the overflow value.
MODEL_LABEL_CAP = 32
MODEL_LABEL_OVERFLOW = "__other__"

_model_children_lock = threading.Lock()


def model_registry(registry: "Registry", model: str) -> "Registry":
    """The child registry carrying the bounded ``model`` label, memoized per
    root registry (the same model always lands on the same child); past
    MODEL_LABEL_CAP distinct models every further name shares the
    MODEL_LABEL_OVERFLOW child."""
    model = str(model)
    with _model_children_lock:
        children = getattr(registry, "_kdlt_model_children", None)
        if children is None:
            children = registry._kdlt_model_children = {}
        if model not in children:
            if len(children) >= MODEL_LABEL_CAP:
                model = MODEL_LABEL_OVERFLOW
                if model in children:
                    return children[model]
            children[model] = registry.with_labels(model=model)
        return children[model]


def model_version_registry(registry: "Registry", model: str, version: int) -> "Registry":
    """A served model VERSION's labelled child registry (one per served
    version; dropped with ``registry.remove`` when the version is unloaded,
    so at most one version of a model is live on the page at a time)."""
    return registry.with_labels(model=model, version=str(version))


def _memo_on_child(child: "Registry", attr: str, factory):
    """Mint a model child's series once: two names can share a child (the
    overflow one), and re-minting a (name, labels) pair raises."""
    with _model_children_lock:
        got = getattr(child, attr, None)
        if got is None:
            got = factory(child)
            setattr(child, attr, got)
        return got


def scheduler_lane_metrics(registry: "Registry", model: str) -> dict:
    """One scheduling lane's series (``runtime.scheduler.UnifiedScheduler``):
    ``kdlt_batcher_batch_size`` and ``kdlt_batcher_rejected_total`` keep the
    batchers' names under the ``model`` label; the ``kdlt_sched_*`` series
    are the scheduler's own (queue depth, dispatches, weight-floor boosts,
    device time consumed, weight, queue age at dispatch)."""
    return _memo_on_child(model_registry(registry, model), "_kdlt_sched_lane",
                          _mint_lane_metrics)


def _mint_lane_metrics(child: "Registry") -> dict:
    return {
        "batch_size": child.histogram(
            "kdlt_batcher_batch_size", "dispatched batch sizes",
            buckets=(1, 2, 4, 8, 16, 32, 64, 128, 256)),
        "queue_full": child.counter(
            "kdlt_batcher_rejected_total", "requests rejected because queue was full"),
        "queue_depth": child.gauge(
            "kdlt_sched_queue_depth", "images queued awaiting dispatch"),
        "dispatch": child.counter(
            "kdlt_sched_dispatch_total", "batches dispatched for this model"),
        "floor_boosts": child.counter(
            "kdlt_sched_floor_boosts_total",
            "dispatches granted by the weight-floor starvation guard ahead "
            "of the deadline order"),
        "device_seconds": child.counter(
            "kdlt_sched_device_seconds_total",
            "observed dispatch->completion device time consumed by this "
            "model (the share the weighted policy arbitrates)"),
        "weight": child.gauge("kdlt_sched_weight", "configured scheduling weight"),
        "queue_age": child.histogram(
            "kdlt_sched_queue_age_seconds",
            "age of queued units when their dispatch plan was taken "
            "(enqueue -> scheduled): the queuing-delay component of "
            "cross-model arbitration", buckets=PIPELINE_STAGE_BUCKETS),
    }



def model_request_counter(registry: "Registry", model: str) -> "Counter":
    """Per-model predict request count (the bounded ``model`` label)."""
    return _memo_on_child(
        model_registry(registry, model), "_kdlt_model_requests",
        lambda c: c.counter("kdlt_model_requests_total", "predict requests by served model"))


# --- the generative lane's series (runtime.decode) ---------------------------
#
# TTFT and TPOT distributions (the per-token SLO signals), token,
# generation and step counts, and the continuous-batching occupancy gauges,
# under the bounded ``model`` label; the JAX package's names and buckets.
# TTFT spans a prefill up to queue-dominated seconds; TPOT is one decode
# step amortized per token.
DECODE_TTFT_BUCKETS = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5,
    5.0, 10.0,
)
DECODE_TPOT_BUCKETS = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
    0.1, 0.25, 1.0,
)


def decode_metrics(registry: "Registry", model: str) -> dict:
    """One generative model's decode-lane series (memoized per child)."""

    def mint(c: "Registry") -> dict:
        return {
            "ttft": c.histogram(
                "kdlt_decode_ttft_seconds",
                "time to first token: generation admitted -> first token "
                "materialized (prefill + queue wait included)",
                buckets=DECODE_TTFT_BUCKETS),
            "tpot": c.histogram(
                "kdlt_decode_tpot_seconds",
                "time per output token after the first "
                "((t_last - t_first) / (n - 1)) for each finished generation",
                buckets=DECODE_TPOT_BUCKETS),
            "tokens": c.counter("kdlt_decode_tokens_total", "output tokens emitted"),
            "generations": c.counter("kdlt_decode_generations_total", "generations finished"),
            "steps": c.counter(
                "kdlt_decode_steps_total",
                "batched decode steps executed (each advances every active slot by one token)"),
            "step_seconds": c.histogram(
                "kdlt_decode_step_seconds",
                "wall time of one batched decode step (dispatch + materialize)",
                buckets=PIPELINE_STAGE_BUCKETS),
            "prefill_seconds": c.histogram(
                "kdlt_decode_prefill_seconds",
                "wall time of one prompt prefill (one graph per prompt bucket)",
                buckets=PIPELINE_STAGE_BUCKETS),
            "active_slots": c.gauge(
                "kdlt_decode_active_slots",
                "decode batch slots currently occupied by live generations"),
            "queue_depth": c.gauge(
                "kdlt_decode_queue_depth",
                "admitted generations waiting for a free decode slot"),
            "pages_in_use": c.gauge(
                "kdlt_decode_kv_pages_in_use",
                "KV-cache pages currently allocated to live generations"),
        }

    return _memo_on_child(model_registry(registry, model), "_kdlt_decode", mint)


# --- the SLO engine's series (utils.slo) -------------------------------------
#
# Per-model sliding-window goodput and multi-window burn rates against
# $KDLT_SLO_TARGET.  The ``model`` label stays bounded through
# model_registry; the ``window`` label's values are exactly utils.slo.WINDOWS.

def slo_tier_metrics(registry: "Registry") -> dict:
    """The per-tier SLO statics: the configured objective itself."""
    return {
        "target": registry.gauge(
            "kdlt_slo_target",
            "configured SLO target (KDLT_SLO_TARGET): the fraction of "
            "requests that must complete in-deadline"),
    }


def slo_model_window_metrics(registry: "Registry", model: str, window: str) -> dict:
    """One (model, window) cell of the SLO engine's gauge matrix, minted once
    per (model child, window)."""

    def mint(c: "Registry") -> dict:
        w = c.with_labels(window=window)
        return {
            "goodput_ratio": w.gauge(
                "kdlt_slo_goodput_ratio",
                "fraction of SLO-eligible requests completed in-deadline "
                "over the window"),
            "burn_rate": w.gauge(
                "kdlt_slo_burn_rate",
                "error-budget burn rate over the window (bad fraction / "
                "(1 - target)); 1.0 = burning exactly at the sustainable rate"),
            "shed_ratio": w.gauge(
                "kdlt_slo_shed_ratio",
                "fraction of SLO-eligible requests shed (503/504) over the window"),
            "error_ratio": w.gauge(
                "kdlt_slo_error_ratio",
                "fraction of SLO-eligible requests failed server-side over the window"),
            "requests": w.gauge(
                "kdlt_slo_window_requests", "SLO-eligible requests observed in the window"),
        }

    return _memo_on_child(model_registry(registry, model), f"_kdlt_slo_{window}", mint)


# Tail-based trace retention (utils.trace.Tracer): every finished trace is
# classified into exactly one of these, and eviction drops ``routine``
# traces first -- the label set is this tuple, nothing else.
TRACE_RETENTION_CLASSES = (
    ("incident", "the trace is pinned by a flight-recorder incident bundle"),
    ("error", "the request failed server-side (5xx/disconnect)"),
    ("shed", "the request was shed (503/504)"),
    ("deadline", "the request completed but violated its deadline budget"),
    ("slow", "the request landed in the tier's slowest percentile"),
    ("routine", "an unremarkable request"),
)


def trace_retention_metrics(registry: "Registry") -> dict:
    """The tracer's retention accounting: traces classified (retained) and
    traces evicted from the ring (dropped), by retention class.  A rising
    dropped{class!="routine"} means interesting traces are being lost."""
    return {
        kind: {
            cls: registry.with_labels(**{"class": cls}).counter(name, f"{what}: {help}")
            for cls, help in TRACE_RETENTION_CLASSES
        }
        for kind, name, what in (
            ("retained", "kdlt_trace_retained_total", "traces classified for retention"),
            ("dropped", "kdlt_trace_dropped_total", "traces evicted from the ring buffer"),
        )
    }


def mfu_bucket_gauge(registry: "Registry", bucket: int) -> "Gauge":
    """Live per-bucket MFU gauge (runtime.flops.MfuAccountant); the caller's
    registry carries the model/version labels, ``bucket`` values are the
    engine's ladder -- bounded by construction."""
    return registry.with_labels(bucket=str(int(bucket))).gauge(
        "kdlt_mfu_pct",
        "live model FLOP/s utilization of the device's dense peak, per batch "
        "bucket (EWMA over the batches' device times)")


def device_busy_gauge(registry: "Registry") -> "Gauge":
    return registry.gauge(
        "kdlt_device_busy_ratio",
        "decayed fraction of wall time the device spent executing this "
        "engine's batches (the batches' device times; ~30 s half-life)")



# The gateway tier and the bytes wire (serving.gateway, serving.upstream,
# serving.cache): the JAX package's families, minted here as there.


def upstream_pool_metrics(registry: "Registry") -> dict:
    """The gateway-tier replica-pool series (failover + hedging)."""
    return {
        "failover": registry.counter(
            "kdlt_upstream_failover_total",
            "upstream attempts redirected to another replica after a failure",
        ),
        "hedge_fired": registry.counter(
            "kdlt_hedge_fired_total",
            "hedged second attempts fired after the hedge delay",
        ),
        "hedge_won": registry.counter(
            "kdlt_hedge_won_total",
            "hedged attempts whose response was the one used",
        ),
    }


CACHE_EVICTION_REASONS = (
    ("lru", "evicted to fit the KDLT_CACHE_MAX_MB byte budget"),
    ("ttl", "expired past KDLT_CACHE_TTL_S"),
    ("reload", "dropped because the model's artifact hash changed (hot "
               "reload with different bytes)"),
)


def cache_metrics(registry: "Registry") -> dict:
    """The gateway-tier response-cache series (kdlt_cache_*).

    Centralized like the helpers above so the cache, /debug/cache, and
    bench.py --cache-ab key one set of names.  ``hits`` never touched
    admission or the upstream; ``coalesced`` rode another request's
    flight (admitted-but-not-dispatched); ``misses`` paid the full path.
    """
    return {
        "hits": registry.counter(
            "kdlt_cache_hits_total",
            "requests served from the response cache (no admission slot, "
            "no upstream call, no device work)",
        ),
        "misses": registry.counter(
            "kdlt_cache_misses_total",
            "cacheable requests that missed and led their own upstream flight",
        ),
        "coalesced": registry.counter(
            "kdlt_cache_coalesced_total",
            "requests coalesced onto another identical request's in-flight "
            "upstream call (singleflight followers)",
        ),
        "stale_hits": registry.counter(
            "kdlt_cache_stale_hits_total",
            "requests served a TTL-expired entry under brownout "
            "stale-while-revalidate (within KDLT_CACHE_SWR_S past expiry; "
            "marked X-Kdlt-Cache: stale)",
        ),
        "neg_hits": registry.counter(
            "kdlt_cache_negative_hits_total",
            "requests answered from a negative-cache entry (a recent 404/"
            "400 for the same content key, held for KDLT_CACHE_NEG_TTL_S)",
        ),
        "bytes": registry.counter(
            "kdlt_cache_bytes_total",
            "response bytes inserted into the cache",
        ),
        "resident": registry.gauge(
            "kdlt_cache_resident_bytes",
            "response bytes currently held by the cache",
        ),
        "entries": registry.gauge(
            "kdlt_cache_entries", "entries currently held by the cache"
        ),
        "hit_ratio": registry.gauge(
            "kdlt_cache_hit_ratio",
            "lifetime hits / (hits + misses) of the response cache",
        ),
        "evictions": {
            reason: registry.with_labels(reason=reason).counter(
                "kdlt_cache_evictions_total", help
            )
            for reason, help in CACHE_EVICTION_REASONS
        },
    }


def cache_decoded_metrics(registry: "Registry") -> dict:
    """The decoded-uint8 cache tier's series (kdlt_cache_decoded_*).

    Keys are (payload content hash, resolved preprocess params), so a hit
    means a previously decoded image's pixels were reused -- across
    requests AND across models sharing an input contract -- skipping the
    JPEG/PNG decode + resize entirely.  Entries are content-addressed and
    therefore immutable: there is no TTL and no artifact invalidation,
    only the LRU byte budget (KDLT_CACHE_DECODED_MB)."""
    return {
        "hits": registry.counter(
            "kdlt_cache_decoded_hits_total",
            "decode-stage lookups served a previously decoded uint8 tensor "
            "(no JPEG/PNG decode, no resize)",
        ),
        "misses": registry.counter(
            "kdlt_cache_decoded_misses_total",
            "decode-stage lookups that paid the full decode+resize",
        ),
        "resident": registry.gauge(
            "kdlt_cache_decoded_resident_bytes",
            "decoded uint8 tensor bytes currently held by the decoded tier",
        ),
        "entries": registry.gauge(
            "kdlt_cache_decoded_entries",
            "entries currently held by the decoded tier",
        ),
        "evictions": registry.counter(
            "kdlt_cache_decoded_evictions_total",
            "decoded entries evicted to fit the KDLT_CACHE_DECODED_MB "
            "byte budget (content-addressed entries never expire; LRU is "
            "the only way out)",
        ),
    }


INGEST_FALLBACK_REASONS = (
    ("format", "payload failed the JPEG/PNG magic-byte sniff (exotic "
               "format decodes at the gateway, rides the tensor wire)"),
    ("negotiation", "the model tier did not advertise the bytes capability "
                    "on its spec response (old server or KDLT_INGEST=0)"),
    ("rejected", "a bytes-wire POST came back 4xx and the request was "
                 "re-sent decoded on the legacy tensor wire"),
)


def ingest_gateway_metrics(registry: "Registry") -> dict:
    """The gateway tier's raw-bytes ingest series (kdlt_ingest_*): how
    much traffic rides the bytes wire, why the rest fell back, and the
    wire bytes actually shipped (the payload-diet receipt bench.py
    --ingest-ab cross-checks)."""
    return {
        "bytes_requests": registry.counter(
            "kdlt_ingest_bytes_requests_total",
            "upstream predict calls sent on the raw-bytes wire",
        ),
        "wire_bytes": registry.counter(
            "kdlt_ingest_wire_bytes_total",
            "request-body bytes shipped on the raw-bytes wire",
        ),
        "fallbacks": {
            reason: registry.with_labels(reason=reason).counter(
                "kdlt_ingest_fallbacks_total", help
            )
            for reason, help in INGEST_FALLBACK_REASONS
        },
    }


def ingest_server_metrics(registry: "Registry") -> dict:
    """The model tier's decode-stage series (kdlt_ingest_*): images
    decoded at this tier and the per-batch decode latency (the stage a
    trace waterfall shows as server.ingest_decode)."""
    return {
        "decoded_images": registry.counter(
            "kdlt_ingest_decoded_images_total",
            "images decoded+resized by the model tier's decode stage",
        ),
        "decode_seconds": registry.histogram(
            "kdlt_ingest_decode_seconds",
            "wall seconds per bytes-wire batch in the thread-pooled "
            "decode stage",
            buckets=PIPELINE_STAGE_BUCKETS,
        ),
    }


def pool_membership_metrics(registry: "Registry") -> dict:
    """Pool-level dynamic-membership series (kdlt_pool_*).

    Minted HERE and nowhere else (tools/check_metrics.py confines the
    kdlt_pool_ prefix to this module) so the gateway pool and bench.py
    --churn-ab key one set of names.  ``members`` counts replicas in
    rotation OR quarantine (everything the resolver currently believes
    in); joins/leaves count membership transitions, which is what the
    churn bench's assertions and any flap alert key on.
    """
    return {
        "members": registry.gauge(
            "kdlt_pool_members",
            "upstream replicas currently known to the pool (in rotation, "
            "quarantined, or draining)",
        ),
        "joins": registry.counter(
            "kdlt_pool_joins_total",
            "replicas added to the pool by dynamic membership (resolver "
            "or set_membership)",
        ),
        "leaves": registry.counter(
            "kdlt_pool_leaves_total",
            "replicas removed from the pool by dynamic membership",
        ),
    }


def pool_replica_metrics(registry: "Registry", host: str) -> dict:
    """One replica's pool series, minted under a single labeled child so
    dynamic membership can retire ALL of a departed replica's series
    atomically (``registry.remove(child)``) without leaving stale samples
    on /metrics.  ``child`` is that handle; callers never mint through it
    directly."""
    child = registry.with_labels(replica=host)
    return {
        "child": child,
        "healthy": child.gauge(
            "kdlt_upstream_replica_healthy",
            "1 while the upstream replica is considered healthy",
        ),
        "picks": child.counter(
            "kdlt_pool_pick_total",
            "times power-of-two-choices selection routed a primary "
            "attempt to this replica",
        ),
        "ewma_ms": child.gauge(
            "kdlt_pool_replica_ewma_ms",
            "EWMA of this replica's observed request latency (the "
            "power-of-two-choices ranking signal)",
        ),
    }


# Quantization serving state (ops.quantize + runtime.engine): the
# ``scheme`` label's value set is exactly this tuple.
QUANT_SCHEMES = (
    ("float32", "unquantized float serving"),
    ("int8-weight-only", "int8 weights dequantized inline; float activations"),
    ("int8-w8a8", "int8 weights AND calibrated int8 activations (MXU 2x path)"),
)


def quant_metrics(registry: "Registry") -> dict:
    """One engine's quantization accounting: which scheme is ACTIVE (the
    gauge is 1 for exactly one scheme -- post-tolerance-gate, post-
    $KDLT_QUANT_SCHEME override, so a silently-downgraded pod is
    alertable) and how many times the warmup tolerance gate refused
    int8 activations (kdlt_quant_gate_failures_total).  The names and help
    are the JAX package's."""
    return {
        "scheme": {
            scheme: registry.with_labels(scheme=scheme).gauge(
                "kdlt_quant_scheme",
                f"1 while this scheme is the one actually serving: {help}",
            )
            for scheme, help in QUANT_SCHEMES
        },
        "gate_failures": registry.counter(
            "kdlt_quant_gate_failures_total",
            "warmup golden-logits tolerance gate failures: a calibrated "
            "int8-w8a8 artifact drifted past KDLT_QUANT_TOL (or top-1 "
            "agreement) and was downgraded to weight-only serving",
        ),
    }


# The flight recorder's triggers (utils.flightrecorder.TRIGGER_RULES): the
# ``trigger`` label's values are exactly this tuple.
INCIDENT_TRIGGERS = ("burn-crossing", "brownout", "dispatch-stall", "replica-unhealthy")


def incident_metrics(registry: "Registry") -> dict:
    """The flight recorder's series: bundles captured / suppressed (dedup or
    hysteresis swallowed a repeat fire) / dropped (the caps evicted an old
    bundle), per trigger, plus how many bundles are currently retained.
    Minted once per registry."""
    return _memo_on_child(registry, "_kdlt_incident", _mint_incident)


def _mint_incident(registry: "Registry") -> dict:
    def per_trigger(name: str, help: str) -> dict:
        return {trig: registry.with_labels(trigger=trig).counter(name, help)
                for trig in INCIDENT_TRIGGERS}

    return {
        "captures": per_trigger("kdlt_incident_captures_total",
                                "incident bundles captured, by firing trigger"),
        "suppressed": per_trigger(
            "kdlt_incident_suppressed_total",
            "trigger fires suppressed inside the dedup window (a flapping "
            "signal yields ONE bundle plus this counter)"),
        "dropped": per_trigger(
            "kdlt_incident_dropped_total",
            "incident bundles evicted oldest-first by the KDLT_INCIDENT_MAX_BUNDLES / "
            "KDLT_INCIDENT_MAX_MB caps, by the evicted bundle's trigger"),
        "open": registry.gauge(
            "kdlt_incident_open",
            "incident bundles currently retained on disk under KDLT_INCIDENT_DIR"),
    }


# Deadline budgets are ms-scale; the request-latency buckets (seconds) would
# collapse every remaining-budget observation into two bins.
DEADLINE_MS_BUCKETS = (
    1, 5, 10, 25, 50, 100, 250, 500, 1000, 2500, 5000,
    10_000, 20_000, 60_000, 120_000,
)


def admission_metrics(registry: "Registry") -> dict:
    """The per-tier admission series (kdlt_admission_*), distinguished by
    the registry's ``tier`` label."""
    return {
        "requests": registry.counter(
            "kdlt_admission_requests_total", "requests seen by admission control"),
        "admitted": registry.counter(
            "kdlt_admission_admitted_total", "requests admitted to execution"),
        "queue_wait": registry.histogram(
            "kdlt_admission_queue_wait_seconds",
            "wait for a concurrency slot before execution", buckets=PIPELINE_STAGE_BUCKETS),
        "deadline_remaining_ms": registry.histogram(
            "kdlt_admission_deadline_remaining_ms",
            "remaining deadline budget at admission (propagation evidence: "
            "each tier down the path observes strictly less)", buckets=DEADLINE_MS_BUCKETS),
        "limit": registry.gauge(
            "kdlt_admission_concurrency_limit", "current AIMD concurrency limit"),
        "inflight": registry.gauge(
            "kdlt_admission_inflight", "admitted requests currently executing"),
        "draining": registry.gauge(
            "kdlt_admission_draining", "1 while the tier refuses new work for shutdown"),
        "shed": {
            reason: registry.with_labels(shed_reason=reason).counter(
                "kdlt_admission_shed_total", help)
            for reason, help in ADMISSION_SHED_REASONS
        },
    }


def admission_class_metrics(registry: "Registry") -> dict:
    """Admitted and shed requests by priority class (the ``class`` label)."""
    out: dict = {}
    for cls in ADMISSION_PRIORITY_CLASSES:
        child = registry.with_labels(**{"class": cls})
        out[cls] = {
            "admitted": child.counter(
                "kdlt_admission_class_admitted_total",
                "requests admitted to execution, by priority class"),
            "shed": child.counter(
                "kdlt_admission_class_shed_total",
                "requests shed, by priority class (lowest class sheds first)"),
        }
    return out


def admission_model_metrics(registry: "Registry", model: str) -> dict:
    """Requests seen and admitted for one model (the ``model`` label under
    the controller's ``tier`` registry; the controller bounds its values)."""
    child = registry.with_labels(model=model)
    return {
        "requests": child.counter(
            "kdlt_admission_requests_total", "requests seen by admission control"),
        "admitted": child.counter(
            "kdlt_admission_admitted_total", "requests admitted to execution"),
    }


def batcher_budget_histogram(registry: "Registry") -> "Histogram":
    """The remaining budget when a request reached the batcher's or the
    dispatcher's wait (a served model's registry)."""
    return registry.histogram(
        "kdlt_admission_batcher_budget_ms",
        "remaining deadline budget when the request reached the batcher/dispatcher wait",
        buckets=DEADLINE_MS_BUCKETS)


# --- OpenMetrics exemplars ----------------------------------------------------
#
# Behind $KDLT_METRICS_EXEMPLARS=1 a histogram annotates each bucket sample
# with the trace id of a recent observation that landed there
# (``... # {trace_id="..."} value timestamp``), linking a latency bucket to
# /debug/trace/<rid>.  Off (the default) the exposition is the plain text
# format.  Only histograms carry exemplars (the OpenMetrics rule).

EXEMPLARS_ENV = "KDLT_METRICS_EXEMPLARS"


def exemplars_enabled() -> bool:
    """Read the env gate afresh (a handful of calls per request)."""
    return os.environ.get(EXEMPLARS_ENV, "").strip() == "1"


def _escape_label_value(v) -> str:
    """Prometheus text-format label escaping: backslash, quote, newline."""
    return str(v).replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _escape_help(text: str) -> str:
    """HELP text escaping per the exposition format: backslash + newline."""
    return str(text).replace("\\", "\\\\").replace("\n", "\\n")


def _fmt_labels(labels: dict[str, str] | None, extra: str = "") -> str:
    parts = [f'{k}="{_escape_label_value(v)}"' for k, v in (labels or {}).items()]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


class Counter:
    kind = "counter"

    def __init__(self, name: str, help: str = "", labels: dict[str, str] | None = None):
        self.name, self.help, self.labels = name, help, labels
        self._value = 0.0
        self._lock = threading.Lock()

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        return self._value

    def sample_lines(self) -> list[str]:
        return [f"{self.name}{_fmt_labels(self.labels)} {self._value}"]


class Gauge(Counter):
    kind = "gauge"

    def set(self, v: float) -> None:
        with self._lock:
            self._value = v


class Histogram:
    kind = "histogram"

    def __init__(self, name: str, help: str = "", buckets=DEFAULT_BUCKETS,
                 labels: dict[str, str] | None = None):
        self.name, self.help, self.labels = name, help, labels
        self.buckets = tuple(buckets)
        self._counts = [0] * (len(self.buckets) + 1)  # +inf bucket
        self._sum = 0.0
        self._n = 0
        # Last exemplar per bucket index: (trace_id, value, unix time); only
        # callers passing ``exemplar=`` populate it.
        self._exemplars: dict[int, tuple[str, float, float]] = {}
        self._lock = threading.Lock()

    def observe(self, v: float, exemplar: str | None = None) -> None:
        i = bisect.bisect_left(self.buckets, v)
        with self._lock:
            self._counts[i] += 1
            self._sum += v
            self._n += 1
            if exemplar is not None:
                self._exemplars[i] = (str(exemplar), v, time.time())

    def percentile(self, q: float) -> float:
        """Approximate percentile from bucket upper bounds (q in [0,1])."""
        with self._lock:
            n = self._n
            if n == 0:
                return 0.0
            target = q * n
            cum = 0
            for i, c in enumerate(self._counts):
                cum += c
                if cum >= target:
                    return self.buckets[i] if i < len(self.buckets) else float("inf")
        return float("inf")

    @property
    def count(self) -> int:
        return self._n

    @property
    def sum(self) -> float:
        return self._sum

    def _exemplar_suffix(self, i: int, with_exemplars: bool) -> str:
        """Bucket ``i``'s exemplar annotation, or "" (always "" with the env
        gate off, so the plain exposition is unchanged)."""
        ex = self._exemplars.get(i) if with_exemplars else None
        if ex is None:
            return ""
        trace_id, value, ts = ex
        return f' # {{trace_id="{_escape_label_value(trace_id)}"}} {value:.6g} {ts:.3f}'

    def sample_lines(self) -> list[str]:
        out = []
        cum = 0
        with_ex = bool(self._exemplars) and exemplars_enabled()
        with self._lock:
            for i, (le, c) in enumerate(zip(self.buckets, self._counts)):
                cum += c
                le_label = f'le="{le}"'
                out.append(f"{self.name}_bucket{_fmt_labels(self.labels, le_label)} {cum}"
                           + self._exemplar_suffix(i, with_ex))
            cum += self._counts[-1]
            inf_label = 'le="+Inf"'
            out.append(f"{self.name}_bucket{_fmt_labels(self.labels, inf_label)} {cum}"
                       + self._exemplar_suffix(len(self.buckets), with_ex))
            out.append(f"{self.name}_sum{_fmt_labels(self.labels)} {self._sum}")
            out.append(f"{self.name}_count{_fmt_labels(self.labels)} {self._n}")
        return out


class Registry:
    def __init__(self, labels: dict[str, str] | None = None):
        """``labels`` are applied to every metric created through this
        registry (e.g. ``model=<name>`` per served model, so two models'
        engines never emit colliding series)."""
        self._metrics: list = []
        self._labels = dict(labels or {})
        self._keys: set = set()
        self._lock = threading.Lock()

    def counter(self, name: str, help: str = "") -> Counter:
        return self._add(Counter(name, help, labels=self._labels or None))

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._add(Gauge(name, help, labels=self._labels or None))

    def histogram(self, name: str, help: str = "", buckets=DEFAULT_BUCKETS) -> Histogram:
        return self._add(Histogram(name, help, buckets, labels=self._labels or None))

    def with_labels(self, **labels: str) -> "Registry":
        """Child registry sharing this one's output but adding labels."""
        child = Registry({**self._labels, **labels})
        self._add(child)
        return child

    def _add(self, m):
        with self._lock:
            name = getattr(m, "name", None)
            if name is not None:
                key = (name, tuple(sorted((m.labels or {}).items())))
                if key in self._keys:
                    raise ValueError(f"duplicate metric {name!r} with same labels")
                self._keys.add(key)
            self._metrics.append(m)
        return m

    def remove(self, m) -> None:
        """Drop a metric or child registry (an unloaded model version's
        series) from this registry's output."""
        with self._lock:
            if m in self._metrics:
                self._metrics.remove(m)
                name = getattr(m, "name", None)
                if name is not None:
                    self._keys.discard((name, tuple(sorted((m.labels or {}).items()))))

    def _leaves(self):
        """Every leaf metric under this registry, depth-first, in creation
        order (child registries flattened in place)."""
        with self._lock:
            metrics = list(self._metrics)
        for m in metrics:
            if isinstance(m, Registry):
                yield from m._leaves()
            else:
                yield m

    def render(self) -> str:
        """Prometheus text exposition, grouped by metric name: labeled series
        sharing a name render under ONE ``# HELP``/``# TYPE`` block (the
        format forbids repeating them); the first series' HELP/TYPE wins."""
        order: list[str] = []
        meta: dict[str, tuple[str, str]] = {}
        samples: dict[str, list[str]] = {}
        for m in self._leaves():
            if m.name not in meta:
                order.append(m.name)
                meta[m.name] = (m.kind, m.help)
                samples[m.name] = []
            samples[m.name].extend(m.sample_lines())
        out: list[str] = []
        for name in order:
            kind, help = meta[name]
            out.append(f"# HELP {name} {_escape_help(help)}")
            out.append(f"# TYPE {name} {kind}")
            out.extend(samples[name])
        return "\n".join(out) + "\n" if out else ""
