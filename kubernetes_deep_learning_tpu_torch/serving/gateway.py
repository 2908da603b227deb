"""The serving gateway: the IO tier, same public API as the reference.

The port's copy of the JAX package's ``serving/gateway.py``: the same
routes, wires, cache, replica pool, admission half, error replies and
``/generate`` relay, with three changes.  It talks to the model tier
through ``http.client`` (``serving.upstream.HttpClient``; the card's
machine has no ``requests``); it decodes with the port's PIL-free decoder
(``ops.preprocess``); and it has no brownout ladder, which comes with
ROADMAP A12b: no class is shed by brownout stage (neither a /predict nor a
/generate), hedging is never switched off and a TTL-expired cache entry
never serves.  ``POST /generate`` (the decode model, ``$KDLT_DECODE_MODEL``)
and ``/generate/<model>`` proxy the model tier's ``:generate`` token
stream chunk by chunk, outside the cache, coalescing and hedging.  Run it
as its own process, as the reference deploys it: ``kdlt-torch-gateway
--serving-host HOST:PORT`` (JAX's flags, less the brownout ones).

Reference behavior being reproduced (reference model_server.py:52-66):
``POST /predict`` with body ``{"url": "<image url>"}`` -> fetch the image,
preprocess, call the model tier, return ``{label: score}`` for every class.
The two-tier split and its rationale -- IO-bound gateway vs compute-bound
model server, keep the accelerator from idling on IO -- is the reference's
(guide.md:160-168) and is kept.

Differences, all TPU-first:

- preprocessing stops at resized **uint8**; normalization happens on the
  TPU where it fuses into the first conv (the reference ships float32
  TensorProtos, 3x the bytes);
- the model contract (input size, resize filter, labels) is **discovered**
  from the model server's /v1/models/<name> endpoint at startup instead of
  hardcoded (reference model_server.py:18,21-32,40-47);
- service discovery stays env-var based: ``KDLT_SERVING_HOST`` with a
  localhost default, exactly like the reference's ``TF_SERVING_HOST``
  (reference model_server.py:13, serving-gateway-deployment.yaml:22-24) --
  but the value may be a comma-separated REPLICA LIST (serving.upstream):
  per-replica health + circuit breakers, automatic failover on connect
  errors and 5xx, and deadline-budget-aware hedged requests
  (``KDLT_HEDGE_DELAY_MS``), so the gateway survives a model-tier replica
  dying instead of outsourcing all availability to the orchestrator.
"""

from __future__ import annotations

import argparse
import json
import os
import random
import re
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler

from kubernetes_deep_learning_tpu_torch.modelspec import ModelSpec
from kubernetes_deep_learning_tpu_torch.ops import preprocess
from kubernetes_deep_learning_tpu_torch.runtime.errors import BatcherClosed, QueueFull
from kubernetes_deep_learning_tpu_torch.serving import protocol
from kubernetes_deep_learning_tpu_torch.serving.httpserver import ServingHTTPServer, send_chunked
from kubernetes_deep_learning_tpu_torch.serving.admission import (
    DEADLINE_HEADER,
    AdmissionController,
    Deadline,
    Shed,
    install_sigterm_drain,
    retry_after_headers,
)
from kubernetes_deep_learning_tpu_torch.serving import cache as cache_lib
from kubernetes_deep_learning_tpu_torch.serving import faults as faults_lib
from kubernetes_deep_learning_tpu_torch.serving.microbatch import UpstreamStall
from kubernetes_deep_learning_tpu_torch.serving.tracing import (
    PARENT_SPAN_HEADER,
    REQUEST_ID_HEADER,
    TRACE_HEADER,
    ensure_request_id,
    log_request,
)
from kubernetes_deep_learning_tpu_torch.serving.upstream import (
    HttpClient,
    RequestException,
    UpstreamPool,
    resolve_serving_host,
)
from kubernetes_deep_learning_tpu_torch.utils import flightrecorder as incident_lib
from kubernetes_deep_learning_tpu_torch.utils import metrics as metrics_lib
from kubernetes_deep_learning_tpu_torch.utils import slo as slo_lib
from kubernetes_deep_learning_tpu_torch.utils import trace as trace_lib

DEFAULT_PORT = 9696          # reference gateway port (gateway.dockerfile:15-16)
DEFAULT_SERVING_HOST = "localhost:8500"  # reference model_server.py:13
SERVING_HOST_ENV = "KDLT_SERVING_HOST"
MODEL_ENV = "KDLT_MODEL"
DEFAULT_MODEL = "clothing-model"
# Multi-model routing: ``POST /predict`` keeps the reference's shape and
# serves the DEFAULT model ($KDLT_MODEL); ``POST /predict/<model>`` or the
# X-Kdlt-Model header route to any other model the tier's registry serves.
# Path wins over header (the more explicit signal).
MODEL_HEADER = protocol.MODEL_HEADER
WSGI_MODEL_KEY = "HTTP_X_KDLT_MODEL"  # the same headers as WSGI environ keys
# Priority classes: bounded X-Kdlt-Priority values, parsed once at the
# transport edge (unknown/absent -> interactive) and propagated upstream.
PRIORITY_HEADER = protocol.PRIORITY_HEADER
WSGI_PRIORITY_KEY = "HTTP_X_KDLT_PRIORITY"
# Model names are path/label material: constrain them before they touch
# URLs, metrics labels, or upstream requests.
_MODEL_NAME_RE = re.compile(r"^[A-Za-z0-9._-]{1,64}$")
# Generative lane routing: ``POST /generate`` streams tokens from the
# decode model (``/generate/<model>`` routes explicitly).  The default name
# mirrors the model tier's lane ($KDLT_DECODE_MODEL); the gateway holds
# only the NAME: the weights and the KV-cache live in the model tier.
DECODE_MODEL_ENV = "KDLT_DECODE_MODEL"
DEFAULT_DECODE_MODEL = "gen-default"
# A token stream outlives any single-response deadline: connect fast, then
# read with a generous idle timeout a chunk (each token resets it: it
# bounds decode silence, not stream length).
GENERATE_CONNECT_TIMEOUT_S = 5.0
GENERATE_IDLE_TIMEOUT_S = 60.0
PREDICT_TIMEOUT_S = 20.0     # reference's gRPC deadline (model_server.py:55)
PER_IMAGE_TIMEOUT_S = 0.25   # extra upstream budget per batched image: a
                             # 256-image predict is one POST and must not be
                             # held to the single-image 20 s deadline
UPSTREAM_RETRY_BACKOFF_S = 0.05  # one retry on the model tier's 503 overload
MIN_RETRY_BUDGET_S = 0.05    # a 503 retry must leave at least this much
                             # deadline budget AFTER the backoff sleep, or
                             # the retry is skipped (it cannot finish anyway)
MAX_BATCH_FETCHERS = 8       # default concurrent image downloads per batch
                             # request; $KDLT_FETCH_CONCURRENCY overrides
                             # (GUIDE Appendix A) -- the constant stays as
                             # the documented default and back-compat alias
FETCH_CONCURRENCY_ENV = "KDLT_FETCH_CONCURRENCY"
MAX_URLS_PER_REQUEST = 256   # hard cap: bounds per-request image memory
MAX_PREDICT_BODY_BYTES = 4 * 1024 * 1024  # /predict bodies are JSON of up to
# 256 URLs -- a few KB each covers any sane client; checked against
# Content-Length BEFORE reading so an adversarial multi-GB body cannot
# exhaust gateway memory (the model tier has the equivalent pre-read cap).


def resolve_fetch_concurrency(explicit: int | None = None) -> int:
    """Explicit arg > $KDLT_FETCH_CONCURRENCY > MAX_BATCH_FETCHERS; >= 1."""
    if explicit is not None:
        return max(1, int(explicit))
    raw = os.environ.get(FETCH_CONCURRENCY_ENV, "")
    try:
        return max(1, int(raw)) if raw.strip() else MAX_BATCH_FETCHERS
    except ValueError:
        return MAX_BATCH_FETCHERS


class _BytesWireRejected(Exception):
    """A bytes-wire POST came back 400/415: the replica pool is mixed-version
    (stale negotiation) or the server was flipped to KDLT_INGEST=0 after
    discovery.  Internal signal only -- the caller decodes at the gateway
    and resends the SAME request on the tensor wire, so the client never
    sees the rollout seam."""


class UpstreamError(RuntimeError):
    """Model-tier failure; surfaces as a retryable 5xx, never a client 400.

    ``retry_after_s`` carries the model tier's own Retry-After hint (or the
    circuit breaker's remaining cool-down) through to the client response.
    """

    def __init__(
        self, msg: str, http_status: int = 502, retry_after_s: float | None = None
    ):
        super().__init__(msg)
        self.http_status = http_status
        self.retry_after_s = retry_after_s


class Gateway:
    def __init__(
        self,
        serving_host: str | None = None,
        model: str | None = None,
        port: int = DEFAULT_PORT,
        host: str = "0.0.0.0",
        bind: bool = True,
        request_log: bool = False,
        upstream_batch: int = 0,
        upstream_delay_ms: float = 2.0,
        admission: bool | None = None,
        failover: bool | None = None,
        hedge_delay_ms: float | None = None,
        probe_interval_s: float | None = None,
        slo: bool | None = None,
        slo_windows=None,
        cache: bool | None = None,
        cache_ttl_s: float | None = None,
        cache_max_mb: float | None = None,
        cache_neg_ttl_s: float | None = None,
        cache_swr_s: float | None = None,
        pool_resolve_s: float | None = None,
        incident: bool | None = None,
        incident_dir: str | None = None,
        incident_triggers: str | None = None,
        incident_dedup_s: float | None = None,
        ingest: bool | None = None,
        fetch_concurrency: int | None = None,
    ):
        # request_log: print one traced line per /predict (rid, status,
        # duration).  Off by default for in-process use (tests, benches);
        # the CLI turns it on.  Errors are always logged, with the rid.
        self.request_log = request_log
        # upstream_batch > 0: coalesce concurrent single-image requests into
        # one upstream predict of up to this size (serving.microbatch) --
        # the model tier then sees few, fat requests.  0 = one upstream call
        # per request (the reference's shape, model_server.py:55).
        # Coalescing is PER MODEL (a batch must be one model's images);
        # non-default models get their batcher lazily on first request.
        self._upstream_batch = upstream_batch
        self._upstream_delay_ms = upstream_delay_ms
        self._microbatchers: dict[str, object] = {}
        self._microbatcher_lock = threading.Lock()
        self._microbatcher = None
        if upstream_batch > 0:
            self._microbatcher = self._make_microbatcher(None)
        # bind=False skips the in-tree HTTP server entirely (serving.wsgi
        # wraps the gateway so, for gunicorn).
        self.serving_host = serving_host or os.environ.get(
            SERVING_HOST_ENV, DEFAULT_SERVING_HOST
        )
        self.model = model or os.environ.get(MODEL_ENV, DEFAULT_MODEL)
        # /generate's default route target (a name only: this tier proxies
        # the token stream).
        self.decode_model = os.environ.get(DECODE_MODEL_ENV, "").strip() or DEFAULT_DECODE_MODEL
        self._session_obj = None
        self._session_lock = threading.Lock()
        self._spec_lock = threading.Lock()

        self.registry = metrics_lib.Registry()
        # Per-request span traces (utils.trace): the gateway half of the
        # cross-tier waterfall.  /debug/trace/<rid> on this tier MERGES the
        # model tier's spans in (fetched from the replica pool), so one GET
        # yields the full client-visible timeline.
        self.tracer = trace_lib.Tracer("gateway", registry=self.registry)
        # SLO engine (utils.slo): the CLIENT-OBSERVED per-model goodput/
        # burn-rate windows -- this tier sees what the user saw (including
        # failover/hedging saves the model tier's own view cannot know
        # about).  /debug/slo here also merges every replica's view.
        # slo_windows overrides the (label, seconds) window pair -- benches
        # compress hours of burn dynamics into seconds while keeping the
        # "5m" label contract the brownout ladder and dashboards key on.
        self.slo = slo_lib.SloEngine(
            self.registry, tier="gateway", enabled=slo,
            windows=slo_windows if slo_windows is not None else slo_lib.WINDOWS,
        )
        self._m_requests = self.registry.counter("kdlt_gateway_requests_total", "requests")
        self._m_errors = self.registry.counter("kdlt_gateway_errors_total", "errors")
        self._m_latency = self.registry.histogram(
            "kdlt_gateway_request_seconds", "end-to-end request latency"
        )
        self._m_fetch = self.registry.histogram(
            "kdlt_gateway_fetch_seconds", "image download+decode+resize latency"
        )
        # Admission control (serving.admission): deadline budgets, AIMD
        # concurrency limiting, shed accounting, graceful drain -- the
        # gateway-tier front door.  admission=None -> $KDLT_ADMISSION ->
        # enabled.  The breaker guards the upstream hop: a dead/saturated
        # model tier turns into fast local 503s instead of a thread-pinning
        # timeout per request.
        self.admission = AdmissionController(
            self.registry, tier="gateway", enabled=admission
        )
        # Incident flight recorder (utils.flightrecorder): the IO tier's
        # black box.  Every failure edge below (shed bursts, breaker
        # opens, pool churn) records into its timeline, and the trigger
        # engine turns sustained signals into /debug/incidents bundles.
        # Built BEFORE the pool (which takes its hook).
        self.recorder = incident_lib.FlightRecorder(
            "gateway", self.registry, tracer=self.tracer,
            enabled=incident, incident_dir=incident_dir,
            triggers=incident_triggers, dedup_s=incident_dedup_s,
        )
        # Content-addressed response cache + singleflight coalescing
        # (serving.cache): checked AHEAD of admission, so a hit consumes no
        # AIMD concurrency slot, no preprocessing, and no upstream/device
        # work, while identical in-flight misses collapse into ONE upstream
        # flight (hedging fires once per flight, not per caller).
        # cache=None -> $KDLT_CACHE -> enabled; KDLT_CACHE=0 kills the
        # whole subsystem (cache AND coalescing) -- the exact legacy path.
        self.cache = (
            cache_lib.ResponseCache(
                self.registry, ttl_s=cache_ttl_s, max_mb=cache_max_mb,
                neg_ttl_s=cache_neg_ttl_s, swr_s=cache_swr_s,
            )
            if cache_lib.cache_enabled(cache)
            else None
        )
        self._singleflight = cache_lib.SingleFlight()
        # Raw-bytes ingest wire (GUIDE 10q): when enabled here (KDLT_INGEST,
        # default on; ``ingest`` arg overrides) AND the model tier
        # advertised the capability during spec discovery (X-Kdlt-Ingest),
        # fetched JPEG/PNG bytes travel upstream verbatim and the MODEL
        # tier decodes -- this tier's Python stops paying decode+resize
        # CPU per image.  Unsniffable blobs and mixed-version replicas
        # fall back per request to the legacy tensor wire (reason-labelled
        # counters below).  The decoded-uint8 cache serves the LEGACY
        # preprocess path here: a repeat image skips decode+resize.
        self._ingest_enabled = protocol.ingest_enabled(ingest)
        self._ingest_caps: dict[str, tuple] = {}
        self._fetch_concurrency = resolve_fetch_concurrency(fetch_concurrency)
        self.decoded_cache = cache_lib.DecodedCache(registry=self.registry)
        self._m_ingest = metrics_lib.ingest_gateway_metrics(self.registry)
        # Multi-replica upstream pool (serving.upstream): replica list from
        # the serving host, per-replica health + breaker, hedging policy.
        # With a single replica this degrades to exactly the PR 2 posture
        # (one breaker, no failover possible).  Dynamic membership: a
        # dns+srv:// serving host carries its own resolver; a plain list
        # re-resolves its DNS names when KDLT_POOL_RESOLVE_S /
        # --pool-resolve-s asks for it (the pool builds that resolver).
        hosts, resolver = resolve_serving_host(self.serving_host)
        self.pool = UpstreamPool(
            hosts,
            registry=self.registry,
            failover=failover,
            hedge_delay_ms=hedge_delay_ms,
            probe_interval_s=probe_interval_s,
            resolver=resolver,
            resolve_interval_s=pool_resolve_s,
            on_event=self.recorder.record,
        )
        self.pool.start_probing()
        # What a bundle snapshots: the same documents the /debug pages
        # serve, captured at fire time (the pages themselves only show
        # NOW; the bundle is the page as of the incident).
        self.recorder.add_snapshot_provider("slo", self.slo.debug_payload)
        self.recorder.add_snapshot_provider("pool", self.pool.debug_payload)
        self.recorder.add_snapshot_provider("cache", self._cache_debug)
        # Fault injection (serving.faults): the gateway.upstream point;
        # None (zero-overhead) unless $KDLT_FAULTS configures rules.
        self._faults = faults_lib.from_env()
        if self._faults is not None:
            self._faults.attach(self.registry)

        self._httpd = None
        self.port = port
        if bind:
            self._httpd = ServingHTTPServer((host, port), self._make_handler())
            self.port = self._httpd.server_address[1]
        self._thread: threading.Thread | None = None

    # --- model routing -----------------------------------------------------

    def _make_microbatcher(self, model: str | None):
        from kubernetes_deep_learning_tpu_torch.serving.microbatch import (
            UpstreamMicroBatcher,
        )

        return UpstreamMicroBatcher(
            lambda images, request_id, _m=model: self._predict_batch(
                images, request_id, model=_m
            ),
            max_batch=self._upstream_batch,
            max_delay_ms=self._upstream_delay_ms,
        )

    def _microbatcher_for(self, model: str | None):
        """The per-model upstream micro-batcher (None when coalescing is
        off).  One per model: a flush must be one model's images."""
        if self._upstream_batch <= 0:
            return None
        if model is None or model == self.model:
            return self._microbatcher
        with self._microbatcher_lock:
            mb = self._microbatchers.get(model)
            if mb is None:
                mb = self._make_microbatcher(model)
                self._microbatchers[model] = mb
            return mb

    def resolve_model(self, path: str, header: str | None) -> str | None:
        """Route a /predict request to a model name.

        ``/predict`` -> the default model (reference-compatible);
        ``/predict/<model>`` -> that model; the X-Kdlt-Model header applies
        when the path carries no model.  Returns None for a malformed name
        (the transports answer 404 without touching the upstream).
        """
        model: str | None = None
        if path.startswith("/predict/"):
            model = path[len("/predict/"):]
        elif header:
            model = str(header).strip()
        if model is None or model == self.model:
            return self.model
        if not _MODEL_NAME_RE.match(model):
            return None
        return model

    # --- model-server client ----------------------------------------------

    def _session(self) -> HttpClient:
        # One shared client: connections to the model tier are pooled
        # across handler threads (64 idle per replica) instead of a fresh
        # TCP setup per short-lived client connection.
        if self._session_obj is None:
            with self._session_lock:
                if self._session_obj is None:
                    self._session_obj = HttpClient()
        return self._session_obj

    def _fetch_spec(self, replica, model: str | None = None) -> ModelSpec:
        """GET one replica's /v1/models/<name> contract (RequestException
        propagates -- the caller decides whether that means failover)."""
        r = self._session().get(
            f"{replica.base}/v1/models/{model or self.model}", timeout=10
        )
        if r.status_code == 404:
            raise UpstreamError(
                f"model tier serves no model {model or self.model!r}", 404
            )
        r.raise_for_status()
        # Ingest negotiation rides spec discovery (GUIDE 10q): the header's
        # presence IS the capability; an old server never sends it and this
        # gateway stays on the tensor wire for that model.
        replica.ingest_caps = protocol.parse_ingest_caps(
            r.headers.get(protocol.INGEST_HEADER)
        )
        return ModelSpec.from_json(r.text)

    @property
    def spec(self) -> ModelSpec:
        """The DEFAULT model's contract, discovered from the model tier.

        Discovery sweeps the replica pool (healthy replicas first) and the
        first answer becomes the pool's ``reference_spec`` -- the contract
        every other replica is validated against before serving traffic
        (see _validate_replica_spec).
        """
        return self.spec_for(None)

    def spec_for(self, model: str | None) -> ModelSpec:
        """A model's reference contract, discovered on first use.

        The default model keeps the original pool.reference_spec slot
        (back-compat for everything built on the single-model surface);
        other models land in pool.reference_specs keyed by name.
        """
        pool = self.pool
        default = model is None or model == self.model
        cached = (
            pool.reference_spec if default else pool.reference_specs.get(model)
        )
        if cached is not None:
            return cached
        with self._spec_lock:
            cached = (
                pool.reference_spec if default
                else pool.reference_specs.get(model)
            )
            if cached is not None:
                return cached
            last_exc: Exception | None = None
            for replica in pool.snapshot_ordered():
                try:
                    spec = self._fetch_spec(replica, None if default else model)
                except UpstreamError:
                    raise  # a 404 is an answer (unknown model), not an outage
                except RequestException as e:
                    last_exc = e
                    continue
                if default:
                    replica.spec = spec
                    pool.reference_spec = spec
                else:
                    replica.specs[model] = spec
                    pool.reference_specs[model] = spec
                # The reference replica's advertised ingest caps become the
                # routed model's negotiation outcome; a stale answer on a
                # mixed pool is healed per request (_BytesWireRejected).
                self._ingest_caps["" if default else model] = getattr(
                    replica, "ingest_caps", ()
                )
                return spec
            raise UpstreamError(
                f"model spec discovery failed: {last_exc}"
            ) from last_exc

    def supports_ingest(self, cap: str, model: str | None = None) -> bool:
        """Negotiated ingest capability for the routed model: this gateway
        has KDLT_INGEST on AND the model tier advertised ``cap`` at spec
        discovery.  ``cap`` is a protocol.INGEST_CAPS member (kdlt-lint's
        closed-vocabulary registry covers call sites)."""
        if not self._ingest_enabled:
            return False
        default = model is None or model == self.model
        return cap in self._ingest_caps.get("" if default else model, ())

    def _fetch_one_for(self, url: str, model: str | None, tags: dict | None = None):
        """url -> the model's resized uint8 HWC image (the host-side half of
        the pipeline).  ``tags`` (a span's) receives the fetch, decode and
        resize milliseconds."""
        spec = self.spec_for(model)
        t0 = time.perf_counter()
        data = self._fetch_timed(url, tags)
        image = self._decode_cached(data, spec, tags)
        self._m_fetch.observe(time.perf_counter() - t0)
        return image

    def _fetch_timed(self, url: str, tags: dict | None = None) -> bytes:
        t0 = time.perf_counter()
        data = preprocess.fetch_image_bytes(url)
        if tags is not None:
            tags["fetch_ms"] = round((time.perf_counter() - t0) * 1e3, 3)
        return data

    def _decode_cached(self, data: bytes, spec, tags: dict | None = None):
        """Decode+resize through the decoded-uint8 cache: content-addressed
        by (payload hash, preprocess params), so a repeat image -- same
        bytes, any URL, any model sharing the resolution/filter -- skips
        the gateway's decode+resize CPU entirely."""
        cache = self.decoded_cache
        key = None
        if cache.enabled:
            key = cache_lib.decoded_key(
                data, cache_lib.decoded_params(spec.input_shape, spec.resize_filter)
            )
            hit = cache.get(key)
            if hit is not None:
                if tags is not None:
                    tags["decoded_cache"] = "hit"
                return hit
        t0 = time.perf_counter()
        pixels = preprocess.decode_image(data)
        t1 = time.perf_counter()
        image = preprocess.resize_uint8(pixels, spec.input_shape[:2], spec.resize_filter)
        if tags is not None:
            tags["decode_ms"] = round((t1 - t0) * 1e3, 3)
            tags["resize_ms"] = round((time.perf_counter() - t1) * 1e3, 3)
        if key is not None:
            cache.put(key, image)
        return image

    def _fetch_one_bytes(self, url: str, trace=None, model: str | None = None):
        """Raw-bytes ingest fetch: download only -- no decode, no resize
        (that CPU moves to the model tier).  Returns the encoded payload;
        the caller sniffs it before committing to the bytes wire."""
        self.spec_for(model)  # contract discovery still gates serving
        if trace is None:
            t0 = time.perf_counter()
            data = self._fetch_timed(url)
            self._m_fetch.observe(time.perf_counter() - t0)
            return data
        with trace.span(trace_lib.SPAN_GATEWAY_PREPROCESS) as span:
            t0 = time.perf_counter()
            data = self._fetch_timed(url, span.tags)
            self._m_fetch.observe(time.perf_counter() - t0)
            return data

    def _fetch_one_traced(self, url: str, trace=None, model: str | None = None):
        """_fetch_one_for under a ``gateway.preprocess`` span, whose tags
        carry the fetch, decode and resize milliseconds."""
        if trace is None:
            return self._fetch_one_for(url, model)
        with trace.span(trace_lib.SPAN_GATEWAY_PREPROCESS) as span:
            return self._fetch_one_for(url, model, span.tags)

    def _validate_replica_spec(self, replica, model: str | None = None) -> None:
        """Failover spec re-validation: before a replica other than the
        reference source serves traffic, its contract must match the pool's
        reference -- a replica left serving a different model version
        surfaces as an explicit 502, never silently mixed responses.

        Only runs once a reference exists and only until the replica's spec
        is cached (it is re-cleared when the replica rejoins after being
        unhealthy).  RequestException propagates: an unreachable replica is
        a connect failure, which the failover loop routes around.  Checked
        PER MODEL: each routed model's contract is validated independently.
        """
        default = model is None or model == self.model
        reference = (
            self.pool.reference_spec if default
            else self.pool.reference_specs.get(model)
        )
        if reference is None:
            return
        if default:
            if replica.spec is None:
                replica.spec = self._fetch_spec(replica)
            cached = replica.spec
        else:
            cached = replica.specs.get(model)
            if cached is None:
                cached = replica.specs[model] = self._fetch_spec(replica, model)
        if cached.to_json() != reference.to_json():
            self.pool.mark_spec_mismatch(replica)
            raise UpstreamError(
                f"model-tier replica {replica.host} serves a different "
                f"model contract ({model or self.model!r}) than the pool "
                "reference", 502,
            )

    def _post_once(self, replica, body, request_id, deadline, timeout,
                   span_id: str = "", model: str | None = None,
                   priority: str | None = None, content_type: str | None = None):
        """One upstream POST to one replica (headers re-measured now)."""
        if self._faults is not None:
            self._faults.fire("gateway.upstream")
        headers = {"Content-Type": content_type or protocol.MSGPACK_CONTENT_TYPE}
        if request_id:  # cross-tier trace propagation
            headers[REQUEST_ID_HEADER] = request_id
        if span_id:  # this attempt's span: the model tier's root parent
            headers[PARENT_SPAN_HEADER] = span_id
        if deadline is not None:  # remaining budget, re-measured now
            headers[DEADLINE_HEADER] = deadline.header_value()
        if priority:  # class propagation: the model tier sheds by class too
            headers[PRIORITY_HEADER] = priority
        return self._session().post(
            f"{replica.base}/v1/models/{model or self.model}:predict",
            data=body,
            headers=headers,
            timeout=timeout,
        )

    def _attempt_traced(self, replica, body, request_id, deadline, timeout,
                        trace, role: str, model: str | None = None,
                        priority: str | None = None,
                        content_type: str | None = None):
        """One upstream POST recorded as a ``gateway.upstream`` span.

        Returns ``(response, span)``; on failure records the span with the
        error tag and re-raises.  The span id travels upstream as
        X-Kdlt-Parent-Span, so the model tier's subtree hangs off THIS
        attempt -- which is what makes a hedged request's waterfall show
        two distinguishable model-tier executions.
        """
        if trace is None:
            return self._post_once(
                replica, body, request_id, deadline, timeout, model=model,
                priority=priority, content_type=content_type,
            ), None
        sid = trace_lib.new_span_id()
        w0 = trace_lib.now_s()
        try:
            r = self._post_once(
                replica, body, request_id, deadline, timeout, span_id=sid,
                model=model, priority=priority, content_type=content_type,
            )
        except Exception as e:
            trace.tracer.record(
                trace.trace_id, trace_lib.SPAN_GATEWAY_UPSTREAM, w0,
                trace_lib.now_s() - w0, parent_id=trace.span_id, span_id=sid,
                replica=replica.host, role=role, error=str(e)[:120],
            )
            raise
        span = trace.tracer.record(
            trace.trace_id, trace_lib.SPAN_GATEWAY_UPSTREAM, w0, trace_lib.now_s() - w0,
            parent_id=trace.span_id, span_id=sid,
            replica=replica.host, role=role, status=r.status_code,
        )
        return r, span

    def _post_hedged(
        self, primary, body, request_id, deadline, timeout, tried,
        trace=None, role: str = "primary", model: str | None = None,
        priority: str | None = None, content_type: str | None = None,
    ):
        """POST with a deadline-budget-aware hedged second attempt.

        If the primary has not answered within the pool's hedge delay AND
        another healthy replica exists AND the remaining budget can still
        cover a useful attempt, a second request fires against that
        replica; the first usable answer wins and the loser is abandoned
        (its daemon thread reads its response whole before the connection
        goes back to the pool, or closes it on any failure -- plain
        HTTP/1.1 has no cancel).  Tail-at-scale hedging: the hedge
        only ever duplicates the slowest requests, so the added load is
        bounded by the hedge-delay percentile.

        Returns ``(winning_replica, response)``.  If every attempt raised,
        failures are recorded for the hedge replica (the caller records the
        primary's), the hedge replica is appended to ``tried``, and the
        primary's exception re-raises.
        """
        pool = self.pool
        delay = pool.hedge_delay_s
        hedgeable = (
            pool.failover
            and delay > 0
            and pool.has_healthy_candidate(exclude=[primary, *tried])
            and (
                deadline is None
                or deadline.remaining_s() > delay + MIN_RETRY_BUDGET_S
            )
        )
        if not hedgeable:
            r, span = self._attempt_traced(
                primary, body, request_id, deadline, timeout, trace, role,
                model=model, priority=priority, content_type=content_type,
            )
            if span is not None:
                span.tags["winner"] = True
            return primary, r
        import queue as queue_lib

        results: queue_lib.Queue = queue_lib.Queue()

        def attempt(rep, rep_role):
            try:
                r, span = self._attempt_traced(
                    rep, body, request_id, deadline, timeout, trace, rep_role,
                    model=model, priority=priority, content_type=content_type,
                )
                results.put((rep, r, None, span))
            except Exception as e:  # noqa: BLE001 - reported via the queue
                results.put((rep, None, e, None))

        threading.Thread(
            target=attempt, args=(primary, role), name="kdlt-upstream-primary",
            daemon=True,
        ).start()
        try:
            first = results.get(timeout=delay)
        except queue_lib.Empty:
            first = None
        hedge = None
        if first is None:
            # Primary is slow past the hedge delay: fire the hedge.
            hedge = pool.choose(
                exclude=[primary, *tried],
                gate_breaker=self.admission.enabled,
            )
            if hedge is None:
                first = results.get()
            else:
                if pool.m_hedge_fired is not None:
                    pool.m_hedge_fired.inc()
                threading.Thread(
                    target=attempt, args=(hedge, "hedge"),
                    name="kdlt-upstream-hedge", daemon=True,
                ).start()
                first = results.get()
        outcomes = [first]
        if hedge is not None and not self._usable(first):
            # The faster attempt failed; the slower one may still win.
            outcomes.append(results.get())
        winner = next((o for o in outcomes if self._usable(o)), None)
        if winner is None:
            # No usable answer; prefer returning a 5xx response (the
            # caller's 503/failover policy applies) over raising.
            winner = next((o for o in outcomes if o[1] is not None), None)
        if winner is not None:
            rep, r, _exc, span = winner
            if span is not None:
                # The used attempt is marked on the trace: a hedged
                # request's waterfall shows BOTH attempt spans and which
                # one's response the client actually got.
                span.tags["winner"] = True
            for lrep, lr, lexc, _lspan in outcomes:
                if lrep is rep:
                    continue  # the caller accounts the winner's outcome
                if lexc is not None or (lr is not None and lr.status_code >= 500):
                    pool.record_failure(lrep)
                    if lr is not None and lr.headers.get(
                        protocol.STALLED_HEADER
                    ):
                        pool.mark_stalled(lrep)  # declared stall: out now
                    if lrep not in tried:
                        tried.append(lrep)  # a known-bad failover target
            if hedge is not None and rep is hedge and pool.m_hedge_won is not None:
                pool.m_hedge_won.inc()
            return rep, r
        # Every observed attempt raised: account the hedge's failure here
        # (the caller only knows the primary) and re-raise the primary's.
        primary_exc = None
        for lrep, _lr, lexc, _lspan in outcomes:
            if lrep is primary:
                primary_exc = lexc
                continue
            pool.record_failure(lrep)
            if lrep not in tried:
                tried.append(lrep)
        raise primary_exc if primary_exc is not None else outcomes[-1][2]

    @staticmethod
    def _usable(outcome) -> bool:
        """A hedged attempt outcome worth returning: a response that is not
        a server-side failure (2xx-4xx means the tier is up and judged the
        request on its merits)."""
        _rep, r, exc, _span = outcome
        return exc is None and r is not None and r.status_code < 500

    @staticmethod
    def _status_error(r) -> UpstreamError:
        """Map a non-200 upstream response to the client-facing error.
        A 404 passes through: "no such model" is the caller's mistake
        (bad route), not a tier outage dressed up as a 502."""
        if r.status_code == 404:
            return UpstreamError(
                f"model server error 404: {r.text[:200]}", 404
            )
        status = 503 if r.status_code == 503 else 502
        retry_after = None
        if status == 503:
            try:
                retry_after = float(r.headers.get("Retry-After", ""))
            except (TypeError, ValueError):
                retry_after = None
        return UpstreamError(
            f"model server error {r.status_code}: {r.text[:200]}",
            status,
            retry_after_s=retry_after,
        )

    def _predict_batch(
        self,
        images,
        request_id: str = "",
        deadline: Deadline | None = None,
        trace=None,
        model: str | None = None,
        priority: str | None = None,
    ) -> tuple[list, list[str]]:
        """uint8 (N,H,W,C) -> (logit rows, labels) via the legacy tensor
        wire (msgpack uint8)."""
        return self._predict_wire(
            protocol.encode_predict_request(images), images.shape[0],
            request_id, deadline, trace, model, priority,
        )

    def _predict_bytes(
        self,
        blobs: list[bytes],
        request_id: str = "",
        deadline: Deadline | None = None,
        trace=None,
        model: str | None = None,
        priority: str | None = None,
    ) -> tuple[list, list[str]]:
        """Encoded JPEG/PNG blobs -> (logit rows, labels) via the raw-bytes
        ingest wire (GUIDE 10q): the model tier decodes.  Raises
        _BytesWireRejected on an upstream 400/415 so the caller can decode
        locally and resend on the tensor wire (mixed-pool rollout)."""
        body = protocol.encode_bytes_predict_request(blobs)
        self._m_ingest["bytes_requests"].inc()
        self._m_ingest["wire_bytes"].inc(len(body))
        return self._predict_wire(
            body, len(blobs), request_id, deadline, trace, model, priority,
            content_type=protocol.BYTES_CONTENT_TYPE,
        )

    def _predict_wire(
        self,
        body: bytes,
        n_images: int,
        request_id: str = "",
        deadline: Deadline | None = None,
        trace=None,
        model: str | None = None,
        priority: str | None = None,
        content_type: str | None = None,
    ) -> tuple[list, list[str]]:
        """One encoded request body -> (logit rows, labels) via the model
        tier; the shared upstream engine for both wire formats.

        Failure policy over the replica pool (serving.upstream):

        - a connect error / injected fault fails over to the next replica
          (passive health + breaker bookkeeping per replica) until the
          pool or the deadline budget is exhausted;
        - a 503 (the tier's explicit transient overload signal) fails over
          immediately when another HEALTHY replica exists; otherwise it
          keeps PR 2's single-upstream shape -- one brief backoff retry
          against the same replica, budget permitting;
        - slow responses are hedged to a second replica after the hedge
          delay (_post_hedged), budget permitting;
        - when every replica is refused up front (breakers open), the
          request sheds locally as breaker_open, Retry-After = the
          soonest any replica might recover.

        Deadline-aware throughout: the read timeout is clamped to the
        request's remaining budget (a caller that will give up in 800 ms
        must not hold this thread for 20 s) and the REMAINING budget
        travels upstream in the deadline header.
        """
        pool = self.pool
        gate = self.admission.enabled
        # (connect, read) pair: only the READ budget scales with batch size;
        # an unreachable model tier should still fail fast at connect.
        base_read = (
            PREDICT_TIMEOUT_S + PER_IMAGE_TIMEOUT_S * max(0, n_images - 1)
        )
        tried: list = []
        retried_503 = False
        last_exc: UpstreamError | None = None
        r = None
        while True:
            replica = pool.choose(exclude=tried, gate_breaker=gate)
            if replica is None:
                if not tried and gate:
                    # Every replica refused up front: fast local shed
                    # instead of a thread-pinning timeout per request.
                    self.admission.count_shed("breaker_open")
                    self.recorder.note_shed()
                    self.recorder.record("breaker.open", rid=request_id or None)
                    raise UpstreamError(
                        "model tier circuit breaker is open",
                        503,
                        retry_after_s=pool.min_retry_after_s() or 0.5,
                    )
                if last_exc is not None:
                    raise last_exc
                if r is not None:
                    raise self._status_error(r)
                raise UpstreamError(
                    "no model-tier replica available", 503, retry_after_s=0.5
                )
            if tried and pool.m_failover is not None:
                pool.m_failover.inc()
            read_timeout = base_read
            if deadline is not None:
                read_timeout = deadline.clamp(read_timeout, floor_s=0.05)
            timeout = (
                min(PREDICT_TIMEOUT_S, max(read_timeout, 0.05)), read_timeout
            )
            try:
                self._validate_replica_spec(replica, model)
                replica, r = self._post_hedged(
                    replica, body, request_id, deadline, timeout, tried,
                    trace=trace,
                    role="failover" if tried else "primary",
                    model=model, priority=priority, content_type=content_type,
                )
            except (
                RequestException,
                faults_lib.InjectedFault,
                ConnectionError,
            ) as e:
                pool.record_failure(replica)
                if replica not in tried:
                    tried.append(replica)
                last_exc = UpstreamError(f"model server unreachable: {e}")
                last_exc.__cause__ = e
                if not pool.failover:
                    # Blind mode (KDLT_FAILOVER=0, the chaos-A/B baseline
                    # arm): one attempt, the failure surfaces as-is.
                    raise last_exc
                if deadline is not None and (
                    deadline.remaining_s() < MIN_RETRY_BUDGET_S
                ):
                    raise last_exc  # no budget left to try anyone else
                continue
            # Breaker/health bookkeeping per attempt: any 5xx (including
            # the tier's 503 shed) is evidence of an unhealthy/saturated
            # replica; 2xx-4xx means it is up and judging requests on
            # their merits.
            if r.status_code >= 500:
                pool.record_failure(replica)
                if r.headers.get(protocol.STALLED_HEADER):
                    # A DECLARED dispatch stall (the replica's watchdog
                    # fired; only a restart recovers it) is not transient
                    # overload: take the replica out of rotation NOW
                    # instead of feeding it UNHEALTHY_AFTER more requests
                    # -- a stalled cross-host leader would otherwise keep
                    # stranding every coalesced flight that dials it.
                    pool.mark_stalled(replica)
            else:
                # Feed the replica's latency EWMA (the power-of-two-choices
                # ranking signal) from the winning response's own timing.
                elapsed = getattr(r, "elapsed", None)
                pool.record_success(
                    replica,
                    latency_s=(
                        elapsed.total_seconds() if elapsed is not None else None
                    ),
                )
            if r.status_code != 503:
                break
            last_exc = None
            if replica not in tried:
                tried.append(replica)
            if pool.has_healthy_candidate(exclude=tried):
                continue  # overloaded here; another healthy replica may not be
            if retried_503:
                break
            if deadline is not None and deadline.remaining_s() < (
                UPSTREAM_RETRY_BACKOFF_S + MIN_RETRY_BUDGET_S
            ):
                # A nearly-expired request must not burn its last budget
                # sleeping out the backoff and re-posting work that cannot
                # finish in time; surface the 503 to the client now.
                break
            retried_503 = True
            time.sleep(UPSTREAM_RETRY_BACKOFF_S)
            tried.remove(replica)  # the backoff retry re-targets this replica
        if r.status_code != 200:
            if (
                content_type == protocol.BYTES_CONTENT_TYPE
                and r.status_code in (400, 415)
            ):
                # The bytes wire was negotiated but THIS replica rejected
                # it (old code, or KDLT_INGEST flipped off after
                # discovery).  Signal the caller to decode locally and
                # resend on the tensor wire -- a rollout seam, never a
                # client-visible error.
                raise _BytesWireRejected(r.text[:200])
            raise self._status_error(r)
        if self.cache is not None:
            # Learn the serving artifact's identity from the response: a
            # CHANGED hash is a hot reload with different bytes, which
            # drops that model's cached entries (a byte-identical
            # re-export under a higher version keeps them).
            self.cache.note_artifact_hash(
                model or self.model,
                r.headers.get(protocol.ARTIFACT_HASH_HEADER, ""),
            )
        try:
            logits, labels = protocol.decode_predict_response(
                r.content, r.headers.get("Content-Type", "")
            )
        except Exception as e:
            # A 200 with an undecodable body is the model tier's fault
            # (truncated response, content-type mismatch), never the client's.
            raise UpstreamError(f"malformed model server response: {e}") from e
        return logits, labels

    def apply_model(
        self,
        url: str,
        request_id: str = "",
        deadline: Deadline | None = None,
        trace=None,
        model: str | None = None,
        priority: str | None = None,
    ) -> dict[str, float]:
        """url -> {label: score}; the reference's apply_model
        (reference model_server.py:52-56).  ``model`` routes to a
        non-default served model (multi-model registry).  ``priority``
        travels upstream on the direct path; micro-batched flushes mix
        classes, so a coalesced upstream POST carries none."""
        if self._ingest_enabled:
            self.spec_for(model)  # negotiation rides spec discovery
            if self.supports_ingest(protocol.INGEST_BYTES_CAP, model):
                # Raw-bytes wire (GUIDE 10q).  Bypasses the microbatcher:
                # the upstream POST already carries compact encoded bytes,
                # so coalescing would only add queueing delay.
                return self._apply_model_bytes(
                    url, request_id, deadline, trace, model, priority
                )
            self._m_ingest["fallbacks"]["negotiation"].inc()
        image = self._fetch_one_traced(url, trace, model=model)
        microbatcher = self._microbatcher_for(model)
        if microbatcher is not None:
            # Micro-batched flushes coalesce MANY requests' upstream hop
            # into one POST; the upstream attempt is not attributable to a
            # single request's subtree, so the trace records the wait as
            # one span instead.
            if trace is None:
                row, labels = microbatcher.predict(
                    image,
                    request_id,
                    timeout=None if deadline is None else deadline.remaining_s(),
                )
            else:
                with trace.span(trace_lib.SPAN_GATEWAY_MICROBATCH):
                    row, labels = microbatcher.predict(
                        image,
                        request_id,
                        timeout=None if deadline is None else deadline.remaining_s(),
                    )
            return dict(zip(labels, map(float, row)))
        logits, labels = self._predict_batch(
            image[None], request_id, deadline, trace, model=model,
            priority=priority,
        )
        return dict(zip(labels, map(float, logits[0])))

    def _apply_model_bytes(
        self, url, request_id, deadline, trace, model, priority,
    ) -> dict[str, float]:
        """apply_model over the raw-bytes ingest wire, with the per-request
        fallbacks (GUIDE 10q): an unsniffable blob (reason "format") or a
        replica that rejects the wire (reason "rejected") decodes at the
        gateway and resends the SAME fetched bytes on the tensor wire --
        never a second download, never a client-visible seam."""
        import numpy as np

        spec = self.spec_for(model)
        blob = self._fetch_one_bytes(url, trace, model)
        if protocol.sniff_image_format(blob) is not None:
            try:
                logits, labels = self._predict_bytes(
                    [blob], request_id, deadline, trace, model=model,
                    priority=priority,
                )
                return dict(zip(labels, map(float, logits[0])))
            except _BytesWireRejected:
                self._m_ingest["fallbacks"]["rejected"].inc()
        else:
            self._m_ingest["fallbacks"]["format"].inc()
        image = self._decode_cached(blob, spec)
        logits, labels = self._predict_batch(
            np.asarray(image)[None], request_id, deadline, trace, model=model,
            priority=priority,
        )
        return dict(zip(labels, map(float, logits[0])))

    def apply_model_batch(
        self,
        urls: list[str],
        request_id: str = "",
        deadline: Deadline | None = None,
        trace=None,
        model: str | None = None,
        priority: str | None = None,
    ) -> list[dict]:
        """urls -> per-url {label: score} or {"error": ...}, order-preserving.

        Beyond-reference extension: fetches run concurrently (IO-bound) and
        every successfully fetched image travels to the model tier as ONE
        predict (the tier splits oversize batches over its own bucket
        ladder, ServedModel.predict -- chunking policy lives in one place).
        A bad URL fails only its own entry; a model-tier failure fails the
        whole request (UpstreamError propagates, not a per-URL condition).
        """
        from concurrent.futures import ThreadPoolExecutor

        if not urls:
            return []
        if len(urls) > MAX_URLS_PER_REQUEST:
            raise ValueError(
                f"{len(urls)} urls exceeds the {MAX_URLS_PER_REQUEST}-url limit"
            )
        self.spec_for(model)  # discover contract FIRST: outage => 502, not 200
        if self._ingest_enabled:
            if self.supports_ingest(protocol.INGEST_BYTES_CAP, model):
                return self._apply_model_batch_bytes(
                    urls, request_id, deadline, trace, model, priority
                )
            self._m_ingest["fallbacks"]["negotiation"].inc()
        with ThreadPoolExecutor(
            max_workers=min(len(urls), self._fetch_concurrency)
        ) as ex:
            fetched = list(
                ex.map(lambda u: self._fetch_one_safe(u, trace, model), urls)
            )
        good = [(i, img) for i, (img, _) in enumerate(fetched) if img is not None]
        results: list[dict] = [
            {"error": err} if err is not None else {} for _, err in fetched
        ]
        if good:
            import numpy as np

            logits, labels = self._predict_batch(
                np.stack([img for _, img in good]), request_id, deadline,
                trace, model=model, priority=priority,
            )
            for row, (i, _) in enumerate(good):
                results[i] = dict(zip(labels, map(float, logits[row])))
        return results

    def _apply_model_batch_bytes(
        self, urls, request_id, deadline, trace, model, priority,
    ) -> list[dict]:
        """apply_model_batch over the raw-bytes ingest wire.

        Wire choice is per REQUEST: all sniffable blobs -> one bytes POST;
        any exotic blob drops the whole request to the tensor wire (reason
        "format") so the batch stays one upstream flight either way, and a
        _BytesWireRejected replica gets the tensor resend (reason
        "rejected").  Per-URL failure semantics match the legacy path: a
        bad download or undecodable blob fails only its own entry."""
        from concurrent.futures import ThreadPoolExecutor

        import numpy as np

        spec = self.spec_for(model)

        def fetch(u):
            try:
                return self._fetch_one_bytes(u, trace, model), None
            except UpstreamError:
                raise  # model-tier trouble fails the request, not the URL
            except Exception as e:  # noqa: BLE001 - per-URL failure
                return None, str(e)

        with ThreadPoolExecutor(
            max_workers=min(len(urls), self._fetch_concurrency)
        ) as ex:
            fetched = list(ex.map(fetch, urls))
        good = [(i, blob) for i, (blob, _) in enumerate(fetched) if blob is not None]
        results: list[dict] = [
            {"error": err} if err is not None else {} for _, err in fetched
        ]
        if not good:
            return results
        logits = labels = None
        if all(protocol.sniff_image_format(b) is not None for _, b in good):
            try:
                logits, labels = self._predict_bytes(
                    [b for _, b in good], request_id, deadline, trace,
                    model=model, priority=priority,
                )
            except _BytesWireRejected:
                self._m_ingest["fallbacks"]["rejected"].inc()
        else:
            self._m_ingest["fallbacks"]["format"].inc()
        if logits is None:
            # Tensor-wire fallback: decode the already-fetched bytes here
            # (through the decoded cache); a blob that fails to decode
            # fails only its own entry, like a bad URL.
            keep, images = [], []
            for i, blob in good:
                try:
                    images.append(self._decode_cached(blob, spec))
                    keep.append(i)
                except Exception as e:  # noqa: BLE001 - per-URL failure
                    results[i] = {"error": str(e)}
            if not keep:
                return results
            good = [(i, None) for i in keep]
            logits, labels = self._predict_batch(
                np.stack(images), request_id, deadline, trace, model=model,
                priority=priority,
            )
        for row, (i, _) in enumerate(good):
            results[i] = dict(zip(labels, map(float, logits[row])))
        return results

    def _fetch_one_safe(self, url: str, trace=None, model: str | None = None):
        try:
            return self._fetch_one_traced(url, trace, model=model), None
        except UpstreamError:
            raise  # model-tier trouble is the request's failure, not the URL's
        except Exception as e:
            return None, str(e)

    # --- transport-neutral request handling --------------------------------
    # One implementation of routing, error mapping, and metrics policy,
    # shared by the in-tree threaded server below and serving.wsgi (gunicorn)
    # so the two deployment postures can never diverge.

    def handle_get(self, path: str) -> tuple[int, bytes, str]:
        """Route a GET; returns (status, body, content_type)."""
        if path == "/healthz":
            return 200, b"ok", "text/plain"
        if path == "/readyz":
            if self.admission.draining:
                # Drain flips readiness FIRST so the Service/LB stops
                # routing here while in-flight work completes.
                return 503, b"draining", "text/plain"
            try:
                self.spec  # reachable + spec discoverable => ready
                return 200, b"ready", "text/plain"
            except Exception as e:
                return 503, str(e).encode(), "text/plain"
        if path == "/metrics":
            # Pull-model freshness: SLO window gauges recompute at scrape.
            self.slo.refresh()
            return 200, self.registry.render().encode(), "text/plain"
        if path == "/debug/slo":
            return (
                200, json.dumps(self.handle_slo()).encode(), "application/json"
            )
        if path == "/debug/cache":
            # The response cache's operator surface: sizing, hit ratio,
            # per-model residency, resolved artifact hashes, and the
            # singleflight's live flight count.
            return (
                200, json.dumps(self._cache_debug()).encode(),
                "application/json",
            )
        if path == "/debug/pool":
            # The replica pool's operator surface: membership, per-replica
            # health/quarantine/drain state, picks, and the latency EWMA
            # driving power-of-two-choices (kdlt-client --stats renders
            # the per-replica rows from this).
            return (
                200,
                json.dumps(self.pool.debug_payload()).encode(),
                "application/json",
            )
        if path.split("?", 1)[0] == "/debug/profile":
            # Bucket-shape audit, merged across the fleet: each replica's
            # per-bucket padding waste and compiled FLOPs/img (the numbers
            # that say whether the bucket ladder fits the traffic).
            return (
                200, json.dumps(self.handle_profile()).encode(),
                "application/json",
            )
        if path in ("/debug", "/debug/"):
            # The debug INDEX: every debug surface this tier serves, with
            # a one-line description -- so operators (and kdlt-client
            # --stats) need not memorize the route list.
            return (
                200, json.dumps(self.debug_index()).encode(),
                "application/json",
            )
        if path in ("/debug/incidents", "/debug/incidents/"):
            return (
                200, json.dumps(self.handle_incidents()).encode(),
                "application/json",
            )
        if path.startswith("/debug/incidents/"):
            return self.handle_incident(path.rsplit("/", 1)[-1])
        if path.startswith("/debug/trace/"):
            return self.handle_trace(path.rsplit("/", 1)[-1])
        return 404, b'{"error": "not found"}', "application/json"

    def _cache_debug(self) -> dict:
        # "decoded" is the decoded-uint8 tier (content-addressed, GUIDE
        # 10q) -- independent of the response cache, so it reports even
        # when KDLT_CACHE=0 disables the response tier.
        decoded = {"decoded": self.decoded_cache.stats()}
        if self.cache is None:
            return {"enabled": False, **decoded}
        return {
            "enabled": True,
            **self.cache.stats(),
            **self._singleflight.stats(),
            **decoded,
        }

    def debug_index(self) -> dict:
        """GET /debug/: this tier's debug routes, one line each."""
        return {
            "tier": "gateway",
            "routes": {
                "/debug/slo": "merged fleet SLO view: gateway-observed + "
                "every replica's goodput and burn windows",
                "/debug/cache": "response cache sizing, hit ratio, "
                "per-model residency, live singleflight count",
                "/debug/pool": "upstream membership and per-replica "
                "health/quarantine/drain, picks, latency EWMA",
                "/debug/profile?audit=buckets": "merged bucket-shape "
                "audit: per-replica padding waste and FLOPs/img per bucket",
                "/debug/incidents": "flight-recorder bundles (own + "
                "replicas'), merged into causal windows",
                "/debug/incidents/<id>": "one full incident bundle "
                "(timeline, pinned traces, snapshots, metrics delta)",
                "/debug/trace/<rid>": "merged cross-tier span waterfall "
                "for one request id",
            },
        }

    def handle_incidents(self) -> dict:
        """GET /debug/incidents: this tier's bundles plus every model-tier
        replica's, merged into causal windows (one failure fires triggers
        on several processes within seconds; the window groups them).
        Unreachable replicas degrade to error entries, never a failed
        response -- incident review must work during the incident."""
        payload = self.recorder.debug_payload()
        own = payload["incidents"]
        for e in own:
            e["origin"] = "gateway"
        entries = list(own)
        replicas: dict[str, object] = {}
        for replica in self.pool.replicas:
            try:
                r = self._session().get(
                    f"{replica.base}/debug/incidents", timeout=2.0
                )
                if r.status_code != 200:
                    replicas[replica.host] = {
                        "error": f"status {r.status_code}"
                    }
                    continue
                body = r.json()
                remote = body.get("incidents", [])
                for e in remote:
                    e["origin"] = replica.host
                replicas[replica.host] = remote
                entries.extend(remote)
            except Exception as e:  # noqa: BLE001 - partial views beat none
                replicas[replica.host] = {"error": str(e)[:200]}
        payload["replicas"] = replicas
        payload["windows"] = incident_lib.merge_windows(entries)
        return payload

    def handle_incident(self, bundle_id: str) -> tuple[int, bytes, str]:
        """GET /debug/incidents/<id>: the full bundle -- own first, then
        each replica is asked (the id encodes nothing about its origin;
        the gateway is the tier that knows the replica list)."""
        bundle = self.recorder.get(bundle_id)
        if bundle is None:
            for replica in self.pool.replicas:
                try:
                    r = self._session().get(
                        f"{replica.base}/debug/incidents/{bundle_id}",
                        timeout=2.0,
                    )
                    if r.status_code == 200:
                        bundle = r.json()
                        break
                except Exception:  # noqa: BLE001 - try the next replica
                    continue
        if bundle is None:
            return (
                404,
                json.dumps(
                    {"error": f"no incident bundle {bundle_id!r} on any tier"}
                ).encode(),
                "application/json",
            )
        return 200, json.dumps(bundle).encode(), "application/json"

    def handle_slo(self) -> dict:
        """GET /debug/slo: the MERGED fleet SLO view.

        Three sections: ``gateway`` is this tier's own accounting (what
        clients experienced, failover/hedging included), ``replicas`` is
        each model-tier replica's /debug/slo verbatim, and ``merged`` sums
        the replicas' raw counts per (model, window) and re-derives
        goodput/burn -- the per-model fleet truth an autoscaler reads.  An
        unreachable replica degrades to an error entry, never a failed
        response: like /debug/trace, this surface must work best when the
        serving path is misbehaving.
        """
        payload = self.slo.debug_payload()
        payload["gateway"] = payload.pop("models", {})
        replicas: dict[str, dict] = {}
        for replica in self.pool.replicas:
            try:
                r = self._session().get(
                    f"{replica.base}/debug/slo", timeout=2.0
                )
                replicas[replica.host] = (
                    r.json() if r.status_code == 200
                    else {"error": f"status {r.status_code}"}
                )
            except Exception as e:  # noqa: BLE001 - partial views beat none
                replicas[replica.host] = {"error": str(e)[:200]}
        payload["replicas"] = replicas
        payload["merged"] = slo_lib.merge_model_views(
            [v.get("models") for v in replicas.values() if isinstance(v, dict)],
            self.slo.target,
        )
        return payload

    def handle_profile(self) -> dict:
        """GET /debug/profile?audit=buckets: the merged bucket-shape audit.

        Each model-tier replica's per-bucket padding-waste ratio and
        compiled FLOPs/img, keyed by replica host -- the fleet view of
        whether the bucket ladder fits the traffic shape.  An unreachable
        replica degrades to an error entry, never a failed response.
        """
        replicas: dict[str, dict] = {}
        for replica in self.pool.replicas:
            try:
                r = self._session().get(
                    f"{replica.base}/debug/profile?audit=buckets", timeout=2.0
                )
                replicas[replica.host] = (
                    r.json() if r.status_code == 200
                    else {"error": f"status {r.status_code}"}
                )
            except Exception as e:  # noqa: BLE001 - partial views beat none
                replicas[replica.host] = {"error": str(e)[:200]}
        return {"tier": "gateway", "replicas": replicas}

    def handle_trace(self, raw_rid: str) -> tuple[int, bytes, str]:
        """GET /debug/trace/<rid>: the MERGED cross-tier waterfall.

        This tier's spans plus every model-tier replica's spans for the
        same trace id (fetched from their /debug/trace endpoints -- the
        gateway is the only tier that knows the replica list), sorted on
        the shared timeline.  An unreachable replica degrades to a partial
        trace, never an error: the debug surface must work best exactly
        when the serving path is misbehaving.
        """
        rid = ensure_request_id(raw_rid)
        info = self.tracer.trace_info(rid)
        spans = list(info["spans"]) if info is not None else []
        # Truncation accounting rides along: a merged waterfall missing its
        # pipeline stages with spans_dropped > 0 was CAPPED, not
        # un-instrumented (the silent-drop bug this field fixes).
        spans_dropped = info["spans_dropped"] if info is not None else 0
        retention = info["retention_class"] if info is not None else None
        for replica in self.pool.replicas:
            try:
                r = self._session().get(
                    f"{replica.base}/debug/trace/{rid}", timeout=2.0
                )
                if r.status_code == 200:
                    body = r.json()
                    spans.extend(body.get("spans", []))
                    spans_dropped += int(body.get("spans_dropped", 0) or 0)
            except Exception:  # noqa: BLE001 - partial traces beat no traces
                continue
        if not spans:
            return 404, json.dumps(
                {"error": f"no trace for {rid!r} on any tier",
                 "ring": self.tracer.stats()}
            ).encode(), "application/json"
        return 200, json.dumps(
            {"trace_id": rid, "spans": trace_lib.sort_spans(spans),
             "spans_dropped": spans_dropped, "retention_class": retention}
        ).encode(), "application/json"

    def reject_oversize(self, length: int) -> tuple[int, bytes, str] | None:
        """Pre-read Content-Length check shared by both transports; returns
        the 413 response when the declared body exceeds the cap, else None.
        Negative lengths are rejected too: rfile.read(-1) would read until
        connection close, which is exactly the unbounded buffering the cap
        exists to prevent."""
        if length < 0 or length > MAX_PREDICT_BODY_BYTES:
            self._m_errors.inc()
            return (
                413,
                json.dumps({
                    "error": f"request body {length} bytes exceeds the "
                    f"{MAX_PREDICT_BODY_BYTES}-byte limit"
                }).encode(),
                "application/json",
            )
        return None

    def _cache_key(self, routed: str, url: str, salt: str) -> str:
        """The content hash of one canonicalized single-url request:
        model name + resolved artifact hash + preprocessing params (from
        the model's cached contract; a never-discovered spec contributes
        the empty string, which only splits the very first pre-discovery
        flight) + the URL payload + the client's cache-bust salt."""
        default = routed == self.model
        spec = (
            self.pool.reference_spec if default
            else self.pool.reference_specs.get(routed)
        )
        params = (
            "" if spec is None
            else f"{tuple(spec.input_shape)}|{spec.resize_filter}"
        )
        return cache_lib.content_key(
            routed, self.cache.resolved_hash(routed), params, url, salt=salt
        )

    def _predict_coalesced(
        self,
        body: bytes,
        req: dict,
        rid: str,
        deadline: Deadline | None,
        rt,
        model: str | None,
        routed: str,
        salt: str,
        priority: str | None = None,
    ) -> tuple[int, bytes, str, dict[str, str]]:
        """The cache + singleflight front door for one single-url request.

        Hit: served straight from the cache -- no admission slot, no
        preprocessing, no upstream.  Miss: the first arrival leads the
        flight through the normal path (admission included) and fans its
        finished response out; concurrent identical arrivals become
        followers, counted admitted-but-not-dispatched, each waiting under
        its OWN deadline (a follower's 504 never cancels the leader).
        Only 200s are cached, so an injected/real upstream failure is
        never served back; salted (cache-bust) requests coalesce but are
        never stored.
        """
        key = self._cache_key(routed, str(req.get("url", "")), salt)
        w0 = trace_lib.now_s()
        # Stale-while-revalidate serving is a brownout stage (ROADMAP A12b);
        # without the ladder only fresh entries serve.
        cached = self.cache.lookup_swr(key, stale_ok=False)
        if cached is not None:
            # Positive (200) or negative (recent 404/400 under the short
            # KDLT_CACHE_NEG_TTL_S) -- either way the full fetch path is
            # skipped; a negative hit still answers with ITS error status
            # and counts as this client's error.
            hit_status, out, ctype, stale = cached
            disposition = "stale" if stale else "hit"
            if hit_status != 200:
                self._m_errors.inc()
            self.tracer.record(
                rid, trace_lib.SPAN_GATEWAY_CACHE, w0, trace_lib.now_s() - w0,
                parent_id=rt.span_id, result=disposition, status=hit_status,
            )
            return hit_status, out, ctype, {
                cache_lib.CACHE_STATUS_HEADER: disposition
            }
        flight, leader = self._singleflight.begin(key)
        if not leader:
            self.cache.count_coalesced()
            # Admitted-but-not-dispatched: the follower IS served (via the
            # leader's flight) without consuming a concurrency slot.
            self.admission.count_coalesced(routed)
            timeout = (
                deadline.remaining_s() if deadline is not None
                else PREDICT_TIMEOUT_S + 10.0
            )
            try:
                status, out, ctype, extra = flight.wait(max(0.0, timeout))
            except cache_lib.FlightTimeout:
                # This waiter's own budget expired; the leader flies on for
                # the others.
                self._m_errors.inc()
                self.admission.count_shed("deadline_exhausted", priority)
                self.tracer.record(
                    rid, trace_lib.SPAN_GATEWAY_CACHE, w0, trace_lib.now_s() - w0,
                    parent_id=rt.span_id, result="coalesced", outcome="timeout",
                )
                return 504, json.dumps(
                    {"error": "deadline budget exhausted waiting on the "
                     "coalesced upstream flight"}
                ).encode(), "application/json", {
                    cache_lib.CACHE_STATUS_HEADER: "coalesced"
                }
            except BaseException as e:  # noqa: BLE001 - leader died unmapped
                self._m_errors.inc()
                self.tracer.record(
                    rid, trace_lib.SPAN_GATEWAY_CACHE, w0, trace_lib.now_s() - w0,
                    parent_id=rt.span_id, result="coalesced",
                    error=str(e)[:120],
                )
                return 502, json.dumps(
                    {"error": f"coalesced flight failed: {e}"}
                ).encode(), "application/json", {
                    cache_lib.CACHE_STATUS_HEADER: "coalesced"
                }
            if status >= 400:
                self._m_errors.inc()  # every follower answers its own client
            self.tracer.record(
                rid, trace_lib.SPAN_GATEWAY_CACHE, w0, trace_lib.now_s() - w0,
                parent_id=rt.span_id, result="coalesced", status=status,
            )
            return status, out, ctype, {
                **extra, cache_lib.CACHE_STATUS_HEADER: "coalesced"
            }
        # Leader: record the miss decision as its own (short) span, then
        # run the normal path -- its sub-spans (admission, preprocess,
        # upstream attempts) follow in this same trace.
        self.cache.count_miss()
        self.tracer.record(
            rid, trace_lib.SPAN_GATEWAY_CACHE, w0, trace_lib.now_s() - w0,
            parent_id=rt.span_id, result="miss",
        )
        try:
            status, out, ctype, extra, _n = self._predict_response(
                body, req, rid, deadline, rt, model, routed,
                priority=priority,
            )
        except BaseException as e:
            # _predict_response maps every Exception; only process-fatal
            # escapes land here.  Fail the flight so followers never hang.
            self._singleflight.finish(key, flight)
            flight.fail(e)
            raise
        if not salt and self.cache.storable_response(status, ctype):
            # Store BEFORE detaching the flight: an arrival in between
            # hits the cache instead of starting a duplicate flight.
            # Salted requests are deliberate cache opt-outs: they
            # coalesce (same salt = same stampede) but are never stored.
            # The key is RE-canonicalized: this flight may just have
            # learned the model's artifact hash / contract (the first
            # request of a model, or the first after a reload), and the
            # entry must live under the key every future lookup computes.
            # storable_response: 200 always; 404/400 only under the short
            # negative TTL (a hammered bad URL stops paying the fetch
            # path); 5xx never -- upstream failures are not replayable;
            # text/event-stream never -- a token stream is a live
            # connection, not a replayable value.
            self.cache.put(
                self._cache_key(routed, str(req.get("url", "")), salt),
                out, ctype, routed, self.cache.resolved_hash(routed),
                status=status,
            )
        self._singleflight.finish(key, flight)
        flight.resolve((status, out, ctype, extra))
        return status, out, ctype, {
            **extra, cache_lib.CACHE_STATUS_HEADER: "miss"
        }

    def _predict_response(
        self,
        body: bytes,
        req: dict | None,
        rid: str,
        deadline: Deadline | None,
        rt,
        model: str | None,
        routed: str,
        priority: str | None = None,
    ) -> tuple[int, bytes, str, dict[str, str], int]:
        """The admission -> parse -> preprocess -> upstream core of one
        /predict, every failure mapped to its client-facing response;
        returns (status, body, content_type, extra_headers, n_urls).

        Called once per upstream flight: cache hits never reach it, and
        coalesced followers receive its return tuple through the flight
        instead of calling it.  ``req`` is the already-parsed body when
        the cache front door ran (None re-parses here so bad JSON keeps
        its 400 mapping AFTER admission, the historical precedence).
        """
        ticket = None
        n_urls = 1
        try:
            try:
                with rt.span(trace_lib.SPAN_GATEWAY_ADMISSION):
                    ticket = self.admission.admit(
                        deadline, model=routed,
                        priority=priority or protocol.DEFAULT_PRIORITY,
                    )
            except Shed as e:
                self._m_errors.inc()
                self.recorder.note_shed()
                return e.http_status, json.dumps(
                    {"error": str(e), "shed_reason": e.reason}
                ).encode(), "application/json", e.headers(), n_urls
            if req is None:
                req = json.loads(body)
            if "urls" in req:  # batch extension; {"url": ...} is the
                # reference's schema (reference test.py:15) and unchanged
                urls = list(req["urls"])
                n_urls = len(urls)
                preds = self.apply_model_batch(
                    urls, rid, deadline, trace=rt, model=model,
                    priority=priority,
                )
                return 200, json.dumps(
                    {"predictions": preds}
                ).encode(), "application/json", {}, n_urls
            scores = self.apply_model(
                req["url"], rid, deadline, trace=rt, model=model,
                priority=priority,
            )
            return 200, json.dumps(scores).encode(), "application/json", {}, n_urls
        except UpstreamError as e:
            self._m_errors.inc()
            if ticket is not None and e.http_status == 503:
                ticket.mark_overloaded()  # AIMD: the tier below is saturated
            return e.http_status, json.dumps(
                {"error": str(e)}
            ).encode(), "application/json", retry_after_headers(
                e.retry_after_s
            ), n_urls
        except (QueueFull, BatcherClosed, UpstreamStall) as e:
            # Transient server-side conditions from the upstream
            # micro-batcher (overload, shutdown race, hung upstream): a
            # retryable 503, exactly like the model tier's own mapping --
            # NOT a 400, which clients would treat as a permanent error.
            # (UpstreamStall is typed precisely so this clause does not
            # have to catch TimeoutError, which would also swallow
            # client-side image-fetch timeouts on Python >= 3.11.)
            self._m_errors.inc()
            if ticket is not None:
                ticket.mark_overloaded()
            return 503, json.dumps(
                {"error": f"upstream unavailable: {e}"}
            ).encode(), "application/json", retry_after_headers(
                self.admission.retry_after_s()
            ), n_urls
        except Exception as e:
            # Bad JSON, missing "url", unfetchable/undecodable image:
            # genuinely the caller's fault.
            self._m_errors.inc()
            return 400, json.dumps(
                {"error": str(e)}
            ).encode(), "application/json", {}, n_urls
        finally:
            if ticket is not None:
                ticket.release()

    def handle_generate(
        self,
        body: bytes,
        request_id: str | None = None,
        deadline: Deadline | None = None,
        model: str | None = None,
        priority: str | None = None,
    ):
        """POST /generate -> (status, payload, content_type, extra_headers).

        ``payload`` is complete bytes for every error and for a JSON-mode
        answer; for a 200 event-stream it is an ITERATOR of the chunks the
        model tier sent, relayed as they arrive (both transports write it
        chunked, so tokens reach the client at decode speed).

        Deliberately NOT on the cache, singleflight or hedging path: a token
        stream is a live connection.  Caching one would replay a dead
        transcript, coalescing would fan one client's generation out to
        strangers, and a hedge would run the SAME generation twice.
        Failover is connect-time only: once the stream has started, a
        replica that dies truncates it (the client sees no done event).

        Admission applies ahead of any upstream work, and the ticket is held
        for the life of the stream.  The SLO is accounted at the stream's
        end: a truncated stream, or a done event whose finish_reason is
        "deadline", is deadline-exceeded.  (The JAX gateway first sheds a
        generation by brownout class; that waits for the brownout ladder,
        ROADMAP A12b.)
        """
        t0 = time.perf_counter()
        rid = request_id or ensure_request_id(None)
        routed = model or self.decode_model
        priority = protocol.parse_priority(priority)
        rt = self.tracer.request_trace(rid)
        w_start = trace_lib.now_s()
        self._m_requests.inc()
        metrics_lib.model_request_counter(self.registry, routed).inc()

        def account(status: int, *, deadline_exceeded: bool = False) -> None:
            dt = time.perf_counter() - t0
            self._m_latency.observe(
                dt, exemplar=rid if metrics_lib.exemplars_enabled() else None)
            late = deadline_exceeded or (deadline is not None and deadline.expired)
            self.slo.record(routed, status, dt, deadline_exceeded=late)
            self.tracer.record(rid, trace_lib.SPAN_GATEWAY_GENERATE, w_start,
                               trace_lib.now_s() - w_start, span_id=rt.span_id, status=status)
            self.tracer.classify(rid, trace_lib.retention_class(status, late, False))
            if self.request_log or (status >= 500 and status not in (503, 504)):
                log_request("gateway generate", rid, status=status, t0=t0, span_id=rt.span_id)

        if deadline is None and self.admission.enabled:
            deadline = Deadline.default()
        try:
            with rt.span(trace_lib.SPAN_GATEWAY_ADMISSION):
                ticket = self.admission.admit(deadline, model=routed, priority=priority)
        except Shed as e:
            self.recorder.note_shed()
            self._m_errors.inc()
            account(e.http_status)
            return e.http_status, json.dumps(
                {"error": str(e), "shed_reason": e.reason}
            ).encode(), "application/json", e.headers()

        headers = {"Content-Type": protocol.JSON_CONTENT_TYPE, REQUEST_ID_HEADER: rid,
                   PRIORITY_HEADER: priority}
        read_timeout = GENERATE_IDLE_TIMEOUT_S
        if deadline is not None:
            headers[DEADLINE_HEADER] = deadline.header_value()
            read_timeout = deadline.clamp(read_timeout)
        tried: list = []
        r = None
        last_err: Exception | None = None
        # Connect-time failover only: up to two replicas, the first answer
        # wins.  Each pool.choose consumed a breaker allow(), so every pick
        # is settled with record_success or record_failure.
        for _ in range(2):
            replica = self.pool.choose(exclude=tried)
            if replica is None:
                break
            tried.append(replica)
            sid = trace_lib.new_span_id()
            headers[PARENT_SPAN_HEADER] = sid
            w0 = trace_lib.now_s()
            try:
                r = self._session().stream(
                    "POST", f"{replica.base}/v1/models/{routed}:generate", body, headers,
                    timeout=(GENERATE_CONNECT_TIMEOUT_S, read_timeout))
            except RequestException as e:
                self.pool.record_failure(replica)
                self.tracer.record(rid, trace_lib.SPAN_GATEWAY_UPSTREAM, w0,
                                   trace_lib.now_s() - w0, parent_id=rt.span_id, span_id=sid,
                                   replica=replica.host, role="generate", error=str(e)[:120])
                last_err = e
                continue
            # Headers arrived: the replica is alive and answered (even a 4xx
            # or a 503 is an answer; the breaker counts reachability).
            self.pool.record_success(replica, trace_lib.now_s() - w0)
            self.tracer.record(rid, trace_lib.SPAN_GATEWAY_UPSTREAM, w0, trace_lib.now_s() - w0,
                               parent_id=rt.span_id, span_id=sid, replica=replica.host,
                               role="generate", status=r.status_code)
            break
        if r is None:
            ticket.release()
            self._m_errors.inc()
            account(502)
            return 502, json.dumps(
                {"error": f"no upstream replica reachable for generate: {last_err}"}
            ).encode(), "application/json", retry_after_headers(self.pool.min_retry_after_s())
        ctype = r.headers.get("Content-Type", "application/json")
        if r.status_code != 200 or not ctype.startswith(protocol.EVENT_STREAM_CONTENT_TYPE):
            # A complete answer (JSON mode, or any error): pass the
            # upstream's status and body through verbatim.
            try:
                out = r.content
            except RequestException as e:
                out = json.dumps({"error": f"upstream generate reply lost: {e}"}).encode()
            finally:
                r.close()
            extra = {}
            if r.status_code == 503:
                # The AIMD congestion signal before release: the tier below
                # is saturated, so this tier's concurrency limit is high.
                ticket.mark_overloaded()
                extra = retry_after_headers(self.admission.retry_after_s())
            ticket.release()
            if r.status_code >= 400:
                self._m_errors.inc()
            account(r.status_code)
            return r.status_code, out, ctype, extra

        def stream():
            """The chunk relay.  A small rolling tail keeps the terminal done
            event parseable without buffering the stream; the finally closes
            the upstream connection (which cancels the generation there when
            the CLIENT went away), releases the ticket and closes the SLO
            loop, whether the stream completed or was truncated."""
            tail = b""
            truncated = True
            try:
                for chunk in r.iter_content():
                    tail = (tail + chunk)[-4096:]
                    yield chunk
                truncated = False
            except RequestException:
                pass  # the upstream died mid-stream: the client sees the truncation
            finally:
                r.close()
                ticket.release()
                done = None
                for ev in protocol.parse_sse_events(tail):
                    if ev.get("done"):
                        done = ev
                late = truncated or done is None or done.get("finish_reason") == "deadline"
                if truncated:
                    self._m_errors.inc()
                account(200, deadline_exceeded=late)

        return 200, stream(), protocol.EVENT_STREAM_CONTENT_TYPE, {"Cache-Control": "no-store"}

    def handle_predict(
        self,
        body: bytes,
        request_id: str | None = None,
        deadline: Deadline | None = None,
        model: str | None = None,
        cache_bust: str | None = None,
        priority: str | None = None,
    ) -> tuple[int, bytes, str, dict[str, str]]:
        """POST /predict body -> (status, body, content_type, extra_headers).

        ``request_id`` is the (already-sanitized) cross-tier trace id; both
        transports mint/sanitize it via tracing.ensure_request_id before
        calling here so the id in the response header, the upstream call,
        and the log line is the same one.  ``deadline`` is the request's
        parsed deadline budget (transports build it from the
        X-Request-Deadline-Ms header when admission is enabled); the extra
        headers carry Retry-After on shed/overload responses.  ``model``
        is the transports' resolved route target (resolve_model); None
        keeps the default model and the exact single-model code path.
        ``cache_bust`` is the client's X-Kdlt-Cache-Bust salt (hashed into
        the content key; never stored).

        Single-url requests ride the content-addressed cache + singleflight
        front door (serving.cache) AHEAD of admission; batch requests and
        the cache-disabled posture take the legacy path unchanged.  Every
        disposition -- hit, miss, coalesced -- lands in the SAME
        latency/SLO/trace accounting below, at the same handler boundary.
        """
        t0 = time.perf_counter()
        rid = request_id or ensure_request_id(None)
        # Normalize: the default model rides the legacy (model=None) path
        # end to end, so single-model deployments are bit-for-bit the old
        # gateway; only genuinely non-default routes carry a name.
        if model is not None and model == self.model:
            model = None
        routed = model or self.model
        priority = protocol.parse_priority(priority)
        # This request's trace (trace id = rid): the root span carrier every
        # child span -- admission, preprocess, upstream attempts -- nests
        # under, and the key /debug/trace/<rid> serves the waterfall by.
        rt = self.tracer.request_trace(rid)
        w_start = trace_lib.now_s()
        self._m_requests.inc()
        # Per-model request count (bounded `model` label, minted centrally):
        # the route is sanitized by resolve_model before it reaches here.
        metrics_lib.model_request_counter(self.registry, routed).inc()
        status = 500
        n_urls = 1
        try:
            if deadline is None and self.admission.enabled:
                deadline = Deadline.default()
            req = None
            if self.cache is not None:
                try:
                    parsed = json.loads(body)
                except Exception:  # noqa: BLE001 - core path maps the 400
                    parsed = None
                if (
                    isinstance(parsed, dict)
                    and "url" in parsed
                    and "urls" not in parsed
                ):
                    req = parsed
            if req is not None:
                status, out, ctype, extra = self._predict_coalesced(
                    body, req, rid, deadline, rt, model, routed,
                    str(cache_bust or ""), priority=priority,
                )
            else:
                status, out, ctype, extra, n_urls = self._predict_response(
                    body, None, rid, deadline, rt, model, routed,
                    priority=priority,
                )
            return status, out, ctype, extra
        finally:
            dt = time.perf_counter() - t0
            slow = (
                self._m_latency.count >= 100
                and dt >= self._m_latency.percentile(0.99)
            )
            self._m_latency.observe(
                dt,
                exemplar=rid if metrics_lib.exemplars_enabled() else None,
            )
            deadline_exceeded = deadline is not None and deadline.expired
            # Client-observed SLO accounting, per routed model -- the same
            # boundary as kdlt_gateway_request_seconds.
            self.slo.record(
                routed, status, dt, deadline_exceeded=deadline_exceeded
            )
            # Root span last (it covers the whole handler); the transports
            # build the X-Kdlt-Trace header AFTER handle_predict returns,
            # so the header summary includes it.
            self.tracer.record(
                rid, trace_lib.SPAN_GATEWAY_REQUEST, w_start, trace_lib.now_s() - w_start,
                span_id=rt.span_id, status=status, urls=n_urls,
            )
            self.tracer.classify(
                rid, trace_lib.retention_class(status, deadline_exceeded, slow)
            )
            # Sheds (503/504) skip the always-log rule: rejection must stay
            # cheap under overload; kdlt_admission_shed_total counts them.
            if self.request_log or (status >= 500 and status not in (503, 504)):
                log_request(
                    "gateway predict", rid, status=status, t0=t0,
                    span_id=rt.span_id, urls=n_urls,
                )

    # --- HTTP plumbing ----------------------------------------------------

    def _make_handler(self):
        gw = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"
            # TCP_NODELAY: http.server writes a response as two send()s
            # (header buffer, then body); with Nagle on, the body segment
            # waits out the peer's delayed ACK of the header segment -- a
            # flat ~40 ms added to every response on Linux.  Found by the
            # span tracer: client wall minus the gateway.request root span
            # was a constant ~40 ms that belonged to no stage.
            disable_nagle_algorithm = True

            def log_message(self, fmt, *args):
                pass

            def _send(
                self, code: int, body: bytes, ctype: str, rid: str = "",
                extra: dict[str, str] | None = None,
            ):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                if rid:
                    self.send_header(REQUEST_ID_HEADER, rid)
                for k, v in (extra or {}).items():
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                self._send(*gw.handle_get(self.path))

            def _generate(self, path: str, rid: str):
                """POST /generate[/<model>]: proxy one token stream."""
                model = None
                if path.startswith("/generate/"):
                    model = path[len("/generate/"):]
                    if not _MODEL_NAME_RE.match(model):
                        return self._send(404, b'{"error": "malformed model name"}',
                                          "application/json", rid)
                length = int(self.headers.get("Content-Length", 0) or 0)
                rejected = gw.reject_oversize(length)
                if rejected is not None:
                    self.close_connection = True
                    return self._send(*rejected, rid)
                deadline = (Deadline.from_header(self.headers.get(DEADLINE_HEADER))
                            if gw.admission.enabled else None)
                status, payload, ctype, extra = gw.handle_generate(
                    self.rfile.read(length), rid, deadline, model=model,
                    priority=self.headers.get(PRIORITY_HEADER))
                if status == 200 and not isinstance(payload, (bytes, bytearray)):
                    return send_chunked(self, 200, payload, ctype, {REQUEST_ID_HEADER: rid, **extra})
                summary = gw.tracer.summary(rid)
                if summary:
                    extra = {**extra, TRACE_HEADER: summary}
                self._send(status, payload, ctype, rid, extra)

            def do_POST(self):
                rid = ensure_request_id(self.headers.get(REQUEST_ID_HEADER))
                path = self.path.split("?", 1)[0]
                if path == "/generate" or path.startswith("/generate/"):
                    return self._generate(path, rid)
                if path != "/predict" and not path.startswith("/predict/"):
                    return self._send(
                        404, b'{"error": "not found"}', "application/json", rid
                    )
                # Model routing: /predict/<model> or X-Kdlt-Model; the bare
                # /predict keeps the reference's shape (default model).
                model = gw.resolve_model(path, self.headers.get(MODEL_HEADER))
                if model is None:
                    return self._send(
                        404, b'{"error": "malformed model name"}',
                        "application/json", rid,
                    )
                length = int(self.headers.get("Content-Length", 0))
                rejected = gw.reject_oversize(length)
                if rejected is not None:
                    # The unread body is still in the socket; close rather
                    # than let keep-alive parse gigabytes as a next request.
                    self.close_connection = True
                    return self._send(*rejected, rid)
                deadline = (
                    Deadline.from_header(self.headers.get(DEADLINE_HEADER))
                    if gw.admission.enabled
                    else None
                )
                status, out, ctype, extra = gw.handle_predict(
                    self.rfile.read(length), rid, deadline, model=model,
                    cache_bust=self.headers.get(cache_lib.CACHE_BUST_HEADER),
                    priority=self.headers.get(PRIORITY_HEADER),
                )
                # Server-Timing-style span summary; handle_predict has
                # recorded the full trace (root included) by return time.
                summary = gw.tracer.summary(rid)
                if summary:
                    extra = {**extra, TRACE_HEADER: summary}
                self._send(status, out, ctype, rid, extra)

        return Handler

    def start(self, block: bool = False) -> None:
        if self._httpd is None:
            raise RuntimeError("gateway built with bind=False; serve it via WSGI")
        self._serving = True
        if block:
            self._httpd.serve_forever()
        else:
            self._thread = threading.Thread(
                target=self._httpd.serve_forever, name="kdlt-gateway", daemon=True
            )
            self._thread.start()

    def begin_drain(self) -> None:
        """Graceful-drain entry: /readyz goes 503 and admission sheds new
        work with reason "draining" while in-flight requests complete
        (admission.wait_idle observes them).  The CLI wires SIGTERM here."""
        self.admission.begin_drain()

    def shutdown(self) -> None:
        self.recorder.close()
        if self._microbatcher is not None:
            self._microbatcher.close()
        with self._microbatcher_lock:
            for mb in self._microbatchers.values():
                mb.close()
            self._microbatchers.clear()
        self.pool.close()
        if self._session_obj is not None:
            self._session_obj.close()
        if self._httpd is None:
            return
        # See ModelServer.shutdown: BaseServer.shutdown() hangs if
        # serve_forever never ran.
        if getattr(self, "_serving", False):
            self._httpd.shutdown()
        self._httpd.server_close()


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description="serving gateway (the PyTorch port's)")
    p.add_argument("--port", type=int, default=DEFAULT_PORT)
    p.add_argument("--serving-host", default=None, help=f"overrides ${SERVING_HOST_ENV}")
    p.add_argument("--model", default=None, help=f"overrides ${MODEL_ENV}")
    p.add_argument(
        "--no-request-log",
        action="store_true",
        help="disable the per-request traced log line (rid, status, duration)",
    )
    p.add_argument(
        "--upstream-batch",
        type=int,
        default=0,
        help="coalesce concurrent single-image requests into one upstream "
        "predict of up to this size (0 = off, one upstream call per request)",
    )
    p.add_argument("--upstream-delay-ms", type=float, default=2.0)
    p.add_argument(
        "--no-admission",
        action="store_true",
        help="disable admission control (deadline rejection, AIMD "
        "concurrency limiting, circuit breaking); graceful drain stays on",
    )
    p.add_argument(
        "--no-failover",
        action="store_true",
        help="disable upstream failover/health tracking/hedging: the "
        "replica list becomes a blind round-robin (overrides $KDLT_FAILOVER)",
    )
    p.add_argument(
        "--hedge-delay-ms",
        type=float,
        default=None,
        help="fire a hedged upstream attempt against a second healthy "
        "replica after this many ms without a response (default "
        "$KDLT_HEDGE_DELAY_MS; 0 = off)",
    )
    p.add_argument(
        "--probe-interval-s",
        type=float,
        default=None,
        help="seconds between /healthz probes of unhealthy upstream "
        "replicas (default $KDLT_PROBE_INTERVAL_S or 1.0)",
    )
    p.add_argument(
        "--pool-resolve-s",
        type=float,
        default=None,
        help="re-resolve the serving host's DNS name(s) every this many "
        "seconds and apply membership deltas live (joiners quarantined "
        "until ready, leavers drained); default $KDLT_POOL_RESOLVE_S or "
        "off.  KDLT_SERVING_HOST=dns+srv://name resolves SRV records "
        "instead",
    )
    p.add_argument(
        "--no-slo",
        action="store_true",
        help="disable the SLO engine (per-model goodput/burn-rate windows, "
        "kdlt_slo_* gauges, /debug/slo); default $KDLT_SLO or enabled",
    )
    p.add_argument(
        "--no-cache",
        action="store_true",
        help="disable the content-addressed response cache AND singleflight "
        "request coalescing (serving.cache); default $KDLT_CACHE or enabled",
    )
    p.add_argument(
        "--cache-swr-s",
        type=float,
        default=None,
        help="stale-while-revalidate window, as the JAX gateway takes it; "
        "stale entries serve only under a brownout stage, which this "
        "gateway does not have yet (ROADMAP A12b), so none serves",
    )
    args = p.parse_args(argv)
    gw = Gateway(
        serving_host=args.serving_host,
        model=args.model,
        port=args.port,
        request_log=not args.no_request_log,
        upstream_batch=args.upstream_batch,
        upstream_delay_ms=args.upstream_delay_ms,
        admission=False if args.no_admission else None,
        failover=False if args.no_failover else None,
        hedge_delay_ms=args.hedge_delay_ms,
        probe_interval_s=args.probe_interval_s,
        slo=False if args.no_slo else None,
        cache=False if args.no_cache else None,
        cache_swr_s=args.cache_swr_s,
        pool_resolve_s=args.pool_resolve_s,
    )
    # SIGTERM -> flip /readyz, shed new work, finish in-flight, then stop;
    # pairs with the k8s terminationGracePeriodSeconds/preStop settings.
    install_sigterm_drain(gw.admission, gw.shutdown)
    print(f"gateway listening on :{gw.port}, model tier at {gw.serving_host}")
    gw.start(block=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
