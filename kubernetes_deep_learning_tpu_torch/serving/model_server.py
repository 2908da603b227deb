"""Model server: the TF-Serving-shaped HTTP front of the port's engines.

A threaded ``http.server`` over one ``InferenceEngine`` per model found
under ``<model_root>/<name>/<version>/`` (the highest version wins, as in
TF-Serving), each behind a ``ServedModel``.  The ``serving.registry``
``ModelRegistry`` owns the name -> ServedModel map: it loads every model's
highest version, and on each scan (``poll_versions``, or the watcher every
``--watch-interval`` seconds) builds, warms (captures the CUDA graphs of)
and activates a higher version whose bytes changed, swaps it in and only
then closes the old one, whose engine gives its device memory back; a
byte-identical version is adopted without a reload.  With batching on
(and any ``--batcher`` but ``native``), every model serves through its
lane of one ``runtime.scheduler.UnifiedScheduler`` over ONE shared
in-flight dispatcher (``--sched-policy``, ``--sched-weights``), which
arbitrates the card's time across models; ``--batcher native`` keeps a
private C++ queue and dispatcher per model.  Routes:

- ``GET /v1/models``: every model's status, keyed by name (the JAX
  server's keys: version, readiness, artifact hash, buckets, family,
  labels, quantization, sharding);
- ``GET /v1/models/<name>:status``: one model's;
- ``GET /v1/models/<name>``: the model's ``spec.json`` (what a gateway
  reads to discover the contract), with ``X-Kdlt-Ingest: bytes`` unless
  ``KDLT_INGEST=0``: the offer of the bytes wire;
- ``POST /v1/models/<name>:predict``: msgpack or JSON (``serving.protocol``),
  or the bytes wire (``application/x-kdlt-image-bytes``: the encoded
  JPEG/PNG blobs a gateway fetched), which this tier decodes and resizes to
  the model's input in a thread pool (``ops.preprocess.BatchDecoder``,
  ``KDLT_DECODE_POOL`` threads) through a decoded-pixel cache
  (``serving.cache.DecodedCache``) and answers in JSON, as the JAX server
  does; an undecodable or unsupported image is a 400.  With
  ``KDLT_INGEST_DEVICE_RESIZE=HxW`` the decode stops at HxW and the batch
  goes, in max-bucket chunks, straight to the engine's staged program,
  which resizes on the device (bypassing the lanes, as the JAX server's
  staged dispatch does).  uint8 images go through the model's lane in max-bucket chunks (or, with
  the native batcher, a single image through it, a batch up to the largest
  bucket straight to the engine and a larger one in chunks through the
  dispatcher); every 200 carries the served artifact's hash
  (``X-Kdlt-Artifact-Hash``), on which the JAX gateway keys its response
  cache.  Admission runs first, before the body is read
  (``serving.admission``): the request's deadline budget
  (``X-Request-Deadline-Ms``, which the JAX gateway sends), its priority
  class (``X-Kdlt-Priority``) and the model name go to the controller,
  which sheds a request while the server drains (503 "draining"), one
  whose budget is spent (504, the engine untouched) and one the AIMD
  concurrency limiter cannot seat in time (503 with a derived, jittered
  ``Retry-After``); a shed's unread body is drained (or the connection
  closed), so a kept-alive connection stays usable.  An admitted request
  waits for its batch at most its remaining budget.  Errors answer as the
  JAX server does, with a JSON ``{"error": ...}`` body (sheds add
  ``"shed_reason"``): 400 for a malformed request, 404, 500; 503
  "overloaded" with the limiter's ``Retry-After`` when the batcher's queue
  is full or a wait outlives its deadline; 503 with ``Retry-After: 1.000``
  and ``X-Kdlt-Stalled: 1`` once the dispatch watchdog has declared the
  pipeline stalled;
- ``GET /healthz`` (the process is up and its pipelines are not stalled),
  ``GET /readyz`` (every engine has warmed, nothing stalled, not draining)
  and ``GET /metrics`` (the registry's Prometheus text: engine, batcher,
  dispatch-pipeline, admission, SLO, trace-retention, incident and MFU
  series, labelled by model and tier; a scrape refreshes the SLO gauges);
- observability, as the JAX server answers it: every predict reply echoes
  its ``X-Request-Id`` (the client's, sanitized, or a minted one) and
  carries an ``X-Kdlt-Trace`` summary of the request's spans, which nest
  under the caller's ``X-Kdlt-Parent-Span``; ``GET /debug/trace/<rid>``
  (the request's span tree: ``server.request`` over ``server.admission``,
  ``server.decode`` and ``server.predict``, which holds
  ``batcher.queue_wait`` and the four ``pipeline.*`` stages; 404 with the
  ring's stats once evicted), ``GET /debug/slo`` (per-model goodput and
  burn-rate windows), ``GET /debug/incidents[/<id>]`` (the flight
  recorder's bundles: a dispatch stall captures one with the request's
  pinned trace), ``GET|POST /debug/profile`` (``?seconds=N`` in (0, 60]: a
  capture of the card's kernels and copies (the CPU's ops where there is
  no card) while the other handler threads serve, written as
  ``trace.json`` into a fresh directory under ``--profile-dir``, the reply
  naming the top device kernels by time; on the card the recording is the
  port's own CUPTI collector (``ops._native.DeviceTrace``: its stop and
  export run in C++, off the interpreter lock), and it holds
  ``runtime.engine.capture_lock`` only while it starts and while it stops,
  so a reload's graph capture waits for those moments only; 409 while
  another capture, or a CUDA graph capture, runs;
  ``?audit=buckets``: each model's padding waste per bucket and FLOPs per
  image) and ``GET /debug/`` (this list);
- the generative lane (``--decode`` or ``KDLT_DECODE=1``; ``serving.generate``
  over ``runtime.decode``): ``POST /v1/models/<m>:generate`` with a JSON
  ``{"prompt", "max_new_tokens", "stream"}`` body, admitted like a predict;
  a streamed 200 is a chunked ``text/event-stream`` of per-token SSE frames
  written as the decode loop emits them (the admission ticket is held for
  the stream's life; a client that goes away cancels its generation), else
  one JSON document.  ``/debug/slo`` gains a ``decode`` section (TTFT/TPOT
  percentiles, budgets, slot and page occupancy).  The lane's graphs (one
  per prompt bucket, one step) are captured by ``warmup()`` on the image
  engines' capture thread.

Run it with ``kdlt-torch-model-server --model-root DIR --device cuda``
(``--max-delay-ms``, ``--pipeline-depth``, ``--batcher``,
``--no-batching``, ``--no-admission``, ``--watch-interval``,
``--sched-policy``, ``--sched-weights``, ``--profile-dir``,
``--no-profiling``, ``--no-request-log``, ``--no-slo``, ``--decode``,
``--static-decode-batching``; the JAX server's
``KDLT_PROFILE_DIR``, ``KDLT_SLO*``, ``KDLT_INCIDENT*``, ``KDLT_MFU``,
``KDLT_LOG_FORMAT`` and ``KDLT_METRICS_EXEMPLARS``; ``--aot-warm`` runs
``export.warm``'s pass and exits).  The boot line and
``kdlt_native_builds`` on /metrics say which native libraries the process
compiled (none after a warmed boot); ``kdlt_kernel_launches{kernel}``
counts each hand-written kernel's launches.  ``--no-admission`` or
``KDLT_ADMISSION=0`` turn deadline rejection and the limiter off (every
wait is then a fixed 20 s, or 120 s for a chunk); drain stays on.  SIGTERM
drains: /readyz turns 503 "draining", new requests shed, admitted ones
finish (at most ``KDLT_DRAIN_TIMEOUT_S``, 25 s), then the process exits.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import logging
import os
import re
import sys
import tempfile
import threading
import time
from concurrent.futures import TimeoutError as FuturesTimeout
from http.server import BaseHTTPRequestHandler
from typing import Sequence
from urllib.parse import parse_qs

import numpy as np
import torch

from kubernetes_deep_learning_tpu_torch.export import artifact as art
from kubernetes_deep_learning_tpu_torch.ops import _native
from kubernetes_deep_learning_tpu_torch.ops import preprocess as preprocess_lib
from kubernetes_deep_learning_tpu_torch.runtime import create_batcher
from kubernetes_deep_learning_tpu_torch.runtime.batcher import BatcherClosed, QueueFull
from kubernetes_deep_learning_tpu_torch.runtime.engine import (
    DEFAULT_BUCKETS,
    DispatcherClosed,
    DispatchStall,
    EngineClosed,
    InferenceEngine,
    InFlightDispatcher,
    capture_lock,
    resolve_pipeline_depth,
)
from kubernetes_deep_learning_tpu_torch.runtime.scheduler import (
    POLICIES,
    UnifiedScheduler,
    resolve_weights,
)
from kubernetes_deep_learning_tpu_torch.serving import cache as cache_lib
from kubernetes_deep_learning_tpu_torch.serving import generate as generate_lib
from kubernetes_deep_learning_tpu_torch.serving import protocol
from kubernetes_deep_learning_tpu_torch.serving.httpserver import ServingHTTPServer, send_chunked
from kubernetes_deep_learning_tpu_torch.serving.admission import (
    DEADLINE_HEADER,
    AdaptiveLimiter,
    AdmissionController,
    Deadline,
    Shed,
    Ticket,
    admission_enabled,
    env_max_limit,
    install_sigterm_drain,
)
from kubernetes_deep_learning_tpu_torch.serving.registry import ModelRegistry
from kubernetes_deep_learning_tpu_torch.serving.tracing import (
    PARENT_SPAN_HEADER,
    REQUEST_ID_HEADER,
    TRACE_HEADER,
    ensure_request_id,
    ensure_span_id,
    log_request,
)
from kubernetes_deep_learning_tpu_torch.utils import flightrecorder as incident_lib
from kubernetes_deep_learning_tpu_torch.utils import metrics as metrics_lib
from kubernetes_deep_learning_tpu_torch.utils import slo as slo_lib
from kubernetes_deep_learning_tpu_torch.utils import trace as trace_lib

log = logging.getLogger(__name__)

_PREFIX = "/v1/models"
_STATUS_RE = re.compile(r"^/v1/models/([^/:]+):status$")
_GENERATE_RE = re.compile(r"^/v1/models/([^/:]+):generate$")
PROFILE_DIR_ENV = "KDLT_PROFILE_DIR"  # base dir for /debug/profile captures
PROFILE_TOP_KERNELS = 20  # device kernels named in a /debug/profile reply
# The bytes wire's image-count bound (the JAX server's).
MAX_IMAGES_PER_REQUEST = 256

# (status, body, content type, extra headers)
Reply = tuple[int, bytes, str, dict[str, str]]


def _json(status: int, obj, headers: dict[str, str] | None = None) -> Reply:
    return status, json.dumps(obj).encode(), protocol.JSON_CONTENT_TYPE, headers or {}


def _error(status: int, message: str, headers: dict[str, str] | None = None) -> Reply:
    """An error reply as the JAX server sends it: ``{"error": message}``."""
    return _json(status, {"error": message}, headers)


# How long a handler waits for its image's batch (the reference's 20 s
# gRPC deadline) and for a chunk of a large request, when the request
# carries no deadline (admission off); a deadline shortens both.
BATCHER_TIMEOUT_S = 20.0
CHUNK_TIMEOUT_S = 120.0
# How long an unloaded version waits for its last dispatches before its
# engine frees the graphs they replay (longer than any request's wait).
UNLOAD_WAIT_S = 2 * CHUNK_TIMEOUT_S


class ServedModel:
    """One served model version's pipeline over its engine.

    With ``scheduler`` (the server's ``UnifiedScheduler``) and batching on,
    every uint8 batch of this model rides its scheduling lane: single
    images coalesce in the lane, multi-image requests enter as max-bucket
    chunks, and the scheduler's one shared dispatcher carries them, so the
    card's time is arbitrated across models.  Otherwise the model has a
    private pipeline: ``dispatcher``, ONE in-flight dispatch pipeline shared
    by the single-image batcher and the chunked path (None at depth 1), and
    ``batcher``, the one ``runtime.create_batcher`` picks for
    ``batcher_impl`` (None when batching is off).  An engine without
    ``predict_async`` (a plain ``runtime.stub.StubEngine``) has no device
    pipeline to arbitrate, so it keeps the private pipeline, as in JAX.
    """

    def __init__(self, engine: InferenceEngine, max_delay_ms: float = 2.0,
                 use_batcher: bool = True, pipeline_depth: int | None = None,
                 batcher_impl: str = "auto", scheduler: UnifiedScheduler | None = None,
                 weight: float | None = None, artifact: art.ModelArtifact | None = None,
                 version: int | None = None):
        self.engine = engine
        self.name = engine.spec.name
        self.artifact = artifact
        self.version = version
        self.warmup_s: float | None = None  # how long the engine's warmup took
        self._max_delay_ms = max_delay_ms
        self._weight = weight
        self._scheduler = (scheduler if use_batcher and hasattr(engine, "predict_async")
                           else None)
        self.dispatcher = self.batcher = None
        if self._scheduler is None:
            depth = resolve_pipeline_depth(pipeline_depth)
            self.dispatcher = (
                InFlightDispatcher(engine, depth=depth, registry=engine.registry)
                if depth > 1 and hasattr(engine, "predict_async") else None
            )
            self.batcher = (
                create_batcher(engine, impl=batcher_impl, max_delay_ms=max_delay_ms,
                               registry=engine.registry, pipeline_depth=depth,
                               dispatcher=self.dispatcher)
                if use_batcher else None
            )
        self._m_budget = metrics_lib.batcher_budget_histogram(engine.registry)

    @property
    def artifact_hash(self) -> str | None:
        """The registry's identity key (sha256 of the artifact dir), stamped
        by ModelRegistry.poll after a successful load; kept on the engine,
        so a reply names the version whose engine served it."""
        return self.engine.artifact_hash

    @artifact_hash.setter
    def artifact_hash(self, digest: str | None) -> None:
        self.engine.artifact_hash = digest

    @property
    def stalled(self) -> bool:
        return self.dispatcher is not None and self.dispatcher.stalled

    def activate(self) -> None:
        """Route the model's lane to this version's engine: called after
        warmup (a lane never routes to a cold engine on a reload) and before
        the registry rebinds its dict.  Queued requests survive the swap.
        No-op without a scheduler."""
        if self._scheduler is not None:
            self._scheduler.register(self.name, self.engine, weight=self._weight,
                                     max_delay_ms=self._max_delay_ms)

    def _wait(self, fut, timeout: float) -> np.ndarray:
        """Every wait for a lane's batch."""
        return fut.result(timeout=timeout)

    def predict(self, images: np.ndarray, deadline: Deadline | None = None,
                priority: str | None = None, engines: list | None = None,
                trace: trace_lib.RequestTrace | None = None) -> np.ndarray:
        """Logits for ``images``.  Every wait below (the lane's, the
        batcher's, the chunk futures') is bounded by ``deadline``'s remaining
        budget, so a request never holds a handler thread after its caller
        stopped listening; ``deadline=None`` keeps the fixed 20 s and 120 s.
        ``priority`` orders the request in its lane.  ``engines``, if given,
        receives the engine that served each part: on a lane, the version
        current when the part was dispatched, which a reload may have
        changed since this version was resolved.  ``trace`` (the request's
        ``server.predict`` span) gets the queue and pipeline-stage spans, or
        ``engine.predict`` on the unbatched path."""
        if engines is None:
            engines = []
        batcher_timeout, chunk_timeout = BATCHER_TIMEOUT_S, CHUNK_TIMEOUT_S
        if deadline is not None:
            remaining = max(deadline.remaining_s(), 0.0)
            self._m_budget.observe(remaining * 1e3)
            batcher_timeout = min(batcher_timeout, remaining)
            chunk_timeout = min(chunk_timeout, remaining)
        step = self.engine.max_batch
        if (self._scheduler is not None and images.dtype == np.uint8 and images.ndim >= 1
                and len(images)):
            try:
                if len(images) == 1:
                    fut = self._scheduler.submit(self.name, images[0], deadline=deadline,
                                                 trace=trace, priority=priority)
                    row = self._wait(fut, batcher_timeout)
                    engines.append(fut.engine)
                    return row[None]
                futs = [self._scheduler.submit_batch(self.name, images[i : i + step],
                                                     deadline=deadline, trace=trace,
                                                     priority=priority)
                        for i in range(0, len(images), step)]
                rows = [self._wait(f, chunk_timeout) for f in futs]
                engines.extend(f.engine for f in futs)
                return np.concatenate(rows)
            except BatcherClosed:
                pass  # a shutdown race: the engine is still valid, serve directly
        engines.append(self.engine)
        # Single uint8 images go through the batcher to coalesce across
        # concurrent requests (the batcher is uint8-only so mixed dtypes
        # never end up in one np.stack).
        if (self.batcher is not None and images.ndim >= 1 and len(images) == 1
                and images.dtype == np.uint8):
            try:
                return self.batcher.predict(images[0], timeout=batcher_timeout,
                                            trace=trace)[None]
            except BatcherClosed:
                pass  # a shutdown race: the engine is still valid, serve directly
        if images.ndim == 0 or len(images) <= step:
            if trace is not None:
                with trace.span(trace_lib.SPAN_ENGINE_PREDICT,
                                batch=int(images.shape[0]) if images.ndim else 0):
                    return self.engine.predict(images)
            return self.engine.predict(images)
        # Batches beyond the bucket ladder are served in max-bucket chunks:
        # the client's batch size need not know the server's buckets.  With
        # the pipeline on, chunk i+1's staging and launches overlap chunk
        # i's execution; the futures keep chunk order for the concatenate.
        chunks = [images[i : i + step] for i in range(0, len(images), step)]
        if self.dispatcher is not None and images.dtype == np.uint8:
            try:
                futs = [self.dispatcher.submit(c, traces=(trace,)) for c in chunks]
                return np.concatenate([f.result(timeout=chunk_timeout) for f in futs])
            except DispatcherClosed:
                pass  # a shutdown race: fall through to the serial engine path
        return np.concatenate([self.engine.predict(c) for c in chunks])

    def close(self) -> bool:
        """Stop serving this version.  With a scheduler: drop its lane
        unless a newer version already owns it (then a no-op), and wait
        until none of its plans is still dispatching or in flight.  Without:
        drain and stop the batcher, then the dispatcher behind it.  Returns
        whether the engine is quiet (nothing of it left to run), so that it
        may be closed."""
        if self._scheduler is not None:
            self._scheduler.unregister(self.name, engine=self.engine)
            return self._scheduler.wait_engine_idle(self.engine, UNLOAD_WAIT_S)
        if self.batcher is not None:
            self.batcher.close(drain=True)
        if self.dispatcher is not None:
            # After the batcher's dispatch thread exits, only in-flight
            # handler threads can race this close; they fall back to the
            # engine path on DispatcherClosed.
            self.dispatcher.close(drain=True)
        return True


class _CpuProfile:
    """/debug/profile without a card (the CPU tests): torch.profiler's CPU
    activity, its trace exported here; no device, so no kernels."""

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile

        self._prof = profile(activities=[ProfilerActivity.CPU])

    def start(self) -> None:
        self._prof.start()

    def stop(self) -> None:
        self._prof.stop()

    def write(self, path: str, top: int) -> dict:
        self._prof.export_chrome_trace(path)
        return {}


class _ProfileBusy(RuntimeError):
    """A /debug/profile capture was refused: another one, or a CUDA graph
    capture, is running."""


class _Exchange:
    """One predict request's trace and accounting state, from its arrival
    to ``finish()``, which runs once, after the reply went out.

    The request's root span, ``server.request``, runs from its arrival to
    the moment its reply is made (``w_end``); its children,
    ``server.admission``, ``server.decode`` and ``server.predict``, follow
    one another from shared boundaries (each starts where the previous one
    ended), as the dispatcher's pipeline stages do, so they cover it."""

    __slots__ = ("server", "rid", "parent", "rt", "w_start", "w_mark", "w_end", "t0", "model",
                 "deadline", "ticket", "status", "batch", "stalled", "_spans")

    def __init__(self, server: "ModelServer", headers):
        self.t0 = time.perf_counter()
        self.w_start = self.w_mark = trace_lib.now_s()
        self.w_end: float | None = None
        self._spans: list[trace_lib.Span] = []  # closed stages, recorded at the reply
        self.server = server
        # The caller's id (the JAX gateway's X-Request-Id) or a minted one;
        # the gateway's upstream-attempt span id arrives in
        # X-Kdlt-Parent-Span, so this tier's root span nests under it.
        self.rid = ensure_request_id(headers.get(REQUEST_ID_HEADER))
        self.parent = ensure_span_id(headers.get(PARENT_SPAN_HEADER))
        self.rt = server.tracer.request_trace(self.rid, self.parent)
        self.model: str | None = None  # set once the request names a served model
        self.deadline: Deadline | None = None
        self.ticket: Ticket | None = None
        self.status = 500
        self.batch = 0
        self.stalled = False

    @contextlib.contextmanager
    def stage(self, name: str, **tags):
        """A child span of the request from where the previous one ended to
        the end of the block (kept even when it raises or returns), with
        the children deferred to it; yields the child's RequestTrace, under
        which nested spans nest.  Recorded with the reply (``_record``)."""
        child = trace_lib.RequestTrace(self.rt.tracer, self.rid, trace_lib.new_span_id(),
                                       self.rt.span_id)
        try:
            yield child
        finally:
            end = trace_lib.now_s()
            self._spans += child.close()
            self._spans.append(trace_lib.Span(
                self.rid, child.span_id, self.rt.span_id, name, self.rt.tracer.tier,
                self.w_mark, end - self.w_mark, {**tags, **child.tags}))
            self.w_mark = end

    def _record(self) -> None:
        """Record the closed stages' spans, under one lock acquisition."""
        if self._spans:
            self.server.tracer.record_spans(self.rid, self._spans)
            self._spans = []

    def reply_headers(self) -> dict[str, str]:
        """The id echo and the ``X-Kdlt-Trace`` summary of the spans
        recorded so far (all but the root, which closes after the send)."""
        self._record()
        headers = {REQUEST_ID_HEADER: self.rid}
        summary = self.server.tracer.summary(self.rid)
        if summary:
            headers[TRACE_HEADER] = summary
        return headers

    def finish(self) -> None:
        """Release the admission ticket, then the JAX server's per-request
        accounting: the latency histogram (with an exemplar under
        KDLT_METRICS_EXEMPLARS=1), the SLO record, the root span, the
        trace's retention class, the request log line, and the
        ``dispatch.stall`` event of a request the stall failed."""
        dt = time.perf_counter() - self.t0
        server = self.server
        self._record()
        if self.ticket is not None:
            self.ticket.release()
        if self.status != 200:
            server._m_errors.inc()
        if self.model is None:
            return
        # "slow" for trace retention = past the tier's own p99, judged
        # against the distribution BEFORE this sample, once it is meaningful.
        latency = server._m_latency
        slow = latency.count >= 100 and dt >= latency.percentile(0.99)
        latency.observe(dt, exemplar=self.rid if metrics_lib.exemplars_enabled() else None)
        deadline_exceeded = self.deadline is not None and self.deadline.expired
        server.slo.record(self.model, self.status, dt, deadline_exceeded=deadline_exceeded)
        server.tracer.record(self.rid, trace_lib.SPAN_SERVER_REQUEST, self.w_start,
                             self.w_end - self.w_start, parent_id=self.parent,
                             span_id=self.rt.span_id, status=self.status, batch=self.batch)
        server.tracer.classify(
            self.rid, trace_lib.retention_class(self.status, deadline_exceeded, slow))
        # Sheds are left out of the always-log rule: a log line per shed is
        # load, and kdlt_admission_shed_total counts them already.
        if server.request_log or (self.status >= 500 and self.status not in (503, 504)):
            log_request("model-server predict", self.rid, status=self.status, t0=self.t0,
                        span_id=self.rt.span_id, model=self.model, batch=self.batch)
        if self.stalled:
            # The stall edge with its causal request, whose trace the bundle
            # pins; the trigger's dedup window folds the storm of stalled
            # replies into ONE bundle.
            server.recorder.record("dispatch.stall", rid=self.rid, model=self.model)


class _GenerateExchange(_Exchange):
    """One :generate request's state, finished as the JAX server finishes a
    generation: after the stream (the admission ticket is held for its
    life), with the root span ``server.generate``; the SLO is recorded here
    only for a request the lane never saw (a shed, an internal error): the
    lane records the rest at the generation's end."""

    __slots__ = ("lane_recorded",)

    def finish(self) -> None:
        server = self.server
        self._record()
        if self.ticket is not None:
            self.ticket.release()
        if self.status != 200:
            server._m_errors.inc()
        if self.model is None:
            return
        dt = time.perf_counter() - self.t0
        server._m_latency.observe(dt, exemplar=self.rid if metrics_lib.exemplars_enabled() else None)
        if not self.lane_recorded:
            server.slo.record(self.model, self.status, dt, deadline_exceeded=False)
        deadline_exceeded = self.deadline is not None and self.deadline.expired
        server.tracer.record(self.rid, trace_lib.SPAN_SERVER_GENERATE, self.w_start,
                             trace_lib.now_s() - self.w_start, parent_id=self.parent,
                             span_id=self.rt.span_id, status=self.status)
        server.tracer.classify(self.rid,
                               trace_lib.retention_class(self.status, deadline_exceeded, False))
        if server.request_log or (self.status >= 500 and self.status not in (503, 504)):
            log_request("model-server generate", self.rid, status=self.status, t0=self.t0,
                        span_id=self.rt.span_id, model=self.model)


class ModelServer:
    def __init__(self, model_root: str, port: int = 8500, host: str = "127.0.0.1",
                 buckets: Sequence[int] = DEFAULT_BUCKETS, device: str = "cuda",
                 max_delay_ms: float = 2.0, use_batcher: bool = True,
                 pipeline_depth: int | None = None, batcher_impl: str = "auto",
                 admission: bool | None = None, sched_policy: str | None = None,
                 sched_weights: dict[str, float] | None = None,
                 profile_base: str | None = "", request_log: bool = False,
                 slo: bool | None = None, incident_dir: str | None = None,
                 engine_factory=None, ingest: bool | None = None,
                 decode_pool: int | None = None, decode: bool | None = None,
                 decode_continuous: bool = True):
        """``admission``: None = ``$KDLT_ADMISSION`` (on by default); False
        turns deadline rejection and the concurrency limiter off (drain
        stays on).  ``sched_policy`` and ``sched_weights``: the scheduler's
        (None = ``$KDLT_SCHED_POLICY`` and ``$KDLT_SCHED_WEIGHTS``).
        ``profile_base``: the directory /debug/profile captures go under;
        "" = ``$KDLT_PROFILE_DIR`` or ``<tmp>/kdlt-traces``, None turns the
        capture off.  ``request_log``: one stdout line per predict (errors
        are always logged).  ``slo``: None = ``$KDLT_SLO`` (on by default).
        ``incident_dir``: where the flight recorder writes its bundles (None =
        ``$KDLT_INCIDENT_DIR``; its other settings are its ``KDLT_INCIDENT*``
        environment).  ``engine_factory``: what builds each version's
        engine (``InferenceEngine``; ``runtime.stub.StubEngine`` takes the
        device out).  ``ingest``: None = ``$KDLT_INGEST`` (on): offer and
        accept the bytes wire, decoded by ``decode_pool`` threads (None =
        ``$KDLT_DECODE_POOL`` or a core-scaled default).  ``decode``: None =
        ``$KDLT_DECODE`` (off by default); on, the generative lane serves
        ``:generate`` on ``device`` (``decode_continuous=False``: static
        request-boundary batching, the A/B baseline)."""
        if profile_base == "":
            profile_base = (os.environ.get(PROFILE_DIR_ENV, "").strip()
                            or os.path.join(tempfile.gettempdir(), "kdlt-traces"))
        self._profile_base = profile_base
        self._profile_lock = threading.Lock()
        self.request_log = request_log
        self.registry = metrics_lib.Registry()
        # Per-request span traces (utils.trace), keyed by the propagated
        # X-Request-Id and served at /debug/trace/<rid>; the registry gets
        # the retention accounting (kdlt_trace_{retained,dropped}_total).
        self.tracer = trace_lib.Tracer("model-server", registry=self.registry)
        # Per-model goodput and burn-rate windows (utils.slo), fed from the
        # same boundary as kdlt_server_request_seconds.
        self.slo = slo_lib.SloEngine(self.registry, tier="model-server", enabled=slo)
        self._m_requests = self.registry.counter("kdlt_server_requests_total",
                                                 "predict requests")
        self._m_errors = self.registry.counter("kdlt_server_errors_total",
                                               "failed predict requests")
        self._m_latency = self.registry.histogram("kdlt_server_request_seconds",
                                                  "request handling latency")
        # The native libraries this process compiled (0 after a boot against a
        # build directory kdlt-torch-warm filled), and every kernel wrapper's
        # launches; both read at scrape time.
        self._m_builds = self.registry.gauge(
            "kdlt_native_builds", "kernel and host libraries this process compiled "
            "(nvcc, g++); 0 when it booted against a warmed build directory")
        self._m_launches: dict[str, metrics_lib.Gauge] = {}  # guarded-by: _launches_lock
        self._launches_lock = threading.Lock()
        # The model tier's front door.  The limiter's floor is 2x the largest
        # bucket: the admitted handlers ARE the batcher's supply, so a lower
        # limit would starve batch formation without shortening anyone's
        # wait; below it, overload belongs to the shed path.  The ceiling is
        # 2x the floor, or the operator's KDLT_ADMISSION_MAX_CONCURRENCY if
        # higher (never under the floor: that would turn the AIMD decrease
        # into an increase).
        floor = 2.0 * max(buckets)
        self.admission = AdmissionController(
            self.registry, tier="model-server", enabled=admission,
            limiter=(AdaptiveLimiter(min_limit=floor, max_limit=max(2.0 * floor, env_max_limit()))
                     if admission_enabled(admission) else None),
        )
        # The bytes wire: offered on spec discovery, decoded here in a pool
        # whose native calls release the interpreter lock, through a cache
        # of decoded pixels keyed by content and preprocessing parameters.
        self._ingest_enabled = protocol.ingest_enabled(ingest)
        self._ingest_decoder = preprocess_lib.BatchDecoder(decode_pool)
        self._decoded_cache = cache_lib.DecodedCache(registry=self.registry)
        self._m_ingest = (metrics_lib.ingest_server_metrics(self.registry)
                          if self._ingest_enabled else None)
        self._engine_factory = engine_factory or InferenceEngine
        self.model_root = model_root
        self._buckets = tuple(buckets)
        self._device = device
        self._max_delay_ms = max_delay_ms
        self._use_batcher = use_batcher
        self._pipeline_depth = pipeline_depth
        self._batcher_impl = batcher_impl
        # A version that loads once the server has been warmed (a reload) is
        # warmed before it is swapped in; warmup() warms the first scan's.
        self._warm = False
        # One scheduler and one shared dispatcher for every model, as in the
        # JAX server: batching on and any batcher but "native", whose C++
        # queue keeps a private pipeline per model.
        self.dispatcher: InFlightDispatcher | None = None
        self.scheduler: UnifiedScheduler | None = None
        if use_batcher and batcher_impl != "native":
            self.dispatcher = InFlightDispatcher(None, depth=pipeline_depth,
                                                 registry=self.registry)
            self.scheduler = UnifiedScheduler(registry=self.registry, policy=sched_policy,
                                              weights=sched_weights, dispatcher=self.dispatcher)
        # The incident flight recorder (utils.flightrecorder): registry
        # loads and unloads and dispatch stalls record into its timeline; a
        # stall captures a bundle with the causal request's trace.  Built
        # before the first poll, whose loads it records.
        self.recorder = incident_lib.FlightRecorder(
            "model-server", self.registry, tracer=self.tracer, incident_dir=incident_dir,
            profiler=self._incident_profile)
        self.recorder.add_snapshot_provider("slo", self.slo.debug_payload)
        if self.scheduler is not None:
            self.recorder.add_snapshot_provider("scheduler", self.scheduler.lanes_snapshot)
        self.model_registry = ModelRegistry(model_root, loader=self._load_model,
                                            unloader=self._unload_model)
        self._watcher: threading.Thread | None = None
        self._watcher_stop = threading.Event()
        self.generate: generate_lib.GenerateLane | None = None
        self.poll_versions()
        try:
            if not self.models:
                raise ValueError(f"no model versions found under {model_root!r}")
            self._httpd = ServingHTTPServer((host, port), self._handler_class())
            # The generative lane (serving.generate): continuous batching over
            # a paged KV-cache, with this tier's registry, SLO engine, tracer
            # and flight recorder, so decode and image burn read off the same
            # dashboards.  Opt-in: the image path is the same with it off.
            if generate_lib.decode_enabled(decode):
                self.generate = generate_lib.GenerateLane(
                    registry=self.registry, slo=self.slo, tracer=self.tracer,
                    recorder=self.recorder, continuous=decode_continuous,
                    engine_kwargs={"device": device})
                self.recorder.add_snapshot_provider("decode", self.generate.debug_payload)
        except BaseException:
            if hasattr(self, "_httpd"):
                self._httpd.server_close()
            self._close_pipeline()
            self.recorder.close()
            self._ingest_decoder.close()
            raise
        self._thread: threading.Thread | None = None

    @property
    def models(self) -> dict[str, ServedModel]:
        """The name -> ServedModel routing map (the registry's)."""
        return self.model_registry.models

    @property
    def engines(self) -> dict[str, InferenceEngine]:
        return {name: model.engine for name, model in self.models.items()}

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    @property
    def ready(self) -> bool:
        return all(e.ready for e in self.engines.values())

    @property
    def stalled(self) -> bool:
        if self.scheduler is not None and self.scheduler.stalled:
            return True
        return any(m.stalled for m in self.models.values())

    def warmup(self) -> None:
        for name, model in self.models.items():
            model.warmup_s = model.engine.warmup()
            log.info("warmed %s in %.2f s", name, model.warmup_s)
        if self.generate is not None:
            rep = self.generate.warmup()
            log.info("warmed decode %s in %.2f s (prefill buckets %s, one step; %d graphs)",
                     rep["model"], sum(rep["buckets"].values()) + rep["step_s"],
                     sorted(rep["buckets"], key=int), rep["graphs"])
        self._warm = True

    def start(self) -> None:
        self._thread = threading.Thread(target=self._httpd.serve_forever, daemon=True)
        self._thread.start()

    # --- versions ----------------------------------------------------------------

    def poll_versions(self) -> list[str]:
        """One scan of the artifact root: load any new model, or a higher
        version whose bytes changed (``serving.registry``); "name vN" per
        swap.  The first scan (from ``__init__``) is the initial load."""
        return self.model_registry.poll()

    def _load_model(self, name: str, version: int, directory: str) -> ServedModel | None:
        """The registry's loader: build one version's engine and pipeline,
        warm it (capture its graphs) if the server is warm, and activate it,
        all before the registry swaps it in.  An artifact whose
        ``spec.name`` is not its directory's name is declined: the name is
        the serving key, the URL path and the version-comparison key."""
        artifact = art.load_artifact(directory)
        if artifact.spec.name != name:
            log.warning("version watcher: skipping %s: spec.name %r != directory name %r",
                        directory, artifact.spec.name, name)
            return None
        child = metrics_lib.model_version_registry(self.registry, name, version)
        engine = fresh = None
        try:
            engine = self._engine_factory(artifact, buckets=self._buckets, device=self._device,
                                          pipeline_depth=self._pipeline_depth, registry=child)
            fresh = ServedModel(engine, self._max_delay_ms, self._use_batcher,
                                self._pipeline_depth, self._batcher_impl,
                                scheduler=self.scheduler, artifact=artifact, version=version)
            if self._warm:
                fresh.warmup_s = engine.warmup()
                log.info("warmed %s v%d in %.2f s", name, version, fresh.warmup_s)
        except BaseException:
            # The registry retries on its next scan; nothing of this version
            # may stay behind (its series, its device memory).
            if fresh is not None:
                fresh.close()
            if engine is not None:
                engine.close()
            self.registry.remove(child)
            raise
        fresh.activate()
        self.recorder.record("registry.load", model=name, version=version)
        return fresh

    def _unload_model(self, old: ServedModel) -> None:
        """The registry's unloader for a superseded version: stop its
        pipeline, free its engine's device memory once nothing of it is
        left to run, and drop its series."""
        if old.close():
            old.engine.close()
        else:
            log.error("%s v%s: dispatches still in flight after %.0f s; its device memory "
                      "stays allocated", old.name, old.version, UNLOAD_WAIT_S)
        self.registry.remove(old.engine.registry)
        self.recorder.record("registry.unload", model=old.name, version=old.version)

    def start_version_watcher(self, interval_s: float = 10.0) -> None:
        """Scan the artifact root for new versions every ``interval_s``
        seconds in a daemon thread (hot reload)."""

        def loop():
            while not self._watcher_stop.wait(interval_s):
                try:
                    self.poll_versions()
                except Exception:  # noqa: BLE001 - the watcher must keep watching
                    log.exception("version watcher error")

        self._watcher = threading.Thread(target=loop, name="kdlt-version-watcher", daemon=True)
        self._watcher.start()

    def begin_drain(self) -> None:
        """Graceful drain: /readyz answers 503 "draining", new predicts
        shed "draining", admitted ones run to completion
        (``admission.wait_idle``).  SIGTERM leads here from the command line."""
        self.admission.begin_drain()

    def _close_pipeline(self) -> None:
        """Drain the lanes, then the models, then the shared dispatcher."""
        if self.scheduler is not None:
            self.scheduler.close(drain=True)
        for model in self.models.values():
            model.close()
        if self.dispatcher is not None:
            self.dispatcher.close(drain=True)

    def shutdown(self) -> None:
        """Stop the version watcher, drain the pipeline, then stop HTTP and
        the flight recorder."""
        self._watcher_stop.set()
        if self._watcher is not None:
            self._watcher.join(timeout=30)
        if self.generate is not None:
            self.generate.close()
        self._close_pipeline()
        self.recorder.close()
        self._ingest_decoder.close()
        if self._thread is not None:  # shutdown() waits for a loop that must be running
            self._httpd.shutdown()
            self._thread.join(timeout=10)
        self._httpd.server_close()

    # --- request handling ----------------------------------------------------

    def _refresh_native_metrics(self) -> None:
        from kubernetes_deep_learning_tpu_torch.ops import _counts, _native

        self._m_builds.set(len(_native.built()))
        with self._launches_lock:  # concurrent scrapes mint each series once
            for name, n in _counts.totals().items():
                gauge = self._m_launches.get(name)
                if gauge is None:
                    gauge = self.registry.with_labels(kernel=name).gauge(
                        "kdlt_kernel_launches", "hand-written kernel launches by wrapper "
                        "(graph replays credited)")
                    self._m_launches[name] = gauge
                gauge.set(n)

    def handle_get(self, path: str) -> Reply:
        """A GET by its path (a query string is read by /debug/profile)."""
        path, _, query = path.partition("?")
        if path.startswith("/debug"):
            return self._handle_debug(path, parse_qs(query))
        if path == "/healthz":
            if self.stalled:
                # A stalled dispatch pipeline is unrecoverable in-process:
                # fail liveness so the orchestrator restarts the pod.
                return 503, b"dispatch stalled", "text/plain", {}
            return 200, b"ok", "text/plain", {}
        if path == "/readyz":
            if self.admission.draining:
                # Readiness fails first, so the endpoint pool stops routing
                # here while admitted batches complete.
                return 503, b"draining", "text/plain", {}
            if self.stalled:
                return 503, b"dispatch stalled", "text/plain", {}
            if not self.ready:
                return 503, b"warming", "text/plain", {}
            return 200, b"ready", "text/plain", {}
        if path == "/metrics":
            # Pull-model freshness: the SLO window gauges are recomputed at
            # scrape time, not on a timer.
            self.slo.refresh()
            self._refresh_native_metrics()
            return 200, self.registry.render().encode(), protocol.METRICS_CONTENT_TYPE, {}
        if path == _PREFIX:
            return _json(200, self.model_registry.status())
        found = _STATUS_RE.match(path)
        if found:
            status = self.model_registry.model_status(found.group(1))
            if status is None:
                return _error(404, f"no model {found.group(1)!r}")
            return _json(200, status)
        if path.startswith(_PREFIX + "/"):
            name = path[len(_PREFIX) + 1 :]
            engine = self.engines.get(name)
            if engine is not None:
                # Spec discovery doubles as the ingest offer: the header's
                # presence is the capability.
                offer = ({protocol.INGEST_HEADER: protocol.INGEST_BYTES_CAP}
                         if self._ingest_enabled else {})
                return 200, engine.spec.to_json().encode(), protocol.JSON_CONTENT_TYPE, offer
            return _error(404, f"no model {name!r}")
        return _error(404, "not found")

    def handle_predict(self, path: str, body, content_type: str, headers=None) -> Reply:
        """``serve_predict``, its exchange finished once the reply is made."""
        reply, exchange = self.serve_predict(path, body, content_type, headers)
        exchange.finish()
        return reply

    def serve_predict(self, path: str, body, content_type: str,
                      headers=None) -> tuple[Reply, _Exchange]:
        """A ``:predict`` request -> (reply, its exchange).

        ``body`` is the request's bytes, or a callable that reads them: the
        HTTP handler passes one, so the body is read only once the request
        is admitted.  ``headers`` (any mapping with ``get``) carry the
        request id, the parent span, the deadline and the priority.  The
        caller sends the reply with ``exchange.reply_headers()`` added, then
        calls ``exchange.finish()``, which releases the admission ticket and
        does the request's accounting.
        """
        headers = headers if headers is not None else {}
        ex = _Exchange(self, headers)
        try:
            return self._serve(path, body, content_type, headers, ex), ex
        finally:
            ex.w_end = trace_lib.now_s()

    def _serve(self, path: str, body, content_type: str, headers, ex: _Exchange) -> Reply:
        self._m_requests.inc()
        # server.admission is the front door from the request's arrival:
        # routing, the deadline and priority, the admission decision.
        try:
            with ex.stage(trace_lib.SPAN_SERVER_ADMISSION):
                if not (path.startswith(_PREFIX + "/") and path.endswith(":predict")):
                    return _error(404, "not found")
                name = path[len(_PREFIX) + 1 : -len(":predict")]
                model = self.models.get(name)
                if model is None:
                    return _error(404, f"no model {name!r}")
                if not model.engine.ready:
                    return _error(503, "model is warming up")
                # Only served names reach the bounded ``model`` label.
                metrics_lib.model_request_counter(self.registry, name).inc()
                ex.model = name
                # The deadline is parsed only with admission on: off, every
                # wait is the fixed one of a server without admission.
                deadline = (Deadline.from_header(headers.get(DEADLINE_HEADER))
                            if self.admission.enabled else None)
                ex.deadline = deadline
                priority = protocol.parse_priority(headers.get(protocol.PRIORITY_HEADER))
                ex.ticket = self.admission.admit(deadline, model=name, priority=priority)
        except Shed as e:  # a refusal, not a fault: before the body is read
            ex.status = e.http_status
            return _json(e.http_status, {"error": str(e), "shed_reason": e.reason},
                         e.headers())
        return self._predict(model, body, content_type, deadline, priority, ex)

    def serve_generate(self, name: str, body, headers=None
                       ) -> tuple[tuple, _GenerateExchange]:
        """A ``:generate`` request for model ``name`` -> ((status, payload,
        content type, headers), its exchange), as the JAX server's route:
        the same front door as ``:predict`` (admission before the body is
        read, the deadline and the priority class), then the lane.  A 200
        with ``stream`` carries an iterator of SSE frames the caller writes
        chunked; the caller calls ``exchange.finish()`` once the reply (the
        whole stream) went out.  ``body``: bytes, or a callable that reads
        them."""
        headers = headers if headers is not None else {}
        ex = _GenerateExchange(self, headers)
        ex.lane_recorded = False
        self._m_requests.inc()
        lane = self.generate
        if lane is None:
            ex.status = 404
            return _error(404, "generative lane disabled (start the server with --decode or "
                          f"{generate_lib.DECODE_ENV}=1)"), ex
        if name != lane.model:
            ex.status = 404
            return _error(404, f"no generative model {name!r}"), ex
        metrics_lib.model_request_counter(self.registry, name).inc()
        ex.model = name
        deadline = (Deadline.from_header(headers.get(DEADLINE_HEADER))
                    if self.admission.enabled else None)
        ex.deadline = deadline
        priority = protocol.parse_priority(headers.get(protocol.PRIORITY_HEADER))
        try:
            with ex.stage(trace_lib.SPAN_SERVER_ADMISSION):
                ex.ticket = self.admission.admit(deadline, model=name, priority=priority)
            length = int(headers.get("Content-Length") or 0)
            if length > generate_lib.MAX_GENERATE_BODY_BYTES:
                raise ValueError(f"generate body {length} bytes exceeds the "
                                 f"{generate_lib.MAX_GENERATE_BODY_BYTES}-byte limit")
            with ex.stage(trace_lib.SPAN_SERVER_DECODE) as span:
                raw = body() if callable(body) else body
                span.tags["bytes"] = len(raw)
            reply = lane.handle_generate(raw, rid=ex.rid, deadline=deadline, priority=priority)
        except Shed as e:  # a refusal, not a fault: before the body is read
            ex.status = e.http_status
            return _json(e.http_status, {"error": str(e), "shed_reason": e.reason},
                         e.headers()), ex
        except ValueError as e:  # a malformed request
            ex.status = 400
            return _error(400, str(e)), ex
        except Exception as e:  # noqa: BLE001 - a request must get an answer
            log.exception("generate failed")
            return _error(500, str(e)), ex
        ex.lane_recorded = True  # the lane owns the SLO record from here on
        ex.status = reply[0]
        return reply, ex

    def _infer(self, model: ServedModel, images: np.ndarray, deadline: Deadline | None,
               priority: str, trace: trace_lib.RequestTrace | None = None
               ) -> tuple[np.ndarray, str | None]:
        """(logits, the artifact hash of the version that served them, None
        if a reload split the request between two).  A request that
        resolved a version a reload has since closed is served by the new
        one."""
        engines: list = []
        try:
            logits = model.predict(images, deadline, priority, engines=engines, trace=trace)
        except EngineClosed:
            fresh = self.models.get(model.name)
            if fresh is None or fresh is model:
                raise
            engines.clear()
            logits = fresh.predict(images, deadline, priority, engines=engines, trace=trace)
        hashes = {getattr(e, "artifact_hash", None) for e in engines}
        return logits, hashes.pop() if len(hashes) == 1 else None

    def _predict(self, model: ServedModel, body, content_type: str,
                 deadline: Deadline | None, priority: str, ex: _Exchange) -> Reply:
        try:
            encoded = content_type.split(";")[0].strip() == protocol.BYTES_CONTENT_TYPE
            with ex.stage(trace_lib.SPAN_SERVER_DECODE) as span:
                raw = body() if callable(body) else body
                span.tags["bytes"] = len(raw)
                if not encoded:
                    images = protocol.decode_predict_request(raw, content_type)
                elif not self._ingest_enabled:
                    raise ValueError(
                        "raw-bytes ingest is disabled on this server (set "
                        f"{protocol.INGEST_ENV}=1 or use the tensor wire)")
                else:
                    blobs = protocol.decode_bytes_predict_request(
                        raw, max_images=MAX_IMAGES_PER_REQUEST)
            staged = False
            if encoded:
                spec = model.engine.spec
                # Device-resize staging ($KDLT_INGEST_DEVICE_RESIZE): decode
                # stops at the staging resolution, and the engine's staged
                # program resizes on the device ahead of the forward.
                src = tuple(getattr(model.engine, "ingest_source_shape", spec.input_shape))
                staged = src != tuple(spec.input_shape)
                with ex.stage(trace_lib.SPAN_SERVER_INGEST_DECODE, images=len(blobs),
                              bytes=len(raw)):
                    images = self._decode_blobs(src, spec.resize_filter, blobs)
            ex.batch = int(images.shape[0]) if images.ndim else 0
            # server.predict runs from the images to the reply's bytes.
            with ex.stage(trace_lib.SPAN_SERVER_PREDICT, batch=ex.batch) as span:
                if staged:
                    logits, digest = self._predict_staged(model, images)
                else:
                    logits, digest = self._infer(model, images, deadline, priority, span)
                out, ctype = protocol.encode_predict_response(logits, model.engine.spec.labels,
                                                              content_type)
        except ValueError as e:  # malformed request
            ex.status = 400
            return _error(400, str(e))
        except (QueueFull, FuturesTimeout) as e:  # transient overload
            # An admitted request still missed its budget or found the
            # batcher full: the AIMD limit is too high for the service time.
            ex.status = 503
            ex.ticket.mark_overloaded()
            return _error(503, f"overloaded: {e or 'timed out'}",
                          protocol.retry_after_headers(self.admission.retry_after_s()))
        except DispatchStall as e:
            # Retryable for the client (another replica serves it), terminal
            # for this process: the header tells the gateway to take the
            # replica out of its pool now, not after repeated failures.
            ex.status, ex.stalled = 503, True
            return _error(503, f"dispatch stalled: {e}", {
                **protocol.retry_after_headers(protocol.STALL_RETRY_AFTER_S),
                protocol.STALLED_HEADER: "1",
            })
        except Exception as e:  # noqa: BLE001 - a request must get an answer
            log.exception("predict failed")
            return _error(500, str(e))
        ex.status = 200
        # The served artifact's identity rides every success: the gateway's
        # response cache drops a model's entries when it changes.
        return 200, out, ctype, {protocol.ARTIFACT_HASH_HEADER: digest} if digest else {}

    def _predict_staged(self, model: ServedModel, images: np.ndarray
                        ) -> tuple[np.ndarray, str | None]:
        """Device-resize staging dispatch: staging-resolution uint8 batches go
        straight to the engine's staged program, chunked to the bucket
        ladder.  The scheduler's lanes and the batchers carry input_shape
        tensors only, so this opt-in path bypasses them (serial, as the JAX
        server's).  (logits, the artifact hash of the engine that served
        them); a request that resolved a version a reload has since closed
        is served by the new one."""
        try:
            return self._staged_on(model.engine, images)
        except EngineClosed:
            fresh = self.models.get(model.name)
            if fresh is None or fresh is model:
                raise
            return self._staged_on(fresh.engine, images)

    @staticmethod
    def _staged_on(eng, images: np.ndarray) -> tuple[np.ndarray, str | None]:
        outs = []
        for i in range(0, images.shape[0], eng.max_batch):
            handle, n = eng.predict_ingest_async(images[i:i + eng.max_batch])
            outs.append(np.asarray(handle)[:n])
        logits = np.concatenate(outs) if len(outs) > 1 else outs[0]
        return logits, getattr(eng, "artifact_hash", None)

    def _decode_blobs(self, shape, resize_filter: str, blobs: list[bytes]) -> np.ndarray:
        """The bytes wire's decode stage: encoded blobs -> uint8 (N,H,W,C)
        at ``shape``, through the decoded-pixel cache (keyed by content hash
        and preprocessing parameters, so a repeat image skips decode and
        resize).  Misses fan out on the decode pool; a corrupt or
        unsupported blob raises ValueError (a 400)."""
        t0 = time.perf_counter()
        params = cache_lib.decoded_params(shape, resize_filter)
        keys = [cache_lib.decoded_key(b, params) for b in blobs]
        out: list = [self._decoded_cache.get(k) for k in keys]
        miss = [i for i, arr in enumerate(out) if arr is None]
        if miss:
            decoded = self._ingest_decoder.decode_batch([blobs[i] for i in miss], shape[:2],
                                                        filter=resize_filter)
            for j, i in enumerate(miss):
                self._decoded_cache.put(keys[i], decoded[j])
                out[i] = decoded[j]
        images = np.stack(out)
        if self._m_ingest is not None:
            self._m_ingest["decoded_images"].inc(len(blobs))
            self._m_ingest["decode_seconds"].observe(time.perf_counter() - t0)
        return images

    # --- observability: /debug/* ----------------------------------------------

    def debug_index(self) -> dict:
        """GET /debug/: this tier's debug routes, one line each."""
        return {
            "tier": "model-server",
            "routes": {
                "/debug/slo": "per-model goodput and burn-rate windows as this replica "
                "observed them (plus the decode lane's per-token TTFT/TPOT view when "
                "--decode is on)",
                "/debug/incidents": "flight-recorder bundles captured on this replica",
                "/debug/incidents/<id>": "one full incident bundle (timeline, pinned traces, "
                "snapshots, metrics delta)",
                "/debug/trace/<rid>": "this tier's span waterfall for one request id",
                "/debug/profile?seconds=N": "capture a trace of the card's kernels (CUPTI) "
                "under KDLT_PROFILE_DIR, naming the top device kernels",
                "/debug/profile?audit=buckets": "per-model bucket-shape audit: padding-waste "
                "ratio + FLOPs/img per bucket",
            },
        }

    def bucket_audit(self) -> dict:
        """GET /debug/profile?audit=buckets: every served model's per-bucket
        padding waste and FLOPs per image."""
        return {"tier": "model-server",
                "models": {name: m.engine.bucket_audit() for name, m in self.models.items()}}

    def _handle_debug(self, path: str, query: dict) -> Reply:
        if path == "/debug/slo":
            payload = self.slo.debug_payload()
            if self.generate is not None:
                # The per-token view beside the per-request windows: what
                # kdlt-torch-client --slo renders as its decode table.
                payload["decode"] = self.generate.debug_payload()
            return _json(200, payload)
        if path in ("/debug", "/debug/"):
            return _json(200, self.debug_index())
        if path in ("/debug/incidents", "/debug/incidents/"):
            return _json(200, self.recorder.debug_payload())
        if path.startswith("/debug/incidents/"):
            bundle_id = path.rsplit("/", 1)[-1]
            bundle = self.recorder.get(bundle_id)
            if bundle is None:
                return _error(404, f"no incident bundle {bundle_id!r}")
            return _json(200, bundle)
        if path.startswith("/debug/trace/"):
            rid = ensure_request_id(path.rsplit("/", 1)[-1])
            info = self.tracer.trace_info(rid)
            if info is None:
                # The ring's accounting on the 404: "evicted" and "never
                # instrumented" are different debugging paths.
                return _json(404, {"error": f"no trace for {rid!r} (evicted from the ring "
                                   "buffer or never seen)", "ring": self.tracer.stats()})
            return _json(200, {"trace_id": rid, "tier": "model-server", **info})
        if path == "/debug/profile":
            if query.get("audit", [""])[0] == "buckets":
                # Host-side bookkeeping: served even with profiling off.
                return _json(200, self.bucket_audit())
            return self.handle_profile(query.get("seconds", ["2.0"])[0])
        return _error(404, "not found")

    def handle_profile(self, seconds) -> Reply:
        """``/debug/profile``: a capture of ``seconds`` (in (0, 60]) while
        the other handler threads serve (``_profile``).  404 with profiling
        off; 409 while another capture, or a CUDA graph capture, runs (the
        recording never starts or stops during a graph capture)."""
        if self._profile_base is None:
            return _error(404, "profiling disabled")
        try:
            seconds = float(seconds)
            if not 0 < seconds <= 60:
                raise ValueError("seconds must be in (0, 60]")
            # Client input never chooses the path: a fresh directory under
            # the operator-configured base.
            os.makedirs(self._profile_base, exist_ok=True)
            trace_dir = tempfile.mkdtemp(prefix="kdlt-trace-", dir=self._profile_base)
        except (ValueError, TypeError) as e:
            return _error(400, str(e))
        try:
            return _json(200, self._profile(seconds, trace_dir))
        except _ProfileBusy as e:
            os.rmdir(trace_dir)
            return _error(409, str(e))

    def _profile(self, seconds: float, trace_dir: str) -> dict:
        """Capture the card (without one, the CPU) for ``seconds`` into
        ``trace_dir/trace.json``: {"trace_dir", "seconds", "kernels"}, the
        device kernels that took the most time in the window (name ->
        launches and total microseconds; the CUDA graphs' replays
        included).

        Serving goes on meanwhile, on the other handler threads.
        ``capture_lock`` is held only while the recording starts and while
        it stops (a graph capture must not straddle either), never for the
        window or while the trace is written, so a reload's capture, an
        unload's close and a w8a8 downgrade wait for those moments only.
        On the card the recording is ``ops._native.DeviceTrace`` (CUPTI
        activity; its stop, the chrome trace and the kernel summary run in
        C++ with the interpreter lock released): torch.profiler's stop and
        export each held the lock 0.5-1.5 s after a busy 2 s window on the
        H100.  Raises
        _ProfileBusy while another capture runs, or a CUDA graph capture
        when it starts."""
        if not self._profile_lock.acquire(blocking=False):
            raise _ProfileBusy("a profile capture is already running")
        try:
            recording = (_native.DeviceTrace() if torch.cuda.is_available()
                         else _CpuProfile())
            if not capture_lock.acquire(blocking=False):
                raise _ProfileBusy("a CUDA graph capture is running")
            try:
                recording.start()
            finally:
                capture_lock.release()
            path = os.path.join(trace_dir, "trace.json")
            try:
                time.sleep(seconds)
            finally:
                with capture_lock:  # a graph capture in progress finishes first
                    recording.stop()
            kernels = recording.write(path, PROFILE_TOP_KERNELS)
            return {"trace_dir": trace_dir, "seconds": seconds, "kernels": kernels}
        finally:
            self._profile_lock.release()

    def _incident_profile(self, seconds: float) -> dict:
        """The flight recorder's profile hook (``KDLT_INCIDENT_PROFILE_S`` >
        0): the /debug/profile capture, under the same locks; a capture
        already running wins and the bundle notes the skip."""
        if self._profile_base is None:
            return {"skipped": "profiling disabled"}
        os.makedirs(self._profile_base, exist_ok=True)
        trace_dir = tempfile.mkdtemp(prefix="kdlt-incident-", dir=self._profile_base)
        try:
            return self._profile(seconds, trace_dir)
        except _ProfileBusy as e:
            os.rmdir(trace_dir)
            return {"skipped": str(e)}

    def _handler_class(self):
        server = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"
            # The reply goes out in two writes (headers, body); with Nagle on,
            # the second waits for the client's delayed ACK (~40 ms) on a
            # keep-alive connection.
            disable_nagle_algorithm = True

            # A body at most this size is drained (not closed over) when the
            # reply goes out before it was read: sheds come under overload,
            # just when a gateway's kept-alive connections are worth most.
            _DRAIN_LIMIT = 1 << 20

            def _reply(self, status: int, body: bytes, ctype: str,
                       headers: dict[str, str], exchange: _Exchange | None = None) -> None:
                if exchange is not None:
                    headers = {**headers, **exchange.reply_headers()}
                self.send_response(status)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                if self.close_connection:
                    # Said explicitly, so a pooling client retires the
                    # connection instead of reusing a dead socket.
                    self.send_header("Connection", "close")
                for key, value in headers.items():
                    self.send_header(key, value)
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):  # noqa: N802 - http.server API
                self._reply(*server.handle_get(self.path))

            def _read_body(self) -> bytes:
                self._body_read = True
                try:
                    length = int(self.headers.get("Content-Length") or 0)
                except ValueError:
                    self.close_connection = True
                    raise ValueError("malformed Content-Length") from None
                return self.rfile.read(length)

            def _discard_body(self) -> None:
                """Settle a body that was never read before the connection is
                reused: left in the socket, the keep-alive loop would parse
                it as the next request line.  Small bodies are drained;
                large, chunked or unsized ones close the connection."""
                self._body_read = True
                if "chunked" in self.headers.get("Transfer-Encoding", "").lower():
                    self.close_connection = True
                    return
                try:
                    length = int(self.headers.get("Content-Length") or 0)
                except ValueError:
                    length = -1
                if not 0 <= length <= self._DRAIN_LIMIT:
                    self.close_connection = True
                    return
                try:
                    while length > 0:
                        chunk = self.rfile.read(min(length, 65536))
                        if not chunk:
                            self.close_connection = True
                            return
                        length -= len(chunk)
                except OSError:
                    self.close_connection = True

            def _profile_request(self) -> Reply:
                """POST /debug/profile with a JSON body {"seconds": s}."""
                try:
                    raw = self._read_body()
                    req = json.loads(raw) if raw else {}
                    if not isinstance(req, dict):
                        raise ValueError("body must be a JSON object")
                except ValueError as e:
                    return _error(400, str(e))
                return server.handle_profile(req.get("seconds", 2.0))

            def _generate(self, name: str) -> None:
                reply, exchange = server.serve_generate(name, self._read_body, self.headers)
                status, payload, ctype, headers = reply
                try:
                    if not self._body_read:  # a reply made before the body was read
                        self._discard_body()
                    headers = {**headers, **exchange.reply_headers()}
                    if isinstance(payload, bytes):
                        self._reply(status, payload, ctype, headers)
                    else:
                        send_chunked(self, status, payload, ctype, headers)
                except ConnectionError:  # the client hung up
                    self.close_connection = True
                finally:
                    exchange.finish()

            def do_POST(self):  # noqa: N802 - http.server API
                self._body_read = False
                path = self.path.split("?", 1)[0]
                if path == "/debug/profile":
                    self._reply(*self._profile_request())
                    return
                found = _GENERATE_RE.match(path)
                if found:
                    self._generate(found.group(1))
                    return
                exchange = None
                try:
                    reply, exchange = server.serve_predict(
                        path, self._read_body, self.headers.get("Content-Type", ""),
                        self.headers)
                except Exception as e:  # noqa: BLE001 - a request must get an answer
                    log.exception("predict failed")
                    reply = _error(500, str(e))
                try:
                    if not self._body_read:  # a reply made before the body was read
                        self._discard_body()
                    self._reply(*reply, exchange=exchange)
                except ConnectionError:  # the client hung up (gave up waiting)
                    self.close_connection = True
                finally:
                    if exchange is not None:  # after the reply: drain waits for it
                        exchange.finish()

            def log_message(self, fmt, *args):
                log.debug(fmt, *args)

        return Handler


def native_libraries_line() -> str:
    """The boot line's account of the native libraries: where they load
    from and which this process had to compile."""
    from kubernetes_deep_learning_tpu_torch.ops import _build, _native

    built = _native.built()
    names = ", ".join(built) or "none: no nvcc, no g++"
    return f"native libraries from {_build.build_dir()}: {len(built)} built here ({names})"


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="PyTorch/CUDA model server (tensor wire)")
    p.add_argument("--model-root", required=True, help="directory of <name>/<version>/ artifacts")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8500)
    p.add_argument("--buckets", default=",".join(map(str, DEFAULT_BUCKETS)),
                   help="comma-separated batch buckets")
    p.add_argument("--device", default="cuda", help="torch device (cuda, cuda:1, cpu)")
    p.add_argument("--max-delay-ms", type=float, default=2.0,
                   help="how long a small batch waits for more single-image requests")
    p.add_argument(
        "--pipeline-depth", type=int, default=0,
        help="max batches in flight on the device (dispatch pipelining): batch "
        "N+1's staging and launches overlap batch N's execution.  0 = "
        "$KDLT_PIPELINE_DEPTH or the default 2; 1 = serial dispatch.  Depth > 2 "
        "buys nothing on one card (its stream runs one batch at a time); it "
        "only queues latency",
    )
    p.add_argument("--batcher", default="auto", choices=["auto", "native", "python"],
                   help="batching queue implementation (native = the C++ queue, "
                   "native/batchqueue.cc, built with g++ at first use; auto = native "
                   "when the process may run on 2 or more cores)")
    p.add_argument("--no-batching", action="store_true",
                   help="serve every request as its own forward")
    p.add_argument("--no-admission", action="store_true",
                   help="turn deadline rejection and the AIMD concurrency limiter off "
                   "(as KDLT_ADMISSION=0): every wait is the fixed 20 s (120 s a chunk); "
                   "drain on SIGTERM stays on")
    p.add_argument("--watch-interval", type=float, default=10.0,
                   help="seconds between artifact-root scans for new versions (0 = off)")
    p.add_argument("--sched-policy", default=None, choices=list(POLICIES),
                   help="cross-model arbitration policy of the scheduler (default "
                   "$KDLT_SCHED_POLICY or weighted_deadline): weighted_deadline = earliest "
                   "effective deadline with per-model weight floors; fifo = arrival order")
    p.add_argument("--sched-weights", default=None,
                   help='per-model scheduling weights, e.g. "clothing-model=2,vit-b16-384=1" '
                   "(default $KDLT_SCHED_WEIGHTS; unlisted models weigh 1.0)")
    p.add_argument("--profile-dir", default="",
                   help="base directory for /debug/profile traces (default $KDLT_PROFILE_DIR "
                   "or a kdlt-traces dir under the system temp dir)")
    p.add_argument("--no-profiling", action="store_true",
                   help="disable the /debug/profile capture")
    p.add_argument("--no-request-log", action="store_true",
                   help="disable the per-request traced log line (rid, model, batch, status)")
    p.add_argument("--no-slo", action="store_true",
                   help="disable the SLO engine (per-model goodput/burn-rate windows, "
                   "kdlt_slo_* gauges, /debug/slo); default $KDLT_SLO or enabled")
    p.add_argument("--decode", action="store_true",
                   help="ALSO serve the generative lane (/v1/models/<m>:generate): "
                   "continuous-batching autoregressive decode over a paged KV-cache with "
                   "streamed text/event-stream token responses and per-token TTFT/TPOT "
                   "SLOs.  Default $KDLT_DECODE=1; the model name is $KDLT_DECODE_MODEL "
                   "(gen-default)")
    p.add_argument("--static-decode-batching", action="store_true",
                   help="with --decode: replace continuous (token-boundary) batching with "
                   "static request-boundary batching (the A/B baseline); never in production")
    p.add_argument("--aot-warm", action="store_true",
                   help="run the kdlt-torch-warm pass (build the kernels' and host "
                   "libraries into $KDLT_TORCH_BUILD_DIR, warm every model's latest "
                   "version over --buckets) and EXIT: at image build or in an init "
                   "container sharing the build volume; a server booted with "
                   "$KDLT_TORCH_BUILD_DIR on that volume compiles nothing")
    return p


def _server_from_args(args: argparse.Namespace) -> ModelServer:
    return ModelServer(
        args.model_root, port=args.port, host=args.host,
        buckets=[int(b) for b in args.buckets.split(",")], device=args.device,
        max_delay_ms=args.max_delay_ms, use_batcher=not args.no_batching,
        pipeline_depth=args.pipeline_depth or None, batcher_impl=args.batcher,
        admission=False if args.no_admission else None, sched_policy=args.sched_policy,
        sched_weights=(None if args.sched_weights is None
                       else resolve_weights(args.sched_weights)),
        profile_base=None if args.no_profiling else args.profile_dir,
        request_log=not args.no_request_log, slo=False if args.no_slo else None,
        decode=True if args.decode else None, decode_continuous=not args.static_decode_batching,
    )


def build_server(argv: Sequence[str] | None = None) -> ModelServer:
    """The server the command line describes (not started, not warmed, no
    version watcher)."""
    return _server_from_args(_parser().parse_args(argv))


def main(argv: Sequence[str] | None = None) -> int:
    logging.basicConfig(level=logging.INFO)
    args = _parser().parse_args(argv)
    if args.aot_warm:  # image build / init container: the pass is the job
        from kubernetes_deep_learning_tpu_torch.export.warm import warm_models

        report = warm_models(args.model_root, buckets=[int(b) for b in args.buckets.split(",")],
                             device=args.device, decode=True if args.decode else None)
        failed = [n for n, m in report["models"].items() if "error" in m]
        if "error" in report.get("decode", {}):
            failed.append("decode")
        return 1 if failed or report["failed_libraries"] or not report["models"] else 0
    server = _server_from_args(args)
    stopped = threading.Event()

    def stop() -> None:
        server.shutdown()
        stopped.set()

    # SIGTERM: /readyz turns 503, new requests shed, admitted ones finish,
    # then the server stops and the process exits 0.
    install_sigterm_drain(server.admission, stop)
    server.start()  # /healthz answers while warming; /readyz waits for warmup
    server.warmup()
    if args.watch_interval > 0:
        server.start_version_watcher(args.watch_interval)
    log.info("serving %s on port %d", sorted(server.engines), server.port)
    log.info("%s", native_libraries_line())
    try:
        # A signal handler runs only when the main thread executes bytecode,
        # and the kernel may deliver SIGTERM to any thread (the CUDA runtime
        # starts several): a main thread blocked in an untimed wait would
        # never run it.  Waking twice a second lets it run.
        while not stopped.wait(0.5):
            pass
    except KeyboardInterrupt:
        stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
