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
  reads to discover the contract; no ingest capability is advertised, so a
  gateway keeps the tensor wire);
- ``POST /v1/models/<name>:predict``: msgpack or JSON (``serving.protocol``);
  uint8 images go through the model's lane in max-bucket chunks (or, with
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
  dispatch-pipeline and admission series, labelled by model and tier).

Run it with ``kdlt-torch-model-server --model-root DIR --device cuda``
(``--max-delay-ms``, ``--pipeline-depth``, ``--batcher``,
``--no-batching``, ``--no-admission``, ``--watch-interval``,
``--sched-policy``, ``--sched-weights``).  ``--no-admission`` or
``KDLT_ADMISSION=0`` turn deadline rejection and the limiter off (every
wait is then a fixed 20 s, or 120 s for a chunk); drain stays on.  SIGTERM
drains: /readyz turns 503 "draining", new requests shed, admitted ones
finish (at most ``KDLT_DRAIN_TIMEOUT_S``, 25 s), then the process exits.
"""

from __future__ import annotations

import argparse
import json
import logging
import re
import threading
from concurrent.futures import TimeoutError as FuturesTimeout
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Sequence

import numpy as np

from kubernetes_deep_learning_tpu_torch.export import artifact as art
from kubernetes_deep_learning_tpu_torch.runtime import create_batcher
from kubernetes_deep_learning_tpu_torch.runtime.batcher import BatcherClosed, QueueFull
from kubernetes_deep_learning_tpu_torch.runtime.engine import (
    DEFAULT_BUCKETS,
    DispatcherClosed,
    DispatchStall,
    EngineClosed,
    InferenceEngine,
    InFlightDispatcher,
    resolve_pipeline_depth,
)
from kubernetes_deep_learning_tpu_torch.runtime.scheduler import (
    POLICIES,
    UnifiedScheduler,
    resolve_weights,
)
from kubernetes_deep_learning_tpu_torch.serving import protocol
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
from kubernetes_deep_learning_tpu_torch.utils import metrics as metrics_lib

log = logging.getLogger(__name__)

_PREFIX = "/v1/models"
_STATUS_RE = re.compile(r"^/v1/models/([^/:]+):status$")

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
    ``batcher_impl`` (None when batching is off).
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
        self._scheduler = scheduler if use_batcher else None
        self.dispatcher = self.batcher = None
        if self._scheduler is None:
            depth = resolve_pipeline_depth(pipeline_depth)
            self.dispatcher = (
                InFlightDispatcher(engine, depth=depth, registry=engine.registry)
                if depth > 1 else None
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
                priority: str | None = None, engines: list | None = None) -> np.ndarray:
        """Logits for ``images``.  Every wait below (the lane's, the
        batcher's, the chunk futures') is bounded by ``deadline``'s remaining
        budget, so a request never holds a handler thread after its caller
        stopped listening; ``deadline=None`` keeps the fixed 20 s and 120 s.
        ``priority`` orders the request in its lane.  ``engines``, if given,
        receives the engine that served each part: on a lane, the version
        current when the part was dispatched, which a reload may have
        changed since this version was resolved."""
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
                                                 priority=priority)
                    row = self._wait(fut, batcher_timeout)
                    engines.append(fut.engine)
                    return row[None]
                futs = [self._scheduler.submit_batch(self.name, images[i : i + step],
                                                     deadline=deadline, priority=priority)
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
                return self.batcher.predict(images[0], timeout=batcher_timeout)[None]
            except BatcherClosed:
                pass  # a shutdown race: the engine is still valid, serve directly
        if images.ndim == 0 or len(images) <= step:
            return self.engine.predict(images)
        # Batches beyond the bucket ladder are served in max-bucket chunks:
        # the client's batch size need not know the server's buckets.  With
        # the pipeline on, chunk i+1's staging and launches overlap chunk
        # i's execution; the futures keep chunk order for the concatenate.
        chunks = [images[i : i + step] for i in range(0, len(images), step)]
        if self.dispatcher is not None and images.dtype == np.uint8:
            try:
                futs = [self.dispatcher.submit(c) for c in chunks]
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


class ModelServer:
    def __init__(self, model_root: str, port: int = 8500, host: str = "127.0.0.1",
                 buckets: Sequence[int] = DEFAULT_BUCKETS, device: str = "cuda",
                 max_delay_ms: float = 2.0, use_batcher: bool = True,
                 pipeline_depth: int | None = None, batcher_impl: str = "auto",
                 admission: bool | None = None, sched_policy: str | None = None,
                 sched_weights: dict[str, float] | None = None):
        """``admission``: None = ``$KDLT_ADMISSION`` (on by default); False
        turns deadline rejection and the concurrency limiter off (drain
        stays on).  ``sched_policy`` and ``sched_weights``: the scheduler's
        (None = ``$KDLT_SCHED_POLICY`` and ``$KDLT_SCHED_WEIGHTS``)."""
        self.registry = metrics_lib.Registry()
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
        self.model_registry = ModelRegistry(model_root, loader=self._load_model,
                                            unloader=self._unload_model)
        self._watcher: threading.Thread | None = None
        self._watcher_stop = threading.Event()
        self.poll_versions()
        if not self.models:
            self._close_pipeline()
            raise ValueError(f"no model versions found under {model_root!r}")
        try:
            self._httpd = ThreadingHTTPServer((host, port), self._handler_class())
        except OSError:
            self._close_pipeline()
            raise
        self._httpd.daemon_threads = True
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
            engine = InferenceEngine(artifact, buckets=self._buckets, device=self._device,
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
        """Stop the version watcher, drain the pipeline, then stop HTTP."""
        self._watcher_stop.set()
        if self._watcher is not None:
            self._watcher.join(timeout=30)
        self._close_pipeline()
        if self._thread is not None:  # shutdown() waits for a loop that must be running
            self._httpd.shutdown()
            self._thread.join(timeout=10)
        self._httpd.server_close()

    # --- request handling ----------------------------------------------------

    def handle_get(self, path: str) -> Reply:
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
                return 200, engine.spec.to_json().encode(), protocol.JSON_CONTENT_TYPE, {}
            return _error(404, f"no model {name!r}")
        return _error(404, "not found")

    def handle_predict(self, path: str, body, content_type: str, headers=None) -> Reply:
        """``serve_predict``, its ticket released once the reply is made."""
        reply, ticket = self.serve_predict(path, body, content_type, headers)
        if ticket is not None:
            ticket.release()
        return reply

    def serve_predict(self, path: str, body, content_type: str,
                      headers=None) -> tuple[Reply, Ticket | None]:
        """A ``:predict`` request -> (reply, admission ticket or None).

        ``body`` is the request's bytes, or a callable that reads them: the
        HTTP handler passes one, so the body is read only once the request
        is admitted.  ``headers`` (any mapping with ``get``) carry the
        deadline and the priority.  The caller releases the ticket after it
        has sent the reply.
        """
        if not (path.startswith(_PREFIX + "/") and path.endswith(":predict")):
            return _error(404, "not found"), None
        name = path[len(_PREFIX) + 1 : -len(":predict")]
        model = self.models.get(name)
        if model is None:
            return _error(404, f"no model {name!r}"), None
        if not model.engine.ready:
            return _error(503, "model is warming up"), None
        headers = headers if headers is not None else {}
        # The deadline is parsed only with admission on: off, every wait is
        # the fixed one of a server without admission.
        deadline = (Deadline.from_header(headers.get(DEADLINE_HEADER))
                    if self.admission.enabled else None)
        priority = protocol.parse_priority(headers.get(protocol.PRIORITY_HEADER))
        try:
            ticket = self.admission.admit(deadline, model=name, priority=priority)
        except Shed as e:  # a refusal, not a fault: before the body is read
            return _json(e.http_status, {"error": str(e), "shed_reason": e.reason},
                         e.headers()), None
        try:
            return self._predict(model, body, content_type, deadline, priority, ticket), ticket
        except BaseException:
            ticket.release()
            raise

    def _infer(self, model: ServedModel, images: np.ndarray, deadline: Deadline | None,
               priority: str) -> tuple[np.ndarray, str | None]:
        """(logits, the artifact hash of the version that served them, None
        if a reload split the request between two).  A request that
        resolved a version a reload has since closed is served by the new
        one."""
        engines: list = []
        try:
            logits = model.predict(images, deadline, priority, engines=engines)
        except EngineClosed:
            fresh = self.models.get(model.name)
            if fresh is None or fresh is model:
                raise
            engines.clear()
            logits = fresh.predict(images, deadline, priority, engines=engines)
        hashes = {getattr(e, "artifact_hash", None) for e in engines}
        return logits, hashes.pop() if len(hashes) == 1 else None

    def _predict(self, model: ServedModel, body, content_type: str,
                 deadline: Deadline | None, priority: str, ticket: Ticket) -> Reply:
        try:
            images = protocol.decode_predict_request(body() if callable(body) else body,
                                                     content_type)
            logits, digest = self._infer(model, images, deadline, priority)
        except ValueError as e:  # malformed request
            return _error(400, str(e))
        except (QueueFull, FuturesTimeout) as e:  # transient overload
            # An admitted request still missed its budget or found the
            # batcher full: the AIMD limit is too high for the service time.
            ticket.mark_overloaded()
            return _error(503, f"overloaded: {e or 'timed out'}",
                          protocol.retry_after_headers(self.admission.retry_after_s()))
        except DispatchStall as e:
            # Retryable for the client (another replica serves it), terminal
            # for this process: the header tells the gateway to take the
            # replica out of its pool now, not after repeated failures.
            return _error(503, f"dispatch stalled: {e}", {
                **protocol.retry_after_headers(protocol.STALL_RETRY_AFTER_S),
                protocol.STALLED_HEADER: "1",
            })
        out, ctype = protocol.encode_predict_response(logits, model.engine.spec.labels,
                                                      content_type)
        # The served artifact's identity rides every success: the gateway's
        # response cache drops a model's entries when it changes.
        return 200, out, ctype, {protocol.ARTIFACT_HASH_HEADER: digest} if digest else {}

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
                       headers: dict[str, str]) -> None:
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
                self._reply(*server.handle_get(self.path.split("?", 1)[0]))

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

            def do_POST(self):  # noqa: N802 - http.server API
                self._body_read = False
                ticket = None
                try:
                    reply, ticket = server.serve_predict(
                        self.path.split("?", 1)[0], self._read_body,
                        self.headers.get("Content-Type", ""), self.headers)
                except Exception as e:  # noqa: BLE001 - a request must get an answer
                    log.exception("predict failed")
                    reply = _error(500, str(e))
                try:
                    if not self._body_read:  # a reply made before the body was read
                        self._discard_body()
                    self._reply(*reply)
                except ConnectionError:  # the client hung up (gave up waiting)
                    self.close_connection = True
                finally:
                    if ticket is not None:  # after the reply: drain waits for it
                        ticket.release()

            def log_message(self, fmt, *args):
                log.debug(fmt, *args)

        return Handler


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
    )


def build_server(argv: Sequence[str] | None = None) -> ModelServer:
    """The server the command line describes (not started, not warmed, no
    version watcher)."""
    return _server_from_args(_parser().parse_args(argv))


def main(argv: Sequence[str] | None = None) -> None:
    logging.basicConfig(level=logging.INFO)
    args = _parser().parse_args(argv)
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
    try:
        # A signal handler runs only when the main thread executes bytecode,
        # and the kernel may deliver SIGTERM to any thread (the CUDA runtime
        # starts several): a main thread blocked in an untimed wait would
        # never run it.  Waking twice a second lets it run.
        while not stopped.wait(0.5):
            pass
    except KeyboardInterrupt:
        stop()


if __name__ == "__main__":
    main()
