"""Model server: the TF-Serving-shaped HTTP front of the port's engines.

A threaded ``http.server`` over one ``InferenceEngine`` per model found
under ``<model_root>/<name>/<version>/`` (the highest version wins, as in
TF-Serving), each behind a ``ServedModel``: a dynamic batcher that
coalesces concurrent one-image requests, and an in-flight dispatcher that
keeps up to ``pipeline_depth`` batches on the device.  Routes:

- ``GET /v1/models``: the served models, versions and readiness;
- ``GET /v1/models/<name>``: the model's ``spec.json`` (what a gateway
  reads to discover the contract; no ingest capability is advertised, so a
  gateway keeps the tensor wire);
- ``POST /v1/models/<name>:predict``: msgpack or JSON (``serving.protocol``);
  a single uint8 image goes through the batcher, a batch up to the largest
  bucket straight to the engine, and a larger one in max-bucket chunks
  through the dispatcher.  Errors answer as the JAX server does, with a
  JSON ``{"error": ...}`` body: 400 for a malformed request, 404, 500; 503
  "overloaded" with ``Retry-After: 0.050`` when the batcher's queue is
  full or a wait outlives its deadline; 503 with ``Retry-After: 1.000``
  and ``X-Kdlt-Stalled: 1`` once the dispatch watchdog has declared the
  pipeline stalled;
- ``GET /healthz`` (the process is up and its pipelines are not stalled),
  ``GET /readyz`` (every engine has warmed, nothing stalled) and
  ``GET /metrics`` (the registry's Prometheus text: engine, batcher and
  dispatch-pipeline series, labelled by model).

Run it with ``kdlt-torch-model-server --model-root DIR --device cuda``
(``--max-delay-ms``, ``--pipeline-depth``, ``--batcher``,
``--no-batching``).
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import signal
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
    InferenceEngine,
    InFlightDispatcher,
    resolve_pipeline_depth,
)
from kubernetes_deep_learning_tpu_torch.serving import protocol
from kubernetes_deep_learning_tpu_torch.utils import metrics as metrics_lib

log = logging.getLogger(__name__)

_PREFIX = "/v1/models"

# (status, body, content type, extra headers)
Reply = tuple[int, bytes, str, dict[str, str]]


def _json(status: int, obj, headers: dict[str, str] | None = None) -> Reply:
    return status, json.dumps(obj).encode(), protocol.JSON_CONTENT_TYPE, headers or {}


def _error(status: int, message: str, headers: dict[str, str] | None = None) -> Reply:
    """An error reply as the JAX server sends it: ``{"error": message}``."""
    return _json(status, {"error": message}, headers)


# How long a handler waits for its image's batch (the reference's 20 s
# gRPC deadline) and for a chunk of a large request.
BATCHER_TIMEOUT_S = 20.0
CHUNK_TIMEOUT_S = 120.0


class ServedModel:
    """One model's serving pipeline over its engine.

    ``dispatcher``: ONE in-flight dispatch pipeline, shared by the
    single-image batcher and the chunked multi-image path so both draw
    from the same bounded in-flight budget; None at depth 1 (serial).
    ``batcher``: the single-image batcher ``runtime.create_batcher`` picks
    for ``batcher_impl`` (the C++ queue or the Python one), None when
    batching is off.
    """

    def __init__(self, engine: InferenceEngine, max_delay_ms: float = 2.0,
                 use_batcher: bool = True, pipeline_depth: int | None = None,
                 batcher_impl: str = "auto"):
        self.engine = engine
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

    @property
    def stalled(self) -> bool:
        return self.dispatcher is not None and self.dispatcher.stalled

    def predict(self, images: np.ndarray) -> np.ndarray:
        # Single uint8 images go through the batcher to coalesce across
        # concurrent requests (the batcher is uint8-only so mixed dtypes
        # never end up in one np.stack).
        if (self.batcher is not None and images.ndim >= 1 and len(images) == 1
                and images.dtype == np.uint8):
            try:
                return self.batcher.predict(images[0], timeout=BATCHER_TIMEOUT_S)[None]
            except BatcherClosed:
                pass  # a shutdown race: the engine is still valid, serve directly
        step = self.engine.max_batch
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
                return np.concatenate([f.result(timeout=CHUNK_TIMEOUT_S) for f in futs])
            except DispatcherClosed:
                pass  # a shutdown race: fall through to the serial engine path
        return np.concatenate([self.engine.predict(c) for c in chunks])

    def close(self) -> None:
        """Drain and stop the batcher, then the dispatcher behind it."""
        if self.batcher is not None:
            self.batcher.close(drain=True)
        if self.dispatcher is not None:
            # After the batcher's dispatch thread exits, only in-flight
            # handler threads can race this close; they fall back to the
            # engine path on DispatcherClosed.
            self.dispatcher.close(drain=True)


class ModelServer:
    def __init__(self, model_root: str, port: int = 8500, host: str = "127.0.0.1",
                 buckets: Sequence[int] = DEFAULT_BUCKETS, device: str = "cuda",
                 max_delay_ms: float = 2.0, use_batcher: bool = True,
                 pipeline_depth: int | None = None, batcher_impl: str = "auto"):
        self.registry = metrics_lib.Registry()
        self.models: dict[str, ServedModel] = {}
        self.versions: dict[str, int] = {}
        for name in sorted(os.listdir(model_root)):
            version = art.latest_version(model_root, name)
            if version is None:
                continue
            artifact = art.load_artifact(art.version_dir(model_root, name, version))
            name = artifact.spec.name
            engine = InferenceEngine(
                artifact, buckets=buckets, device=device, pipeline_depth=pipeline_depth,
                registry=self.registry.with_labels(model=name),
            )
            self.versions[name] = version
            try:
                self.models[name] = ServedModel(engine, max_delay_ms, use_batcher,
                                                pipeline_depth, batcher_impl)
            except BaseException:
                self._close_models()  # a failed queue build stops the models made so far
                raise
        if not self.models:
            raise ValueError(f"no model versions found under {model_root!r}")
        try:
            self._httpd = ThreadingHTTPServer((host, port), self._handler_class())
        except OSError:
            self._close_models()
            raise
        self._httpd.daemon_threads = True
        self._thread: threading.Thread | None = None

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
        return any(m.stalled for m in self.models.values())

    def warmup(self) -> None:
        for name, engine in self.engines.items():
            log.info("warmed %s in %.2f s", name, engine.warmup())

    def start(self) -> None:
        self._thread = threading.Thread(target=self._httpd.serve_forever, daemon=True)
        self._thread.start()

    def _close_models(self) -> None:
        for model in self.models.values():
            model.close()

    def shutdown(self) -> None:
        """Drain the batchers, then the dispatchers, then stop HTTP."""
        self._close_models()
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
            if self.stalled:
                return 503, b"dispatch stalled", "text/plain", {}
            if not self.ready:
                return 503, b"warming", "text/plain", {}
            return 200, b"ready", "text/plain", {}
        if path == "/metrics":
            return 200, self.registry.render().encode(), protocol.METRICS_CONTENT_TYPE, {}
        if path == _PREFIX:
            models = [
                {"name": n, "version": self.versions[n], "ready": e.ready}
                for n, e in self.engines.items()
            ]
            return _json(200, {"models": models})
        if path.startswith(_PREFIX + "/"):
            name = path[len(_PREFIX) + 1 :]
            engine = self.engines.get(name)
            if engine is not None:
                return 200, engine.spec.to_json().encode(), protocol.JSON_CONTENT_TYPE, {}
            return _error(404, f"no model {name!r}")
        return _error(404, "not found")

    def handle_predict(self, path: str, body: bytes, content_type: str) -> Reply:
        if not (path.startswith(_PREFIX + "/") and path.endswith(":predict")):
            return _error(404, "not found")
        name = path[len(_PREFIX) + 1 : -len(":predict")]
        model = self.models.get(name)
        if model is None:
            return _error(404, f"no model {name!r}")
        if not model.engine.ready:
            return _error(503, "model is warming up")
        try:
            images = protocol.decode_predict_request(body, content_type)
            logits = model.predict(images)
        except ValueError as e:  # malformed request
            return _error(400, str(e))
        except (QueueFull, FuturesTimeout) as e:  # transient overload
            return _error(503, f"overloaded: {e or 'timed out'}",
                          protocol.retry_after_headers(protocol.OVERLOAD_RETRY_AFTER_S))
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
        return 200, out, ctype, {}

    def _handler_class(self):
        server = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"
            # The reply goes out in two writes (headers, body); with Nagle on,
            # the second waits for the client's delayed ACK (~40 ms) on a
            # keep-alive connection.
            disable_nagle_algorithm = True

            def _reply(self, status: int, body: bytes, ctype: str,
                       headers: dict[str, str]) -> None:
                self.send_response(status)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                for key, value in headers.items():
                    self.send_header(key, value)
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):  # noqa: N802 - http.server API
                self._reply(*server.handle_get(self.path.split("?", 1)[0]))

            def do_POST(self):  # noqa: N802 - http.server API
                body = self.rfile.read(int(self.headers.get("Content-Length") or 0))
                try:
                    reply = server.handle_predict(
                        self.path.split("?", 1)[0], body, self.headers.get("Content-Type", "")
                    )
                except Exception as e:  # noqa: BLE001 - a request must get an answer
                    log.exception("predict failed")
                    reply = _error(500, str(e))
                self._reply(*reply)

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
    return p


def build_server(argv: Sequence[str] | None = None) -> ModelServer:
    """The server the command line describes (not started, not warmed)."""
    args = _parser().parse_args(argv)
    return ModelServer(
        args.model_root, port=args.port, host=args.host,
        buckets=[int(b) for b in args.buckets.split(",")], device=args.device,
        max_delay_ms=args.max_delay_ms, use_batcher=not args.no_batching,
        pipeline_depth=args.pipeline_depth or None, batcher_impl=args.batcher,
    )


def main(argv: Sequence[str] | None = None) -> None:
    logging.basicConfig(level=logging.INFO)
    server = build_server(argv)
    server.start()  # /healthz answers while warming; /readyz waits for warmup
    server.warmup()
    log.info("serving %s on port %d", sorted(server.engines), server.port)
    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *_: stop.set())
    try:
        stop.wait()
    except KeyboardInterrupt:
        pass
    server.shutdown()


if __name__ == "__main__":
    main()
