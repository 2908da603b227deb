"""Model server: the TF-Serving-shaped HTTP front of the port's engines.

A threaded ``http.server`` over one ``InferenceEngine`` per model found
under ``<model_root>/<name>/<version>/`` (the highest version wins, as in
TF-Serving).  Routes:

- ``GET /v1/models``: the served models, versions and readiness;
- ``GET /v1/models/<name>``: the model's ``spec.json`` (what a gateway
  reads to discover the contract; no ingest capability is advertised, so a
  gateway keeps the tensor wire);
- ``POST /v1/models/<name>:predict``: msgpack or JSON (``serving.protocol``);
  a batch larger than the largest bucket is served in max-bucket chunks;
- ``GET /healthz`` (the process is up) and ``GET /readyz`` (every engine
  has warmed).

Run it with ``kdlt-torch-model-server --model-root DIR --device cuda``.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import signal
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Sequence

import numpy as np

from kubernetes_deep_learning_tpu_torch.export import artifact as art
from kubernetes_deep_learning_tpu_torch.runtime.engine import DEFAULT_BUCKETS, InferenceEngine
from kubernetes_deep_learning_tpu_torch.serving import protocol

log = logging.getLogger(__name__)

_PREFIX = "/v1/models"


class ModelServer:
    def __init__(self, model_root: str, port: int = 8500, host: str = "127.0.0.1",
                 buckets: Sequence[int] = DEFAULT_BUCKETS, device: str = "cuda"):
        self.engines: dict[str, InferenceEngine] = {}
        self.versions: dict[str, int] = {}
        for name in sorted(os.listdir(model_root)):
            version = art.latest_version(model_root, name)
            if version is None:
                continue
            artifact = art.load_artifact(art.version_dir(model_root, name, version))
            self.engines[artifact.spec.name] = InferenceEngine(
                artifact, buckets=buckets, device=device
            )
            self.versions[artifact.spec.name] = version
        if not self.engines:
            raise ValueError(f"no model versions found under {model_root!r}")
        self._httpd = ThreadingHTTPServer((host, port), self._handler_class())
        self._httpd.daemon_threads = True
        self._thread: threading.Thread | None = None

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    @property
    def ready(self) -> bool:
        return all(e.ready for e in self.engines.values())

    def warmup(self) -> None:
        for name, engine in self.engines.items():
            log.info("warmed %s in %.2f s", name, engine.warmup())

    def start(self) -> None:
        self._thread = threading.Thread(target=self._httpd.serve_forever, daemon=True)
        self._thread.start()

    def shutdown(self) -> None:
        if self._thread is not None:  # shutdown() waits for a loop that must be running
            self._httpd.shutdown()
            self._thread.join(timeout=10)
        self._httpd.server_close()

    # --- request handling ----------------------------------------------------

    def handle_get(self, path: str) -> tuple[int, bytes, str]:
        if path == "/healthz":
            return 200, b"ok", "text/plain"
        if path == "/readyz":
            return (200, b"ready", "text/plain") if self.ready else (503, b"warming", "text/plain")
        if path == _PREFIX:
            models = [
                {"name": n, "version": self.versions[n], "ready": e.ready}
                for n, e in self.engines.items()
            ]
            return 200, json.dumps({"models": models}).encode(), protocol.JSON_CONTENT_TYPE
        if path.startswith(_PREFIX + "/"):
            engine = self.engines.get(path[len(_PREFIX) + 1 :])
            if engine is not None:
                return 200, engine.spec.to_json().encode(), protocol.JSON_CONTENT_TYPE
        return 404, b"not found", "text/plain"

    def handle_predict(self, path: str, body: bytes, content_type: str) -> tuple[int, bytes, str]:
        if not (path.startswith(_PREFIX + "/") and path.endswith(":predict")):
            return 404, b"not found", "text/plain"
        engine = self.engines.get(path[len(_PREFIX) + 1 : -len(":predict")])
        if engine is None:
            return 404, b"unknown model", "text/plain"
        if not engine.ready:
            return 503, b"model is warming up", "text/plain"
        try:
            images = protocol.decode_predict_request(body, content_type)
            logits = _predict_chunked(engine, images)
        except ValueError as e:
            return 400, str(e).encode(), "text/plain"
        out, ctype = protocol.encode_predict_response(logits, engine.spec.labels, content_type)
        return 200, out, ctype

    def _handler_class(self):
        server = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"
            # The reply goes out in two writes (headers, body); with Nagle on,
            # the second waits for the client's delayed ACK (~40 ms) on a
            # keep-alive connection.
            disable_nagle_algorithm = True

            def _reply(self, status: int, body: bytes, ctype: str) -> None:
                self.send_response(status)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
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
                    reply = (500, f"internal error: {e}".encode(), "text/plain")
                self._reply(*reply)

            def log_message(self, fmt, *args):
                log.debug(fmt, *args)

        return Handler


def _predict_chunked(engine: InferenceEngine, images: np.ndarray) -> np.ndarray:
    """``engine.predict``, with a batch past the largest bucket served in
    max-bucket chunks: a client's batch size need not know the buckets."""
    images = np.asarray(images)
    step = engine.max_batch
    if images.ndim == 0 or len(images) <= step:
        return engine.predict(images)
    return np.concatenate([engine.predict(images[i : i + step])
                           for i in range(0, len(images), step)])


def main(argv: Sequence[str] | None = None) -> None:
    p = argparse.ArgumentParser(description="PyTorch/CUDA model server (tensor wire)")
    p.add_argument("--model-root", required=True, help="directory of <name>/<version>/ artifacts")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8500)
    p.add_argument("--buckets", default=",".join(map(str, DEFAULT_BUCKETS)),
                   help="comma-separated batch buckets")
    p.add_argument("--device", default="cuda", help="torch device (cuda, cuda:1, cpu)")
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    server = ModelServer(
        args.model_root, port=args.port, host=args.host,
        buckets=[int(b) for b in args.buckets.split(",")], device=args.device,
    )
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
