"""WSGI adapter: the port's gateway under gunicorn (reference parity; the
port of ``serving/wsgi.py``).

The reference's production arrangement is gunicorn driving a WSGI app
(reference gateway.dockerfile:16, ``gunicorn model_server:app``).  The
port's default is its threaded stdlib server (``kdlt-torch-gateway``), but
operators who want gunicorn's pre-fork process model -- worker recycling,
graceful reloads, the exact reference posture -- get it via this module:

    gunicorn 'kubernetes_deep_learning_tpu_torch.serving.wsgi:app'

Configuration comes from the same env vars as the CLI (KDLT_SERVING_HOST,
KDLT_MODEL); each gunicorn worker process builds its own Gateway (own
upstream connection pool), mirroring the reference's per-worker module
globals (reference model_server.py:13-18).  Routing, error mapping, and
metrics live on Gateway.handle_get/handle_predict -- this module is pure
transport translation, so the two server postures cannot diverge.
``/generate`` streams: a 200 token stream is the gateway's iterator of SSE
chunks, returned as the WSGI iterable with no Content-Length, so the
server writes each chunk as it comes (gunicorn flushes a yielded chunk).
"""

from __future__ import annotations

import http.client
import threading
from typing import Callable, Iterable

from kubernetes_deep_learning_tpu_torch.serving.gateway import Gateway


def _status_line(code: int) -> str:
    return f"{code} {http.client.responses.get(code, 'Error')}"


class GatewayWSGI:
    """WSGI callable exposing the gateway's routes."""

    def __init__(self, gateway: Gateway | None = None):
        self.gateway = gateway or Gateway(bind=False)

    def __call__(self, environ: dict, start_response: Callable) -> Iterable[bytes]:
        from kubernetes_deep_learning_tpu_torch.serving.admission import (
            WSGI_DEADLINE_KEY,
            Deadline,
        )
        from kubernetes_deep_learning_tpu_torch.serving.cache import WSGI_CACHE_BUST_KEY
        from kubernetes_deep_learning_tpu_torch.serving.gateway import (
            _MODEL_NAME_RE,
            WSGI_MODEL_KEY,
            WSGI_PRIORITY_KEY,
        )
        from kubernetes_deep_learning_tpu_torch.serving.tracing import (
            REQUEST_ID_HEADER,
            TRACE_HEADER,
            ensure_request_id,
        )

        method = environ.get("REQUEST_METHOD", "GET")
        path = environ.get("PATH_INFO", "/")
        rid = ensure_request_id(environ.get("HTTP_X_REQUEST_ID"))
        extra: dict[str, str] = {}
        if method == "GET":
            code, body, ctype = self.gateway.handle_get(path)
        elif method == "POST" and (path == "/generate" or path.startswith("/generate/")):
            model = path[len("/generate/"):] if path.startswith("/generate/") else None
            length = int(environ.get("CONTENT_LENGTH") or 0)
            rejected = self.gateway.reject_oversize(length)
            if model is not None and not _MODEL_NAME_RE.match(model):
                code, body, ctype = (
                    404, b'{"error": "malformed model name"}', "application/json"
                )
            elif rejected is not None:
                code, body, ctype = rejected
            else:
                deadline = (
                    Deadline.from_header(environ.get(WSGI_DEADLINE_KEY))
                    if self.gateway.admission.enabled
                    else None
                )
                code, body, ctype, extra = self.gateway.handle_generate(
                    environ["wsgi.input"].read(length), rid, deadline, model=model,
                    priority=environ.get(WSGI_PRIORITY_KEY),
                )
                if not isinstance(body, (bytes, bytearray)):
                    # A token stream: no Content-Length, one chunk at a time.
                    start_response(_status_line(code), [
                        ("Content-Type", ctype), (REQUEST_ID_HEADER, rid), *extra.items()])
                    return body
        elif method == "POST" and (path == "/predict" or path.startswith("/predict/")):
            # Same model routing as the threaded transport: path segment
            # first, X-Kdlt-Model header second, default model otherwise.
            model = self.gateway.resolve_model(path, environ.get(WSGI_MODEL_KEY))
            length = int(environ.get("CONTENT_LENGTH") or 0)
            rejected = self.gateway.reject_oversize(length)
            if model is None:
                code, body, ctype = (
                    404, b'{"error": "malformed model name"}', "application/json"
                )
            elif rejected is not None:
                code, body, ctype = rejected  # body stays unread; gunicorn
                # discards the connection on its own
            else:
                deadline = (
                    Deadline.from_header(environ.get(WSGI_DEADLINE_KEY))
                    if self.gateway.admission.enabled
                    else None
                )
                code, body, ctype, extra = self.gateway.handle_predict(
                    environ["wsgi.input"].read(length), rid, deadline,
                    model=model,
                    cache_bust=environ.get(WSGI_CACHE_BUST_KEY),
                    priority=environ.get(WSGI_PRIORITY_KEY),
                )
                # Same span-summary header as the threaded transport.
                summary = self.gateway.tracer.summary(rid)
                if summary:
                    extra = {**extra, TRACE_HEADER: summary}
        else:
            code, body, ctype = 404, b'{"error": "not found"}', "application/json"
        start_response(
            _status_line(code),
            [
                ("Content-Type", ctype),
                ("Content-Length", str(len(body))),
                (REQUEST_ID_HEADER, rid),
                *extra.items(),
            ],
        )
        return [body]


# The module-level app gunicorn imports; built lazily (so importing this
# module does not yet require the model tier) and under a lock (threaded
# workers could otherwise race two Gateways into existence on first load,
# splitting the metrics registry).
_app_instance: GatewayWSGI | None = None
_app_lock = threading.Lock()


def app(environ, start_response):
    global _app_instance
    if _app_instance is None:
        with _app_lock:
            if _app_instance is None:
                _app_instance = GatewayWSGI()
    return _app_instance(environ, start_response)
