"""The port's client, WSGI adapter and doctor on the CPU, against the JAX
package's.

- ``kdlt-torch-client`` (``http.client``) and the JAX ``kdlt-client``
  (``requests``) against the port's gateway (in front of the port's model
  server with a ``runtime.stub.StubEngine``, a 96-px spec with the clothing
  model's labels, images from a real local ``http.server``) print the same
  output; the ``render_*`` functions give the same text on the same
  payloads, and the ``fetch_*`` ones the same payloads;
- the retry budget on a 503 with ``Retry-After`` and on a reset
  connection: the same retries, stats and final errors as JAX's;
- ``--stream`` (the generative lane's client half) prints what the JAX
  client prints, from the port's gateway in front of a model server with
  the lane on;
- ``serving.wsgi`` under ``wsgiref``: the same reply as the threaded
  gateway, the health and metrics routes, an oversize body refused unread,
  ``/generate`` streamed as the threaded gateway streams it, and
  ``/generate/nope`` a 404;
- ``kdlt-torch-doctor``'s renders equal the JAX ``kdlt-doctor``'s for the
  same bundle and incident list.
"""

from __future__ import annotations

import io
import json
import os
import socket
import threading
import wsgiref.simple_server
from functools import partial
from http.server import BaseHTTPRequestHandler, SimpleHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest
import requests

import chip_smoke
from kubernetes_deep_learning_tpu.serving import client as jax_client
from kubernetes_deep_learning_tpu.serving import doctor as jax_doctor
from kubernetes_deep_learning_tpu.utils import trace as jax_trace
from kubernetes_deep_learning_tpu_torch.export import artifact as art
from kubernetes_deep_learning_tpu_torch.modelspec import CLOTHING_MODEL, ModelSpec
from kubernetes_deep_learning_tpu_torch.runtime.stub import StubEngine
from kubernetes_deep_learning_tpu_torch.serving import client, doctor
from kubernetes_deep_learning_tpu_torch.serving.gateway import Gateway
from kubernetes_deep_learning_tpu_torch.serving.model_server import ModelServer
from kubernetes_deep_learning_tpu_torch.serving.wsgi import GatewayWSGI
from kubernetes_deep_learning_tpu_torch.utils import trace
from torch_threads import one_torch_thread  # noqa: F401

SPEC = ModelSpec(name="client-stub", family="xception", input_shape=(96, 96, 3),
                 labels=CLOTHING_MODEL.labels, preprocessing="tf", resize_filter="nearest")


class _QuietFiles(SimpleHTTPRequestHandler):
    def log_message(self, *args):
        pass


def _serve(httpd) -> str:
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return f"http://127.0.0.1:{httpd.server_address[1]}"


@pytest.fixture(scope="module")
def stack(tmp_path_factory):
    """Images on a local http.server, the port's model server (stub engine)
    and the port's gateway in front of it."""
    d = tmp_path_factory.mktemp("images")
    rng = np.random.default_rng(0)
    for i in range(3):
        with open(d / f"img{i}.png", "wb") as f:
            f.write(chip_smoke._png_bytes(rng.integers(0, 256, (70 + i, 90, 3), np.uint8)))
    files = ThreadingHTTPServer(("127.0.0.1", 0), partial(_QuietFiles, directory=str(d)))
    image_base = _serve(files)
    root = tmp_path_factory.mktemp("models")
    art.save_artifact(art.version_dir(str(root), SPEC.name, 1), SPEC, {"params": {}}, {})
    server = ModelServer(str(root), port=0, buckets=(1, 2, 4), device="cpu", decode=True,
                         engine_factory=lambda a, **k: StubEngine(a, **k))
    server.start()
    server.warmup()
    gw = Gateway(serving_host=f"127.0.0.1:{server.port}", model=SPEC.name, port=0)
    gw.start()
    yield {"image": lambda i: f"{image_base}/img{i}.png",
           "gateway": f"http://127.0.0.1:{gw.port}", "gw": gw, "server": server}
    gw.shutdown()
    server.shutdown()
    files.shutdown()
    files.server_close()


@pytest.mark.parametrize("flags", [
    [], ["--model", SPEC.name], ["--deadline-ms", "5000", "--priority", "batch"],
    ["--cache-bust"], ["--retries", "0"]], ids=["plain", "model", "deadline", "bust", "noretry"])
def test_client_cli_prints_what_the_jax_client_prints(stack, capsys, flags):
    argv = ["--gateway", stack["gateway"], "--image-url", stack["image"](1), *flags]
    assert client.main(argv) == 0
    got = capsys.readouterr().out
    assert jax_client.main(argv) == 0
    want = capsys.readouterr().out
    assert got == want
    assert list(json.loads(got)) == list(SPEC.labels)


def test_predict_url_stats_equal_jax(stack):
    got, want = {}, {}
    a = client.predict_url(stack["gateway"], stack["image"](2), stats=got)
    b = jax_client.predict_url(stack["gateway"], stack["image"](2), stats=want)
    assert a == b
    assert {k: got[k] for k in ("retried_shed", "retried_connect")} == {
        k: want[k] for k in ("retried_shed", "retried_connect")} == {
        "retried_shed": 0, "retried_connect": 0}
    assert (got["cache"], want["cache"]) == ("miss", "hit")
    assert got["request_id"] and got["trace_summary"]


def test_fetches_and_renders_equal_jax(stack, capsys):
    base = stack["gateway"]
    stats: dict = {}
    client.predict_url(base, stack["image"](0), stats=stats)
    assert client.fetch_debug_index(base) == jax_client.fetch_debug_index(base)
    for fetch, render in (("fetch_pool", "render_pool"),
                          ("fetch_bucket_audit", "render_bucket_audit"),
                          ("fetch_debug_index", "render_debug_index"),
                          ("fetch_slo", "render_slo")):
        payload = getattr(client, fetch)(base)
        assert getattr(client, render)(payload) == getattr(jax_client, render)(payload)
    spans = client.fetch_trace(base, stats["request_id"])
    assert spans == jax_client.fetch_trace(base, stats["request_id"])
    assert trace.render_waterfall(spans) == jax_trace.render_waterfall(spans)
    # --slo prints the same table, and the decode lane's below it.
    assert client.main(["--gateway", base, "--slo"]) == 0
    got = capsys.readouterr().out
    assert got.startswith("SLO target") and "merged" in got
    assert "decode lane (per-token SLOs" in got


def test_stats_and_trace_modes_print_the_jax_tables(stack, capsys):
    """--stats and --trace: the JAX client's stderr, less its brownout
    table (the port's gateway has no /debug/brownout, ROADMAP A12b)."""
    argv = ["--gateway", stack["gateway"], "--image-url", stack["image"](0), "--stats",
            "--trace", "--cache-bust"]
    assert client.main(argv) == 0
    got = capsys.readouterr().err.splitlines()
    for head in ("stat ", "cache ", "retried_shed ", "retried_connect ", "request_id ",
                 "pool: ", "bucket audit", "debug index (gateway tier)", "trace "):
        assert any(ln.startswith(head) for ln in got), head
    assert not any("brownout" in ln or "failed" in ln for ln in got)


def test_stream_flag_prints_what_the_jax_client_prints(stack, capsys):
    """--stream and --max-new-tokens: the tokens on stdout as the JAX client
    prints them, the done event's numbers on stderr (its timings aside)."""
    argv = ["--gateway", stack["gateway"], "--stream", "a prompt", "--max-new-tokens", "4"]
    assert client.main(argv) == 0
    out, err = capsys.readouterr()
    assert jax_client.main(argv) == 0
    want_out, want_err = capsys.readouterr()
    assert out == want_out and out.endswith("\n")
    assert err.startswith("# ") and "finish=" in err and "request_id=" in err
    assert err.split(" ttft")[0] == want_err.split(" ttft")[0]  # "# N tokens,"


# --- the retry budget --------------------------------------------------------------


class _Scripted(BaseHTTPRequestHandler):
    """Answers POSTs from a script: "503" (with the script's Retry-After),
    "reset" (closes the connection unanswered) or "ok"."""

    protocol_version = "HTTP/1.1"
    script: list = []
    retry_after = "0.01"

    def log_message(self, *args):
        pass

    def do_POST(self):
        self.rfile.read(int(self.headers.get("Content-Length", 0)))
        step = type(self).script.pop(0) if type(self).script else "ok"
        if step == "reset":
            self.connection.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER,
                                       b"\x01\x00\x00\x00\x00\x00\x00\x00")
            self.close_connection = True
            return
        body = b'{"a": 1.5}' if step == "ok" else b'{"error": "overloaded"}'
        self.send_response(200 if step == "ok" else 503)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        if step == "503":
            self.send_header("Retry-After", type(self).retry_after)
        self.end_headers()
        self.wfile.write(body)


@pytest.fixture
def scripted():
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), _Scripted)
    yield _serve(httpd)
    httpd.shutdown()
    httpd.server_close()


def _outcome(fn, url, script, **kw):
    _Scripted.script = list(script)
    stats: dict = {}
    try:
        return fn(url, "http://x/img.png", stats=stats, **kw), stats
    except Exception as e:  # noqa: BLE001 - the outcome is the exception's kind
        status = getattr(e, "status", None) or getattr(getattr(e, "response", None),
                                                       "status_code", None)
        return ("raised", status), stats


@pytest.mark.parametrize("script,kw,want", [
    (["503", "503"], {}, ({"a": 1.5}, 2, 0)),
    (["reset"], {}, ({"a": 1.5}, 0, 1)),
    (["503", "reset"], {}, ({"a": 1.5}, 1, 1)),
    (["503", "503", "503"], {}, (("raised", 503), 2, 0)),
    (["503"], {"retries": 0}, (("raised", 503), 0, 0)),
    (["reset", "reset", "reset"], {}, (("raised", None), 0, 2)),
], ids=["shed-twice", "reset", "shed-reset", "shed-exhausted", "no-retries", "reset-exhausted"])
def test_retry_budget_matches_jax(scripted, script, kw, want):
    for fn in (client.predict_url, jax_client.predict_url):
        result, stats = _outcome(fn, scripted, script, **kw)
        assert (result, stats["retried_shed"], stats["retried_connect"]) == want, fn.__module__


def test_retry_after_past_the_deadline_surfaces_the_503(scripted):
    """A Retry-After (capped at 5 s) that would outlive the client's own
    timeout budget is not slept: the 503 surfaces at once."""
    _Scripted.retry_after = "30"
    try:
        for fn in (client.predict_url, jax_client.predict_url):
            result, stats = _outcome(fn, scripted, ["503", "503"], timeout=1.0)
            assert result == ("raised", 503) and stats["retried_shed"] == 0
    finally:
        _Scripted.retry_after = "0.01"


def test_http_errors_carry_their_status(scripted):
    with pytest.raises(client.HTTPError) as info:
        _Scripted.script = ["503"]
        client.predict_url(scripted, "http://x/img.png", retries=0)
    assert info.value.status == 503 and b"overloaded" in info.value.body


# --- the WSGI adapter --------------------------------------------------------------


class _QuietWSGI(wsgiref.simple_server.WSGIRequestHandler):
    def log_message(self, *args):
        pass


@pytest.fixture(scope="module")
def wsgi(stack):
    app = GatewayWSGI(Gateway(serving_host=f"127.0.0.1:{stack['server'].port}",
                              model=SPEC.name, bind=False))
    httpd = wsgiref.simple_server.make_server("127.0.0.1", 0, app, handler_class=_QuietWSGI)
    yield _serve(httpd)
    httpd.shutdown()
    httpd.server_close()
    app.gateway.shutdown()


def test_wsgi_reply_equals_the_threaded_gateways(stack, wsgi):
    body = json.dumps({"url": stack["image"](1)}).encode()
    got = client.request("POST", f"{wsgi}/predict", body, {"Content-Type": "application/json"})
    want = client.request("POST", f"{stack['gateway']}/predict/{SPEC.name}", body,
                          {"Content-Type": "application/json"})
    assert (got.status_code, got.content) == (want.status_code, want.content) and \
        got.status_code == 200
    assert got.headers.get("X-Request-Id") and got.headers.get("X-Kdlt-Trace")
    assert client.predict_url(wsgi, stack["image"](1), model=SPEC.name) == json.loads(want.content)


def test_wsgi_routes(wsgi):
    health = client.request("GET", f"{wsgi}/healthz")
    assert (health.status_code, health.content) == (200, b"ok")
    metrics = client.request("GET", f"{wsgi}/metrics")
    assert metrics.status_code == 200 and b"kdlt_gateway_requests_total" in metrics.content
    for method, path, code, needle in (("POST", "/generate/nope", 404, b"no generative model"),
                                       ("POST", "/generate/bad%20name!", 404, b"malformed"),
                                       ("POST", "/generate", 400, b"prompt"),
                                       ("POST", "/predict/bad%20name!", 404, b"malformed"),
                                       ("POST", "/nowhere", 404, b"not found"),
                                       ("PUT", "/predict", 404, b"not found")):
        r = client.request(method, f"{wsgi}{path}", b"{}", {"Content-Type": "application/json"})
        assert (r.status_code, needle in r.content) == (code, True), path


def test_wsgi_streams_generate_as_the_threaded_gateway(stack, wsgi):
    """A streamed 200 through the WSGI adapter: the same events as the
    threaded gateway's, and the JSON answer's text."""
    streams = []
    for base in (wsgi, stack["gateway"]):
        events = list(client.generate_stream(base, "wsgi", max_new_tokens=5))
        assert events[-1]["done"] and events[-1]["tokens"] == 5
        streams.append([{k: v for k, v in e.items() if k not in ("ttft_ms", "tpot_ms")}
                        for e in events])
    assert streams[0] == streams[1]
    r = client.request("POST", f"{wsgi}/generate",
                       json.dumps({"prompt": "wsgi", "max_new_tokens": 5, "stream": False}).encode(),
                       {"Content-Type": "application/json"})
    assert r.status_code == 200 and r.json()["text"] == streams[0][-1]["text"]


def test_wsgi_refuses_an_oversize_body_unread(stack):
    """The 413 comes from the declared length: the body is never read."""
    app = GatewayWSGI(Gateway(serving_host=f"127.0.0.1:{stack['server'].port}",
                              model=SPEC.name, bind=False))

    class Unreadable(io.RawIOBase):
        def read(self, *args):
            raise AssertionError("the body was read")

    seen = {}
    try:
        out = app({"REQUEST_METHOD": "POST", "PATH_INFO": "/predict",
                   "CONTENT_LENGTH": str(1 << 30), "wsgi.input": Unreadable()},
                  lambda status, headers: seen.update(status=status, headers=dict(headers)))
    finally:
        app.gateway.shutdown()
    assert seen["status"] == "413 Request Entity Too Large"
    assert b"exceeds" in b"".join(out)


# --- the doctor --------------------------------------------------------------------


def _bundle(spans: list[dict]) -> dict:
    rid = spans[0]["trace_id"]
    event = {"m": 12.5, "kind": "dispatch.stall", "tier": "model-server", "rid": rid,
             "attrs": {"model": SPEC.name, "stalled_s": 31.0}}
    return {
        "id": "inc-20260101T000000Z-dispatch-stall", "tier": "model-server",
        "trigger": "dispatch-stall", "fired_at_s": 1_767_225_600.0,
        "captured_at_s": 1_767_225_600.4, "capture_latency_s": 0.4, "event": event,
        "events": [{"m": 10.0, "kind": "shed", "tier": "gateway", "attrs": {"reason": "x"}},
                   event, {"m": 13.0, "kind": "breaker.open", "tier": "gateway",
                           "rid": "other", "attrs": {}}],
        "traces": {rid: {"retention_class": "error", "spans": spans},
                   "other": {"retention_class": "slow", "spans": []}},
        "snapshots": {"metrics": {}, "pool": {}},
        "metrics_delta": {f"series_{i}": (-1) ** i * i * 0.5 for i in range(25)},
        "profile": {"dir": "/tmp/x", "top": {"k": 1}},
    }


def test_doctor_renders_equal_jax(stack, tmp_path, capsys):
    stats: dict = {}
    client.predict_url(stack["gateway"], stack["image"](0), stats=stats, cache_bust="d")
    spans = client.fetch_trace(stack["gateway"], stats["request_id"])
    bundle = _bundle(spans)
    assert doctor.render_bundle(bundle) == jax_doctor.render_bundle(bundle)
    listing = {"incidents": [{k: bundle[k] for k in ("id", "trigger", "tier", "fired_at_s",
                                                     "capture_latency_s")} | {"events": 3}],
               "replicas": {"127.0.0.1:1": {"error": "unreachable"},
                            "127.0.0.1:2": [{"id": "inc-b", "trigger": "shed-storm",
                                             "tier": "model-server", "fired_at_s": 5.0,
                                             "events": 1}]},
               "windows": [{"start_s": 1.0, "end_s": 4.5, "triggers": ["dispatch-stall"],
                            "incidents": [{"id": "inc-b", "origin": "127.0.0.1:2"}]}]}
    assert doctor.render_list(listing) == jax_doctor.render_list(listing)
    assert doctor.render_list({}) == jax_doctor.render_list({}) == "no incident bundles captured"
    path = tmp_path / "bundle.json"
    path.write_text(json.dumps(bundle))
    for argv in (["--file", str(path)], ["--file", str(path), "--json"],
                 ["--gateway", stack["gateway"]]):
        assert doctor.main(argv) == 0
        got = capsys.readouterr().out
        assert jax_doctor.main(argv) == 0
        assert got == capsys.readouterr().out, argv


def test_doctor_reports_an_unreachable_gateway(capsys):
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    assert doctor.main(["--gateway", f"http://127.0.0.1:{port}"]) == 1
    assert capsys.readouterr().err.startswith("kdlt-torch-doctor: ")


def test_client_needs_no_requests():
    """The port's client and doctor speak http.client: no requests import."""
    import subprocess
    import sys

    code = ("import sys; import kubernetes_deep_learning_tpu_torch.serving.client, "
            "kubernetes_deep_learning_tpu_torch.serving.doctor, "
            "kubernetes_deep_learning_tpu_torch.serving.wsgi; "
            "assert 'requests' not in sys.modules")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    subprocess.run([sys.executable, "-c", code], check=True, cwd=repo, timeout=120)
    assert requests  # the JAX client's transport, here for the comparisons only
