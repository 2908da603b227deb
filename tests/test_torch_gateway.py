"""The port's gateway on the CPU, against the JAX package's.

- The port's ``serving.gateway.Gateway`` in front of the port's model server
  (a ``runtime.stub.StubEngine`` standing in for the device, a 96-px spec
  with the clothing model's 10 labels) answers ``POST /predict {"url"}``
  with the reference's ``{label: score}``: each image's stub logits for the
  pixels PIL decodes and resizes;
- its reply is byte-identical to the unchanged JAX gateway's in front of
  the same server, on the bytes wire and on the tensor wire, and the two
  wires give the same reply (each wire the one asked for);
- a progressive JPEG is answered on both wires with the logits of the
  pixels PIL decodes; an unsupported image (an arithmetic-coded JPEG, a
  GIF), or one over PIL's pixel limit, is a 400 naming what is refused, on
  both wires;
- the response cache: miss, hit (the same body, no upstream call), a
  cache-bust salt, and concurrent identical requests coalesced onto one
  upstream call;
- the circuit breaker opens on a failing tier and recovers, with the JAX
  gateway's statuses and bodies; upstream batching coalesces concurrent
  requests; the deadline, request id and priority headers are forwarded;
- its error replies equal the JAX gateway's in status, JSON body and
  ``Retry-After``;
- the full 299-px ``clothing-model`` (seeded weights, carried into the port
  by ``weights.py``): the port gateway's reply equals the JAX gateway's in
  front of the same port server, lies within the fused path's 2e-2 of the
  JAX gateway and JAX server with the same weights (same top-1), and the
  tensor wire equals the bytes wire;
- ``/generate`` and ``/generate/<model>`` relay a model server's token
  stream (the lane on, ``decode=True``) with the JAX gateway's events, and
  its JSON answers and refusals with the JAX gateway's statuses and bodies;
- ``/debug/profile`` on the port's server holds ``capture_lock`` only while
  the profiler starts and stops, not for its window, and other requests
  complete meanwhile (ROADMAP C5).

Images come from a real local ``http.server`` on 127.0.0.1, never from a
patched fetch function.
"""

from __future__ import annotations

import io
import json
import os
import struct
import threading
import time
import urllib.error
import urllib.request
import zlib
from functools import partial
from http.server import BaseHTTPRequestHandler, HTTPServer, SimpleHTTPRequestHandler
from http.server import ThreadingHTTPServer

import numpy as np
import pytest
from PIL import Image

from kubernetes_deep_learning_tpu.ops import preprocess as jax_preprocess
from kubernetes_deep_learning_tpu.serving.gateway import Gateway as JaxGateway
from kubernetes_deep_learning_tpu_torch.export import artifact as art
from kubernetes_deep_learning_tpu_torch.modelspec import CLOTHING_MODEL, ModelSpec
from kubernetes_deep_learning_tpu_torch.runtime.stub import StubEngine, stub_logits
from kubernetes_deep_learning_tpu_torch.serving import protocol
from kubernetes_deep_learning_tpu_torch.serving.gateway import Gateway
from kubernetes_deep_learning_tpu_torch.serving.model_server import ModelServer
from torch_threads import one_torch_thread  # noqa: F401

SPEC = ModelSpec(name="gw-stub", family="xception", input_shape=(96, 96, 3),
                 labels=CLOTHING_MODEL.labels, preprocessing="tf", resize_filter="nearest")
GOOD = ("pants.png", "photo.jpg", "grey.jpg")


def _smooth(h: int, w: int, seed: int) -> np.ndarray:
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([x * 255 // (w - 1), y * 255 // (h - 1), (x + y) * 5 % 256], -1)
    noise = np.random.default_rng(seed).integers(-20, 20, (h, w, 3))
    return np.clip(base + noise, 0, 255).astype(np.uint8)


def _save(directory, name: str, im: Image.Image, **kw) -> None:
    im.save(os.path.join(directory, name), **kw)


@pytest.fixture(scope="module")
def images(tmp_path_factory):
    """A local image host: name -> URL, and the directory."""
    d = tmp_path_factory.mktemp("images")
    rng = np.random.default_rng(0)
    _save(d, "pants.png", Image.fromarray(rng.integers(0, 256, (120, 80, 3), dtype=np.uint8)))
    _save(d, "photo.jpg", Image.fromarray(_smooth(150, 203, 1)), quality=90, subsampling=2)
    _save(d, "grey.jpg", Image.fromarray(_smooth(77, 61, 2)).convert("L"), quality=80)
    _save(d, "prog.jpg", Image.fromarray(_smooth(64, 64, 3)), progressive=True)
    _save(d, "anim.gif", Image.fromarray(_smooth(16, 16, 4)))
    for i in range(6):
        _save(d, f"many{i}.png", Image.fromarray(_smooth(50 + i, 70, 10 + i)))
    # Headers claiming 65535 x 65535 pixels, over PIL's decompression-bomb bound.
    jpeg = bytearray(open(os.path.join(d, "photo.jpg"), "rb").read())
    sof = jpeg.index(b"\xff\xc0")
    jpeg[sof + 5:sof + 9] = struct.pack(">HH", 65535, 65535)
    png = bytearray(open(os.path.join(d, "pants.png"), "rb").read())
    png[16:24] = struct.pack(">II", 65535, 65535)
    png[29:33] = struct.pack(">I", zlib.crc32(bytes(png[12:29])))
    # The same photo marked arithmetic-coded (SOF9), which stays refused.
    arith = bytearray(open(os.path.join(d, "photo.jpg"), "rb").read())
    arith[arith.index(b"\xff\xc0") + 1] = 0xC9
    for name, data in (("bomb.jpg", jpeg), ("bomb.png", png), ("arith.jpg", arith)):
        with open(os.path.join(d, name), "wb") as f:
            f.write(data)
    httpd = ThreadingHTTPServer(("127.0.0.1", 0),
                                partial(_QuietFiles, directory=str(d)))
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    yield (lambda name: f"{base}/{name}"), d
    httpd.shutdown()
    httpd.server_close()


class _QuietFiles(SimpleHTTPRequestHandler):
    def log_message(self, *args):
        pass


def _stub_server(root, device_ms: float = 0.0, **kw) -> ModelServer:
    art.save_artifact(art.version_dir(str(root), SPEC.name, 1), SPEC, {"params": {}}, {})
    server = ModelServer(str(root), port=0, buckets=(1, 2, 4), device="cpu",
                         engine_factory=lambda a, **k: StubEngine(
                             a, device_ms_per_batch=device_ms, **k), **kw)
    server.start()
    server.warmup()
    return server


@pytest.fixture(scope="module")
def tier(tmp_path_factory):
    server = _stub_server(tmp_path_factory.mktemp("models"))
    yield server
    server.shutdown()


def _gateway(cls, serving_port: int, **kw):
    gw = cls(serving_host=f"127.0.0.1:{serving_port}", model=kw.pop("model", SPEC.name), port=0,
             **kw)
    gw.start()
    return gw


def _post(port: int, body, headers: dict | None = None, path: str = "/predict"):
    data = body if isinstance(body, bytes) else json.dumps(body).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data, method="POST",
                                 headers={"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, r.read(), r.headers
    except urllib.error.HTTPError as e:
        return e.code, e.read(), e.headers


def _want(images, name: str, spec=SPEC) -> dict:
    with open(os.path.join(images[1], name), "rb") as f:
        pixels = jax_preprocess.preprocess_bytes(f.read(), spec.input_shape[:2],
                                                 filter=spec.resize_filter)
    return dict(zip(spec.labels, map(float, stub_logits(pixels[None], spec.num_classes)[0])))


# --- the slice's path, with the stub engine ------------------------------------------


def test_served_model_builds_its_engine_from_a_factory(tmp_path):
    """The stub engine in ``ServedModel``: it serves each image's stub
    logits through the private batcher (a stub without ``predict_async``
    takes no scheduler lane, as in JAX)."""
    from kubernetes_deep_learning_tpu_torch.runtime.scheduler import UnifiedScheduler
    from kubernetes_deep_learning_tpu_torch.serving.model_server import ServedModel

    art.save_artifact(str(tmp_path / "1"), SPEC, {"params": {}}, {})
    scheduler = UnifiedScheduler()
    artifact = art.load_artifact(str(tmp_path / "1"))
    model = ServedModel(StubEngine(artifact, buckets=(1, 2), device="cpu"), max_delay_ms=1.0,
                        artifact=artifact, pipeline_depth=1, batcher_impl="python",
                        scheduler=scheduler)
    try:
        assert isinstance(model.engine, StubEngine) and model._scheduler is None
        model.engine.warmup()
        imgs = np.random.default_rng(0).integers(0, 256, (3, *SPEC.input_shape), dtype=np.uint8)
        np.testing.assert_array_equal(model.predict(imgs), stub_logits(imgs, SPEC.num_classes))
        np.testing.assert_array_equal(model.predict(imgs[:1]), stub_logits(imgs[:1], 10))
    finally:
        model.close()
        scheduler.close()


@pytest.mark.parametrize("name", GOOD)
def test_port_gateway_answers_the_reference_schema(tier, images, name):
    gw = _gateway(Gateway, tier.port)
    try:
        status, body, headers = _post(gw.port, {"url": images[0](name)})
        assert status == 200 and headers["X-Kdlt-Cache"] == "miss"
        scores = json.loads(body)
        assert list(scores) == list(CLOTHING_MODEL.labels) and len(scores) == 10
        assert scores == _want(images, name)
    finally:
        gw.shutdown()


@pytest.mark.parametrize("ingest", [True, False], ids=["bytes-wire", "tensor-wire"])
def test_port_gateway_reply_is_identical_to_the_jax_gateways(tier, images, ingest):
    gws = [_gateway(Gateway, tier.port, ingest=ingest),
           _gateway(JaxGateway, tier.port, ingest=ingest)]
    try:
        for name in GOOD:
            (s1, b1, _), (s2, b2, _) = (_post(gw.port, {"url": images[0](name)}) for gw in gws)
            assert s1 == s2 == 200 and b1 == b2, (name, b1, b2)
            urls = {"urls": [images[0](n) for n in (*GOOD, "nope.png")]}
            (s1, b1, _), (s2, b2, _) = (_post(gw.port, urls) for gw in gws)
            assert s1 == s2 == 200 and b1 == b2
        for gw in gws:
            assert gw._m_ingest["bytes_requests"].value == (6 if ingest else 0)
    finally:
        for gw in gws:
            gw.shutdown()


def test_tensor_wire_equals_bytes_wire(tier, images):
    decoded = tier._m_ingest["decoded_images"].value
    gws = {wire: _gateway(Gateway, tier.port, ingest=wire == "bytes")
           for wire in ("bytes", "tensor")}
    try:
        for name in GOOD:
            bodies = {w: _post(gw.port, {"url": images[0](name)})[1] for w, gw in gws.items()}
            assert bodies["bytes"] == bodies["tensor"]
        assert gws["bytes"]._m_ingest["bytes_requests"].value == len(GOOD)
        assert gws["tensor"]._m_ingest["bytes_requests"].value == 0
        assert tier._m_ingest["decoded_images"].value == decoded + len(GOOD)
    finally:
        for gw in gws.values():
            gw.shutdown()


@pytest.mark.parametrize("ingest", [True, False], ids=["bytes-wire", "tensor-wire"])
@pytest.mark.parametrize("name, match", [("arith.jpg", "arithmetic"),
                                         ("anim.gif", "only JPEG and PNG"),
                                         ("bomb.jpg", "image too large"),
                                         ("bomb.png", "image too large")])
def test_unsupported_image_is_a_named_400(tier, images, ingest, name, match):
    gw = _gateway(Gateway, tier.port, ingest=ingest)
    try:
        status, body, _ = _post(gw.port, {"url": images[0](name)})
        assert status == 400 and match in json.loads(body)["error"]
        fallbacks = gw._m_ingest["fallbacks"]
        if ingest:  # the server refused a JPEG or PNG (rejected); a GIF never left (format)
            assert fallbacks["format" if name.endswith(".gif") else "rejected"].value == 1
    finally:
        gw.shutdown()


@pytest.mark.parametrize("ingest", [True, False], ids=["bytes-wire", "tensor-wire"])
def test_progressive_jpeg_is_answered_on_both_wires(tier, images, ingest):
    """The JAX package decodes with PIL, which opens progressive JPEG: the
    port's gateway answers it with 200 and the logits of PIL's pixels."""
    gw = _gateway(Gateway, tier.port, ingest=ingest)
    try:
        status, body, _ = _post(gw.port, {"url": images[0]("prog.jpg")})
        assert status == 200, body
        assert json.loads(body) == _want(images, "prog.jpg")
        assert gw._m_ingest["bytes_requests"].value == (1 if ingest else 0)
    finally:
        gw.shutdown()


# --- cache, breaker, upstream batching, forwarded headers ----------------------------


def test_cache_hit_miss_bust_and_coalescing(tmp_path, images):
    server = _stub_server(tmp_path, device_ms=300.0)
    gw = _gateway(Gateway, server.port)
    try:
        url = {"url": images[0]("pants.png")}
        s1, b1, h1 = _post(gw.port, url)
        seen = server._m_requests.value
        s2, b2, h2 = _post(gw.port, url)
        assert (s1, s2) == (200, 200) and b1 == b2
        assert (h1["X-Kdlt-Cache"], h2["X-Kdlt-Cache"]) == ("miss", "hit")
        assert server._m_requests.value == seen  # a hit never reaches the tier
        _, b3, h3 = _post(gw.port, url, {"X-Kdlt-Cache-Bust": "salt"})
        assert h3["X-Kdlt-Cache"] == "miss" and b3 == b1
        assert server._m_requests.value == seen + 1
        out: list = []
        fresh = {"url": images[0]("photo.jpg")}
        threads = [threading.Thread(target=lambda: out.append(_post(gw.port, fresh)))
                   for _ in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert len({o[1] for o in out}) == 1 and all(o[0] == 200 for o in out)
        assert sorted(o[2]["X-Kdlt-Cache"] for o in out) == ["coalesced"] * 3 + ["miss"]
        assert server._m_requests.value == seen + 2  # one upstream call for the four
    finally:
        gw.shutdown()
        server.shutdown()


class _FakeTier:
    """A model tier whose behaviour the test sets: the spec on discovery (no
    ingest offer: both gateways take the tensor wire), /healthz, and a
    ``:predict`` answer per ``mode``; it records the headers it was sent."""

    def __init__(self, spec=SPEC):
        self.mode = "ok"
        self.headers: list = []
        self.predicts = 0
        tier = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *args):
                pass

            def _send(self, status, body, ctype="application/json", extra=None):
                self.send_response(status)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                for k, v in (extra or {}).items():
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == f"/v1/models/{spec.name}":
                    return self._send(200, spec.to_json().encode())
                if self.path in ("/healthz", "/readyz"):
                    return self._send(503 if tier.mode == "500" else 200, b"ok", "text/plain")
                self._send(404, b'{"error": "not found"}')

            def do_POST(self):
                body = self.rfile.read(int(self.headers.get("Content-Length") or 0))
                tier.headers.append(dict(self.headers))
                tier.predicts += 1
                if tier.mode == "500":
                    return self._send(500, b'{"error": "boom"}')
                if tier.mode == "503":
                    return self._send(503, b'{"error": "overloaded"}', extra={
                        "Retry-After": "0.250"})
                if not self.path.startswith(f"/v1/models/{spec.name}:"):
                    return self._send(404, b'{"error": "no model"}')
                images = protocol.decode_predict_request(body, self.headers["Content-Type"])
                out, ctype = protocol.encode_predict_response(
                    stub_logits(images, spec.num_classes), spec.labels,
                    protocol.MSGPACK_CONTENT_TYPE)
                self._send(200, out, ctype, {protocol.ARTIFACT_HASH_HEADER: "ab" * 32})

        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.httpd.daemon_threads = True
        self.port = self.httpd.server_address[1]
        threading.Thread(target=self.httpd.serve_forever, daemon=True).start()

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()


@pytest.fixture
def fake_tier():
    tier = _FakeTier()
    yield tier
    tier.close()


def test_breaker_opens_on_a_failing_tier_and_recovers_as_the_jax_gateways(
        fake_tier, images, monkeypatch):
    monkeypatch.setenv("KDLT_BREAKER_FAILURES", "2")
    monkeypatch.setenv("KDLT_BREAKER_RESET_S", "0.3")
    monkeypatch.setenv("KDLT_PROBE_INTERVAL_S", "30")  # recovery through the half-open probe
    runs = []
    for cls in (Gateway, JaxGateway):
        gw = _gateway(cls, fake_tier.port, cache=False)
        try:
            url = {"url": images[0]("pants.png")}
            assert _post(gw.port, url)[0] == 200
            fake_tier.mode = "500"
            seq = [_post(gw.port, url) for _ in range(3)]
            fake_tier.mode = "ok"
            time.sleep(0.4)  # past the reset: half open
            seq.append(_post(gw.port, url))
            runs.append([(s, json.loads(b), h.get("Retry-After") is not None) for s, b, h in seq])
        finally:
            gw.shutdown()
    port_run, jax_run = runs
    assert [r[0] for r in port_run] == [r[0] for r in jax_run] == [502, 502, 503, 200]
    assert port_run[2][1] == jax_run[2][1] == {"error": "model tier circuit breaker is open"}
    assert port_run[2][2] and jax_run[2][2]  # Retry-After: the remaining cool-down
    assert port_run[0][1] == jax_run[0][1]


def test_upstream_batching_coalesces_concurrent_requests(tmp_path, images):
    server = _stub_server(tmp_path, device_ms=50.0)
    gw = _gateway(Gateway, server.port, ingest=False, upstream_batch=4, upstream_delay_ms=100.0,
                  cache=False)
    try:
        names = [f"many{i}.png" for i in range(4)]
        seen = server._m_requests.value
        out: dict = {}
        threads = [threading.Thread(target=lambda n=n: out.__setitem__(
            n, _post(gw.port, {"url": images[0](n)}))) for n in names]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        for n in names:
            assert out[n][0] == 200 and json.loads(out[n][1]) == _want(images, n)
        assert server._m_requests.value - seen <= 2  # fewer upstream POSTs than requests
    finally:
        gw.shutdown()
        server.shutdown()


def test_deadline_request_id_and_priority_are_forwarded_as_the_jax_gateway_does(
        fake_tier, images):
    seen = []
    for cls in (Gateway, JaxGateway):
        gw = _gateway(cls, fake_tier.port, cache=False)
        try:
            fake_tier.headers.clear()
            status, _, headers = _post(gw.port, {"url": images[0]("pants.png")}, {
                "X-Request-Deadline-Ms": "5000", "X-Request-Id": "rid-fwd-1",
                "X-Kdlt-Priority": "batch"})
            assert status == 200 and headers["X-Request-Id"] == "rid-fwd-1"
            sent = fake_tier.headers[-1]
            assert 0 < float(sent["X-Request-Deadline-Ms"]) <= 5000
            assert sent["X-Request-Id"] == "rid-fwd-1" and sent["X-Kdlt-Priority"] == "batch"
            seen.append(sorted(k for k in sent if k.startswith("X-")))
        finally:
            gw.shutdown()
    assert seen[0] == seen[1]


# --- error replies -------------------------------------------------------------------


_CASES = {
    # name: (request body or callable(url) -> body, path, headers, tier mode)
    "bad-json": (b"{not json", "/predict", {}, "ok"),
    "missing-url": ({"image": "x"}, "/predict", {}, "ok"),
    "unfetchable": (lambda url: {"url": url("nope.png")}, "/predict", {}, "ok"),
    "oversize": (b"x", "/predict", {"Content-Length": str(5 * 1024 * 1024)}, "ok"),
    "bad-model-name": ({"url": "x"}, "/predict/bad%20name!", {}, "ok"),
    "unknown-route": ({"url": "x"}, "/other", {}, "ok"),
    "deadline-spent": (lambda url: {"url": url("pants.png")}, "/predict",
                       {"X-Request-Deadline-Ms": "0"}, "ok"),
    "tier-503": (lambda url: {"url": url("pants.png")}, "/predict", {}, "503"),
    "tier-500": (lambda url: {"url": url("pants.png")}, "/predict", {}, "500"),
    "unknown-model": (lambda url: {"url": url("pants.png")}, "/predict/other-model", {}, "ok"),
}


def _raw_post(port: int, body: bytes, path: str, headers: dict):
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.putrequest("POST", path)
        hdrs = {"Content-Type": "application/json", "Content-Length": str(len(body)), **headers}
        for k, v in hdrs.items():
            conn.putheader(k, v)
        conn.endheaders()
        if int(hdrs["Content-Length"]) == len(body):
            conn.send(body)
        resp = conn.getresponse()
        return resp.status, resp.read(), resp.getheader("Retry-After")
    finally:
        conn.close()


@pytest.mark.parametrize("case", sorted(_CASES))
def test_error_replies_match_the_jax_gateway(fake_tier, images, case, monkeypatch):
    monkeypatch.setattr("random.uniform", lambda a, b: (a + b) / 2)  # jitter at its centre
    body, path, headers, mode = _CASES[case]
    if callable(body):
        body = body(images[0])
    if not isinstance(body, bytes):
        body = json.dumps(body).encode()
    replies = []
    for cls in (Gateway, JaxGateway):
        gw = _gateway(cls, fake_tier.port, cache=False)
        try:
            fake_tier.mode = mode
            replies.append(_raw_post(gw.port, body, path, headers))
        finally:
            fake_tier.mode = "ok"
            gw.shutdown()
    (s1, b1, r1), (s2, b2, r2) = replies
    assert s1 == s2 and s1 >= 400, (s1, s2)
    assert json.loads(b1) == json.loads(b2), (b1, b2)
    assert r1 == r2


def test_unreachable_tier_replies_match_the_jax_gateway_but_for_the_client_library(images):
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        dead = s.getsockname()[1]
    replies = []
    for cls in (Gateway, JaxGateway):
        gw = _gateway(cls, dead, cache=False)
        try:
            status, body, headers = _post(gw.port, {"url": images[0]("pants.png")})
            replies.append((status, sorted(json.loads(body)), headers.get("Retry-After")))
            assert json.loads(body)["error"].startswith("model spec discovery failed")
        finally:
            gw.shutdown()
    assert replies[0] == replies[1] and replies[0][0] == 502


def test_generate_streams_through_the_port_gateway_as_through_the_jax_gateway(tmp_path):
    """``/generate`` and ``/generate/<model>`` relay the model tier's token
    stream (a streamed 200, ``text/event-stream``, never cached: a second
    identical request decodes again) with the JAX gateway's events; JSON
    mode and the refusals (``/generate/nope``, a malformed name, a bad
    body) pass through with the JAX gateway's statuses and bodies."""
    server = _stub_server(tmp_path, decode=True)
    gateways = [_gateway(cls, server.port) for cls in (Gateway, JaxGateway)]
    try:
        streams = []
        for gw in gateways:
            for path in ("/generate", "/generate/gen-default"):
                status, body, headers = _post(gw.port, {"prompt": "hi there", "max_new_tokens": 5},
                                              path=path)
                assert status == 200, body
                assert headers["Content-Type"] == protocol.EVENT_STREAM_CONTENT_TYPE
                assert headers["Cache-Control"] == "no-store"
                events = protocol.parse_sse_events(body)
                assert events[-1]["done"] and events[-1]["tokens"] == len(events) - 1 == 5
                streams.append([{k: v for k, v in e.items() if k not in ("ttft_ms", "tpot_ms")}
                                for e in events])
        assert all(s == streams[0] for s in streams)
        assert server.generate.debug_payload()["window"]["generations"] == 4
        for body, path in (({"prompt": "hi there", "max_new_tokens": 5, "stream": False},
                            "/generate"),
                           ({"prompt": "x"}, "/generate/nope"),
                           ({"prompt": "x"}, "/generate/bad%20name!"),
                           ({"nope": 1}, "/generate")):
            (s1, b1, _), (s2, b2, _) = (_post(gw.port, body, path=path) for gw in gateways)
            assert s1 == s2, (path, s1, s2)
            if s1 == 200:
                assert json.loads(b1)["text"] == json.loads(b2)["text"] == streams[0][-1]["text"]
            else:
                assert json.loads(b1) == json.loads(b2), (b1, b2)
        assert _post(gateways[0].port, {"prompt": "x"}, path="/generate/nope")[0] == 404
    finally:
        for gw in gateways:
            gw.shutdown()
        server.shutdown()


# --- the full clothing-model -----------------------------------------------------------


def test_full_clothing_model_through_the_port_and_the_jax_gateways(tmp_path, images):
    """299 px, all 14 blocks, seeded weights written once (flax layout),
    served by the port's engine (weights carried by ``weights.py``) and by
    the JAX server."""
    from kubernetes_deep_learning_tpu.serving.model_server import ModelServer as JaxModelServer
    from kubernetes_deep_learning_tpu_torch.models import init_variables

    spec = CLOTHING_MODEL
    art.save_artifact(art.version_dir(str(tmp_path), spec.name, 1), spec,
                      init_variables(spec, seed=3), {"compute_dtype": "bfloat16"})
    port_server = ModelServer(str(tmp_path), port=0, buckets=(1, 2), device="cpu")
    port_server.start()
    port_server.warmup()
    jax_server = JaxModelServer(str(tmp_path), port=0, buckets=(1,), max_delay_ms=1.0)
    jax_server.warmup()
    jax_server.start()
    gws = {"port": _gateway(Gateway, port_server.port, model=spec.name),
           "port-tensor": _gateway(Gateway, port_server.port, model=spec.name, ingest=False),
           "jax": _gateway(JaxGateway, port_server.port, model=spec.name),
           "jax-jax": _gateway(JaxGateway, jax_server.port, model=spec.name)}
    try:
        for name in ("photo.jpg", "pants.png"):
            out = {k: _post(gw.port, {"url": images[0](name)}) for k, gw in gws.items()}
            assert all(s == 200 for s, _, _ in out.values()), {k: v[:2] for k, v in out.items()}
            assert out["port"][1] == out["jax"][1] == out["port-tensor"][1]
            port = json.loads(out["port"][1])
            ref = json.loads(out["jax-jax"][1])
            assert list(port) == list(ref) == list(spec.labels)
            got, want = np.asarray(list(port.values())), np.asarray(list(ref.values()))
            assert np.abs(got - want).max() <= 2e-2 * np.abs(want).max() + 2e-2, (got, want)
            assert got.argmax() == want.argmax()
        assert gws["port"]._m_ingest["bytes_requests"].value == 2
    finally:
        for gw in gws.values():
            gw.shutdown()
        port_server.shutdown()
        jax_server.shutdown()


# --- ROADMAP C5: /debug/profile does not stall serving -------------------------------------


def test_profile_capture_holds_the_capture_lock_only_at_its_edges(tmp_path, monkeypatch):
    """A 1.5 s capture on the stub server while other requests run: during
    its window ``runtime.engine.capture_lock`` is free (a reload's graph
    capture need not wait for the window), and so it is while the trace is
    written; requests on other threads complete, and the reply keeps its
    keys with a ``trace.json``."""
    import torch.profiler

    from kubernetes_deep_learning_tpu_torch.runtime.engine import capture_lock
    from kubernetes_deep_learning_tpu_torch.serving import model_server

    started = threading.Event()
    start = torch.profiler.profile.start

    def start_and_tell(prof):  # the profiler's first start can take a second or more
        start(prof)
        started.set()

    write = model_server._CpuProfile.write
    locked_at_write: list = []

    def write_and_look(recording, *args):
        locked_at_write.append(capture_lock.locked())
        return write(recording, *args)

    monkeypatch.setattr(torch.profiler.profile, "start", start_and_tell)
    monkeypatch.setattr(model_server._CpuProfile, "write", write_and_look)
    server = _stub_server(tmp_path / "models", profile_base=str(tmp_path / "profiles"))
    body = protocol.encode_predict_request(np.zeros((1, *SPEC.input_shape), np.uint8))
    url = f"http://127.0.0.1:{server.port}/v1/models/{SPEC.name}:predict"
    reply: list = []
    try:
        capture = threading.Thread(target=lambda: reply.append(
            server.handle_get("/debug/profile?seconds=1.5")))
        capture.start()
        assert started.wait(60)
        t0 = time.monotonic()
        time.sleep(0.3)  # inside the 1.5 s window
        free = capture_lock.acquire(timeout=0.2)
        if free:
            capture_lock.release()
        done = []
        while time.monotonic() - t0 < 1.0:
            req = urllib.request.Request(url, data=body, method="POST",
                                         headers={"Content-Type": protocol.MSGPACK_CONTENT_TYPE})
            with urllib.request.urlopen(req, timeout=10) as r:
                done.append(r.status)
        capture.join(timeout=60)
        assert free, "capture_lock was held during the profile's window"
        assert locked_at_write == [False], "capture_lock was held while the trace was written"
        assert done and set(done) == {200}
        status, out, _, _ = reply[0]
        got = json.loads(out)
        assert status == 200 and set(got) == {"trace_dir", "seconds", "kernels"}
        assert got["seconds"] == 1.5 and isinstance(got["kernels"], dict)
        with open(os.path.join(got["trace_dir"], "trace.json")) as f:
            assert json.load(f)["traceEvents"]
        # A second capture while one runs is refused, as before.
        capture = threading.Thread(target=lambda: reply.append(
            server.handle_get("/debug/profile?seconds=0.5")))
        capture.start()
        time.sleep(0.1)
        assert server.handle_get("/debug/profile?seconds=0.5")[0] == 409
        capture.join(timeout=60)
    finally:
        server.shutdown()


def test_device_trace_builds_here_and_refuses_loudly_without_cupti():
    """The card's profile recorder (``native/cupti_trace.cc``) builds with
    g++ on any host (it declares the CUPTI types it reads where no header
    is); where no libcupti is loaded, starting it raises, naming libcupti:
    /debug/profile never records something else in its place."""
    import ctypes.util

    from kubernetes_deep_learning_tpu_torch.ops import _native

    trace = _native.DeviceTrace()
    assert trace._lib.kdlt_trace_start is not None
    if not ctypes.util.find_library("cupti"):
        with pytest.raises(RuntimeError, match="libcupti"):
            trace.start()
