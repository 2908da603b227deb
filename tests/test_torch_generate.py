"""The port's generative lane (``serving/generate.py``) and its wire path on
the CPU, against the JAX package's.

- The port counterpart of every test of JAX's
  ``tests/test_generate_serving.py``: request handling, SSE framing, the
  per-token SLO closure and the /debug/slo decode section, on one
  module-scoped lane (the real engine and scheduler, 2 slots, 8-token
  pages); the end-to-end one runs the port's model server (``decode=True``,
  a stub image engine), the port's gateway and the port's client, and the
  JAX client reads the same stream from the port's gateway.
- The model server's ``:generate`` route: chunked SSE over HTTP, a client
  that goes away cancels its generation and frees its slot, the spans and
  series it leaves, the 404s, the CLI flags.
- ``export.warm.warm_decode`` and the ladder in ``warm_models``: the
  counterparts of JAX's three ``tests/test_warm.py`` decode tests, and the
  real CPU engine's grid.
"""

from __future__ import annotations

import http.client
import json
import time

import pytest

from kubernetes_deep_learning_tpu.serving import client as jax_client
from kubernetes_deep_learning_tpu.serving import generate as jax_generate
from kubernetes_deep_learning_tpu_torch.export import artifact as art
from kubernetes_deep_learning_tpu_torch.export import warm
from kubernetes_deep_learning_tpu_torch.modelspec import CLOTHING_MODEL, ModelSpec
from kubernetes_deep_learning_tpu_torch.runtime.stub import StubEngine
from kubernetes_deep_learning_tpu_torch.serving import client as client_lib
from kubernetes_deep_learning_tpu_torch.serving import generate as generate_lib
from kubernetes_deep_learning_tpu_torch.serving import model_server as model_server_lib
from kubernetes_deep_learning_tpu_torch.serving import protocol
from kubernetes_deep_learning_tpu_torch.serving.gateway import Gateway
from kubernetes_deep_learning_tpu_torch.serving.model_server import ModelServer
from kubernetes_deep_learning_tpu_torch.utils import metrics as metrics_lib
from torch_threads import one_torch_thread  # noqa: F401

SMALL = dict(max_slots=2, page_size=8, max_pages_per_seq=4, device="cpu")
SPEC = ModelSpec(name="gen-stub", family="xception", input_shape=(96, 96, 3),
                 labels=CLOTHING_MODEL.labels, preprocessing="tf", resize_filter="nearest")


class _SloSpy:
    def __init__(self):
        self.calls = []

    def record(self, model, status, dt, deadline_exceeded=False):
        self.calls.append((model, status, deadline_exceeded))


@pytest.fixture(scope="module")
def slo_spy():
    return _SloSpy()


@pytest.fixture(scope="module")
def registry():
    return metrics_lib.Registry()


@pytest.fixture(scope="module")
def lane(slo_spy, registry):
    lane = generate_lib.GenerateLane("gen-test", registry=registry, slo=slo_spy,
                                     engine_kwargs=SMALL)
    yield lane
    lane.close()


def test_knobs_are_jaxs():
    for name in ("DECODE_ENV", "DECODE_MODEL_ENV", "DEFAULT_DECODE_MODEL", "TTFT_BUDGET_ENV",
                 "TPOT_BUDGET_ENV", "DEFAULT_TTFT_BUDGET_MS", "DEFAULT_TPOT_BUDGET_MS",
                 "MAX_GENERATE_BODY_BYTES"):
        assert getattr(generate_lib, name) == getattr(jax_generate, name), name


def test_decode_enabled_reads_the_env_switch(monkeypatch):
    monkeypatch.delenv("KDLT_DECODE", raising=False)
    assert generate_lib.decode_enabled(None) is False
    assert generate_lib.decode_enabled(True) is True
    assert generate_lib.decode_enabled(False) is False
    monkeypatch.setenv("KDLT_DECODE", "1")
    assert generate_lib.decode_enabled(None) is True
    assert generate_lib.decode_enabled(False) is False  # explicit wins over env


def test_json_mode_answers_one_document(lane, slo_spy):
    slo_spy.calls.clear()
    status, body, ctype, extra = lane.handle_generate(
        json.dumps({"prompt": "hi", "max_new_tokens": 4, "stream": False}).encode(),
        rid="json-1")
    assert status == 200 and ctype == protocol.JSON_CONTENT_TYPE
    doc = json.loads(body)
    assert 1 <= doc["tokens"] <= 4
    assert doc["finish_reason"] in ("stop", "length")
    assert doc["ttft_ms"] >= 0
    assert slo_spy.calls == [("gen-test", 200, False)]


def test_stream_mode_yields_sse_frames_with_terminal_done(lane):
    status, payload, ctype, extra = lane.handle_generate(
        json.dumps({"prompt": "hello", "max_new_tokens": 5}).encode(), rid="sse-1")
    assert status == 200
    assert ctype == protocol.EVENT_STREAM_CONTENT_TYPE
    assert extra["Cache-Control"] == "no-store"  # a stream never enters a cache
    events = protocol.parse_sse_events(b"".join(payload))
    done = events[-1]
    assert done["done"] is True
    assert done["tokens"] == len(events) - 1
    assert done["text"] == "".join(e["text"] for e in events[:-1])


def test_stream_and_json_agree_on_the_same_prompt(lane):
    _, payload, _, _ = lane.handle_generate(
        json.dumps({"prompt": "same prompt", "max_new_tokens": 6}).encode())
    streamed = protocol.parse_sse_events(b"".join(payload))[-1]["text"]
    _, body, _, _ = lane.handle_generate(
        json.dumps({"prompt": "same prompt", "max_new_tokens": 6, "stream": False}).encode())
    assert json.loads(body)["text"] == streamed


def test_malformed_and_unfittable_bodies_are_400(lane, slo_spy):
    slo_spy.calls.clear()
    status, body, ctype, _ = lane.handle_generate(b"notjson")
    assert status == 400 and b"error" in body
    status, body, _, _ = lane.handle_generate(
        json.dumps({"prompt": "x" * 40, "max_new_tokens": 10}).encode())
    assert status == 400 and b"exceeds" in body
    assert [c[1] for c in slo_spy.calls] == [400, 400]


def test_queue_at_capacity_is_a_retryable_503(lane, slo_spy):
    slo_spy.calls.clear()
    old_cap = lane.scheduler.queue_cap
    lane.scheduler.queue_cap = 0  # every admission is over the cap
    try:
        status, body, _, _ = lane.handle_generate(json.dumps({"prompt": "hi"}).encode())
    finally:
        lane.scheduler.queue_cap = old_cap
    assert status == 503 and b"capacity" in body
    assert slo_spy.calls == [("gen-test", 503, False)]


def test_budget_violation_counts_as_deadline_exceeded(lane, slo_spy, monkeypatch):
    monkeypatch.setenv(generate_lib.TTFT_BUDGET_ENV, "0.000001")
    slo_spy.calls.clear()
    _, body, _, _ = lane.handle_generate(
        json.dumps({"prompt": "hi", "max_new_tokens": 3, "stream": False}).encode())
    assert json.loads(body)["finish_reason"] in ("stop", "length")
    assert slo_spy.calls == [("gen-test", 200, True)]


def test_debug_payload_has_window_budgets_and_occupancy(lane):
    payload = lane.debug_payload()
    assert payload["model"] == "gen-test"
    assert payload["continuous"] is True
    assert set(payload["budgets_ms"]) == {"ttft", "tpot"}
    w = payload["window"]
    assert w["generations"] >= 1  # earlier tests populated the window
    assert set(w["ttft_ms"]) == {"p50", "p95", "p99"}
    occ = payload["occupancy"]
    assert occ["max_slots"] == 2
    assert occ["active_slots"] == 0 and occ["queue_depth"] == 0
    assert occ["pages_total"] == lane.engine.num_pages - 1
    assert sum(payload["finish_reasons"].values()) == w["generations"]


def test_decode_series_minted_centrally_on_the_lane_registry(lane, registry):
    text = registry.render()
    for series in ("kdlt_decode_ttft_seconds", "kdlt_decode_tpot_seconds",
                   "kdlt_decode_tokens_total", "kdlt_decode_generations_total",
                   "kdlt_decode_steps_total", "kdlt_decode_kv_pages_in_use"):
        assert series in text, series
    assert 'model="gen-test"' in text


def test_client_disconnect_mid_stream_cancels_the_generation(lane, monkeypatch):
    orig_step = lane.engine.step_async

    def slow_step():
        time.sleep(0.01)
        return orig_step()

    monkeypatch.setattr(lane.engine, "step_async", slow_step)
    status, payload, _, _ = lane.handle_generate(
        json.dumps({"prompt": "hi", "max_new_tokens": 25}).encode(), rid="gone-1")
    assert status == 200
    it = iter(payload)
    next(it)  # the first token is on the wire...
    it.close()  # ...then the client goes away
    for _ in range(300):
        if lane.engine.active_slots == 0 and lane.engine.pages_in_use == 0:
            break
        time.sleep(0.02)
    assert lane.engine.active_slots == 0
    assert lane.engine.pages_in_use == 0
    assert lane.debug_payload()["finish_reasons"].get("cancelled", 0) >= 1


# --- end to end: the server's :generate -> the gateway's /generate -> the client ---


@pytest.fixture(scope="module")
def tiers(tmp_path_factory):
    """The port's model server with the lane on (a stub image engine beside
    it; the lane at the JAX defaults, on the CPU) and the port's gateway."""
    root = tmp_path_factory.mktemp("models")
    art.save_artifact(art.version_dir(str(root), SPEC.name, 1), SPEC, {"params": {}}, {})
    server = ModelServer(str(root), port=0, buckets=(1,), device="cpu", decode=True,
                         engine_factory=lambda a, **k: StubEngine(a, **k))
    server.start()
    server.warmup()
    gw = Gateway(serving_host=f"127.0.0.1:{server.port}", model=SPEC.name, port=0)
    gw.start()
    yield {"server": server, "gateway": f"http://127.0.0.1:{gw.port}", "gw": gw}
    gw.shutdown()
    server.shutdown()


def test_generate_streams_end_to_end_through_gateway_and_client(tiers):
    """A token stream leaves the server's ``:generate`` as chunked SSE,
    relays through the gateway's ``/generate`` without buffering or caching,
    and lands in the client's incremental parser equal to the non-streamed
    JSON answer."""
    base = tiers["gateway"]
    stats: dict = {}
    events = list(client_lib.generate_stream(base, "hello tpu", max_new_tokens=6, stats=stats))
    done = events[-1]
    assert done["done"] is True and done["tokens"] == len(events) - 1
    assert stats["request_id"]
    r = client_lib.request("POST", f"{base}/generate",
                           json.dumps({"prompt": "hello tpu", "max_new_tokens": 6,
                                       "stream": False}).encode(),
                           {"Content-Type": "application/json"}, timeout=60)
    assert r.status_code == 200
    assert r.json()["text"] == done["text"]  # greedy: the same stream
    r = client_lib.request("POST", f"{base}/generate/nope", b'{"prompt": "x"}',
                           {"Content-Type": "application/json"}, timeout=60)
    assert r.status_code == 404 and b"nope" in r.content
    # The decode section rides each replica's /debug/slo through the merge.
    slo = client_lib.fetch_slo(base)
    decs = [body.get("decode") for body in slo["replicas"].values() if isinstance(body, dict)]
    assert any(d and d["window"]["generations"] >= 2 for d in decs)
    table = client_lib.render_decode_slo(slo)
    assert "gen-default" in table
    assert table == jax_client.render_decode_slo(slo)
    assert client_lib.render_decode_slo({}) == jax_client.render_decode_slo({})


def test_jax_client_reads_the_port_gateways_stream(tiers):
    """JAX's ``generate_stream`` (on requests) and the port's (on
    http.client) read the same events from the port's gateway, all but the
    done event's timings."""
    got = list(client_lib.generate_stream(tiers["gateway"], "parity", max_new_tokens=5))
    want = list(jax_client.generate_stream(tiers["gateway"], "parity", max_new_tokens=5))
    strip = [{k: v for k, v in e.items() if k not in ("ttft_ms", "tpot_ms")} for e in got]
    assert strip == [{k: v for k, v in e.items() if k not in ("ttft_ms", "tpot_ms")}
                     for e in want]
    assert len(got) >= 2 and got[-1]["done"]


def test_server_route_streams_chunked_and_a_gone_client_frees_its_slot(tiers):
    server = tiers["server"]
    lane = server.generate
    conn = http.client.HTTPConnection("127.0.0.1", server.port, timeout=30)
    conn.request("POST", "/v1/models/gen-default:generate",
                 json.dumps({"prompt": "hi", "max_new_tokens": 100}).encode(),
                 {"Content-Type": "application/json", "X-Request-Id": "gone-http"})
    r = conn.getresponse()
    assert r.status == 200
    assert r.getheader("Transfer-Encoding") == "chunked"
    assert r.getheader("Content-Type") == protocol.EVENT_STREAM_CONTENT_TYPE
    assert r.getheader("X-Request-Id") == "gone-http"
    assert protocol.parse_sse_events(r.read1(65536))[0]["index"] == 0
    conn.sock.close()  # the client goes away mid-stream
    conn.close()
    for _ in range(500):
        if lane.engine.active_slots == 0 and lane.engine.pages_in_use == 0:
            break
        time.sleep(0.02)
    assert (lane.engine.active_slots, lane.engine.pages_in_use) == (0, 0)
    assert lane.debug_payload()["finish_reasons"].get("cancelled", 0) >= 1
    spans = {s["name"] for s in server.tracer.trace_info("gone-http")["spans"]}
    assert {"server.generate", "server.admission", "server.decode", "decode.prefill",
            "decode.first_token", "decode.stream"} <= spans
    metrics = server.handle_get("/metrics")[1].decode()
    assert 'kdlt_decode_tokens_total{model="gen-default"}' in metrics


def test_server_route_refusals(tiers, tmp_path):
    server = tiers["server"]
    for name, body, status, needle in (
            ("nope", b'{"prompt": "x"}', 404, b"no generative model 'nope'"),
            ("gen-default", b"notjson", 400, b"invalid JSON"),
            ("gen-default", b'{"prompt": "' + b"x" * 200 + b'"}', 400, b"exceeds")):
        reply, exchange = server.serve_generate(name, body, {"Content-Length": str(len(body))})
        exchange.finish()
        assert reply[0] == status and needle in reply[1], (name, reply)
    art.save_artifact(art.version_dir(str(tmp_path), SPEC.name, 1), SPEC, {"params": {}}, {})
    plain = ModelServer(str(tmp_path), port=0, buckets=(1,), device="cpu",
                        engine_factory=lambda a, **k: StubEngine(a, **k))
    try:
        reply, exchange = plain.serve_generate("gen-default", b'{"prompt": "x"}')
        exchange.finish()
        assert reply[0] == 404 and b"lane disabled" in reply[1] and b"KDLT_DECODE=1" in reply[1]
        assert "decode" not in json.loads(plain.handle_get("/debug/slo")[1])
    finally:
        plain.shutdown()


def test_cli_flags_turn_the_lane_on_and_static(tmp_path):
    art.save_artifact(art.version_dir(str(tmp_path), SPEC.name, 1), SPEC, {"params": {}}, {})
    args = model_server_lib._parser().parse_args(
        ["--model-root", str(tmp_path), "--device", "cpu", "--decode",
         "--static-decode-batching"])
    assert args.decode and args.static_decode_batching
    server = ModelServer(str(tmp_path), port=0, buckets=(1,), device="cpu",
                         engine_factory=lambda a, **k: StubEngine(a, **k),
                         decode=args.decode, decode_continuous=not args.static_decode_batching)
    try:
        assert server.generate is not None and server.generate.scheduler.continuous is False
        assert server.generate.engine.device.type == "cpu"
    finally:
        server.shutdown()


# --- kdlt-torch-warm's decode ladder ------------------------------------------------


class _FakeDecodeEngine:
    """A device-free stand-in for runtime.decode.DecodeEngine."""

    max_slots = 4

    def __init__(self, model="gen-default", device="cuda"):
        self.model = model
        self.closed = False

    def warmup(self):
        return {"model": self.model, "buckets": {"16": 0.01, "32": 0.01, "64": 0.01},
                "step_s": 0.01}

    def close(self):
        self.closed = True


def _stub_root(root) -> str:
    art.save_artifact(art.version_dir(str(root), SPEC.name, 1), SPEC, {"params": {}}, {})
    return str(root)


def _stub_factory(directory, buckets, device):
    return StubEngine(art.load_artifact(directory), buckets=buckets, device=device)


def test_warm_learns_decode_grid_when_lane_enabled(tmp_path, monkeypatch):
    monkeypatch.delenv("KDLT_DECODE", raising=False)
    report = warm.warm_models(_stub_root(tmp_path), buckets=(1,), device="cpu",
                              engine_factory=_stub_factory, libraries=(), decode=True,
                              decode_engine_factory=_FakeDecodeEngine)
    grid = report["decode"]["grid"]
    assert grid["prompt_buckets"] == [16, 32, 64]
    assert grid["slots"] == 4
    assert report["decode"]["model"] == "gen-default"
    assert report["decode"]["step_s"] >= 0


def test_warm_decode_follows_kdlt_decode_env(tmp_path, monkeypatch):
    root = _stub_root(tmp_path)
    monkeypatch.delenv("KDLT_DECODE", raising=False)
    report = warm.warm_models(root, buckets=(1,), device="cpu", engine_factory=_stub_factory,
                              libraries=(), decode_engine_factory=_FakeDecodeEngine)
    assert "decode" not in report
    monkeypatch.setenv("KDLT_DECODE", "1")
    report = warm.warm_models(root, buckets=(1,), device="cpu", engine_factory=_stub_factory,
                              libraries=(), decode_engine_factory=_FakeDecodeEngine)
    assert report["decode"]["grid"]["slots"] == 4


def test_warm_decode_failure_is_fail_soft_and_reported(tmp_path, monkeypatch):
    def exploding_factory(model="gen-default", device="cuda"):
        raise RuntimeError("decode capture exploded")

    report = warm.warm_models(_stub_root(tmp_path), buckets=(1,), device="cpu",
                              engine_factory=_stub_factory, libraries=(), decode=True,
                              decode_engine_factory=exploding_factory)
    assert "error" not in report["models"][SPEC.name]
    assert report["decode"]["error"] == "decode capture exploded"
    monkeypatch.setattr(warm, "_default_factory", _stub_factory)
    monkeypatch.setattr(warm, "HOST_LIBRARIES", ())
    monkeypatch.setattr(warm, "warm_decode", lambda *a: exploding_factory())
    assert warm.main(["--models", str(tmp_path), "--device", "cpu", "--decode"]) == 1


def test_warm_decode_runs_the_real_ladder_and_frees_the_engine(monkeypatch):
    monkeypatch.delenv("KDLT_DECODE_MODEL", raising=False)
    engines = []

    def factory(**kw):
        from kubernetes_deep_learning_tpu_torch.runtime.decode import DecodeEngine

        engines.append(DecodeEngine(**kw))
        return engines[-1]

    entry = warm.warm_decode(factory, device="cpu")
    assert entry["model"] == "gen-default"
    assert entry["grid"] == {"prompt_buckets": [16, 32, 64], "slots": 4}
    assert engines[0].cache is None  # closed: its memory given back


def test_lane_threads_stop_on_close():
    lane = generate_lib.GenerateLane("gen-close", engine_kwargs=SMALL)
    gen = lane.scheduler.submit("abc", 3)
    list(gen.iter_events(timeout_s=30.0))
    lane.close()
    assert not lane.scheduler._thread.is_alive()
    assert gen.finish_reason in ("stop", "length")
