"""The port's observability layer against the JAX package's.

The same scripted inputs (an injected clock, explicit span ids and
timestamps) go through both packages' tracer, SLO engine, flight recorder
and MFU accountant, and the results must be equal; the port's FLOPs per
image must lie within 2% of the JAX package's ``lowered_flops_per_image``;
the unchanged JAX gateway in front of the port's model server (CPU, a tiny
ViT) must merge a waterfall that passes the JAX package's own assertions;
the ``/debug/*`` routes must answer with the JAX server's status codes and
keys; a dispatch stall must yield exactly one incident bundle.
"""

from __future__ import annotations

import json
import os
import threading
import time
import urllib.error
import urllib.request
from functools import partial
from http.server import HTTPServer, SimpleHTTPRequestHandler
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import requests

from kubernetes_deep_learning_tpu.export import artifact as jax_art
from kubernetes_deep_learning_tpu.modelspec import ModelSpec as JaxModelSpec
from kubernetes_deep_learning_tpu.modelspec import register_spec
from kubernetes_deep_learning_tpu.runtime import flops as jax_flops
from kubernetes_deep_learning_tpu.runtime.stub import StubEngine
from kubernetes_deep_learning_tpu.serving.gateway import Gateway
from kubernetes_deep_learning_tpu.serving.model_server import ModelServer as JaxModelServer
from kubernetes_deep_learning_tpu.utils import flightrecorder as jax_recorder
from kubernetes_deep_learning_tpu.utils import metrics as jax_metrics
from kubernetes_deep_learning_tpu.utils import slo as jax_slo
from kubernetes_deep_learning_tpu.utils import trace as jax_trace
from kubernetes_deep_learning_tpu_torch.export import artifact as art
from kubernetes_deep_learning_tpu_torch.models import init_variables
from kubernetes_deep_learning_tpu_torch.modelspec import CLOTHING_MODEL, ModelSpec
from kubernetes_deep_learning_tpu_torch.runtime import flops as port_flops
from kubernetes_deep_learning_tpu_torch.serving import protocol
from kubernetes_deep_learning_tpu_torch.serving.model_server import ModelServer
from kubernetes_deep_learning_tpu_torch.serving.tracing import (
    PARENT_SPAN_HEADER,
    REQUEST_ID_HEADER,
    TRACE_HEADER,
)
from kubernetes_deep_learning_tpu_torch.utils import flightrecorder as port_recorder
from kubernetes_deep_learning_tpu_torch.utils import metrics as port_metrics
from kubernetes_deep_learning_tpu_torch.utils import slo as port_slo
from kubernetes_deep_learning_tpu_torch.utils import trace as port_trace
from torch_threads import one_torch_thread  # noqa: F401

PKGS = {
    "jax": SimpleNamespace(trace=jax_trace, slo=jax_slo, recorder=jax_recorder,
                           metrics=jax_metrics, flops=jax_flops),
    "port": SimpleNamespace(trace=port_trace, slo=port_slo, recorder=port_recorder,
                            metrics=port_metrics, flops=port_flops),
}


def _samples(registry) -> list[str]:
    """A registry's sample lines (the HELP texts are each package's own)."""
    return [line for line in registry.render().splitlines() if not line.startswith("#")]


def _series(registry) -> set[str]:
    """Each sample's name and labels, without its value."""
    return {line.rsplit(" ", 1)[0] for line in _samples(registry)}


# --- the closed vocabularies and the metric names ----------------------------


def test_vocabularies_and_metric_names_equal_jax():
    assert port_trace.SPAN_NAMES == jax_trace.SPAN_NAMES
    assert port_trace.RETENTION_PRIORITY == jax_trace.RETENTION_PRIORITY
    for name in ("TRACE_HEADER", "PARENT_SPAN_HEADER", "GRPC_PARENT_SPAN_KEY"):
        assert getattr(port_trace, name) == getattr(jax_trace, name)
    assert port_recorder.EVENT_KINDS == jax_recorder.EVENT_KINDS
    assert port_recorder.TRIGGER_RULES == jax_recorder.TRIGGER_RULES
    assert port_recorder.DEFAULT_TRIGGERS == jax_recorder.DEFAULT_TRIGGERS
    assert port_slo.WINDOWS == jax_slo.WINDOWS
    series = {}
    for key, pkg in PKGS.items():
        reg = pkg.metrics.Registry()
        pkg.metrics.trace_retention_metrics(reg)
        pkg.metrics.slo_tier_metrics(reg)
        pkg.metrics.slo_model_window_metrics(reg, "m", "5m")
        pkg.metrics.incident_metrics(reg)
        pkg.metrics.mfu_bucket_gauge(reg.with_labels(model="m", version="1"), 16)
        pkg.metrics.device_busy_gauge(reg)
        pkg.metrics.model_request_counter(reg, "m")
        series[key] = _series(reg)
    assert series["port"] == series["jax"]
    assert len(series["port"]) == 2 * 6 + 1 + 5 + 3 * 4 + 1 + 3


# --- tracer ------------------------------------------------------------------


def _tracer_run(pkg) -> dict:
    """A scripted mix of retention classes through a 4-trace ring with a
    3-span cap."""
    reg = pkg.metrics.Registry()
    t = pkg.trace.Tracer("model-server", max_traces=4, max_spans=3, registry=reg)
    out = {}
    for i in range(5):  # one trace over the span cap: 2 spans dropped
        t.record("capped", f"s{i}", 100.0 + i, 0.001, span_id=f"c{i}", k=i)
    out["capped"] = t.trace_info("capped")  # evicted later (routine)
    for i, (rid, cls) in enumerate([("a", "error"), ("b", None), ("c", "slow"), ("d", None)]):
        t.record(rid, "server.request", 200.0 + i, 0.002, span_id=f"{rid}0", parent_id="p")
        if cls:
            t.classify(rid, cls)
    t.classify("a", "routine")  # upgrades only: stays "error"
    out["a_class"] = t.trace_info("a")["retention_class"]
    t.classify("c", "deadline")  # slow -> deadline: an upgrade
    for i, rid in enumerate("efg"):  # evicts the oldest routine each time
        t.record(rid, "server.request", 300.0 + i, 0.003, span_id=f"{rid}0")
        out[f"resident_{rid}"] = sorted(r for r in "abcdefg" if t.spans(r) is not None)
    for rid in "efg":
        t.classify(rid, "shed")
    t.record("h", "server.request", 400.0, 0.004, span_id="h0")  # all protected: oldest goes
    out["resident_h"] = sorted(r for r in "abcdefgh" if t.spans(r) is not None)
    out["info"] = {r: t.trace_info(r) for r in "abcdefgh"}
    out["summary"] = t.summary("c")
    out["stats"] = t.stats()
    out["metrics"] = _samples(reg)
    return out


def test_tracer_eviction_cap_and_classify_match_jax():
    got, want = _tracer_run(PKGS["port"]), _tracer_run(PKGS["jax"])
    assert got == want
    assert got["capped"]["spans_dropped"] == 2 and len(got["capped"]["spans"]) == 3
    assert got["a_class"] == "error" and got["info"]["a"] is None  # protected, oldest: last out
    assert got["info"]["c"]["retention_class"] == "deadline"
    assert got["resident_h"] == ["c", "f", "g", "h"]


# --- SLO engine --------------------------------------------------------------


def _slo_run(pkg) -> tuple[list, list]:
    clock = [0.0]
    reg = pkg.metrics.Registry()
    eng = pkg.slo.SloEngine(reg, tier="model-server", enabled=True, target=0.99,
                            latency_objective_ms=50.0, clock=lambda: clock[0])
    rng = np.random.default_rng(3)
    payloads = []
    for i in range(2400):  # ~2 h of traffic, two models
        clock[0] = i * 3.1
        status = int(rng.choice([200, 200, 200, 200, 503, 504, 500, 404]))
        eng.record(("a", "b")[i % 2], status, float(rng.uniform(0.0, 0.08)),
                   deadline_exceeded=bool(rng.random() < 0.05))
        if i % 600 == 599:
            payloads.append(eng.debug_payload())
    return payloads, _samples(reg)


def test_slo_engine_windows_and_burn_rates_match_jax():
    got, want = _slo_run(PKGS["port"]), _slo_run(PKGS["jax"])
    assert got == want
    last = got[0][-1]["models"]["a"]
    assert last["5m"]["total"] < last["1h"]["total"] and last["1h"]["burn_rate"] > 0
    assert port_slo.merge_model_views([got[0][-1]["models"]] * 2, 0.99) == \
        jax_slo.merge_model_views([want[0][-1]["models"]] * 2, 0.99)


# --- flight recorder ---------------------------------------------------------


_TIMING = ("captured_at_s", "capture_latency_s", "bytes", "path")


def _recorder_run(pkg, directory) -> dict:
    """One event sequence through each trigger: fires, dedup, hysteresis."""
    clock = [1000.0]
    reg = pkg.metrics.Registry()
    tracer = pkg.trace.Tracer("model-server", registry=reg)
    rec = pkg.recorder.FlightRecorder(
        "model-server", reg, tracer=tracer, incident_dir=str(directory), dedup_s=60.0,
        clock=lambda: clock[0], wall=lambda: 1.7e9 + clock[0], enabled=True)
    rec.add_snapshot_provider("slo", lambda: {"tier": "model-server"})
    for rid in ("r1", "r2"):
        tracer.record(rid, "server.request", 1.0, 0.01, span_id=rid + "0")
    steps = [
        (0, "record", ("registry.load",), {"model": "m", "version": 1}),
        (1, "record", ("dispatch.stall",), {"rid": "r1", "model": "m"}),  # fires
        (2, "record", ("dispatch.stall",), {"rid": "r2", "model": "m"}),  # dedup
        (70, "record", ("dispatch.stall",), {"model": "m"}),  # past dedup: fires
        (80, "observe_burn", (0.5,), {}),
        (81, "observe_burn", (2.0,), {}),  # up: fires burn-crossing
        (82, "observe_burn", (0.5,), {}),  # down: clears
        (83, "observe_burn", (3.0,), {}),  # up inside dedup: suppressed
        (90, "record", ("brownout.enter",), {"stage": 1, "burn": 2.0}),  # fires
        (200, "record", ("brownout.enter",), {"stage": 2, "burn": 3.0}),  # armed: suppressed
        (210, "record", ("brownout.exit",), {"stage": 0, "burn": 0.5}),  # clears
        (300, "record", ("brownout.enter",), {"stage": 1, "burn": 2.0}),  # fires
        (310, "record", ("pool.unhealthy",), {"replica": "x"}),  # fires
    ]
    for t, method, args, kwargs in steps:
        clock[0] = 1000.0 + t
        getattr(rec, method)(*args, **kwargs)
        assert rec.wait_idle(10.0)
    index = rec.index()
    out = {
        "index": [{k: v for k, v in e.items() if k not in _TIMING} for e in index],
        "bundle_keys": [sorted(rec.get(e["id"])) for e in index],
        "events": [[ev["kind"] for ev in rec.get(e["id"])["events"]] for e in index],
        "triggers": rec.debug_payload()["triggers"],
        "metrics": [m for m in _samples(reg) if m.startswith("kdlt_incident")],
        "pinned": tracer.trace_info("r1")["retention_class"],
        "files": sorted(os.listdir(directory)),
    }
    rec.close()
    return out


def test_flight_recorder_decisions_and_bundles_match_jax(tmp_path):
    got = _recorder_run(PKGS["port"], tmp_path / "port")
    want = _recorder_run(PKGS["jax"], tmp_path / "jax")
    assert got == want
    assert [e["trigger"] for e in got["index"]] == [
        "replica-unhealthy", "brownout", "brownout", "burn-crossing", "dispatch-stall",
        "dispatch-stall"]
    assert got["index"][-1]["traces"] == ["r1"] and got["pinned"] == "incident"
    assert 'kdlt_incident_suppressed_total{trigger="dispatch-stall"} 1.0' in got["metrics"]


def test_flight_recorder_caps_evict_and_a_restart_reindexes(tmp_path):
    """Three bundles under a cap of two: the oldest file goes; a new
    recorder on the same directory adopts the two left and serves them from
    disk.  The same in both packages."""
    views = {}
    for key, pkg in PKGS.items():
        directory = tmp_path / key
        clock = [0.0]
        reg = pkg.metrics.Registry()
        kw = dict(incident_dir=str(directory), max_bundles=2, dedup_s=0.0,
                  clock=lambda: clock[0], wall=lambda: 1.7e9 + clock[0], enabled=True)
        rec = pkg.recorder.FlightRecorder("model-server", reg, **kw)
        for i in range(3):
            clock[0] = float(i)
            rec.record("dispatch.stall", model=f"m{i}")
            assert rec.wait_idle(10.0)
        rec.close()
        again = pkg.recorder.FlightRecorder("model-server", pkg.metrics.Registry(), **kw)
        index = again.index()
        views[key] = dict(
            files=sorted(os.listdir(directory)),
            index=[{k: v for k, v in e.items() if k not in _TIMING} for e in index],
            models=[again.get(e["id"])["event"]["attrs"]["model"] for e in index],
            dropped=[m for m in _samples(reg) if m.startswith("kdlt_incident_dropped")])
        again.close()
    assert views["port"] == views["jax"]
    assert views["port"]["models"] == ["m2", "m1"] and len(views["port"]["files"]) == 2
    assert 'kdlt_incident_dropped_total{trigger="dispatch-stall"} 1.0' in views["port"]["dropped"]


def test_parse_triggers_and_merge_windows_match_jax():
    for spec in ("", "dispatch-stall", "burn-crossing=2.5,brownout=2"):
        assert port_recorder.parse_triggers(spec) == jax_recorder.parse_triggers(spec)
    for mod in (port_recorder, jax_recorder):
        with pytest.raises(ValueError):
            mod.parse_triggers("no-such-trigger")
    entries = [{"id": i, "trigger": t, "fired_at_s": s}
               for i, (t, s) in enumerate([("a", 0.0), ("b", 10.0), ("a", 100.0)])]
    assert port_recorder.merge_windows(entries) == jax_recorder.merge_windows(entries)


# --- FLOPs per image and the MFU accountant ----------------------------------


def _jax_flops_per_image(kw: dict) -> float:
    """The JAX package's count: lowered cost analysis of the exact graph at
    batch 1, on abstract variables (no init, no compile)."""
    from kubernetes_deep_learning_tpu.models import build_forward as jax_build_forward
    from kubernetes_deep_learning_tpu.models import init_variables as jax_init_variables

    spec = JaxModelSpec(**kw)
    variables = jax.eval_shape(lambda: jax_init_variables(spec, 0))
    x = jax.ShapeDtypeStruct((1, *spec.input_shape), jnp.uint8)
    return jax_flops.lowered_flops_per_image(
        jax.jit(jax_build_forward(spec, dtype=jnp.float32, fast=False)), 1, variables, x)


@pytest.mark.parametrize("which", ["clothing-model-299", "vit-tiny-32"])
def test_flops_per_image_match_jax_within_2_percent(which):
    if which == "clothing-model-299":
        kw = {f: getattr(CLOTHING_MODEL, f) for f in (
            "name", "family", "input_shape", "labels", "preprocessing", "head_hidden")}
    else:
        kw = dict(name="obs-vit-tiny", family="vit-tiny", input_shape=(32, 32, 3),
                  labels=tuple("abcdefghij"), preprocessing="tf")
    got, want = port_flops.flops_per_image(ModelSpec(**kw)), _jax_flops_per_image(kw)
    assert abs(got / want - 1.0) < 0.02, (got, want)


def test_mfu_accountant_matches_jax(monkeypatch):
    """The same observe sequence (clock injected into both modules) gives the
    same per-bucket MFU and busy gauges; the JAX accountant's background
    FLOPs worker is primed first."""
    clock = [50.0]
    flops_img = 16.8e9
    snapshots, samples = {}, {}
    for key, pkg in PKGS.items():
        monkeypatch.setattr(pkg.flops, "time", SimpleNamespace(monotonic=lambda: clock[0]))
        clock[0] = 50.0
        reg = pkg.metrics.Registry().with_labels(model="m", version="1")
        if key == "jax":
            acc = pkg.flops.MfuAccountant(reg, 989.4, lambda bucket: flops_img, enabled=True)
            for b in (1, 16, 32):
                with acc._lock:
                    acc._ensure_flops_locked(b)
            deadline = time.monotonic() + 10
            while any(acc.flops_estimate(b) is None for b in (1, 16, 32)):
                assert time.monotonic() < deadline
                time.sleep(0.01)
        else:
            acc = pkg.flops.MfuAccountant(reg, 989.4, enabled=True)
            acc.set_flops_per_image(flops_img)
        rng = np.random.default_rng(5)
        for _ in range(200):
            clock[0] += float(rng.uniform(0.001, 0.02))
            b = int(rng.choice([1, 16, 32]))
            acc.observe(b, int(rng.integers(1, b + 1)), b * 6.5e-4 * float(rng.uniform(0.8, 1.2)))
        snapshots[key], samples[key] = acc.snapshot(), _samples(reg)
    assert snapshots["port"] == snapshots["jax"] and set(snapshots["port"]) == {1, 16, 32}
    assert samples["port"] == samples["jax"]
    assert port_flops.peak_tflops(port_flops.torch.device("cpu"), "bfloat16") is None


# --- the served path: the JAX gateway in front of the port server -----------


def _vit_spec(name: str) -> ModelSpec:
    return ModelSpec(name=name, family="vit-tiny", input_shape=(16, 16, 3), labels=("a", "b"),
                     preprocessing="tf")


def _port_server(root, spec, **kw) -> ModelServer:
    art.save_artifact(art.version_dir(str(root), spec.name, 1), spec,
                      init_variables(spec, seed=0), {"compute_dtype": "float32"})
    server = ModelServer(str(root), port=0, buckets=(1, 2), device="cpu", max_delay_ms=1.0, **kw)
    server.start()
    server.warmup()
    return server


@pytest.fixture(scope="module")
def stack(tmp_path_factory):
    """The port server (tiny ViT) behind the JAX gateway, a JAX server over a
    stub engine for the routes' parity, and an image server."""
    from PIL import Image

    tmp = tmp_path_factory.mktemp("obs")
    spec = _vit_spec("obs-vit")
    profiles = tmp / "profiles"
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("KDLT_PROFILE_DIR", str(profiles))
        server = _port_server(tmp / "port", spec)
    gateway = Gateway(serving_host=f"127.0.0.1:{server.port}", model=spec.name, port=0,
                      host="127.0.0.1", cache=False)
    gateway.start()
    jspec = register_spec(JaxModelSpec(name="obs-stub", family="xception",
                                       input_shape=(16, 16, 3), labels=("a", "b")))
    jroot = str(tmp / "jax")
    jax_art.save_artifact(jax_art.version_dir(jroot, jspec.name, 1), jspec, {"params": {}},
                          None, {})
    jax_server = JaxModelServer(
        jroot, port=0, buckets=(1, 2), max_delay_ms=1.0, host="127.0.0.1",
        batcher_impl="python", profile_base=str(tmp / "jax-profiles"),
        engine_factory=lambda a, **kw: StubEngine(a, device_ms_per_batch=2.0,
                                                  async_device=True, **kw))
    jax_server.warmup()
    jax_server.start()
    img_dir = tmp / "img"
    img_dir.mkdir()
    Image.fromarray(np.random.default_rng(0).integers(0, 256, (24, 24, 3), np.uint8)).save(
        img_dir / "img.png")

    class Quiet(SimpleHTTPRequestHandler):
        def log_message(self, fmt, *args):
            pass

    img_httpd = HTTPServer(("127.0.0.1", 0), partial(Quiet, directory=str(img_dir)))
    threading.Thread(target=img_httpd.serve_forever, daemon=True).start()
    img_url = f"http://127.0.0.1:{img_httpd.server_address[1]}/img.png"
    yield SimpleNamespace(spec=spec, server=server, gateway=gateway, jspec=jspec,
                          jax_server=jax_server, img_url=img_url, profiles=profiles)
    gateway.shutdown()
    server.shutdown()
    jax_server.shutdown()
    img_httpd.shutdown()


def _merged_trace(gateway, rid, want=("server.request", "gateway.request"), timeout_s=5.0):
    """Poll the gateway's merged /debug/trace/<rid> until the names appear
    (the model tier's root span records just after its reply is sent)."""
    base = f"http://127.0.0.1:{gateway.port}"
    deadline = time.monotonic() + timeout_s
    spans: list = []
    while time.monotonic() < deadline:
        r = requests.get(f"{base}/debug/trace/{rid}", timeout=5)
        if r.status_code == 200:
            spans = r.json()["spans"]
            if all(w in [s["name"] for s in spans] for w in want):
                return spans
        time.sleep(0.02)
    return spans


def test_jax_gateway_merges_the_port_servers_waterfall(stack):
    """The assertions of the JAX package's
    ``tests/test_trace.py::test_single_request_merged_waterfall``, with the
    port's server as the model tier."""
    rid = "obs-waterfall-1"
    r = requests.post(f"http://127.0.0.1:{stack.gateway.port}/predict",
                      json={"url": stack.img_url}, headers={REQUEST_ID_HEADER: rid}, timeout=30)
    assert r.status_code == 200, r.text
    assert r.headers[REQUEST_ID_HEADER] == rid
    assert "gateway.request;dur=" in r.headers[TRACE_HEADER]
    spans = _merged_trace(stack.gateway, rid)
    assert len(spans) >= 8, [s["name"] for s in spans]
    by_name = {s["name"]: s for s in spans}
    by_id = {s["span_id"]: s for s in spans}
    roots = [s for s in spans if s.get("parent_id") not in by_id]
    assert [s["name"] for s in roots] == ["gateway.request"]
    up = by_name["gateway.upstream"]
    assert by_name["server.request"]["parent_id"] == up["span_id"]
    assert up["parent_id"] == by_name["gateway.request"]["span_id"]
    assert up["tags"]["winner"] is True and up["tags"]["status"] == 200
    srv_root = by_name["server.request"]["span_id"]
    predict = by_name["server.predict"]
    assert predict["parent_id"] == srv_root
    assert by_name["server.admission"]["parent_id"] == srv_root
    assert by_name["server.decode"]["parent_id"] == srv_root
    assert by_name["batcher.queue_wait"]["parent_id"] == predict["span_id"]
    stages = [by_name[f"pipeline.{s}"] for s in ("enqueue_wait", "dispatch", "execute",
                                                 "readback")]
    for st in stages:
        assert st["parent_id"] == predict["span_id"] and st["tier"] == "model-server"
    for a, b in zip(stages, stages[1:]):
        assert b["start_s"] >= a["start_s"] + a["dur_ms"] / 1e3 - 2e-6, (a["name"], b["name"])
    assert stages[0]["start_s"] >= predict["start_s"] - 2e-6
    gw_seq = [by_name["gateway.admission"], by_name["gateway.preprocess"], up]
    for a, b in zip(gw_seq, gw_seq[1:]):
        assert b["start_s"] >= a["start_s"] + a["dur_ms"] / 1e3 - 2e-6


def _get(port: int, path: str) -> tuple[int, dict]:
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=30) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _wait_for_root(port: int, rid: str, timeout_s: float = 5.0) -> None:
    """Until the request's root span (recorded after the reply) is in."""
    deadline = time.monotonic() + timeout_s
    while not any(s["name"] == "server.request"
                  for s in _get(port, f"/debug/trace/{rid}")[1].get("spans", [])):
        assert time.monotonic() < deadline, rid
        time.sleep(0.02)


def _post_predict(port: int, name: str, spec, rid: str, parent: str | None = None):
    headers = {"Content-Type": protocol.MSGPACK_CONTENT_TYPE, REQUEST_ID_HEADER: rid}
    if parent:
        headers[PARENT_SPAN_HEADER] = parent
    body = protocol.encode_predict_request(np.zeros((1, *spec.input_shape), np.uint8))
    return requests.post(f"http://127.0.0.1:{port}/v1/models/{name}:predict", data=body,
                         headers=headers, timeout=30)


def test_debug_routes_answer_as_the_jax_server(stack):
    """Each /debug route: the JAX server's status and keys.  A traced
    predict echoes its id, carries the span summary and nests under the
    caller's parent span."""
    servers = {"port": (stack.server, stack.spec), "jax": (stack.jax_server, stack.jspec)}
    for key, (server, spec) in servers.items():
        r = _post_predict(server.port, spec.name, spec, f"obs-{key}-1", parent="feedbeef")
        assert r.status_code == 200 and r.headers[REQUEST_ID_HEADER] == f"obs-{key}-1"
        assert "server.predict;dur=" in r.headers[TRACE_HEADER]
    replies = {}
    paths = ("/debug", "/debug/", "/debug/slo", "/debug/incidents", "/debug/incidents/nope",
             "/debug/trace/never-seen", "/debug/profile?seconds=0", "/debug/profile?seconds=x",
             "/debug/profile?audit=buckets")
    for key, (server, spec) in servers.items():
        _wait_for_root(server.port, f"obs-{key}-1")
        replies[key] = {p: _get(server.port, p) for p in (*paths, f"/debug/trace/obs-{key}-1")}
    for p in paths:
        (want_status, want), (status, got) = replies["jax"][p], replies["port"][p]
        assert status == want_status, p
        assert got.keys() == want.keys(), p
    assert replies["port"]["/debug/trace/never-seen"][0] == 404
    assert replies["port"]["/debug/slo"][1]["models"][stack.spec.name]["5m"]["good"] >= 1
    (_, jax_trace_), (status, port_trace_) = (replies["jax"]["/debug/trace/obs-jax-1"],
                                              replies["port"]["/debug/trace/obs-port-1"])
    assert status == 200 and port_trace_.keys() == jax_trace_.keys()
    assert {k for s in port_trace_["spans"] for k in s} == {k for s in jax_trace_["spans"]
                                                            for k in s}
    by_name = {s["name"]: s for s in port_trace_["spans"]}
    assert by_name["server.request"]["parent_id"] == "feedbeef"
    audit = replies["port"]["/debug/profile?audit=buckets"][1]["models"][stack.spec.name]
    assert set(audit["buckets"]["1"]) == {"batches", "mean_admitted", "padding_waste_ratio",
                                          "flops_per_image"}
    assert audit["buckets"]["1"]["flops_per_image"] > 0
    text = stack.server.handle_get("/metrics")[1].decode()
    for series in ("kdlt_trace_retained_total", "kdlt_slo_goodput_ratio",
                   "kdlt_incident_open", "kdlt_device_busy_ratio",
                   "kdlt_server_request_seconds_bucket"):
        assert series in text, series


def test_debug_profile_writes_a_chrome_trace_and_refuses_when_off(stack, monkeypatch):
    status, got = _get(stack.server.port, "/debug/profile?seconds=0.2")
    assert status == 200 and got["seconds"] == 0.2 and "kernels" in got
    assert os.path.dirname(got["trace_dir"]) == str(stack.profiles)
    with open(os.path.join(got["trace_dir"], "trace.json")) as f:
        assert "traceEvents" in json.load(f)
    r = requests.post(f"http://127.0.0.1:{stack.server.port}/debug/profile",
                      json={"seconds": 0.1}, timeout=30)
    assert r.status_code == 200 and r.json()["seconds"] == 0.1
    for server in (stack.server, stack.jax_server):
        monkeypatch.setattr(server, "_profile_base", None)
        assert _get(server.port, "/debug/profile?seconds=1")[0] == 404
        assert _get(server.port, "/debug/profile?audit=buckets")[0] == 200


def test_exemplars_ride_the_latency_histogram_when_asked(stack, monkeypatch):
    monkeypatch.setenv("KDLT_METRICS_EXEMPLARS", "1")
    _post_predict(stack.server.port, stack.spec.name, stack.spec, "obs-exemplar")
    _wait_for_root(stack.server.port, "obs-exemplar")  # the histogram is fed after the reply
    text = stack.server.handle_get("/metrics")[1].decode()
    assert any(line.startswith("kdlt_server_request_seconds_bucket")
               and '# {trace_id="obs-exemplar"}' in line for line in text.splitlines())
    monkeypatch.delenv("KDLT_METRICS_EXEMPLARS")
    assert 'trace_id="' not in stack.server.handle_get("/metrics")[1].decode()


def test_a_dispatch_stall_yields_one_incident_bundle(tmp_path):
    """A stalled dispatcher: every request gets the stall 503, the first
    one's ``dispatch.stall`` event captures ONE bundle with its trace pinned,
    the second is folded by the trigger's dedup window."""
    spec = _vit_spec("obs-stall")
    server = _port_server(tmp_path, spec, incident_dir=str(tmp_path / "incidents"))
    try:
        server.dispatcher.declare_stall()
        for rid in ("stall-1", "stall-2"):
            r = _post_predict(server.port, spec.name, spec, rid)
            assert r.status_code == 503 and r.headers[protocol.STALLED_HEADER] == "1"
            assert r.headers[REQUEST_ID_HEADER] == rid
            assert server.recorder.wait_idle(10.0)
        status, payload = _get(server.port, "/debug/incidents")
        assert status == 200 and len(payload["incidents"]) == 1
        entry = payload["incidents"][0]
        assert entry["trigger"] == "dispatch-stall" and entry["traces"] == ["stall-1"]
        status, bundle = _get(server.port, f"/debug/incidents/{entry['id']}")
        assert status == 200 and bundle["event"]["kind"] == "dispatch.stall"
        assert bundle["event"]["rid"] == "stall-1"
        assert {"slo", "scheduler"} <= set(bundle["snapshots"])
        assert os.listdir(tmp_path / "incidents") == [entry["id"] + ".json"]
        text = server.handle_get("/metrics")[1].decode()
        assert 'kdlt_incident_suppressed_total{trigger="dispatch-stall"} 1.0' in text
    finally:
        server.shutdown()
