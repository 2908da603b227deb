"""The port's serving slice on the CPU: artifact, engine, wire, server.

- ``load_artifact`` reads what the JAX exporter writes (flax msgpack) leaf
  for leaf, and writes what flax reads;
- the committed golden fixture passes through the port engine in float32
  (rtol/atol 2e-3, as ``test_golden_fixture.py``);
- the unchanged JAX ``Gateway`` pointed at the port's model server returns
  ``{label: score}`` within 1e-3 of the JAX forward in float32;
- importing the port loads neither jax, flax nor the JAX package;
- the port server's error replies (400, the overload 503, the stall 503)
  carry the JAX server's JSON body keys and ``Retry-After`` header for the
  same fault, and ``/metrics`` serves the registry.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
import urllib.error
import urllib.request
from functools import partial
from http.server import HTTPServer, SimpleHTTPRequestHandler

import jax
import msgpack
import numpy as np
import pytest

from kubernetes_deep_learning_tpu.export import artifact as jax_art
from kubernetes_deep_learning_tpu.export import export_model
from kubernetes_deep_learning_tpu.models import init_variables as jax_init_variables
from kubernetes_deep_learning_tpu.modelspec import ModelSpec as JaxModelSpec
from kubernetes_deep_learning_tpu.modelspec import register_spec
from kubernetes_deep_learning_tpu.serving import protocol as jax_protocol
from kubernetes_deep_learning_tpu_torch import msgpack_lite
from kubernetes_deep_learning_tpu_torch.export import artifact as art
from kubernetes_deep_learning_tpu_torch.modelspec import CLOTHING_MODEL, ModelSpec
from kubernetes_deep_learning_tpu_torch.runtime import InferenceEngine
from kubernetes_deep_learning_tpu_torch.serving import protocol
from kubernetes_deep_learning_tpu_torch.serving.model_server import ModelServer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_SPEC_KW = dict(
    name="torch-e2e-xception",
    family="xception",
    input_shape=(96, 96, 3),
    labels=("dress", "hat", "pants", "shirt"),
    preprocessing="tf",
    resize_filter="nearest",
)


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in
            jax.tree_util.tree_leaves_with_path(tree)}


# --- codec and artifact -------------------------------------------------------


@pytest.mark.parametrize(
    "obj",
    [
        {"inputs": {"shape": [2, 3], "dtype": "uint8", "data": bytes(range(6))}},
        [None, True, False, 0, 127, 128, 65536, 2**40, -1, -33, -2**40, 1.5, "é" * 40],
        {"k" * 300: list(range(20)), "m": {str(i): i for i in range(20)}},
        b"x" * 70000,
    ],
)
def test_msgpack_lite_matches_msgpack(obj):
    assert msgpack.unpackb(msgpack_lite.packb(obj), strict_map_key=False) == obj
    assert msgpack_lite.unpackb(msgpack.packb(obj, use_bin_type=True)) == obj


def test_msgpack_lite_reads_and_writes_flax_format():
    import flax.serialization
    import jax.numpy as jnp

    tree = {
        "params": {"a": {"kernel": np.arange(24, dtype=np.float32).reshape(2, 3, 4)}},
        "batch_stats": {"a": {"mean": np.float32(3.5) * np.ones(4, np.float32)}},
        "half": np.asarray(jnp.linspace(-3, 3, 7, dtype=jnp.bfloat16)),
        "step": np.int32(7),
    }
    back = msgpack_lite.unpackb(flax.serialization.msgpack_serialize(tree))
    for k, v in _leaves(tree).items():
        np.testing.assert_array_equal(_leaves(back)[k], np.asarray(v, np.float32 if
                                      v.dtype == jnp.bfloat16 else v.dtype))
    del tree["half"]  # the port writes float32 only
    again = flax.serialization.msgpack_restore(msgpack_lite.packb(tree))
    for k, v in _leaves(tree).items():
        np.testing.assert_array_equal(_leaves(again)[k], v)


@pytest.mark.parametrize("params_dtype", [None, "bfloat16"])
def test_load_artifact_matches_jax(tmp_path, params_dtype):
    import jax.numpy as jnp

    from kubernetes_deep_learning_tpu.export.exporter import cast_params

    spec = JaxModelSpec(**_SPEC_KW)
    variables = jax_init_variables(spec, seed=1)
    if params_dtype:
        variables = cast_params(variables, jnp.bfloat16)
    d = str(tmp_path / "1")
    jax_art.save_artifact(d, spec, variables, None, {"compute_dtype": "float32"})
    want = jax_art.load_artifact(d)
    got = art.load_artifact(d)
    assert got.spec == ModelSpec.from_json(spec.to_json())
    assert got.metadata == want.metadata
    lw, lg = _leaves(want.variables), _leaves(got.variables)
    assert lw.keys() == lg.keys()
    for k in lw:
        np.testing.assert_array_equal(lg[k], lw[k].astype(np.float32))


def test_save_artifact_round_trips_through_jax_loader(tmp_path):
    from kubernetes_deep_learning_tpu_torch.models import init_variables

    spec = ModelSpec(**_SPEC_KW)
    variables = init_variables(spec, seed=2)
    d = art.save_artifact(str(tmp_path / "m" / "3"), spec, variables, {"compute_dtype": "float32"})
    loaded = jax_art.load_artifact(d)
    assert loaded.spec.to_json() == spec.to_json()
    for k, v in _leaves(variables).items():
        np.testing.assert_array_equal(_leaves(loaded.variables)[k], v)
    assert art.scan_versions(str(tmp_path), "m") == [3]
    assert art.latest_version(str(tmp_path), "m") == 3
    assert art.latest_version(str(tmp_path), "absent") is None


def test_clothing_spec_round_trips_with_jax_spec():
    from kubernetes_deep_learning_tpu.modelspec import CLOTHING_MODEL as JAX_CLOTHING

    assert CLOTHING_MODEL.to_json() == JAX_CLOTHING.to_json()
    assert ModelSpec.from_json(JAX_CLOTHING.to_json()) == CLOTHING_MODEL


# --- wire ---------------------------------------------------------------------


def test_protocol_is_byte_compatible_with_jax():
    rng = np.random.default_rng(0)
    imgs = rng.integers(0, 256, (2, 4, 4, 3), np.uint8)
    body = jax_protocol.encode_predict_request(imgs)
    np.testing.assert_array_equal(
        protocol.decode_predict_request(body, protocol.MSGPACK_CONTENT_TYPE), imgs
    )
    np.testing.assert_array_equal(
        jax_protocol.decode_predict_request(protocol.encode_predict_request(imgs),
                                            protocol.MSGPACK_CONTENT_TYPE), imgs
    )
    logits = rng.normal(size=(2, 3)).astype(np.float32)
    for ctype in (protocol.MSGPACK_CONTENT_TYPE, protocol.JSON_CONTENT_TYPE):
        out, got_ctype = protocol.encode_predict_response(logits, ("a", "b", "c"), ctype)
        got, labels = jax_protocol.decode_predict_response(out, got_ctype)
        np.testing.assert_allclose(got, logits, rtol=1e-6)
        assert labels == ["a", "b", "c"]
    with pytest.raises(ValueError, match="0, 255"):
        protocol.decode_predict_request(b'{"instances": [[300]]}', protocol.JSON_CONTENT_TYPE)
    with pytest.raises(ValueError, match="content type"):
        protocol.decode_predict_request(b"", "text/csv")


# --- engine -------------------------------------------------------------------


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    """A float32 artifact exported by the JAX exporter, and its variables."""
    spec = register_spec(JaxModelSpec(**_SPEC_KW))
    root = tmp_path_factory.mktemp("models")
    variables = jax_init_variables(spec, seed=5)
    export_model(spec, variables, str(root), dtype=np.float32)
    return spec, str(root), variables


def test_engine_pads_to_buckets_and_matches_jax(exported):
    from kubernetes_deep_learning_tpu.models import build_forward as jax_build_forward

    spec, root, variables = exported
    engine = InferenceEngine(
        art.load_artifact(art.version_dir(root, spec.name, 1)), buckets=(1, 4), device="cpu"
    )
    assert not engine.fast and not engine.ready
    engine.warmup()
    assert engine.ready
    assert [engine.bucket_for(n) for n in (1, 2, 4)] == [1, 4, 4]
    with pytest.raises(ValueError, match="exceeds max bucket"):
        engine.bucket_for(5)
    rng = np.random.default_rng(3)
    imgs = rng.integers(0, 256, (3, *spec.input_shape), np.uint8)
    handle, n = engine.predict_async(imgs)
    assert n == 3 and np.asarray(handle).shape == (4, 4)
    want = np.asarray(jax.jit(jax_build_forward(spec, dtype=None))(variables, imgs))
    np.testing.assert_allclose(np.asarray(handle)[:n], want, rtol=1e-3, atol=1e-3)
    from kubernetes_deep_learning_tpu.ops.preprocess import normalize

    np.testing.assert_allclose(
        engine.predict(normalize(imgs, "tf").astype(np.float32)), want, rtol=1e-3, atol=1e-3
    )
    scores = engine.predict_scores(imgs[:1])
    assert list(scores[0]) == list(spec.labels)
    with pytest.raises(ValueError, match="expected"):
        engine.predict(imgs[:, :10])
    with pytest.raises(ValueError, match="unsupported"):
        engine.predict(imgs.astype(np.int16))


def test_golden_fixture_through_port_engine(tmp_path):
    """test_golden_fixture.py's chain up to the artifact (variables -> Keras
    .h5 -> importer -> exporter), then the port's engine in float32."""
    from test_golden_fixture import GOLDEN_PATH, SPEC, _deterministic_variables, _golden_inputs
    from test_keras_import import _flax_to_keras_h5

    from kubernetes_deep_learning_tpu.models.keras_import import load_keras_h5

    spec = register_spec(SPEC)
    h5_path = str(tmp_path / "golden.h5")
    _flax_to_keras_h5(h5_path, _deterministic_variables(spec))
    root = str(tmp_path / "models")
    export_model(spec, load_keras_h5(spec, h5_path), root, dtype=np.float32)
    engine = InferenceEngine(
        art.load_artifact(art.version_dir(root, spec.name, 1)), buckets=(2,), device="cpu"
    )
    engine.warmup()
    got = engine.predict(_golden_inputs(spec))
    with open(GOLDEN_PATH) as f:
        golden = json.load(f)
    assert got.shape == tuple(golden["shape"])
    np.testing.assert_allclose(got, np.asarray(golden["logits"], np.float32), rtol=2e-3, atol=2e-3)


# --- server and gateway -------------------------------------------------------


@pytest.fixture(scope="module")
def stack(exported, tmp_path_factory):
    """Port model server + the JAX package's gateway + a local image host."""
    from PIL import Image

    from kubernetes_deep_learning_tpu.serving.gateway import Gateway

    spec, root, variables = exported
    server = ModelServer(root, port=0, buckets=(1, 2, 4), device="cpu")
    server.start()
    server.warmup()
    gateway = Gateway(serving_host=f"localhost:{server.port}", model=spec.name, port=0)
    gateway.start()
    img_dir = tmp_path_factory.mktemp("images")
    pixels = np.random.default_rng(0).integers(0, 256, size=(120, 80, 3), dtype=np.uint8)
    Image.fromarray(pixels).save(img_dir / "pants.png")
    img_httpd = HTTPServer(
        ("127.0.0.1", 0), partial(SimpleHTTPRequestHandler, directory=str(img_dir))
    )
    threading.Thread(target=img_httpd.serve_forever, daemon=True).start()
    image_url = f"http://127.0.0.1:{img_httpd.server_address[1]}/pants.png"
    yield spec, server, gateway, image_url, pixels, variables
    gateway.shutdown()
    server.shutdown()
    img_httpd.shutdown()
    img_httpd.server_close()


def test_jax_gateway_on_port_server_matches_jax_forward(stack):
    from kubernetes_deep_learning_tpu.models import build_forward as jax_build_forward
    from kubernetes_deep_learning_tpu.ops import preprocess
    from kubernetes_deep_learning_tpu.serving.client import predict_url

    spec, _, gateway, image_url, pixels, variables = stack
    scores = predict_url(f"http://localhost:{gateway.port}", image_url)
    assert set(scores) == set(spec.labels)
    img = preprocess.resize_uint8(pixels, spec.input_shape[:2], "nearest")
    want = np.asarray(jax.jit(jax_build_forward(spec, dtype=None))(variables, img[None]))[0]
    got = np.asarray([scores[label] for label in spec.labels], np.float32)
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3)


def _http(method, url, body=None, ctype=None):
    req = urllib.request.Request(url, data=body, method=method)
    if ctype:
        req.add_header("Content-Type", ctype)
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, r.read(), r.headers.get("Content-Type", "")
    except urllib.error.HTTPError as e:
        return e.code, e.read(), e.headers.get("Content-Type", "")


def test_model_server_routes(stack):
    spec, server, _, _, _, _ = stack
    base = f"http://127.0.0.1:{server.port}"
    assert _http("GET", f"{base}/healthz")[0] == 200
    assert _http("GET", f"{base}/readyz")[0] == 200
    status, body, _ = _http("GET", f"{base}/v1/models")
    assert status == 200 and json.loads(body)["models"] == [
        {"name": spec.name, "version": 1, "ready": True}
    ]
    status, body, _ = _http("GET", f"{base}/v1/models/{spec.name}")
    assert status == 200 and JaxModelSpec.from_json(body.decode()) == spec
    assert _http("GET", f"{base}/v1/models/nope")[0] == 404
    imgs = np.zeros((3, *spec.input_shape), np.uint8)
    status, body, ctype = _http("POST", f"{base}/v1/models/{spec.name}:predict",
                                jax_protocol.encode_predict_request(imgs),
                                protocol.MSGPACK_CONTENT_TYPE)
    assert status == 200
    logits, labels = jax_protocol.decode_predict_response(body, ctype)
    assert logits.shape == (3, 4) and labels == list(spec.labels)
    status, body, _ = _http("POST", f"{base}/v1/models/{spec.name}:predict",
                            json.dumps({"instances": imgs[:1].tolist()}).encode(),
                            protocol.JSON_CONTENT_TYPE)
    assert status == 200 and len(json.loads(body)["predictions"]) == 1
    too_many = np.zeros((5, *spec.input_shape), np.uint8)  # past the largest bucket (4)
    status, body, ctype = _http("POST", f"{base}/v1/models/{spec.name}:predict",
                                protocol.encode_predict_request(too_many),
                                protocol.MSGPACK_CONTENT_TYPE)
    assert status == 200 and protocol.decode_predict_response(body, ctype)[0].shape == (5, 4)
    assert _http("POST", f"{base}/v1/models/nope:predict", b"{}",
                 protocol.JSON_CONTENT_TYPE)[0] == 404


def test_batch_past_the_largest_bucket_is_served_in_chunks(stack):
    """5 images against buckets (1, 2, 4): 200, served as 4 + 1, and the
    logits of every image match the JAX forward (the gateway test's 1e-3)."""
    from kubernetes_deep_learning_tpu.models import build_forward as jax_build_forward

    spec, server, _, _, _, variables = stack
    imgs = np.random.default_rng(11).integers(0, 256, (5, *spec.input_shape), np.uint8)
    status, body, ctype = _http("POST", f"http://127.0.0.1:{server.port}/v1/models/"
                                f"{spec.name}:predict", protocol.encode_predict_request(imgs),
                                protocol.MSGPACK_CONTENT_TYPE)
    assert status == 200
    got, labels = jax_protocol.decode_predict_response(body, ctype)
    assert labels == list(spec.labels)
    want = np.asarray(jax.jit(jax_build_forward(spec, dtype=None))(variables, imgs))
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3)


def test_keep_alive_requests_do_not_stall_on_nagle(tmp_path):
    """30 one-image msgpack :predicts over ONE keep-alive connection: p50
    under 30 ms.  Without TCP_NODELAY each reply's body write waits for the
    client's delayed ACK (>= 40 ms on Linux).  The model is a 16-px
    vit-tiny, whose CPU forward takes a few ms, so the bound measures the
    server and not the model."""
    import http.client
    import time

    from kubernetes_deep_learning_tpu_torch.models import init_variables

    spec = ModelSpec(name="torch-nodelay-vit", family="vit-tiny", input_shape=(16, 16, 3),
                     labels=("a", "b"), preprocessing="tf")
    art.save_artifact(art.version_dir(str(tmp_path), spec.name, 1), spec,
                      init_variables(spec, seed=0), {"compute_dtype": "float32"})
    server = ModelServer(str(tmp_path), port=0, buckets=(1,), device="cpu")
    server.start()
    server.warmup()
    conn = http.client.HTTPConnection("127.0.0.1", server.port, timeout=60)
    try:
        body = protocol.encode_predict_request(np.zeros((1, *spec.input_shape), np.uint8))
        headers = {"Content-Type": protocol.MSGPACK_CONTENT_TYPE}
        lat = []
        for _ in range(30):
            t0 = time.perf_counter()
            conn.request("POST", f"/v1/models/{spec.name}:predict", body, headers)
            resp = conn.getresponse()
            reply = resp.read()
            lat.append((time.perf_counter() - t0) * 1e3)
            assert resp.status == 200
        logits, _ = protocol.decode_predict_response(reply, resp.getheader("Content-Type"))
        assert logits.shape == (1, 2)
    finally:
        conn.close()
        server.shutdown()
    assert float(np.median(lat)) < 30.0, sorted(lat)


# --- import guard ---------------------------------------------------------------


def test_port_imports_no_jax_flax_or_jax_package():
    """Every port module (and chip_smoke.py, mbconv_ablation.py,
    entry_ablation.py) imports without jax, flax, optax, orbax, msgpack,
    PIL or the JAX package: none of them is on the GPU machine.  The port's own name starts with the JAX
    package's, so match the package name exactly or with a trailing dot."""
    code = """
import importlib, pkgutil, sys
import kubernetes_deep_learning_tpu_torch as pkg
for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    importlib.import_module(m.name)
import chip_smoke
import mbconv_ablation
import entry_ablation
bad = sorted(
    k for k in sys.modules
    for root in ("jax", "flax", "optax", "orbax", "msgpack", "PIL",
                 "kubernetes_deep_learning_tpu")
    if k == root or k.startswith(root + ".")
)
training = {"kubernetes_deep_learning_tpu_torch.training." + m
            for m in ("trainer", "loop", "data", "checkpoint")}
assert training <= set(sys.modules), training - set(sys.modules)
print(len([k for k in sys.modules if k.startswith("kubernetes_deep_learning_tpu_torch.")]))
assert not bad, bad
"""
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120,
        env={**os.environ, "PYTHONPATH": REPO},
    )
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 22  # every module was really imported


def test_model_server_gates_on_warmup(exported):
    """Before warmup /readyz says 503 and :predict refuses; /healthz is up."""
    spec, root, _ = exported
    server = ModelServer(root, port=0, buckets=(1,), device="cpu")
    try:
        assert server.handle_get("/healthz")[0] == 200
        assert server.handle_get("/readyz")[0] == 503
        body = protocol.encode_predict_request(np.zeros((1, *spec.input_shape), np.uint8))
        status = server.handle_predict(
            f"/v1/models/{spec.name}:predict", body, protocol.MSGPACK_CONTENT_TYPE
        )[0]
        assert status == 503
        server.warmup()
        assert server.handle_get("/readyz")[0] == 200
    finally:
        server.shutdown()


def test_model_server_needs_a_model(tmp_path):
    with pytest.raises(ValueError, match="no model versions"):
        ModelServer(str(tmp_path), port=0, device="cpu")


# --- error replies, against the JAX server -------------------------------------


@pytest.fixture(scope="module")
def error_servers(exported, tmp_path_factory):
    """The JAX model server (a stub engine: its error paths need no model)
    and the port's, each serving one model, under default settings."""
    from kubernetes_deep_learning_tpu.runtime.stub import StubEngine
    from kubernetes_deep_learning_tpu.serving.model_server import ModelServer as JaxModelServer

    spec, root, _ = exported
    jax_root = str(tmp_path_factory.mktemp("jax-models"))
    jax_art.save_artifact(jax_art.version_dir(jax_root, spec.name, 1), spec, {"params": {}},
                          None, {})
    jax_server = JaxModelServer(jax_root, port=0, buckets=(1,), host="127.0.0.1",
                                engine_factory=lambda a, **kw: StubEngine(a, **kw))
    jax_server.warmup()
    jax_server.start()
    port_server = ModelServer(root, port=0, buckets=(1,), device="cpu")
    port_server.start()
    port_server.warmup()
    yield spec, jax_server, port_server
    port_server.shutdown()
    jax_server.shutdown()


def _raise(exc):
    def predict(*args, **kwargs):
        raise exc
    return predict


def _post_raw(port, name, body):
    req = urllib.request.Request(f"http://127.0.0.1:{port}/v1/models/{name}:predict",
                                 data=body, method="POST",
                                 headers={"Content-Type": protocol.MSGPACK_CONTENT_TYPE})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, r.headers, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers, e.read()


@pytest.mark.parametrize("fault", ["bad-request", "overload", "stall"])
def test_error_replies_match_the_jax_server(error_servers, monkeypatch, fault):
    """The same fault at both servers: the same status, a JSON body with the
    same keys, and the same ``Retry-After`` and ``X-Kdlt-Stalled`` headers.
    The overload hint is the one the JAX server sends under its default
    admission settings: its limiter's idle value, which it jitters by
    +-25%; the test pins that jitter to its centre."""
    from types import SimpleNamespace

    from kubernetes_deep_learning_tpu.runtime import DispatchStall as JaxDispatchStall
    from kubernetes_deep_learning_tpu.runtime import QueueFull as JaxQueueFull
    from kubernetes_deep_learning_tpu.serving.admission import limiter as jax_limiter

    from kubernetes_deep_learning_tpu_torch.runtime import DispatchStall, QueueFull

    spec, jax_server, port_server = error_servers
    assert jax_server.admission.limiter is not None  # the JAX default: a limiter
    monkeypatch.setattr(jax_limiter, "random", SimpleNamespace(uniform=lambda a, b: (a + b) / 2))
    body = protocol.encode_predict_request(np.zeros((1, *spec.input_shape), np.uint8))
    if fault == "bad-request":  # a well-formed tensor of the wrong shape
        body = protocol.encode_predict_request(np.zeros((1, 8, 8, 3), np.uint8))
    else:
        jax_exc, port_exc = ((JaxQueueFull, QueueFull) if fault == "overload"
                             else (JaxDispatchStall, DispatchStall))
        monkeypatch.setattr(jax_server.models[spec.name], "predict",
                            _raise(jax_exc("request queue full")))
        monkeypatch.setattr(port_server.models[spec.name], "predict",
                            _raise(port_exc("request queue full")))
    replies = [_post_raw(s.port, spec.name, body) for s in (jax_server, port_server)]
    (want_status, want_headers, want_body), (status, headers, got_body) = replies
    assert status == want_status == {"bad-request": 400}.get(fault, 503)
    assert headers["Content-Type"] == want_headers["Content-Type"] == protocol.JSON_CONTENT_TYPE
    assert json.loads(got_body).keys() == json.loads(want_body).keys() == {"error"}
    for key in ("Retry-After", protocol.STALLED_HEADER):
        assert headers.get(key) == want_headers.get(key), key
    assert headers.get("Retry-After") == {"bad-request": None, "overload": "0.050",
                                          "stall": "1.000"}[fault]


def test_model_server_routes_answer_json_errors_and_metrics(stack):
    """404s carry ``{"error": ...}``; ``/metrics`` serves the registry's
    Prometheus text, the engine's series included."""
    spec, server, _, _, _, _ = stack
    base = f"http://127.0.0.1:{server.port}"
    for method, path in (("GET", "/nope"), ("GET", "/v1/models/nope"),
                         ("POST", "/v1/models/nope:predict"), ("POST", "/nope")):
        status, body, ctype = _http(method, f"{base}{path}", b"{}" if method == "POST" else None,
                                    protocol.JSON_CONTENT_TYPE if method == "POST" else None)
        assert status == 404 and ctype == protocol.JSON_CONTENT_TYPE
        assert set(json.loads(body)) == {"error"}
    status, body, ctype = _http("GET", f"{base}/metrics")
    assert status == 200 and ctype == "text/plain"
    assert f'kdlt_engine_images_total{{model="{spec.name}"}}' in body.decode()
