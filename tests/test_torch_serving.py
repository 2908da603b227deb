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
  same fault, and ``/metrics`` serves the registry;
- hot reload through ``poll_versions()`` (called directly): replies and
  ``X-Kdlt-Artifact-Hash`` switch at a reload, a reload of one model
  leaves the other untouched, a broken version directory is skipped,
  ``:status`` and ``/v1/models`` equal the JAX server's for the same root,
  the new flags parse, and the unchanged JAX gateway in front drops its
  cached answers after a reload with changed bytes and keeps them after a
  byte-identical version bump.
"""

from __future__ import annotations

import json
import os
import shutil
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
from torch_threads import one_torch_thread  # noqa: F401

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
    status, body, _ = _http("GET", f"{base}/v1/models")  # keyed by name, as in JAX
    models = json.loads(body)
    assert status == 200 and list(models) == [spec.name]
    assert (models[spec.name]["version"], models[spec.name]["ready"]) == (1, True)
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


FORBIDDEN_IMPORTS = ("jax", "flax", "optax", "orbax", "msgpack", "PIL", "requests", "h5py",
                     "kubernetes_deep_learning_tpu")
ROOT_SCRIPTS = ("chip_smoke.py", "mbconv_ablation.py", "entry_ablation.py",
                "observability_ab.py", "host_ab.py")


def _forbidden_imports(path: str) -> list[str]:
    """Every ``import`` and ``from ... import`` of a forbidden package in a
    file, wherever it stands (module level, a function body, a branch),
    as "line: name"; relative imports stay inside the port."""
    import ast

    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    found = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names = [node.module]
        else:
            continue
        for name in names:
            if any(name == root or name.startswith(root + ".") for root in FORBIDDEN_IMPORTS):
                found.append((node.lineno, name))
    return [f"{line}: {name}" for line, name in sorted(found)]


def test_port_source_imports_no_forbidden_package_even_inside_functions():
    """The import test below imports modules, and never runs a function's
    body: a lazy ``import requests`` would pass it and fail on the card.
    So read every ``import`` statement of every port module and of the five
    root scripts."""
    files = [os.path.join(REPO, s) for s in ROOT_SCRIPTS]
    pkg = os.path.join(REPO, "kubernetes_deep_learning_tpu_torch")
    for dirpath, _, names in os.walk(pkg):
        files += [os.path.join(dirpath, n) for n in sorted(names) if n.endswith(".py")]
    assert len(files) >= 60
    bad = {os.path.relpath(f, REPO): hits for f in files if (hits := _forbidden_imports(f))}
    assert not bad, bad


def test_forbidden_import_scan_sees_function_bodies(tmp_path):
    src = tmp_path / "m.py"
    src.write_text("import os\nfrom . import x\nfrom kubernetes_deep_learning_tpu_torch import y\n"
                   "def f():\n    import requests\n    if 1:\n        from PIL import Image\n"
                   "    from kubernetes_deep_learning_tpu.serving import client\n")
    assert _forbidden_imports(str(src)) == [
        "5: requests", "7: PIL", "8: kubernetes_deep_learning_tpu.serving"]


def test_port_imports_no_jax_flax_or_jax_package():
    """Every port module (and chip_smoke.py, mbconv_ablation.py,
    entry_ablation.py, observability_ab.py, host_ab.py) imports without jax, flax, optax,
    orbax, msgpack, PIL, requests, h5py or the JAX package: none of them is on the GPU
    machine.  (``test_port_source_imports_no_forbidden_package_even_inside_functions``
    reads the imports that only a function's call would run.)
    The port's own name starts with the JAX package's, so match the package name exactly
    or with a trailing dot."""
    code = """
import importlib, pkgutil, sys
import kubernetes_deep_learning_tpu_torch as pkg
for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    importlib.import_module(m.name)
import chip_smoke
import mbconv_ablation
import entry_ablation
import observability_ab
import host_ab
bad = sorted(
    k for k in sys.modules
    for root in ("jax", "flax", "optax", "orbax", "msgpack", "PIL", "requests", "h5py",
                 "kubernetes_deep_learning_tpu")
    if k == root or k.startswith(root + ".")
)
training = {"kubernetes_deep_learning_tpu_torch.training." + m
            for m in ("trainer", "loop", "data", "checkpoint")}
assert training <= set(sys.modules), training - set(sys.modules)
slice12 = {"kubernetes_deep_learning_tpu_torch." + m for m in (
    "models.resnet", "serving.admission", "serving.admission.controller",
    "serving.admission.deadline", "serving.admission.limiter", "serving.admission.shed")}
assert slice12 <= set(sys.modules), slice12 - set(sys.modules)
multimodel = {"kubernetes_deep_learning_tpu_torch." + m for m in (
    "runtime.scheduler", "serving.registry")}
assert multimodel <= set(sys.modules), multimodel - set(sys.modules)
observability = {"kubernetes_deep_learning_tpu_torch." + m for m in (
    "utils.trace", "utils.slo", "utils.flightrecorder", "serving.tracing", "runtime.flops")}
assert observability <= set(sys.modules), observability - set(sys.modules)
quantization = {"kubernetes_deep_learning_tpu_torch." + m for m in ("ops.quantize", "ops.int8")}
assert quantization <= set(sys.modules), quantization - set(sys.modules)
gateway = {"kubernetes_deep_learning_tpu_torch." + m for m in (
    "runtime.stub", "ops.preprocess", "ops._native", "serving.gateway", "serving.upstream",
    "serving.cache", "serving.microbatch", "serving.faults", "serving.admission.breaker",
    "serving.httpserver", "runtime.errors")}
assert gateway <= set(sys.modules), gateway - set(sys.modules)
lifecycle = {"kubernetes_deep_learning_tpu_torch." + m for m in (
    "h5lite", "models.keras_import", "export.exporter", "export.inspect", "export.warm",
    "golden", "serving.client", "serving.wsgi", "serving.doctor")}
assert lifecycle <= set(sys.modules), lifecycle - set(sys.modules)
generative = {"kubernetes_deep_learning_tpu_torch." + m for m in (
    "runtime.decode", "serving.generate")}
assert generative <= set(sys.modules), generative - set(sys.modules)
print(len([k for k in sys.modules if k.startswith("kubernetes_deep_learning_tpu_torch.")]))
assert not bad, bad
"""
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120,
        env={**os.environ, "PYTHONPATH": REPO},
    )
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 55  # every module was really imported


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


def _post_raw(port, name, body, headers=None):
    req = urllib.request.Request(f"http://127.0.0.1:{port}/v1/models/{name}:predict",
                                 data=body, method="POST",
                                 headers={"Content-Type": protocol.MSGPACK_CONTENT_TYPE,
                                          **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, r.headers, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers, e.read()


@pytest.mark.parametrize("fault", ["bad-request", "overload", "stall", "deadline", "shed"])
def test_error_replies_match_the_jax_server(error_servers, monkeypatch, fault):
    """The same fault at both servers: the same status, a JSON body with the
    same keys, and the same ``Retry-After`` and ``X-Kdlt-Stalled`` headers.
    "deadline" is an exhausted budget (``X-Request-Deadline-Ms: 0``, the
    504); "shed" the limiter's queue at its cap (a 503 with a shed reason).
    The overload and shed hints are the limiters' derived ones, which both
    servers jitter by +-25%; the test pins the jitter to its centre."""
    from types import SimpleNamespace

    from kubernetes_deep_learning_tpu.runtime import DispatchStall as JaxDispatchStall
    from kubernetes_deep_learning_tpu.runtime import QueueFull as JaxQueueFull
    from kubernetes_deep_learning_tpu.serving.admission import limiter as jax_limiter

    from kubernetes_deep_learning_tpu_torch.runtime import DispatchStall, QueueFull
    from kubernetes_deep_learning_tpu_torch.serving.admission import limiter as port_limiter

    spec, jax_server, port_server = error_servers
    assert jax_server.admission.limiter is not None  # the JAX default: a limiter
    assert port_server.admission.limiter is not None  # and the port's
    centre = SimpleNamespace(uniform=lambda a, b: (a + b) / 2)
    monkeypatch.setattr(jax_limiter, "random", centre)
    monkeypatch.setattr(port_limiter, "random", centre)
    body = protocol.encode_predict_request(np.zeros((1, *spec.input_shape), np.uint8))
    headers = {}
    if fault == "bad-request":  # a well-formed tensor of the wrong shape
        body = protocol.encode_predict_request(np.zeros((1, 8, 8, 3), np.uint8))
    elif fault == "deadline":
        headers = {"X-Request-Deadline-Ms": "0"}
    elif fault == "shed":  # the limiter's waiter cap at 0: every arrival finds it full
        for server in (jax_server, port_server):
            monkeypatch.setattr(server.admission.limiter, "queue_cap", 0)
            monkeypatch.setattr(server.admission.limiter, "_inflight", 10**6)
    else:
        jax_exc, port_exc = ((JaxQueueFull, QueueFull) if fault == "overload"
                             else (JaxDispatchStall, DispatchStall))
        monkeypatch.setattr(jax_server.models[spec.name], "predict",
                            _raise(jax_exc("request queue full")))
        monkeypatch.setattr(port_server.models[spec.name], "predict",
                            _raise(port_exc("request queue full")))
    replies = [_post_raw(s.port, spec.name, body, headers) for s in (jax_server, port_server)]
    (want_status, want_headers, want_body), (status, headers, got_body) = replies
    assert status == want_status == {"bad-request": 400, "deadline": 504}.get(fault, 503)
    assert headers["Content-Type"] == want_headers["Content-Type"] == protocol.JSON_CONTENT_TYPE
    got, want = json.loads(got_body), json.loads(want_body)
    assert got.keys() == want.keys() == (
        {"error", "shed_reason"} if fault in ("deadline", "shed") else {"error"})
    assert got.get("shed_reason") == want.get("shed_reason")
    for key in ("Retry-After", protocol.STALLED_HEADER):
        assert headers.get(key) == want_headers.get(key), key
    assert headers.get("Retry-After") == {"bad-request": None, "overload": "0.050",
                                          "stall": "1.000", "deadline": None,
                                          "shed": "0.050"}[fault]


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
    assert f'kdlt_engine_images_total{{model="{spec.name}",version="1"}}' in body.decode()


# --- admission: deadlines, sheds, drain ------------------------------------------

_DEADLINE = "X-Request-Deadline-Ms"


def _served(exported, argv=(), **kw):
    """A started, warmed port server over the exported artifact, buckets
    (1, 2); ``argv`` goes through the command line's parser."""
    from kubernetes_deep_learning_tpu_torch.serving.model_server import build_server

    spec, root, _ = exported
    if argv:
        server = build_server(["--model-root", root, "--port", "0", "--host", "127.0.0.1",
                               "--buckets", "1,2", "--device", "cpu", *argv])
    else:
        server = ModelServer(root, port=0, buckets=(1, 2), device="cpu", **kw)
    server.start()
    server.warmup()
    return spec, server


def _sample(server, name: str, labels: str) -> float:
    """The sample of ``name`` whose label set is exactly ``labels``."""
    import re

    found = re.search(rf"^{name}\{{{re.escape(labels)}\}} (\S+)$", server.registry.render(),
                      re.M)
    assert found, (name, labels)
    return float(found.group(1))


def _image_body(spec, n=1):
    return protocol.encode_predict_request(np.zeros((n, *spec.input_shape), np.uint8))


def _timeouts(monkeypatch, model) -> list:
    """Record the timeout of every wait for a batch of the served model's
    lane."""
    seen = []
    real = model._wait

    def wait(fut, timeout):
        seen.append(timeout)
        return real(fut, timeout)

    monkeypatch.setattr(model, "_wait", wait)
    return seen


def test_exhausted_deadline_gets_504_before_the_body_is_read(exported):
    """A spent budget is shed at admission: the body is never read, the
    engine never called (its image counter does not move)."""
    spec, server = _served(exported)
    try:
        read = []
        status, body, ctype, _ = server.handle_predict(
            f"/v1/models/{spec.name}:predict", lambda: read.append(1) or b"",
            protocol.MSGPACK_CONTENT_TYPE, {_DEADLINE: "0"})
        assert status == 504 and not read and ctype == protocol.JSON_CONTENT_TYPE
        assert json.loads(body)["shed_reason"] == "deadline_exhausted"
        served = f'model="{spec.name}",version="1"'
        before = _sample(server, "kdlt_engine_images_total", served)
        status, headers, body = _post_raw(server.port, spec.name, _image_body(spec),
                                          {_DEADLINE: "0"})
        assert status == 504 and "Retry-After" not in headers
        assert json.loads(body)["shed_reason"] == "deadline_exhausted"
        assert _sample(server, "kdlt_engine_images_total", served) == before
        assert _sample(server, "kdlt_admission_shed_total",
                       'tier="model-server",shed_reason="deadline_exhausted"') == 2.0
        # A healthy budget on the same server is served.
        assert _post_raw(server.port, spec.name, _image_body(spec),
                         {_DEADLINE: "10000"})[0] == 200
        assert _sample(server, "kdlt_engine_images_total", served) == before + 1
    finally:
        server.shutdown()


def test_shed_keeps_a_kept_alive_connection_usable(exported):
    """Replies made before the body was read (a shed, a 404) drain it, so
    the next request on the same kept-alive connection is parsed whole."""
    import http.client

    spec, server = _served(exported)
    conn = http.client.HTTPConnection("127.0.0.1", server.port, timeout=60)
    try:
        ctype = {"Content-Type": protocol.MSGPACK_CONTENT_TYPE}
        statuses, socks = [], []
        for path, headers in ((f"/v1/models/{spec.name}:predict", {_DEADLINE: "0"}),
                              ("/v1/models/nope:predict", {}),
                              (f"/v1/models/{spec.name}:predict", {_DEADLINE: "-1"}),
                              (f"/v1/models/{spec.name}:predict", {_DEADLINE: "10000"})):
            conn.request("POST", path, _image_body(spec), {**ctype, **headers})
            resp = conn.getresponse()
            resp.read()
            statuses.append(resp.status)
            assert resp.getheader("Connection") != "close"
            socks.append(conn.sock)
        assert statuses == [504, 404, 504, 200]
        assert all(s is socks[0] for s in socks)  # one connection throughout
    finally:
        conn.close()
        server.shutdown()


def test_drain_flips_readyz_sheds_new_work_and_completes_inflight(exported, monkeypatch):
    spec, server = _served(exported)
    model = server.models[spec.name]
    entered, gate = threading.Event(), threading.Event()
    real = model.predict

    def held(images, *args, **kwargs):
        entered.set()
        gate.wait(30)
        return real(images, *args, **kwargs)

    monkeypatch.setattr(model, "predict", held)
    base = f"http://127.0.0.1:{server.port}"
    result = []
    t = threading.Thread(target=lambda: result.append(
        _post_raw(server.port, spec.name, _image_body(spec), {_DEADLINE: "20000"})))
    try:
        assert _http("GET", f"{base}/readyz")[:2] == (200, b"ready")
        t.start()
        assert entered.wait(30) and server.admission.inflight == 1
        server.begin_drain()
        assert _http("GET", f"{base}/readyz")[:2] == (503, b"draining")
        assert _http("GET", f"{base}/healthz")[0] == 200
        status, headers, body = _post_raw(server.port, spec.name, _image_body(spec))
        assert status == 503 and headers["Retry-After"] == "1.000"
        assert json.loads(body)["shed_reason"] == "draining"
        assert not server.admission.wait_idle(timeout_s=0.05)  # still in flight
        gate.set()
        assert server.admission.wait_idle(timeout_s=30)
        t.join(timeout=30)
        assert not t.is_alive() and result[0][0] == 200
        logits, _ = protocol.decode_predict_response(result[0][2], protocol.MSGPACK_CONTENT_TYPE)
        assert logits.shape == (1, len(spec.labels)) and np.isfinite(logits).all()
    finally:
        gate.set()
        server.shutdown()


def test_jax_gateway_deadline_budget_bounds_the_port_servers_wait(stack, monkeypatch):
    """The unchanged JAX gateway's ``X-Request-Deadline-Ms`` reaches the port
    server: admission sees less budget than the client gave, the batcher's
    wait less again, and that wait's timeout is the budget left, not 20 s."""
    spec, server, gateway, image_url, _, _ = stack
    timeouts = _timeouts(monkeypatch, server.models[spec.name])
    tier, model = 'tier="model-server"', f'model="{spec.name}",version="1"'
    names = [("kdlt_admission_deadline_remaining_ms", tier),
             ("kdlt_admission_batcher_budget_ms", model)]
    before = {(n, agg): _sample(server, f"{n}_{agg}", lab) for n, lab in names
              for agg in ("sum", "count")}
    req = urllib.request.Request(
        f"http://127.0.0.1:{gateway.port}/predict", method="POST",
        data=json.dumps({"url": image_url}).encode(),
        # The salt keeps the gateway's response cache from answering for the
        # model server (an earlier test sent the same image).
        headers={"Content-Type": "application/json", _DEADLINE: "5000",
                 "X-Kdlt-Cache-Bust": "deadline-test"})
    with urllib.request.urlopen(req, timeout=60) as r:
        assert r.status == 200 and set(json.loads(r.read())) == set(spec.labels)
    delta = {(n, agg): _sample(server, f"{n}_{agg}", lab) - before[(n, agg)]
             for n, lab in names for agg in ("sum", "count")}
    assert delta[(names[0][0], "count")] == delta[(names[1][0], "count")] == 1.0
    at_server, at_batcher = delta[(names[0][0], "sum")], delta[(names[1][0], "sum")]
    assert 0.0 < at_batcher < at_server < 5000.0, (at_server, at_batcher)
    assert len(timeouts) == 1 and abs(timeouts[0] * 1e3 - at_batcher) < 1e-6


@pytest.mark.parametrize("how", ["flag", "env"])
def test_no_admission_restores_the_fixed_waits(exported, monkeypatch, how):
    """``--no-admission`` or ``KDLT_ADMISSION=0``: no limiter, the deadline
    header ignored (a spent budget is served), every batch wait the fixed
    20 s; drain still sheds."""
    from kubernetes_deep_learning_tpu_torch.serving.model_server import BATCHER_TIMEOUT_S

    if how == "env":
        monkeypatch.setenv("KDLT_ADMISSION", "0")
    spec, server = _served(exported, argv=["--no-admission"] if how == "flag" else ())
    try:
        assert not server.admission.enabled and server.admission.limiter is None
        timeouts = _timeouts(monkeypatch, server.models[spec.name])
        for budget in ("0", "50"):
            assert _post_raw(server.port, spec.name, _image_body(spec),
                             {_DEADLINE: budget})[0] == 200
        assert timeouts == [BATCHER_TIMEOUT_S] * 2
        server.begin_drain()
        status, _, body = _post_raw(server.port, spec.name, _image_body(spec))
        assert status == 503 and json.loads(body)["shed_reason"] == "draining"
    finally:
        server.shutdown()


def test_open_loop_loadgen_reports_goodput_and_sheds(exported, tmp_path):
    """The load generator's open-loop mode against a port server on the CPU,
    in two processes on one schedule: every request sent, latency from its
    scheduled time, goodput and the in-deadline percentiles; then a spent
    budget on every request: all 504, each a JSON shed with its reason."""
    from kubernetes_deep_learning_tpu_torch.serving import loadgen

    spec, server = _served(exported)
    images = np.random.default_rng(4).integers(0, 256, (6, *spec.input_shape), np.uint8)
    np.save(tmp_path / "images.npy", images)
    url = f"http://127.0.0.1:{server.port}/v1/models/{spec.name}:predict"
    try:
        out = tmp_path / "open.npz"
        done = subprocess.run(
            [sys.executable, "-m", "kubernetes_deep_learning_tpu_torch.serving.loadgen",
             "--url", url, "--images", str(tmp_path / "images.npy"), "--rate", "30",
             "--duration", "1", "--deadline-ms", "60000", "--processes", "2",
             "--connections", "8", "--out", str(out)],
            cwd=REPO, capture_output=True, text=True, timeout=120,
            env={**os.environ, "PYTHONPATH": REPO})
        assert done.returncode == 0, done.stderr
        summary = json.loads(done.stdout.strip().splitlines()[-1])
        with np.load(out) as z:
            res = {k: z[k] for k in z.files}
        assert summary == loadgen.summarize(res)
        assert summary["requests"] == summary["sent"] == summary["completed_200"] == 30
        assert summary["status"] == {"200": 30} and summary["shed"] == {}
        assert summary["goodput_rps"] == 30.0 and 0.0 < summary["offered_rps"] <= 31.0
        assert 0.0 < summary["p50_in_deadline_ms"] <= summary["p99_in_deadline_ms"]
        np.testing.assert_array_equal(res["k"], np.arange(30))
        np.testing.assert_array_equal(res["image"], np.arange(30) % 6)
        np.testing.assert_allclose(res["sched_s"], np.arange(30) / 30)
        # Never sent before its time; its latency counts from the schedule.
        assert (res["sent_s"] >= res["sched_s"]).all()
        assert (res["lat_ms"] >= 1e3 * (res["sent_s"] - res["sched_s"])).all()
        engine = server.engines[spec.name]
        solo = np.concatenate([engine.predict(images[i : i + 1]) for i in range(6)])
        np.testing.assert_allclose(res["logits"], solo[res["image"]], rtol=1e-4, atol=1e-4)

        res = loadgen.run_open(url, images, rate=40, duration_s=0.5, deadline_ms=0,
                               connections=3)
        summary = loadgen.summarize(res)
        assert summary["status"] == {"504": 20} and summary["shed"] == {"deadline_exhausted": 20}
        assert summary["goodput_rps"] == 0.0 and summary["p99_in_deadline_ms"] is None
        assert res["json_body"].all() and np.isnan(res["retry_after_s"]).all()
    finally:
        server.shutdown()


def test_sigterm_drains_the_server_process_and_exits_0(exported):
    """The command line's server, serving: SIGTERM drains it and the
    process exits 0 (``install_sigterm_drain`` wired in ``main``)."""
    import signal
    import socket
    import time

    spec, root, _ = exported
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    proc = subprocess.Popen(
        [sys.executable, "-m", "kubernetes_deep_learning_tpu_torch.serving.model_server",
         "--model-root", root, "--host", "127.0.0.1", "--port", str(port), "--buckets", "1",
         "--device", "cpu"], cwd=REPO, env={**os.environ, "PYTHONPATH": REPO},
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)
    try:
        base = f"http://127.0.0.1:{port}"
        for _ in range(600):
            if proc.poll() is None and _http_or_none(f"{base}/readyz") == (200, b"ready"):
                break
            time.sleep(0.1)
        else:
            pytest.fail(f"server never ready: {proc.stderr.read().decode()[-2000:]}")
        assert _post_raw(port, spec.name, _image_body(spec))[0] == 200
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def _http_or_none(url):
    try:
        return _http("GET", url)[:2]
    except OSError:
        return None


# --- hot reload, artifact identity, the multi-model tier -------------------------


def _tiny_specs(*names):
    return [ModelSpec(name=n, family="vit-tiny", input_shape=(16, 16, 3), labels=("a", "b"),
                      preprocessing="tf") for n in names]


def _save(root, spec, version, seed):
    from kubernetes_deep_learning_tpu_torch.models import init_variables

    return art.save_artifact(art.version_dir(str(root), spec.name, version), spec,
                             init_variables(spec, seed=seed), {"compute_dtype": "float32"})


def _alone(directory, images):
    """The version's logits, image by image, from an engine of its own."""
    engine = InferenceEngine(art.load_artifact(directory), buckets=(1,), device="cpu")
    return np.concatenate([engine.predict(images[i : i + 1]) for i in range(len(images))])


def _predict(server, name, images):
    status, body, ctype, headers = server.handle_predict(
        f"/v1/models/{name}:predict", protocol.encode_predict_request(images),
        protocol.MSGPACK_CONTENT_TYPE)
    assert status == 200, body
    return protocol.decode_predict_response(body, ctype)[0], headers


def test_reload_switches_replies_and_hash_and_leaves_the_other_model(tmp_path):
    """Two models on one server (one scheduler, one shared dispatcher).  A
    new version of m0 with other weights: after ``poll_versions()`` m0's
    replies are v2's logits under v2's hash, v1's engine is closed and its
    series are gone, /readyz stayed 200; m1's engine, lane, replies and
    hash are untouched.  A byte-identical v3 is adopted with no new engine."""
    from kubernetes_deep_learning_tpu_torch.serving.registry import artifact_hash

    m0, m1 = _tiny_specs("reload-m0", "reload-m1")
    dirs = {(m0.name, 1): _save(tmp_path, m0, 1, seed=0), (m1.name, 1): _save(tmp_path, m1, 1, 1)}
    images = np.random.default_rng(2).integers(0, 256, (3, 16, 16, 3), np.uint8)
    server = ModelServer(str(tmp_path), port=0, buckets=(1, 2), device="cpu")
    try:
        server.warmup()
        assert server.scheduler is not None and server.models[m0.name].batcher is None
        before = {}
        for spec in (m0, m1):
            got, headers = _predict(server, spec.name, images[:1])
            want = _alone(dirs[(spec.name, 1)], images[:1])
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
            assert headers[protocol.ARTIFACT_HASH_HEADER] == artifact_hash(dirs[(spec.name, 1)])
            before[spec.name] = (got, headers)
        old, m1_engine, m1_lane = (server.models[m0.name], server.engines[m1.name],
                                   server.scheduler.lane(m1.name))
        m0_lane = server.scheduler.lane(m0.name)
        v2 = _save(tmp_path, m0, 2, seed=7)
        assert server.poll_versions() == [f"{m0.name} v2"]
        assert server.handle_get("/readyz")[0] == 200
        assert old.engine._closed and server.models[m0.name] is not old
        assert server.scheduler.lane(m0.name) is m0_lane  # the lane survived the swap
        assert m0_lane.engine is server.engines[m0.name]
        got, headers = _predict(server, m0.name, images)
        np.testing.assert_allclose(got, _alone(v2, images), rtol=1e-5, atol=1e-6)
        assert headers[protocol.ARTIFACT_HASH_HEADER] == artifact_hash(v2)
        assert headers[protocol.ARTIFACT_HASH_HEADER] != before[m0.name][1][
            protocol.ARTIFACT_HASH_HEADER]
        # The other model: same engine, same lane, same replies and hash.
        assert server.engines[m1.name] is m1_engine and server.scheduler.lane(m1.name) is m1_lane
        got, headers = _predict(server, m1.name, images[:1])
        np.testing.assert_array_equal(got, before[m1.name][0])
        assert headers == before[m1.name][1]
        text = server.registry.render()
        assert f'model="{m0.name}",version="1"' not in text
        assert f'kdlt_engine_images_total{{model="{m0.name}",version="2"}} 3.0' in text
        # Byte-identical v3: adopted, no new engine, the hash unchanged.
        engine = server.engines[m0.name]
        shutil.copytree(v2, art.version_dir(str(tmp_path), m0.name, 3))
        assert server.poll_versions() == []
        status = json.loads(server.handle_get(f"/v1/models/{m0.name}:status")[1])
        assert server.engines[m0.name] is engine and status["version"] == 3
        assert status["artifact_hash"] == artifact_hash(v2)
        assert _predict(server, m0.name, images[:1])[1] == headers | {
            protocol.ARTIFACT_HASH_HEADER: artifact_hash(v2)}
    finally:
        server.shutdown()


def test_a_broken_version_directory_is_skipped_and_retried(tmp_path, monkeypatch):
    """A half-written v2 (its weights unreadable), one whose spec names
    another model, and one whose warmup fails (its engine closed, its
    series dropped): each skipped, v1 serves on; once v2 is whole and
    warms, the next scan loads it."""
    (m0,) = _tiny_specs("broken-m0")
    v1 = _save(tmp_path, m0, 1, seed=0)
    images = np.random.default_rng(3).integers(0, 256, (2, 16, 16, 3), np.uint8)
    server = ModelServer(str(tmp_path), port=0, buckets=(1, 2), device="cpu")
    try:
        server.warmup()
        v2 = art.version_dir(str(tmp_path), m0.name, 2)
        os.makedirs(v2)
        with open(os.path.join(v2, art.SPEC_FILE), "w") as f:
            f.write(m0.to_json())
        with open(os.path.join(v2, art.PARAMS_FILE), "wb") as f:
            f.write(b"\xc1 not msgpack")
        assert server.poll_versions() == []
        assert server.models[m0.name].version == 1
        (other,) = _tiny_specs("another-model")
        _save(tmp_path / "elsewhere", other, 1, seed=0)
        shutil.rmtree(v2)
        shutil.copytree(art.version_dir(str(tmp_path / "elsewhere"), other.name, 1), v2)
        assert server.poll_versions() == []  # declined: spec.name is not the directory's
        got, _ = _predict(server, m0.name, images)
        np.testing.assert_allclose(got, _alone(v1, images), rtol=1e-5, atol=1e-6)
        text = server.registry.render()
        assert 'version="2"' not in text  # no series of a version that never loaded
        shutil.rmtree(v2)
        _save(tmp_path, m0, 2, seed=5)
        built = []
        real_warmup = InferenceEngine.warmup

        def failing_warmup(engine):
            built.append(engine)
            raise RuntimeError("capture failed")

        monkeypatch.setattr(InferenceEngine, "warmup", failing_warmup)
        assert server.poll_versions() == []
        assert len(built) == 1 and built[0]._closed and server.models[m0.name].version == 1
        assert 'version="2"' not in server.registry.render()
        monkeypatch.setattr(InferenceEngine, "warmup", real_warmup)
        assert server.poll_versions() == [f"{m0.name} v2"]
        assert server.models[m0.name].version == 2
    finally:
        server.shutdown()


def test_a_request_holding_a_closed_version_is_served_by_the_new_one(tmp_path):
    """Batching off (no lane): a request that resolved v1 before a reload
    closed v1's engine is answered by v2, under v2's hash."""
    from kubernetes_deep_learning_tpu_torch.serving.registry import artifact_hash

    (m0,) = _tiny_specs("closed-m0")
    _save(tmp_path, m0, 1, seed=0)
    images = np.random.default_rng(4).integers(0, 256, (2, 16, 16, 3), np.uint8)
    server = ModelServer(str(tmp_path), port=0, buckets=(1, 2), device="cpu", use_batcher=False)
    try:
        server.warmup()
        held = server.models[m0.name]
        v2 = _save(tmp_path, m0, 2, seed=3)
        assert server.poll_versions() == [f"{m0.name} v2"] and held.engine._closed
        logits, digest = server._infer(held, images, None, "interactive")
        np.testing.assert_allclose(logits, _alone(v2, images), rtol=1e-5, atol=1e-6)
        assert digest == artifact_hash(v2)
    finally:
        server.shutdown()


def test_status_and_models_routes_match_the_jax_server(exported):
    """The JAX server and the port's over the same artifact root, the same
    buckets: ``GET /v1/models`` and ``GET /v1/models/<name>:status`` answer
    the same JSON (the artifact hash included); an unknown model's status
    is a JSON 404 on both."""
    from kubernetes_deep_learning_tpu.serving.model_server import ModelServer as JaxModelServer

    spec, root, _ = exported
    jax_server = JaxModelServer(root, port=0, buckets=(1, 2), host="127.0.0.1")
    port_server = ModelServer(root, port=0, buckets=(1, 2), device="cpu")
    try:
        for s in (jax_server, port_server):
            s.start()
            s.warmup()
        for path in ("/v1/models", f"/v1/models/{spec.name}:status"):
            replies = [_http("GET", f"http://127.0.0.1:{s.port}{path}")
                       for s in (jax_server, port_server)]
            (want_status, want, _), (status, got, ctype) = replies
            assert status == want_status == 200 and ctype == protocol.JSON_CONTENT_TYPE
            assert json.loads(got) == json.loads(want), path
        got = json.loads(_http("GET", f"http://127.0.0.1:{port_server.port}/v1/models")[1])
        assert got[spec.name]["artifact_hash"] and got[spec.name]["sharding"] == "single"
        for s in (jax_server, port_server):
            status, body, _ = _http("GET", f"http://127.0.0.1:{s.port}/v1/models/nope:status")
            assert status == 404 and set(json.loads(body)) == {"error"}
    finally:
        port_server.shutdown()
        jax_server.shutdown()


def test_watch_and_scheduler_flags_parse(exported, monkeypatch):
    """``--watch-interval`` (10 s by default, as in JAX), ``--sched-policy``
    and ``--sched-weights`` reach the server; without them the scheduler
    reads ``KDLT_SCHED_POLICY`` and ``KDLT_SCHED_WEIGHTS``; ``--batcher
    native`` and ``--no-batching`` serve without a scheduler."""
    from kubernetes_deep_learning_tpu_torch.serving.model_server import _parser, build_server

    spec, root, _ = exported
    args = _parser().parse_args(["--model-root", root])
    assert (args.watch_interval, args.sched_policy, args.sched_weights) == (10.0, None, None)
    args = _parser().parse_args(["--model-root", root, "--watch-interval", "0.5"])
    assert args.watch_interval == 0.5
    with pytest.raises(SystemExit):
        _parser().parse_args(["--model-root", root, "--sched-policy", "lifo"])
    base = ["--model-root", root, "--port", "0", "--buckets", "1", "--device", "cpu"]
    server = build_server([*base, "--sched-policy", "fifo", "--sched-weights",
                           f"{spec.name}=3,other=x"])
    try:
        assert server.scheduler.policy == "fifo"
        assert server.scheduler.lane(spec.name).weight == 3.0
    finally:
        server.shutdown()
    monkeypatch.setenv("KDLT_SCHED_POLICY", "fifo")
    monkeypatch.setenv("KDLT_SCHED_WEIGHTS", f"{spec.name}=0.5")
    server = build_server(base)
    try:
        assert server.scheduler.policy == "fifo"
        assert server.scheduler.lane(spec.name).weight == 0.5
    finally:
        server.shutdown()
    for flag in ("--no-batching", "--batcher=native"):
        server = build_server([*base, flag])
        try:
            assert server.scheduler is None and server.dispatcher is None
        finally:
            server.shutdown()


def test_jax_gateway_cache_learns_the_new_hash_after_a_reload(exported, tmp_path):
    """The unchanged JAX gateway in front of the port server, its response
    cache on: image A is cached under v1.  A reload with changed bytes:
    the next upstream answer (image B) carries v2's hash, the gateway drops
    v1's entries, and A is answered with v2's logits -- no cache-bust
    header anywhere.  A byte-identical v3 keeps the entries (a hit)."""
    from PIL import Image

    from kubernetes_deep_learning_tpu.models import build_forward as jax_build_forward
    from kubernetes_deep_learning_tpu.ops import preprocess
    from kubernetes_deep_learning_tpu.serving.client import predict_url
    from kubernetes_deep_learning_tpu.serving.gateway import Gateway

    spec, src, _ = exported
    root = tmp_path / "models"
    shutil.copytree(os.path.join(src, spec.name, "1"), root / spec.name / "1")
    server = ModelServer(str(root), port=0, buckets=(1, 2), device="cpu")
    server.start()
    server.warmup()
    gateway = Gateway(serving_host=f"localhost:{server.port}", model=spec.name, port=0)
    gateway.start()
    img_dir = tmp_path / "images"
    img_dir.mkdir()
    rng = np.random.default_rng(8)
    pixels = {k: rng.integers(0, 256, (64, 64, 3), np.uint8) for k in "ab"}
    for k, px in pixels.items():
        Image.fromarray(px).save(img_dir / f"{k}.png")
    httpd = HTTPServer(("127.0.0.1", 0), partial(SimpleHTTPRequestHandler, directory=str(img_dir)))
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    url = {k: f"http://127.0.0.1:{httpd.server_address[1]}/{k}.png" for k in "ab"}
    base = f"http://localhost:{gateway.port}"

    def ask(k):
        stats: dict = {}
        scores = predict_url(base, url[k], stats=stats)
        return np.asarray([scores[label] for label in spec.labels], np.float32), stats["cache"]

    def want(variables, k):
        img = preprocess.resize_uint8(pixels[k], spec.input_shape[:2], "nearest")
        return np.asarray(jax.jit(jax_build_forward(spec, dtype=None))(variables, img[None]))[0]

    try:
        v1_a, disposition = ask("a")
        assert disposition == "miss"
        assert ask("a")[1] == "hit"
        v2_vars = jax_init_variables(spec, seed=6)
        export_model(spec, v2_vars, str(root), dtype=np.float32)  # version 2
        assert server.poll_versions() == [f"{spec.name} v2"]
        got_b, disposition = ask("b")  # an upstream answer carrying v2's hash
        assert disposition == "miss"
        np.testing.assert_allclose(got_b, want(v2_vars, "b"), rtol=1e-3, atol=1e-3)
        got_a, disposition = ask("a")
        assert disposition == "miss" and not np.allclose(got_a, v1_a, rtol=1e-3, atol=1e-3)
        np.testing.assert_allclose(got_a, want(v2_vars, "a"), rtol=1e-3, atol=1e-3)
        shutil.copytree(root / spec.name / "2", root / spec.name / "3")
        assert server.poll_versions() == []  # byte-identical: adopted, no reload
        for k in "ab":
            assert ask(k)[1] == "hit"
    finally:
        gateway.shutdown()
        server.shutdown()
        httpd.shutdown()
        httpd.server_close()


def test_loadgen_sends_several_images_a_request(exported, tmp_path):
    """``--images-per-request 3``: closed loop, request k carries images
    3k..3k+2; open loop on a shared ``--start-at``, request k the images of
    group k mod (N // 3); each reply holds its images' logits in order."""
    import time

    from kubernetes_deep_learning_tpu_torch.serving import loadgen

    spec, server = _served(exported)
    images = np.random.default_rng(9).integers(0, 256, (12, *spec.input_shape), np.uint8)
    url = f"http://127.0.0.1:{server.port}/v1/models/{spec.name}:predict"
    try:
        engine = server.engines[spec.name]
        solo = np.concatenate([engine.predict(images[i : i + 1]) for i in range(len(images))])
        res = loadgen.run(url, images, clients=2, requests=2, per_request=3)
        assert (res["status"] == 200).all() and res["logits"].shape == (4, 3, len(spec.labels))
        np.testing.assert_allclose(res["logits"], solo.reshape(4, 3, -1), rtol=1e-4, atol=1e-4)
        np.save(tmp_path / "images.npy", images[:7])  # 2 groups of 3; image 6 unused
        out = tmp_path / "open.npz"
        done = subprocess.run(
            [sys.executable, "-m", "kubernetes_deep_learning_tpu_torch.serving.loadgen",
             "--url", url, "--images", str(tmp_path / "images.npy"), "--rate", "20",
             "--duration", "0.5", "--deadline-ms", "60000", "--images-per-request", "3",
             "--processes", "2", "--start-at", repr(time.time() + 1.0), "--out", str(out)],
            cwd=REPO, capture_output=True, text=True, timeout=120,
            env={**os.environ, "PYTHONPATH": REPO})
        assert done.returncode == 0, done.stderr
        with np.load(out) as z:
            res = {k: z[k] for k in z.files}
        assert (res["status"] == 200).all() and len(res["status"]) == 10
        np.testing.assert_array_equal(res["image"], (np.arange(10) % 2) * 3)
        want = solo[:6].reshape(2, 3, -1)[np.arange(10) % 2]
        np.testing.assert_allclose(res["logits"], want, rtol=1e-4, atol=1e-4)
    finally:
        server.shutdown()
