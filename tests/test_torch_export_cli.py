"""The port's deployment CLIs on the CPU: ``kdlt-torch-export``,
``-inspect``, ``-warm`` and ``-verify-golden``, against the JAX package's.

At a 32-px Xception (full depth: the exit flow reaches 1x1) with the
clothing model's head (10 labels, ``head_hidden=(100,)``), registered in
both packages' spec registries; torch on one thread (the suite's
processes share the cores, and the JAX int8 program crawls beside a
torch pool a core wide).  Tolerances, each named where it is used:

- a float32 artifact served by the JAX engine (``use_exported=False``,
  the exact graph) and by the port's engine: max abs logit difference
  <= 1e-3 (``EXACT_ATOL``: float32 graphs that sum in other orders);
- a bfloat16-compute artifact: relative max abs difference <= 2e-2
  (``BF16_RTOL``: two bfloat16 graphs);
- the ``--calibrate`` (int8-w8a8) version: relative max abs difference <=
  5e-2 and the same top-1 on every image (``W8A8_RTOL``, as
  ``tests/test_torch_quantize.py``);
- verify-golden's printed scores (3 decimals) of the two packages:
  within 1.5e-3 (``GOLDEN_ATOL``: each rounds its own exact float32
  logits).
"""

from __future__ import annotations

import ast
import dataclasses
import json
import os

import flax.serialization
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_keras_import import _flax_to_keras_h5
from torch_bn_training import torch_threads

from kubernetes_deep_learning_tpu import golden as jax_golden
from kubernetes_deep_learning_tpu import modelspec as jax_modelspec
from kubernetes_deep_learning_tpu.export import artifact as jart
from kubernetes_deep_learning_tpu.export import inspect as jax_inspect
from kubernetes_deep_learning_tpu.runtime.engine import InferenceEngine as JaxEngine
from kubernetes_deep_learning_tpu_torch import golden, modelspec
from kubernetes_deep_learning_tpu_torch.export import artifact as art
from kubernetes_deep_learning_tpu_torch.export import exporter, warm
from kubernetes_deep_learning_tpu_torch.export import inspect as port_inspect
from kubernetes_deep_learning_tpu_torch.models import init_variables
from kubernetes_deep_learning_tpu_torch.modelspec import CLOTHING_MODEL, ModelSpec
from kubernetes_deep_learning_tpu_torch.ops import preprocess
from kubernetes_deep_learning_tpu_torch.runtime import InferenceEngine
from kubernetes_deep_learning_tpu_torch.runtime.stub import StubEngine

EXACT_ATOL = 1e-3
BF16_RTOL = 2e-2
W8A8_RTOL = 5e-2
GOLDEN_ATOL = 1.5e-3
NAME = "torch-export-xception"
SPEC_KW = dict(name=NAME, family="xception", input_shape=(32, 32, 3),
               labels=CLOTHING_MODEL.labels, preprocessing="tf", resize_filter="nearest",
               head_hidden=(100,))
SPEC = modelspec.register_spec(ModelSpec(**SPEC_KW))
jax_modelspec.register_spec(jax_modelspec.ModelSpec(**SPEC_KW))


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    """One torch thread, restored after: see ``torch_bn_training.torch_threads``
    (the suite's processes otherwise starve each other)."""
    with torch_threads():
        yield


def _images(n: int = 3, seed: int = 4) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, (n, *SPEC.input_shape), dtype=np.uint8)


def _both(directory: str, fast=False) -> tuple[np.ndarray, np.ndarray]:
    """The version served by the JAX engine and the port's, on the CPU."""
    x = _images()
    jax_engine = JaxEngine(jart.load_artifact(directory), buckets=(4,), use_exported=False,
                           fast=fast)
    port_engine = InferenceEngine(art.load_artifact(directory), buckets=(4,), device="cpu")
    return np.asarray(jax_engine.predict(x)), port_engine.predict(x)


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    """One .h5 and the CLI's artifacts: v1 float32 from the .h5, v2 its
    w8a8 calibration, v7 port-seeded with bfloat16 storage."""
    d = tmp_path_factory.mktemp("export")
    variables = init_variables(SPEC, seed=3)
    h5 = str(d / "model.h5")
    _flax_to_keras_h5(h5, variables)
    root = str(d / "models")
    assert exporter.main(["--model", NAME, "--weights", h5, "--output", root, "--dtype",
                          "float32", "--calibrate", "4", "--calibrate-percentile", "100",
                          "--device", "cpu"]) == 0
    assert exporter.main(["--model", NAME, "--seed", "5", "--output", root, "--version", "7",
                          "--params-dtype", "bfloat16"]) == 0
    return h5, root, variables


def _meta(root: str, version: int) -> dict:
    with open(os.path.join(root, NAME, str(version), "metadata.json")) as f:
        return json.load(f)


def test_export_writes_the_versions_and_metadata(exported):
    _, root, _ = exported
    assert art.scan_versions(root, NAME) == [1, 2, 7]
    assert {k: _meta(root, 1)[k] for k in ("compute_dtype", "params_dtype", "init")} == {
        "compute_dtype": "float32", "params_dtype": None, "init": "keras-h5"}
    assert _meta(root, 2)["quantization"] == "int8-w8a8"
    assert _meta(root, 2)["calibration"]["images"] == 4
    assert {k: _meta(root, 7)[k] for k in ("compute_dtype", "params_dtype", "init")} == {
        "compute_dtype": "bfloat16", "params_dtype": "bfloat16", "init": "port-seeded"}


def test_bfloat16_storage_is_what_flax_writes(exported):
    """v7's params.msgpack holds bfloat16 arrays, equal to JAX's cast of the
    port-seeded float32 tree (round to nearest even)."""
    _, root, _ = exported
    with open(os.path.join(root, NAME, "7", art.PARAMS_FILE), "rb") as f:
        stored = flax.serialization.msgpack_restore(f.read())
    want = init_variables(SPEC, seed=5)
    leaf = stored["params"]["block1_conv1"]["kernel"]
    assert leaf.dtype == jnp.bfloat16
    np.testing.assert_array_equal(
        np.asarray(leaf).view(np.uint16),
        np.asarray(jnp.asarray(want["params"]["block1_conv1"]["kernel"]).astype(
            jnp.bfloat16)).view(np.uint16))


def test_float32_export_serves_equal_on_both_engines(exported):
    _, root, _ = exported
    ref, got = _both(art.version_dir(root, NAME, 1))
    assert np.abs(got - ref).max() <= EXACT_ATOL


def test_bfloat16_export_serves_alike_on_both_engines(exported):
    _, root, _ = exported
    ref, got = _both(art.version_dir(root, NAME, 7))
    assert np.abs(got - ref).max() <= BF16_RTOL * np.abs(ref).max()


def test_calibrated_export_serves_alike_on_both_engines(exported):
    _, root, _ = exported
    ref, got = _both(art.version_dir(root, NAME, 2))
    assert np.abs(got - ref).max() <= W8A8_RTOL * np.abs(ref).max()
    assert (got.argmax(-1) == ref.argmax(-1)).all()


@pytest.mark.parametrize("version", [1, 2, 7])
def test_describe_carries_the_jax_fields(exported, version):
    """Every line JAX's inspector prints for a port-written artifact, the
    port's prints too (the JAX one prints no module lines for it: there is
    none); the port adds one line saying the artifact is params-only."""
    _, root, _ = exported
    d = art.version_dir(root, NAME, version)
    want, got = jax_inspect.describe(d).splitlines(), port_inspect.describe(d).splitlines()
    extra = [ln for ln in got if ln not in want]
    assert [ln for ln in got if ln in want] == want
    assert len(extra) == 1 and "params-only" in extra[0]


def test_inspect_root_lists_every_version(exported, capsys):
    _, root, _ = exported
    assert port_inspect.main(["--root", root]) == 0
    out = capsys.readouterr().out
    assert [ln.split("/")[-1] for ln in out.splitlines() if ln.startswith("Artifact:")] == [
        "1", "2", "7"]


SCORES = {
    "golden": dict(golden.GOLDEN_LOGITS),
    "one_off": {**golden.GOLDEN_LOGITS, "hat": -4.9},
    "missing": {k: v for k, v in golden.GOLDEN_LOGITS.items() if k != "skirt"},
    "wrong_top1": {**golden.GOLDEN_LOGITS, "shorts": 10.5},
    "empty": {},
}


@pytest.mark.parametrize("case", sorted(SCORES))
@pytest.mark.parametrize("atol", [0.05, 0.2])
def test_check_scores_fails_as_jax_does(case, atol):
    assert golden.GOLDEN_LOGITS == jax_golden.GOLDEN_LOGITS
    assert golden.check_scores(SCORES[case], atol) == jax_golden.check_scores(SCORES[case], atol)


def test_verify_golden_cli_exits_and_scores_as_jax(exported, tmp_path, monkeypatch, capsys):
    """Both CLIs on the same .h5 and image (a 32-px stand-in for the clothing
    model: the spec lookup patched in both packages): exit 1 (seeded weights
    are not the golden ones) and the same printed scores."""
    h5, _, _ = exported
    image = str(tmp_path / "image.png")
    with open(image, "wb") as f:
        f.write(_png(_images(1, seed=9)[0]))
    monkeypatch.setattr(modelspec, "get_spec", lambda name: SPEC)
    monkeypatch.setattr(jax_modelspec, "get_spec",
                        lambda name: jax_modelspec.ModelSpec(**SPEC_KW))
    assert golden.main(["--weights", h5, "--image", image, "--device", "cpu"]) == 1
    got = capsys.readouterr()
    assert jax_golden.main(["--weights", h5, "--image", image]) == 1
    want = capsys.readouterr()
    scores = [ast.literal_eval(out.out.split("scores: ", 1)[1].splitlines()[0])
              for out in (got, want)]
    assert list(scores[0]) == list(scores[1])
    assert max(abs(scores[0][k] - scores[1][k]) for k in scores[1]) <= GOLDEN_ATOL
    assert got.err.count("FAIL") == want.err.count("FAIL") > 0


def test_verify_golden_runs_the_served_check_when_the_exact_one_passes(exported, tmp_path,
                                                                        monkeypatch):
    """Both engine checks pass on a model with a known golden dict: the
    .h5's model with its pants bias raised to lead by 8
    (``chip_smoke._pants_leads``), against that model's own exact float32
    scores.  The served configuration (bfloat16, ``fast="auto"``) then runs,
    prints its scores and passes within ``--served-atol``."""
    import chip_smoke

    from kubernetes_deep_learning_tpu_torch.models import build_forward
    from kubernetes_deep_learning_tpu_torch.weights import from_jax_variables

    _, _, variables = exported
    image = str(tmp_path / "image.png")
    with open(image, "wb") as f:
        f.write(_png(_images(1, seed=9)[0]))
    with open(image, "rb") as f:
        pixels = preprocess.preprocess_bytes(f.read(), SPEC.input_shape[:2],
                                             filter=SPEC.resize_filter)[None]

    def exact(tree) -> np.ndarray:
        forward = build_forward(SPEC, from_jax_variables(tree), torch.float32, fast=False,
                                device="cpu")
        with torch.inference_mode():
            return forward(torch.from_numpy(pixels))[0].numpy()

    raised = chip_smoke._pants_leads(SPEC, variables, exact(variables), 8.0)
    h5 = str(tmp_path / "golden.h5")
    _flax_to_keras_h5(h5, raised)
    want = dict(zip(SPEC.labels, map(float, exact(raised))))
    assert max(want, key=want.get) == "pants"
    monkeypatch.setattr(modelspec, "get_spec", lambda name: SPEC)
    code, text = chip_smoke._golden_both_checks(h5, image, want, "cpu")
    assert code == 0, text
    assert golden.GOLDEN_LOGITS == jax_golden.GOLDEN_LOGITS  # swapped back
    served = ast.literal_eval(text.split("served-config scores: ", 1)[1].splitlines()[0])
    assert max(abs(served[k] - want[k]) for k in want) <= 0.2
    assert "OK: served config (bf16, fast=auto) within atol=0.2" in text


def _png(img: np.ndarray) -> bytes:
    import chip_smoke

    return chip_smoke._png_bytes(img)


# --- kdlt-torch-warm, with a stub engine -------------------------------------------


def _stub_root(root, names=("a-model", "b-model")) -> str:
    for name in names:
        spec = dataclasses.replace(SPEC, name=name)
        art.save_artifact(art.version_dir(str(root), name, 1), spec, {"params": {}}, {})
        art.save_artifact(art.version_dir(str(root), name, 2), spec, {"params": {}}, {})
    return str(root)


def test_warm_reports_every_model_and_warms_the_rest_after_a_failure(tmp_path):
    root = _stub_root(tmp_path)
    warmed = []

    def factory(directory, buckets, device):
        if "a-model" in directory:
            raise RuntimeError("broken artifact")
        engine = StubEngine(art.load_artifact(directory), buckets=buckets, device=device)
        warmed.append((directory, engine.buckets))
        return engine

    report = warm.warm_models(root, buckets=(1, 4), device="cpu", engine_factory=factory,
                              libraries=())
    assert report["models"]["a-model"] == {"version": 2, "error": "broken artifact"}
    assert report["models"]["b-model"]["version"] == 2
    assert report["models"]["b-model"]["buckets"] == [1, 4]
    assert report["models"]["b-model"]["seconds"] >= 0
    assert warmed == [(art.version_dir(root, "b-model", 2), (1, 4))]
    assert report["libraries"] == {} and report["failed_libraries"] == []


@pytest.mark.parametrize("case,code", [("ok", 0), ("one_fails", 1), ("empty", 1),
                                       ("library_fails", 1)])
def test_warm_cli_exit_codes(tmp_path, monkeypatch, capsys, case, code):
    root = str(tmp_path / "models")
    os.makedirs(root)
    if case != "empty":
        _stub_root(root)

    def factory(directory, buckets, device):
        if case == "one_fails" and "b-model" in directory:
            raise RuntimeError("no")
        return StubEngine(art.load_artifact(directory), buckets=buckets, device=device)

    def broken():
        raise RuntimeError("nvcc not found")

    before = os.environ.get("KDLT_TORCH_BUILD_DIR")
    monkeypatch.setattr(warm, "_default_factory", factory)
    monkeypatch.setattr(warm, "HOST_LIBRARIES", ("hostops",) if case == "library_fails" else ())
    monkeypatch.setattr(warm, "_loaders", lambda: {"hostops": broken})
    assert warm.main(["--models", root, "--device", "cpu", "--buckets", "2,1", "--json",
                      "--build-dir", str(tmp_path / "build")]) == code
    if case != "empty":
        report = json.loads(capsys.readouterr().out)
        assert report["buckets"] == [1, 2]
        assert report["build_dir"] == str(tmp_path / "build")
        assert sorted(report["models"]) == ["a-model", "b-model"]
        assert report["failed_libraries"] == (["hostops"] if case == "library_fails" else [])
    assert os.environ.get("KDLT_TORCH_BUILD_DIR") == before  # the caller's, restored


def test_model_server_aot_warm_runs_the_pass_and_exits(tmp_path, monkeypatch):
    from kubernetes_deep_learning_tpu_torch.serving import model_server

    calls = []

    def fake(root, buckets=None, device="cuda", **kw):
        calls.append((root, tuple(buckets), device))
        return {"models": {"m": {"version": 1}}, "failed_libraries": []}

    monkeypatch.setattr(warm, "warm_models", fake)
    assert model_server.main(["--model-root", str(tmp_path), "--device", "cpu", "--buckets",
                              "1,4", "--aot-warm"]) == 0
    assert calls == [(str(tmp_path), (1, 4), "cpu")]


def test_server_metrics_count_native_builds_and_kernel_launches(tmp_path, monkeypatch):
    """The server's /metrics: ``kdlt_native_builds`` (the libraries this
    process compiled) and ``kdlt_kernel_launches{kernel}`` (every kernel
    wrapper's count); the boot line names the build directory."""
    import re

    from kubernetes_deep_learning_tpu_torch.ops import _build, _native, fused_sepconv
    from kubernetes_deep_learning_tpu_torch.serving import model_server

    monkeypatch.setattr(_build, "BUILT", ["kdlt_kernels-0123.so"])
    monkeypatch.setattr(_native, "BUILT", ["kdlt_hostops-4567.so"])
    root = _stub_root(tmp_path, names=("a-model",))
    server = model_server.ModelServer(root, port=0, buckets=(1,), device="cpu",
                                      engine_factory=lambda a, **k: StubEngine(a, **k))
    try:
        fused_sepconv.reset_launch_counts()
        for name in ("fused_sepconv_block", "fused_sepconv_block", "fused_sepconv_chain"):
            fused_sepconv._counts.count(name)
        text = server.handle_get("/metrics")[1].decode()
    finally:
        fused_sepconv.reset_launch_counts()
        server.shutdown()
    samples = {m.group(1) or "": float(m.group(2)) for m in re.finditer(
        r'^kdlt_kernel_launches(?:\{kernel="(\w+)"\})? (\S+)$', text, re.M)}
    assert samples["fused_sepconv_block"] == 2 and samples["fused_sepconv_chain"] == 1
    assert re.search(r"^kdlt_native_builds 2(\.0)?$", text, re.M)
    assert model_server.native_libraries_line() == (
        f"native libraries from {_build.build_dir()}: 2 built here "
        "(kdlt_kernels-0123.so, kdlt_hostops-4567.so)")
