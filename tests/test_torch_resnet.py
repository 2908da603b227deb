"""The port's ResNet50 (BASELINE config 3) against the JAX package on the CPU.

The full ResNet50 depth (all 16 bottleneck blocks) at a 64x64 input, the
size of ``tests/test_resnet.py``; weights and images are made with numpy
from a seed and handed to both frameworks, and each compute dtype is
jitted once for the module.  Tolerances, relative to the largest logit:
the exact f32 graph within 1e-3 of flax (the same arithmetic summed in
another order), the bf16 graph within 2e-2 of the flax bf16 graph, as
``test_torch_efficientnet.py``.  A case with some BatchNorm variances in
U(1e-5, 1e-4) tells ResNet's epsilon (1.001e-5) from Keras's 1e-3, which
the default init's U(0.5, 1.5) cannot.  Then the ``resnet50-imagenet``
parameter count, the weights' round trip, the stages' downsampling, and
one artifact served by the port's model server and by the JAX server.
"""

from __future__ import annotations

import json
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubernetes_deep_learning_tpu.export import export_model
from kubernetes_deep_learning_tpu.models import build_forward as jax_build_forward
from kubernetes_deep_learning_tpu.models import create_model as jax_create_model
from kubernetes_deep_learning_tpu.modelspec import ModelSpec as JaxModelSpec
from kubernetes_deep_learning_tpu.modelspec import register_spec
from kubernetes_deep_learning_tpu_torch.models import (
    build_forward,
    create_model,
    has_fast_forward,
    init_variables,
    resolve_fast,
)
from kubernetes_deep_learning_tpu_torch.models.layers import BatchNorm
from kubernetes_deep_learning_tpu_torch.models.resnet import RESNET_BN_EPS
from kubernetes_deep_learning_tpu_torch.modelspec import RESNET50_IMAGENET, ModelSpec
from kubernetes_deep_learning_tpu_torch.serving import protocol
from kubernetes_deep_learning_tpu_torch.serving.model_server import ModelServer
from kubernetes_deep_learning_tpu_torch.weights import (
    KERAS_BN_EPS,
    from_jax_variables,
    to_jax_variables,
)
from torch_threads import one_torch_thread  # noqa: F401

_SPEC_KW = dict(name="torch-tiny-resnet", family="resnet50", input_shape=(64, 64, 3),
                labels=("a", "b", "c", "d"), preprocessing="caffe")


def _rel(got, want) -> float:
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-6))


@pytest.fixture(scope="module")
def tiny():
    """(jax spec, port spec, variables (numpy flax tree), 5 uint8 images)."""
    jspec, spec = JaxModelSpec(**_SPEC_KW), ModelSpec(**_SPEC_KW)
    variables = init_variables(spec, seed=0)
    images = np.random.default_rng(0).integers(0, 256, (5, *spec.input_shape), np.uint8)
    return jspec, spec, variables, images


@pytest.fixture(scope="module")
def flax_forward(tiny):
    """The jitted flax graph per compute dtype (compiled once each; the
    variables are an argument, so other weights of the same shapes reuse it)."""
    jspec = tiny[0]
    cache = {}

    def get(dtype: str):
        if dtype not in cache:
            cache[dtype] = jax.jit(jax_build_forward(jspec, jnp.dtype(dtype), fast=False))
        return cache[dtype]

    return get


def _port_logits(spec, variables, images, dtype: str) -> np.ndarray:
    fwd = build_forward(spec, from_jax_variables(variables), getattr(torch, dtype), False, "cpu")
    with torch.inference_mode():
        return fwd(torch.from_numpy(images)).numpy()


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-3), ("bfloat16", 2e-2)])
def test_exact_graph_matches_flax(tiny, flax_forward, dtype, tol):
    _, spec, variables, images = tiny
    got = _port_logits(spec, variables, images, dtype)
    want = np.asarray(flax_forward(dtype)(variables, images), np.float32)
    assert got.shape == (5, 4) and got.dtype == np.float32 and np.isfinite(got).all()
    assert _rel(got, want) < tol


def test_small_variances_need_resnet_epsilon(tiny, flax_forward):
    """A fifth of the variances of the stem's BatchNorm and of the last
    block's drawn in U(1e-5, 1e-4) (in every BatchNorm, the activations
    overflow): the port with ResNet's epsilon matches flax in f32; the same
    weights with Keras's 1e-3 in every BatchNorm do not."""
    _, spec, variables, images = tiny
    rng = np.random.default_rng(11)
    stats = jax.tree_util.tree_map(np.array, variables["batch_stats"])
    for node in (stats["conv1_bn"], stats["conv5_block3"]["3_bn"]):
        small = rng.random(node["var"].shape) < 0.2
        node["var"][small] = rng.uniform(1e-5, 1e-4, int(small.sum()))
    tight = {"params": variables["params"], "batch_stats": stats}
    want = np.asarray(flax_forward("float32")(tight, images))
    got = _port_logits(spec, tight, images, "float32")
    assert np.isfinite(want).all() and _rel(got, want) < 1e-3

    fwd = build_forward(spec, from_jax_variables(tight), torch.float32, False, "cpu")
    bns = [m for m in fwd.modules() if isinstance(m, BatchNorm)]
    assert len(bns) == 53 and {m.eps for m in bns} == {RESNET_BN_EPS}
    for m in bns:
        m.eps = KERAS_BN_EPS
    with torch.inference_mode():
        keras_eps = fwd(torch.from_numpy(images)).numpy()
    assert _rel(keras_eps, want) > 1e-3


def test_param_count_matches_keras_resnet50():
    """keras.applications.ResNet50 (1000 classes) has 25,636,712 weights,
    BatchNorm statistics included, as the flax tree counts them."""
    model = create_model(RESNET50_IMAGENET)
    total = sum(t.numel() for t in model.state_dict().values())
    assert total == 25_636_712
    assert not has_fast_forward(RESNET50_IMAGENET)
    assert not resolve_fast(RESNET50_IMAGENET, torch.bfloat16, "auto", "cuda")


def test_weights_round_trip_and_tree(tiny):
    jspec, _, variables, _ = tiny
    back = to_jax_variables(from_jax_variables(variables))
    flat_a = jax.tree_util.tree_leaves_with_path(variables)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(flat_b[path], leaf)
    want = jax.eval_shape(lambda: jax_create_model(jspec).init(
        jax.random.PRNGKey(0), jnp.zeros((1, *jspec.input_shape))))
    shapes = lambda t: {jax.tree_util.keystr(p): tuple(l.shape)  # noqa: E731
                        for p, l in jax.tree_util.tree_leaves_with_path(t)}
    assert shapes(variables) == shapes(want)


def test_stage_downsampling(tiny):
    """64 px: the stem halves to 32, the pool to 16, stages 3-5 halve each
    to 2x2 before the global pool (total stride 32), 4x the bottleneck
    width out of every block."""
    _, spec, variables, images = tiny
    model = create_model(spec)
    model.load_state_dict(from_jax_variables(variables))
    seen = {}

    def hook(name):
        def record(module, args, out):
            seen[name] = tuple(out.shape)
        return record

    for name in model.blocks:
        model._modules[name].register_forward_hook(hook(name))
    with torch.inference_mode():
        model(torch.zeros((2, *spec.input_shape)))
    want = {2: (16, 256), 3: (8, 512), 4: (4, 1024), 5: (2, 2048)}
    assert len(seen) == 16
    for name, shape in seen.items():
        hw, c = want[int(name[4])]
        assert shape == (2, hw, hw, c), name


def _post(port: int, name: str, images: np.ndarray) -> np.ndarray:
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/models/{name}:predict",
        data=protocol.encode_predict_request(images), method="POST",
        headers={"Content-Type": protocol.MSGPACK_CONTENT_TYPE})
    with urllib.request.urlopen(req, timeout=120) as r:
        return protocol.decode_predict_response(r.read(), r.headers["Content-Type"])[0]


def test_port_server_serves_resnet_like_the_jax_server(tiny, tmp_path):
    """One f32 artifact written by the JAX exporter, served by the JAX
    model server and by the port's (the CPU, exact f32 graph): the same
    logits for a 1-image and a 3-image request, and the same spec."""
    from kubernetes_deep_learning_tpu.serving.model_server import ModelServer as JaxModelServer

    jspec, _, variables, images = tiny
    register_spec(jspec)
    root = str(tmp_path / "models")
    export_model(jspec, variables, root, dtype=np.float32)
    jax_server = JaxModelServer(root, port=0, buckets=(1, 4), host="127.0.0.1")
    port_server = ModelServer(root, port=0, buckets=(1, 4), device="cpu")
    try:
        for s in (jax_server, port_server):
            s.warmup()
            s.start()
        assert not port_server.engines[jspec.name].fast
        for batch in (images[:1], images[1:4]):
            want = _post(jax_server.port, jspec.name, batch)
            got = _post(port_server.port, jspec.name, batch)
            assert got.shape == (len(batch), 4)
            assert _rel(got, want) < 1e-3
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port_server.port}/v1/models/{jspec.name}", timeout=30) as r:
            assert json.loads(r.read())["family"] == "resnet50"
    finally:
        port_server.shutdown()
        jax_server.shutdown()
