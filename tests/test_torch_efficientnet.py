"""The port's EfficientNet (exact graph and fast path) against the JAX package.

An ``efficientnet-b0`` spec at 64 px: every stage, 11 of its 16 blocks
fused on the fast path (the stride-1 openers of stages 5 and 7 with
``residual=False``).  Weights and images are made with numpy from a seed
and handed to both frameworks.  Tolerances, relative to the largest logit:
the exact f32 graph within 1e-3 of ``EfficientNet.apply`` (the same f32
arithmetic summed in another order); the bf16 exact graph and the bf16
fast path (the fused blocks in their plain version on the CPU) within
2e-2 of the flax bf16 graph, as the JAX package's own fast-path test.
Whole networks are compared with the jitted flax graph; the Pallas kernel
in interpret mode is compared per block in ``test_torch_fused_mbconv.py``.
"""

from __future__ import annotations

import collections

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubernetes_deep_learning_tpu.export import export_model
from kubernetes_deep_learning_tpu.models import build_forward as jax_build_forward
from kubernetes_deep_learning_tpu.models import create_model as jax_create_model
from kubernetes_deep_learning_tpu.models.efficientnet_fast import block_plan as jax_block_plan
from kubernetes_deep_learning_tpu.modelspec import ModelSpec as JaxModelSpec
from kubernetes_deep_learning_tpu.modelspec import register_spec
from kubernetes_deep_learning_tpu_torch.export import artifact as art
from kubernetes_deep_learning_tpu_torch.modelspec import EFFICIENTNET_B3_IMAGENET, ModelSpec
from kubernetes_deep_learning_tpu_torch.models import (
    build_forward,
    create_model,
    has_fast_forward,
    init_variables,
    resolve_fast,
)
from kubernetes_deep_learning_tpu_torch.models.efficientnet import block_plan
from kubernetes_deep_learning_tpu_torch.models.efficientnet_fast import block_routes
from kubernetes_deep_learning_tpu_torch.ops import fused_mbconv
from kubernetes_deep_learning_tpu_torch.runtime import InferenceEngine
from kubernetes_deep_learning_tpu_torch.weights import from_jax_variables, to_jax_variables
from torch_threads import one_torch_thread  # noqa: F401

_SPEC_KW = dict(name="torch-tiny-effnet-b0", family="efficientnet-b0", input_shape=(64, 64, 3),
                labels=("a", "b", "c"), preprocessing="torch")


def _rel(got, want) -> float:
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-6))


@pytest.fixture(scope="module")
def b0():
    """(jax spec, port spec, variables (numpy flax tree), 5 uint8 images)."""
    jspec, spec = JaxModelSpec(**_SPEC_KW), ModelSpec(**_SPEC_KW)
    variables = init_variables(spec, seed=3)  # BN statistics away from (0, 1)
    images = np.random.default_rng(0).integers(0, 256, (5, *spec.input_shape), np.uint8)
    return jspec, spec, variables, images


@pytest.fixture(scope="module")
def flax_logits(b0):
    """The flax graph's logits per compute dtype (jitted once each)."""
    jspec, _, variables, images = b0
    cache = {}

    def get(dtype: str) -> np.ndarray:
        if dtype not in cache:
            fwd = jax_build_forward(jspec, jnp.dtype(dtype), fast=False)
            cache[dtype] = np.asarray(jax.jit(fwd)(variables, images), np.float32)
        return cache[dtype]

    return get


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-3), ("bfloat16", 2e-2)])
def test_exact_graph_matches_flax(b0, flax_logits, dtype, tol):
    _, spec, variables, images = b0
    fwd = build_forward(spec, from_jax_variables(variables), getattr(torch, dtype), False, "cpu")
    assert not fwd.fast
    with torch.inference_mode():
        got = fwd(torch.from_numpy(images)).numpy()
    assert got.shape == (5, 3) and got.dtype == np.float32
    assert _rel(got, flax_logits(dtype)) < tol


def test_fast_forward_matches_flax_bf16(b0, flax_logits):
    """EfficientNetFast at batch 5 (no padding to 8 in the port)."""
    _, spec, variables, images = b0
    fwd = build_forward(spec, from_jax_variables(variables), torch.bfloat16, True, "cpu")
    assert fwd.fast
    routes = fwd.inner.routes(64, 64)
    assert sum(b.fused for b in routes) == 11 and len(routes) == 16
    fused_mbconv.reset_launch_counts()
    with torch.inference_mode():
        got = fwd(torch.from_numpy(images)).numpy()
    assert fused_mbconv.launch_counts()["fused_mbconv_block"] == 0  # CPU: plain version
    assert got.shape == (5, 3) and np.isfinite(got).all()
    assert _rel(got, flax_logits("bfloat16")) < 2e-2


def test_block_plan_and_routes_b3():
    """B3 at 300 px: 26 blocks, 18 fused, in 7 shapes; the stride-1 stage
    openers block13 and block24 fused without the residual."""
    plan = block_plan(1.2, 1.4)
    assert plan == [tuple(b) for b in jax_block_plan(1.2, 1.4)]
    routes = block_routes(plan, 150, 150, 40)
    fused = [b for b in routes if b.fused]
    assert len(routes) == 26 and len(fused) == 18
    assert [b.name for b in fused if not b.residual] == ["block13", "block24"]
    shapes = collections.Counter(
        (b.h, b.c_in, b.c_in * b.expand, b.features, b.kernel, b.residual) for b in fused)
    assert shapes == {
        (38, 48, 288, 48, 5, True): 2,
        (19, 96, 576, 96, 3, True): 4,
        (19, 96, 576, 136, 5, False): 1,
        (19, 136, 816, 136, 5, True): 4,
        (10, 232, 1392, 232, 5, True): 5,
        (10, 232, 1392, 384, 3, False): 1,
        (10, 384, 2304, 384, 3, True): 1,
    }
    # The high-resolution stages (150 and 75 px) and every stride-2 opener stay unfused.
    assert all(b.h <= 38 and b.stride == 1 for b in fused)


def test_weights_round_trip_and_tree(b0):
    jspec, spec, variables, _ = b0
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


def test_jax_exported_artifact_serves_on_port_engine(b0, flax_logits, tmp_path):
    """A B0 artifact written by the JAX exporter (f32 compute), served by
    the port's engine on the CPU (the exact f32 graph) against flax."""
    jspec, _, variables, images = b0
    register_spec(jspec)
    d = export_model(jspec, variables, str(tmp_path), dtype=np.float32)
    engine = InferenceEngine(art.load_artifact(d), buckets=(2, 8), device="cpu")
    assert not engine.fast
    engine.warmup()
    got = engine.predict(images)
    assert got.shape == (5, 3) and np.isfinite(got).all()
    assert _rel(got, flax_logits("float32")) < 1e-3


def test_b3_spec_routing_and_size():
    from kubernetes_deep_learning_tpu.modelspec import EFFICIENTNET_B3_IMAGENET as JAX_B3

    spec = EFFICIENTNET_B3_IMAGENET
    assert spec.to_json() == JAX_B3.to_json()
    assert has_fast_forward(spec)
    assert resolve_fast(spec, torch.bfloat16, "auto", "cuda")
    assert not resolve_fast(spec, torch.bfloat16, "auto", "cpu")
    assert not resolve_fast(spec, torch.float32, "auto", "cuda")
    assert not resolve_fast(spec, torch.bfloat16, False, "cuda")
    # EfficientNet-B3 with 1000 classes: 12.2 M parameters and statistics
    # (the JAX package's test_param_count_matches_b3 band).
    total = sum(t.numel() for t in create_model(spec).state_dict().values())
    assert 11_900_000 < total < 12_600_000, total
