"""The port's Xception (exact graph and fast path) against the JAX package.

Inputs and weights are made with numpy from a seed and handed to both
frameworks.  Tolerances: the exact float32 graph within 1e-3 of
``Xception.apply`` (the two frameworks sum convolutions in different
orders); the bf16 fast path within 2e-2 relative of the JAX fast path run
in Pallas interpret mode (bf16 rounds at slightly different points).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubernetes_deep_learning_tpu.models import build_forward as jax_build_forward
from kubernetes_deep_learning_tpu.models import init_variables as jax_init_variables
from kubernetes_deep_learning_tpu.models.xception import Xception as JaxXception
from kubernetes_deep_learning_tpu.modelspec import ModelSpec as JaxModelSpec
from kubernetes_deep_learning_tpu.ops import preprocess as jax_preprocess
from kubernetes_deep_learning_tpu_torch.modelspec import ModelSpec
from kubernetes_deep_learning_tpu_torch.models import (
    build_forward,
    init_variables,
    resolve_fast,
)
from kubernetes_deep_learning_tpu_torch.models.layers import max_pool_same, same_pads
from kubernetes_deep_learning_tpu_torch.ops.preprocess import normalize
from kubernetes_deep_learning_tpu_torch.weights import from_jax_variables, to_jax_variables
from torch_threads import one_torch_thread  # noqa: F401

_SPEC_KW = dict(
    name="torch-tiny-xception",
    family="xception",
    input_shape=(96, 96, 3),
    labels=("a", "b", "c", "d"),
    preprocessing="tf",
    head_hidden=(16,),
)


@pytest.fixture(scope="module")
def specs():
    return JaxModelSpec(**_SPEC_KW), ModelSpec(**_SPEC_KW)


@pytest.fixture(scope="module")
def variables(specs):
    """Flax-initialized variables with jittered BN statistics (numpy)."""
    jspec, _ = specs
    v = jax.tree_util.tree_map(np.asarray, jax_init_variables(jspec, seed=3))
    rng = np.random.default_rng(2)

    def jitter(tree):
        for k, leaf in tree.items():
            if isinstance(leaf, dict):
                jitter(leaf)
            elif k == "mean":
                tree[k] = rng.normal(0, 0.05, leaf.shape).astype(np.float32)
            elif k == "var":
                tree[k] = rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)

    jitter(v["batch_stats"])
    return v


@pytest.fixture(scope="module")
def images(specs):
    rng = np.random.default_rng(11)
    return rng.integers(0, 256, (2, *specs[0].input_shape), np.uint8)


def test_weights_round_trip(variables):
    back = to_jax_variables(from_jax_variables(variables))
    flat_a = jax.tree_util.tree_leaves_with_path(variables)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(flat_b[path], leaf)


def test_exact_graph_matches_flax_f32(specs, variables, images):
    jspec, spec = specs
    x = jax_preprocess.normalize(images, "tf")
    want = np.asarray(JaxXception(4, head_hidden=(16,)).apply(variables, x))
    fwd = build_forward(spec, from_jax_variables(variables), torch.float32, False, "cpu")
    with torch.inference_mode():
        got = fwd(torch.from_numpy(images)).numpy()
    assert got.shape == (2, 4)
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3)


def test_fast_forward_matches_jax_fast_path(specs, variables, images):
    """Plain kernel versions (CPU) vs build_fast_forward(interpret=True)."""
    from kubernetes_deep_learning_tpu.models.xception_fast import build_fast_forward

    jspec, spec = specs
    x = jax_preprocess.normalize(jnp.asarray(images), "tf")
    jfast = build_fast_forward(jspec, dtype=jnp.bfloat16, interpret=True)
    want = np.asarray(jax.jit(jfast)(variables, x), np.float32)
    fwd = build_forward(spec, from_jax_variables(variables), torch.bfloat16, True, "cpu")
    assert fwd.fast
    with torch.inference_mode():
        got = fwd(torch.from_numpy(images)).numpy()
    rel = np.abs(got - want).max() / (np.abs(want).max() + 1e-6)
    assert rel < 2e-2, f"fast path diverges from the JAX fast path: {rel:.2e}"


def test_exact_bf16_graph_matches_flax_bf16(specs, variables, images):
    jspec, spec = specs
    want = np.asarray(jax.jit(jax_build_forward(jspec, jnp.bfloat16, fast=False))(variables, images))
    fwd = build_forward(spec, from_jax_variables(variables), torch.bfloat16, False, "cpu")
    with torch.inference_mode():
        got = fwd(torch.from_numpy(images)).numpy()
    rel = np.abs(got - want).max() / (np.abs(want).max() + 1e-6)
    assert rel < 2e-2, f"bf16 exact graph diverges from flax bf16: {rel:.2e}"


@pytest.mark.parametrize("size", [74, 12, 6, 147, 45])
def test_max_pool_same_matches_flax(size):
    """TF-SAME pooling: even sides pad (0, 1), odd sides (1, 1)."""
    import flax.linen as nn

    rng = np.random.default_rng(size)
    x = rng.normal(0, 1, (2, size, size, 5)).astype(np.float32)
    want = np.asarray(nn.max_pool(x, (3, 3), strides=(2, 2), padding="SAME"))
    got = max_pool_same(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)
    assert same_pads(size, 3, 2) == ((0, 1) if size % 2 == 0 else (1, 1))


@pytest.mark.parametrize("mode", ["tf", "caffe", "torch", "none"])
def test_normalize_bit_equal_to_numpy(mode):
    rng = np.random.default_rng(4)
    x = rng.integers(0, 256, (2, 7, 5, 3), np.uint8)
    want = np.asarray(jax_preprocess.normalize(x, mode))
    got = normalize(torch.from_numpy(x), mode).numpy()
    np.testing.assert_array_equal(got, want)


def test_init_variables_matches_flax_tree(specs):
    """The port's seeded init builds exactly the flax tree's leaves and shapes."""
    jspec, spec = specs
    want = jax.eval_shape(lambda: jax_init_variables(jspec, seed=0))
    got = init_variables(spec, seed=1)
    want_shapes = {jax.tree_util.keystr(p): l.shape for p, l in jax.tree_util.tree_leaves_with_path(want)}
    got_shapes = {jax.tree_util.keystr(p): l.shape for p, l in jax.tree_util.tree_leaves_with_path(got)}
    assert got_shapes == want_shapes


def test_resolve_fast_and_device_rules(specs):
    _, spec = specs
    assert not resolve_fast(spec, torch.bfloat16, "auto", "cpu")
    assert resolve_fast(spec, torch.bfloat16, "auto", "cuda")
    assert not resolve_fast(spec, torch.float32, "auto", "cuda")
    assert resolve_fast(spec, torch.float32, True, "cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build_forward(spec, {}, device="cuda")


@pytest.mark.parametrize("batch", [2, 3])
def test_entry_kernel_forward_matches_jax_and_flax(specs, variables, batch):
    """``XceptionFast(entry_kernel=True)`` (plain kernel versions on the
    CPU; the 96-px spec's conv1 gives 47 -> 45 -> 23 -> 12 -> 6) against
    ``build_fast_forward(entry_kernel=True, interpret=True)`` and the flax
    bf16 graph, within 2e-2 relative."""
    from kubernetes_deep_learning_tpu.models.xception_fast import build_fast_forward
    from kubernetes_deep_learning_tpu_torch.models import Forward, create_model
    from kubernetes_deep_learning_tpu_torch.models.xception_fast import XceptionFast
    from kubernetes_deep_learning_tpu_torch.ops import fused_entry

    jspec, spec = specs
    images = np.random.default_rng(20 + batch).integers(0, 256, (batch, 96, 96, 3), np.uint8)
    x = jax_preprocess.normalize(jnp.asarray(images), "tf")
    jfast = build_fast_forward(jspec, dtype=jnp.bfloat16, interpret=True, entry_kernel=True)
    want_fast = np.asarray(jax.jit(jfast)(variables, x), np.float32)
    want_flax = np.asarray(
        jax.jit(jax_build_forward(jspec, jnp.bfloat16, fast=False))(variables, images))
    model = create_model(spec, torch.bfloat16)
    model.load_state_dict(from_jax_variables(variables))
    fwd = Forward(spec, XceptionFast(model.eval(), entry_kernel=True), True)
    fused_entry.reset_launch_counts()
    with torch.inference_mode():
        got = fwd(torch.from_numpy(images)).numpy()
    assert fused_entry.launch_counts()["fused_entry_block"] == 0  # CPU: plain version
    assert got.shape == (batch, 4)
    for name, want in (("JAX entry-kernel fast path", want_fast), ("flax bf16", want_flax)):
        rel = np.abs(got - want).max() / (np.abs(want).max() + 1e-6)
        assert rel < 2e-2, f"entry-kernel forward diverges from {name}: {rel:.2e}"
