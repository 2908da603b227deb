"""The port's ViT, its weights and its engine against the JAX package.

vit-tiny (patch 8, width 64, 2 heads of 32, depth 2) at 32 px gives 16
tokens (the einsum route) and at 256 px 1024 tokens (the flash route, in
its plain version on the CPU; JAX's CPU lowering takes its einsum
fallback there).  Weights and images are made with numpy from a seed and
handed to both frameworks.  Tolerances, relative to the largest logit: the
exact f32 graph within 1e-3 (the same f32 arithmetic summed in another
order); bf16 within 2e-2 (bf16 rounds at slightly different points).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubernetes_deep_learning_tpu.export import artifact as jax_art
from kubernetes_deep_learning_tpu.export import export_model
from kubernetes_deep_learning_tpu.models import build_forward as jax_build_forward
from kubernetes_deep_learning_tpu.models import init_variables as jax_init_variables
from kubernetes_deep_learning_tpu.modelspec import ModelSpec as JaxModelSpec
from kubernetes_deep_learning_tpu.modelspec import register_spec
from kubernetes_deep_learning_tpu.runtime.engine import InferenceEngine as JaxEngine
from kubernetes_deep_learning_tpu_torch.export import artifact as art
from kubernetes_deep_learning_tpu_torch.modelspec import VIT_B16_IMAGENET, ModelSpec
from kubernetes_deep_learning_tpu_torch.models import (
    build_forward,
    create_model,
    init_variables,
    resolve_fast,
)
from kubernetes_deep_learning_tpu_torch.ops import attention
from kubernetes_deep_learning_tpu_torch.runtime import InferenceEngine
from kubernetes_deep_learning_tpu_torch.weights import from_jax_variables, to_jax_variables
from torch_threads import one_torch_thread  # noqa: F401


def _spec_kw(px: int) -> dict:
    return dict(name=f"torch-tiny-vit-{px}", family="vit-tiny", input_shape=(px, px, 3),
                labels=("a", "b", "c", "d"), preprocessing="tf")


def _leaves(tree) -> dict:
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


def _rel(got, want) -> float:
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-6))


@pytest.fixture(scope="module", params=[32, 256], ids=["16tok", "1024tok"])
def tiny(request):
    """(jax spec, port spec, flax variables with random LayerNorm affines, uint8 images)."""
    px = request.param
    jspec, spec = JaxModelSpec(**_spec_kw(px)), ModelSpec(**_spec_kw(px))
    variables = jax.tree_util.tree_map(np.asarray, jax_init_variables(jspec, seed=4))
    rng = np.random.default_rng(px)

    def jitter(tree):  # flax inits LayerNorm to (1, 0) and biases to 0
        for k, leaf in tree.items():
            if isinstance(leaf, dict):
                jitter(leaf)
            elif k in ("bias", "scale"):
                tree[k] = (leaf + rng.normal(0, 0.05, leaf.shape)).astype(np.float32)

    jitter(variables["params"])
    images = rng.integers(0, 256, (2, px, px, 3), np.uint8)
    return jspec, spec, variables, images


def test_weights_round_trip_vit_tree(tiny):
    _, _, variables, _ = tiny
    params = from_jax_variables(variables)
    assert params["block_0.attn.query.kernel"].shape == (64, 2, 32)
    assert params["block_0.attn.out.kernel"].shape == (2, 32, 64)
    back = to_jax_variables(params)
    assert back.keys() == variables.keys() == {"params"}
    want, got = _leaves(variables), _leaves(back)
    assert want.keys() == got.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


def test_init_variables_matches_flax_tree(tiny):
    jspec, spec, _, _ = tiny
    want = jax.eval_shape(lambda: jax_init_variables(jspec, seed=0))
    got = init_variables(spec, seed=1)
    assert {k: v.shape for k, v in _leaves(got).items()} == {
        jax.tree_util.keystr(p): leaf.shape
        for p, leaf in jax.tree_util.tree_leaves_with_path(want)}
    assert abs(float(np.std(got["params"]["pos_embed"])) - 0.02) < 5e-3


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_matches_flax(tiny, dtype, monkeypatch):
    jspec, spec, variables, images = tiny
    jdt = None if dtype == "float32" else jnp.bfloat16
    want = np.asarray(jax.jit(jax_build_forward(jspec, jdt, fast=False))(variables, images))
    fwd = build_forward(spec, from_jax_variables(variables), getattr(torch, dtype), "auto", "cpu")
    assert not fwd.fast  # ViT's kernel sits inside its attention
    flash_calls = []
    plain = attention.flash_attention_reference
    monkeypatch.setattr(attention, "flash_attention_reference",
                        lambda *a, **kw: flash_calls.append(1) or plain(*a, **kw))
    attention.reset_launch_counts()
    with torch.inference_mode():
        got = fwd(torch.from_numpy(images)).numpy()
    assert attention.launch_counts()["flash_attention"] == 0  # CPU: plain version
    assert len(flash_calls) == (2 if spec.input_shape[0] == 256 else 0)  # one per block
    assert got.shape == (2, 4) and got.dtype == np.float32
    assert _rel(got, want) < (1e-3 if dtype == "float32" else 2e-2)


def test_jax_exported_artifact_serves_on_port_engine(tiny, tmp_path):
    """A vit-tiny artifact written by the JAX exporter (f32 compute), served
    by the port's engine on the CPU, against the JAX engine on it."""
    jspec, _, variables, images = tiny
    register_spec(jspec)
    d = export_model(jspec, variables, str(tmp_path), dtype=np.float32)
    jax_engine = JaxEngine(jax_art.load_artifact(d), buckets=(1, 2), use_exported=True)
    jax_engine.warmup()
    want = jax_engine.predict(images)
    engine = InferenceEngine(art.load_artifact(d), buckets=(1, 2), device="cpu")
    assert not engine.fast
    engine.warmup()
    got = engine.predict(images)
    assert got.shape == (2, 4) and np.isfinite(got).all()
    assert _rel(got, want) < 1e-3
    assert _rel(engine.predict(images[:1]), want[:1]) < 1e-3


def test_vit_specs_and_routing():
    from kubernetes_deep_learning_tpu.modelspec import VIT_B16_IMAGENET as JAX_VIT

    assert VIT_B16_IMAGENET.to_json() == JAX_VIT.to_json()
    assert not resolve_fast(VIT_B16_IMAGENET, torch.bfloat16, "auto", "cuda")
    assert (256 // 16) ** 2 <= attention.EINSUM_MAX_SEQ < (384 // 16) ** 2
    with pytest.raises(ValueError, match="not divisible by patch size"):
        create_model(ModelSpec(**{**_spec_kw(36), "input_shape": (36, 36, 3)}))
