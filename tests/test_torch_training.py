"""The port's training path (trainer, loop, data, checkpoint, export)
against the JAX package's, on the CPU.

vit-tiny (patch 8, width 64, 2 heads of 32, depth 2) with 3 classes, as
``tests/test_training.py``'s ``tiny_train_spec``: at 16 px (4 tokens, the
``attend_block`` route of the trainable attention) and at 64 px (64
tokens, the partials route: K3P's plain version here).  The same flax
variables, carried across with ``weights.from_jax_variables``, and the
same uint8 batches go through both packages.  JAX's trainable attention
takes its ``attend_block`` reference on the CPU.

Tolerances, each from the arithmetic compared:
- train-mode logits: 1e-4 relative to the largest (f32 throughout, sums
  in another order);
- loss 1e-5 relative, accuracy exact;
- SGD: the update (new - old parameter) within 1e-4 of the largest
  update of its tensor (f32 gradients summed in another order), plus
  1e-6: a few ulps of parameters near 1, the floor for tensors whose
  gradient is zero up to rounding (the key projection's bias: softmax
  does not see a shift shared by all keys);
- Adam: every parameter within 1e-2 * lr of JAX's after three steps.
  Adam divides each gradient by its own running RMS, so the relative
  rounding error of a gradient element passes into its step at full
  size: an element whose gradient is the small difference of large terms
  (relative error ~1e-3 here) moves by ~1e-3 * lr more or less, one
  whose gradient is pure noise by up to lr.  The key projection's bias is the
  exception: its gradient is zero in exact arithmetic (see SGD), so Adam
  moves it by noise in both packages; it is held within Adam's bound of
  lr per step.
"""

from __future__ import annotations

import dataclasses
import functools
import itertools
import os
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from kubernetes_deep_learning_tpu.export import artifact as jax_art
from kubernetes_deep_learning_tpu.models import create_model as jax_create_model
from kubernetes_deep_learning_tpu.models import init_variables as jax_init_variables
from kubernetes_deep_learning_tpu.modelspec import ModelSpec as JaxModelSpec
from kubernetes_deep_learning_tpu.ops.preprocess import normalize as jax_normalize
from kubernetes_deep_learning_tpu.runtime.engine import InferenceEngine as JaxEngine
from kubernetes_deep_learning_tpu.training import data as jax_data
from kubernetes_deep_learning_tpu.training import loop as jax_loop
from kubernetes_deep_learning_tpu.training import trainer as jax_trainer
from kubernetes_deep_learning_tpu_torch.export import artifact as art
from kubernetes_deep_learning_tpu_torch.export.exporter import export_model
from kubernetes_deep_learning_tpu_torch.modelspec import ModelSpec
from kubernetes_deep_learning_tpu_torch.models import build_forward, create_model
from kubernetes_deep_learning_tpu_torch.ops import attention
from kubernetes_deep_learning_tpu_torch.ops.preprocess import normalize
from kubernetes_deep_learning_tpu_torch.runtime import InferenceEngine
from kubernetes_deep_learning_tpu_torch.training import (
    Checkpointer,
    PrefetchIterator,
    build_eval_step,
    build_train_step,
    create_train_state,
    evaluate,
    fit,
    fit_and_export,
    map_batches,
    synthetic_batches,
)
from kubernetes_deep_learning_tpu_torch.weights import from_jax_variables, to_jax_variables
from torch_threads import one_torch_thread  # noqa: F401


def _spec_kw(px: int) -> dict:
    return dict(name=f"torch-train-vit-{px}", family="vit-tiny", input_shape=(px, px, 3),
                labels=("a", "b", "c"), preprocessing="tf")


def _leaves(tree) -> dict:
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-12))


def _batch(spec, n: int, seed: int):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (n, *spec.input_shape), np.uint8),
            rng.integers(0, spec.num_classes, (n,), np.int32))


def _sgd(lr):
    return functools.partial(torch.optim.SGD, lr=lr)


def _adam(lr):
    return functools.partial(torch.optim.Adam, lr=lr, eps=1e-8)


@pytest.fixture(scope="module", params=[16, 64], ids=["4tok", "64tok"])
def tiny(request):
    """(jax spec, port spec, flax variables with random LayerNorm affines)."""
    px = request.param
    jspec, spec = JaxModelSpec(**_spec_kw(px)), ModelSpec(**_spec_kw(px))
    variables = jax.tree_util.tree_map(np.asarray, jax_init_variables(jspec, seed=3))
    rng = np.random.default_rng(px)

    def jitter(tree):  # flax inits LayerNorm to (1, 0) and biases to 0
        for k, leaf in tree.items():
            if isinstance(leaf, dict):
                jitter(leaf)
            elif k in ("bias", "scale"):
                tree[k] = (leaf + rng.normal(0, 0.05, leaf.shape)).astype(np.float32)

    jitter(variables["params"])
    return jspec, spec, variables


@pytest.fixture(scope="module")
def tiny16():
    return ModelSpec(**_spec_kw(16))


def test_train_mode_forward_matches_flax(tiny, monkeypatch):
    jspec, spec, variables = tiny
    images, _ = _batch(spec, 4, 0)
    x = jax_normalize(jnp.asarray(images), "tf")
    want = np.asarray(jax_create_model(jspec).apply(variables, x, train=True))
    model = create_model(spec)
    model.load_state_dict(from_jax_variables(variables))
    calls = []
    plain = attention.flash_attention_partials_reference
    monkeypatch.setattr(attention, "flash_attention_partials_reference",
                        lambda *a, **kw: calls.append(1) or plain(*a, **kw))
    got = model(normalize(torch.from_numpy(images), "tf"), train=True)
    assert got.shape == (4, 3) and got.dtype == torch.float32
    assert _rel(got.detach().numpy(), want) < 1e-4
    assert len(calls) == (2 if spec.input_shape[0] == 64 else 0)  # partials: one per block


def _jax_step(jspec, variables, tx, batches):
    state = jax_trainer.create_train_state(jspec, tx, variables=jax.tree_util.tree_map(
        jnp.array, variables))
    step = jax_trainer.build_train_step(jspec, tx)
    metrics = []
    for images, labels in batches:
        state, m = step(state, images, labels)
        metrics.append({k: float(v) for k, v in m.items()})
    return state, metrics


def _port_step(spec, variables, tx, batches):
    state = create_train_state(spec, tx, variables=variables, device="cpu")
    step = build_train_step(spec)
    metrics = []
    for images, labels in batches:
        state, m = step(state, images, labels)
        metrics.append({k: float(v) for k, v in m.items()})
    return state, metrics


def test_sgd_step_matches_jax(tiny):
    jspec, spec, variables = tiny
    batches = [_batch(spec, 8, 1)]
    jstate, jm = _jax_step(jspec, variables, optax.sgd(0.5), batches)
    state, m = _port_step(spec, variables, _sgd(0.5), batches)
    assert state.step == int(jstate.step) == 1
    assert abs(m[0]["loss"] - jm[0]["loss"]) <= 1e-5 * abs(jm[0]["loss"])
    assert m[0]["accuracy"] == jm[0]["accuracy"]
    old, want, got = _leaves(variables), _leaves({"params": jstate.params}), _leaves(
        state.variables())
    assert want.keys() == got.keys()
    assert max(np.abs(want[k] - old[k]).max() for k in want) > 1e-2
    for k in want:
        upd_want, upd_got = want[k] - old[k], got[k] - old[k]
        err = np.abs(upd_got - upd_want).max()
        assert err <= 1e-4 * np.abs(upd_want).max() + 1e-6, (k, err)


def test_adam_steps_match_jax(tiny):
    jspec, spec, variables = tiny
    lr = 1e-2
    batches = [_batch(spec, 8, s) for s in (2, 3, 4)]
    jstate, jm = _jax_step(jspec, variables, optax.adam(lr), batches)
    state, m = _port_step(spec, variables, _adam(lr), batches)
    assert state.step == 3
    for a, b in zip(m, jm):
        assert abs(a["loss"] - b["loss"]) <= 1e-5 * abs(b["loss"])
        assert a["accuracy"] == b["accuracy"]
    old, want, got = _leaves(variables), _leaves({"params": jstate.params}), _leaves(
        state.variables())
    for k in want:
        if "['key']['bias']" in k:
            # Zero gradient in exact arithmetic: Adam normalises its
            # rounding noise into steps of up to lr in both packages.
            assert np.abs(got[k] - old[k]).max() <= 3 * lr * (1 + 1e-6), k
            continue
        assert np.abs(want[k] - old[k]).max() > 0.5 * lr, k  # Adam moved it by ~lr per step
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-2 * lr, err_msg=k)


def test_eval_step_and_evaluate_match_jax(tiny):
    jspec, spec, variables = tiny
    jstate = jax_trainer.create_train_state(jspec, optax.sgd(1e-3), variables=variables)
    state = create_train_state(spec, _sgd(1e-3), variables=variables, device="cpu")
    images, labels = _batch(spec, 6, 5)
    valid = np.array([1, 1, 0, 1, 0, 1], np.float32)
    want = jax_trainer.build_eval_step(jspec, topk=2)(jstate, images, labels, valid)
    got = build_eval_step(spec, topk=2)(state, images, labels, valid)
    assert float(got["count"]) == float(want["count"]) == 4
    for key in ("top1_sum", "topk_sum"):
        assert float(got[key]) == float(want[key]), key
    assert abs(float(got["loss_sum"]) - float(want["loss_sum"])) <= 1e-5 * float(want["loss_sum"])

    def uneven():  # batches of 3 and 5
        rng = np.random.default_rng(8)
        for n in (3, 5):
            yield (rng.integers(0, 256, (n, *spec.input_shape), np.uint8),
                   rng.integers(0, spec.num_classes, (n,), np.int32))

    m, jm = evaluate(spec, state, uneven()), jax_loop.evaluate(jspec, jstate, uneven())
    assert m["count"] == jm["count"] == 8
    assert m["val_top1"] == jm["val_top1"] and m["val_topk"] == jm["val_topk"] == 1.0
    assert abs(m["val_loss"] - jm["val_loss"]) <= 1e-5 * jm["val_loss"]


def test_synthetic_batches_are_bit_equal_to_jax(tiny16):
    want = jax_data.synthetic_batches(JaxModelSpec(**_spec_kw(16)), 4, steps=3, seed=7)
    got = list(synthetic_batches(tiny16, 4, steps=3, seed=7))
    assert len(got) == 3
    for (gi, gl), (wi, wl) in zip(got, want, strict=True):
        assert gi.dtype == wi.dtype and gl.dtype == wl.dtype
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gl, wl)
    doubled = list(map_batches(synthetic_batches(tiny16, 2, steps=2), lambda b: b[1] * 2))
    assert [d.shape for d in doubled] == [(2,), (2,)]


def test_fit_runs_periodic_and_final_eval(tiny16):
    logs: list[str] = []
    eval_hist: list = []
    state, hist = fit(
        tiny16, _sgd(1e-3), synthetic_batches(tiny16, 4, steps=4), steps=4, log_fn=logs.append,
        eval_batches=lambda: synthetic_batches(tiny16, 4, steps=2, seed=9), eval_every=2,
        eval_history=eval_hist, device="cpu")
    assert state.step == 4
    assert hist[-1][0] == 4
    assert [s for s, _ in eval_hist] == [2, 4]
    for _, m in eval_hist:
        assert set(m) >= {"val_loss", "val_top1", "val_topk", "count"}
        assert m["count"] == 8
    assert sum("eval step" in line for line in logs) == 2


def test_fit_loss_falls_on_a_repeated_batch(tiny16):
    batch = _batch(tiny16, 8, 11)
    _, hist = fit(tiny16, _adam(1e-2), itertools.repeat(batch, 8), steps=8, log_every=1,
                  log_fn=lambda s: None, device="cpu")
    assert [s for s, _ in hist] == list(range(1, 9))
    assert hist[-1][1] < 0.5 * hist[0][1]


def test_fit_resumes_from_checkpoint_as_if_uninterrupted(tiny16, tmp_path):
    """4 steps with checkpoints, then a new fit to 6 from the directory,
    equals 6 steps in one run; the checkpoint copy is taken at save time."""
    src = list(synthetic_batches(tiny16, 4, steps=6, seed=2))
    whole, _ = fit(tiny16, _adam(1e-2), iter(src), steps=6, device="cpu", log_fn=lambda s: None)
    ckpt = str(tmp_path / "ckpt")
    first, _ = fit(tiny16, _adam(1e-2), iter(src[:4]), steps=4, ckpt_dir=ckpt, ckpt_every=2,
                   device="cpu", log_fn=lambda s: None)
    assert Checkpointer(ckpt).all_steps() == [2, 4]
    logs: list[str] = []
    resumed, hist = fit(tiny16, _adam(1e-2), iter(src[4:]), steps=6, ckpt_dir=ckpt,
                        seed=99, device="cpu", log_fn=logs.append)
    assert any("resumed" in line and "step 4" in line for line in logs)
    assert resumed.step == 6 and hist[-1][0] == 6
    for k, t in whole.params.items():
        torch.testing.assert_close(resumed.params[k], t, rtol=0, atol=1e-6)
    assert Checkpointer(ckpt).latest_step() == 6


def test_checkpoint_retention_and_restore_into_a_fresh_state(tiny16, tmp_path):
    state, _ = fit(tiny16, _adam(1e-2), synthetic_batches(tiny16, 4, steps=5), steps=5,
                   ckpt_dir=str(tmp_path), ckpt_every=1, max_to_keep=2, device="cpu",
                   log_fn=lambda s: None)
    ckpt = Checkpointer(str(tmp_path), max_to_keep=2)
    assert ckpt.all_steps() == [4, 5]
    assert not ckpt.save(state)  # step 5 is on disk already
    fresh = create_train_state(tiny16, _adam(1e-2), seed=5, device="cpu")
    assert ckpt.restore(fresh) is fresh and fresh.step == 5
    for k, t in state.params.items():
        assert torch.equal(fresh.params[k], t)
    want, got = state.optimizer.state_dict(), fresh.optimizer.state_dict()
    for i, s in want["state"].items():
        for key in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(got["state"][i][key], s[key])
    ckpt.close()
    assert Checkpointer(str(tmp_path / "empty")).restore(fresh) is None


def test_prefetch_iterator_yields_the_source_and_surfaces_errors(tiny16):
    src = list(synthetic_batches(tiny16, 2, steps=3))
    with PrefetchIterator(iter(src), device="cpu") as it:
        got = list(it)
    assert len(got) == 3
    for (gi, gl), (wi, wl) in zip(got, src):
        assert isinstance(gi, torch.Tensor) and np.array_equal(gi.numpy(), wi)
        assert np.array_equal(gl.numpy(), wl)

    def broken():
        yield src[0]
        raise RuntimeError("source failed")

    it = PrefetchIterator(broken(), device="cpu")
    next(it)
    with pytest.raises(RuntimeError, match="source failed"):
        next(it)
    it.close()


def test_prefetch_close_stops_an_endless_producer(tiny16):
    it = PrefetchIterator(synthetic_batches(tiny16, 2), device="cpu")
    next(it)
    t0 = time.monotonic()
    it.close()
    it.close()  # idempotent
    assert time.monotonic() - t0 < 5.0
    assert not it._thread.is_alive()
    assert not any(t.name == "kdlt-torch-prefetch" and t is it._thread
                   for t in threading.enumerate())


def test_fit_and_export_serves_in_both_packages(tiny16, tmp_path):
    """fit_and_export writes the next version; the JAX loader and engine
    read it, and the port's engine serves the trained module's logits."""
    root = str(tmp_path / "models")
    spec = tiny16
    first = export_model(spec, create_train_state(spec, _sgd(0.1), device="cpu").variables(),
                         root)
    assert first.endswith(os.path.join(spec.name, "1"))
    d = fit_and_export(spec, _sgd(0.1), synthetic_batches(spec, 4, steps=3, seed=4), 3, root,
                       device="cpu", log_fn=lambda s: None, ckpt_dir=str(tmp_path / "ckpt"))
    assert d.endswith(os.path.join(spec.name, "2"))
    assert sorted(os.listdir(os.path.join(root, spec.name))) == ["1", "2"]
    state = create_train_state(spec, _sgd(0.1), device="cpu")
    assert Checkpointer(str(tmp_path / "ckpt")).restore(state).step == 3
    params = {k: t.detach() for k, t in state.params.items()}

    loaded = jax_art.load_artifact(d)
    want_tree, got_tree = _leaves(to_jax_variables(params)), _leaves(loaded.variables)
    assert want_tree.keys() == got_tree.keys()
    for k in want_tree:
        np.testing.assert_array_equal(got_tree[k], want_tree[k])
    assert loaded.spec == JaxModelSpec(**_spec_kw(16)) and loaded.exported_bytes is None
    jax_engine = JaxEngine(dataclasses.replace(loaded, metadata={"compute_dtype": "float32"}),
                           buckets=(2,), use_exported=False, fast=False)
    images, _ = _batch(spec, 2, 12)
    x = (images.astype(np.float32) / 127.5 - 1.0).astype(np.float32)

    engine = InferenceEngine(art.load_artifact(d), buckets=(2,), device="cpu")
    assert engine.compute_dtype == torch.bfloat16
    with torch.no_grad():
        for dtype, imgs in ((torch.bfloat16, images), (torch.float32, x)):
            want = build_forward(spec, params, dtype, "auto", "cpu")(torch.from_numpy(imgs))
            got = engine.predict(imgs)
            np.testing.assert_allclose(got, want.numpy(), rtol=0, atol=1e-6)
        exact = engine.predict(x)
    assert _rel(exact, jax_engine.predict(images)) < 1e-4

