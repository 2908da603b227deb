"""Train mode of EfficientNet in the port against the JAX package's, on
the CPU: B0 at full width and depth at 32 px, batch 16, torch
preprocessing; and the refusal of a train step through the head's dropout,
which the JAX package's step cannot run either.
The set-up, the references and the reasons for each tolerance are in
``tests/torch_bn_training.py``; the numbers (measured on the CPU):

- train-mode logits within 1e-4 of JAX's float64 ones, relative to the
  largest (measured 1.2e-5; JAX's own float32 program 1.5e-5);
- loss within 1e-5 relative (measured 3e-7), accuracy exact;
- each new running statistic within 1e-4 of its float64 update
  (measured 1.4e-5): float32 sums of up to thousands of values;
- the SGD update of each tensor within 1e-3 of its largest element plus
  1e-4 of the largest update in the model (measured 1.5e-5):
  the gradient's rounding is relative to the signal that reaches a tensor,
  not to the tensor's own update; zero-gradient tensors move by at most
  1e-5 of the largest update;
- Adam: losses within 1e-5 relative of JAX's float32 program's
  (measured 1.7e-6), at most 1e-3 of elements further than lr / 10
  (measured 2e-5);
- bf16: the first BatchNorm's statistics within 1e-2 of their update.
"""

from __future__ import annotations

import pytest
import torch

import torch_bn_training as bn

TOL = {"loss": 1e-5, "stats": 1e-4, "update": 1e-3, "floor": 1e-4, "zero": 1e-5}


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    with bn.torch_threads():
        yield


@pytest.fixture(scope="module")
def fam():
    jspec, spec = bn.specs("efficientnet-b0", "torch")
    tree = bn.variables(jspec, 3)
    return {"spec": spec, "tree": tree, "ref": bn.jax_references(jspec, tree)}


def test_train_mode_logits_match_jax(fam):
    bn.check_train_logits(fam, 1e-4)


def test_sgd_step_zero_gradient_tensors(fam):
    checked = bn.check_sgd_step(fam, TOL)
    # Every block's project_bn bias: each path from it meets a 1x1
    # convolution and then a BatchNorm.
    assert checked["zero"] == {f"['params']['block{i}']['project_bn']['bias']"
                               for i in range(16)}


def test_dropout_head_refuses_to_train_as_jax_fails():
    """A spec with a hidden head layer reaches the head's dropout (the
    variant's rate, 0.2 for B0) in train mode.  JAX's train step passes no
    dropout key and raises flax's InvalidRngError; the port raises a
    ValueError naming the head instead of training without the dropout.
    The failed step leaves the state as it was, and eval mode works in
    both."""
    import flax
    import optax

    from kubernetes_deep_learning_tpu.training import trainer as jax_trainer
    from kubernetes_deep_learning_tpu_torch.training import (
        build_eval_step,
        build_train_step,
        create_train_state,
    )

    jspec, spec = bn.specs("efficientnet-b0", "torch", head_hidden=(8,))
    tree = bn.variables(jspec, 5)
    images, labels = bn.batch(spec, 2, 1)
    jstate = jax_trainer.create_train_state(jspec, optax.sgd(0.1), variables=tree)
    with pytest.raises(flax.errors.InvalidRngError, match="Dropout_0 needs PRNG"):
        jax_trainer.build_train_step(jspec, optax.sgd(0.1))(jstate, images, labels)
    state = create_train_state(spec, bn.sgd(0.1), variables=tree, device="cpu")
    before = {k: t.clone() for k, t in {**state.params, **state.batch_stats}.items()}
    with pytest.raises(ValueError, match="head: dropout 0.2 after hidden_0"):
        build_train_step(spec)(state, images, labels)
    assert state.step == 0
    for k, t in {**state.params, **state.batch_stats}.items():  # nothing half-updated
        assert torch.equal(t, before[k]), k
    want = jax_trainer.build_eval_step(jspec)(jstate, images, labels)
    got = build_eval_step(spec)(state, images, labels)
    assert abs(float(got["loss_sum"]) - float(want["loss_sum"])) <= 1e-5 * float(
        want["loss_sum"])


def test_adam_steps_match_jax(fam):
    bn.check_adam_steps(fam, {"loss": 1e-5, "far": 1e-3})


def test_bf16_step_matches_jax(fam):
    bn.check_bf16_step(fam, 1e-2)


def test_eval_step_matches_jax(fam):
    bn.check_eval_sums(fam)
