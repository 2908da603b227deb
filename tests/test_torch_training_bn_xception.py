"""Train mode of Xception in the port against the JAX package's, on the
CPU: ``clothing-model``'s family at full width, with a hidden head layer
as its, at 32 px, batch 16.
The set-up, the references and the reasons for each tolerance are in
``tests/torch_bn_training.py``; the numbers (measured on the CPU):

- train-mode logits within 1e-4 of JAX's float64 ones, relative to the
  largest (measured 1e-5; JAX's own float32 program 1.1e-5);
- loss within 1e-5 relative (measured 1.5e-7), accuracy exact;
- each new running statistic within 1e-4 of its float64 update
  (measured 1e-5): float32 sums of up to thousands of values;
- the SGD update of each tensor within 1e-3 of its largest element plus
  1e-2 of the largest update in the model (measured 4.2e-3 on ``block1_conv1``; JAX's own float32 step is 2.4e-3 off its float64 one):
  the gradient's rounding is relative to the signal that reaches a tensor,
  not to the tensor's own update; zero-gradient tensors move by at most
  1e-6 of the largest update;
- Adam: losses within 1e-5 relative of JAX's float32 program's
  (measured 1.4e-6), at most 1e-2 of elements further than lr / 10
  (measured 2.3e-3);
- bf16: the first BatchNorm's statistics within 1e-2 of their update.
"""

from __future__ import annotations

import pytest

import torch_bn_training as bn

TOL = {"loss": 1e-5, "stats": 1e-4, "update": 1e-3, "floor": 1e-2, "zero": 1e-6}


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    with bn.torch_threads():
        yield


@pytest.fixture(scope="module")
def fam():
    jspec, spec = bn.specs("xception", "tf", head_hidden=(8,))
    tree = bn.variables(jspec, 3)
    return {"spec": spec, "tree": tree, "ref": bn.jax_references(jspec, tree)}


def test_train_mode_logits_match_jax(fam):
    bn.check_train_logits(fam, 1e-4)


def test_sgd_step_zero_gradient_tensors_and_smallest_batch_norm(fam):
    checked = bn.check_sgd_step(fam, TOL)
    assert checked["zero"] == {"['params']['block13_res_bn']['bias']",
                               "['params']['block13_sepconv2_bn']['bias']"}
    assert checked["smallest"] == ("['block13_res_bn']", bn.BATCH)  # 1x1 maps


def test_adam_steps_match_jax(fam):
    bn.check_adam_steps(fam, {"loss": 1e-5, "far": 1e-2})


def test_bf16_step_matches_jax(fam):
    bn.check_bf16_step(fam, 1e-2)


def test_eval_step_matches_jax(fam):
    bn.check_eval_sums(fam)
