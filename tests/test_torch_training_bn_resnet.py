"""Train mode of ResNet50 in the port against the JAX package's, on the
CPU: full width and depth at 32 px, batch 16, caffe preprocessing.  Its
BatchNorm epsilon (1.001e-5, not Keras's 1e-3) lets a channel of small
batch variance amplify rounding 300-fold, so its tolerances are wider than
the other families'.
The set-up, the references and the reasons for each tolerance are in
``tests/torch_bn_training.py``; the numbers (measured on the CPU):

- train-mode logits within 5e-4 of JAX's float64 ones, relative to the
  largest (measured 5.8e-5; JAX's own float32 program 1.8e-4);
- loss within 1e-4 relative (measured 8.6e-6), accuracy exact;
- each new running statistic within 3e-4 of its float64 update
  (measured 7e-5): float32 sums of up to thousands of values;
- the SGD update of each tensor within 1e-3 of its largest element plus
  3e-2 of the largest update in the model (measured 1.0e-2 on ``conv1_conv``; JAX's own float32 step is 2.4e-2 off its float64 one):
  the gradient's rounding is relative to the signal that reaches a tensor,
  not to the tensor's own update; zero-gradient tensors move by at most
  1e-5 of the largest update;
- Adam: losses within 1e-3 relative of JAX's float32 program's
  (measured 3.1e-4), at most 0.1 of elements further than lr / 10
  (measured 6.5%; JAX's own float32 program is 5.1% off its float64 one, the port 3.7%);
- bf16: the first BatchNorm's statistics within 1e-2 of their update.
"""

from __future__ import annotations

import pytest

import torch_bn_training as bn

TOL = {"loss": 1e-4, "stats": 3e-4, "update": 1e-3, "floor": 3e-2, "zero": 1e-5}


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    with bn.torch_threads():
        yield


@pytest.fixture(scope="module")
def fam():
    jspec, spec = bn.specs("resnet50", "caffe")
    tree = bn.variables(jspec, 3)
    return {"spec": spec, "tree": tree, "ref": bn.jax_references(jspec, tree)}


def test_train_mode_logits_match_jax(fam):
    bn.check_train_logits(fam, 5e-4)


def test_sgd_step_zero_gradient_tensors(fam):
    checked = bn.check_sgd_step(fam, TOL)
    # Every convolution bias: each convolution feeds its BatchNorm.
    assert len(checked["zero"]) == 53
    assert all(k.endswith("_conv']['bias']") for k in checked["zero"])


def test_adam_steps_match_jax(fam):
    bn.check_adam_steps(fam, {"loss": 1e-3, "far": 0.1})


def test_bf16_step_matches_jax(fam):
    bn.check_bf16_step(fam, 1e-2)


def test_eval_step_matches_jax(fam):
    bn.check_eval_sums(fam)
