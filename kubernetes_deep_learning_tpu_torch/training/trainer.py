"""Training step and evaluation step (the port of ``training/trainer.py``).

The JAX package jits a pure ``train_step(state) -> state`` and donates the
old state; here the step runs eagerly and updates the state in place (the
torch analog of ``donate_argnums=(0,)``): ``loss.backward()`` then the
optimizer's in-place ``step()``.  The state's parameters are plain leaf
tensors in the port's ``state_dict`` layout, handed to the model with
``torch.func.functional_call`` as flax's ``model.apply({"params": ...})``
does, so one state serves a step of any compute dtype.

Optimizers: ``tx`` is a factory ``params -> torch.optim.Optimizer``.
``functools.partial(torch.optim.SGD, lr=...)`` stands for ``optax.sgd``
and ``functools.partial(torch.optim.Adam, lr=..., eps=1e-8)`` for
``optax.adam``: their update rules are the same.

Every family trains.  The BatchNorm families (Xception, ResNet50,
EfficientNet) normalise on batch statistics in train mode and update the
state's running statistics in place, outside autograd, as flax's
``mutable=["batch_stats"]`` returns them (``models.layers.BatchNorm``).  A
head with dropout (an EfficientNet spec with ``head_hidden``) raises a
``ValueError``: the JAX package's step passes no dropout key and fails
there.  There is no mesh: one device.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch
import torch.nn.functional as F

from kubernetes_deep_learning_tpu_torch.modelspec import ModelSpec
from kubernetes_deep_learning_tpu_torch.models import (
    create_model,
    exact_float32,
    init_variables,
    resolve_device,
)
from kubernetes_deep_learning_tpu_torch.ops.preprocess import normalize
from kubernetes_deep_learning_tpu_torch.weights import from_jax_variables, to_jax_variables

Optimizer = Callable[[Any], torch.optim.Optimizer]


@dataclasses.dataclass
class TrainState:
    """``step`` (optimizer steps taken), ``params`` (port key -> f32 leaf
    tensor with ``requires_grad``, updated in place), ``batch_stats``
    (port key -> f32 running mean or variance, updated in place by each
    train step; empty for ViT) and ``optimizer``, which holds the optimizer
    state."""

    step: int
    params: dict[str, torch.Tensor]
    batch_stats: dict[str, torch.Tensor]
    optimizer: torch.optim.Optimizer

    @property
    def device(self) -> torch.device:
        return next(iter(self.params.values())).device

    def variables(self) -> dict:
        """The flax variable tree (numpy), as ``weights.to_jax_variables``."""
        return to_jax_variables({**self.params, **self.batch_stats})


def create_train_state(spec: ModelSpec, tx: Optimizer, seed: int = 0,
                       variables: dict | None = None,
                       device: str | torch.device = "cuda") -> TrainState:
    """Adopt ``variables`` (a flax tree; ``models.init_variables(spec,
    seed)`` when None) on ``device`` and build the optimizer over them."""
    device = resolve_device(device)
    exact_float32(device)
    if variables is None:
        variables = init_variables(spec, seed=seed)
    tensors = from_jax_variables(variables)
    params = {k: t.to(device).requires_grad_() for k, t in tensors.items()
              if not k.endswith(("running_mean", "running_var"))}
    stats = {k: t.to(device) for k, t in tensors.items() if k not in params}
    return TrainState(0, params, stats, tx(list(params.values())))


def _architecture(spec: ModelSpec, dtype: torch.dtype | None) -> torch.nn.Module:
    """The module without weights of its own (on the meta device): every
    call hands it the state's tensors through ``functional_call``."""
    with torch.device("meta"):
        return create_model(spec, dtype=dtype or torch.float32)


def build_train_step(spec: ModelSpec, dtype: torch.dtype | None = None) -> Callable:
    """``train_step(state, images_u8, labels) -> (state, metrics)``.

    Images are raw uint8 batches, normalised on the device; the loss is the
    mean cross-entropy of the f32 logits (optax's
    ``softmax_cross_entropy_with_integer_labels(...).mean()``).  ``dtype``
    is the compute dtype (None: float32); parameters and BatchNorm
    statistics stay float32 (the statistics are computed in float32 from
    the bf16 activations, as flax's).  The step updates ``state.params``
    and ``state.batch_stats`` in place.  ``metrics`` holds device tensors
    (``loss``, ``accuracy``); reading them waits for the device.
    """
    model = _architecture(spec, dtype)

    def train_step(state: TrainState, images, labels):
        device = state.device
        x = normalize(torch.as_tensor(images, device=device), spec.preprocessing)
        y = torch.as_tensor(labels, device=device).long()
        # The BatchNorms update copies of the running statistics, taken
        # into the state only once the whole step has run: a step that
        # raises (the dropout refusal, an error in the backward) leaves the
        # state as it was.
        stats = {k: t.clone() for k, t in state.batch_stats.items()}
        logits = torch.func.functional_call(
            model, {**state.params, **stats}, (x,), {"train": True})
        logits = logits.float()
        loss = F.cross_entropy(logits, y)
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        state.optimizer.step()
        with torch.no_grad():
            for k, t in stats.items():
                state.batch_stats[k].copy_(t)
        state.step += 1
        acc = (logits.detach().argmax(-1) == y).float().mean()
        return state, {"loss": loss.detach(), "accuracy": acc}

    return train_step


def build_eval_step(spec: ModelSpec, topk: int = 5) -> Callable:
    """``eval_step(state, images_u8, labels, valid=None) -> metrics``: the
    inference-mode forward (``train=False``) and per-batch sums
    (``loss_sum``, ``top1_sum``, ``topk_sum``, ``count``; device tensors),
    so uneven batches aggregate exactly.  ``valid`` (f32 (N,) of 0/1)
    masks padding rows out of every sum.  Float32, as the JAX ``fit``
    evaluates."""
    model = _architecture(spec, None)
    k = min(topk, spec.num_classes)

    @torch.no_grad()
    def eval_step(state: TrainState, images, labels, valid=None):
        device = state.device
        x = normalize(torch.as_tensor(images, device=device), spec.preprocessing)
        y = torch.as_tensor(labels, device=device).long()
        logits = torch.func.functional_call(
            model, {**state.params, **state.batch_stats}, (x,), {"train": False}).float()
        v = (torch.ones(y.shape[0], device=device) if valid is None
             else torch.as_tensor(valid, device=device).float())
        losses = F.cross_entropy(logits, y, reduction="none")
        top1 = (logits.argmax(-1) == y).float()
        in_topk = (logits.topk(k, dim=-1).indices == y[:, None]).any(-1).float()
        return {"loss_sum": (losses * v).sum(), "top1_sum": (top1 * v).sum(),
                "topk_sum": (in_topk * v).sum(), "count": v.sum()}

    return eval_step
