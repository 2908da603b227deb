"""Shared body of the BatchNorm families' training tests
(``test_torch_training_bn_*.py``): the same seeded flax variables and uint8
batches through the JAX package's train and eval steps and the port's, on
the CPU.

Each family runs at full width and depth at 32 px with 3 labels and its
own preprocessing, batch 16: the smallest input all three take.  The last
BatchNorms then see 1x1 maps, n = 16 values a channel, where the unbiased
variance is n/(n-1) = 1.067 times the biased one.  Flax initialises
BatchNorm to (scale 1, bias 0, mean 0, var 1) and biases to 0; the
variables are jittered off those values so that a swapped or missing term
shows.

The references.  A train-mode BatchNorm network at random weights is
ill-conditioned: the batch statistics of its late layers come from 16
values, and its gradient through them is a small difference of large
terms.  JAX's own float32 step on the CPU is off its float64 step by up
to 5% on some tensors (Xception's ``block2_sepconv1`` at batch 4), and by
more than bf16's rounding everywhere in bf16.  So the float32 port is held
to the JAX package's ``build_train_step`` run in float64 (``jax.enable_x64``
with float64 variables: the same program, every product and sum in
float64), where the port's float32 arithmetic is the only error left, and
the bf16 and Adam comparisons, which that conditioning amplifies past any
per-element bound, are held to JAX's own float32 or bf16 program as the
yardstick (each test says how).

Parameters whose gradient is zero in exact arithmetic: a per-channel
constant added before a train-mode BatchNorm is removed by its mean, so
every ResNet convolution bias (each feeds its BatchNorm), every
EfficientNet ``project_bn`` bias (every path from it reaches a 1x1
convolution and then a BatchNorm), and Xception's ``block13`` BatchNorm
biases at 32 px (a 1x1 map, where the next depthwise convolution is its
centre tap alone) get pure rounding noise as gradient.  The tests find
them as the tensors whose float64 update is below 1e-12 of the largest.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

from kubernetes_deep_learning_tpu.models import create_model as jax_create_model
from kubernetes_deep_learning_tpu.models import init_variables as jax_init_variables
from kubernetes_deep_learning_tpu.modelspec import ModelSpec as JaxModelSpec
from kubernetes_deep_learning_tpu.ops.preprocess import normalize as jax_normalize
from kubernetes_deep_learning_tpu.training import trainer as jax_trainer
from kubernetes_deep_learning_tpu_torch.models import create_model
from kubernetes_deep_learning_tpu_torch.models.layers import BatchNorm
from kubernetes_deep_learning_tpu_torch.modelspec import ModelSpec
from kubernetes_deep_learning_tpu_torch.ops.preprocess import normalize
from kubernetes_deep_learning_tpu_torch.training import (
    build_eval_step,
    build_train_step,
    create_train_state,
)
from kubernetes_deep_learning_tpu_torch.weights import from_jax_variables
from torch_threads import torch_threads  # noqa: F401  (the bn test files' fixture)

PX = 32
BATCH = 16
LABELS = ("a", "b", "c")
SGD_LR = 0.5
ADAM_LR = 1e-6
ADAM_STEPS = 3


def spec_kw(family: str, preprocessing: str, **kw) -> dict:
    return dict(name=f"torch-train-{family}", family=family, input_shape=(PX, PX, 3),
                labels=LABELS, preprocessing=preprocessing, **kw)


def specs(family: str, preprocessing: str, **kw) -> tuple[JaxModelSpec, ModelSpec]:
    return (JaxModelSpec(**spec_kw(family, preprocessing, **kw)),
            ModelSpec(**spec_kw(family, preprocessing, **kw)))


def variables(jspec: JaxModelSpec, seed: int) -> dict:
    """flax's initial variables, jittered (numpy float32 leaves)."""
    tree = jax.tree_util.tree_map(np.asarray, jax_init_variables(jspec, seed=seed))
    rng = np.random.default_rng(seed)

    def jitter(node):
        for k, leaf in node.items():
            if isinstance(leaf, dict):
                jitter(leaf)
            elif k in ("bias", "scale", "mean"):
                node[k] = (leaf + rng.normal(0, 0.1, leaf.shape)).astype(np.float32)
            elif k == "var":
                node[k] = (leaf * rng.uniform(0.5, 1.5, leaf.shape)).astype(np.float32)

    jitter(tree)
    return tree


def leaves(tree) -> dict:
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


def rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-300))


def batch(spec, n: int, seed: int):
    """n images that differ from each other as photographs do (each its
    own colour, tilt and noise), and labels."""
    rng = np.random.default_rng(seed)
    h, w, _ = spec.input_shape
    yy, xx = np.meshgrid(np.linspace(-1, 1, h), np.linspace(-1, 1, w), indexing="ij")
    colour = rng.uniform(40, 215, (n, 1, 1, 3))
    tilt = rng.uniform(-60, 60, (n, 2, 1, 1, 3))
    noise = rng.normal(0, 20, (n, h, w, 3))
    images = colour + tilt[:, 0] * yy[..., None] + tilt[:, 1] * xx[..., None] + noise
    return (np.clip(np.rint(images), 0, 255).astype(np.uint8),
            rng.integers(0, spec.num_classes, (n,), np.int32))


def sgd(lr=SGD_LR):
    return functools.partial(torch.optim.SGD, lr=lr)


def adam(lr=ADAM_LR):
    return functools.partial(torch.optim.Adam, lr=lr, eps=1e-8)


# --- the JAX side ---

def _jax_logits(jspec, tree, images, dtype=None) -> np.ndarray:
    model = jax_create_model(jspec, dtype=dtype)

    @jax.jit
    def forward(t, images):
        x = jax_normalize(images, jspec.preprocessing)
        return model.apply(t, x, train=True, mutable=["batch_stats"])[0]

    return np.asarray(forward(tree, images), np.float64)


def _jax_steps(jspec, tree, tx, batches, dtype=None) -> dict:
    state = jax_trainer.create_train_state(jspec, tx, variables=jax.tree_util.tree_map(
        jnp.array, tree))
    step = jax_trainer.build_train_step(jspec, tx, dtype=dtype)
    out = {"loss": [], "accuracy": []}
    for images, labels in batches:
        state, m = step(state, images, labels)
        out["loss"].append(float(m["loss"]))
        out["accuracy"].append(float(m["accuracy"]))
        out.setdefault("stats", leaves({"batch_stats": state.batch_stats}))
    out["params"] = leaves({"params": state.params})
    return out


def jax_references(jspec, tree) -> dict:
    """Every JAX number a family's tests compare with, computed once."""
    b = [batch(jspec, BATCH, s) for s in range(1, 1 + ADAM_STEPS)]
    with jax.enable_x64(True):
        t64 = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), tree)
        f64 = {"logits": _jax_logits(jspec, t64, b[0][0]),
               "sgd": _jax_steps(jspec, t64, optax.sgd(SGD_LR), b[:1])}
    adam32 = _jax_steps(jspec, tree, optax.adam(ADAM_LR), b)
    bf16 = _jax_steps(jspec, tree, optax.sgd(SGD_LR), b[:1], jnp.bfloat16)
    images, labels = batch(jspec, 6, 9)
    valid = np.array([1, 1, 0, 1, 0, 1], np.float32)
    state = jax_trainer.create_train_state(jspec, optax.sgd(1e-3), variables=tree)
    evals = {k: float(v) for k, v in jax_trainer.build_eval_step(jspec, topk=2)(
        state, images, labels, valid).items()}
    return {"batches": b, "f64": f64, "adam32": adam32, "bf16": bf16,
            "eval": (images, labels, valid, evals), "old": leaves(tree)}


# --- the port's side ---

def port_logits(spec, tree, images, dtype=torch.float32) -> np.ndarray:
    model = create_model(spec, dtype=dtype)
    model.load_state_dict(from_jax_variables(tree))
    with torch.no_grad():
        x = normalize(torch.from_numpy(images), spec.preprocessing)
        return model(x, train=True).double().numpy()


def port_steps(spec, tree, tx, batches, dtype=None) -> dict:
    state = create_train_state(spec, tx, variables=tree, device="cpu")
    step = build_train_step(spec, dtype=dtype)
    out = {"loss": [], "accuracy": []}
    for images, labels in batches:
        state, m = step(state, images, labels)
        out["loss"].append(float(m["loss"]))
        out["accuracy"].append(float(m["accuracy"]))
        out.setdefault("stats", leaves({"batch_stats": state.variables()["batch_stats"]}))
    out["params"] = leaves({"params": state.variables()["params"]})
    out["state"] = state
    return out


def port_eval(spec, tree, images, labels, valid) -> dict:
    state = create_train_state(spec, sgd(1e-3), variables=tree, device="cpu")
    m = build_eval_step(spec, topk=2)(state, images, labels, valid)
    return {k: float(v) for k, v in m.items()}


def bn_sizes(spec, images) -> dict[str, int]:
    """flax ``batch_stats`` path prefix -> n, the values each channel's
    statistics are taken over (batch x height x width of the input)."""
    model = create_model(spec)
    sizes = {}
    for name, mod in model.named_modules():
        if isinstance(mod, BatchNorm):
            key = "".join(f"[{part!r}]" for part in name.split("."))
            mod.register_forward_hook(lambda m, args, out, key=key: sizes.__setitem__(
                key, int(np.prod(args[0].shape[:-1]))))
    with torch.no_grad():
        model(normalize(torch.from_numpy(images), spec.preprocessing), train=True)
    return sizes


def zero_gradient(ref: dict) -> set[str]:
    """Parameters whose float64 SGD update is below 1e-12 of the largest."""
    old, new = ref["old"], ref["f64"]["sgd"]["params"]
    upd = {k: np.abs(new[k] - old[k]).max() for k in new}
    top = max(upd.values())
    return {k for k, u in upd.items() if u <= 1e-12 * top}


# --- the checks each family's file runs, with its own tolerances ---

def check_train_logits(fam, tol: float) -> None:
    """The port's float32 train-mode logits against JAX's float64 ones."""
    spec, tree, ref = fam["spec"], fam["tree"], fam["ref"]
    got = port_logits(spec, tree, ref["batches"][0][0])
    assert got.shape == (BATCH, len(LABELS))
    assert rel(got, ref["f64"]["logits"]) < tol


def check_sgd_step(fam, tol: dict) -> dict:
    """One SGD step against JAX's float64 step: loss, accuracy, every new
    running statistic (the biased variance: the unbiased one misses at the
    1x1 BatchNorms by far more than the tolerance), and the update."""
    spec, tree, ref = fam["spec"], fam["tree"], fam["ref"]
    want, old = ref["f64"]["sgd"], ref["old"]
    got = port_steps(spec, tree, sgd(), ref["batches"][:1])
    assert got["state"].step == 1
    assert abs(got["loss"][0] - want["loss"][0]) <= tol["loss"] * want["loss"][0]
    assert got["accuracy"] == want["accuracy"]

    sizes = bn_sizes(spec, ref["batches"][0][0])
    assert got["stats"].keys() == want["stats"].keys()
    assert len(sizes) == len(want["stats"]) // 2
    smallest = min(sizes, key=sizes.get)
    n = sizes[smallest]
    for k, new in want["stats"].items():
        step = np.abs(new - old[k]).max()
        assert np.abs(got["stats"][k] - new).max() <= tol["stats"] * step, k
    # The batch variance JAX's running variance took in, and the unbiased
    # variance F.batch_norm would have taken in its place.
    k = f"['batch_stats']{smallest}['var']"
    var = (want["stats"][k] - 0.99 * old[k]) / 0.01
    unbiased = 0.99 * old[k] + 0.01 * var * n / (n - 1)
    step = np.abs(want["stats"][k] - old[k]).max()
    assert n <= BATCH and np.abs(unbiased - want["stats"][k]).max() > 100 * tol["stats"] * step

    zero = zero_gradient(ref)
    top = max(np.abs(want["params"][k] - old[k]).max() for k in want["params"])
    assert got["params"].keys() == want["params"].keys()
    for k in want["params"]:
        upd_want, upd_got = want["params"][k] - old[k], got["params"][k] - old[k]
        if k in zero:  # rounding noise in both packages
            assert np.abs(upd_got).max() <= tol["zero"] * top, k
            continue
        err = np.abs(upd_got - upd_want).max()
        assert err <= tol["update"] * np.abs(upd_want).max() + tol["floor"] * top, (k, err)
    return {"zero": zero, "smallest": (smallest, n)}


def check_adam_steps(fam, tol: dict) -> None:
    """Three Adam steps (lr 1e-6) against JAX's float32 program.  Adam's
    first step is lr * sign(g) per element, so an element whose gradient
    lies within float32 rounding of zero moves by lr one way or the other
    in either package: against JAX's float64 program JAX's own float32 one
    is up to 2 lr per step off on such elements (a few percent of
    ResNet50's, which its BatchNorm epsilon of 1e-5 conditions worst).  So
    the losses are held to ``tol["loss"]``, every element to Adam's bound
    of 2 lr a step, and the share of elements further than lr / 10 from
    JAX's to ``tol["far"]``; the zero-gradient tensors move by noise, up
    to lr a step, in both."""
    spec, tree, ref = fam["spec"], fam["tree"], fam["ref"]
    want, old = ref["adam32"], ref["old"]
    got = port_steps(spec, tree, adam(), ref["batches"])
    assert got["state"].step == ADAM_STEPS
    for a, b in zip(got["loss"], want["loss"], strict=True):
        assert abs(a - b) <= tol["loss"] * b
    zero = zero_gradient(ref)
    diffs = []
    for k in want["params"]:
        if k in zero:
            assert np.abs(got["params"][k] - old[k]).max() <= ADAM_STEPS * ADAM_LR * (1 + 1e-3), k
            continue
        assert np.abs(want["params"][k] - old[k]).max() > 0.5 * ADAM_LR, k  # Adam moved it
        diffs.append(np.abs(got["params"][k] - want["params"][k]).ravel())
    d = np.concatenate(diffs) / ADAM_LR
    assert d.max() <= 2 * ADAM_STEPS * (1 + 1e-3)
    assert (d > 0.1).mean() <= tol["far"]


def check_bf16_step(fam, tol: float) -> None:
    """One bf16 step (parameters and statistics stay float32) against JAX's
    bf16 step.  Train-mode BatchNorm amplifies bf16's rounding: JAX's own
    bf16 loss lies 1-10% off its float64 loss here, so the port's bf16
    loss is held within twice that distance of JAX's, plus two bf16 steps
    of the loss (JAX rounds its loss to bf16).  The first BatchNorm's new
    statistics, taken over thousands of values of a bf16 convolution of
    the image, are held within ``tol`` of their update."""
    spec, tree, ref = fam["spec"], fam["tree"], fam["ref"]
    want, f64, old = ref["bf16"], ref["f64"]["sgd"], ref["old"]
    got = port_steps(spec, tree, sgd(), ref["batches"][:1], torch.bfloat16)
    state = got["state"]
    assert all(t.dtype == torch.float32 for t in (*state.params.values(),
                                                 *state.batch_stats.values()))
    assert np.isfinite(got["loss"][0])
    spread = abs(want["loss"][0] - f64["loss"][0])
    assert abs(got["loss"][0] - want["loss"][0]) <= 2 * spread + 2 * 2.0 ** -7 * want["loss"][0]
    first = next(iter(bn_sizes(spec, ref["batches"][0][0])))
    for stat in ("mean", "var"):
        k = f"['batch_stats']{first}['{stat}']"
        step = np.abs(want["stats"][k] - old[k]).max()
        assert np.abs(got["stats"][k] - want["stats"][k]).max() <= tol * step, k


def check_eval_sums(fam) -> None:
    """The eval step (running statistics) against JAX's float32 one: the
    loss sum within 1e-5, the top-1 and top-k sums exactly."""
    spec, tree, ref = fam["spec"], fam["tree"], fam["ref"]
    images, labels, valid, want = ref["eval"]
    got = port_eval(spec, tree, images, labels, valid)
    assert got["count"] == want["count"] == 4
    for key in ("top1_sum", "topk_sum"):
        assert got[key] == want[key], key
    assert abs(got["loss_sum"] - want["loss_sum"]) <= 1e-5 * want["loss_sum"]
