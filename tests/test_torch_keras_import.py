"""The port's Keras .h5 import (``models.keras_import`` over ``h5lite``)
against the JAX package's, on the CPU.

The .h5 files are the JAX tests' own Keras-layout files
(``tests/test_keras_import.py``'s writers: Xception's nested
``model_weights/xception/<layer>/<layer>/<w>:0`` with auto-named residual
and head layers, keras.applications' flat ResNet50 and EfficientNet),
at JAX's narrow specs.  Tolerances:

- the imported tree: equal to JAX's, leaf for leaf (path, dtype, bytes);
- the port's exact float32 forward of the imported tree against JAX's
  exact forward: max abs logit difference <= 1e-3 (``FORWARD_ATOL``: two
  float32 graphs that sum in other orders);
- refusals: the same exception type and message as JAX's.
"""

from __future__ import annotations

import dataclasses

import h5py
import jax
import numpy as np
import pytest
import torch
from test_keras_import import (
    _flax_efficientnet_to_keras_h5,
    _flax_resnet_to_keras_h5,
    _flax_to_keras_h5,
)
from torch_bn_training import torch_threads

from kubernetes_deep_learning_tpu.models import build_forward as jax_build_forward
from kubernetes_deep_learning_tpu.models import keras_import as jki
from kubernetes_deep_learning_tpu.modelspec import ModelSpec as JaxSpec
from kubernetes_deep_learning_tpu_torch.models import build_forward, init_variables
from kubernetes_deep_learning_tpu_torch.models import keras_import as tki
from kubernetes_deep_learning_tpu_torch.modelspec import ModelSpec
from kubernetes_deep_learning_tpu_torch.weights import from_jax_variables

FORWARD_ATOL = 1e-3

SPECS = {
    "xception": dict(name="h5-xception", family="xception", input_shape=(96, 96, 3),
                     labels=("a", "b", "c", "d"), preprocessing="tf", head_hidden=(16,)),
    "resnet50": dict(name="h5-resnet", family="resnet50", input_shape=(64, 64, 3),
                     labels=("a", "b", "c"), preprocessing="caffe"),
    "efficientnet-b0": dict(name="h5-eff-b0", family="efficientnet-b0",
                            input_shape=(64, 64, 3), labels=("a", "b", "c"),
                            preprocessing="torch", head_hidden=(16,)),
}


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    """One torch thread, restored after: see ``torch_bn_training.torch_threads``
    (the suite's processes otherwise starve each other)."""
    with torch_threads():
        yield


def _write(family: str, path: str, variables) -> None:
    if family == "xception":
        _flax_to_keras_h5(path, variables)
    elif family == "resnet50":
        _flax_resnet_to_keras_h5(path, variables)
    else:
        _flax_efficientnet_to_keras_h5(path, "b0", variables)


@pytest.fixture(scope="module", params=sorted(SPECS))
def imported(request, tmp_path_factory):
    family = request.param
    jspec, tspec = JaxSpec(**SPECS[family]), ModelSpec(**SPECS[family])
    variables = init_variables(tspec, seed=11)  # the flax layout, made without a JAX init
    path = str(tmp_path_factory.mktemp(family) / "model.h5")
    _write(family, path, variables)
    return jspec, tspec, path, jki.load_keras_h5(jspec, path), tki.load_keras_h5(tspec, path)


def test_import_equals_jax_leaf_for_leaf(imported):
    *_, want, got = imported
    flat_w, tree_w = jax.tree_util.tree_flatten_with_path(want)
    flat_g, tree_g = jax.tree_util.tree_flatten_with_path(got)
    assert tree_w == tree_g
    for (path, w), (_, g) in zip(flat_w, flat_g):
        w = np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape, jax.tree_util.keystr(path)
        assert np.ascontiguousarray(g).tobytes() == np.ascontiguousarray(w).tobytes()


def test_imported_forward_matches_jax_exact(imported):
    jspec, tspec, _, want, got = imported
    x = np.random.default_rng(2).integers(0, 256, (2, *jspec.input_shape), dtype=np.uint8)
    ref = np.asarray(jax.jit(jax_build_forward(jspec, dtype=None))(want, x))
    forward = build_forward(tspec, from_jax_variables(got), torch.float32, fast=False,
                            device="cpu")
    with torch.inference_mode():
        out = forward(torch.from_numpy(x)).numpy()
    assert out.shape == ref.shape
    assert np.abs(out - ref).max() <= FORWARD_ATOL


def _refusal(fn, *args) -> tuple[type, str]:
    with pytest.raises(Exception) as info:
        fn(*args)
    return info.type, str(info.value)


def test_wrong_head_refusals_match_jax(imported):
    jspec, tspec, path, *_ = imported
    if jspec.head_hidden:  # a hidden-layer size the .h5 does not have
        kw = dict(head_hidden=(32,))
    else:  # a class count the .h5 does not have
        kw = dict(labels=("a", "b"))
    want = _refusal(jki.load_keras_h5, dataclasses.replace(jspec, **kw), path)
    got = _refusal(tki.load_keras_h5, dataclasses.replace(tspec, **kw), path)
    assert got == want and want[0] is ValueError


def test_missing_layer_refusal_matches_jax(imported, tmp_path):
    """A layer dropped from the file: the structure check's "missing"
    message, with JAX's keystr paths."""
    jspec, tspec, path, *_ = imported
    cut = str(tmp_path / "cut.h5")
    with h5py.File(path, "r") as src, h5py.File(cut, "w") as dst:
        src.copy(src["model_weights"], dst, "model_weights")
        root = dst["model_weights"]
        victim = {"xception": "xception/block1_conv2_bn", "resnet50": "conv2_block1_2_bn",
                  "efficientnet-b0": "block1a_project_bn"}[jspec.family]
        del root[victim]
    want = _refusal(jki.load_keras_h5, jspec, cut)
    got = _refusal(tki.load_keras_h5, tspec, cut)
    assert got[0] is want[0]
    if want[0] is ValueError and "missing" in want[1]:
        assert got == want
    else:  # a KeyError before the check (EfficientNet's per-block lookups)
        assert got[1] == want[1]


def test_non_torch_preprocessing_refusal_matches_jax(tmp_path):
    kw = dict(SPECS["efficientnet-b0"], name="h5-eff-badpre", preprocessing="tf")
    jspec, tspec = JaxSpec(**kw), ModelSpec(**kw)
    path = str(tmp_path / "eff.h5")
    _flax_efficientnet_to_keras_h5(path, "b0", init_variables(tspec, seed=0))
    with h5py.File(path, "a") as f:
        g = f["model_weights"].create_group("normalization")
        g.create_dataset("mean:0", data=np.array([0.485, 0.456, 0.406]))
        g.create_dataset("variance:0", data=np.array([0.052, 0.050, 0.051]))
    want = _refusal(jki.load_keras_h5, jspec, path)
    got = _refusal(tki.load_keras_h5, tspec, path)
    assert got == want and "preprocessing" in want[1]


def test_vit_import_is_not_implemented(tmp_path):
    path = str(tmp_path / "vit.h5")
    with h5py.File(path, "w") as f:
        f.create_group("model_weights").create_dataset("w:0", data=np.zeros(2, np.float32))
    kw = dict(name="h5-vit", family="vit-tiny", input_shape=(32, 32, 3), labels=("a", "b"))
    want = _refusal(jki.load_keras_h5, JaxSpec(**kw), path)
    got = _refusal(tki.load_keras_h5, ModelSpec(**kw), path)
    assert got == want and want[0] is NotImplementedError
