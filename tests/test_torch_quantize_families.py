"""int8-w8a8 for ResNet50, EfficientNet and ViT: the port's calibration, w8a8
forward and artifacts against the JAX package's, on the CPU.

At 32 px, full depth, 10 labels, weights from seed 1 (``init_variables``,
a flax tree both packages load), the default quantization rule (min_size
4096, the head skipped) and calibration at percentile 100 on 4 noise
images, as ``tests/test_torch_quantize.py`` does for Xception.  Tolerances:

- calibration: JAX's keys, each scale within ``CALIB_RTOL`` 1e-5 relative
  (the two float graphs sum in other orders);
- the whole model against JAX's ``build_w8a8_forward`` on the same
  calibrated tree: relative max-abs logit difference <= ``MODEL_RTOL``
  5e-2 and top-1 equal on every image (one int8 code that flips at a
  rounding tie moves every later layer).

ViT: JAX's interceptor sees ``nn.Conv`` and ``nn.Dense`` only, so it
calibrates the patch embedding and the MLPs and no ``DenseGeneral``; its
w8a8 program then fails at the first quantized ``DenseGeneral``
(``block_0/attn/query``).  The port calibrates the same layers and refuses
to serve the artifact there, as JAX does.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import shutil

import jax
import numpy as np
import pytest
import torch

from kubernetes_deep_learning_tpu.export import artifact as jart
from kubernetes_deep_learning_tpu.modelspec import ModelSpec as JaxSpec
from kubernetes_deep_learning_tpu.modelspec import register_spec
from kubernetes_deep_learning_tpu.ops import quantize as jq
from kubernetes_deep_learning_tpu_torch import weights
from kubernetes_deep_learning_tpu_torch.export import artifact as art
from kubernetes_deep_learning_tpu_torch.models import create_model, init_variables
from kubernetes_deep_learning_tpu_torch.models.layers import Conv2dNHWC
from kubernetes_deep_learning_tpu_torch.modelspec import ModelSpec
from kubernetes_deep_learning_tpu_torch.ops import int8 as int8_ops
from kubernetes_deep_learning_tpu_torch.ops import quantize as tq
from torch_threads import one_torch_thread  # noqa: F401

CALIB_RTOL = 1e-5
MODEL_RTOL = 5e-2
PCT = 100.0
SIDE = 32
LABELS = tuple(f"class{i}" for i in range(10))
# family -> (preprocessing, quantized = calibrated layers, Q1 convs, Q2 depthwise)
FAMILIES = {
    "resnet50": ("caffe", 53, 53, 0),
    "efficientnet-b0": ("torch", 57, 46, 11),
}
VIT_NAME = "torch-quant-vit-tiny"
VIT_SCALES = 5  # patch_embed and each block's mlp_in and mlp_out


def _specs(family: str, name: str, preprocessing: str):
    kw = dict(name=name, family=family, input_shape=(SIDE, SIDE, 3), labels=LABELS,
              preprocessing=preprocessing)
    return register_spec(JaxSpec(**kw)), ModelSpec(**kw)


def _calib_images() -> np.ndarray:
    return np.random.default_rng(7).integers(0, 256, (4, SIDE, SIDE, 3), np.uint8)


def _images(n: int = 4, seed: int = 11) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, (n, SIDE, SIDE, 3), np.uint8)


def _rel(got, want) -> float:
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-9))


@dataclasses.dataclass
class Case:
    family: str
    jspec: JaxSpec
    tspec: ModelSpec
    variables: dict
    qvars: dict
    jax_scales: dict  # JAX's calibration of ``variables`` on _calib_images()
    tree: dict        # qvars with JAX's scales attached (the artifact JAX writes)


@pytest.fixture(scope="module", params=list(FAMILIES))
def case(request) -> Case:
    family = request.param
    jspec, tspec = _specs(family, f"torch-quant-{family}", FAMILIES[family][0])
    variables = init_variables(tspec, seed=1)
    qvars = jq.quantize_variables(variables)
    scales = jq.calibrate_activation_scales(jspec, variables, qvars, _calib_images(),
                                            percentile=PCT)
    tree = {**qvars, "params": jq.attach_activation_scales(qvars["params"], scales)}
    return Case(family, jspec, tspec, variables, qvars, scales, tree)


def test_every_conv_is_called_through_its_module(case):
    """Every convolution of the family is a ``Conv2dNHWC`` the forward calls,
    every quantized leaf names one, and ResNet's stem sees its input before
    the explicit pads (as flax's interceptor does, so a clipping percentile
    takes no padding zeros)."""
    model = create_model(case.tspec)
    convs = {n: m for n, m in model.named_modules() if isinstance(m, Conv2dNHWC)}
    assert not any(isinstance(m, torch.nn.Conv2d) and n not in convs
                   for n, m in model.named_modules())
    seen = {}

    def hook_for(n):
        def hook(_module, args):
            seen.setdefault(n, tuple(args[0].shape))
        return hook

    for n, m in convs.items():
        m.register_forward_pre_hook(hook_for(n))
    with torch.inference_mode():
        model(torch.zeros((2, SIDE, SIDE, 3)))
    assert sorted(seen) == sorted(convs)
    leaves = {".".join(p) for p in tq.quantized_leaves(case.qvars)}
    assert len(leaves) == FAMILIES[case.family][1] and leaves <= set(convs)
    first = "conv1_conv" if case.family == "resnet50" else "stem_conv"
    assert seen[first] == (2, SIDE, SIDE, 3)


def test_calibration_matches_jax(case):
    got = tq.calibrate_activation_scales(case.tspec, case.variables, case.qvars,
                                         _calib_images(), percentile=PCT, device="cpu")
    assert sorted(got) == sorted(case.jax_scales)
    assert len(got) == FAMILIES[case.family][1]
    for k, want in case.jax_scales.items():
        assert got[k].dtype == np.float32
        np.testing.assert_allclose(got[k], want, rtol=CALIB_RTOL, err_msg=str(k))


def test_w8a8_forward_matches_jax(case):
    """The port's w8a8 forward (every calibrated conv an ``Int8Conv2d``, its
    CPU path the kernels' plain version) against JAX's program on the same
    calibrated tree."""
    _, _, convs, depthwise = FAMILIES[case.family]
    fwd = tq.build_w8a8_forward(case.tspec, case.tree, device="cpu")
    kinds = [m.kind for m in fwd.modules() if isinstance(m, int8_ops.Int8Conv2d)]
    assert (kinds.count("conv"), kinds.count("depthwise")) == (convs, depthwise)
    want = np.asarray(jax.jit(jq.build_w8a8_forward(case.jspec))(case.tree, _images()))
    with torch.inference_mode():
        got = fwd(torch.from_numpy(_images())).numpy()
    assert np.isfinite(got).all() and got.shape == want.shape
    assert _rel(got, want) <= MODEL_RTOL
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


def test_from_jax_quantized_names_the_familys_modules(case):
    params, leaves = weights.from_jax_quantized(case.tree)
    model = create_model(case.tspec)
    model.load_state_dict(params)
    modules = dict(model.named_modules())
    for name, leaf in leaves.items():
        assert isinstance(modules[name], Conv2dNHWC), name
        assert leaf.weight.shape == modules[name].weight.shape and leaf.act_scale is not None
    if case.family == "resnet50":
        assert leaves["conv1_conv"].weight.shape == (64, 3, 7, 7)
    else:
        assert leaves["block6.dwconv"].weight.shape == (480, 1, 3, 3)
        assert leaves["block11.dwconv"].weight.shape == (672, 1, 5, 5)  # 5x5/2
        assert leaves["block11.se.expand"].weight.shape == (672, 28, 1, 1)


# --- ViT: calibrated as JAX calibrates it, refused where JAX's program fails ----------


@pytest.fixture(scope="module")
def vit_root(tmp_path_factory):
    """(root, jspec, tspec): vit-tiny v1 float and v2 int8-w8a8, both written
    by the JAX package (its ``write_quantized_version``)."""
    jspec, tspec = _specs("vit-tiny", VIT_NAME, "tf")
    root = str(tmp_path_factory.mktemp("jax-vit-quant"))
    jart.save_artifact(jart.version_dir(root, VIT_NAME, 1), jspec, init_variables(tspec, 1),
                       None, {"compute_dtype": "float32"})
    jq.write_quantized_version(root, VIT_NAME, scheme=jq.SCHEME_W8A8,
                               calib_images=_calib_images(), percentile=PCT)
    return root, jspec, tspec


def _vit_tree(vit_root):
    return art.load_artifact(art.version_dir(vit_root[0], VIT_NAME, 2)).variables


def test_vit_calibration_gives_jaxs_five_scales(vit_root):
    root, _, tspec = vit_root
    variables = art.load_artifact(art.version_dir(root, VIT_NAME, 1)).variables
    qvars = tq.quantize_variables(variables)
    assert len(tq.quantized_leaves(qvars)) == 13  # 8 of them DenseGeneral kernels
    got = tq.calibrate_activation_scales(tspec, variables, qvars, _calib_images(),
                                         percentile=PCT, device="cpu")
    want = jq.activation_scales(_vit_tree(vit_root))
    assert sorted(got) == sorted(want) and len(got) == VIT_SCALES
    assert ("patch_embed",) in got and ("block_1", "mlp_out") in got
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=CALIB_RTOL, err_msg=str(k))


def test_vit_w8a8_fails_in_both_packages(vit_root):
    """JAX's w8a8 program fails at the first quantized DenseGeneral; the
    port's refuses to build there, naming it, and the weights convert
    before it (the 3-D kernels keep flax's layout)."""
    _, jspec, tspec = vit_root
    tree = _vit_tree(vit_root)
    with pytest.raises(ValueError, match="entry not a 2- or 3- tuple"):
        jax.jit(jq.build_w8a8_forward(jspec))(tree, _images())
    _, leaves = weights.from_jax_quantized(tree)
    assert leaves["block_0.attn.query"].weight.shape == (64, 2, 32)
    assert leaves["block_0.attn.out"].weight.dtype == torch.int8
    assert leaves["block_0.mlp_in"].act_scale is not None
    with pytest.raises(ValueError, match="block_0/attn/query is a quantized DenseGeneral.*JAX"):
        tq.build_w8a8_forward(tspec, tree, device="cpu")


def test_vit_quantize_writes_jaxs_artifact(vit_root, tmp_path):
    root, _, _ = vit_root
    shutil.copytree(os.path.join(root, VIT_NAME, "1"), os.path.join(tmp_path, VIT_NAME, "1"))
    path = tq.write_quantized_version(str(tmp_path), VIT_NAME, scheme=tq.SCHEME_W8A8,
                                      calib_images=_calib_images(), percentile=PCT,
                                      device="cpu")
    got = jart.load_artifact(path)
    want = jart.load_artifact(jart.version_dir(root, VIT_NAME, 2))
    assert got.metadata == want.metadata
    assert got.metadata["calibration"]["layers"] == VIT_SCALES
    g, w = tq.quantized_leaves(got.variables), tq.quantized_leaves(want.variables)
    assert sorted(g) == sorted(w)
    for k in w:
        for key in (tq.QUANT_KEY, tq.SCALE_KEY):
            assert np.asarray(g[k][key]).tobytes() == np.asarray(w[k][key]).tobytes(), k
        assert (tq.ACT_SCALE_KEY in g[k]) == (tq.ACT_SCALE_KEY in w[k]), k
        if tq.ACT_SCALE_KEY in w[k]:
            np.testing.assert_allclose(g[k][tq.ACT_SCALE_KEY], w[k][tq.ACT_SCALE_KEY],
                                       rtol=CALIB_RTOL, err_msg=str(k))


def test_vit_w8a8_version_is_skipped_and_the_float_one_keeps_serving(vit_root, tmp_path,
                                                                     caplog):
    """The JAX-written w8a8 v2 appears under a root that serves v1: the
    port's server and the JAX server both skip it (the port logs why) and
    keep serving v1."""
    from kubernetes_deep_learning_tpu.serving.model_server import ModelServer as JaxModelServer
    from kubernetes_deep_learning_tpu_torch.serving.model_server import ModelServer

    root, _, _ = vit_root
    roots = {k: str(tmp_path / k) for k in ("port", "jax")}
    for r in roots.values():
        shutil.copytree(os.path.join(root, VIT_NAME, "1"), os.path.join(r, VIT_NAME, "1"))
    port = ModelServer(roots["port"], port=0, buckets=(1,), device="cpu")
    jaxs = JaxModelServer(roots["jax"], port=0, buckets=(1,), max_delay_ms=1.0)
    try:
        for server, r in ((port, roots["port"]), (jaxs, roots["jax"])):
            server.warmup()
            shutil.copytree(os.path.join(root, VIT_NAME, "2"), os.path.join(r, VIT_NAME, "2"))
            with caplog.at_level(logging.WARNING):
                assert server.poll_versions() == []
            assert server.models[VIT_NAME].version == 1
            assert server.models[VIT_NAME].engine.quantization is None
        assert "block_0/attn/query" in caplog.text
        imgs = _images(1)
        np.testing.assert_allclose(port.models[VIT_NAME].engine.predict(imgs),
                                   np.asarray(jaxs.models[VIT_NAME].engine.predict(imgs)),
                                   rtol=1e-3, atol=1e-4)
    finally:
        port.shutdown()
        jaxs.shutdown()
