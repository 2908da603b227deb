"""The port's int8 quantization (``ops.quantize``, ``ops.int8``, the engine's
schemes) against the JAX package's, on the CPU.

At the 96-px Xception of ``tests/test_quantize.py`` with the clothing
model's head (10 labels, ``head_hidden=(100,)``), weights from seed 1.
Tolerances, each named where it is used:

- the numpy half (``quantize_variables``, dequantization, ``clip_scale``,
  noise images, the tree predicates): equal, byte for byte;
- calibration: the same 68 keys as JAX's, each scale within 1e-5
  relative (``CALIB_RTOL``: the two float graphs sum in other orders, so
  the activations' last bits differ);
- a layer's int32 accumulators against JAX's ``conv_general_dilated(int8,
  int8, preferred_element_type=int32)``, and the whole layer (quantize-in,
  int op, epilogue) against JAX's interceptor math on the same f32 input:
  equal;
- the whole model against JAX's w8a8 program: relative max-abs logit
  difference <= 5e-2 and top-1 equal on every image (``MODEL_RTOL``: one
  int8 code that flips at a rounding tie of the two float graphs moves
  every later layer; JAX's own program moves 1.3e-2 for one ulp of input).

Calibration here uses percentile 100 (absmax), as ``tests/test_quantize.py``
does: uniform-noise calibration images have no outliers for the 99.9 clip
to remove (``test_calibration_matches_jax`` holds both percentiles).
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubernetes_deep_learning_tpu.export import artifact as jart
from kubernetes_deep_learning_tpu.models import init_variables as jax_init_variables
from kubernetes_deep_learning_tpu.modelspec import ModelSpec as JaxSpec
from kubernetes_deep_learning_tpu.modelspec import register_spec
from kubernetes_deep_learning_tpu.ops import quantize as jq
from kubernetes_deep_learning_tpu_torch import weights
from kubernetes_deep_learning_tpu_torch.export import artifact as art
from kubernetes_deep_learning_tpu_torch.models import build_forward
from kubernetes_deep_learning_tpu_torch.models.layers import Conv2dNHWC
from kubernetes_deep_learning_tpu_torch.modelspec import CLOTHING_MODEL, ModelSpec
from kubernetes_deep_learning_tpu_torch.ops import int8 as int8_ops
from kubernetes_deep_learning_tpu_torch.ops import quantize as tq
from kubernetes_deep_learning_tpu_torch.runtime import InferenceEngine
from torch_threads import one_torch_thread  # noqa: F401

CALIB_RTOL = 1e-5
MODEL_RTOL = 5e-2
PCT = 100.0
NAME = "torch-quant-xception"
SPEC_KW = dict(family="xception", input_shape=(96, 96, 3), labels=CLOTHING_MODEL.labels,
               preprocessing="tf", resize_filter="nearest", head_hidden=(100,))
# clothing-model's structure under the JAX rule (min_size 4096, head skipped):
# 39 dense convs and 29 depthwise convs quantized.
QUANTIZED_LAYERS = 68


@pytest.fixture(scope="module")
def jspec():
    return register_spec(JaxSpec(name=NAME, **SPEC_KW))


@pytest.fixture(scope="module")
def tspec():
    return ModelSpec(name=NAME, **SPEC_KW)


def _calib_images() -> np.ndarray:
    return np.random.default_rng(7).integers(0, 256, (16, 96, 96, 3), np.uint8)


def _images(n: int = 4, seed: int = 11) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, (n, 96, 96, 3), np.uint8)


@pytest.fixture(scope="module")
def jax_root(jspec, tmp_path_factory):
    """(root, float variables): v1 float and v2 int8-w8a8, both written by
    the JAX package (its ``write_quantized_version``, 16 noise images)."""
    root = str(tmp_path_factory.mktemp("jax-quant"))
    variables = jax.tree_util.tree_map(np.asarray, jax_init_variables(jspec, seed=1))
    jart.save_artifact(jart.version_dir(root, NAME, 1), jspec, variables, None,
                       {"compute_dtype": "float32"})
    jq.write_quantized_version(root, NAME, scheme=jq.SCHEME_W8A8,
                               calib_images=_calib_images(), percentile=PCT)
    return root, variables


@pytest.fixture(scope="module")
def w8a8_tree(jax_root):
    return art.load_artifact(art.version_dir(jax_root[0], NAME, 2)).variables


@pytest.fixture(scope="module")
def jax_w8a8_logits(jspec, w8a8_tree):
    """JAX's w8a8 program (the one its engine jits) on ``_images()``."""
    fwd = jax.jit(jq.build_w8a8_forward(jspec))
    return np.asarray(fwd(w8a8_tree, _images()))


def _assert_trees_equal(a, b, path=""):
    assert isinstance(a, dict) == isinstance(b, dict), path
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), path
        for k in a:
            _assert_trees_equal(a[k], b[k], f"{path}/{k}")
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (path, a.dtype, b.dtype)
    assert a.tobytes() == b.tobytes(), path


def _miscalibrated(tree):
    """Every activation scale x1000 (JAX's test_gate_refuses_miscalibrated_artifact)."""
    if isinstance(tree, dict):
        if tq.ACT_SCALE_KEY in tree:
            scaled = np.asarray(tree[tq.ACT_SCALE_KEY], np.float32) * np.float32(1e3)
            return {**tree, tq.ACT_SCALE_KEY: np.asarray(scaled, np.float32)}
        return {k: _miscalibrated(v) for k, v in tree.items()}
    return tree


def _rel(got, want) -> float:
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-9))


# --- the numpy half -------------------------------------------------------------


@pytest.mark.parametrize("min_size,skip", [(4096, ("head",)), (700_000, ("head",)), (1, ())])
def test_quantize_variables_matches_jax_byte_for_byte(jax_root, min_size, skip):
    _, variables = jax_root
    want = jq.quantize_variables(variables, min_size=min_size, skip=skip)
    got = tq.quantize_variables(variables, min_size=min_size, skip=skip)
    _assert_trees_equal(got, want)
    assert tq.is_quantized(got) and not tq.is_quantized(variables)
    if min_size == 4096:
        assert len(tq.quantized_leaves(got)) == QUANTIZED_LAYERS


def test_dequantization_matches_jax_bit_for_bit(w8a8_tree):
    got = tq.dequantize_variables_host(w8a8_tree)
    _assert_trees_equal(got, jq.dequantize_variables_host(w8a8_tree))
    # The engine-side (jnp) dequantization the JAX weight-only engine runs.
    _assert_trees_equal(got, jax.device_get(jq.dequantize_variables(w8a8_tree)))


def test_tree_predicates_match_jax(jax_root, w8a8_tree):
    _, variables = jax_root
    assert tq.is_calibrated(w8a8_tree) and jq.is_calibrated(w8a8_tree)
    assert not tq.is_calibrated(tq.quantize_variables(variables))
    got, want = tq.activation_scales(w8a8_tree), jq.activation_scales(w8a8_tree)
    assert sorted(got) == sorted(want) and len(got) == QUANTIZED_LAYERS
    for k in want:
        assert got[k].tobytes() == want[k].tobytes(), k
    bare = tq.quantize_variables(variables)
    _assert_trees_equal(tq.attach_activation_scales(bare["params"], want),
                        jq.attach_activation_scales(bare["params"], want))


@pytest.mark.parametrize("percentile", [100.0, 99.9, 50.0])
@pytest.mark.parametrize("stream", ["zeros", "outlier", "empty"])
def test_clip_scale_matches_jax(stream, percentile):
    rng = np.random.default_rng(0)
    values = {"zeros": np.zeros(1000, np.float32), "empty": np.zeros(0, np.float32),
              "outlier": np.abs(rng.normal(0.2, 0.2, 10_000)).clip(0, 1.0)}[stream]
    if stream == "outlier":
        values[1234] = 1000.0
    got, want = tq.clip_scale(values, percentile), jq.clip_scale(values, percentile)
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()


@pytest.mark.parametrize("n", [1, 2, 7, 1000, 4_000_001])
@pytest.mark.parametrize("percentile", [100.0, 99.9, 50.0, 0.0])
def test_percentile_on_a_tensor_is_numpys(n, percentile):
    """Calibration's percentile (two order statistics found with torch,
    numpy's own index and interpolation arithmetic) equals np.percentile."""
    a = np.abs(np.random.default_rng(n).normal(0, 1, n)).astype(np.float32)
    assert tq._percentile(torch.from_numpy(a), percentile) == float(np.percentile(a, percentile))


def test_representative_images_match_jax(jspec, tspec, tmp_path):
    np.testing.assert_array_equal(tq.representative_images(tspec, 5, seed=3),
                                  jq.representative_images(jspec, 5, seed=3))
    from PIL import Image

    rng = np.random.default_rng(0)
    for i in range(3):
        Image.fromarray(rng.integers(0, 256, (40, 50, 3), np.uint8)).save(tmp_path / f"{i}.png")
    np.testing.assert_array_equal(
        tq.representative_images(tspec, 4, image_dir=str(tmp_path)),
        jq.representative_images(jspec, 4, image_dir=str(tmp_path)))


# Committed JPEG and PNG fixtures (grey, 4:2:2, 4:4:4, palette, RGBA): a
# calibration directory whose five files the seven images below cycle over.
CALIB_FIXTURES = ("q75_422_64x47.jpg", "q80_grey_33x21.jpg", "q90_444_37x29.jpg",
                  "palette_23x17.png", "rgba_19x25.png")
FIXTURE_DIR = os.path.join(os.path.dirname(__file__), "ingest_fixtures")


def _calib_dir(tmp_path, extra=()) -> str:
    for name in CALIB_FIXTURES:
        shutil.copy(os.path.join(FIXTURE_DIR, name), tmp_path / name)
    for name in extra:
        shutil.copy(os.path.join(FIXTURE_DIR, CALIB_FIXTURES[0]), tmp_path / name)
    return str(tmp_path)


@pytest.mark.parametrize("resize_filter", ["bilinear", "nearest"])
def test_representative_images_from_fixtures_match_jax(jspec, tspec, tmp_path, resize_filter):
    """C8: the port's image directory branch (no PIL) gives JAX's array:
    the same files in the same order, cycled, decoded and resized alike."""
    root = _calib_dir(tmp_path)
    got = tq.representative_images(dataclasses.replace(tspec, resize_filter=resize_filter), 7,
                                   image_dir=root)
    want = jq.representative_images(dataclasses.replace(jspec, resize_filter=resize_filter), 7,
                                    image_dir=root)
    assert got.shape == (7, 96, 96, 3) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[5:], got[:2])


def test_representative_images_need_no_pil(jspec, tspec, tmp_path, monkeypatch):
    """The card's machine has no PIL: with it hidden, the same array."""
    root = _calib_dir(tmp_path)
    want = jq.representative_images(jspec, 7, image_dir=root)
    monkeypatch.setitem(sys.modules, "PIL", None)
    monkeypatch.setitem(sys.modules, "PIL.Image", None)
    with pytest.raises(ImportError):
        import PIL.Image  # noqa: F401
    np.testing.assert_array_equal(tq.representative_images(tspec, 7, image_dir=root), want)


@pytest.mark.parametrize("ext", [".bmp", ".webp"])
def test_representative_images_refuse_what_the_port_does_not_decode(tspec, tmp_path, ext):
    root = _calib_dir(tmp_path, extra=(f"zz{ext}",))
    with pytest.raises(ValueError, match=f"zz\\{ext}"):
        tq.representative_images(tspec, len(CALIB_FIXTURES) + 1, image_dir=root)


# --- calibration ---------------------------------------------------------------


@pytest.mark.parametrize("percentile", [PCT, 99.9])
def test_calibration_matches_jax(jspec, tspec, jax_root, w8a8_tree, percentile):
    """The same 68 keys (flax path tuples) as JAX's calibration of the same
    float tree on the same 16 images, each scale within CALIB_RTOL."""
    _, variables = jax_root
    qvars = tq.quantize_variables(variables)
    got = tq.calibrate_activation_scales(tspec, variables, qvars, _calib_images(),
                                         percentile=percentile, device="cpu")
    if percentile == PCT:  # the artifact JAX wrote holds its scales
        want = jq.activation_scales(w8a8_tree)
    else:
        want = jq.calibrate_activation_scales(jspec, variables, qvars, _calib_images(),
                                              percentile=percentile)
    assert sorted(got) == sorted(want) and len(got) == QUANTIZED_LAYERS
    assert ("block13_sepconv2", "depthwise") in got and ("block1_conv2",) in got
    for k in want:
        assert got[k].dtype == np.float32
        np.testing.assert_allclose(got[k], want[k], rtol=CALIB_RTOL, err_msg=str(k))


# --- one layer: the kernels' plain versions ----------------------------------


# (batch, side, C_in, C_out, k, stride, padding, groups)
LAYERS = {
    "pointwise 728 (K tail), batch 3": (3, 19, 728, 728, 1, 1, "VALID", 1),
    "residual 1x1/2 SAME 19->10": (2, 19, 728, 1024, 1, 2, "SAME", 1),
    "residual 1x1/2 SAME 147->74": (1, 147, 64, 128, 1, 2, "SAME", 1),
    "conv 3x3 VALID": (2, 23, 32, 64, 3, 1, "VALID", 1),
    "depthwise 3x3 SAME, batch 3": (3, 19, 728, 728, 3, 1, "SAME", 728),
    "C 40 (a K tail)": (3, 9, 40, 24, 1, 1, "VALID", 1),
    "C 40, 3x3/2 SAME": (2, 11, 40, 200, 3, 2, "SAME", 1),
    "depthwise C 40": (3, 9, 40, 40, 3, 1, "SAME", 40),
    # ResNet50's stem: C_in 3, flax's explicit pads.
    "stem 7x7/2, C_in 3, pads (3,3)": (2, 20, 3, 64, 7, 2, ((3, 3), (3, 3)), 1),
    # EfficientNet's squeeze-excite convs, on (N, 1, 1, C).
    "1x1 C_in 34 on 1x1 (SE expand)": (3, 1, 34, 136, 1, 1, "SAME", 1),
    "1x1 C_out 34 on 1x1 (SE reduce)": (3, 1, 136, 34, 1, 1, "SAME", 1),
    # EfficientNet's depthwise convs: 5x5, stride 2, SAME pads (1, 2) on an even side.
    "depthwise 5x5/1 SAME": (2, 10, 48, 48, 5, 1, "SAME", 48),
    "depthwise 5x5/2 SAME, even side": (2, 10, 48, 48, 5, 2, "SAME", 48),
    "depthwise 3x3/2 SAME, even side": (3, 12, 24, 24, 3, 2, "SAME", 24),
}


def _layer(case: str, seed: int = 0):
    """Random f32 input, int8 HWIO codes, f32 weight scales, an activation scale."""
    b, h, c, c_out, k, s, pad, groups = LAYERS[case]
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1.5, (b, h, h, c)).astype(np.float32)
    q = rng.integers(-127, 128, (k, k, c // groups, c_out)).astype(np.int8)
    sw = rng.uniform(1e-3, 2e-2, c_out).astype(np.float32)
    return x, q, sw, np.float32(0.0173), (k, s, pad, groups)


def _jax_layer(x, q, sw, s_act, geometry):
    """JAX's interceptor math (ops/quantize.py build_w8a8_forward): (int32
    accumulators, f32 output)."""
    _, s, pad, groups = geometry
    pad = pad if isinstance(pad, str) else list(pad)

    @jax.jit
    def f(x, q, sw, s_act):
        lhs = jnp.clip(jnp.round(x / s_act), -127, 127).astype(jnp.int8)
        acc = jax.lax.conv_general_dilated(
            lhs, q, window_strides=(s, s), padding=pad,
            dimension_numbers=("NHWC", "HWIO", "NHWC"), feature_group_count=groups,
            preferred_element_type=jnp.int32)
        return acc, acc.astype(jnp.float32) * (s_act * sw)

    acc, y = f(x, q, sw, s_act)
    return np.asarray(acc), np.asarray(y)


@pytest.mark.parametrize("case", list(LAYERS))
def test_int8_accumulators_equal_jax_int_conv(case):
    x, q, sw, s_act, geometry = _layer(case)
    _, s, pad, groups = geometry
    want, _ = _jax_layer(x, q, sw, s_act, geometry)
    codes = int8_ops.quantize_input(torch.from_numpy(x), float(s_act))
    got = int8_ops.int8_accumulate_reference(
        codes, torch.from_numpy(q.transpose(3, 2, 0, 1).copy()), s, pad, groups)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("case", list(LAYERS))
def test_int8_layer_equals_jax_interceptor_math(case):
    """``Int8Conv2d`` (quantize-in, int op, epilogue; its CPU path is the
    kernels' plain version) equals JAX's w8a8 layer on the same input."""
    x, q, sw, s_act, geometry = _layer(case, seed=1)
    k, s, pad, groups = geometry
    c_in, c_out = x.shape[-1], q.shape[-1]
    conv = Conv2dNHWC(c_in, c_out, k, s, pad, groups)
    layer = int8_ops.Int8Conv2d(conv, torch.from_numpy(q.transpose(3, 2, 0, 1).copy()),
                                torch.from_numpy(sw), s_act)
    assert layer.kind == ("depthwise" if groups > 1 else "conv")
    _, want = _jax_layer(x, q, sw, s_act, geometry)
    got = layer(torch.from_numpy(x))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


def test_packing_round_trips_and_pads_k_with_zeros():
    """Q1's packing: taps (kh, kw, C_pad), C_pad = C_in rounded up to 16
    (40 -> 48), K = 9 * 48 = 432 rounded up to 512; every pad is zero."""
    rng = np.random.default_rng(2)
    q = torch.from_numpy(rng.integers(-127, 128, (24, 40, 3, 3)).astype(np.int8))
    packed = int8_ops.pack_conv(q)
    assert packed.shape == (24, 512) and not packed[:, 432:].any()
    taps = packed[:, :432].reshape(24, 3, 3, 48)
    assert not taps[..., 40:].any()
    torch.testing.assert_close(taps[..., :40], q.permute(0, 2, 3, 1), rtol=0, atol=0)
    torch.testing.assert_close(int8_ops.unpack_conv(packed, 40, 3, 3), q, rtol=0, atol=0)
    for k in (3, 5):
        dw = torch.from_numpy(rng.integers(-127, 128, (40, 1, k, k)).astype(np.int8))
        assert int8_ops.pack_depthwise(dw).shape == (k * k, 40)
        torch.testing.assert_close(int8_ops.unpack_depthwise(int8_ops.pack_depthwise(dw)), dw,
                                   rtol=0, atol=0)


@pytest.mark.parametrize("c", [3, 34, 48, 728])
def test_int8_codes_are_quantize_input_padded_with_zero(c):
    """Q1's quantize pass (its plain version here): ``quantize_input``'s
    codes, the channel stride padded to a multiple of 16 with code 0; for
    a 1x1 conv of stride 2 (top/left pads 1 here) only the pixels it
    reads, code 0 outside the image."""
    x = torch.from_numpy(np.random.default_rng(c).normal(0, 3, (2, 5, 6, c)).astype(np.float32))
    want = int8_ops.quantize_input(x, 0.0173).to(torch.int8)
    codes = int8_ops.int8_codes(x, 0.0173)
    assert codes.dtype == torch.int8 and codes.shape == (2, 5, 6, int8_ops.code_width(c))
    assert codes.shape[-1] % 16 == 0 and not codes[..., c:].any()
    assert torch.equal(codes[..., :c], want)
    assert codes.abs().max() == 127  # some codes reach the clamp
    sampled = int8_ops.int8_codes(x, 0.0173, sample=(2, 1, 1, 4, 4))
    assert sampled.shape == (2, 4, 4, int8_ops.code_width(c))
    assert not sampled[:, 0].any() and not sampled[:, :, 0].any() and not sampled[:, 3].any()
    assert torch.equal(sampled[:, 1:3, 1:, :c], want[:, 1::2, 1::2])


# (M, C_out, K_pad, kernel) -> (warpgroups, TMA for A) on the H100's 132 SMs
Q1_INSTANCES = {
    "middle flow 19x19x728 batch 16": ((16 * 19 * 19, 728, 768, (1, 1)), (2, True)),
    "block14 1536->2048 batch 16": ((16 * 10 * 10, 2048, 1536, (1, 1)), (2, True)),
    "residual 1x1/2 (its pixels by TMA)": ((16 * 74 * 74, 128, 128, (1, 1)), (2, True)),
    "ResNet50 stem 7x7/2 C_in 3": ((16 * 112 * 112, 64, 896, (7, 7)), (2, False)),
    "SE reduce at M = batch": ((16, 58, 1408, (1, 1)), (1, True)),
}


@pytest.mark.parametrize("case", list(Q1_INSTANCES))
def test_q1_instance_is_chosen_by_shape(case):
    args, want = Q1_INSTANCES[case]
    assert int8_ops.q1_instance(*args, 132) == want


def test_int8_layer_refuses_what_no_kernel_takes():
    # Q1 takes any width and explicit pads; Q2 3x3 and 5x5, stride 1 and 2.
    assert int8_ops.check_cuda_layer(3, 64, (7, 7), 2, ((3, 3), (3, 3)), 1) == "conv"
    assert int8_ops.check_cuda_layer(34, 136, (1, 1), 1, "SAME", 1) == "conv"
    assert int8_ops.check_cuda_layer(48, 48, (5, 5), 2, "SAME", 48) == "depthwise"
    with pytest.raises(ValueError, match="no int8 kernel"):
        int8_ops.check_cuda_layer(64, 64, (7, 7), 1, "SAME", 64)
    with pytest.raises(ValueError, match="no int8 kernel"):
        int8_ops.check_cuda_layer(64, 64, (3, 3), 1, "SAME", 2)
    with pytest.raises(ValueError, match="no int8 kernel"):
        int8_ops.check_cuda_layer(64, 64, (3, 3), 3, "SAME", 64)
    with pytest.raises(ValueError, match="no int8 kernel"):
        int8_ops.check_cuda_layer(64, 64, (3, 3), 1, "VALID", 64)
    with pytest.raises(ValueError, match="multiples of 4"):
        int8_ops.check_cuda_layer(6, 6, (3, 3), 1, "SAME", 6)
    with pytest.raises(ValueError, match="negative padding"):
        int8_ops.check_cuda_layer(8, 8, (3, 3), 1, ((-1, 0), (0, 0)), 1)


# --- weights and the model ------------------------------------------------------


def test_from_jax_quantized_gives_port_layouts(w8a8_tree):
    params, leaves = weights.from_jax_quantized(w8a8_tree)
    assert len(leaves) == QUANTIZED_LAYERS
    dw = leaves["block13_sepconv2.depthwise"]
    assert dw.weight.shape == (728, 1, 3, 3) and dw.weight.dtype == torch.int8
    assert dw.scale.shape == (728,) and dw.act_scale.dtype == np.float32
    assert leaves["block1_conv2"].weight.shape == (64, 32, 3, 3)
    # The float half is the host-dequantized tree, bit for bit.
    deq = jq.dequantize_variables_host(w8a8_tree)
    want = np.asarray(deq["params"]["block5_sepconv1"]["pointwise"]["kernel"])
    np.testing.assert_array_equal(params["block5_sepconv1.pointwise.weight"].numpy(),
                                  want.transpose(3, 2, 0, 1))
    with pytest.raises(ValueError, match="from_jax_quantized"):
        weights.from_jax_variables(w8a8_tree)


def test_xception_calls_every_conv_through_its_module(tspec, jax_root):
    from kubernetes_deep_learning_tpu_torch.models import create_model

    model = create_model(tspec)
    convs = {n for n, m in model.named_modules() if isinstance(m, Conv2dNHWC)}
    assert len(convs) == 74
    called = []
    for n, m in model.named_modules():
        if n in convs:
            m.register_forward_pre_hook(lambda mod, args, n=n: called.append(n))
    with torch.inference_mode():
        model(torch.zeros((1, 96, 96, 3)))
    assert sorted(called) == sorted(convs)


def test_w8a8_forward_matches_jax(tspec, w8a8_tree, jax_w8a8_logits):
    """The whole model against JAX's w8a8 program on the same calibrated
    tree: MODEL_RTOL, top-1 equal on every image."""
    fwd = tq.build_w8a8_forward(tspec, w8a8_tree, device="cpu")
    kinds = [m.kind for m in fwd.modules() if isinstance(m, int8_ops.Int8Conv2d)]
    assert kinds.count("conv") == 39 and kinds.count("depthwise") == 29
    with torch.inference_mode():
        got = fwd(torch.from_numpy(_images())).numpy()
    assert _rel(got, jax_w8a8_logits) <= MODEL_RTOL
    np.testing.assert_array_equal(got.argmax(-1), jax_w8a8_logits.argmax(-1))


def test_uncalibrated_leaf_stays_a_float_conv(tspec, w8a8_tree):
    tree = dict(w8a8_tree)
    params = dict(tree["params"])
    leaf = dict(params["block5_sepconv1"]["pointwise"]["kernel"])
    del leaf[tq.ACT_SCALE_KEY]
    params["block5_sepconv1"] = {**params["block5_sepconv1"],
                                 "pointwise": {"kernel": leaf}}
    tree["params"] = params
    fwd = tq.build_w8a8_forward(tspec, tree, device="cpu")
    module = fwd.inner.block5_sepconv1.pointwise
    assert type(module) is Conv2dNHWC
    deq = tq.dequantize_variables_host({"params": {"k": leaf}})["params"]["k"]
    np.testing.assert_array_equal(module.weight.detach().numpy(), deq.transpose(3, 2, 0, 1))
    assert sum(isinstance(m, int8_ops.Int8Conv2d) for m in fwd.modules()) == 67


# --- the engine -------------------------------------------------------------------


def _engine(root, version, tree=None, buckets=(4,)):
    a = art.load_artifact(art.version_dir(root, NAME, version))
    if tree is not None:
        a = dataclasses.replace(a, variables=tree)
    return InferenceEngine(a, buckets=buckets, device="cpu")


def test_engine_serves_a_jax_written_w8a8_artifact(jax_root, jax_w8a8_logits):
    eng = _engine(jax_root[0], 2)
    assert eng.quantization == eng.quantization_active == tq.SCHEME_W8A8 and not eng.fast
    eng.warmup()  # the tolerance gate
    assert eng.quantization_active == tq.SCHEME_W8A8 and not eng.quant_gate_failed
    assert 0 <= eng.quant_gate_drift <= tq.resolve_quant_tol()
    assert eng.quant_gate_top1 >= tq.GATE_TOP1
    got = eng.predict(_images())
    assert _rel(got, jax_w8a8_logits) <= MODEL_RTOL
    np.testing.assert_array_equal(got.argmax(-1), jax_w8a8_logits.argmax(-1))
    assert eng._m_quant["scheme"][tq.SCHEME_W8A8].value == 1.0
    assert eng._m_quant["scheme"]["float32"].value == 0.0
    assert eng._m_quant["gate_failures"].value == 0.0


def test_engine_downgrades_a_miscalibrated_artifact(jax_root, w8a8_tree):
    root = jax_root[0]
    eng = _engine(root, 2, _miscalibrated(w8a8_tree))
    eng.warmup()
    assert eng.quant_gate_failed and eng.quant_gate_drift > tq.resolve_quant_tol()
    assert eng.quantization == tq.SCHEME_W8A8
    assert eng.quantization_active == tq.SCHEME
    assert eng._m_quant["gate_failures"].value == 1.0
    assert eng._m_quant["scheme"][tq.SCHEME].value == 1.0
    assert eng._m_quant["scheme"][tq.SCHEME_W8A8].value == 0.0
    assert not any(isinstance(m, int8_ops.Int8Conv2d) for m in eng._forward.modules())
    # The fallback serves the weight-only numerics: the float graph on the
    # dequantized tree, bit for bit.
    params, _ = weights.from_jax_quantized(w8a8_tree)
    with torch.inference_mode():
        want = build_forward(eng.spec, params, torch.float32, False, "cpu")(
            torch.from_numpy(_images())).numpy()
    np.testing.assert_array_equal(eng.predict(_images()), want)


def test_scheme_override_env_forces_weight_only(jax_root, monkeypatch):
    monkeypatch.setenv(tq.QUANT_SCHEME_ENV, "weight-only")
    eng = _engine(jax_root[0], 2, buckets=(1,))
    assert eng.quantization == tq.SCHEME_W8A8
    assert eng.quantization_active == tq.SCHEME
    eng.warmup()
    assert not eng.quant_gate_failed and eng.quant_gate_drift is None
    assert eng._m_quant["gate_failures"].value == 0.0
    assert eng._m_quant["scheme"][tq.SCHEME].value == 1.0


def test_weight_only_artifact_is_bit_equal_to_float_serving_of_the_dequantized_tree(
        jax_root, tmp_path):
    root, _ = jax_root
    src = str(tmp_path)
    shutil.copytree(os.path.join(root, NAME, "1"), os.path.join(src, NAME, "1"))
    jq.write_quantized_version(src, NAME, scheme=jq.SCHEME)
    quantized = art.load_artifact(art.version_dir(src, NAME, 2))
    eng = InferenceEngine(quantized, buckets=(4,), device="cpu")
    assert eng.quantization == eng.quantization_active == tq.SCHEME
    eng.warmup()
    deq = dataclasses.replace(quantized, variables=tq.dequantize_variables_host(
        quantized.variables), metadata={"compute_dtype": "float32"})
    float_engine = InferenceEngine(deq, buckets=(4,), device="cpu")
    np.testing.assert_array_equal(eng.predict(_images()), float_engine.predict(_images()))
    assert eng._m_quant["scheme"][tq.SCHEME].value == 1.0
    assert float_engine._m_quant["scheme"]["float32"].value == 1.0


@pytest.mark.parametrize("scheme", [tq.SCHEME, tq.SCHEME_W8A8])
def test_port_written_version_loads_in_jax_and_matches_its_tree(jax_root, tmp_path, scheme):
    """The port's ``write_quantized_version`` and JAX's, from the same float
    version: JAX's ``load_artifact`` reads the port's, the int8 leaves and
    weight scales are equal and the activation scales within CALIB_RTOL."""
    root, _ = jax_root
    ours, theirs = str(tmp_path / "port"), str(tmp_path / "jax")
    for r in (ours, theirs):
        shutil.copytree(os.path.join(root, NAME, "1"), os.path.join(r, NAME, "1"))
    path = tq.write_quantized_version(ours, NAME, scheme=scheme, calib_images=_calib_images(),
                                      percentile=PCT, device="cpu")
    assert path == art.version_dir(ours, NAME, 2)
    jq.write_quantized_version(theirs, NAME, scheme=scheme, calib_images=_calib_images(),
                               percentile=PCT)
    got = jart.load_artifact(path)
    want = jart.load_artifact(jart.version_dir(theirs, NAME, 2))
    assert got.metadata == want.metadata
    strip = lambda t: {k: strip(v) for k, v in t.items() if k != tq.ACT_SCALE_KEY} \
        if isinstance(t, dict) else t  # noqa: E731
    _assert_trees_equal(strip(got.variables), strip(want.variables))
    g, w = jq.activation_scales(got.variables), jq.activation_scales(want.variables)
    assert sorted(g) == sorted(w) and len(w) == (QUANTIZED_LAYERS if scheme == tq.SCHEME_W8A8
                                                 else 0)
    for k in w:
        np.testing.assert_allclose(g[k], w[k], rtol=CALIB_RTOL, err_msg=str(k))
    for path, leaf in tq.quantized_leaves(want.variables).items():
        if tq.ACT_SCALE_KEY in leaf:  # a 0-d float32, as JAX writes it
            ours_leaf = tq.quantized_leaves(got.variables)[path][tq.ACT_SCALE_KEY]
            assert ours_leaf.shape == leaf[tq.ACT_SCALE_KEY].shape == ()
            assert ours_leaf.dtype == np.float32
    with pytest.raises(ValueError, match="already quantized"):
        tq.write_quantized_version(ours, NAME, device="cpu")


def test_quantize_cli_writes_the_next_version(jax_root, tmp_path, capsys):
    root, _ = jax_root
    shutil.copytree(os.path.join(root, NAME, "1"), os.path.join(tmp_path, NAME, "1"))
    assert tq.main(["--models", str(tmp_path), "--model", NAME, "--scheme", tq.SCHEME_W8A8,
                    "--calibrate-images", "2", "--calibrate-percentile", "100",
                    "--device", "cpu"]) == 0
    assert "int8-w8a8" in capsys.readouterr().out
    loaded = art.load_artifact(art.version_dir(str(tmp_path), NAME, 2))
    assert loaded.metadata["calibration"] == {"images": 2, "percentile": 100.0,
                                              "layers": QUANTIZED_LAYERS}


def test_registry_hot_reload_from_float_to_w8a8_reports_both_schemes(jax_root, w8a8_tree,
                                                                      tmp_path):
    """A float v1 served, then the JAX-written w8a8 v2 hot-loaded: ``:status``
    and ``/metrics`` carry the scheme; then a miscalibrated v3: requested
    w8a8, serving weight-only, one gate failure."""
    from kubernetes_deep_learning_tpu_torch.serving.model_server import ModelServer

    root, _ = jax_root
    shutil.copytree(os.path.join(root, NAME, "1"), os.path.join(tmp_path, NAME, "1"))
    server = ModelServer(str(tmp_path), port=0, buckets=(1, 2), device="cpu")

    def status():
        code, body = server.handle_get(f"/v1/models/{NAME}:status")[:2]
        assert code == 200
        s = json.loads(body)
        return s["version"], s["quantization"], s["quantization_active"]

    try:
        server.warmup()
        assert status() == (1, None, None)
        shutil.copytree(os.path.join(root, NAME, "2"), os.path.join(tmp_path, NAME, "2"))
        assert server.poll_versions() == [f"{NAME} v2"]
        assert status() == (2, tq.SCHEME_W8A8, tq.SCHEME_W8A8)
        assert json.loads(server.handle_get("/v1/models")[1])[NAME]["quantization_active"] \
            == tq.SCHEME_W8A8
        text = server.registry.render()
        assert f'kdlt_quant_scheme{{model="{NAME}",version="2",scheme="int8-w8a8"}} 1.0' in text
        bad = art.load_artifact(os.path.join(tmp_path, NAME, "2"))
        art.save_artifact(os.path.join(tmp_path, NAME, "3"), bad.spec,
                          _miscalibrated(bad.variables), bad.metadata)
        assert server.poll_versions() == [f"{NAME} v3"]
        assert status() == (3, tq.SCHEME_W8A8, tq.SCHEME)
        text = server.registry.render()
        assert f'kdlt_quant_gate_failures_total{{model="{NAME}",version="3"}} 1.0' in text
    finally:
        server.shutdown()
