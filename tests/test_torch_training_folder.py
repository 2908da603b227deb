"""The port's image-folder reader and the fit -> checkpoint -> export ->
serve pipeline of a BatchNorm family, against the JAX package's, on the
CPU.

``image_folder_batches`` on a ``<root>/<label>/<file>`` folder of JPEG and
PNG files that PIL wrote from a seed: the same labels in the same order
for two epochs, byte-equal images at both resize filters, and JAX's three
errors.  A BMP, which the JAX reader opens with PIL, is refused by name.

Then Xception (the clothing model's family, full width, a hidden head
layer) at 32 px, batch 4, fed from such a folder: ``fit`` interrupted by a
checkpoint and resumed equals one uninterrupted run, running statistics
included (within 1e-6: the same float32 program on the same CPU), and
``fit_and_export`` writes an artifact both packages' engines serve: the
port's within 1e-6 of the trained state's own eval forward, and the exact
float32 logits within 1e-4 of the JAX engine's (as the ViT artifact in
``tests/test_torch_training.py``).
"""

from __future__ import annotations

import dataclasses
import functools
import io
import os

import jax
import numpy as np
import pytest
import torch
from PIL import Image
from torch_bn_training import torch_threads

from kubernetes_deep_learning_tpu.export import artifact as jax_art
from kubernetes_deep_learning_tpu.modelspec import ModelSpec as JaxModelSpec
from kubernetes_deep_learning_tpu.runtime.engine import InferenceEngine as JaxEngine
from kubernetes_deep_learning_tpu.training import data as jax_data
from kubernetes_deep_learning_tpu_torch.export import artifact as art
from kubernetes_deep_learning_tpu_torch.models import build_forward
from kubernetes_deep_learning_tpu_torch.modelspec import ModelSpec
from kubernetes_deep_learning_tpu_torch.runtime import InferenceEngine
from kubernetes_deep_learning_tpu_torch.training import (
    Checkpointer,
    create_train_state,
    fit,
    fit_and_export,
    image_folder_batches,
)
from kubernetes_deep_learning_tpu_torch.weights import to_jax_variables

LABELS = ("pants", "shirt", "shoes")


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    """One torch thread, restored after: see ``torch_bn_training.torch_threads``."""
    with torch_threads():
        yield


def _spec_kw(filter: str, px: int = 32) -> dict:
    return dict(name=f"torch-folder-{filter}", family="xception", input_shape=(px, px, 3),
                labels=LABELS, preprocessing="tf", resize_filter=filter, head_hidden=(8,))


def _write_folder(root: str, per_label: int, seed: int) -> None:
    """JPEG (4:2:0, 4:4:4, greyscale) and PNG (RGB, RGBA, palette) files of
    several sizes under ``root/<label>/``, made from ``seed``."""
    rng = np.random.default_rng(seed)
    for li, label in enumerate(LABELS):
        os.makedirs(os.path.join(root, label))
        for i in range(per_label):
            h, w = (int(v) for v in rng.integers(20, 90, 2))
            base = rng.uniform(0, 255, (1, 1, 3)) + rng.normal(0, 40, (h, w, 3))
            img = Image.fromarray(np.clip(base, 0, 255).astype(np.uint8))
            buf = io.BytesIO()
            kind = (li + i) % 6
            if kind == 0:
                img.save(buf, "JPEG", quality=85)
            elif kind == 1:
                img.save(buf, "JPEG", quality=95, subsampling=0)
            elif kind == 2:
                img.convert("L").save(buf, "JPEG", quality=75)
            elif kind == 3:
                img.save(buf, "PNG")
            elif kind == 4:
                img.convert("RGBA").save(buf, "PNG")
            else:
                img.convert("P").save(buf, "PNG")
            ext = "jpg" if kind < 3 else "png"
            with open(os.path.join(root, label, f"{label}_{i:03d}.{ext}"), "wb") as f:
                f.write(buf.getvalue())
    with open(os.path.join(root, LABELS[0], "README.txt"), "w") as f:
        f.write("not an image: skipped at scan time by both readers\n")


@pytest.mark.parametrize("filter", ["bilinear", "nearest"])
def test_image_folder_batches_equal_jax(tmp_path, filter):
    root = str(tmp_path / "data")
    _write_folder(root, 7, seed=11)
    jspec, spec = JaxModelSpec(**_spec_kw(filter)), ModelSpec(**_spec_kw(filter))
    want = list(jax_data.image_folder_batches(root, jspec, 4, epochs=2, seed=3))
    got = list(image_folder_batches(root, spec, 4, epochs=2, seed=3))
    assert len(got) == len(want) == 2 * (21 // 4)
    for (gi, gl), (wi, wl) in zip(got, want, strict=True):
        assert gi.dtype == wi.dtype == np.uint8 and gl.dtype == wl.dtype == np.int32
        np.testing.assert_array_equal(gl, wl)
        np.testing.assert_array_equal(gi, wi)
    tail = list(image_folder_batches(root, spec, 4, epochs=1, seed=3, drop_remainder=False))
    jtail = list(jax_data.image_folder_batches(root, jspec, 4, epochs=1, seed=3,
                                               drop_remainder=False))
    assert [len(b[1]) for b in tail] == [len(b[1]) for b in jtail] == [4] * 5 + [1]
    np.testing.assert_array_equal(tail[-1][0], jtail[-1][0])


def test_image_folder_errors_match_jax(tmp_path):
    jspec, spec = JaxModelSpec(**_spec_kw("nearest")), ModelSpec(**_spec_kw("nearest"))
    empty = tmp_path / "empty"
    empty.mkdir()
    for reader, s in ((jax_data.image_folder_batches, jspec), (image_folder_batches, spec)):
        with pytest.raises(FileNotFoundError, match="no class directories"):
            next(reader(str(empty), s, 2))
    few = str(tmp_path / "few")
    _write_folder(few, 1, seed=2)
    for reader, s in ((jax_data.image_folder_batches, jspec), (image_folder_batches, spec)):
        with pytest.raises(ValueError, match=r"only 3 sample\(s\).*batch=4"):
            next(reader(few, s, 4))
    (tmp_path / "few" / "hats").mkdir()
    for reader, s in ((jax_data.image_folder_batches, jspec), (image_folder_batches, spec)):
        with pytest.raises(ValueError, match="directory 'hats' is not a spec label"):
            next(reader(few, s, 2))


def test_image_folder_refuses_a_bmp_by_name(tmp_path):
    """JAX's reader opens a BMP with PIL; the port decodes JPEG and PNG
    only, and raises naming the file rather than skip it."""
    jspec, spec = JaxModelSpec(**_spec_kw("nearest")), ModelSpec(**_spec_kw("nearest"))
    root = tmp_path / "bmp"
    (root / "shoes").mkdir(parents=True)
    Image.fromarray(np.full((9, 7, 3), 120, np.uint8)).save(root / "shoes" / "a.bmp")
    images, labels = next(jax_data.image_folder_batches(str(root), jspec, 1))
    assert images.shape == (1, 32, 32, 3) and int(labels[0]) == LABELS.index("shoes")
    with pytest.raises(ValueError, match=r"a\.bmp.*\.bmp file.*only JPEG and PNG"):
        next(image_folder_batches(str(root), spec, 1))


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("folder") / "data")
    _write_folder(root, 4, seed=5)
    return root, ModelSpec(**_spec_kw("nearest"))


def _adam():
    return functools.partial(torch.optim.Adam, lr=1e-4, eps=1e-8)


def test_fit_resumes_from_a_checkpoint_as_if_uninterrupted(folder, tmp_path):
    """4 steps with checkpoints, then a new fit to 6 from the directory,
    equals 6 steps in one run: parameters and running statistics."""
    root, spec = folder
    src = list(image_folder_batches(root, spec, 4, epochs=2, seed=1))
    quiet = dict(device="cpu", log_fn=lambda s: None)
    whole, _ = fit(spec, _adam(), iter(src), steps=6, **quiet)
    ckpt = str(tmp_path / "ckpt")
    fit(spec, _adam(), iter(src[:4]), steps=4, ckpt_dir=ckpt, ckpt_every=2, **quiet)
    assert Checkpointer(ckpt).all_steps() == [2, 4]
    logs: list[str] = []
    resumed, hist = fit(spec, _adam(), iter(src[4:]), steps=6, ckpt_dir=ckpt, seed=99,
                        device="cpu", log_fn=logs.append)
    assert any("resumed" in line and "step 4" in line for line in logs)
    assert resumed.step == 6 and hist[-1][0] == 6
    assert resumed.batch_stats.keys() == whole.batch_stats.keys() and whole.batch_stats
    init = create_train_state(spec, _adam(), device="cpu")
    for name in ("params", "batch_stats"):
        for k, t in getattr(whole, name).items():
            torch.testing.assert_close(getattr(resumed, name)[k], t, rtol=0, atol=1e-6)
    moved = [k for k, t in whole.batch_stats.items() if not torch.equal(t, init.batch_stats[k])]
    assert len(moved) == len(whole.batch_stats)  # every running statistic trained

    fresh = create_train_state(spec, _adam(), seed=7, device="cpu")
    with Checkpointer(ckpt) as c:
        assert c.restore(fresh).step == 6
    for name in ("params", "batch_stats"):
        for k, t in getattr(resumed, name).items():
            assert torch.equal(getattr(fresh, name)[k], t), (name, k)


def test_fit_and_export_serves_in_both_packages(folder, tmp_path):
    root, spec = folder
    models = str(tmp_path / "models")
    evals: list = []
    d = fit_and_export(spec, _adam(), image_folder_batches(root, spec, 4, seed=2), 3, models,
                       device="cpu", log_fn=lambda s: None, ckpt_dir=str(tmp_path / "ckpt"),
                       eval_batches=lambda: image_folder_batches(root, spec, 4, epochs=1),
                       eval_every=2, eval_history=evals)
    assert d.endswith(os.path.join(spec.name, "1"))
    assert [s for s, _ in evals] == [2, 3] and evals[-1][1]["count"] == 12
    state = create_train_state(spec, _adam(), device="cpu")
    assert Checkpointer(str(tmp_path / "ckpt")).restore(state).step == 3
    tensors = {k: t.detach() for k, t in {**state.params, **state.batch_stats}.items()}

    loaded = jax_art.load_artifact(d)
    want_tree = to_jax_variables(tensors)
    flat = {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_leaves_with_path(want_tree)}
    got = {jax.tree_util.keystr(p): np.asarray(v)
           for p, v in jax.tree_util.tree_leaves_with_path(loaded.variables)}
    assert flat.keys() == got.keys() and any("batch_stats" in k for k in flat)
    for k in flat:
        np.testing.assert_array_equal(got[k], flat[k])

    images, _ = next(image_folder_batches(root, spec, 2, seed=9))
    x = (images.astype(np.float32) / 127.5 - 1.0).astype(np.float32)
    engine = InferenceEngine(art.load_artifact(d), buckets=(2,), device="cpu")
    with torch.no_grad():
        for dtype, imgs in ((torch.bfloat16, images), (torch.float32, x)):
            want = build_forward(spec, tensors, dtype, "auto", "cpu")(torch.from_numpy(imgs))
            np.testing.assert_allclose(engine.predict(imgs), want.numpy(), rtol=0, atol=1e-6)
        exact = engine.predict(x)
    jax_engine = JaxEngine(dataclasses.replace(loaded, metadata={"compute_dtype": "float32"}),
                           buckets=(2,), use_exported=False, fast=False)
    want = jax_engine.predict(images)
    assert np.abs(exact - want).max() / np.abs(want).max() < 1e-4
