"""The port's ingest path at PIL's breadth, and the device-side ingest resize.

- ``ops.preprocess.decode_image`` is byte-equal to
  ``PIL.Image.open(...).convert("RGB")`` on seeded images of every format
  the decoder reads beyond baseline JPEG and 8-bit PNG: progressive JPEG
  (PIL's and libjpeg's scan scripts, qualities, sampling factors, odd
  sizes, restart intervals), 4-component JPEG (Adobe CMYK, YCCK, no Adobe
  marker), 4:4:0 and 4:1:1 sampling (written by OpenCV), 16-bit PNG of
  colour types 0, 2, 4 and 6, and Adam7-interlaced PNG at depths 1, 2, 4, 8
  and 16 and in palette (written by this file's generator: zlib, and the
  row filters in numpy);
- a progressive file whose scans stop early (libjpeg-turbo would block-
  smooth it) is refused with an error that names the smoothing;
- the committed fixtures under ``tests/ingest_fixtures/formats/`` (which
  ``chip_smoke.py`` decodes on the card's machine, which has no PIL) are
  what PIL decodes: every digest is recomputed here;
- ``ops.resize`` computes what ``jax.image.resize`` computes, both
  methods, down and up, at odd sizes: float32 within 1e-4, uint8 after
  round and clip within 1 everywhere and equal at >= 99.9% of pixels;
- the engine's staged program (``KDLT_INGEST_DEVICE_RESIZE``) on a small
  Xception is held to the JAX engine's ``_ingest_fused`` within 2e-2, the
  knob parses as JAX's does, and off it leaves the engine as it was;
- the model server serves staged bytes-wire requests end to end.
"""

from __future__ import annotations

import importlib.util
import io
import json
import os
import struct
import zlib

import numpy as np
import pytest
from PIL import Image

from kubernetes_deep_learning_tpu_torch.ops import preprocess

HERE = os.path.dirname(os.path.abspath(__file__))
FORMATS = os.path.join(HERE, "ingest_fixtures", "formats")


def _load_generator():
    spec = importlib.util.spec_from_file_location(
        "kdlt_format_fixtures", os.path.join(FORMATS, "make_fixtures.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


gen = _load_generator()
SIZES = [(1, 1), (2, 3), (7, 9), (8, 8), (17, 33), (31, 47), (77, 123)]


def _encode(im: Image.Image, fmt: str, **kw) -> bytes:
    buf = io.BytesIO()
    im.save(buf, fmt, **kw)
    return buf.getvalue()


def _assert_decodes_as_pil(data: bytes) -> None:
    got, want = preprocess.decode_image(data), gen.pil_pixels(data)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


# --- progressive JPEG -------------------------------------------------------------


@pytest.mark.parametrize("quality", [50, 75, 95])
@pytest.mark.parametrize("sampling", ["4:4:4", "4:2:2", "4:2:0", "grey"])
def test_progressive_jpeg_decodes_byte_equal_to_pil(sampling, quality):
    for i, (h, w) in enumerate(SIZES):
        for smooth in (True, False):
            im = Image.fromarray(gen.pixels(h, w, seed=i, smooth=smooth))
            for restart in ({}, {"restart_marker_blocks": 2}):
                if sampling == "grey":
                    data = _encode(im.convert("L"), "JPEG", quality=quality, progressive=True,
                                   **restart)
                else:
                    sub = {"4:4:4": 0, "4:2:2": 1, "4:2:0": 2}[sampling]
                    data = _encode(im, "JPEG", quality=quality, subsampling=sub,
                                   progressive=True, **restart)
                assert b"\xff\xc2" in data  # SOF2
                _assert_decodes_as_pil(data)


def test_progressive_jpeg_with_optimized_tables_decodes_byte_equal_to_pil():
    im = Image.fromarray(gen.pixels(61, 50, seed=8))
    _assert_decodes_as_pil(_encode(im, "JPEG", quality=85, progressive=True, optimize=True))
    _assert_decodes_as_pil(_encode(im, "JPEG", quality=85, progressive=True,
                                   restart_marker_rows=1))


def _scan_starts(data: bytes) -> list[int]:
    return [i for i in range(len(data) - 1) if data[i] == 0xFF and data[i + 1] == 0xDA]


def test_progressive_jpeg_cut_before_its_refinements_is_refused_by_name():
    """PIL's progressive file cut after its first scans, EOI appended: PIL
    decodes it with libjpeg-turbo's block smoothing, which the port does not
    implement, so the port refuses it with an error naming that; a file
    whose scans all arrived decodes byte-equal."""
    data = _encode(Image.fromarray(gen.pixels(40, 48, seed=3)), "JPEG", quality=90,
                   progressive=True)
    scans = _scan_starts(data)
    assert len(scans) == 10  # libjpeg's script for YCbCr
    for cut in (1, 3, 6, 9):
        short = data[:scans[cut]] + b"\xff\xd9"
        assert gen.pil_pixels(short).shape == (40, 48, 3)  # PIL opens it
        with pytest.raises(ValueError, match="block smoothing"):
            preprocess.decode_image(short)
    _assert_decodes_as_pil(data)


# --- 4-component JPEG -------------------------------------------------------------


@pytest.mark.parametrize("progressive", [False, True], ids=["baseline", "progressive"])
@pytest.mark.parametrize("kind", ["adobe-cmyk", "ycck", "no-adobe", "adobe-transform-1"])
def test_four_component_jpeg_decodes_byte_equal_to_pil(kind, progressive):
    for i, (h, w) in enumerate(SIZES):
        im = Image.fromarray(gen.pixels(h, w, seed=20 + i, smooth=i % 2 == 0, channels=4),
                             "CMYK")
        for quality in (60, 90):
            data = _encode(im, "JPEG", quality=quality, progressive=progressive)
            if kind == "ycck":
                data = gen.set_adobe_transform(data, 2)
            elif kind == "adobe-transform-1":  # libjpeg reads it as YCCK too
                data = gen.set_adobe_transform(data, 1)
            elif kind == "no-adobe":
                data = gen.drop_adobe(data)
            assert Image.open(io.BytesIO(data)).mode == "CMYK"
            _assert_decodes_as_pil(data)


# --- 4:4:0 and 4:1:1 --------------------------------------------------------------


@pytest.mark.parametrize("progressive", [False, True], ids=["baseline", "progressive"])
@pytest.mark.parametrize("sampling", ["440", "411"])
def test_440_and_411_sampling_decode_byte_equal_to_pil(sampling, progressive):
    for i, (h, w) in enumerate(SIZES + [(35, 47), (64, 32)]):
        for quality in (50, 90):
            for smooth in (True, False):
                data = gen.cv2_jpeg(gen.pixels(h, w, seed=30 + i, smooth=smooth), sampling,
                                    quality, progressive)
                factors = {"440": b"\x12", "411": b"\x41"}[sampling]
                sof = data.index(b"\xff\xc2" if progressive else b"\xff\xc0")
                assert data[sof + 11:sof + 12] == factors  # the luma's h x v
                _assert_decodes_as_pil(data)


# --- PNG: 16-bit and Adam7 --------------------------------------------------------


@pytest.mark.parametrize("interlace", [False, True], ids=["plain", "adam7"])
@pytest.mark.parametrize("ctype", [0, 2, 4, 6])
def test_16_bit_png_decodes_as_pil_converts_it(ctype, interlace):
    for i, (h, w) in enumerate(SIZES):
        samples, _ = gen.png_image(h, w, 16, ctype, seed=60 + i)
        _assert_decodes_as_pil(gen.write_png(samples, 16, ctype, interlace))


def test_16_bit_grey_clips_and_colour_takes_the_high_byte_as_pil_does():
    grey = np.array([[[0], [1], [255], [256], [1000], [40000], [65535]]], np.uint16)
    np.testing.assert_array_equal(preprocess.decode_image(gen.write_png(grey, 16, 0, False)),
                                  np.repeat(np.minimum(grey, 255), 3, -1).astype(np.uint8))
    rgb = np.repeat(grey, 3, -1)
    np.testing.assert_array_equal(preprocess.decode_image(gen.write_png(rgb, 16, 2, False))[0, :, 0],
                                  [0, 0, 0, 1, 3, 156, 255])
    for data in (gen.write_png(grey, 16, 0, False), gen.write_png(rgb, 16, 2, False)):
        _assert_decodes_as_pil(data)


@pytest.mark.parametrize("depth, ctype", [(1, 0), (2, 0), (4, 0), (8, 0), (16, 0), (8, 2),
                                          (16, 2), (8, 4), (8, 6), (16, 6), (1, 3), (2, 3),
                                          (4, 3), (8, 3)])
def test_adam7_png_decodes_byte_equal_to_pil(depth, ctype):
    for i, (h, w) in enumerate(SIZES + [(5, 13), (9, 1), (1, 9), (16, 16)]):
        samples, palette = gen.png_image(h, w, depth, ctype, seed=70 + i)
        data = gen.write_png(samples, depth, ctype, True, palette)
        assert Image.open(io.BytesIO(data)).info.get("interlace") == 1
        _assert_decodes_as_pil(data)
        # The same image, not interlaced, decodes to the same pixels.
        flat = preprocess.decode_image(gen.write_png(samples, depth, ctype, False, palette))
        np.testing.assert_array_equal(preprocess.decode_image(data), flat)


def test_truncated_adam7_png_is_refused():
    """An IDAT that ends inside the last pass is a named truncation."""
    samples, _ = gen.png_image(17, 23, 8, 2, seed=1)
    data = gen.write_png(samples, 8, 2, True)
    at = data.index(b"IDAT") - 4
    (length,) = struct.unpack(">I", data[at:at + 4])
    raw = zlib.decompress(data[at + 8:at + 8 + length])
    cut = data[:at] + gen._chunk(b"IDAT", zlib.compress(raw[:-40])) + data[at + 12 + length:]
    with pytest.raises(ValueError, match="truncated PNG"):
        preprocess.decode_image(cut)


# --- committed fixtures -----------------------------------------------------------


def _digests() -> dict:
    with open(os.path.join(FORMATS, gen.DIGESTS)) as f:
        return json.load(f)


@pytest.mark.parametrize("name", sorted(_digests()))
def test_committed_format_fixtures_are_what_pil_and_the_port_decode(name):
    entry = _digests()[name]
    with open(os.path.join(FORMATS, name), "rb") as f:
        data = f.read()
    pil = gen.pil_pixels(data)
    assert list(pil.shape) == entry["shape"] and gen.digest(pil) == entry["sha256"]
    port = preprocess.decode_image(data)
    assert list(port.shape) == entry["shape"] and gen.digest(port) == entry["sha256"]


def test_committed_fixtures_cover_every_format_and_stay_small():
    table = _digests()
    assert {e["format"] for e in table.values()} == {
        "progressive", "cmyk", "4:4:0", "4:1:1", "png16", "adam7", "large"}
    assert set(table) == set(gen.fixtures())  # the generator names every file
    assert sum(os.path.getsize(os.path.join(FORMATS, n)) for n in table) < 300_000
    large = [e["shape"] for e in table.values() if e["format"] == "large"]
    assert len(large) >= 2 and all(min(s[:2]) >= 512 for s in large)


# --- the device-side resize ---------------------------------------------------------

RESIZE_CASES = [((512, 512), (299, 299)), ((600, 800), (299, 299)), ((720, 540), (299, 299)),
                ((37, 53), (299, 299)), ((101, 77), (64, 160)), ((8, 9), (3, 2)),
                ((1, 1), (5, 5)), ((1, 7), (3, 3)), ((299, 300), (299, 299))]


@pytest.mark.parametrize("method", ["linear", "nearest"])
@pytest.mark.parametrize("src, dst", RESIZE_CASES, ids=str)
def test_device_resize_matches_jax_image_resize(method, src, dst):
    import jax
    import jax.numpy as jnp
    import torch

    from kubernetes_deep_learning_tpu_torch.ops import resize as resize_lib

    x = np.random.default_rng(sum(src)).integers(0, 256, (2, *src, 3), dtype=np.uint8)
    want = np.asarray(jax.image.resize(jnp.asarray(x, jnp.float32), (2, *dst, 3), method=method))
    rz = resize_lib.Resize(src, dst, method)
    got = rz(torch.from_numpy(x).float()).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    assert float(np.abs(got - want).max()) <= 1e-4
    want_u8 = np.clip(np.round(want), 0, 255).astype(np.uint8)
    got_u8 = resize_lib.resize_to_uint8(rz, torch.from_numpy(x)).numpy()
    diff = np.abs(got_u8.astype(np.int16) - want_u8)
    assert diff.max() <= 1 and (diff == 0).mean() >= 0.999


def test_device_resize_refuses_what_it_is_not_built_for():
    import torch

    from kubernetes_deep_learning_tpu_torch.ops import resize as resize_lib

    with pytest.raises(ValueError, match="unknown resize method"):
        resize_lib.Resize((4, 4), (2, 2), "cubic")
    rz = resize_lib.Resize((4, 4), (2, 2), "linear")
    with pytest.raises(ValueError, match="expected"):
        rz(torch.zeros((1, 5, 4, 3)))
    with pytest.raises(ValueError, match="float32"):
        rz(torch.zeros((1, 4, 4, 3), dtype=torch.float64))
    assert resize_lib.method_for("nearest") == "nearest"
    assert resize_lib.method_for("bilinear") == "linear"


# --- the knob and the staged forward -------------------------------------------------


def test_ingest_device_resize_parses_as_jax_does(monkeypatch):
    from kubernetes_deep_learning_tpu.runtime import engine as jax_engine
    from kubernetes_deep_learning_tpu_torch.runtime import engine

    assert engine.INGEST_DEVICE_RESIZE_ENV == jax_engine.INGEST_DEVICE_RESIZE_ENV
    monkeypatch.delenv(engine.INGEST_DEVICE_RESIZE_ENV, raising=False)
    assert engine.ingest_device_resize() is None  # off by default: host resize rules
    for raw in ("", "0", "off", "false", "no", "512x384", " 96X96 "):
        monkeypatch.setenv(engine.INGEST_DEVICE_RESIZE_ENV, raw)
        assert engine.ingest_device_resize() == jax_engine.ingest_device_resize()
    monkeypatch.setenv(engine.INGEST_DEVICE_RESIZE_ENV, "512x384")
    assert engine.ingest_device_resize() == (512, 384)
    assert engine.ingest_device_resize("96x96") == (96, 96)  # explicit beats env
    assert engine.ingest_device_resize("off") is None
    for bad in ("512", "0x64", "-1x64", "axb"):
        with pytest.raises(ValueError):
            engine.ingest_device_resize(bad)
        with pytest.raises(ValueError):
            jax_engine.ingest_device_resize(bad)


_SPEC_KW = dict(family="xception", input_shape=(96, 96, 3), labels=("dress", "hat", "pants",
                                                                      "shirt"),
                preprocessing="tf")


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    """Float32 Xception artifacts (96 px) exported by the JAX exporter, one
    per resize filter: name -> (JAX spec, root)."""
    from kubernetes_deep_learning_tpu.export import export_model
    from kubernetes_deep_learning_tpu.models import init_variables as jax_init_variables
    from kubernetes_deep_learning_tpu.modelspec import ModelSpec as JaxModelSpec
    from kubernetes_deep_learning_tpu.modelspec import register_spec

    out = {}
    root = tmp_path_factory.mktemp("models")
    for i, filt in enumerate(("nearest", "bilinear")):
        spec = register_spec(JaxModelSpec(name=f"torch-staged-{filt}", resize_filter=filt,
                                          **_SPEC_KW))
        export_model(spec, jax_init_variables(spec, seed=7 + i), str(root), dtype=np.float32)
        out[filt] = (spec, str(root))
    return out


def _port_engine(exported, filt, **kw):
    from kubernetes_deep_learning_tpu_torch.export import artifact as art
    from kubernetes_deep_learning_tpu_torch.runtime import InferenceEngine

    spec, root = exported[filt]
    return InferenceEngine(art.load_artifact(art.version_dir(root, spec.name, 1)),
                           buckets=(1, 4), device="cpu", **kw)


@pytest.mark.parametrize("staging", ["150x131", "61x83"])
@pytest.mark.parametrize("filt", ["nearest", "bilinear"])
def test_staged_forward_matches_the_jax_engines_ingest_fused(exported, monkeypatch, filt,
                                                             staging):
    from kubernetes_deep_learning_tpu.export import artifact as jax_art
    from kubernetes_deep_learning_tpu.runtime.engine import InferenceEngine as JaxEngine

    monkeypatch.setenv("KDLT_INGEST_DEVICE_RESIZE", staging)
    spec, root = exported[filt]
    jax_eng = JaxEngine(jax_art.load_artifact(jax_art.version_dir(root, spec.name, 1)),
                        buckets=(1, 4))
    port = _port_engine(exported, filt)
    h, w = map(int, staging.split("x"))
    assert port.ingest_source_shape == tuple(jax_eng.ingest_source_shape) == (h, w, 3)
    imgs = np.stack([gen.photo(h, w, seed=s) for s in range(3)])
    handle, n = port.predict_ingest_async(imgs)
    got = np.asarray(handle)[:n]
    want = np.asarray(jax_eng.predict_ingest_async(imgs)[0])[:3]
    assert got.shape == want.shape == (3, 4)
    rel = float(np.abs(got - want).max() / (np.abs(want).max() + 1e-9))
    assert rel < 2e-2, rel
    # The staged program is the resize then the plain forward: the same
    # logits as the plain forward on the device-resized pixels.
    import torch

    from kubernetes_deep_learning_tpu_torch.ops import resize as resize_lib

    rz = resize_lib.Resize((h, w), (96, 96), resize_lib.method_for(filt))
    resized = resize_lib.resize_to_uint8(rz, torch.from_numpy(imgs)).numpy()
    np.testing.assert_allclose(got, np.asarray(port.predict_async(resized)[0])[:3], rtol=1e-6,
                               atol=1e-6)
    with pytest.raises(ValueError, match="expected"):
        port.predict_ingest_async(np.zeros((1, 96, 96, 3), np.uint8))
    with pytest.raises(ValueError, match="uint8"):
        port.predict_ingest_async(imgs.astype(np.float32))


def test_knob_off_or_equal_to_the_input_leaves_the_engine_as_it_was(exported, monkeypatch):
    monkeypatch.delenv("KDLT_INGEST_DEVICE_RESIZE", raising=False)
    imgs = np.random.default_rng(0).integers(0, 256, (2, 96, 96, 3), dtype=np.uint8)
    for eng in (_port_engine(exported, "nearest"),
                _port_engine(exported, "nearest", ingest_resize="96x96")):
        assert eng.ingest_source_shape == (96, 96, 3)
        assert eng._resize is None and eng._staged_slots is None and not eng._staged_graphs
        np.testing.assert_array_equal(np.asarray(eng.predict_ingest_async(imgs)[0]),
                                      np.asarray(eng.predict_async(imgs)[0]))
    with pytest.raises(ValueError, match="HxW"):
        _port_engine(exported, "nearest", ingest_resize="512")


# --- the server ---------------------------------------------------------------------


def test_server_serves_staged_bytes_wire_requests_end_to_end(exported, monkeypatch):
    from kubernetes_deep_learning_tpu_torch.serving import cache as cache_lib
    from kubernetes_deep_learning_tpu_torch.serving import protocol
    from kubernetes_deep_learning_tpu_torch.serving.model_server import ModelServer

    spec, root = exported["bilinear"]
    monkeypatch.setenv("KDLT_INGEST_DEVICE_RESIZE", "150x131")
    server = ModelServer(root, port=0, buckets=(1, 2), device="cpu")
    try:
        server.warmup()
        engine = server.models[spec.name].engine
        assert engine.ingest_source_shape == (150, 131, 3)
        with open(os.path.join(FORMATS, "prog_q75_420_123x77.jpg"), "rb") as f:
            prog = f.read()
        with open(os.path.join(FORMATS, "large_512x512.jpg"), "rb") as f:
            large = f.read()
        blobs = [prog, large, _encode(Image.fromarray(gen.pixels(40, 30, 2)), "PNG")]
        body = protocol.encode_bytes_predict_request(blobs)
        path = f"/v1/models/{spec.name}:predict"
        status, out, _ctype, headers = server.handle_predict(path, body,
                                                              protocol.BYTES_CONTENT_TYPE)
        assert status == 200, out
        scores = json.loads(out)["predictions"]
        got = np.array([[row[label] for label in spec.labels] for row in scores], np.float32)
        # What the engine's staged program gives the host decode at the
        # staging size (3 images: a 2-bucket chunk and a 1-bucket chunk).
        staged = np.stack([preprocess.preprocess_bytes(b, (150, 131), filter="bilinear")
                           for b in blobs])
        want = np.concatenate([np.asarray(engine.predict_ingest_async(staged[:2])[0])[:2],
                               np.asarray(engine.predict_ingest_async(staged[2:])[0])[:1]])
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        key = cache_lib.decoded_key(prog, cache_lib.decoded_params((150, 131, 3), "bilinear"))
        assert server._decoded_cache.get(key) is not None  # cached at the staging shape
        assert headers.get(protocol.ARTIFACT_HASH_HEADER) == engine.artifact_hash
        # The tensor wire still takes the model's input shape.
        tensor = protocol.encode_predict_request(staged[:1, :96, :96])
        status, _out, _ctype, _h = server.handle_predict(path, tensor, protocol.MSGPACK_CONTENT_TYPE)
        assert status == 200
    finally:
        server.shutdown()
