"""The port's ingest path on the CPU: decode, resize, the bytes wire, the stub.

- ``ops.preprocess.decode_image`` (no PIL: the C++ JPEG decoder of
  ``native/imagedec.cc``, zlib and the same library's PNG filters) is
  byte-equal to ``PIL.Image.open(...).convert("RGB")`` on images this file
  writes with PIL from seeded numpy: baseline JPEG at 4:4:4, 4:2:2, 4:2:0 and
  greyscale, qualities 50/75/95, odd sizes down to 1x1, restart intervals,
  optimized Huffman tables; PNG in every 8-bit colour type and the sub-byte
  palette and greyscale depths.  What it does not decode raises a
  ValueError naming what is unsupported (``tests/test_torch_ingest_formats.py``
  covers progressive and 4-component JPEG, 4:4:0 and 4:1:1, 16-bit and
  Adam7 PNG);
- ``resize_uint8`` is byte-equal to the JAX package's (and PIL's), both
  filters, up and down;
- the bytes wire's bodies are byte-equal to the JAX protocol's, and its
  decode errors are the same;
- ``runtime.stub.stub_logits`` is equal to JAX's;
- the committed fixtures under ``tests/ingest_fixtures/`` (which the card's
  tests compare against, having no PIL there) are what PIL decodes, and
  one of them resized by PIL up and down with each filter.

Regenerate the fixtures with ``python tests/test_torch_ingest.py``.
"""

from __future__ import annotations

import io
import json
import os
import struct
import sys
import threading
import time
import zlib

import numpy as np
import pytest
from PIL import Image

from kubernetes_deep_learning_tpu.ops import preprocess as jax_preprocess
from kubernetes_deep_learning_tpu.runtime.stub import stub_logits as jax_stub_logits
from kubernetes_deep_learning_tpu.serving import protocol as jax_protocol
from kubernetes_deep_learning_tpu_torch.ops import preprocess
from kubernetes_deep_learning_tpu_torch.runtime.stub import StubEngine, stub_logits
from kubernetes_deep_learning_tpu_torch.serving import protocol
from torch_threads import one_torch_thread  # noqa: F401

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "ingest_fixtures")
SIZES = [(1, 1), (2, 3), (3, 3), (4, 5), (7, 9), (8, 8), (17, 33), (31, 47), (123, 77)]


def _pixels(h: int, w: int, seed: int = 0, smooth: bool = True) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if not smooth:
        return rng.integers(0, 256, size=(h, w, 3), dtype=np.uint8)
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([x * 255 // max(w - 1, 1), y * 255 // max(h - 1, 1), (x + y) * 7 % 256], -1)
    return np.clip(base + rng.integers(-30, 30, size=(h, w, 3)), 0, 255).astype(np.uint8)


def _encode(im: Image.Image, fmt: str, **kw) -> bytes:
    buf = io.BytesIO()
    im.save(buf, fmt, **kw)
    return buf.getvalue()


def _pil_rgb(data: bytes) -> np.ndarray:
    with Image.open(io.BytesIO(data)) as im:
        return np.asarray(im.convert("RGB"))


def _assert_decodes_as_pil(data: bytes) -> None:
    got, want = preprocess.decode_image(data), _pil_rgb(data)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


# --- JPEG -----------------------------------------------------------------------


@pytest.mark.parametrize("quality", [50, 75, 95])
@pytest.mark.parametrize("sampling", ["4:4:4", "4:2:2", "4:2:0", "grey"])
def test_baseline_jpeg_decodes_byte_equal_to_pil(sampling, quality):
    for i, (h, w) in enumerate(SIZES):
        for smooth in (True, False):
            im = Image.fromarray(_pixels(h, w, seed=i, smooth=smooth))
            if sampling == "grey":
                data = _encode(im.convert("L"), "JPEG", quality=quality)
            else:
                sub = {"4:4:4": 0, "4:2:2": 1, "4:2:0": 2}[sampling]
                data = _encode(im, "JPEG", quality=quality, subsampling=sub)
            _assert_decodes_as_pil(data)


@pytest.mark.parametrize("restart", [{"restart_marker_blocks": 1},
                                     {"restart_marker_blocks": 3},
                                     {"restart_marker_rows": 2}])
def test_jpeg_restart_intervals_decode_byte_equal_to_pil(restart):
    for sub in (0, 1, 2):
        data = _encode(Image.fromarray(_pixels(41, 59, seed=sub)), "JPEG", quality=85,
                       subsampling=sub, **restart)
        assert b"\xff\xdd" in data  # a DRI segment
        _assert_decodes_as_pil(data)


def test_jpeg_with_optimized_huffman_tables_and_exif_decodes_byte_equal_to_pil():
    im = Image.fromarray(_pixels(50, 61, seed=3))
    exif = Image.Exif()
    exif[0x0112] = 6  # an orientation tag: PIL's convert() does not apply it
    _assert_decodes_as_pil(_encode(im, "JPEG", optimize=True, quality=90))
    _assert_decodes_as_pil(_encode(im, "JPEG", exif=exif.tobytes(), quality=80))


# --- PNG ------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["RGB", "RGBA", "L", "LA", "P", "1"])
def test_png_every_colour_type_decodes_byte_equal_to_pil(mode):
    for i, (h, w) in enumerate(SIZES):
        a = _pixels(h, w, seed=i)
        if mode == "RGBA":
            alpha = np.random.default_rng(i).integers(0, 256, (h, w), dtype=np.uint8)
            im = Image.fromarray(np.dstack([a, alpha]))
        elif mode == "P":
            im = Image.fromarray(a).quantize(colors=37)
        else:
            im = Image.fromarray(a).convert(mode)
        for optimize in (False, True):  # optimize picks the row filters adaptively
            _assert_decodes_as_pil(_encode(im, "PNG", optimize=optimize))


@pytest.mark.parametrize("bits", [1, 2, 4])
def test_png_sub_byte_palettes_decode_byte_equal_to_pil(bits):
    im = Image.fromarray(_pixels(13, 11, seed=bits)).quantize(colors=2 ** bits)
    _assert_decodes_as_pil(_encode(im, "PNG", bits=bits))


def test_png_palette_with_transparency_decodes_byte_equal_to_pil():
    im = Image.fromarray(_pixels(9, 14, seed=5)).quantize(colors=16)
    _assert_decodes_as_pil(_encode(im, "PNG", transparency=3))


# --- refusals -------------------------------------------------------------------


def _patched_sof(offset: int, value: int, *more: int) -> bytes:
    """A baseline PIL JPEG with bytes of its SOF0 segment replaced from
    ``offset`` on (1: the marker's kind; 4: the sample precision; 11, 14,
    17: the components' sampling factors), every third byte from the
    second value on (``more``)."""
    data = bytearray(_encode(Image.fromarray(_pixels(16, 16)), "JPEG", subsampling=2))
    at = data.index(b"\xff\xc0") + offset
    for i, v in enumerate((value, *more)):
        data[at + 3 * i] = v
    return bytes(data)


# What PIL opens and the port still refuses, each a byte patch of a
# baseline file (ROADMAP A13d).
@pytest.mark.parametrize("make, match", [
    (lambda: _patched_sof(1, 0xC9), "arithmetic"),
    (lambda: _patched_sof(1, 0xC3), "lossless"),
    (lambda: _patched_sof(4, 12), "12-bit"),
    (lambda: _patched_sof(1, 0xC5), "hierarchical"),
    (lambda: _patched_sof(11, 0x31, 0x21), "fractional sampling"),
    (lambda: _encode(Image.fromarray(_pixels(8, 8)), "GIF"), "only JPEG and PNG"),
    (lambda: _encode(Image.fromarray(_pixels(8, 8)), "JPEG")[:300], "truncated"),
    (lambda: _encode(Image.fromarray(_pixels(8, 8)), "PNG")[:-20], "truncated"),
    (lambda: b"not an image", "only JPEG and PNG"),
])
def test_unsupported_or_corrupt_images_raise_a_named_value_error(make, match):
    with pytest.raises(ValueError, match=match):
        preprocess.decode_image(make())


def _jpeg_sized(h: int, w: int) -> bytes:
    """A small PIL JPEG whose frame header (SOF0) claims h x w."""
    data = bytearray(_encode(Image.fromarray(_pixels(16, 16)), "JPEG"))
    sof = data.index(b"\xff\xc0")
    data[sof + 5:sof + 9] = struct.pack(">HH", h, w)
    return bytes(data)


def _png_sized(h: int, w: int) -> bytes:
    """A small PIL PNG whose IHDR claims h x w (its CRC fixed)."""
    data = bytearray(_encode(Image.fromarray(_pixels(8, 8)), "PNG"))
    data[16:24] = struct.pack(">II", w, h)
    data[29:33] = struct.pack(">I", zlib.crc32(bytes(data[12:29])))
    return bytes(data)


def _png_chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))


def _png_with_idat(w: int, h: int, idat: bytes) -> bytes:
    return (b"\x89PNG\r\n\x1a\n"
            + _png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + _png_chunk(b"IDAT", idat) + _png_chunk(b"IEND", b""))


def _png_rows(w: int, h: int) -> bytes:
    return b"".join(b"\x00" + bytes((3 * w * y + i) % 256 for i in range(3 * w))
                    for y in range(h))


def _png_inflating_past_its_rows(extra: int) -> bytes:
    """A 4x4 RGB PNG whose IDAT inflates to its rows and ``extra`` zeros."""
    z = zlib.compressobj(9)
    parts = [z.compress(_png_rows(4, 4))]
    chunk = bytes(1 << 20)
    for _ in range(extra >> 20):
        parts.append(z.compress(chunk))
    parts.append(z.flush())
    return _png_with_idat(4, 4, b"".join(parts))


# PIL refuses more than 2 * MAX_IMAGE_PIXELS = 178,956,970 pixels: 13377^2 is
# under it, 13377 x 13378 over.
_OVER_LIMIT = {
    "jpeg-65535": lambda: _jpeg_sized(65535, 65535),
    "jpeg-13377x13378": lambda: _jpeg_sized(13377, 13378),
    "png-65535": lambda: _png_sized(65535, 65535),
    "png-13378x13377": lambda: _png_sized(13378, 13377),
}


@pytest.mark.parametrize("name", sorted(_OVER_LIMIT))
def test_images_over_pils_pixel_limit_are_refused_as_pil_refuses_them(name):
    data = _OVER_LIMIT[name]()
    assert preprocess.MAX_IMAGE_PIXELS == 2 * Image.MAX_IMAGE_PIXELS
    with pytest.raises(Image.DecompressionBombError):
        Image.open(io.BytesIO(data))
    with pytest.raises(ValueError, match="image too large"):
        preprocess.decode_image(data)


def test_png_zlib_data_past_its_rows_or_unterminated_decodes_as_pil_does():
    """PIL inflates only what the rows hold: data after them, or a stream
    without its end, decodes to the same pixels."""
    rows = _png_rows(5, 3)
    for idat in (zlib.compress(rows + bytes(1000)), zlib.compress(rows)[:-4]):
        _assert_decodes_as_pil(_png_with_idat(5, 3, idat))
    with pytest.raises(ValueError, match="truncated PNG"):
        preprocess.decode_image(_png_with_idat(5, 3, zlib.compress(rows[:-1])))


_BOUNDED_DECODE = r"""
import ctypes, json, resource, sys
from kubernetes_deep_learning_tpu_torch.ops import _native, preprocess

lib = _native.load_hostops()
with open("/proc/self/status") as f:
    vm = next(int(line.split()[1]) * 1024 for line in f if line.startswith("VmSize:"))
limit = vm + (256 << 20)  # far below one plane of a bomb, or one inflated IDAT
resource.setrlimit(resource.RLIMIT_AS, (limit, limit))
out = {}
for name, path in json.loads(sys.argv[1]).items():
    with open(path, "rb") as f:
        data = f.read()
    try:
        if name.startswith("header-"):  # the frame header alone
            h, w, err = ctypes.c_int(), ctypes.c_int(), ctypes.create_string_buffer(256)
            rc = lib.kdlt_jpeg_header(data, len(data), ctypes.byref(h), ctypes.byref(w), err, 256)
            out[name] = [h.value, w.value] if rc == 0 else err.value.decode()
        else:
            out[name] = preprocess.decode_image(data).tolist()
    except Exception as e:
        out[name] = f"{type(e).__name__}: {e}"
print(json.dumps(out))
"""


def test_bombs_are_refused_or_decoded_within_bounded_memory(tmp_path):
    """In a process allowed 256 MiB more address space than it holds: the
    over-limit images are refused by name (a 13 GB zero-filled plane, or a
    1 GB inflated IDAT, would fail to allocate instead), the JPEG header of
    a 13377^2 frame (three 179 MB planes) is read without allocating them,
    and a PNG whose IDAT inflates to 512 MiB past its rows decodes as PIL
    decodes it."""
    import subprocess

    cases = {k: make() for k, make in _OVER_LIMIT.items()}
    cases["header-13377x13377"] = _jpeg_sized(13377, 13377)
    cases["header-13377x13378"] = _jpeg_sized(13377, 13378)
    cases["png-inflating-512MiB-past-its-rows"] = _png_inflating_past_its_rows(512 << 20)
    paths = {}
    for name, data in cases.items():
        paths[name] = str(tmp_path / name)
        with open(paths[name], "wb") as f:
            f.write(data)
    preprocess.decode_image(cases["png-inflating-512MiB-past-its-rows"])  # builds the library
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {**os.environ, "PYTHONPATH": root, "OPENBLAS_NUM_THREADS": "1",
           "OMP_NUM_THREADS": "1"}
    done = subprocess.run([sys.executable, "-c", _BOUNDED_DECODE, json.dumps(paths)],
                          capture_output=True, text=True, timeout=120, env=env, cwd=root)
    assert done.returncode == 0, done.stderr[-3000:]
    got = json.loads(done.stdout.strip().splitlines()[-1])
    for name in _OVER_LIMIT:
        assert got[name].startswith("ValueError: image too large"), (name, got[name])
    assert got["header-13377x13377"] == [13377, 13377]
    assert got["header-13377x13378"].startswith("image too large"), got["header-13377x13378"]
    want = _pil_rgb(cases["png-inflating-512MiB-past-its-rows"])
    np.testing.assert_array_equal(np.array(got["png-inflating-512MiB-past-its-rows"],
                                           np.uint8), want)


def test_batch_decoder_names_the_failing_image_and_decodes_the_rest():
    good = _encode(Image.fromarray(_pixels(30, 20)), "PNG")
    dec = preprocess.BatchDecoder(2)
    try:
        out = dec.decode_batch([good, good], (8, 8), filter="nearest")
        assert out.shape == (2, 8, 8, 3)
        with pytest.raises(ValueError, match="image 1: unsupported JPEG: arithmetic"):
            dec.decode_batch([good, _patched_sof(1, 0xC9)], (8, 8))
    finally:
        dec.close()


def test_decode_releases_the_interpreter_lock():
    """While a thread decodes a large JPEG (one native call of ~0.1 s), this
    thread keeps running: the call releases the interpreter lock (what lets
    the decode pool scale).  Held, it would stall this loop for the whole
    call."""
    data = _encode(Image.fromarray(_pixels(1800, 2400, seed=9)), "JPEG", quality=90)
    t0 = time.perf_counter()
    preprocess.decode_image(data)  # also builds the library
    t0 = time.perf_counter()
    preprocess.decode_image(data)
    call = time.perf_counter() - t0
    worker = threading.Thread(target=preprocess.decode_image, args=(data,))
    gaps = []
    last = time.perf_counter()
    worker.start()  # a held lock would stall here or in the loop: either gap counts
    while worker.is_alive():
        now = time.perf_counter()
        gaps.append(now - last)
        last = now
    gaps.append(time.perf_counter() - last)  # a stall ends in is_alive(): count it too
    worker.join()
    assert len(gaps) > 100 and max(gaps) < 0.5 * call, (call, max(gaps), len(gaps))


# --- resize ---------------------------------------------------------------------


@pytest.mark.parametrize("filter", ["nearest", "bilinear"])
@pytest.mark.parametrize("src, dst", [((120, 80), (299, 299)), ((640, 480), (299, 299)),
                                      ((7, 9), (3, 2)), ((1, 1), (5, 5)), ((96, 96), (96, 96))])
def test_resize_is_byte_equal_to_jax_and_pil(filter, src, dst):
    img = np.random.default_rng(sum(src)).integers(0, 256, (*src, 3), dtype=np.uint8)
    got = preprocess.resize_uint8(img, dst, filter)
    np.testing.assert_array_equal(got, jax_preprocess.resize_uint8(img, dst, filter))
    pil = Image.fromarray(img).resize((dst[1], dst[0]),
                                      Image.NEAREST if filter == "nearest" else Image.BILINEAR)
    np.testing.assert_array_equal(got, np.asarray(pil))
    with pytest.raises(ValueError, match="unknown resize filter"):
        preprocess.resize_uint8(img, dst, "bicubic")


def test_preprocess_bytes_matches_jax():
    data = _encode(Image.fromarray(_pixels(123, 77, seed=4)), "JPEG", quality=90, subsampling=2)
    for f in ("nearest", "bilinear"):
        np.testing.assert_array_equal(
            preprocess.preprocess_bytes(data, (299, 299), filter=f),
            jax_preprocess.preprocess_bytes(data, (299, 299), filter=f))


def test_fetch_and_decode_pool_knobs_match_jax(monkeypatch):
    assert preprocess.MAX_FETCH_BYTES == jax_preprocess.MAX_FETCH_BYTES
    assert preprocess.FETCH_TIMEOUT_S == jax_preprocess.FETCH_TIMEOUT_S
    assert preprocess.USER_AGENT == jax_preprocess.USER_AGENT
    for raw in ("", "3", "0", "junk"):
        monkeypatch.setenv("KDLT_DECODE_POOL", raw)
        assert preprocess.resolve_decode_pool() == jax_preprocess.resolve_decode_pool()
    assert preprocess.resolve_decode_pool(5) == 5


# --- the bytes wire ---------------------------------------------------------------


def test_bytes_wire_bodies_are_byte_equal_to_jax():
    blobs = [_encode(Image.fromarray(_pixels(9, 9)), "PNG"), b"\xff\xd8\xff" + b"x" * 70000,
             b"y" * 300]
    for n in (1, 3):
        body = protocol.encode_bytes_predict_request(blobs[:n])
        assert body == jax_protocol.encode_bytes_predict_request(blobs[:n])
        assert protocol.decode_bytes_predict_request(body) == blobs[:n]
    for name in ("BYTES_CONTENT_TYPE", "INGEST_HEADER", "INGEST_BYTES_CAP", "INGEST_CAPS",
                 "INGEST_ENV", "MAX_ENCODED_IMAGE_BYTES", "MODEL_HEADER", "CACHE_BUST_HEADER",
                 "CACHE_STATUS_HEADER", "EVENT_STREAM_CONTENT_TYPE"):
        assert getattr(protocol, name) == getattr(jax_protocol, name), name
    for raw in (None, "", "bytes", " Bytes , tensor", "tensor"):
        assert protocol.parse_ingest_caps(raw) == jax_protocol.parse_ingest_caps(raw)
    for data in (blobs[0], blobs[1], b"GIF89a", b""):
        assert protocol.sniff_image_format(data) == jax_protocol.sniff_image_format(data)


@pytest.mark.parametrize("body", [
    b"\xc1", jax_protocol.encode_predict_request(np.zeros((1, 2, 2, 3), np.uint8)),
    jax_protocol.encode_bytes_predict_request([]),
    jax_protocol.encode_bytes_predict_request([b""]),
    jax_protocol.encode_bytes_predict_request([b"a"] * 3),
])
def test_bytes_wire_decode_errors_match_jax(body):
    with pytest.raises(ValueError) as jax_err:
        jax_protocol.decode_bytes_predict_request(body, max_images=2)
    with pytest.raises(ValueError) as port_err:
        protocol.decode_bytes_predict_request(body, max_images=2)
    if not str(jax_err.value).startswith("invalid msgpack"):
        assert str(port_err.value) == str(jax_err.value)


def test_ingest_switch_matches_jax(monkeypatch):
    for raw in ("", "0", "off", "1", "yes"):
        monkeypatch.setenv("KDLT_INGEST", raw)
        assert protocol.ingest_enabled() == jax_protocol.ingest_enabled()
    assert protocol.ingest_enabled(False) is False


# --- the stub engine --------------------------------------------------------------


def test_stub_logits_equal_jax_and_the_async_stub_serializes():
    imgs = np.random.default_rng(2).integers(0, 256, (5, 32, 32, 3), dtype=np.uint8)
    want = jax_stub_logits(imgs, 7)
    got = stub_logits(imgs, 7)
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()

    class _Art:
        spec = type("S", (), {"num_classes": 7})()

    eng = StubEngine(_Art(), buckets=(1, 4), async_device=True, device_ms_per_batch=20)
    try:
        t0 = time.perf_counter()
        handles = [eng.predict_async(imgs[i:i + 1]) for i in range(3)]
        assert time.perf_counter() - t0 < 0.02  # dispatch never waits for the device
        rows = [np.asarray(h)[:n] for h, n in handles]
        assert time.perf_counter() - t0 >= 0.06  # one batch at a time
        np.testing.assert_array_equal(np.concatenate(rows), want[:3])
        eng.record_completed(3, 0.1, None)
        assert eng.registry.render().count("kdlt_engine_images_total") >= 1
    finally:
        eng.close()
    plain = StubEngine(_Art(), buckets=(1, 2), device="cuda", pipeline_depth=2)
    assert not hasattr(plain, "predict_async") and plain.bucket_for(2) == 2
    np.testing.assert_array_equal(plain.predict(imgs), want)


# --- committed fixtures -----------------------------------------------------------

# name -> (bytes maker); the card's tests decode these and compare with the
# .npy of what PIL decoded when they were written.
def _fixture_images() -> dict[str, bytes]:
    return {
        "q90_444_37x29.jpg": _encode(Image.fromarray(_pixels(29, 37, seed=11)), "JPEG",
                                     quality=90, subsampling=0),
        "q75_422_64x47.jpg": _encode(Image.fromarray(_pixels(47, 64, seed=12)), "JPEG",
                                     quality=75, subsampling=1),
        "q50_420_101x77_rst.jpg": _encode(Image.fromarray(_pixels(77, 101, seed=13)), "JPEG",
                                          quality=50, subsampling=2, restart_marker_blocks=2),
        "q95_420_299x299.jpg": _encode(Image.fromarray(_pixels(299, 299, seed=14)), "JPEG",
                                       quality=95, subsampling=2),
        "q80_grey_33x21.jpg": _encode(Image.fromarray(_pixels(21, 33, seed=15)).convert("L"),
                                      "JPEG", quality=80),
        "palette_23x17.png": _encode(Image.fromarray(_pixels(17, 23, seed=16)).quantize(
            colors=29), "PNG"),
        "rgba_19x25.png": _encode(Image.fromarray(np.dstack([
            _pixels(25, 19, seed=17),
            np.random.default_rng(17).integers(0, 256, (25, 19), dtype=np.uint8)])), "PNG",
            optimize=True),
    }


# One fixture's pixels resized by PIL, up and down, with each filter: the
# card's tests hold the port's resize to them.
RESIZE_FIXTURE = "q75_422_64x47.jpg"
RESIZE_SIZES = ((61, 83), (23, 31))


def _resize_name(filter: str, size) -> str:
    return f"{RESIZE_FIXTURE}.{filter}-{size[0]}x{size[1]}.npy"


def _pil_resize(pixels: np.ndarray, filter: str, size) -> np.ndarray:
    pil = {"nearest": Image.NEAREST, "bilinear": Image.BILINEAR}[filter]
    return np.asarray(Image.fromarray(pixels).resize((size[1], size[0]), pil))


def write_fixtures(directory: str = FIXTURES) -> None:
    os.makedirs(directory, exist_ok=True)
    for name, data in _fixture_images().items():
        with open(os.path.join(directory, name), "wb") as f:
            f.write(data)
        np.save(os.path.join(directory, name + ".npy"), _pil_rgb(data))
    pixels = np.load(os.path.join(directory, RESIZE_FIXTURE + ".npy"))
    for filter in ("nearest", "bilinear"):
        for size in RESIZE_SIZES:
            np.save(os.path.join(directory, _resize_name(filter, size)),
                    _pil_resize(pixels, filter, size))


@pytest.mark.parametrize("name", sorted(_fixture_images()))
def test_committed_fixtures_are_what_pil_and_the_port_decode(name):
    with open(os.path.join(FIXTURES, name), "rb") as f:
        data = f.read()
    want = np.load(os.path.join(FIXTURES, name + ".npy"))
    np.testing.assert_array_equal(_pil_rgb(data), want)
    np.testing.assert_array_equal(preprocess.decode_image(data), want)


@pytest.mark.parametrize("filter", ["nearest", "bilinear"])
@pytest.mark.parametrize("size", RESIZE_SIZES, ids=str)
def test_committed_resize_fixtures_are_what_pil_and_the_port_resize(filter, size):
    pixels = np.load(os.path.join(FIXTURES, RESIZE_FIXTURE + ".npy"))
    want = np.load(os.path.join(FIXTURES, _resize_name(filter, size)))
    np.testing.assert_array_equal(_pil_resize(pixels, filter, size), want)
    np.testing.assert_array_equal(preprocess.resize_uint8(pixels, size, filter), want)


if __name__ == "__main__":
    write_fixtures(sys.argv[1] if len(sys.argv) > 1 else FIXTURES)
