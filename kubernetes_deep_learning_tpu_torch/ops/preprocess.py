"""Image preprocessing: host-side fetch, decode and resize, device-side
normalization.

The host half is the port's copy of the JAX package's ``ops/preprocess.py``
without PIL, which the card's machine does not have:

- ``decode_image``: JPEG or PNG bytes -> RGB uint8 HWC, byte-equal to
  ``PIL.Image.open(...).convert("RGB")``.  JPEG (baseline, extended and
  progressive; 1, 3 or 4 components, CMYK and YCCK among them; any integral
  sampling ratio) goes through the C++ decoder of ``native/imagedec.cc``,
  which follows libjpeg-turbo's defaults (PIL's); PNG (every colour type
  and bit depth, 16-bit and Adam7-interlaced included) is inflated with
  ``zlib`` and unfiltered in the same library, and its colour types are
  converted as PIL converts them.  What PIL opens and this does not --
  arithmetic-coded, lossless, hierarchical and 12-bit JPEG, a progressive
  JPEG that libjpeg-turbo would block-smooth (scans that stop before the
  low-frequency coefficients are complete), GIF, BMP, WebP, TIFF and every
  other format -- raises a ValueError naming what is unsupported, which
  both tiers answer with a 400; it is never handed to another decoder.
  So does an image of more than ``MAX_IMAGE_PIXELS`` pixels (PIL's
  decompression-bomb bound), before anything of its size is allocated;
- ``resize_uint8``: PIL-exact nearest and bilinear (``native/hostops.cc``);
- ``fetch_image_bytes``, ``preprocess_bytes``, ``resolve_decode_pool`` and
  ``BatchDecoder`` (the model tier's decode stage), as in JAX.

The device half, ``normalize``, runs the elementwise scale/shift on the
device, in float32, with the JAX package's constants (bit-equal to its
numpy ``normalize``).
"""

from __future__ import annotations

import functools
import os
import struct
import urllib.request
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from kubernetes_deep_learning_tpu_torch.ops import _native

#   tf    : x / 127.5 - 1            (Keras "tf" mode; Xception)
#   caffe : BGR, subtract ImageNet channel means (Keras "caffe" mode; ResNet50)
#   torch : x / 255, ImageNet mean/std (EfficientNet, torchvision convention)
_CAFFE_MEAN_BGR = (103.939, 116.779, 123.68)
_TORCH_MEAN = (0.485, 0.456, 0.406)
_TORCH_STD = (0.229, 0.224, 0.225)

USER_AGENT = "kdlt-gateway/0.1"
FETCH_TIMEOUT_S = 10.0
MAX_FETCH_BYTES = 32 * 1024 * 1024  # reject pathological or streaming URLs

# The model tier's decode pool: threads running decode + resize with the
# interpreter lock released, sized to the host's cores but capped, so a
# burst of bytes-wire requests cannot take every core from dispatch.
DECODE_POOL_ENV = "KDLT_DECODE_POOL"
DEFAULT_DECODE_POOL = max(2, min(8, os.cpu_count() or 4))


def resolve_decode_pool(explicit: int | None = None) -> int:
    """Explicit arg > $KDLT_DECODE_POOL > core-scaled default; always >= 1."""
    if explicit is not None:
        return max(1, int(explicit))
    raw = os.environ.get(DECODE_POOL_ENV, "")
    try:
        return max(1, int(raw)) if raw.strip() else DEFAULT_DECODE_POOL
    except ValueError:
        return DEFAULT_DECODE_POOL


def fetch_image_bytes(url: str, timeout: float = FETCH_TIMEOUT_S,
                      max_bytes: int = MAX_FETCH_BYTES) -> bytes:
    """Download raw image bytes (the reference gateway's ``.from_url`` step).
    The read is bounded: a URL pointing at an endless stream must not
    exhaust the gateway's memory (the timeout bounds only inactivity)."""
    req = urllib.request.Request(url, headers={"User-Agent": USER_AGENT})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        data = resp.read(max_bytes + 1)
    if len(data) > max_bytes:
        raise ValueError(f"image at {url!r} exceeds {max_bytes} byte limit")
    return data


# PIL refuses an image of more than 2 * Image.MAX_IMAGE_PIXELS pixels
# (DecompressionBombError) before decoding it; native/imagedec.cc holds
# JPEG to the same bound.
MAX_IMAGE_PIXELS = 2 * 89_478_485

_PNG_MAGIC = b"\x89PNG\r\n\x1a\n"
_JPEG_MAGIC = b"\xff\xd8\xff"
# PNG colour type -> (samples per pixel, name)
_PNG_TYPES = {0: (1, "greyscale"), 2: (3, "RGB"), 3: (1, "palette"),
              4: (2, "greyscale+alpha"), 6: (4, "RGBA")}


def _png_chunks(data: bytes):
    pos = len(_PNG_MAGIC)
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        if len(body) != length or pos + 12 + length > len(data):
            raise ValueError("truncated PNG: a chunk runs past the end of the data")
        (crc,) = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        if zlib.crc32(kind + body) != crc:
            raise ValueError(f"corrupt PNG: bad CRC in the {kind.decode(errors='replace')} chunk")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + length
    raise ValueError("truncated PNG: no IEND chunk")


# Adam7's passes: (first column, first row, column step, row step).
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
          (0, 1, 1, 2))


def _png_samples(rows: np.ndarray, h: int, w: int, spp: int, depth: int) -> np.ndarray:
    """Unfiltered scanlines (h, rowbytes) -> samples (h, w, spp): uint8, or
    uint16 at depth 16 (big-endian on the wire)."""
    if depth < 8:
        # Sub-byte samples (one per pixel), most significant first.
        shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
        return ((rows[:, :, None] >> shifts) & ((1 << depth) - 1)).reshape(h, -1)[:, :w, None]
    if depth == 16:
        return rows.view(">u2").reshape(h, w, spp).astype(np.uint16)
    return rows.reshape(h, w, spp)


def _decode_png(data: bytes) -> np.ndarray:
    header = palette = None
    idat = []
    for kind, body in _png_chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body[:13])
        elif kind == b"PLTE":
            palette = body
        elif kind == b"IDAT":
            idat.append(body)
    if header is None or not idat:
        raise ValueError("corrupt PNG: no IHDR or no IDAT chunk")
    w, h, depth, ctype, _comp, _filt, interlace = header
    if ctype not in _PNG_TYPES:
        raise ValueError(f"corrupt PNG: colour type {ctype}")
    allowed = (1, 2, 4, 8, 16) if ctype == 0 else (1, 2, 4, 8) if ctype == 3 else (8, 16)
    if depth not in allowed:
        raise ValueError(f"corrupt PNG: bit depth {depth} with colour type {ctype}")
    if interlace not in (0, 1):
        raise ValueError(f"corrupt PNG: interlace method {interlace}")
    if w == 0 or h == 0:
        raise ValueError("corrupt PNG: zero width or height")
    if w * h > MAX_IMAGE_PIXELS:
        raise ValueError(f"image too large: {w}x{h} pixels exceeds the limit of "
                         f"{MAX_IMAGE_PIXELS}")
    spp = _PNG_TYPES[ctype][0]
    bpp = max(1, spp * depth // 8)
    rowbytes = lambda width: (width * spp * depth + 7) // 8  # noqa: E731
    # Each pass a sub-image of its own, filtered on its own; empty ones
    # have no bytes at all.  A plain image is one pass over every pixel.
    passes = []
    for x0, y0, dx, dy in _ADAM7 if interlace else ((0, 0, 1, 1),):
        ph, pw = (h - y0 + dy - 1) // dy, (w - x0 + dx - 1) // dx
        if ph and pw:
            passes.append((x0, y0, dx, dy, ph, pw))
    need = sum(ph * (rowbytes(pw) + 1) for *_, ph, pw in passes)
    # Inflate no more than the rows hold; like PIL, ignore what follows.
    try:
        raw = zlib.decompressobj().decompress(b"".join(idat), need)
    except zlib.error as e:
        raise ValueError(f"corrupt PNG: {e}") from e
    if not interlace:
        samples = _png_samples(_native.png_unfilter(raw, h, rowbytes(w), bpp), h, w, spp, depth)
    else:
        samples = np.empty((h, w, spp), np.uint16 if depth == 16 else np.uint8)
        at = 0
        for x0, y0, dx, dy, ph, pw in passes:
            size = ph * (rowbytes(pw) + 1)
            rows = _native.png_unfilter(raw[at:at + size], ph, rowbytes(pw), bpp)
            samples[y0::dy, x0::dx] = _png_samples(rows, ph, pw, spp, depth)
            at += size
    if ctype == 3:
        if palette is None:
            raise ValueError("corrupt PNG: palette image without a PLTE chunk")
        # PIL's palette starts as a grey ramp; PLTE overwrites its first entries.
        lut = np.repeat(np.arange(256, dtype=np.uint8)[:, None], 3, axis=1)
        entries = np.frombuffer(palette[: len(palette) // 3 * 3], np.uint8).reshape(-1, 3)[:256]
        lut[: len(entries)] = entries
        return lut[samples[:, :, 0]]
    if depth == 16:
        # PIL opens 16-bit grey as "I;16", whose convert("RGB") clips at
        # 255; every other colour type keeps each sample's high byte.
        if ctype == 0:
            samples = np.minimum(samples, 255).astype(np.uint8)
        else:
            samples = (samples >> 8).astype(np.uint8)
    if ctype == 0:
        grey = samples[:, :, 0]
        if depth < 8:  # PIL: 1-bit -> 0/255, 2-bit x85, 4-bit x17
            grey = (grey * (255 // ((1 << depth) - 1))).astype(np.uint8)
        return np.repeat(grey[:, :, None], 3, axis=2)
    if ctype == 4:  # convert("RGB") drops the alpha and repeats the grey
        return np.repeat(samples[:, :, :1], 3, axis=2)
    return np.ascontiguousarray(samples[:, :, :3])  # RGB, or RGBA with its alpha dropped


def decode_image(data: bytes) -> np.ndarray:
    """Decode JPEG/PNG bytes to an RGB uint8 HWC array, byte-equal to
    ``PIL.Image.open(io.BytesIO(data)).convert("RGB")``."""
    data = bytes(data)
    if data.startswith(_PNG_MAGIC):
        return _decode_png(data)
    if data.startswith(_JPEG_MAGIC):
        return _native.decode_jpeg(data)
    raise ValueError("unsupported image format: only JPEG and PNG are decoded")


def resize_uint8(img: np.ndarray, size: tuple[int, int], filter: str = "bilinear") -> np.ndarray:
    """Resize an RGB uint8 HWC array to (H, W), bit-exact with PIL.

    ``filter`` comes from ModelSpec.resize_filter: the clothing model uses
    "nearest" because keras-image-helper (the reference's preprocessor)
    resizes with Image.NEAREST, and the filter shifts logits far beyond
    numerical tolerance.
    """
    if filter not in ("bilinear", "nearest"):
        raise ValueError(f"unknown resize filter {filter!r}")
    h, w = int(size[0]), int(size[1])
    if img.shape[0] == h and img.shape[1] == w:
        return np.ascontiguousarray(img)
    fn = _native.resize_bilinear if filter == "bilinear" else _native.resize_nearest
    return fn(img, h, w)


def preprocess_bytes(data: bytes, size: tuple[int, int], *, filter: str = "bilinear") -> np.ndarray:
    """bytes -> resized RGB uint8 HWC; the full host-side gateway pipeline."""
    return resize_uint8(decode_image(data), size, filter)


class BatchDecoder:
    """The model tier's decode stage: a bytes-wire request's JPEG/PNG blobs
    -> one resized RGB uint8 (N,H,W,C) batch.

    Decode and resize run in a bounded thread pool; both native calls
    release the interpreter lock, so a batch costs about one image's wall
    time per pool thread.  A per-image failure raises ValueError naming the
    index, which the server answers with a 400 (a corrupt blob is the
    client's error, never a 500).
    """

    def __init__(self, workers: int | None = None):
        self.workers = resolve_decode_pool(workers)
        self._pool = ThreadPoolExecutor(max_workers=self.workers, thread_name_prefix="kdlt-decode")

    def _decode_one(self, i: int, blob: bytes, size, filter: str) -> np.ndarray:
        try:
            return preprocess_bytes(blob, size, filter=filter)
        except ValueError as e:
            raise ValueError(f"image {i}: {e}") from e
        except Exception as e:  # noqa: BLE001 - undecodable client bytes
            raise ValueError(f"image {i}: undecodable image bytes ({e})") from e

    def decode_batch(self, blobs: list[bytes], size: tuple[int, int], *,
                     filter: str = "bilinear") -> np.ndarray:
        """Encoded blobs -> stacked uint8 (N,H,W,C) batch at ``size``."""
        if not blobs:
            raise ValueError("empty image batch")
        if len(blobs) == 1:
            # No pool hop for the single-image common case.
            return self._decode_one(0, blobs[0], size, filter)[None]
        futures = [self._pool.submit(self._decode_one, i, blob, size, filter)
                   for i, blob in enumerate(blobs)]
        return np.stack([f.result() for f in futures])

    def close(self) -> None:
        self._pool.shutdown(wait=False)


@functools.lru_cache(maxsize=None)
def _const(values: tuple[float, ...], device: torch.device) -> torch.Tensor:
    """A constant made on ``device`` once: a forward captured into a CUDA
    graph must not copy one from pageable host memory."""
    import torch

    return torch.tensor(values, dtype=torch.float32, device=device)


def normalize(x: torch.Tensor, mode: str) -> torch.Tensor:
    """uint8/float NHWC batch -> normalized float32 on ``x``'s device.
    (torch is imported here, not at the top: the gateway, which decodes and
    resizes with this module, runs without it.)"""
    import torch

    if mode == "none":
        return x
    x = x.to(torch.float32)
    if mode == "tf":
        return x / 127.5 - 1.0
    const = lambda v: _const(v, x.device)  # noqa: E731
    if mode == "caffe":
        return x.flip(-1) - const(_CAFFE_MEAN_BGR)
    if mode == "torch":
        return (x / 255.0 - const(_TORCH_MEAN)) / const(_TORCH_STD)
    raise ValueError(f"unknown preprocessing mode {mode!r}")
