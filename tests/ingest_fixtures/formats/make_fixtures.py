"""Write the decoder-breadth fixtures beside this file, and ``digests.json``.

Each fixture is a small image in a format the port's decoder reads beyond
baseline JPEG and plain 8-bit PNG: progressive JPEG (several scan scripts,
restart intervals), 4-component JPEG (Adobe CMYK, YCCK, no Adobe marker),
4:4:0 and 4:1:1 sampling, 16-bit PNG of every colour type, and Adam7 PNG
at every depth; and a few JPEGs of 512 px and more for the device-side
resize (one of them twice, baseline and progressive).  ``digests.json``
holds, for each, the shape and the SHA-256 of
``PIL.Image.open(f).convert("RGB")``'s pixels.  The card's machine has no
PIL: ``chip_smoke.py`` holds the port's decoder to these digests there,
and ``tests/test_torch_ingest_formats.py`` recomputes them with PIL here.

Run: ``python tests/ingest_fixtures/formats/make_fixtures.py`` (needs PIL
and OpenCV).  The images come from fixed seeds, so a rerun with the same
encoders writes the same bytes.
"""

from __future__ import annotations

import hashlib
import io
import json
import os
import struct
import zlib

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
DIGESTS = "digests.json"

# Adam7's passes: (first column, first row, column step, row step).
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
         (0, 1, 1, 2))
# PNG colour type -> samples per pixel
PNG_SPP = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def pixels(h: int, w: int, seed: int = 0, smooth: bool = True, channels: int = 3) -> np.ndarray:
    """Seeded test content: gradients with noise, or plain noise."""
    rng = np.random.default_rng(seed)
    if not smooth:
        return rng.integers(0, 256, size=(h, w, channels), dtype=np.uint8)
    y, x = np.mgrid[0:h, 0:w]
    planes = [x * 255 // max(w - 1, 1), y * 255 // max(h - 1, 1), (x + y) * 7 % 256,
              (x * 3 + y * 5) % 256]
    base = np.stack(planes[:channels], -1)
    return np.clip(base + rng.integers(-30, 30, size=(h, w, channels)), 0, 255).astype(np.uint8)


def _filter_row(kind: int, row: np.ndarray, prev: np.ndarray, bpp: int) -> np.ndarray:
    """One scanline filtered with PNG filter ``kind`` (0-4)."""
    r = row.astype(np.int32)
    b = prev.astype(np.int32)
    a = np.concatenate([np.zeros(bpp, np.int32), r[:-bpp]]) if len(r) else r
    c = np.concatenate([np.zeros(bpp, np.int32), b[:-bpp]]) if len(b) else b
    if kind == 0:
        pred = np.zeros_like(r)
    elif kind == 1:
        pred = a
    elif kind == 2:
        pred = b
    elif kind == 3:
        pred = (a + b) >> 1
    else:
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    return ((r - pred) & 0xFF).astype(np.uint8)


def _pack(samples: np.ndarray, depth: int) -> np.ndarray:
    """Samples (h, w, spp) -> scanline bytes (h, rowbytes)."""
    h = samples.shape[0]
    flat = samples.reshape(h, -1)
    if depth == 16:
        return flat.astype(">u2").view(np.uint8).reshape(h, -1)
    if depth == 8:
        return flat.astype(np.uint8)
    per = 8 // depth
    n = flat.shape[1]
    padded = np.zeros((h, -(-n // per) * per), np.uint8)
    padded[:, :n] = flat
    shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
    return (padded.reshape(h, -1, per) << shifts).sum(-1, dtype=np.uint16).astype(np.uint8)


def _chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))


def write_png(samples: np.ndarray, depth: int, ctype: int, interlace: bool,
              palette: np.ndarray | None = None) -> bytes:
    """A PNG of ``samples`` (h, w, spp; uint16 at depth 16), every row's
    filter cycling through the five kinds; Adam7 when ``interlace``."""
    h, w, spp = samples.shape
    assert spp == PNG_SPP[ctype]
    bpp = max(1, spp * depth // 8)
    passes = ADAM7 if interlace else ((0, 0, 1, 1),)
    raw = bytearray()
    for x0, y0, dx, dy in passes:
        sub = samples[y0::dy, x0::dx]
        if sub.size == 0:
            continue
        rows = _pack(sub, depth)
        prev = np.zeros(rows.shape[1], np.uint8)
        for i, row in enumerate(rows):
            kind = (i + x0 + y0) % 5
            raw += bytes([kind]) + _filter_row(kind, row, prev, bpp).tobytes()
            prev = row
    out = b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0,
                                                           int(interlace)))
    if palette is not None:
        out += _chunk(b"PLTE", palette.astype(np.uint8).tobytes())
    return out + _chunk(b"IDAT", zlib.compress(bytes(raw), 9)) + _chunk(b"IEND", b"")


def png_image(h: int, w: int, depth: int, ctype: int, seed: int) -> tuple[np.ndarray, object]:
    """Seeded samples (and a palette for type 3) at ``depth``."""
    rng = np.random.default_rng(seed)
    spp = PNG_SPP[ctype]
    top = (1 << depth) - 1
    samples = rng.integers(0, top + 1, size=(h, w, spp), dtype=np.uint32)
    if depth == 16 and ctype == 0:
        # Grey 16 clips at 255 in PIL's convert("RGB"): keep many samples low.
        samples[::2] %= 300
    samples = samples.astype(np.uint16 if depth == 16 else np.uint8)
    palette = rng.integers(0, 256, size=(1 << depth, 3)) if ctype == 3 else None
    return samples, palette


def _pil_save(im, fmt: str, **kw) -> bytes:
    buf = io.BytesIO()
    im.save(buf, fmt, **kw)
    return buf.getvalue()


def set_adobe_transform(data: bytes, transform: int) -> bytes:
    """The JPEG with its Adobe APP14 marker's transform byte replaced."""
    data = bytearray(data)
    at = data.index(b"\xff\xee")
    data[at + 4 + 11] = transform
    return bytes(data)


def drop_adobe(data: bytes) -> bytes:
    """The JPEG without its Adobe APP14 segment."""
    at = data.index(b"\xff\xee")
    length = struct.unpack(">H", data[at + 2:at + 4])[0]
    return data[:at] + data[at + 2 + length:]


def cv2_jpeg(img: np.ndarray, sampling: str, quality: int, progressive: bool = False) -> bytes:
    import cv2

    factor = {"440": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440,
              "411": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411}[sampling]
    ok, buf = cv2.imencode(".jpg", img[:, :, ::-1], [
        cv2.IMWRITE_JPEG_SAMPLING_FACTOR, factor, cv2.IMWRITE_JPEG_QUALITY, quality,
        cv2.IMWRITE_JPEG_PROGRESSIVE, int(progressive)])
    assert ok
    return buf.tobytes()


def photo(h: int, w: int, seed: int) -> np.ndarray:
    """A smooth, photo-like RGB image (blurred blobs), cheap to encode."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w] / max(h, w)
    img = np.zeros((h, w, 3))
    for _ in range(12):
        cy, cx, r = rng.random(), rng.random(), 0.05 + 0.3 * rng.random()
        img += rng.random(3) * np.exp(-((y - cy) ** 2 + (x - cx) ** 2) / r**2)[..., None]
    img = img / img.max() * 255 + rng.normal(0, 2, (h, w, 3))
    return np.clip(img, 0, 255).astype(np.uint8)


def fixtures() -> dict[str, tuple[str, bytes]]:
    """name -> (format, file bytes)."""
    from PIL import Image

    rgb = lambda h, w, s: Image.fromarray(pixels(h, w, s))  # noqa: E731
    cmyk = Image.fromarray(pixels(37, 45, 31, channels=4), "CMYK")
    out = {
        "prog_q75_420_123x77.jpg": ("progressive", _pil_save(
            rgb(77, 123, 21), "JPEG", quality=75, subsampling=2, progressive=True)),
        "prog_q90_444_61x45_rst.jpg": ("progressive", _pil_save(
            rgb(45, 61, 22), "JPEG", quality=90, subsampling=0, progressive=True,
            restart_marker_blocks=3)),
        "prog_q60_grey_33x29.jpg": ("progressive", _pil_save(
            rgb(29, 33, 23).convert("L"), "JPEG", quality=60, progressive=True)),
        "prog_q85_cmyk_45x37.jpg": ("progressive", _pil_save(
            cmyk, "JPEG", quality=85, progressive=True)),
        "prog_q80_440_51x39.jpg": ("progressive", cv2_jpeg(pixels(39, 51, 24), "440", 80, True)),
        "cmyk_q90_45x37.jpg": ("cmyk", _pil_save(cmyk, "JPEG", quality=90)),
        "ycck_q90_45x37.jpg": ("cmyk", set_adobe_transform(_pil_save(cmyk, "JPEG", quality=90),
                                                          2)),
        "cmyk_noadobe_q90_45x37.jpg": ("cmyk", drop_adobe(_pil_save(cmyk, "JPEG", quality=90))),
        "s440_q85_47x35.jpg": ("4:4:0", cv2_jpeg(pixels(35, 47, 25), "440", 85)),
        "s411_q85_53x31.jpg": ("4:1:1", cv2_jpeg(pixels(31, 53, 26), "411", 85)),
    }
    for ctype in (0, 2, 4, 6):
        samples, _ = png_image(19, 23, 16, ctype, 40 + ctype)
        out[f"png16_type{ctype}_23x19.png"] = ("png16", write_png(samples, 16, ctype, False))
    for depth, ctype in ((1, 0), (2, 0), (4, 0), (8, 2), (16, 6), (4, 3), (8, 3)):
        samples, palette = png_image(21, 27, depth, ctype, 50 + depth + ctype)
        out[f"adam7_d{depth}_type{ctype}_27x21.png"] = (
            "adam7", write_png(samples, depth, ctype, True, palette))
    # The 800x600 photo twice, baseline and progressive: the card's decode
    # times of the two are of the same pixels.
    for (h, w), q, prog in (((512, 512), 85, False), ((600, 800), 80, True),
                            ((600, 800), 80, False), ((720, 540), 85, False)):
        out[f"large_{w}x{h}{'_prog' if prog else ''}.jpg"] = ("large", _pil_save(
            Image.fromarray(photo(h, w, h + w)), "JPEG", quality=q, subsampling=2,
            progressive=prog))
    return out


def pil_pixels(data: bytes) -> np.ndarray:
    from PIL import Image

    with Image.open(io.BytesIO(data)) as im:
        return np.asarray(im.convert("RGB"))


def digest(pixels_rgb: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(pixels_rgb, np.uint8).tobytes()).hexdigest()


def main(directory: str = HERE) -> None:
    table = {}
    for name, (fmt, data) in sorted(fixtures().items()):
        with open(os.path.join(directory, name), "wb") as f:
            f.write(data)
        rgb = pil_pixels(data)
        table[name] = {"format": fmt, "shape": list(rgb.shape), "sha256": digest(rgb)}
    with open(os.path.join(directory, DIGESTS), "w") as f:
        json.dump(table, f, indent=1, sort_keys=True)
        f.write("\n")


if __name__ == "__main__":
    main()
