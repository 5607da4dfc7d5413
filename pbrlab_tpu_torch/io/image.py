"""Image IO and sRGB conversions (numpy; port of pbrlab_tpu.io.image).

Reference: io/image-io.cc (stb_image / tinyexr load, PNG save with the
x256 clamp) and image-utils.cc:8-97 (piecewise sRGB <-> linear). PNGs
are written by `encode_png` and read by `decode_png` with the standard
library alone (zlib, struct), on every machine. Other LDR files (JPEG,
BMP, ...) are read through Pillow, EXR / HDR read and written through
imageio; both are optional imports, needed only by the functions that
use them.
"""
from __future__ import annotations

import logging
import os
import struct
import zlib
from typing import Optional

import numpy as np

log = logging.getLogger("pbrlab_tpu_torch.io")


def srgb_to_linear(img: np.ndarray) -> np.ndarray:
    """Piecewise sRGB EOTF (image-utils.cc SrgbToLiner)."""
    img = np.asarray(img, np.float32)
    return np.where(img <= 0.04045, img / 12.92,
                    ((img + 0.055) / 1.055) ** 2.4).astype(np.float32)


def linear_to_srgb(img: np.ndarray) -> np.ndarray:
    """Inverse EOTF (image-utils.cc LinerToSrgb)."""
    img = np.clip(np.asarray(img, np.float32), 0.0, None)
    return np.where(img <= 0.0031308, img * 12.92,
                    1.055 * np.maximum(img, 1e-10) ** (1.0 / 2.4)
                    - 0.055).astype(np.float32)


def load_image(path: str) -> Optional[np.ndarray]:
    """Load an image -> float32 [H, W, C]: LDR in [0, 1] (the reference's
    /255, image-io.cc:100-159), EXR / HDR as stored. PNGs go through
    `decode_png`, so they load without Pillow, as the JAX package's
    `np.asarray(Image.open(p).convert("RGB")) / 255` does with it. None
    (with a logged warning) when the file is missing or cannot be read,
    or when the package its format needs (Pillow for other LDR formats,
    imageio for EXR / HDR) is not installed."""
    if not os.path.exists(path):
        log.warning("texture/image not found: %s", path)
        return None
    ext = os.path.splitext(path)[1].lower()
    try:
        if ext == ".png":
            with open(path, "rb") as f:
                img = decode_png(f.read()).astype(np.float32) / 255.0
        elif ext in (".exr", ".hdr"):
            import imageio.v3 as iio

            img = np.asarray(iio.imread(path), np.float32)
        else:
            from PIL import Image

            with Image.open(path) as im:
                img = np.asarray(im.convert("RGB"), np.float32) / 255.0
    except Exception as exc:  # unreadable file or missing optional package
        log.warning("failed to load image %s: %s", path, exc)
        return None
    return img[..., None] if img.ndim == 2 else img


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data)))


def encode_png(img: np.ndarray) -> bytes:
    """8-bit RGB [H, W, 3] uint8 -> PNG file bytes: the signature, IHDR
    (bit depth 8, colour type 2, no interlace), one IDAT of the rows, each
    with filter type 0, through zlib, and IEND."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"encode_png takes [H, W, 3] uint8, got "
                         f"{img.shape} {img.dtype}")
    h, w, _ = img.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           np.ascontiguousarray(img).reshape(h, w * 3)],
                          axis=1)
    return (b"\x89PNG\r\n\x1a\n"
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(rows.tobytes()))
            + _chunk(b"IEND", b""))


_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> samples per pixel, and the bit depths it allows
_PNG_TYPES = {0: (1, (1, 2, 4, 8, 16)), 2: (3, (8, 16)),
              3: (1, (1, 2, 4, 8)), 4: (2, (8, 16)), 6: (4, (8, 16))}
# Adam7's seven passes: (x0, y0, dx, dy) (PNG specification, section 8.2)
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def _png_chunks(data: bytes):
    """(type, body) of each chunk after the signature, its CRC checked."""
    if data[:8] != _PNG_SIGNATURE:
        raise ValueError("not a PNG file: bad signature")
    pos = 8
    while pos < len(data):
        if pos + 12 > len(data):
            raise ValueError("truncated PNG chunk")
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        if len(body) != n or pos + 12 + n > len(data):
            raise ValueError(f"truncated PNG chunk {kind!r}")
        (crc,) = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        if zlib.crc32(kind + body) != crc:
            raise ValueError(f"PNG chunk {kind!r} fails its CRC")
        yield kind, body
        pos += 12 + n
        if kind == b"IEND":
            return
    raise ValueError("PNG file has no IEND chunk")


def _unfilter(raw: np.ndarray, ftype: np.ndarray, bpp: int) -> np.ndarray:
    """Undo the five PNG filters (None, Sub, Up, Average, Paeth) of the
    rows `raw` [H, stride] (uint8, filter bytes removed), `bpp` bytes a
    pixel (1 below 8 bits). A byte depends on its left, upper and
    upper-left neighbours, so the rows are rebuilt along anti-diagonals
    of pixels, each diagonal one vectorised step over every filter."""
    if (ftype == 0).all():
        return raw
    h, stride = raw.shape
    w = stride // bpp
    x = raw.reshape(h, w, bpp).astype(np.int32)
    out = np.zeros((h + 1, w + 1, bpp), np.int32)  # a zero row and column
    for d in range(h + w - 1):
        r = np.arange(max(0, d - w + 1), min(h, d + 1))
        c = d - r
        a, b, ul = out[r + 1, c], out[r, c + 1], out[r, c]
        p = a + b - ul
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - ul)
        paeth = np.where((pa <= pb) & (pa <= pc), a,
                         np.where(pb <= pc, b, ul))
        f = ftype[r][:, None]
        pred = np.where(f == 1, a, np.where(f == 2, b, np.where(
            f == 3, (a + b) >> 1, np.where(f == 4, paeth, 0))))
        out[r + 1, c + 1] = (x[r, c] + pred) & 0xFF
    return out[1:, 1:].reshape(h, stride).astype(np.uint8)


def _samples(raw: np.ndarray, w: int, depth: int, spp: int) -> np.ndarray:
    """Unfiltered rows [H, stride] -> samples [H, w, spp] (uint16 at bit
    depth 16, else uint8; 1-, 2- and 4-bit samples unpacked, unscaled)."""
    h = raw.shape[0]
    if depth == 16:
        return np.ascontiguousarray(raw).view(">u2").reshape(
            h, w, spp).astype(np.uint16)
    if depth == 8:
        return raw.reshape(h, w, spp)
    shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
    return ((raw[:, :, None] >> shifts) & ((1 << depth) - 1)).reshape(
        h, -1)[:, :w, None]


def decode_png(data: bytes) -> np.ndarray:
    """PNG file bytes -> [H, W, 3] uint8 RGB, with zlib and struct alone:
    the JAX package's `np.asarray(Image.open(p).convert("RGB"))` (Pillow)
    on every PNG. Colour types 0 (grey), 2 (RGB), 3 (palette), 4 (grey +
    alpha) and 6 (RGBA) at every bit depth the format allows (1, 2, 4 for
    grey and palette; 8; 16 but for palette), the five filter types,
    Adam7 interlacing (each of the seven passes unfiltered on its own and
    scattered into the image), every chunk's CRC checked (a mismatch
    raises). As Pillow converts:
    - 1-, 2- and 4-bit grey scale to 0..255 (v * 255 / (2^depth - 1));
    - 16-bit grey (Pillow's mode "I;16") is clipped to 255, min(v, 255),
      so most 16-bit grey values read as white;
    - 16-bit RGB, RGBA and grey + alpha keep the high byte, v >> 8;
    - alpha and `tRNS` are dropped (the result is RGB), and palette
      indices past the PLTE entries read black.
    A malformed file raises a ValueError (`load_image` logs it and
    returns None).
    """
    ihdr, palette, idat = None, None, []
    for kind, body in _png_chunks(data):
        if kind == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind[0] < 97 and kind not in (b"IEND",):  # unknown critical
            raise ValueError(f"unsupported critical PNG chunk {kind!r}")
    if ihdr is None or not idat:
        raise ValueError("PNG file has no IHDR or no IDAT")
    w, h, depth, ctype, comp, filt, interlace = ihdr
    if ctype not in _PNG_TYPES or depth not in _PNG_TYPES[ctype][1] \
            or comp or filt or interlace > 1 or w == 0 or h == 0:
        raise ValueError(f"unsupported PNG header {ihdr}")
    if ctype == 3 and palette is None:
        raise ValueError("palette PNG without a PLTE chunk")
    spp = _PNG_TYPES[ctype][0]
    bits = spp * depth
    stream = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    v = np.zeros((h, w, spp), np.uint16 if depth == 16 else np.uint8)
    pos = 0
    for x0, y0, dx, dy in _ADAM7 if interlace else ((0, 0, 1, 1),):
        pw, ph = -((x0 - w) // dx), -((y0 - h) // dy)  # ceil; 0: empty
        if pw <= 0 or ph <= 0:
            continue
        stride = (pw * bits + 7) // 8
        rows = stream[pos:pos + ph * (stride + 1)]
        pos += ph * (stride + 1)
        if rows.size < ph * (stride + 1):
            raise ValueError("PNG image data is truncated")
        rows = rows.reshape(ph, stride + 1)
        if (rows[:, 0] > 4).any():
            raise ValueError("unknown PNG filter type")
        raw = _unfilter(rows[:, 1:], rows[:, 0], max(1, bits // 8))
        v[y0::dy, x0::dx] = _samples(raw, pw, depth, spp)
    if depth == 16:
        if ctype == 0:
            return np.repeat(np.minimum(v, 255).astype(np.uint8), 3, axis=2)
        v = (v >> 8).astype(np.uint8)
    elif depth < 8 and ctype == 0:
        v = (v.astype(np.uint32) * 255 // ((1 << depth) - 1)).astype(
            np.uint8)
    if ctype == 3:
        lut = np.zeros((256, 3), np.uint8)
        lut[:len(palette)] = palette[:256]
        return lut[v[..., 0]]
    if ctype in (0, 4):
        return np.repeat(v[..., :1], 3, axis=2)
    return np.ascontiguousarray(v[..., :3])


def write_png(path: str, img: np.ndarray) -> None:
    """8-bit RGB PNG with the reference's x256, clamp-to-255 quantisation
    (image-io.cc:171-223)."""
    q = np.clip(np.asarray(img, np.float32) * 256.0, 0.0, 255.0)
    with open(path, "wb") as f:
        f.write(encode_png(q.astype(np.uint8)))


def write_exr(path: str, img: np.ndarray) -> bool:
    """Write a float EXR through imageio (optional). A failure is logged
    and reported as False."""
    try:
        import imageio.v3 as iio

        iio.imwrite(path, np.asarray(img, np.float32))
        return True
    except Exception as exc:  # missing optional package or writer
        log.warning("write_exr failed for %s: %s", path, exc)
        return False
