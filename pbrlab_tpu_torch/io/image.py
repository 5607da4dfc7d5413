"""Image IO and sRGB conversions (numpy; port of pbrlab_tpu.io.image).

Reference: io/image-io.cc (stb_image / tinyexr load, PNG save with the
x256 clamp) and image-utils.cc:8-97 (piecewise sRGB <-> linear). PNGs
are written by `encode_png` with the standard library alone. LDR files
are read through Pillow, EXR / HDR read and written through imageio; both
are optional imports, needed only by the functions that use them.
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
    /255, image-io.cc:100-159), EXR / HDR as stored. None (with a logged
    warning) when the file is missing or cannot be read."""
    if not os.path.exists(path):
        log.warning("texture/image not found: %s", path)
        return None
    ext = os.path.splitext(path)[1].lower()
    try:
        if ext in (".exr", ".hdr"):
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
