"""Image IO and sRGB conversions (numpy; port of pbrlab_tpu.io.image).

Reference: io/image-io.cc (stb_image / tinyexr load, PNG save with the
x256 clamp) and image-utils.cc:8-97 (piecewise sRGB <-> linear). LDR
formats go through Pillow, EXR / HDR through imageio; both are optional
imports, needed only by the functions that read or write those formats.
"""
from __future__ import annotations

import logging
import os
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


def write_png(path: str, img: np.ndarray) -> None:
    """8-bit PNG with the reference's x256, clamp-to-255 quantisation
    (image-io.cc:171-223)."""
    from PIL import Image

    q = np.clip(np.asarray(img, np.float32) * 256.0, 0.0, 255.0)
    Image.fromarray(q.astype(np.uint8)).save(path)
