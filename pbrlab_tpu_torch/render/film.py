"""Film resolve (port of pbrlab_tpu.render.film): the averaged linear
image to sRGB and an 8-bit PNG, the CLI tail of the reference
(pc/pbrlab-cli.cc:49-57). Accumulation itself is a plain add in the
wavefront (every lane owns its pixel sample)."""
from __future__ import annotations

import numpy as np

from ..io.image import linear_to_srgb, write_png


def resolve_to_srgb(linear_img) -> np.ndarray:
    """Linear [H, W, 3] (numpy or a torch tensor on any device) -> sRGB."""
    if hasattr(linear_img, "detach"):
        linear_img = linear_img.detach().cpu().numpy()
    return linear_to_srgb(np.asarray(linear_img, np.float32))


def save_png(path: str, linear_img) -> None:
    write_png(path, resolve_to_srgb(linear_img))
