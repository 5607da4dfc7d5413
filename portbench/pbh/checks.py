"""The comparison that decides `correct`: the program's answers against the
plain reference (`pbref`), which builds its own tables from the raw scene.

Renders and preview passes are compared on a sample of pixels drawn from
the seed: the reference traces each sampled pixel's paths (pixel, sample,
seed) in float32 and averages them in the program's order. Two numbers
are held to limits of their own (the cell's traffic file gives them):
- `pixel_l1`: sum |program - reference| / sum |reference| over the
  sampled pixels' channels;
- `mean_bias`: |sum program - sum reference| / sum |reference|.
"""
from __future__ import annotations

import numpy as np

from pbref import path as ref_path
from pbref import scene as ref_scene
from pbref.trace import Tracer

BLOCK = 1 << 16  # reference paths traced at once


class Reference:
    """The reference's tables and tracer for one raw scene and material
    state, in float32 or (the precision control) bfloat16."""

    def __init__(self, torch, raw, device, dtype=None, materials=None,
                 face_emission=None):
        self.torch = torch
        dtype = dtype or torch.float32
        self.geo = ref_scene.Geometry(raw)
        mats = materials if materials is not None else \
            ref_scene.material_columns(raw.materials, device)
        em = face_emission if face_emission is not None else \
            torch.from_numpy(self.geo.emission).to(device)
        self.tab = ref_scene.tables(self.geo, mats, em, device, dtype)
        self.tracer = Tracer(self.geo.v0, self.geo.e1, self.geo.e2, device,
                             dtype)
        self.device, self.dtype = device, dtype

    def pixel_means(self, width, height, pixels, seeds, spp, max_steps,
                    k_volume):
        """Mean radiance [K, 3] of pixel ids [K] over samples 0..spp-1 at
        seeds [K], each pixel's samples summed in order, then divided (a
        render's mean, and the progressive average of passes 0..spp-1)."""
        torch = self.torch
        dev = self.device
        pix = torch.as_tensor(np.asarray(pixels, np.int64), device=dev)
        sd = torch.as_tensor(np.asarray(seeds, np.int64), device=dev)
        per = max(1, BLOCK // spp)
        out = []
        for k0 in range(0, pix.shape[0], per):
            p = pix[k0:k0 + per].repeat_interleave(spp)
            s = torch.arange(spp, device=dev).repeat(
                min(per, pix.shape[0] - k0))
            c = ref_path.radiance(self.tab, self.tracer, width, height, p, s,
                                  sd[k0:k0 + per].repeat_interleave(spp),
                                  max_steps, k_volume, self.dtype)
            c = c.reshape(-1, spp, 3)
            acc = c[:, 0]
            for j in range(1, spp):
                acc = acc + c[:, j]
            out.append(acc / torch.tensor(float(spp), device=dev))
        return torch.cat(out)


def image_numbers(got, want):
    """(pixel_l1, mean_bias) of the program's sampled pixels `got` against
    the reference's `want` (arrays [K, 3])."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    scale = max(np.abs(want).sum(), 1e-30)
    return (float(np.abs(got - want).sum() / scale),
            float(abs(got.sum() - want.sum()) / scale))


def judge(numbers):
    """correct iff every compared value is finite and at most its limit."""
    return all(np.isfinite(v) and v <= lim for v, lim in numbers.values())
