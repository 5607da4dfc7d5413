"""Light sampling over the flattened emissive-face arrays (port of
pbrlab_tpu.scene.lights; semantics from light-manager.h:37-170).

The chained (light, primitive) CDF draws of the reference are one draw over
the flattened p(light) * p(prim | light) CDF built at scene build; the pdf
(area measure) is the per-face face_light_pdf = p_choose(face) / area.
"""
from __future__ import annotations

from typing import Dict, NamedTuple

import torch

from ..core.sampling import sample_cdf, triangle_uniform_sample


class SampledLight(NamedTuple):
    position: torch.Tensor  # [N,3]
    normal: torch.Tensor  # [N,3]
    emission: torch.Tensor  # [N,3]
    pdf: torch.Tensor  # [N] area-measure pdf
    valid: torch.Tensor  # [N] bool (False when scene has no lights)


def sample_all_light(scene: Dict, u0, u1, u2) -> SampledLight:
    """Sample a point on an emissive face per lane (light-manager.h:79-170):
    u0 picks the face through the CDF, (u1, u2) a uniform point on it.
    Reads the `light_fat` rows of build_fat_tables (v0 e1 e2 ng emission pdf).
    """
    cdf = scene["light_cdf"]
    n = u0.shape[0]
    if cdf.shape[0] == 0:
        z3 = u0.new_zeros((n, 3))
        return SampledLight(z3, z3, z3, u0.new_zeros((n,)),
                            torch.zeros((n,), dtype=torch.bool,
                                        device=u0.device))
    row = scene["light_fat"][sample_cdf(cdf, u0)]
    u, v = triangle_uniform_sample(u1, u2)
    # Lerp3 with P = (1-u-v)p0 + u p1 + v p2  ==  p0 + u e1 + v e2
    position = row[:, 0:3] + u[..., None] * row[:, 3:6] + v[..., None] * row[:, 6:9]
    return SampledLight(position, row[:, 9:12], row[:, 12:15], row[:, 15],
                        torch.ones((n,), dtype=torch.bool, device=u0.device))


def implicit_area_light(scene: Dict, prim):
    """Emission + area pdf for a BSDF-sampled hit on an emissive face
    (light-manager.h ImplicitAreaLight). prim [N] >= 0 assumed clipped."""
    emission = scene["face_emission"][prim]
    pdf = scene["face_light_pdf"][prim]
    return pdf > 0.0, emission, pdf
