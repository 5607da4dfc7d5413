"""Branchless orthonormal basis + frame transforms (port of
pbrlab_tpu.core.onb; reference shader-utils.h:44-114)."""
from __future__ import annotations

import torch

from .math import vdot


def branchless_onb(n):
    """Build (ex, ey) given unit normals n [..., 3] (Pixar, Duff et al. 2017)."""
    sign = torch.where(n[..., 2] >= 0.0, 1.0, -1.0)
    a = -1.0 / (sign + n[..., 2])
    b = n[..., 0] * n[..., 1] * a
    ex = torch.stack(
        [1.0 + sign * n[..., 0] * n[..., 0] * a, sign * b, -sign * n[..., 0]],
        dim=-1)
    ey = torch.stack([b, sign + n[..., 1] * n[..., 1] * a, -n[..., 1]], dim=-1)
    return ex, ey


def to_local(v, ex, ey, ez):
    """Global -> shading-local (shader-utils.h GrobalToShadingLocal)."""
    return torch.stack([vdot(v, ex), vdot(v, ey), vdot(v, ez)], dim=-1)


def to_global(v, ex, ey, ez):
    """Shading-local -> global (shader-utils.h ShadingLocalToGlobal)."""
    return v[..., 0:1] * ex + v[..., 1:2] * ey + v[..., 2:3] * ez
