"""Auto-framing pinhole camera (port of pbrlab_tpu.render.camera; reference
render.cc:132-167): screen plane sized from the scene AABB, eye at
z = bmax.z + 0.5*w*sqrt(3), jittered subpixel samples, y scanned down."""
from __future__ import annotations

import math
from typing import Tuple

import torch

from ..core.math import vnormalize


def camera_setup(aabb_min, aabb_max, width: int, height: int):
    """Returns (ray_org [3], x_corner, y_corner, z_corner, dx, dy) as 0-d
    float32 tensors on the AABB's device."""
    ext = aabb_max - aabb_min
    wide = ext[0] > ext[1]
    horizontal = torch.where(wide, ext[0], ext[1] * width / height)
    vertical = torch.where(wide, ext[0] * height / width, ext[1])
    x_center = (aabb_max[0] + aabb_min[0]) * 0.5
    y_center = (aabb_max[1] + aabb_min[1]) * 0.5
    z_center = aabb_max[2] + horizontal * 0.5 * math.sqrt(3.0)
    org = torch.stack([x_center, y_center, z_center])
    return (org, x_center - horizontal * 0.5, y_center + vertical * 0.5,
            aabb_max[2], horizontal / width, vertical / height)


def generate_rays(scene, width: int, height: int, u1, u2, lane
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Primary rays for pixel ids `lane` [N] with jitters u1/u2 [N]: lane i
    is pixel (y, x) = divmod(i, width), row-major like the reference."""
    org, x_corner, y_corner, z_corner, dx, dy = camera_setup(
        scene["aabb_min"], scene["aabb_max"], width, height)
    px = (lane % width).to(torch.float32)
    py = (lane // width).to(torch.float32)
    target = torch.stack(
        [x_corner + dx * (px + u1), y_corner - dy * (py + u2),
         z_corner.expand(lane.shape[0])], dim=-1)
    ray_org = org[None, :].expand(lane.shape[0], 3)
    return ray_org, vnormalize(target - ray_org)
