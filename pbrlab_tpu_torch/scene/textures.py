"""Bilinear texture fetch from the padded atlas stack (port of
pbrlab_tpu.scene.textures).

Reference: texture.{h,cc} FetchFloatN with clamp addressing and the
bilinear filter of image-utils.cc:99-167; pixel centres at integer + 0.5.
Textures are stacked into one [T, Hmax, Wmax, C] atlas (`scene.build`).

`build_quad_atlas` bakes each texel's clamped 2x2 neighbourhood into one
[T, H, W, 4C] row, so `fetch_float3_quad` reads one row per lane where
`fetch_float3` reads four texels; both give the same values.
"""
from __future__ import annotations

import torch


def _texel_coords(sizes, tex_id, u, v):
    """(texture row index, h, w, x, y): the lane's continuous texel
    coordinates (centres at integer + 0.5)."""
    tid = torch.clamp(tex_id, min=0).to(torch.int64)
    h = sizes[tid, 0].to(torch.float32)
    w = sizes[tid, 1].to(torch.float32)
    return tid, h, w, u * w - 0.5, v * h - 0.5


def _clip(i, hi):
    """clip(i, 0, hi) per lane, as jnp.clip."""
    return torch.minimum(torch.clamp(i, min=0), hi)


def _bilerp(c00, c10, c01, c11, fx, fy):
    fx = fx[..., None]
    fy = fy[..., None]
    return (c00 * (1 - fx) * (1 - fy) + c10 * fx * (1 - fy)
            + c01 * (1 - fx) * fy + c11 * fx * fy)


def fetch_float_n(atlas, sizes, tex_id, u, v):
    """Per-lane bilinear fetch of all atlas channels (FetchFloatN,
    texture.h:28-34). atlas [T, H, W, C], sizes [T, 2] (h, w), tex_id [N]
    (>= 0), u, v [N]; clamp addressing at each texture's own extent."""
    tid, h, w, x, y = _texel_coords(sizes, tex_id, u, v)
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    xmax = (w - 1).to(torch.int32)
    ymax = (h - 1).to(torch.int32)
    x0i = x0.to(torch.int32)
    y0i = y0.to(torch.int32)

    def at(xi, yi):
        return atlas[tid, _clip(yi, ymax).to(torch.int64),
                     _clip(xi, xmax).to(torch.int64)]

    return _bilerp(at(x0i, y0i), at(x0i + 1, y0i), at(x0i, y0i + 1),
                   at(x0i + 1, y0i + 1), x - x0, y - y0)


def fetch_float3(atlas, sizes, tex_id, u, v):
    """Per-lane bilinear RGB fetch (the first 3 atlas channels)."""
    return fetch_float_n(atlas, sizes, tex_id, u, v)[..., :3]


def build_quad_atlas(atlas, sizes):
    """Each texel's clamped 2x2 neighbourhood: [T, H, W, C] ->
    [T, H, W, 4C] (c00 c10 c01 c11), clamped at each texture's own extent
    (the textures are padded to Hmax, Wmax)."""
    t, h, w, _ = atlas.shape
    dev = atlas.device
    ti = torch.arange(t, device=dev)[:, None, None]
    yi = torch.arange(h, device=dev)[None, :, None]
    xi = torch.arange(w, device=dev)[None, None, :]
    sz = sizes.to(torch.int64)
    x1 = torch.minimum(xi + 1, sz[:, 1][:, None, None] - 1)
    y1 = torch.minimum(yi + 1, sz[:, 0][:, None, None] - 1)
    return torch.cat([atlas, atlas[ti, yi, x1], atlas[ti, y1, xi],
                      atlas[ti, y1, x1]], dim=-1)


def fetch_float3_quad(quad, sizes, tex_id, u, v):
    """Per-lane bilinear RGB fetch from the quad-texel atlas, one row per
    lane. Equal to fetch_float3, clamp addressing included: where x0 < 0
    both x corners clamp to texel 0 in the naive fetch, which is the quad
    fetch at x0 = 0 with fx = 0 (the same for y)."""
    tid, h, w, x, y = _texel_coords(sizes, tex_id, u, v)
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = torch.where(x0 < 0.0, 0.0, x - x0)
    fy = torch.where(y0 < 0.0, 0.0, y - y0)
    x0i = _clip(x0.to(torch.int32), (w - 1).to(torch.int32))
    y0i = _clip(y0.to(torch.int32), (h - 1).to(torch.int32))
    row = quad[tid, y0i.to(torch.int64), x0i.to(torch.int64)]  # [N, 4C]
    c = quad.shape[-1] // 4
    return _bilerp(row[:, 0:c], row[:, c:2 * c], row[:, 2 * c:3 * c],
                   row[:, 3 * c:4 * c], fx, fy)[..., :3]
