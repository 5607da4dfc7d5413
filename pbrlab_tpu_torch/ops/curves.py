"""Hair curves: flattening on the host (numpy) and the curve-BVH walk
(torch; port of pbrlab_tpu.ops.curves).

Replaces Embree's flat Bezier curves (raytracer_impl.cc:154-197): at
commit each cubic Bezier segment becomes CURVE_SUBDIV linear sub-segments
with lerped radii, tested on the device as ray-facing ribbons
(`_ribbon_intersect`): a ray hits a sub-segment where its
ray-perpendicular projection passes within the local radius.

Two walks find them: the dense_curve kernel over Morton clusters
(ops/dense_curve.py), which every triangle backend but "bvh" uses, and
`curve_trace`, the JAX package's walk of the sub-segments' threaded BVH
(`cbvh_*` of `commit_curves`), which the "bvh" backend uses, as the JAX
package does under it. `curve_trace` launches the `curve_bvh_trace`
kernel of `csrc/bvh_walk.cu` on CUDA tensors and runs its plain torch
twin (`bvh_walk.walk_ref` with `_ribbon_intersect`) on CPU tensors; the
two differ from dense_curve on grazing lanes, as the JAX package's do,
since dense_curve expands d2 (ROADMAP C7).
"""
from __future__ import annotations

import numpy as np
import torch

from .bvh_walk import cross3, dot3, safe_inv, walk_cuda, walk_ref

CURVE_SUBDIV = 8
CBVH_TABLES = ("cbvh_min", "cbvh_max", "cbvh_skip", "cbvh_prim_offset",
               "cbvh_prim_ids")
CURVE_COLUMNS = ("curve_p0", "curve_p1", "curve_r0", "curve_r1",
                 "curve_u0", "curve_u1")


def flatten_curves(curve_pts: np.ndarray):
    """[S, 4, 4] Bezier control points (xyz + radius) -> dict of numpy
    sub-segment arrays: curve_p0, curve_p1 [C, 3], curve_r0, curve_r1 [C],
    curve_seg [C] (source segment id), curve_u0, curve_u1 [C]."""
    S = curve_pts.shape[0]
    if S == 0:
        return {
            "curve_p0": np.zeros((0, 3), np.float32),
            "curve_p1": np.zeros((0, 3), np.float32),
            "curve_r0": np.zeros((0,), np.float32),
            "curve_r1": np.zeros((0,), np.float32),
            "curve_seg": np.zeros((0,), np.int32),
            "curve_u0": np.zeros((0,), np.float32),
            "curve_u1": np.zeros((0,), np.float32),
        }
    t = np.linspace(0.0, 1.0, CURVE_SUBDIV + 1, dtype=np.float32)
    # cubic Bezier basis [K+1, 4]
    b = np.stack([(1 - t) ** 3, 3 * t * (1 - t) ** 2, 3 * t ** 2 * (1 - t),
                  t ** 3], axis=-1)
    pts = np.einsum("kc,scq->skq", b, curve_pts)  # [S, K+1, 4]
    p = pts[..., :3]
    r = pts[..., 3]
    return {
        "curve_p0": p[:, :-1].reshape(-1, 3).astype(np.float32),
        "curve_p1": p[:, 1:].reshape(-1, 3).astype(np.float32),
        "curve_r0": r[:, :-1].reshape(-1).astype(np.float32),
        "curve_r1": r[:, 1:].reshape(-1).astype(np.float32),
        "curve_seg": np.repeat(np.arange(S, dtype=np.int32), CURVE_SUBDIV),
        "curve_u0": np.tile(t[:-1], S).astype(np.float32),
        "curve_u1": np.tile(t[1:], S).astype(np.float32),
    }


def subsegment_bounds(flat):
    """Per sub-segment AABB (bmin, bmax) [C, 3] of both end spheres."""
    bmin = np.minimum(flat["curve_p0"] - flat["curve_r0"][:, None],
                      flat["curve_p1"] - flat["curve_r1"][:, None])
    bmax = np.maximum(flat["curve_p0"] + flat["curve_r0"][:, None],
                      flat["curve_p1"] + flat["curve_r1"][:, None])
    return bmin, bmax


def _ribbon_intersect(org, direction, p0, p1, r0, r1, min_t, max_t):
    """Ray vs ray-facing ribbon around segment [p0, p1], lanes x prims
    (org / direction [..., 3], p0 / p1 [..., 3], r0 / r1 [...], all
    broadcast) -> (hit, t, s, v_signed): s the axis parameter in [0, 1],
    v_signed the ribbon offset in [-1, 1] (the hair BSDF's h)."""
    a = p0 - org
    b = p1 - org
    ad = dot3(a, direction)
    bd = dot3(b, direction)
    a_perp = a - ad[..., None] * direction
    b_perp = b - bd[..., None] * direction
    seg = b_perp - a_perp
    denom = dot3(seg, seg)
    s = -dot3(a_perp, seg) / torch.clamp(denom, min=1e-12)
    s = torch.where(denom > 1e-12, torch.clamp(s, 0.0, 1.0), 0.0)
    closest = a_perp + s[..., None] * seg
    d2 = dot3(closest, closest)
    r = r0 + (r1 - r0) * s
    t = ad + s * (bd - ad)
    hit = (d2 <= r * r) & (t >= min_t) & (t <= max_t) & (r > 0.0)
    # signed offset: the sign from the (direction x tangent) bitangent; the
    # offset from the axis point to the ray line is -closest
    bitangent = cross3(direction, p1 - p0)
    bit_len = torch.sqrt(torch.clamp(dot3(bitangent, bitangent), min=1e-20))
    v_signed = -dot3(closest, bitangent) / (bit_len
                                            * torch.clamp(r, min=1e-12))
    return hit, t, s, torch.clamp(v_signed, -1.0, 1.0)


def _curve_walk_ref(tree, cols, org, direction, min_t, max_t, any_hit=False,
                    counts=False):
    """The plain torch twin of the `curve_bvh_trace` kernel: the walk with
    the ribbon leaf test, u = u0 + (u1 - u0) s; returns (t, u, v, sub)
    and, with counts, the [N, 2] per-lane (ribbon, box) tests."""
    p0, p1, r0, r1, u0, u1 = cols

    def leaf(ln, pid, cap):
        safe = pid.clamp(min=0)
        hit, t, s, v = _ribbon_intersect(
            org[ln, None], direction[ln, None], p0[safe], p1[safe], r0[safe],
            r1[safe], min_t[ln, None], cap[:, None])
        return hit, t, u0[safe] + (u1[safe] - u0[safe]) * s, v

    return walk_ref(tree, leaf, org, safe_inv(direction, 1e-12), min_t,
                    max_t, any_hit=any_hit, counts=counts)


def curve_trace(scene, org, direction, min_t, max_t, any_hit=False,
                plain=False):
    """Closest (or any) hit over the hair sub-segments through the curve
    BVH -> dict(t, u, v, seg, tangent): seg the source Bezier segment (-1
    and t = INF on a miss), u the curve parameter, v the signed ribbon
    offset, tangent the unit (p1 - p0) of the hit sub-segment (of
    sub-segment 0 on a miss). The `curve_bvh_trace` kernel on CUDA
    tensors unless plain, else its twin."""
    tree = [scene[k].contiguous() for k in CBVH_TABLES]
    cols = [scene[k].contiguous() for k in CURVE_COLUMNS]
    rays = [x.contiguous() for x in (org, direction, min_t, max_t)]
    if org.is_cuda and not plain:
        t, u, v, sub = walk_cuda("curve_bvh_trace", tree, cols, *rays,
                                 any_hit=any_hit)
    else:
        t, u, v, sub = _curve_walk_ref(tree, cols, *rays, any_hit=any_hit)
    safe = torch.clamp(sub, min=0).to(torch.int64)
    tangent = scene["curve_p1"][safe] - scene["curve_p0"][safe]
    tlen = torch.sqrt(torch.clamp(dot3(tangent, tangent), min=1e-20))
    return {"t": t, "u": u, "v": v,
            "seg": torch.where(sub >= 0, scene["curve_seg"][safe], -1),
            "tangent": tangent / tlen[..., None]}
