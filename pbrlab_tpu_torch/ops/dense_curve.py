"""dense_curve hair trace: ray-facing ribbons of linear sub-segments,
brute force over Morton clusters of 128 with a cluster AABB cull.

Port of pbrlab_tpu/ops/pallas/dense_curve.py. One kernel, written by hand
in CUDA for Hopper (`csrc/dense_curve.cu`, `dense_curve_trace`), replaces
the Pallas `_trace_kernel`: the closest hit (or any hit) of one ray per
lane against every sub-segment of the scene's hair.

The ribbon test is the Pallas body's, reduced to scalar linear forms:

    ad  = p0.d - o.d          ed = e.d         ae = p0.e - o.e
    aa  = p0.p0 - 2 o.p0 + o.o
    q   = ae - ad*ed          s  = clip(-q / (e.e - ed^2), 0, 1)
    d2  = (aa - ad^2) + 2 s q + s^2 (e.e - ed^2)
    t   = ad + s*ed           hit: d2 <= r(s)^2
    v   = -det[p0-o, d, e] / (|d x e| r)     (signed ribbon offset)

in its order of operations: d2 cancels terms of ~|p0 - o|^2 down to ~r^2,
so any algebraic rewrite gives another hit set on grazing lanes.

Segment row (12 floats): 0:3 p0 | 3:6 e | 6 r0 | 7 dr | 8 p0.e | 9 e.e |
10 u0 | 11 du. Padding rows have r0 = dr = 0 and never hit.

The walk is per ray (`csrc/per_ray.cuh` `cluster_walk`, one thread a
ray): in chunks of 256 clusters in Morton order, each lane slab-tests its
ray against the chunk's boxes (the Pallas body's `(box - o) * inv`
arithmetic) capped at its own best t, orders the clusters it enters by
entry t and tests their 128 sub-segments front to back until its best t
lies before the next entry; any-hit ends a lane's walk after the first
cluster that gives it a hit. The TPU walks 128-lane groups instead: a
group enters a cluster when any of its lanes' slab tests passes, and
every lane of the group tests all 128 segments. The TPU keeps a running
best per sublane slot (segment id mod 8) with a strict `t < best`, and
at the end takes the least t, the lowest slot on ties; one best per lane
with the rule of `per_ray.beats_ref` keeps the same lexicographic
minimum of (t, id mod 8), the first visited on a full tie. Against the
JAX package the two walks may differ on rays that graze a cluster box or
a ribbon and on full ties (ROADMAP C3).

The wrapper takes the kernel for CUDA tensors and the plain torch twin
(`_walk_ref`, each lane's own walk) for CPU tensors;
`dense_curve_trace_ref` runs the twin on any device, which is what the
kernel is compared with on the card.
`LAUNCHES` counts kernel launches per mode.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..core.math import INF
from . import cuda_lib, per_ray

SEG_BLOCK = 128  # sub-segments per Morton cluster

LAUNCHES = {"closest": 0, "any_hit": 0}


def morton_order(cent: np.ndarray) -> np.ndarray:
    """int32 order of the points [P, 3] along the 30-bit Morton curve of
    their bounding box (10 bits an axis), stable on equal codes: the
    cluster order of the dense packings (pbrlab_tpu/ops/pallas/dense.py
    :63-77, dense_curve.py's pack_segments)."""
    lo = cent.min(axis=0)
    ext = np.maximum(cent.max(axis=0) - lo, 1e-12)
    q = np.clip(((cent - lo) / ext * 1023.0).astype(np.uint64), 0, 1023)

    def spread(x):
        x = (x | (x << 16)) & np.uint64(0x30000FF)
        x = (x | (x << 8)) & np.uint64(0x300F00F)
        x = (x | (x << 4)) & np.uint64(0x30C30C3)
        x = (x | (x << 2)) & np.uint64(0x9249249)
        return x

    morton = spread(q[:, 0]) | (spread(q[:, 1]) << np.uint64(1)) \
        | (spread(q[:, 2]) << np.uint64(2))
    return np.argsort(morton, kind="stable").astype(np.int32)


def pack_segments(flat):
    """Host side: Morton-sort the sub-segments, pack rows + cluster AABBs.

    `flat` is the dict of ops.curves.flatten_curves. Returns (packed
    [Cpad, 12], cluster_aabb [8, M], order [C])."""
    p0 = np.asarray(flat["curve_p0"], np.float32)
    p1 = np.asarray(flat["curve_p1"], np.float32)
    r0 = np.asarray(flat["curve_r0"], np.float32)
    r1 = np.asarray(flat["curve_r1"], np.float32)
    u0 = np.asarray(flat["curve_u0"], np.float32)
    u1 = np.asarray(flat["curve_u1"], np.float32)
    C = p0.shape[0]
    if C == 0:
        packed = np.zeros((SEG_BLOCK, 12), np.float32)
        aabb = np.zeros((8, 1), np.float32)
        aabb[0:3] = 1e30
        aabb[3:6] = -1e30
        return packed, aabb, np.zeros((0,), np.int32)

    order = morton_order(0.5 * (p0 + p1))
    p0, p1, r0, r1, u0, u1 = (a[order] for a in (p0, p1, r0, r1, u0, u1))
    e = p1 - p0
    Cpad = (C + SEG_BLOCK - 1) // SEG_BLOCK * SEG_BLOCK
    packed = np.zeros((Cpad, 12), np.float32)
    packed[:C, 0:3] = p0
    packed[:C, 3:6] = e
    packed[:C, 6] = r0
    packed[:C, 7] = r1 - r0
    packed[:C, 8] = (p0 * e).sum(-1)
    packed[:C, 9] = (e * e).sum(-1)
    packed[:C, 10] = u0
    packed[:C, 11] = u1 - u0

    M = Cpad // SEG_BLOCK
    aabb = np.zeros((8, M), np.float32)
    aabb[0:3] = 1e30  # a cluster of padding only: an empty box
    aabb[3:6] = -1e30
    for c in range(M):
        s, t = c * SEG_BLOCK, min((c + 1) * SEG_BLOCK, C)
        if s < C:
            rmax = np.maximum(r0[s:t], r1[s:t])[:, None]
            aabb[0:3, c] = np.minimum(p0[s:t] - rmax,
                                      p1[s:t] - rmax).min(axis=0)
            aabb[3:6, c] = np.maximum(p0[s:t] + rmax,
                                      p1[s:t] + rmax).max(axis=0)
    return packed, aabb, order


def _inv(d):
    """The Pallas body's 1 / where(|d| < 1e-12, 1e-12, d): a tiny negative
    component becomes +1e-12, not -1e-12."""
    return 1.0 / torch.where(torch.abs(d) < 1e-12, 1e-12, d)


def _walk_ref(segs, aabb, org, direction, min_t, max_t, any_hit=False,
              counts=False):
    """Plain torch twin of the kernel (max_t already clamped to INF): each
    lane's walk (`per_ray.cluster_walk` over `per_ray.diff_enter`), a
    cluster's 128 ribbons tested as one [k, 128] block with the kernel's
    operations and kept with `per_ray.beats_ref`. Returns (t, u, v, sub)
    and, with counts, [N, 3] int64 per lane: ray-ribbon tests, ray-box
    tests, 0. t = max_t and sub = -1 where nothing was hit."""
    o = [org[:, k] for k in range(3)]
    d = [direction[:, k] for k in range(3)]
    lane = (*o, *d, min_t, o[0] * d[0] + o[1] * d[1] + o[2] * d[2],
            o[0] * o[0] + o[1] * o[1] + o[2] * o[2])  # ..., o.d, o.o
    table = segs.reshape(-1, SEG_BLOCK, 12)
    cols = torch.arange(SEG_BLOCK, device=org.device)

    def visit(ln, c, best):
        ox, oy, oz, dx, dy, dz, mint, od, oo = (x[ln, None] for x in lane)
        (p0x, p0y, p0z, ex, ey, ez, r0, dr, p0e, ee, u0,
         du) = table[c].unbind(-1)  # each [k, 128]
        ad = (p0x * dx + p0y * dy + p0z * dz) - od
        ed = ex * dx + ey * dy + ez * dz
        ae = p0e - (ex * ox + ey * oy + ez * oz)
        aa = ((p0x * p0x + p0y * p0y + p0z * p0z)
              - 2.0 * (p0x * ox + p0y * oy + p0z * oz) + oo)
        ep2 = torch.clamp(ee - ed * ed, min=1e-12)
        q = ae - ad * ed
        s = torch.clamp(-q / ep2, 0.0, 1.0)
        d2 = (aa - ad * ad) + 2.0 * s * q + s * s * ep2
        t = ad + s * ed
        rad = r0 + s * dr
        # signed ribbon offset: the triple product -det[p0 - o, d, e]
        cx = dy * ez - dz * ey
        cy = dz * ex - dx * ez
        cz = dx * ey - dy * ex
        det = (p0x - ox) * cx + (p0y - oy) * cy + (p0z - oz) * cz
        blen = torch.sqrt(torch.clamp(cx * cx + cy * cy + cz * cz,
                                      min=1e-20))
        voff = torch.clamp(-det / (blen * torch.clamp(rad, min=1e-12)),
                           -1.0, 1.0)
        ok = (d2 <= rad * rad) & (t >= mint) & (rad > 0.0)
        per_ray.beats_ref(ln, c[:, None] * SEG_BLOCK + cols, t, ok,
                          u0 + s * du, voff, best)

    return per_ray.cluster_walk(
        aabb.shape[1], SEG_BLOCK, per_ray.diff_enter(aabb, org,
                                                     _inv(direction), min_t),
        visit, min_t, max_t, any_hit=any_hit, counts=counts)


_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGS = [_P, _P, _I, _P, _P, _P, _P, _I, _I, _P, _P, _P, _P, _P]


def _walk_cuda(segs, aabb, org, direction, min_t, max_t, any_hit=False):
    """Launch the dense_curve kernel on the current stream; same first
    four returns as `_walk_ref`."""
    dev = org.device
    n = org.shape[0]
    m = aabb.shape[1]
    f32 = torch.float32
    check = cuda_lib.check_tensor
    check("dense_curve", segs, f32, (m * SEG_BLOCK, 12), dev)
    check("dense_curve", aabb, f32, (8, m), dev)
    for x, shape in ((org, (n, 3)), (direction, (n, 3)), (min_t, (n,)),
                     (max_t, (n,))):
        check("dense_curve", x, f32, shape, dev)
    cuda_lib.check_float4_rows("dense_curve", segs, 12)  # 3 float4 a row
    t = torch.empty((n,), dtype=f32, device=dev)
    u = torch.empty_like(t)
    v = torch.empty_like(t)
    sub = torch.empty((n,), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = cuda_lib.function("dense_curve_trace", _ARGS)(
            segs.data_ptr(), aabb.data_ptr(), m, org.data_ptr(),
            direction.data_ptr(), min_t.data_ptr(), max_t.data_ptr(),
            int(any_hit), n, t.data_ptr(), u.data_ptr(), v.data_ptr(),
            sub.data_ptr(), stream)
    kind = "any_hit" if any_hit else "closest"
    cuda_lib.launched(f"dense_curve {kind}", rc)
    LAUNCHES[kind] += 1
    return t, u, v, sub


def clamped_rays(org, direction, min_t, max_t):
    """The kernels' ray arrays: contiguous, max_t clamped to INF."""
    return (org.contiguous(), direction.contiguous(), min_t.contiguous(),
            torch.clamp(max_t, max=INF))


def _trace(segs, aabb, org, direction, min_t, max_t, any_hit, plain):
    walk = _walk_cuda if org.is_cuda and not plain else _walk_ref
    t, u, v, sub = walk(segs.contiguous(), aabb.contiguous(),
                        *clamped_rays(org, direction, min_t, max_t),
                        any_hit=any_hit)
    return {"t": torch.where(sub >= 0, t, INF), "u": u, "v": v, "sub": sub}


def dense_curve_trace(packed_segs, cluster_aabb, org, direction, min_t,
                      max_t, any_hit=False):
    """Closest (or any) hit vs hair sub-segments -> dict(t, u, v, sub):
    sub is the SORTED sub-segment id (-1 on a miss, t = INF there); the
    caller maps it to the source segment and tangent (curve_sub_fat)."""
    return _trace(packed_segs, cluster_aabb, org, direction, min_t, max_t,
                  any_hit, plain=False)


def dense_curve_trace_ref(packed_segs, cluster_aabb, org, direction, min_t,
                          max_t, any_hit=False):
    """Plain torch version of `dense_curve_trace` on any device."""
    return _trace(packed_segs, cluster_aabb, org, direction, min_t, max_t,
                  any_hit, plain=True)
