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

The TPU semantics kept: lanes go in groups of 128, and a group enters a
cluster when any of its lanes' slab test passes against that lane's
running best t (the TPU's `jnp.any`), or, for any-hit, until every lane of
the group has a hit. Inside an entered cluster every lane of the group
tests all 128 segments. The TPU keeps a running best per sublane slot
(segment id mod 8) with a strict `t < best`, and at the end takes the
least t, the lowest slot on ties: the result is the lexicographic minimum
of (t, id mod 8), the first visited on a full tie.

The wrapper takes the kernel for CUDA tensors and the plain torch walk
(`_walk_ref`) for CPU tensors; `dense_curve_trace_ref` runs the plain walk
on any device, which is what the kernel is compared with on the card.
`LAUNCHES` counts kernel launches per mode.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..core.math import INF
from . import cuda_lib

LANES = 128  # rays per group (the TPU lane group; one CUDA block)
SLOTS = 8
SEG_BLOCK = 128  # sub-segments per Morton cluster
STEPS = SEG_BLOCK // SLOTS

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


def _walk_ref(segs, aabb, org, direction, min_t, max_t, any_hit=False):
    """Plain torch version of the kernel on padded lanes (N a multiple of
    128, max_t already clamped to INF). Clusters are a loop, because the
    cull reads the running best; inside an entered cluster the 128
    segments are tested at once as [G, 128 lanes, 16 steps, 8 slots]
    against the per-slot bests from before the cluster, each slot keeping
    its first least t: the same result as the TPU's 16 sequential steps,
    whose strict `t < best` only ever accepts a smaller t.

    Returns (t, u, v, sub, entered): t = max_t and sub = -1 where nothing
    was hit; entered [G] counts the clusters each group entered."""
    g = org.shape[0] // LANES
    dev = org.device

    def lanes(x):  # [N] -> [G, 128, 1, 1]
        return x.reshape(g, LANES, 1, 1)

    ox, oy, oz = (lanes(org[:, k]) for k in range(3))
    dx, dy, dz = (lanes(direction[:, k]) for k in range(3))
    mint = lanes(min_t)
    inv_x, inv_y, inv_z = (_inv(direction[:, k]).reshape(g, LANES)
                           for k in range(3))
    od = ox * dx + oy * dy + oz * dz
    oo = ox * ox + oy * oy + oz * oz

    best_t = max_t.reshape(g, LANES, 1).repeat(1, 1, SLOTS)  # [G, 128, 8]
    best_u = torch.zeros_like(best_t)
    best_v = torch.zeros_like(best_t)
    best_p = torch.full_like(best_t, -1, dtype=torch.int32)
    entered = torch.zeros((g,), dtype=torch.int32, device=dev)
    o2 = [org[:, k].reshape(g, LANES) for k in range(3)]
    mint2 = min_t.reshape(g, LANES)
    ids = torch.arange(SEG_BLOCK, dtype=torch.int32, device=dev).reshape(
        STEPS, SLOTS)
    for c in range(aabb.shape[1]):
        t0 = [(aabb[k, c] - o2[k]) * inv for k, inv in
              enumerate((inv_x, inv_y, inv_z))]
        t1 = [(aabb[k + 3, c] - o2[k]) * inv for k, inv in
              enumerate((inv_x, inv_y, inv_z))]
        tnear = torch.maximum(torch.maximum(torch.minimum(t0[0], t1[0]),
                                            torch.minimum(t0[1], t1[1])),
                              torch.minimum(t0[2], t1[2]))
        tfar = torch.minimum(torch.minimum(torch.maximum(t0[0], t1[0]),
                                           torch.maximum(t0[1], t1[1])),
                             torch.maximum(t0[2], t1[2]))
        lane_best = best_t.amin(dim=2)
        box_hit = ((tnear <= tfar * 1.00000024) & (tfar >= mint2)
                   & (tnear <= lane_best))
        do = box_hit.any(dim=1)  # [G]
        if any_hit:
            do = do & ~(best_p >= 0).any(dim=2).all(dim=1)
        entered += do.to(torch.int32)
        rows = segs[c * SEG_BLOCK:(c + 1) * SEG_BLOCK].reshape(
            1, 1, STEPS, SLOTS, 12)
        (p0x, p0y, p0z, ex, ey, ez, r0c, drc, p0e, ee, u0c,
         duc) = rows.unbind(-1)  # each [1, 1, 16, 8]
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
        rad = r0c + s * drc
        # candidates against the slot's best from before the cluster
        prev = best_t[:, :, None, :]
        hit = ((d2 <= rad * rad) & (t >= mint) & (t < prev) & (rad > 0.0)
               & do[:, None, None, None])
        tk, k = torch.where(hit, t, float("inf")).min(dim=2)  # first least
        better = tk < best_t
        if not bool(better.any()):
            continue

        def pick(x):
            x = x.expand(g, LANES, STEPS, SLOTS)
            return torch.gather(x, 2, k[:, :, None, :])[:, :, 0, :]

        cx = dy * ez - dz * ey
        cy = dz * ex - dx * ez
        cz = dx * ey - dy * ex
        det = (p0x - ox) * cx + (p0y - oy) * cy + (p0z - oz) * cz
        blen = torch.sqrt(torch.clamp(cx * cx + cy * cy + cz * cz,
                                      min=1e-20))
        voff = torch.clamp(-det / (blen * torch.clamp(rad, min=1e-12)),
                           -1.0, 1.0)
        best_u = torch.where(better, pick(u0c + s * duc), best_u)
        best_v = torch.where(better, pick(voff), best_v)
        best_p = torch.where(better, pick(
            (ids + c * SEG_BLOCK)[None, None]), best_p)
        best_t = torch.where(better, tk, best_t)
    # least t over the slots, the lowest slot on ties (argmin keeps the
    # first); a slot without a hit still holds max_t, which no hit reaches
    tmin, slot = best_t.min(dim=2)
    sel = slot[..., None]
    sub = torch.gather(best_p, 2, sel)[..., 0]
    found = sub >= 0
    u = torch.where(found, torch.gather(best_u, 2, sel)[..., 0], 0.0)
    v = torch.where(found, torch.gather(best_v, 2, sel)[..., 0], 0.0)
    return (tmin.reshape(-1), u.reshape(-1), v.reshape(-1), sub.reshape(-1),
            entered)


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
    if n % LANES:
        raise ValueError(f"{n} lanes is not a whole number of {LANES}-lane "
                         "groups")
    if segs.data_ptr() % 16:
        raise ValueError("dense_curve kernel reads the rows as float4: the "
                         "table must be 16-byte aligned")
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


def pad_rays(org, direction, min_t, max_t):
    """Pad the lanes to whole 128-lane groups as the JAX wrapper pads (org
    0, direction 1, min_t 0, max_t -1 = dead) and clamp max_t to INF."""
    n = org.shape[0]
    pad = -n % LANES

    def padded(x, value):
        if pad:
            x = torch.cat([x, x.new_full((pad,) + tuple(x.shape[1:]),
                                         value)])
        return x.contiguous()

    return (padded(org, 0.0), padded(direction, 1.0), padded(min_t, 0.0),
            torch.clamp(padded(max_t, -1.0), max=INF))


def _trace(segs, aabb, org, direction, min_t, max_t, any_hit, plain):
    n = org.shape[0]
    rays = pad_rays(org, direction, min_t, max_t)
    segs, aabb = segs.contiguous(), aabb.contiguous()
    if org.is_cuda and not plain:
        t, u, v, sub = _walk_cuda(segs, aabb, *rays, any_hit=any_hit)
    else:
        t, u, v, sub, _ = _walk_ref(segs, aabb, *rays, any_hit=any_hit)
    hit = sub[:n] >= 0
    return {"t": torch.where(hit, t[:n], INF), "u": u[:n], "v": v[:n],
            "sub": sub[:n]}


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
