"""Legacy dense v1 triangle trace, and what the three legacy traces
share: the tables, the ray-triangle test, the per-ray twin and the launch.

Port of pbrlab_tpu/ops/pallas/dense.py. One kernel template, written by
hand in CUDA for Hopper (`csrc/dense_legacy.cu` `legacy_kernel`), replaces
the Pallas `_trace_kernel`s of dense.py (`dense_v1_trace`, here),
dense_v2.py (`dense_v2_trace`, `ops/dense_v2.py`) and dense_v3.py
(`dense_v3_trace`, `ops/dense_v3.py`). The JAX package reaches v1 only
from its own tests; its `pack_triangles` builds the `dense_tris` /
`dense_cluster_aabb` / `dense_order` tables that `commit` adds to every
scene and that all three trace.

Triangles are Morton-sorted and stored as linear forms, one column each
of `packed [12, Fpad]` (Fpad a multiple of 128; padding columns are zero):

    den = n.d        num = k0 - n.o        t = num / den
    u   = (b1.o - c1) + t (b1.d)           v = (b2.o - c2) + t (b2.d)

rows 0:3 n, 3 k0 (= n.v0), 4:7 b1, 7 c1 (= b1.v0), 8:11 b2, 11 c2.

The walk is per ray (`csrc/per_ray.cuh` `cluster_walk`, one thread a
ray; its twin `walk_ref`): in chunks of 256 clusters in cluster order,
each lane slab-tests its ray against the chunk's boxes (the Pallas
bodies' `(box - o) * inv` arithmetic) capped at its own best t, orders
the clusters it enters by entry t and tests their 128 triangles front to
back until its best t lies before the next entry; any-hit ends a lane's
walk after the first cluster that gives it a hit. The TPU walks groups
instead (v1: an aligned block of 8 rays enters a cluster when any of its
rays' boxes passes against that ray's max t), and every ray of a group
tests every triangle of every cluster its group enters.

Ties (`per_ray.TieRule`): v1's TPU body keeps one best per triangle lane
(id mod 128) with a strict `t < best`, in cluster order, from INF with
the bound t <= max_t, and at the end takes the least t, the lowest lane
on ties: the lexicographic minimum of (t, id mod 128, id), which no visit
order changes, up to max_t inclusive (`V1_RULE`). A hit needs |den| >
1e-12, u, v >= 0, u + v <= 1 and t >= min_t. The any_hit flag is
accepted and ignored, as in the JAX package: the answer is the closest
hit. Against the JAX package the walks may differ on rays that graze a
cluster box (ROADMAP C3). prim is the id in the SORTED order, int32
(float32 on the TPU: ROADMAP C9); the caller maps it back through
`order` (the scene's `dense_order`).

The wrapper takes the kernel for CUDA tensors and the twin (`_walk_ref`)
for CPU tensors; `dense_trace_ref` runs the twin on any device, which is
what the kernel is compared with on the card. `LAUNCHES` counts kernel
launches per mode.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..core.math import INF
from . import cuda_lib, per_ray
from .dense_curve import _inv, clamped_rays, morton_order

TRI_BLOCK = 128  # triangles per cluster (the TPU's lane count)
V1_RULE = per_ray.TieRule(slots=TRI_BLOCK, by_id=True, up_to=True)

LAUNCHES = {"closest": 0, "any_hit": 0}


def pack_triangles(tri_v0: np.ndarray, tri_e1: np.ndarray,
                   tri_e2: np.ndarray):
    """Host side: Morton-sort the triangles, precompute their linear forms,
    cluster by 128. Returns (packed [12, Fpad], cluster_aabb [8, M], order
    [F] original ids); padding columns are zero (den = 0: never a hit)."""
    F = tri_v0.shape[0]
    if F == 0:
        packed = np.zeros((12, TRI_BLOCK), np.float32)
        packed[3] = -1.0  # k0; den == 0 -> miss anyway
        aabb = np.zeros((8, 1), np.float32)
        aabb[0:3] = 1e30
        aabb[3:6] = -1e30
        return packed, aabb, np.zeros((0,), np.int32)

    order = morton_order(tri_v0 + (tri_e1 + tri_e2) / 3.0)
    v0 = tri_v0[order]
    e1 = tri_e1[order]
    e2 = tri_e2[order]
    n = np.cross(e1, e2)
    nn = np.maximum((n * n).sum(-1, keepdims=True), 1e-30)
    b1 = np.cross(e2, n) / nn
    b2 = np.cross(n, e1) / nn

    Fpad = (F + TRI_BLOCK - 1) // TRI_BLOCK * TRI_BLOCK
    packed = np.zeros((12, Fpad), np.float32)
    packed[0:3, :F] = n.T
    packed[3, :F] = (n * v0).sum(-1)
    packed[4:7, :F] = b1.T
    packed[7, :F] = (b1 * v0).sum(-1)
    packed[8:11, :F] = b2.T
    packed[11, :F] = (b2 * v0).sum(-1)

    M = Fpad // TRI_BLOCK
    aabb = np.zeros((8, M), np.float32)
    vall = np.stack([v0, v0 + e1, v0 + e2], axis=1)  # [F, 3, 3]
    for c in range(M):
        s, e = c * TRI_BLOCK, min((c + 1) * TRI_BLOCK, F)
        if s < F:
            pts = vall[s:e].reshape(-1, 3)
            aabb[0:3, c] = pts.min(axis=0)
            aabb[3:6, c] = pts.max(axis=0)
        else:
            aabb[0:3, c] = 1e30
            aabb[3:6, c] = -1e30
    return packed, aabb, order


def tri_test(rows, o, d, mint):
    """The Pallas bodies' ray-triangle test in their order of operations:
    rows the 12 linear-form rows (broadcast against the lanes' o, d and
    mint) -> (t, u, v, ok), ok without the upper bound on t."""
    nx, ny, nz, k0, b1x, b1y, b1z, c1, b2x, b2y, b2z, c2 = rows
    ox, oy, oz = o
    dx, dy, dz = d
    den = dx * nx + dy * ny + dz * nz
    num = k0 - (ox * nx + oy * ny + oz * nz)
    t = num / torch.where(torch.abs(den) < 1e-12, 1e-12, den)
    u = (ox * b1x + oy * b1y + oz * b1z) - c1 \
        + t * (dx * b1x + dy * b1y + dz * b1z)
    v = (ox * b2x + oy * b2y + oz * b2z) - c2 \
        + t * (dx * b2x + dy * b2y + dz * b2z)
    ok = ((torch.abs(den) > 1e-12) & (u >= 0.0) & (v >= 0.0)
          & (u + v <= 1.0) & (t >= mint))
    return t, u, v, ok


def walk_ref(rule, tris, aabb, org, direction, min_t, max_t,
             any_hit=False, counts=False):
    """Plain torch twin of the legacy kernels with tie rule `rule` (max_t
    already clamped to INF): each lane's walk (`per_ray.cluster_walk` over
    `per_ray.diff_enter`), a cluster's 128 triangles tested as one [k, 128]
    block with the Pallas bodies' operations (`tri_test`) and kept with
    `per_ray.beats_ref`. Returns (t, u, v, prim) and, with counts, [N, 3]
    int64 per lane: ray-triangle tests, ray-box tests, 0. t = max_t and
    prim = -1 where nothing was hit."""
    o = [org[:, k:k + 1] for k in range(3)]
    d = [direction[:, k:k + 1] for k in range(3)]
    mint = min_t[:, None]
    cols = torch.arange(TRI_BLOCK, device=org.device)

    def visit(ln, c, best):
        ids = c[:, None] * TRI_BLOCK + cols  # [k, 128]
        t, u, v, ok = tri_test(tris[:, ids].unbind(0), [x[ln] for x in o],
                               [x[ln] for x in d], mint[ln])
        per_ray.beats_ref(ln, ids, t, ok, u, v, best, rule)

    return per_ray.cluster_walk(
        aabb.shape[1], TRI_BLOCK,
        per_ray.diff_enter(aabb, org, _inv(direction), min_t), visit, min_t,
        max_t, any_hit=any_hit, counts=counts)


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# tris, fpad, aabb, clusters, org, dir, min_t, max_t, v1's inf or v2 / v3's
# any_hit, n, outs, stream
_ARGS = [_P, _I, _P, _I, _P, _P, _P, _P, _F, _I, _P, _P, _P, _P, _P]


def launch(name, flag, tris, aabb, org, direction, min_t, max_t):
    """Launch the legacy kernel `name` (dense_v1_trace, dense_v2_trace or
    dense_v3_trace) on the current stream, flag its ninth argument (v1's
    INF, a float; v2's and v3's any_hit, an int); raises on a launch
    error. Returns (t, u, v, prim) as `walk_ref`."""
    label = name.removesuffix("_trace").replace("_", " ")
    dev = org.device
    n = org.shape[0]
    m = aabb.shape[1]
    f32 = torch.float32
    check = cuda_lib.check_tensor
    check(label, tris, f32, (12, m * TRI_BLOCK), dev)
    check(label, aabb, f32, (8, m), dev)
    for x, shape in ((org, (n, 3)), (direction, (n, 3)), (min_t, (n,)),
                     (max_t, (n,))):
        check(label, x, f32, shape, dev)
    # cluster c's columns start at 128 c: one float4 is 4 triangles
    cuda_lib.check_float4_rows(label, tris, tris.shape[1])
    t = torch.empty((n,), dtype=f32, device=dev)
    u = torch.empty_like(t)
    v = torch.empty_like(t)
    prim = torch.empty((n,), dtype=torch.int32, device=dev)
    args = list(_ARGS)
    args[8] = _F if isinstance(flag, float) else _I
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = cuda_lib.function(name, args)(
            tris.data_ptr(), tris.shape[1], aabb.data_ptr(), m,
            org.data_ptr(), direction.data_ptr(), min_t.data_ptr(),
            max_t.data_ptr(), flag, n, t.data_ptr(), u.data_ptr(),
            v.data_ptr(), prim.data_ptr(), stream)
    cuda_lib.launched(label, rc)
    return t, u, v, prim


def trace(walk_cuda, walk_ref_, packed, aabb, org, direction, min_t, max_t,
          any_hit, plain):
    """A legacy wrapper: the kernel (walk_cuda) for CUDA tensors unless
    plain, else the twin (walk_ref_), on the clamped rays -> dict(t, u, v,
    prim), t = INF and prim = -1 on a miss."""
    walk = walk_cuda if org.is_cuda and not plain else walk_ref_
    t, u, v, prim = walk(packed.contiguous(), aabb.contiguous(),
                         *clamped_rays(org, direction, min_t, max_t),
                         any_hit=any_hit)
    return {"t": torch.where(prim >= 0, t, INF), "u": u, "v": v,
            "prim": prim}


def _walk_ref(tris, aabb, org, direction, min_t, max_t, any_hit=False,
              counts=False):
    """The v1 twin (`walk_ref` with V1_RULE, any_hit ignored): t = INF
    where nothing was hit, as the kernel writes it."""
    out = walk_ref(V1_RULE, tris, aabb, org, direction, min_t, max_t,
                   counts=counts)
    return (torch.where(out[3] >= 0, out[0], INF), *out[1:])


def _walk_cuda(tris, aabb, org, direction, min_t, max_t, any_hit=False):
    """Launch the dense v1 kernel; same first four returns as `_walk_ref`
    (any_hit only picks the launch counter)."""
    out = launch("dense_v1_trace", INF, tris, aabb, org, direction, min_t,
                 max_t)
    LAUNCHES["any_hit" if any_hit else "closest"] += 1
    return out


def dense_trace(packed_tris, cluster_aabb, org, direction, min_t, max_t,
                any_hit=False):
    """Closest hit of rays vs the packed triangle set -> dict(t, u, v,
    prim): prim indexes the SORTED order (-1 and t = INF on a miss).
    any_hit is accepted and ignored, as in the JAX package."""
    return trace(_walk_cuda, _walk_ref, packed_tris, cluster_aabb, org,
                 direction, min_t, max_t, any_hit, plain=False)


def dense_trace_ref(packed_tris, cluster_aabb, org, direction, min_t, max_t,
                    any_hit=False):
    """Plain torch version of `dense_trace` on any device."""
    return trace(_walk_cuda, _walk_ref, packed_tris, cluster_aabb, org,
                 direction, min_t, max_t, any_hit, plain=True)
