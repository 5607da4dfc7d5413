"""Legacy dense v1 triangle trace: 8-ray blocks against every 128-triangle
Morton cluster, with a per-block slab cull.

Port of pbrlab_tpu/ops/pallas/dense.py. One kernel, written by hand in
CUDA for Hopper (`csrc/dense_legacy.cu`, `dense_v1_trace`), replaces the
Pallas `_trace_kernel`. The JAX package reaches that kernel only from its
own tests; its `pack_triangles` builds the `dense_tris` /
`dense_cluster_aabb` / `dense_order` tables that `commit` adds to every
scene and that the v2 and v3 backends (`ops/dense_v2.py`,
`ops/dense_v3.py`) trace.

Triangles are Morton-sorted and stored as linear forms, one column each
of `packed [12, Fpad]` (Fpad a multiple of 128; padding columns are zero):

    den = n.d        num = k0 - n.o        t = num / den
    u   = (b1.o - c1) + t (b1.d)           v = (b2.o - c2) + t (b2.d)

rows 0:3 n, 3 k0 (= n.v0), 4:7 b1, 7 c1 (= b1.v0), 8:11 b2, 11 c2.

The TPU semantics kept: an aligned block of 8 rays enters cluster c when
any of its rays' slab tests passes against that ray's max t (not its
running best), and then each of the 8 rays tests all 128 triangles. A hit
needs |den| > 1e-12, u, v >= 0, u + v <= 1 and min_t <= t <= max_t. The
TPU keeps one best per triangle lane (id mod 128), strict `t < best` in
cluster order, and at the end takes the least t, the lowest lane on ties:
the lexicographic minimum of (t, id mod 128, cluster). The any_hit flag is
accepted and ignored, as in the JAX package: the answer is the closest
hit. prim is the id in the SORTED order; the caller maps it back through
`order` (the scene's `dense_order`).

The wrapper takes the kernel for CUDA tensors and the plain torch version
(`_walk_ref`) for CPU tensors; `dense_trace_ref` runs the plain version on
any device, which is what the kernel is compared with on the card.
`LAUNCHES` counts kernel launches per mode.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..core.math import INF
from . import cuda_lib
from .dense_curve import _inv, morton_order

TRI_BLOCK = 128  # triangles per cluster (the TPU's lane count)
LANES = 128  # rays per padded group (the TPU lane group; one CUDA block)
RAY_BLOCK = 8  # rays that decide a cluster together (the TPU's sublanes)
SLOP = 1.00000024  # the slab test's relative tolerance on tfar

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


def slab(aabb, c, o, inv):
    """The Pallas bodies' slab test of every lane against cluster c:
    (tnear, tfar), with o and inv the lanes' origin and inverse direction
    components (any shape)."""
    t0 = [(aabb[k, c] - o[k]) * inv[k] for k in range(3)]
    t1 = [(aabb[k + 3, c] - o[k]) * inv[k] for k in range(3)]
    tnear = torch.maximum(torch.maximum(torch.minimum(t0[0], t1[0]),
                                        torch.minimum(t0[1], t1[1])),
                          torch.minimum(t0[2], t1[2]))
    tfar = torch.minimum(torch.minimum(torch.maximum(t0[0], t1[0]),
                                       torch.maximum(t0[1], t1[1])),
                         torch.maximum(t0[2], t1[2]))
    return tnear, tfar


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


def _walk_ref(tris, aabb, org, direction, min_t, max_t, any_hit=False):
    """Plain torch version of the kernel on padded lanes (a multiple of 8,
    max_t clamped to INF): for each cluster, the block vote, then all
    lanes against its 128 triangles at once as [N, 128], one running best
    per (ray, triangle lane) as on the TPU; any_hit is ignored. Returns
    (t, u, v, prim): t = INF and prim = -1 where nothing was hit, u = v =
    0 there."""
    n = org.shape[0]
    dev = org.device
    o = [org[:, k:k + 1] for k in range(3)]  # [N, 1]
    d = [direction[:, k:k + 1] for k in range(3)]
    inv = [_inv(x) for x in d]
    mint, maxt = min_t[:, None], max_t[:, None]
    best_t = torch.full((n, TRI_BLOCK), INF, device=dev)
    best_u = torch.zeros_like(best_t)
    best_v = torch.zeros_like(best_t)
    best_c = torch.zeros((n, TRI_BLOCK), dtype=torch.int32, device=dev)
    for c in range(aabb.shape[1]):
        tnear, tfar = slab(aabb, c, o, inv)
        box_hit = (tnear <= tfar * SLOP) & (tfar >= mint) & (tnear <= maxt)
        do = box_hit.reshape(-1, RAY_BLOCK).any(dim=1).repeat_interleave(
            RAY_BLOCK)[:, None]
        rows = tris[:, c * TRI_BLOCK:(c + 1) * TRI_BLOCK][:, None, :]
        t, u, v, ok = tri_test(rows, o, d, mint)
        hit = ok & (t <= maxt) & (t < best_t) & do
        best_u = torch.where(hit, u, best_u)
        best_v = torch.where(hit, v, best_v)
        best_c = torch.where(hit, c, best_c)
        best_t = torch.where(hit, t, best_t)
    # least t over the triangle lanes, the lowest lane on ties
    tmin = best_t.amin(dim=1, keepdim=True)
    lane = torch.arange(TRI_BLOCK, dtype=torch.int32, device=dev)
    first = torch.where(best_t == tmin, lane, TRI_BLOCK).amin(
        dim=1, keepdim=True).to(torch.int64)
    found = tmin[:, 0] < INF

    def pick(x):
        return torch.gather(x, 1, first)[:, 0]

    prim = torch.where(found, pick(best_c) * TRI_BLOCK + first[:, 0], -1)
    return (tmin[:, 0], pick(best_u), pick(best_v), prim.to(torch.int32))


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGS = [_P, _I, _P, _I, _P, _P, _P, _P, _F, _I, _P, _P, _P, _P, _P]


def _walk_cuda(tris, aabb, org, direction, min_t, max_t, any_hit=False):
    """Launch the dense v1 kernel on the current stream; same returns as
    `_walk_ref` (any_hit only picks the launch counter)."""
    dev = org.device
    n = org.shape[0]
    m = aabb.shape[1]
    f32 = torch.float32
    check = cuda_lib.check_tensor
    check("dense v1", tris, f32, (12, m * TRI_BLOCK), dev)
    check("dense v1", aabb, f32, (8, m), dev)
    for x, shape in ((org, (n, 3)), (direction, (n, 3)), (min_t, (n,)),
                     (max_t, (n,))):
        check("dense v1", x, f32, shape, dev)
    if n % TRI_BLOCK:
        raise ValueError(f"{n} lanes is not a whole number of {TRI_BLOCK}-"
                         "lane blocks")
    t = torch.empty((n,), dtype=f32, device=dev)
    u = torch.empty_like(t)
    v = torch.empty_like(t)
    prim = torch.empty((n,), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = cuda_lib.function("dense_v1_trace", _ARGS)(
            tris.data_ptr(), tris.shape[1], aabb.data_ptr(), m,
            org.data_ptr(), direction.data_ptr(), min_t.data_ptr(),
            max_t.data_ptr(), INF, n, t.data_ptr(), u.data_ptr(),
            v.data_ptr(), prim.data_ptr(), stream)
    kind = "any_hit" if any_hit else "closest"
    cuda_lib.launched(f"dense v1 {kind}", rc)
    LAUNCHES[kind] += 1
    return t, u, v, prim


def pad_rays(org, direction, min_t, max_t):
    """Pad the lanes to whole 128-lane groups as the JAX wrappers pad (org
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


def finish(t, u, v, prim, n):
    """Unpad and give t = INF on a miss (the JAX wrappers' outputs)."""
    hit = prim[:n] >= 0
    return {"t": torch.where(hit, t[:n], INF), "u": u[:n], "v": v[:n],
            "prim": prim[:n]}


def _trace(packed, aabb, org, direction, min_t, max_t, any_hit, plain):
    n = org.shape[0]
    rays = pad_rays(org, direction, min_t, max_t)
    packed, aabb = packed.contiguous(), aabb.contiguous()
    walk = _walk_cuda if org.is_cuda and not plain else _walk_ref
    return finish(*walk(packed, aabb, *rays, any_hit=any_hit), n)


def dense_trace(packed_tris, cluster_aabb, org, direction, min_t, max_t,
                any_hit=False):
    """Closest hit of rays vs the packed triangle set -> dict(t, u, v,
    prim): prim indexes the SORTED order (-1 and t = INF on a miss).
    any_hit is accepted and ignored, as in the JAX package."""
    return _trace(packed_tris, cluster_aabb, org, direction, min_t, max_t,
                  any_hit, plain=False)


def dense_trace_ref(packed_tris, cluster_aabb, org, direction, min_t, max_t,
                    any_hit=False):
    """Plain torch version of `dense_trace` on any device."""
    return _trace(packed_tris, cluster_aabb, org, direction, min_t, max_t,
                  any_hit, plain=True)
