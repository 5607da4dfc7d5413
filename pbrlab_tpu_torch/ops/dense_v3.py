"""Legacy dense v3 triangle trace: per-128-ray-group survivor lists of
128-triangle Morton clusters, walked front to back with an early exit.

Port of pbrlab_tpu/ops/pallas/dense_v3.py. One kernel, written by hand in
CUDA for Hopper (`csrc/dense_legacy.cu`, `dense_v3_trace`), replaces the
Pallas `_trace_kernel`: the executor. It traces the v1 tables
(`ops/dense.py` `pack_triangles`: the scene's `dense_tris`,
`dense_cluster_aabb`); the render reaches it with `tri_backend="dense3"`.

The prelude stays plain torch on every device, as it stayed XLA in the
JAX package: the cluster cull (`group_survivors_beam`, one conservative
interval-arithmetic slab test per group, or with cull="exact" the per-ray
`cluster_mask` reduced per group), then a stable argsort of the beam
tnear into front-to-back survivor lists and their counts.

The TPU semantics kept: each aligned group of 128 rays walks its
survivors in order; before each one it stops when the largest running
best t over all 8 slots of all 128 lanes (`jnp.max(best_t)`: a slot
without a hit still holds max_t) is no more than the next survivor's
tnear, padded by (1 - 1e-6) and -1e-6, and with any_hit once every lane
has a hit (a dead lane never has one). Inside a survivor the body is
v2's: 16 steps of 8 slots, one running best per slot (id mod 8) with max_t
folded in and a strict `t < best`, and at the end the least t, the lowest
slot on ties (`ops/dense_v2.py`).

The wrapper takes the kernel for CUDA tensors and the plain torch walk
(`_walk_ref`) for CPU tensors; `dense_trace_v3_ref` runs the plain walk on
any device, which is what the kernel is compared with on the card.
`LAUNCHES` counts kernel launches per mode. prim is the id in the SORTED
order, int32 (float32 on the TPU: ROADMAP C9).
"""
from __future__ import annotations

import ctypes

import torch

from . import cuda_lib
from .dense import SLOP, TRI_BLOCK, finish
from .dense_curve import _inv, pad_rays
from .dense_v2 import LANES, Lanes, init_bests, resolve, visit

_BIG = 1e30

LAUNCHES = {"closest": 0, "any_hit": 0}


def cluster_mask(cluster_aabb, org, direction, min_t, max_t):
    """[N, M] bool: the ray segment [min_t, max_t] can hit the cluster's
    AABB (dense slab test; a dead lane, max_t < min_t, gets a false row)."""
    inv = _inv(direction)
    o = org

    def axis(k):
        t0 = (cluster_aabb[k][None, :] - o[:, k:k + 1]) * inv[:, k:k + 1]
        t1 = (cluster_aabb[k + 3][None, :] - o[:, k:k + 1]) * inv[:, k:k + 1]
        return torch.minimum(t0, t1), torch.maximum(t0, t1)

    n0, f0 = axis(0)
    n1, f1 = axis(1)
    n2, f2 = axis(2)
    tnear = torch.maximum(torch.maximum(n0, n1), n2)
    tfar = torch.minimum(torch.minimum(f0, f1), f2)
    return ((tnear <= tfar * SLOP) & (tfar >= min_t[:, None])
            & (tnear <= max_t[:, None]) & (max_t >= min_t)[:, None])


def group_survivors_beam(cluster_aabb, org, direction, min_t, max_t,
                         lanes=LANES, return_tnear=False):
    """[G, M] bool: conservatively, some ray of the 128-lane group can hit
    the cluster's AABB, by interval arithmetic on the group's origin box
    and inverse-direction box (products take the min / max over the 4
    endpoint pairs; an axis whose direction sign flips within the group
    does not constrain). With return_tnear, also the [G, M] lower bound of
    the slab entry t: the front-to-back sort key of the walk. The inverse
    direction keeps the sign of a tiny component, unlike `cluster_mask`."""
    n = org.shape[0]
    g = n // lanes
    inv = 1.0 / torch.where(torch.abs(direction) < 1e-12,
                            torch.where(direction < 0.0, -1e-12, 1e-12),
                            direction)
    og = org.reshape(g, lanes, 3)
    ig = inv.reshape(g, lanes, 3)
    o_lo, o_hi = og.amin(dim=1), og.amax(dim=1)  # [G, 3]
    i_lo, i_hi = ig.amin(dim=1), ig.amax(dim=1)
    mixed = (i_lo < 0.0) & (i_hi > 0.0)
    mn_lo = min_t.reshape(g, lanes).amin(dim=1)  # [G]
    mx_hi = max_t.reshape(g, lanes).amax(dim=1)

    m = cluster_aabb.shape[1]
    big = torch.tensor(_BIG, dtype=torch.float32, device=org.device)
    tnear_lo = torch.full((g, m), -_BIG, device=org.device)
    tfar_hi = torch.full((g, m), _BIG, device=org.device)
    for k in range(3):
        d_lo = (cluster_aabb[k][None, :] - o_hi[:, k:k + 1],
                cluster_aabb[k + 3][None, :] - o_hi[:, k:k + 1])
        d_hi = (cluster_aabb[k][None, :] - o_lo[:, k:k + 1],
                cluster_aabb[k + 3][None, :] - o_lo[:, k:k + 1])
        il = i_lo[:, k:k + 1]
        ih = i_hi[:, k:k + 1]
        lo_k = torch.minimum(
            torch.minimum(torch.minimum(d_lo[0] * il, d_lo[0] * ih),
                          torch.minimum(d_hi[0] * il, d_hi[0] * ih)),
            torch.minimum(torch.minimum(d_lo[1] * il, d_lo[1] * ih),
                          torch.minimum(d_hi[1] * il, d_hi[1] * ih)))
        hi_k = torch.maximum(
            torch.maximum(torch.maximum(d_lo[0] * il, d_lo[0] * ih),
                          torch.maximum(d_hi[0] * il, d_hi[0] * ih)),
            torch.maximum(torch.maximum(d_lo[1] * il, d_lo[1] * ih),
                          torch.maximum(d_hi[1] * il, d_hi[1] * ih)))
        free = mixed[:, k:k + 1]
        tnear_lo = torch.maximum(tnear_lo, torch.where(free, -big, lo_k))
        tfar_hi = torch.minimum(tfar_hi, torch.where(free, big, hi_k))
    mask = ((tnear_lo <= tfar_hi * SLOP)
            & (tfar_hi >= mn_lo[:, None]) & (tnear_lo <= mx_hi[:, None])
            & (mx_hi >= mn_lo)[:, None])
    if return_tnear:
        return mask, tnear_lo
    return mask


def signature_key(cluster_aabb, org, direction, min_t, max_t):
    """Sort key grouping rays by the cluster AABBs they can hit: bit c % 32
    set iff `cluster_mask` passes for cluster c (equal keys hit the same
    clusters for M <= 32; above, bits alias). The uint32 value, in int64."""
    m = cluster_mask(cluster_aabb, org, direction, min_t, max_t)
    n, clusters = m.shape
    pad = torch.zeros((n, -clusters % 32), dtype=torch.bool,
                      device=org.device)
    bit = torch.cat([m, pad], dim=1).reshape(n, -1, 32).any(dim=1)
    return (bit.to(torch.int64)
            << torch.arange(32, device=org.device)).sum(dim=1)


def survivor_lists(cluster_aabb, org, direction, min_t, max_t, cull="beam"):
    """The prelude on padded lanes: (surv [G, M] int32 cluster ids, the
    survivors first, front to back; cnt [G] int32; tnear [G, M] f32 the
    sorted key, -1e30 for every survivor with cull="exact", whose walk
    has no early exit)."""
    if cull == "beam":
        gm, tnear = group_survivors_beam(cluster_aabb, org, direction,
                                         min_t, max_t, return_tnear=True)
    elif cull == "exact":
        hitm = cluster_mask(cluster_aabb, org, direction, min_t, max_t)
        gm = hitm.reshape(org.shape[0] // LANES, LANES, -1).any(dim=1)
        tnear = torch.full(gm.shape, -_BIG, device=org.device)
    else:
        raise ValueError(f"unknown cull {cull!r}")
    cnt = gm.sum(dim=1).to(torch.int32)
    key = torch.where(gm, tnear, _BIG)
    surv = torch.argsort(key, dim=1, stable=True)
    return (surv.to(torch.int32).contiguous(), cnt,
            torch.gather(key, 1, surv).contiguous())


def _walk_ref(tris, surv, cnt, tnear, org, direction, min_t, max_t,
              any_hit=False):
    """Plain torch version of the kernel on padded lanes: all groups walk
    their survivor lists in lock-step, a group dropping out for good at
    its first failed loop test (the TPU's while loop). Returns (t, u, v,
    prim) as `dense_v2.resolve`."""
    g, m = surv.shape
    lanes = Lanes(org, direction, min_t)
    bests = init_bests(max_t)
    walking = torch.ones((g,), dtype=torch.bool, device=org.device)
    idx = torch.arange(g, device=org.device)
    for si in range(int(cnt.max()) if g else 0):
        nxt = tnear[idx, min(si, m - 1)]
        can = bests[0].amax(dim=(1, 2)) > nxt * (1.0 - 1e-6) - 1e-6
        if any_hit:
            can = can & ~(bests[3] >= 0).any(dim=2).all(dim=1)
        walking = walking & (si < cnt) & can
        if not bool(walking.any()):
            break
        bests = visit(tris, surv[:, si].to(torch.int64), lanes, bests,
                      walking)
    return resolve(bests)


_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGS = [_P, _I, _P, _P, _P, _I, _P, _P, _P, _P, _I, _I, _P, _P, _P, _P,
         _P]


def _walk_cuda(tris, surv, cnt, tnear, org, direction, min_t, max_t,
               any_hit=False):
    """Launch the dense v3 kernel on the current stream; same returns as
    `_walk_ref`."""
    dev = org.device
    n = org.shape[0]
    g, m = surv.shape
    f32, i32 = torch.float32, torch.int32
    check = cuda_lib.check_tensor
    check("dense v3", tris, f32, (12, tris.shape[1]), dev)
    check("dense v3", surv, i32, (g, m), dev)
    check("dense v3", cnt, i32, (g,), dev)
    check("dense v3", tnear, f32, (g, m), dev)
    for x, shape in ((org, (n, 3)), (direction, (n, 3)), (min_t, (n,)),
                     (max_t, (n,))):
        check("dense v3", x, f32, shape, dev)
    if n != g * LANES or tris.shape[1] % TRI_BLOCK:
        raise ValueError(f"{n} lanes is not {g} groups of {LANES}, or "
                         f"{tris.shape[1]} is not whole clusters")
    t = torch.empty((n,), dtype=f32, device=dev)
    u = torch.empty_like(t)
    v = torch.empty_like(t)
    prim = torch.empty((n,), dtype=i32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = cuda_lib.function("dense_v3_trace", _ARGS)(
            tris.data_ptr(), tris.shape[1], surv.data_ptr(), cnt.data_ptr(),
            tnear.data_ptr(), m, org.data_ptr(), direction.data_ptr(),
            min_t.data_ptr(), max_t.data_ptr(), int(any_hit), n,
            t.data_ptr(), u.data_ptr(), v.data_ptr(), prim.data_ptr(),
            stream)
    kind = "any_hit" if any_hit else "closest"
    cuda_lib.launched(f"dense v3 {kind}", rc)
    LAUNCHES[kind] += 1
    return t, u, v, prim


def _trace(packed, aabb, org, direction, min_t, max_t, any_hit, cull,
           plain):
    n = org.shape[0]
    rays = pad_rays(org, direction, min_t, max_t)
    lists = survivor_lists(aabb, *rays, cull=cull)
    walk = _walk_cuda if org.is_cuda and not plain else _walk_ref
    return finish(*walk(packed.contiguous(), *lists, *rays,
                        any_hit=any_hit), n)


def dense_trace_v3(packed_tris, cluster_aabb, org, direction, min_t, max_t,
                   any_hit=False, cull="beam"):
    """Closest (or any) hit vs the v1 tables -> dict(t, u, v, prim): prim
    indexes the SORTED order (-1 and t = INF on a miss). cull: "beam"
    (conservative per-group test, front-to-back early exit) or "exact"
    (per-ray test reduced per group, no ordering, no early exit). With
    any_hit only `prim >= 0` is meaningful."""
    return _trace(packed_tris, cluster_aabb, org, direction, min_t, max_t,
                  any_hit, cull, plain=False)


def dense_trace_v3_ref(packed_tris, cluster_aabb, org, direction, min_t,
                       max_t, any_hit=False, cull="beam"):
    """Plain torch version of `dense_trace_v3` on any device."""
    return _trace(packed_tris, cluster_aabb, org, direction, min_t, max_t,
                  any_hit, cull, plain=True)
