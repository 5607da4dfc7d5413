"""Legacy dense v2 triangle trace: 128-ray groups against every
128-triangle Morton cluster, culled in the walk against the lanes'
running best.

Port of pbrlab_tpu/ops/pallas/dense_v2.py. One kernel, written by hand in
CUDA for Hopper (`csrc/dense_legacy.cu`, `dense_v2_trace`), replaces the
Pallas `_trace_kernel`. It traces the v1 tables (`ops/dense.py`
`pack_triangles`: the scene's `dense_tris`, `dense_cluster_aabb`); the
render reaches it with `tri_backend="dense"`.

The TPU semantics kept: an aligned group of 128 rays enters cluster c when
any of its lanes' slab tests passes against that lane's running best t
(`jnp.any`); with any_hit the group stops entering clusters once every
lane has a hit (`jnp.all`; a dead lane never has one). Inside an entered
cluster every lane tests the 128 triangles in 16 steps of 8: the TPU keeps
one running best per sublane slot (id mod 8), max_t folded into the
initial best and a strict `t < best`, and at the end takes the least t,
the lowest slot on ties. The plain version and the kernel keep the same 8
bests per lane.

The wrapper takes the kernel for CUDA tensors and the plain torch version
(`_walk_ref`) for CPU tensors; `dense_trace_v2_ref` runs the plain version
on any device, which is what the kernel is compared with on the card.
`LAUNCHES` counts kernel launches per mode. prim is the id in the SORTED
order, int32 (the TPU carries it as float32, exact below 2^24 faces:
ROADMAP C9); the caller maps it back through the scene's `dense_order`.
"""
from __future__ import annotations

import ctypes

import torch

from . import cuda_lib
from .dense import (LANES, SLOP, TRI_BLOCK, finish, pad_rays, slab,
                    tri_test)
from .dense_curve import _inv

SLOTS = 8  # triangles per step (the TPU's sublanes): one best each
STEPS = TRI_BLOCK // SLOTS

LAUNCHES = {"closest": 0, "any_hit": 0}


class Lanes:
    """Per-lane ray terms of padded lanes, shaped [G, 128, 1, 1] to
    broadcast against a cluster's [.., 16 steps, 8 slots] triangles."""

    def __init__(self, org, direction, min_t):
        g = org.shape[0] // LANES
        self.o = [org[:, k].reshape(g, LANES, 1, 1) for k in range(3)]
        self.d = [direction[:, k].reshape(g, LANES, 1, 1) for k in range(3)]
        self.mint = min_t.reshape(g, LANES, 1, 1)


def init_bests(max_t):
    """The per-slot bests [G, 128, 8] of padded lanes: t = max_t (max_t
    folds into the initial best), u = v = 0, prim = -1."""
    g = max_t.shape[0] // LANES
    best_t = max_t.reshape(g, LANES, 1).repeat(1, 1, SLOTS)
    return (best_t, torch.zeros_like(best_t), torch.zeros_like(best_t),
            torch.full_like(best_t, -1, dtype=torch.int32))


def visit(tris, c, lanes, bests, enter):
    """Every lane of every entering group (enter [G] bool) tests the 128
    triangles of its cluster c ([G] int64) in 16 steps of 8 slots. The 16
    steps are one [G, 128, 16, 8] block against the slot bests from before
    the cluster, each slot keeping its first least t: what the TPU's 16
    sequential steps with a strict `t < best` give."""
    best_t, best_u, best_v, best_p = bests
    g = c.shape[0]
    ids = (c[:, None] * TRI_BLOCK + torch.arange(
        TRI_BLOCK, device=c.device)).reshape(g, 1, STEPS, SLOTS)
    rows = tris[:, ids]  # [12, G, 1, 16, 8]
    t, u, v, ok = tri_test(rows.unbind(0), lanes.o, lanes.d, lanes.mint)
    hit = ok & (t < best_t[:, :, None, :]) & enter[:, None, None, None]
    tk, k = torch.where(hit, t, float("inf")).min(dim=2)  # first least
    better = tk < best_t

    def pick(x):
        x = x.expand(g, LANES, STEPS, SLOTS)
        return torch.gather(x, 2, k[:, :, None, :])[:, :, 0, :]

    return (torch.where(better, tk, best_t),
            torch.where(better, pick(u), best_u),
            torch.where(better, pick(v), best_v),
            torch.where(better, pick(ids.to(torch.int32)), best_p))


def resolve(bests):
    """The TPU's end of a group: the least t over the slots, the lowest
    slot with a hit on ties -> flat (t, u, v, prim); t is the initial
    max_t and u = v = 0, prim = -1 where nothing was hit."""
    best_t, best_u, best_v, best_p = bests
    tmin = best_t.amin(dim=2, keepdim=True)
    slot = torch.arange(SLOTS, device=best_t.device)
    first = torch.where((best_t == tmin) & (best_p >= 0), slot,
                        SLOTS).amin(dim=2, keepdim=True)
    found = first < SLOTS
    sel = torch.clamp(first, max=SLOTS - 1)

    def pick(x, miss):
        return torch.where(found, torch.gather(x, 2, sel), miss).reshape(-1)

    return (tmin.reshape(-1), pick(best_u, 0.0), pick(best_v, 0.0),
            pick(best_p, -1))


def _walk_ref(tris, aabb, org, direction, min_t, max_t, any_hit=False):
    """Plain torch version of the kernel on padded lanes (a multiple of
    128, max_t clamped to INF). Clusters are a loop, because the cull
    reads the running best. Returns (t, u, v, prim) as `resolve`."""
    g = org.shape[0] // LANES
    lanes = Lanes(org, direction, min_t)
    o2 = [org[:, k].reshape(g, LANES) for k in range(3)]
    inv = [_inv(direction[:, k]).reshape(g, LANES) for k in range(3)]
    mint2 = min_t.reshape(g, LANES)
    bests = init_bests(max_t)
    for c in range(aabb.shape[1]):
        tnear, tfar = slab(aabb, c, o2, inv)
        lane_best = bests[0].amin(dim=2)
        box_hit = ((tnear <= tfar * SLOP) & (tfar >= mint2)
                   & (tnear <= lane_best))
        enter = box_hit.any(dim=1)
        if any_hit:
            enter = enter & ~(bests[3] >= 0).any(dim=2).all(dim=1)
        if bool(enter.any()):
            bests = visit(tris, torch.full((g,), c, device=org.device),
                          lanes, bests, enter)
    return resolve(bests)


_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGS = [_P, _I, _P, _I, _P, _P, _P, _P, _I, _I, _P, _P, _P, _P, _P]


def _walk_cuda(tris, aabb, org, direction, min_t, max_t, any_hit=False):
    """Launch the dense v2 kernel on the current stream; same returns as
    `_walk_ref`."""
    dev = org.device
    n = org.shape[0]
    m = aabb.shape[1]
    f32 = torch.float32
    check = cuda_lib.check_tensor
    check("dense v2", tris, f32, (12, m * TRI_BLOCK), dev)
    check("dense v2", aabb, f32, (8, m), dev)
    for x, shape in ((org, (n, 3)), (direction, (n, 3)), (min_t, (n,)),
                     (max_t, (n,))):
        check("dense v2", x, f32, shape, dev)
    if n % LANES:
        raise ValueError(f"{n} lanes is not a whole number of {LANES}-lane "
                         "groups")
    t = torch.empty((n,), dtype=f32, device=dev)
    u = torch.empty_like(t)
    v = torch.empty_like(t)
    prim = torch.empty((n,), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = cuda_lib.function("dense_v2_trace", _ARGS)(
            tris.data_ptr(), tris.shape[1], aabb.data_ptr(), m,
            org.data_ptr(), direction.data_ptr(), min_t.data_ptr(),
            max_t.data_ptr(), int(any_hit), n, t.data_ptr(), u.data_ptr(),
            v.data_ptr(), prim.data_ptr(), stream)
    kind = "any_hit" if any_hit else "closest"
    cuda_lib.launched(f"dense v2 {kind}", rc)
    LAUNCHES[kind] += 1
    return t, u, v, prim


def _trace(packed, aabb, org, direction, min_t, max_t, any_hit, plain):
    n = org.shape[0]
    rays = pad_rays(org, direction, min_t, max_t)
    packed, aabb = packed.contiguous(), aabb.contiguous()
    walk = _walk_cuda if org.is_cuda and not plain else _walk_ref
    return finish(*walk(packed, aabb, *rays, any_hit=any_hit), n)


def dense_trace_v2(packed_tris, cluster_aabb, org, direction, min_t, max_t,
                   any_hit=False):
    """Closest (or any) hit vs the v1 tables -> dict(t, u, v, prim): prim
    indexes the SORTED order (-1 and t = INF on a miss). With any_hit only
    `prim >= 0` is meaningful."""
    return _trace(packed_tris, cluster_aabb, org, direction, min_t, max_t,
                  any_hit, plain=False)


def dense_trace_v2_ref(packed_tris, cluster_aabb, org, direction, min_t,
                       max_t, any_hit=False):
    """Plain torch version of `dense_trace_v2` on any device."""
    return _trace(packed_tris, cluster_aabb, org, direction, min_t, max_t,
                  any_hit, plain=True)
