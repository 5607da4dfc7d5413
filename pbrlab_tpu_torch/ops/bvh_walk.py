"""The threaded-BVH walk shared by the "bvh" triangle backend
(`intersect._bvh_trace`) and the hair walk (`curves.curve_trace`).

Port of the JAX package's CPU traces, `_bvh_trace`
(pbrlab_tpu/ops/intersect.py:133) and `curve_trace`
(pbrlab_tpu/ops/curves.py:108). The JAX package walks them in an XLA
`lax.while_loop`, not in Pallas; here two kernels written by hand in CUDA
for Hopper (`csrc/bvh_walk.cu`, `bvh_trace` and `curve_bvh_trace`) walk
one ray per thread, and `walk_ref` is their plain torch twin.

The tree is `geometry.bvh.build_bvh`'s: nodes in depth-first order, each
with its box, its skip link (the next node outside its subtree) and, for
a leaf, a fixed window of LEAF_SIZE slots of `prim_ids` (-1 pads). Every
lane keeps one node pointer and no stack: a box it enters (the slab test
against [min_t, min(max_t, best t)]) that is inner sends it to node + 1,
a leaf or a box it misses to skip[node]. A leaf's slots are tested with
the cap the lane had on entering it; the first minimal t among the hits
replaces the best only if it is strictly smaller. Any-hit ends a lane's
walk after the first leaf that gives it a hit. A lane with max_t < min_t
walks nothing: no hit could pass both bounds.

The twin steps every walking lane by one node a trip, on index subsets
(the leaf test only for the lanes that entered a leaf), with the kernels'
float operations in their order; the kernels do the same per thread, so on
the card a kernel and its twin agree to the bit. `LAUNCHES` counts kernel
launches per kernel and mode.
"""
from __future__ import annotations

import ctypes

import torch

from ..core.math import INF
from ..geometry.bvh import LEAF_SIZE
from . import cuda_lib

SLOP = 1.00000024  # the slab test's relative pad on tfar

LAUNCHES = {"bvh_closest": 0, "bvh_any_hit": 0, "curve_closest": 0,
            "curve_any_hit": 0}


def safe_inv(direction, eps):
    """1 / direction with components below eps in magnitude replaced by
    +-eps (the sign kept): 1e-20 for triangles, 1e-12 for curves, as the
    JAX package's two walks clamp."""
    return 1.0 / torch.where(torch.abs(direction) < eps,
                             torch.where(direction < 0.0, -eps, eps),
                             direction)


def dot3(a, b):
    """(a0 b0 + a1 b1) + a2 b2 over the trailing axis."""
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]) \
        + a[..., 2] * b[..., 2]


def cross3(a, b):
    """a x b over the trailing axis (jnp.cross's component order)."""
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], -1)


def walk_ref(tree, leaf, org, inv, min_t, max_t, any_hit=False,
             counts=False):
    """Each lane's walk of `tree` = (bvh_min, bvh_max [Nn, 3], skip,
    prim_offset [Nn], prim_ids [Np]). `leaf(ln, pid, cap)` tests slots
    pid [k, LEAF_SIZE] (-1: padding) for lanes ln [k] with hit bound cap
    [k] -> (hit, t, u, v) [k, LEAF_SIZE]. Returns (t, u, v, prim) [N]
    (t = INF, prim = -1 on a miss; prim the slot's id) and, with counts,
    [N, 2] int64 per lane: primitive tests, box tests."""
    bmin, bmax, skip, prim_offset, prim_ids = tree
    n = org.shape[0]
    dev = org.device
    i64 = torch.int64
    n_nodes = skip.shape[0]
    n_ids = prim_ids.shape[0]
    cur = torch.where(max_t >= min_t, 0, n_nodes).to(i64)
    best_t = torch.full((n,), INF, dtype=torch.float32, device=dev)
    best_u = torch.zeros_like(best_t)
    best_v = torch.zeros_like(best_t)
    best_p = torch.full((n,), -1, dtype=torch.int32, device=dev)
    work = torch.zeros((n, 2), dtype=i64, device=dev)
    window = torch.arange(LEAF_SIZE, device=dev)
    while True:
        lane = torch.nonzero(cur < n_nodes).squeeze(1)
        if lane.numel() == 0:
            break
        node = cur[lane]
        o, iv, mint = org[lane], inv[lane], min_t[lane]
        cap = torch.minimum(max_t[lane], best_t[lane])
        t0 = (bmin[node] - o) * iv
        t1 = (bmax[node] - o) * iv
        tnear = torch.minimum(t0, t1).amax(1)
        tfar = torch.maximum(t0, t1).amin(1)
        enter = (tnear <= tfar * SLOP) & (tfar >= mint) & (tnear <= cap)
        poff = prim_offset[node].to(i64)
        nxt = torch.where(enter & (poff < 0), node + 1, skip[node].to(i64))
        sel = enter & (poff >= 0)
        if bool(sel.any()):
            ln = lane[sel]
            slots = poff[sel][:, None] + window
            pid = torch.where(slots < n_ids,
                              prim_ids[slots.clamp(max=n_ids - 1)], -1)
            hit, t, u, v = leaf(ln, pid, cap[sel])
            hit = hit & (pid >= 0)
            tk, kk = torch.where(hit, t, INF).min(dim=1)  # the first least
            better = tk < best_t[ln]
            w, kw = ln[better], kk[better][:, None]
            best_t[w] = tk[better]
            best_u[w] = torch.gather(u[better], 1, kw)[:, 0]
            best_v[w] = torch.gather(v[better], 1, kw)[:, 0]
            best_p[w] = torch.gather(pid[better], 1, kw)[:, 0].to(
                torch.int32)
            if any_hit:  # the walk ends after the first leaf with a hit
                nxt[sel] = torch.where(best_p[ln] >= 0, n_nodes, nxt[sel])
            if counts:
                work[ln, 0] += (pid >= 0).sum(1)
        cur[lane] = nxt
        if counts:
            work[lane, 1] += 1
    out = (best_t, best_u, best_v, best_p)
    return (*out, work) if counts else out


_P, _I = ctypes.c_void_p, ctypes.c_int


def walk_cuda(kernel, tree, prims, org, direction, min_t, max_t,
              any_hit=False):
    """Launch `kernel` ("bvh_trace" or "curve_bvh_trace") on the current
    stream over `tree` (as `walk_ref`) and the primitive columns `prims`
    (float32 [P, 3] or [P]); same four returns as `walk_ref`."""
    dev = org.device
    n = org.shape[0]
    f32, i32 = torch.float32, torch.int32
    check = cuda_lib.check_tensor
    bmin, bmax, skip, prim_offset, prim_ids = tree
    n_nodes = skip.shape[0]
    for x, dtype, shape in ((bmin, f32, (n_nodes, 3)),
                            (bmax, f32, (n_nodes, 3)),
                            (skip, i32, (n_nodes,)),
                            (prim_offset, i32, (n_nodes,)),
                            (prim_ids, i32, (prim_ids.shape[0],)),
                            (org, f32, (n, 3)), (direction, f32, (n, 3)),
                            (min_t, f32, (n,)), (max_t, f32, (n,))):
        check(kernel, x, dtype, shape, dev)
    for x in prims:
        check(kernel, x, f32, (prims[0].shape[0],) + tuple(x.shape[1:]),
              dev)
    t = torch.empty((n,), dtype=f32, device=dev)
    u = torch.empty_like(t)
    v = torch.empty_like(t)
    prim = torch.empty((n,), dtype=i32, device=dev)
    args = [bmin.data_ptr(), bmax.data_ptr(), skip.data_ptr(),
            prim_offset.data_ptr(), n_nodes, prim_ids.data_ptr(),
            prim_ids.shape[0], *(x.data_ptr() for x in prims),
            org.data_ptr(), direction.data_ptr(), min_t.data_ptr(),
            max_t.data_ptr(), int(any_hit), n, t.data_ptr(), u.data_ptr(),
            v.data_ptr(), prim.data_ptr()]
    types = [_P] * 4 + [_I, _P, _I] + [_P] * (len(prims) + 4) \
        + [_I, _I] + [_P] * 4 + [_P]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = cuda_lib.function(kernel, types)(*args, stream)
    mode = "any_hit" if any_hit else "closest"
    cuda_lib.launched(f"{kernel} {mode}", rc)
    LAUNCHES[f"{kernel.split('_')[0]}_{mode}"] += 1
    return t, u, v, prim
