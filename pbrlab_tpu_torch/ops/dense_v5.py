"""dense_v5 triangle trace: per-ray BVH walks over the attr-major table
(mid-size scenes) and the leaf-major one (large scenes).

Port of pbrlab_tpu/ops/pallas/dense_v5.py. Hand-written CUDA kernels for
Hopper (`csrc/dense_v5.cu`) replace the three Pallas kernels:

* `dense_trace_v5` -> `dense_v5_trace` replaces `_trace_kernel`: closest
  hit (or any hit) over the attr-major [12, S] table (mid-size scenes);
* `dense_trace_v5_dual` -> `dense_v5_trace_dual` replaces
  `_trace_kernel_dual`: the closest hit plus the deferred-NEE shadow
  any-hit from the same origin, in one launch;
* `dense_trace_v5l` -> `dense_v5l_trace` replaces `_trace_kernel_dma`:
  closest or any hit over the leaf-major [M, 3, 128] table, ray i from
  node group_roots[i // 1024] when `group_roots` is given (large scenes).

`dense_trace_v5s`, the subtree scheduler of large scenes, is plain torch
around `dense_trace_v5l`, as it was XLA around the Pallas kernel.

All three walk per ray (`csrc/per_ray.cuh`, one thread per ray): each
lane has its own stack of STACK entries, culls against its own best t and
pushes the far child first; any-hit ends a lane's walk after the first
leaf that gives it a hit. The dual walks a lane's closest ray, then its
shadow ray as an any-hit query from the same origin, so its closest
answer is `dense_trace_v5`'s to the bit. They replace the TPU's packet
walks of 1024-ray groups (one stack per group, a child entered if any ray
of the group enters it), in which each ray paid for its group's union of
nodes and leaves. `_v5_ref` and `_v5l_ref` are the plain torch twins
(`per_ray.walk_ref`, each lane's own pop sequence). Against the JAX
package they may differ on exact-t ties and grazing rays (ROADMAP C3).

Each wrapper takes the kernel for CUDA tensors and the twin for CPU
tensors; `dense_trace_v5_ref`, `dense_trace_v5_dual_ref` and
`dense_trace_v5l_ref` run the twin on any device, which is what the
kernels are compared with on the card. `LAUNCHES` counts kernel launches
per kernel.

Contract (as the JAX package): rays (org, direction, min_t, max_t) are
float32, max_t < min_t marks a dead lane; results are t, u, v (float32)
and prim (int32 slot id, -1 and t = INF on a miss); the dual query also
returns an occluded bool per lane. With any_hit only `prim >= 0` is
meaningful.
"""
from __future__ import annotations

import ctypes

import torch

from ..core.math import INF
from . import cuda_lib, per_ray
from .per_ray import _inv

GROUP = 1024  # rays per v5l group root: the v5l walks take whole groups
CLUSTER = 32  # triangles per BVH leaf (slot window)
STACK = 128  # traversal stack entries (the build checks the depth)
_BIG = 1e30

LAUNCHES = {"v5": 0, "v5_dual": 0, "v5l": 0}

_P, _I = ctypes.c_void_p, ctypes.c_int
# tris, slots, node_aabb, node_meta, nodes, org, dir, min_t, max_t
_HEAD = [_P, _I, _P, _P, _I, _P, _P, _P, _P]
_V5_ARGS = _HEAD + [_I, _I, _P, _P, _P, _P, _P]  # any_hit, n, outs, stream
_DUAL_ARGS = _HEAD + [_P, _P, _P, _I, _P, _P, _P, _P, _P, _P]
_V5L_ARGS = [_P, _P, _P, _I, _P, _P, _P, _P, _P, _I, _I, _P, _P, _P, _P, _P]


def _pad(x, n_pad, value):
    """Pad the lane axis to n_pad with `value` (as the JAX wrappers pad:
    org 0, directions 1, min_t 0, max_t -1 = dead)."""
    pad = n_pad - x.shape[0]
    if pad:
        x = torch.cat([x, x.new_full((pad,) + tuple(x.shape[1:]), value)])
    return x.contiguous()


def _v5_ref(tris, node_aabb, node_meta, org, direction, min_t, max_t,
            any_hit=False, shadow=None, counts=False):
    """Plain torch twin of the v5 and dual kernels: every lane's own walk
    from node 0 over the attr-major table (`per_ray.walk_ref`), and with
    shadow = (sdir, smin_t, smax_t) then its shadow ray's any-hit walk.
    Returns (t, u, v, prim, occluded or None) and, with counts, each
    lane's ray-triangle and ray-box tests [N, 3] over both walks; t =
    max_t where nothing was hit."""
    rows = per_ray.attr_major_rows(tris)
    out = per_ray.walk_ref(rows, node_aabb, node_meta, org, direction,
                           min_t, max_t, 0, STACK, any_hit=any_hit,
                           counts=counts)
    occ = None
    if shadow is not None:
        s_out = per_ray.walk_ref(rows, node_aabb, node_meta, org, *shadow, 0,
                                 STACK, any_hit=True, counts=counts)
        occ = s_out[3] >= 0
    if not counts:
        return (*out, occ)
    work = out[4] if shadow is None else out[4] + s_out[4]
    return (*out[:4], occ, work)


def _v5_cuda(tris, node_aabb, node_meta, org, direction, min_t, max_t,
             any_hit=False, shadow=None):
    """Launch the dense_v5 kernel, or with shadow the dual one, on the
    current stream; same returns as `_v5_ref`."""
    dev = org.device
    n = org.shape[0]
    nn = node_aabb.shape[1]
    f32, i32 = torch.float32, torch.int32
    checks = [(tris, f32, (12, tris.shape[1])), (node_aabb, f32, (6, nn)),
              (node_meta, i32, (2, nn)), (org, f32, (n, 3)),
              (direction, f32, (n, 3)), (min_t, f32, (n,)),
              (max_t, f32, (n,))]
    if shadow is not None:
        checks += zip(shadow, (f32,) * 3, ((n, 3), (n,), (n,)))
    for x, dtype, shape in checks:
        cuda_lib.check_tensor("dense_v5", x, dtype, shape, dev)
    # leaves start at multiples of CLUSTER slots (build_v5 checks it)
    cuda_lib.check_float4_rows("dense_v5", tris, tris.shape[1])
    t = torch.empty((n,), dtype=f32, device=dev)
    u = torch.empty_like(t)
    v = torch.empty_like(t)
    prim = torch.empty((n,), dtype=i32, device=dev)
    outs = [t.data_ptr(), u.data_ptr(), v.data_ptr(), prim.data_ptr()]
    head = [tris.data_ptr(), tris.shape[1], node_aabb.data_ptr(),
            node_meta.data_ptr(), nn, org.data_ptr(), direction.data_ptr(),
            min_t.data_ptr(), max_t.data_ptr()]
    occ = None
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if shadow is None:
            kind = "v5"
            rc = cuda_lib.function("dense_v5_trace", _V5_ARGS)(
                *head, int(any_hit), n, *outs, stream)
        else:
            kind = "v5_dual"
            occ = torch.empty((n,), dtype=torch.uint8, device=dev)
            rc = cuda_lib.function("dense_v5_trace_dual", _DUAL_ARGS)(
                *head, *(x.data_ptr() for x in shadow), n, *outs,
                occ.data_ptr(), stream)
    cuda_lib.launched(f"dense_{kind}", rc)
    LAUNCHES[kind] += 1
    return t, u, v, prim, None if occ is None else occ.bool()


def _v5l_ref(tris, node_aabb, node_meta, roots, org, direction, min_t,
             max_t, any_hit=False, counts=False):
    """Plain torch twin of the per-ray v5l kernel: every lane's own walk
    from its group's root (roots [G], or None: node 0) over the
    leaf-major table (`per_ray.walk_ref`). Returns (t, u, v, prim) and,
    with counts, each lane's ray-triangle and ray-box tests [N, 3]; t =
    max_t where nothing was hit."""
    root = 0 if roots is None else roots.to(torch.int64).repeat_interleave(
        GROUP)
    return per_ray.walk_ref(per_ray.leaf_major_rows(tris), node_aabb,
                            node_meta, org, direction, min_t, max_t, root,
                            STACK, any_hit=any_hit, counts=counts)


def _v5l_cuda(tris, node_aabb, node_meta, roots, org, direction, min_t,
              max_t, any_hit=False):
    """Launch the per-ray dense_v5l kernel on the current stream; same
    returns as `_v5l_ref`."""
    dev = org.device
    n = org.shape[0]
    g = n // GROUP
    nn = node_aabb.shape[1]
    f32, i32 = torch.float32, torch.int32
    checks = [(tris, f32, (tris.shape[0], 3, 128)),
              (node_aabb, f32, (6, nn)), (node_meta, i32, (2, nn)),
              (org, f32, (n, 3)), (direction, f32, (n, 3)),
              (min_t, f32, (n,)), (max_t, f32, (n,))]
    if roots is not None:
        checks.append((roots, i32, (g,)))
    for x, dtype, shape in checks:
        cuda_lib.check_tensor("dense_v5l", x, dtype, shape, dev)
    cuda_lib.check_float4_rows("dense_v5l", tris, CLUSTER)
    if n != g * GROUP:
        raise ValueError(f"dense_v5l wants whole groups of {GROUP} rays; "
                         f"got {n}")
    t = torch.empty((n,), dtype=f32, device=dev)
    u = torch.empty_like(t)
    v = torch.empty_like(t)
    prim = torch.empty((n,), dtype=i32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = cuda_lib.function("dense_v5l_trace", _V5L_ARGS)(
            tris.data_ptr(), node_aabb.data_ptr(), node_meta.data_ptr(), nn,
            None if roots is None else roots.data_ptr(), org.data_ptr(),
            direction.data_ptr(), min_t.data_ptr(), max_t.data_ptr(),
            int(any_hit), g, t.data_ptr(), u.data_ptr(), v.data_ptr(),
            prim.data_ptr(), stream)
    cuda_lib.launched("dense_v5l", rc)
    LAUNCHES["v5l"] += 1
    return t, u, v, prim


def _trace(tris, leaf_major, node_aabb, node_meta, org, direction, min_t,
           max_t, any_hit=False, shadow=None, group_roots=None, plain=False):
    """Walk (the kernel on CUDA tensors unless plain); v5l's rays padded to
    whole groups for its group roots and unpadded after."""
    n = org.shape[0]
    tables = [x.contiguous() for x in (tris, node_aabb, node_meta)]
    kernel = org.is_cuda and not plain
    occ = None
    if leaf_major:
        n_pad = (n + GROUP - 1) // GROUP * GROUP
        rays = [_pad(org, n_pad, 0.0), _pad(direction, n_pad, 1.0),
                _pad(min_t, n_pad, 0.0),
                torch.clamp(_pad(max_t, n_pad, -1.0), max=INF)]
        roots = None
        if group_roots is not None:
            roots = group_roots.to(torch.int32).contiguous()
        walk = _v5l_cuda if kernel else _v5l_ref
        t, u, v, prim = walk(*tables, roots, *rays, any_hit=any_hit)
    else:
        rays = [org.contiguous(), direction.contiguous(), min_t.contiguous(),
                torch.clamp(max_t, max=INF)]
        if shadow is not None:
            sdir, smin_t, smax_t = shadow
            shadow = (sdir.contiguous(), smin_t.contiguous(),
                      torch.clamp(smax_t, max=INF))
        walk = _v5_cuda if kernel else _v5_ref
        t, u, v, prim, occ = walk(*tables, *rays, any_hit=any_hit,
                                  shadow=shadow)
    hit = prim[:n] >= 0
    res = {"t": torch.where(hit, t[:n], INF), "u": u[:n], "v": v[:n],
           "prim": prim[:n]}
    return res if occ is None else (res, occ)


def dense_trace_v5(packed_tris, node_aabb, node_meta, org, direction, min_t,
                   max_t, any_hit=False):
    """Closest (or any) hit per lane over the attr-major [12, S] table ->
    dict(t, u, v, prim). With any_hit only `prim >= 0` is meaningful."""
    return _trace(packed_tris, False, node_aabb, node_meta, org, direction,
                  min_t, max_t, any_hit=any_hit)


def dense_trace_v5_dual(packed_tris, node_aabb, node_meta, org, direction,
                        min_t, max_t, sdir, smin_t, smax_t):
    """Closest hit + shadow any-hit sharing the origin `org` (deferred
    NEE) in one launch -> (dict(t, u, v, prim), occluded bool)."""
    return _trace(packed_tris, False, node_aabb, node_meta, org, direction,
                  min_t, max_t, shadow=(sdir, smin_t, smax_t))


def dense_trace_v5l(packed_leaf, node_aabb, node_meta, org, direction,
                    min_t, max_t, any_hit=False, group_roots=None):
    """Closest (or any) hit over the leaf-major [M, 3, 128] table; group g
    (rays [1024 g, 1024 (g + 1))) walks from node group_roots[g] when
    given, else from the root."""
    return _trace(packed_leaf, True, node_aabb, node_meta, org, direction,
                  min_t, max_t, any_hit=any_hit, group_roots=group_roots)


def dense_trace_v5_ref(packed_tris, node_aabb, node_meta, org, direction,
                       min_t, max_t, any_hit=False):
    """Plain torch version of `dense_trace_v5` on any device."""
    return _trace(packed_tris, False, node_aabb, node_meta, org, direction,
                  min_t, max_t, any_hit=any_hit, plain=True)


def dense_trace_v5_dual_ref(packed_tris, node_aabb, node_meta, org,
                            direction, min_t, max_t, sdir, smin_t, smax_t):
    """Plain torch version of `dense_trace_v5_dual` on any device."""
    return _trace(packed_tris, False, node_aabb, node_meta, org, direction,
                  min_t, max_t, shadow=(sdir, smin_t, smax_t), plain=True)


def dense_trace_v5l_ref(packed_leaf, node_aabb, node_meta, org, direction,
                        min_t, max_t, any_hit=False, group_roots=None):
    """Plain torch version of `dense_trace_v5l` on any device."""
    return _trace(packed_leaf, True, node_aabb, node_meta, org, direction,
                  min_t, max_t, any_hit=any_hit, group_roots=group_roots,
                  plain=True)


def dense_trace_v5s(packed_leaf, node_aabb, node_meta, sub_roots, sub_aabb,
                    org, direction, min_t, max_t, any_hit=False, passes=1):
    """Subtree-scheduled large-scene trace (pbrlab_tpu dense_trace_v5s):
    same contract as dense_trace_v5l; sub_roots/sub_aabb from
    `build.subtree_cut`.

    Large scenes with incoherent rays make every 1024-ray group walk much
    of the tree. Each pass restores coherence by schedule: every unresolved
    ray picks its nearest candidate subtree it has not visited (a slab test
    against the C <= 64 subtree boxes), rays are sorted by it, and each
    group walks from its first ray's subtree root, with max_t = the ray's
    best t so far. `passes` // 2 passes sort once by the composite key
    (nearest, second nearest) and walk both; an odd pass sorts by the
    nearest alone. A last unrestricted pass sweeps every ray that still has
    a nearer unvisited candidate. The state (rays, bests, visited-subtree
    bits, original lane) rides permuted in one [N, 15] float32 matrix, one
    gather per sort, and goes back with the inverse permutation
    argsort(orig).
    """
    n0 = org.shape[0]
    n = (n0 + GROUP - 1) // GROUP * GROUP
    org = _pad(org, n, 0.0)
    direction = _pad(direction, n, 1.0)
    min_t = _pad(min_t, n, 0.0)
    max_t = torch.clamp(_pad(max_t, n, -1.0), max=INF)
    n_sub = sub_aabb.shape[1]
    if n_sub > 64:
        raise ValueError(f"{n_sub} subtrees: the visited bits are two "
                         "int32 words (at most 64)")
    dev = org.device
    f32, i32 = torch.float32, torch.int32
    lo_c = sub_aabb[0:3].T[None]  # [1, C, 3]
    hi_c = sub_aabb[3:6].T[None]
    sub_ids = torch.arange(n_sub, device=dev)
    bits = torch.ones((), dtype=i32, device=dev) << (sub_ids % 32).to(i32)
    roots = sub_roots.to(i32)

    def avail(st):
        """[N, C] entry t into each subtree box not yet visited and nearer
        than the ray's best t, else 1e30."""
        o, d = st[:, 0:3], st[:, 3:6]
        inv = _inv(d)
        t0 = (lo_c - o[:, None]) * inv[:, None]
        t1 = (hi_c - o[:, None]) * inv[:, None]
        tnear = torch.maximum(torch.minimum(t0, t1).amax(-1), st[:, 6:7])
        tfar = torch.minimum(torch.maximum(t0, t1).amin(-1), st[:, 7:8])
        cand = torch.where(tnear <= tfar * 1.00000024, tnear, _BIG)
        clo, chi = st[:, 12:13].view(i32), st[:, 13:14].view(i32)
        seen = torch.where(sub_ids[None] < 32, (clo & bits) != 0,
                           (chi & bits) != 0)
        return torch.where(seen | (cand >= st[:, 8:9]), _BIG, cand)

    def walk(st, key, cleanup=False):
        """One kernel pass over the sorted state; key [N] is each ray's
        subtree (n_sub: none), or for the cleanup 0 = walk, 1 = skip."""
        bt, bp = st[:, 8], st[:, 11]
        if cleanup:
            active = key == 0
            groot = None
        else:
            first = key.reshape(-1, GROUP)[:, 0]
            groot = torch.where(first >= n_sub, 0,
                                roots[first.clamp(max=n_sub - 1)])
            active = (key == first.repeat_interleave(GROUP)) & (key < n_sub)
            if any_hit:
                active = active & (bp < 0)
        res = dense_trace_v5l(packed_leaf, node_aabb, node_meta, st[:, 0:3],
                              st[:, 3:6], st[:, 6], torch.where(active, bt,
                                                                -1.0),
                              any_hit=any_hit, group_roots=groot)
        upd = active & (res["prim"] >= 0) & (res["t"] < bt)
        st = st.clone()
        st[:, 8] = torch.where(upd, res["t"], bt)
        st[:, 9] = torch.where(upd, res["u"], st[:, 9])
        st[:, 10] = torch.where(upd, res["v"], st[:, 10])
        st[:, 11] = torch.where(upd, res["prim"].to(f32), bp)
        if not cleanup:
            bit = torch.ones_like(key, dtype=i32) << (key % 32).to(i32)
            zero = torch.zeros_like(bit)
            st[:, 12] = (st[:, 12].view(i32) | torch.where(
                active & (key < 32), bit, zero)).view(f32)
            st[:, 13] = (st[:, 13].view(i32) | torch.where(
                active & (key >= 32) & (key < n_sub), bit, zero)).view(f32)
        return st

    def nearest(av, st):
        sid = torch.argmin(av, dim=1)
        has = av.amin(dim=1) < _BIG
        if any_hit:
            has = has & (st[:, 11] < 0)
        return torch.where(has, sid, n_sub)

    # state: org 0:3 | dir 3:6 | min_t 6 | max_t 7 | best t, u, v 8:11 |
    # best prim 11 | visited bits 12:14 (int32 bits) | orig lane 14 (int32)
    zeros = torch.zeros((n, 1), dtype=f32, device=dev)
    state = torch.cat([
        org, direction, min_t[:, None], max_t[:, None], max_t[:, None],
        zeros, zeros, zeros - 1.0,
        torch.zeros((n, 2), dtype=i32, device=dev).view(f32),
        torch.arange(n, dtype=i32, device=dev)[:, None].view(f32)], dim=1)
    for _ in range(passes // 2):
        av = avail(state)
        k1 = nearest(av, state)
        k2 = nearest(torch.where(sub_ids[None] == k1[:, None], _BIG, av),
                     state)
        perm = torch.argsort(k1 * (n_sub + 1) + k2, stable=True)
        state = state[perm]
        state = walk(state, k1[perm])
        state = walk(state, k2[perm])
    if passes % 2:
        key = nearest(avail(state), state)
        perm = torch.argsort(key, stable=True)
        state = walk(state[perm], key[perm])
    # cleanup: whatever still has a nearer candidate walks the whole tree
    rem = (avail(state) < _BIG).any(dim=1)
    if any_hit:
        rem = rem & (state[:, 11] < 0)
    key = torch.where(rem, 0, 1)
    perm = torch.argsort(key, stable=True)
    state = walk(state[perm], key[perm], cleanup=True)
    out = state[torch.argsort(state[:, 14].view(i32))][:n0]
    found = out[:, 11] >= 0.0
    return {"t": torch.where(found, out[:, 8], INF), "u": out[:, 9],
            "v": out[:, 10],
            "prim": torch.where(found, out[:, 11].to(i32), -1)}
