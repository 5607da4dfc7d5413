"""dense_v5 triangle trace: BVH traversal, packet walks of 1024-ray
groups (mid-size scenes) and a per-ray walk (large scenes).

Port of pbrlab_tpu/ops/pallas/dense_v5.py. Hand-written CUDA kernels for
Hopper (`csrc/dense_v5.cu`) replace the three Pallas kernels:

* `dense_trace_v5` -> `dense_v5_trace` replaces `_trace_kernel`: closest
  hit (or any hit) over the attr-major [12, S] table (mid-size scenes);
* `dense_trace_v5_dual` -> `dense_v5_trace_dual` replaces
  `_trace_kernel_dual`: the closest hit plus the deferred-NEE shadow
  any-hit from the same origin, in one walk;
* `dense_trace_v5l` -> `dense_v5l_trace` replaces `_trace_kernel_dma`:
  closest or any hit over the leaf-major [M, 3, 128] table, ray i from
  node group_roots[i // 1024] when `group_roots` is given (large scenes).

`dense_trace_v5s`, the subtree scheduler of large scenes, is plain torch
around `dense_trace_v5l`, as it was XLA around the Pallas kernel.

dense_v5 and its dual walk as the TPU does: a group of 1024 rays
descends the BVH together with one stack; a child is entered if any ray
of the group can enter it before its best t, near child first, and a
popped node is skipped once every ray's best t beats its entry t.
`_packet_ref` is their plain torch version: every group walks its own
stack in lock-step over the groups, one node per step.

dense_v5l walks per ray (`csrc/per_ray.cuh`, one thread per ray): each
lane has its own stack of STACK entries, culls against its own best t and
pushes the far child first; any-hit ends a lane's walk after the first
leaf that gives it a hit. It replaced a packet walk in which each ray paid
for its group's union of nodes and leaves. `_v5l_ref` is its plain torch
twin (`per_ray.walk_ref`, each lane's own pop sequence). Against the JAX
package it may differ on exact-t ties and grazing rays (ROADMAP C3).

Each wrapper takes the kernel for CUDA tensors and the plain version for
CPU tensors; `dense_trace_v5_ref`, `dense_trace_v5_dual_ref` and
`dense_trace_v5l_ref` run the plain version on any device, which is what
the kernels are compared with on the card. `LAUNCHES` counts kernel
launches per kernel.

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
from .dense_v4 import _pad
from .per_ray import _inv

GROUP = 1024  # rays per group: one packet walk per group
CLUSTER = 32  # triangles per BVH leaf (slot window)
STACK = 128  # traversal stack entries (the build checks the depth)
_BIG = 1e30

LAUNCHES = {"v5": 0, "v5_dual": 0, "v5l": 0}

_P, _I = ctypes.c_void_p, ctypes.c_int
_V5_ARGS = [_P, _I, _P, _P, _I, _P, _P, _P, _P, _I, _I, _P, _P, _P, _P, _P]
_DUAL_ARGS = [_P, _I, _P, _P, _I, _P, _P, _P, _P, _P, _P, _P, _I, _P, _P,
              _P, _P, _P, _P]
_V5L_ARGS = [_P, _P, _P, _I, _P, _P, _P, _P, _P, _I, _I, _P, _P, _P, _P, _P]


class _Lanes:
    """One query's per-lane terms, [G, 1024] each."""

    def __init__(self, org, direction, min_t, g):
        self.o = [c.reshape(g, GROUP) for c in org.unbind(1)]
        self.d = [c.reshape(g, GROUP) for c in direction.unbind(1)]
        self.mint = min_t.reshape(g, GROUP)
        self.inv = [_inv(c) for c in self.d]
        self.oi = [o * i for o, i in zip(self.o, self.inv)]

    def entry(self, box, cap):
        """Group-wide entry t into each group's box ([6, G]): the least
        slab entry t of the lanes that enter it before `cap`, else 1e30."""
        near, far = [], []
        for a in range(3):
            t0 = box[a][:, None] * self.inv[a] - self.oi[a]
            t1 = box[a + 3][:, None] * self.inv[a] - self.oi[a]
            near.append(torch.minimum(t0, t1))
            far.append(torch.maximum(t0, t1))
        tnear = torch.maximum(torch.maximum(near[0], near[1]),
                              torch.maximum(near[2], self.mint))
        tfar = torch.minimum(torch.minimum(far[0], far[1]),
                             torch.minimum(far[2], cap))
        return torch.where(tnear <= tfar * 1.00000024, tnear,
                           _BIG).amin(dim=1)


def _packet_ref(tris, node_aabb, node_meta, org, direction, min_t, max_t,
                any_hit=False, sdir=None, smin_t=None, smax_t=None):
    """Plain torch version of the two packet kernels: each group walks its
    stack as the Pallas body does, all groups in lock-step, one popped node
    per step (a group whose stack is empty idles). Rays are whole groups.
    Returns (t, u, v, prim, occluded or None); t = max_t where nothing was
    hit."""
    g = org.shape[0] // GROUP
    dev = org.device
    c = _Lanes(org, direction, min_t, g)
    maxt = max_t.reshape(g, GROUP)
    best_t = maxt.clone()
    best_u = torch.zeros_like(best_t)
    best_v = torch.zeros_like(best_t)
    best_p = torch.full_like(best_t, -1, dtype=torch.int32)
    gmax = best_t.amax(dim=1)
    occ = None
    if sdir is not None:
        s = _Lanes(org, sdir, smin_t, g)
        smaxt = smax_t.reshape(g, GROUP)
        s_dead = smaxt < s.mint
        occ = torch.zeros_like(s_dead)
        gmax = torch.maximum(gmax, torch.where(s_dead, -1.0, smaxt).amax(1))
    rows = torch.arange(g, device=dev)
    stk_id = torch.zeros((g, STACK), dtype=torch.int64, device=dev)
    stk_tn = torch.zeros((g, STACK), dtype=torch.float32, device=dev)
    stk_tn[:, 0] = -1e30
    sp = (gmax >= 0.0).to(torch.int64)
    while bool((sp > 0).any()):
        act = sp > 0
        sp = sp - act.to(torch.int64)
        top = sp.clamp(min=0)
        node = stk_id[rows, top]
        live = act & (stk_tn[rows, top] * (1.0 - 1e-6) - 1e-6 <= gmax)
        right = node_meta[0][node].to(torch.int64)
        leaf = live & (right < 0)
        inner = live & (right >= 0)
        if bool(leaf.any()):
            base = node_meta[1][node].clamp(min=0).to(torch.int64)
            (nx, ny, nz, k0, b1x, b1y, b1z, c1, b2x, b2y, b2z, c2) = (
                r[:, None, :] for r in per_ray.attr_major_rows(tris)(base))
            ox, oy, oz = (x[..., None] for x in c.o)
            dx, dy, dz = (x[..., None] for x in c.d)
            num = k0 - (ox * nx + oy * ny + oz * nz)  # [G, 1024, 32]
            ob1 = ox * b1x + oy * b1y + oz * b1z - c1
            ob2 = ox * b2x + oy * b2y + oz * b2z - c2
            t = num / (dx * nx + dy * ny + dz * nz)
            u = ob1 + t * (dx * b1x + dy * b1y + dz * b1z)
            v = ob2 + t * (dx * b2x + dy * b2y + dz * b2z)
            ok = ((u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
                  & (t >= c.mint[..., None]))
            # the first k of least t, then the kernels' strict t < best_t:
            # what the in-order loop over k with a strict test keeps
            tk, k = torch.where(ok, t, float("inf")).min(dim=2)
            better = leaf[:, None] & (tk < best_t)
            kk = k[..., None]
            best_u = torch.where(better, torch.gather(u, 2, kk)[..., 0],
                                 best_u)
            best_v = torch.where(better, torch.gather(v, 2, kk)[..., 0],
                                 best_v)
            best_p = torch.where(better, (base[:, None] + k).to(torch.int32),
                                 best_p)
            best_t = torch.where(better, tk, best_t)
            new_gmax = best_t.amax(dim=1)
            if occ is not None:
                sx, sy, sz = (x[..., None] for x in s.d)
                ts = num / (sx * nx + sy * ny + sz * nz)
                us = ob1 + ts * (sx * b1x + sy * b1y + sz * b1z)
                vs = ob2 + ts * (sx * b2x + sy * b2y + sz * b2z)
                oks = ((us >= 0.0) & (vs >= 0.0) & (us + vs <= 1.0)
                       & (ts >= s.mint[..., None]) & (ts < smaxt[..., None]))
                occ = occ | (leaf[:, None] & oks.any(dim=2))
                new_gmax = torch.maximum(new_gmax, torch.where(
                    s_dead | occ, -1.0, smaxt).amax(dim=1))
            gmax = torch.where(leaf, new_gmax, gmax)
            if any_hit:
                # every live lane occluded (dead lanes never block this)
                done = ((best_p >= 0) | (maxt < c.mint)).all(dim=1)
                sp = torch.where(leaf & done, 0, sp)
        if bool(inner.any()):
            left = node + 1
            rnode = right.clamp(min=0)
            box_l = node_aabb[:, left.clamp(max=node_aabb.shape[1] - 1)]
            box_r = node_aabb[:, rnode]
            tn_l = c.entry(box_l, best_t)
            tn_r = c.entry(box_r, best_t)
            if occ is not None:
                cap = torch.where(s_dead | occ, -_BIG, smaxt)
                tn_l = torch.minimum(tn_l, s.entry(box_l, cap))
                tn_r = torch.minimum(tn_r, s.entry(box_r, cap))
            l_far = tn_l > tn_r
            for push, nid, ntn in (
                    (torch.maximum(tn_l, tn_r) < _BIG,
                     torch.where(l_far, left, rnode),
                     torch.maximum(tn_l, tn_r)),
                    (torch.minimum(tn_l, tn_r) < _BIG,
                     torch.where(l_far, rnode, left),
                     torch.minimum(tn_l, tn_r))):
                push = inner & push  # far child first, near popped first
                at = sp.clamp(max=STACK - 1)
                stk_id[rows, at] = torch.where(push, nid, stk_id[rows, at])
                stk_tn[rows, at] = torch.where(push, ntn, stk_tn[rows, at])
                sp = sp + push.to(torch.int64)
    flat = [x.reshape(-1) for x in (best_t, best_u, best_v, best_p)]
    return (*flat, None if occ is None else occ.reshape(-1))


def _packet_cuda(tris, node_aabb, node_meta, org, direction, min_t, max_t,
                 any_hit=False, sdir=None, smin_t=None, smax_t=None):
    """Launch one dense_v5 packet kernel on the current stream; same
    returns as `_packet_ref` (any_hit may stop a group at its first
    hits)."""
    dev = org.device
    n = org.shape[0]
    g = n // GROUP
    nn = node_aabb.shape[1]
    f32, i32 = torch.float32, torch.int32
    checks = [(tris, f32, (12, tris.shape[1])), (node_aabb, f32, (6, nn)),
              (node_meta, i32, (2, nn)), (org, f32, (n, 3)),
              (direction, f32, (n, 3)), (min_t, f32, (n,)),
              (max_t, f32, (n,))]
    if sdir is not None:
        checks += [(sdir, f32, (n, 3)), (smin_t, f32, (n,)),
                   (smax_t, f32, (n,))]
    for x, dtype, shape in checks:
        cuda_lib.check_tensor("dense_v5", x, dtype, shape, dev)
    if n != g * GROUP:
        raise ValueError(f"dense_v5 wants whole groups of {GROUP} rays; "
                         f"got {n}")
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
        if sdir is None:
            kind = "v5"
            rc = cuda_lib.function("dense_v5_trace", _V5_ARGS)(
                *head, int(any_hit), g, *outs, stream)
        else:
            kind = "v5_dual"
            occ = torch.empty((n,), dtype=torch.uint8, device=dev)
            rc = cuda_lib.function("dense_v5_trace_dual", _DUAL_ARGS)(
                *head, sdir.data_ptr(), smin_t.data_ptr(), smax_t.data_ptr(),
                g, *outs, occ.data_ptr(), stream)
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
    """Pad to whole groups, walk (kernel on CUDA tensors unless plain),
    unpad."""
    n = org.shape[0]
    n_pad = (n + GROUP - 1) // GROUP * GROUP
    args = [_pad(org, n_pad, 0.0), _pad(direction, n_pad, 1.0),
            _pad(min_t, n_pad, 0.0),
            torch.clamp(_pad(max_t, n_pad, -1.0), max=INF)]
    kernel = org.is_cuda and not plain
    occ = None
    if leaf_major:
        roots = None
        if group_roots is not None:
            roots = group_roots.to(torch.int32).contiguous()
        walk = _v5l_cuda if kernel else _v5l_ref
        t, u, v, prim = walk(tris.contiguous(), node_aabb.contiguous(),
                             node_meta.contiguous(), roots, *args,
                             any_hit=any_hit)
    else:
        kw = {"any_hit": any_hit}
        if shadow is not None:
            sdir, smin_t, smax_t = shadow
            kw.update(sdir=_pad(sdir, n_pad, 1.0),
                      smin_t=_pad(smin_t, n_pad, 0.0),
                      smax_t=torch.clamp(_pad(smax_t, n_pad, -1.0), max=INF))
        walk = _packet_cuda if kernel else _packet_ref
        t, u, v, prim, occ = walk(tris.contiguous(), node_aabb.contiguous(),
                                  node_meta.contiguous(), *args, **kw)
    hit = prim[:n] >= 0
    res = {"t": torch.where(hit, t[:n], INF), "u": u[:n], "v": v[:n],
           "prim": prim[:n]}
    return res if occ is None else (res, occ[:n])


def dense_trace_v5(packed_tris, node_aabb, node_meta, org, direction, min_t,
                   max_t, any_hit=False):
    """Closest (or any) hit per lane over the attr-major [12, S] table ->
    dict(t, u, v, prim). With any_hit only `prim >= 0` is meaningful."""
    return _trace(packed_tris, False, node_aabb, node_meta, org, direction,
                  min_t, max_t, any_hit=any_hit)


def dense_trace_v5_dual(packed_tris, node_aabb, node_meta, org, direction,
                        min_t, max_t, sdir, smin_t, smax_t):
    """Closest hit + shadow any-hit sharing the origin `org` (deferred
    NEE) in one walk -> (dict(t, u, v, prim), occluded bool)."""
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
