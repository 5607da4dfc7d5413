"""dense_v4 triangle trace: survivor-list walk over 32-triangle clusters.

Port of pbrlab_tpu/ops/pallas/dense_v4.py. Two kernels, written by hand in
CUDA for Hopper (`csrc/dense_v4.cu`), replace the two Pallas kernels:

* `dense_trace_v4` -> `dense_v4_trace` replaces `_trace_kernel`: closest
  hit (or any-hit) of one ray per lane;
* `dense_trace_v4_dual` -> `dense_v4_trace_dual` replaces
  `_trace_kernel_dual`: the closest hit plus the deferred-NEE shadow
  any-hit from the same origin, in one walk.

The prelude stays plain torch, as it stayed XLA in the JAX package: an
exact per-ray slab test against every cluster AABB, reduced to per-group
(1024 rays) survivor masks and tnear lower bounds, then a stable argsort
into front-to-back survivor lists.

Each wrapper takes the kernel for CUDA tensors and the plain torch walk
(`_walk_ref`) for CPU tensors; `dense_trace_v4_ref` and
`dense_trace_v4_dual_ref` run the plain walk on any device, which is what
the kernels are compared with on the card. `LAUNCHES` counts kernel
launches per entry point.

Contract (as the JAX package): rays (org, direction, min_t, max_t) are
float32, max_t < min_t marks a dead lane; results are t, u, v (float32)
and prim (int32 slot id, -1 on a miss, t = INF on a miss), and for the
dual query an occluded bool per lane (False where smax_t < smin_t).
"""
from __future__ import annotations

import ctypes

import torch

from ..core.math import INF
from . import cuda_lib

GROUP = 1024  # rays per group: one survivor list per group
CLUSTER = 32  # triangles per cluster (SAH leaf window)
_BIG = 1e30

LAUNCHES = {"single": 0, "dual": 0}


def slab_interval(aabb, org, direction, min_t):
    """Ray-box slab test of N rays against M boxes (rows 0:3 lo, 3:6 hi of
    `aabb`) -> (tnear [N, M] clipped below by min_t, tfar [N, M])."""
    inv = 1.0 / torch.where(torch.abs(direction) < 1e-12,
                            torch.where(direction < 0.0, -1e-12, 1e-12),
                            direction)

    def axis(k):
        t0 = (aabb[k][None, :] - org[:, k:k + 1]) * inv[:, k:k + 1]
        t1 = (aabb[k + 3][None, :] - org[:, k:k + 1]) * inv[:, k:k + 1]
        return torch.minimum(t0, t1), torch.maximum(t0, t1)

    n0, f0 = axis(0)
    n1, f1 = axis(1)
    n2, f2 = axis(2)
    tnear = torch.maximum(torch.maximum(torch.maximum(n0, n1), n2),
                          min_t[:, None])
    return tnear, torch.minimum(torch.minimum(f0, f1), f2)


def exact_group_survivors(cluster_aabb, org, direction, min_t, max_t,
                          group=GROUP):
    """Exact per-ray slab test -> per-group survivor mask + tnear bound.

    Returns (gm [G, M] bool, tnear_lo [G, M] f32): gm[g, c] iff any ray of
    group g can hit cluster c within its [min_t, max_t]; tnear_lo is the
    min over those rays of the slab tnear, the front-to-back sort key.
    """
    n = org.shape[0]
    tnear, tfar = slab_interval(cluster_aabb, org, direction, min_t)
    tfar = torch.minimum(tfar, max_t[:, None])
    mask = (tnear <= tfar * 1.00000024) & (max_t >= min_t)[:, None]
    m = cluster_aabb.shape[1]
    gm = mask.reshape(n // group, group, m).any(dim=1)
    tnear_lo = torch.where(mask, tnear, _BIG).reshape(
        n // group, group, m).amin(dim=1)
    return gm, tnear_lo


def _survivor_lists(gm, tnear_lo):
    """-> (surv [G, M] int32 front-to-back cluster ids, cnt [G] int32,
    tnear [G, M] f32 sorted bounds); entries past cnt[g] are not walked."""
    key = torch.where(gm, tnear_lo, _BIG)
    surv = torch.argsort(key, dim=1, stable=True)
    return (surv.to(torch.int32).contiguous(),
            gm.sum(dim=1).to(torch.int32),
            torch.gather(key, 1, surv).contiguous())


def _pad(x, n_pad, value):
    """Pad the lane axis to n_pad with `value` (as the JAX wrapper pads:
    org 0, directions 1, min_t 0, max_t -1 = dead)."""
    pad = n_pad - x.shape[0]
    if pad:
        x = torch.cat([x, x.new_full((pad,) + tuple(x.shape[1:]), value)])
    return x.contiguous()


def _walk_ref(tris, surv, cnt, org, direction, min_t, max_t,
              sdir=None, smin_t=None, smax_t=None):
    """Plain torch version of both kernels, vectorized over [G, 1024, 32]
    blocks: walks every group's survivors in list order with no early exit
    (which changes no result, see csrc/dense_v4.cu), keeping per lane the
    first-visited triangle of least t. With sdir it also answers the
    shadow any-hit query. Returns (t, u, v, prim, occluded or None), padded
    to the input lane count, t = max_t where nothing was hit."""
    g = surv.shape[0]

    def lanes(x):  # [N] or [N, 3] -> per-component [G, 1024, 1]
        x = x.reshape(g, GROUP, -1, 1)
        return [x[:, :, j] for j in range(x.shape[2])]

    ox, oy, oz = lanes(org)
    dx, dy, dz = lanes(direction)
    (mint,) = lanes(min_t)
    best_t = max_t.reshape(g, GROUP).clone()
    best_u = torch.zeros_like(best_t)
    best_v = torch.zeros_like(best_t)
    best_p = torch.full_like(best_t, -1, dtype=torch.int32)
    occ = None
    if sdir is not None:
        sx, sy, sz = lanes(sdir)
        (smint,) = lanes(smin_t)
        (smaxt,) = lanes(smax_t)
        occ = torch.zeros_like(best_t, dtype=torch.bool)
    ks = torch.arange(CLUSTER, device=tris.device)
    for si in range(int(cnt.max()) if g else 0):
        live = (si < cnt)[:, None, None]
        slot = surv[:, si].to(torch.int64)[:, None] * CLUSTER + ks  # [G, 32]
        (nx, ny, nz, k0, b1x, b1y, b1z, c1,
         b2x, b2y, b2z, c2) = tris[:, slot][:, :, None, :].unbind(0)
        num = k0 - (ox * nx + oy * ny + oz * nz)  # [G, 1024, 32]
        ob1 = ox * b1x + oy * b1y + oz * b1z - c1
        ob2 = ox * b2x + oy * b2y + oz * b2z - c2
        t = num / (dx * nx + dy * ny + dz * nz)
        u = ob1 + t * (dx * b1x + dy * b1y + dz * b1z)
        v = ob2 + t * (dx * b2x + dy * b2y + dz * b2z)
        ok = (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t >= mint) & live
        # first k of least t, then the strict t < best_t of the kernels
        tk, k = torch.where(ok, t, float("inf")).min(dim=2)
        better = tk < best_t
        best_u = torch.where(better, torch.gather(u, 2, k[..., None])[..., 0],
                             best_u)
        best_v = torch.where(better, torch.gather(v, 2, k[..., None])[..., 0],
                             best_v)
        best_p = torch.where(better, torch.gather(slot, 1, k).to(torch.int32),
                             best_p)
        best_t = torch.where(better, tk, best_t)
        if occ is not None:
            ts = num / (sx * nx + sy * ny + sz * nz)
            us = ob1 + ts * (sx * b1x + sy * b1y + sz * b1z)
            vs = ob2 + ts * (sx * b2x + sy * b2y + sz * b2z)
            oks = ((us >= 0.0) & (vs >= 0.0) & (us + vs <= 1.0)
                   & (ts >= smint) & (ts < smaxt) & live)
            occ = occ | oks.any(dim=2)
    flat = [x.reshape(-1) for x in (best_t, best_u, best_v, best_p)]
    return (*flat, None if occ is None else occ.reshape(-1))


_P, _I = ctypes.c_void_p, ctypes.c_int
_TRACE_ARGS = [_P, _I, _P, _P, _P, _I, _P, _P, _P, _P, _I, _I,
               _P, _P, _P, _P, _P]
_DUAL_ARGS = [_P, _I, _P, _P, _P, _I, _P, _P, _P, _P,
              _P, _P, _P, _I, _P, _P, _P, _P, _P, _P]


def _check(x, dtype, shape, device):
    cuda_lib.check_tensor("dense_v4", x, dtype, shape, device)


def _walk_cuda(tris, surv, cnt, tnear, org, direction, min_t, max_t,
               sdir=None, smin_t=None, smax_t=None, any_hit=False):
    """Launch one dense_v4 kernel on the current stream; same returns as
    `_walk_ref` (any_hit stops each lane at its first hit)."""
    dev = org.device
    n = org.shape[0]
    g, m = surv.shape
    f32, i32 = torch.float32, torch.int32
    _check(tris, f32, (12, tris.shape[1]), dev)
    _check(surv, i32, (g, m), dev)
    _check(cnt, i32, (g,), dev)
    _check(tnear, f32, (g, m), dev)
    rays = [(org, (n, 3)), (direction, (n, 3)), (min_t, (n,)), (max_t, (n,))]
    if sdir is not None:
        rays += [(sdir, (n, 3)), (smin_t, (n,)), (smax_t, (n,))]
    for x, shape in rays:
        _check(x, f32, shape, dev)
    if n != g * GROUP:
        raise ValueError(f"{n} lanes is not {g} groups of {GROUP}")
    t = torch.empty((n,), dtype=f32, device=dev)
    u = torch.empty_like(t)
    v = torch.empty_like(t)
    prim = torch.empty((n,), dtype=i32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        head = [tris.data_ptr(), tris.shape[1], surv.data_ptr(),
                cnt.data_ptr(), tnear.data_ptr(), m, org.data_ptr(),
                direction.data_ptr(), min_t.data_ptr(), max_t.data_ptr()]
        outs = [t.data_ptr(), u.data_ptr(), v.data_ptr(), prim.data_ptr()]
        if sdir is None:
            occ = None
            kind = "single"
            rc = cuda_lib.function("dense_v4_trace", _TRACE_ARGS)(
                *head, int(any_hit), n, *outs, stream)
        else:
            occ = torch.empty((n,), dtype=torch.uint8, device=dev)
            kind = "dual"
            rc = cuda_lib.function("dense_v4_trace_dual", _DUAL_ARGS)(
                *head, sdir.data_ptr(), smin_t.data_ptr(), smax_t.data_ptr(),
                n, *outs, occ.data_ptr(), stream)
            occ = occ.bool()
    cuda_lib.launched(f"dense_v4 {kind}", rc)
    LAUNCHES[kind] += 1
    return t, u, v, prim, occ


def _trace(packed_tris, cluster_aabb, org, direction, min_t, max_t,
           shadow=None, any_hit=False, plain=False):
    """Pad, cull, sort, walk (kernel on CUDA tensors unless plain), unpad."""
    n = org.shape[0]
    n_pad = (n + GROUP - 1) // GROUP * GROUP
    org = _pad(org, n_pad, 0.0)
    direction = _pad(direction, n_pad, 1.0)
    min_t = _pad(min_t, n_pad, 0.0)
    max_t = torch.clamp(_pad(max_t, n_pad, -1.0), max=INF)
    gm, tnear_lo = exact_group_survivors(cluster_aabb, org, direction,
                                         min_t, max_t)
    sargs = ()
    if shadow is not None:
        sdir, smin_t, smax_t = shadow
        sdir = _pad(sdir, n_pad, 1.0)
        smin_t = _pad(smin_t, n_pad, 0.0)
        smax_t = torch.clamp(_pad(smax_t, n_pad, -1.0), max=INF)
        gm_s, tn_s = exact_group_survivors(cluster_aabb, org, sdir,
                                           smin_t, smax_t)
        gm = gm | gm_s
        tnear_lo = torch.minimum(tnear_lo, tn_s)
        sargs = (sdir, smin_t, smax_t)
    surv, cnt, tnear = _survivor_lists(gm, tnear_lo)
    tris = packed_tris.contiguous()
    if org.is_cuda and not plain:
        t, u, v, prim, occ = _walk_cuda(tris, surv, cnt, tnear, org,
                                        direction, min_t, max_t, *sargs,
                                        any_hit=any_hit)
    else:
        t, u, v, prim, occ = _walk_ref(tris, surv, cnt, org, direction,
                                       min_t, max_t, *sargs)
    hit = prim[:n] >= 0
    res = {"t": torch.where(hit, t[:n], INF), "u": u[:n], "v": v[:n],
           "prim": prim[:n]}
    return res if occ is None else (res, occ[:n])


def dense_trace_v4(packed_tris, cluster_aabb, org, direction, min_t, max_t,
                   any_hit=False):
    """Closest hit (or any hit) per lane -> dict(t, u, v, prim). With
    any_hit only `prim >= 0` is meaningful: t, u, v may be of any hit."""
    return _trace(packed_tris, cluster_aabb, org, direction, min_t, max_t,
                  any_hit=any_hit)


def dense_trace_v4_dual(packed_tris, cluster_aabb, org, direction, min_t,
                        max_t, sdir, smin_t, smax_t):
    """Closest hit + shadow any-hit sharing the origin `org` (deferred
    NEE) -> (dict(t, u, v, prim), occluded bool)."""
    return _trace(packed_tris, cluster_aabb, org, direction, min_t, max_t,
                  shadow=(sdir, smin_t, smax_t))


def dense_trace_v4_ref(packed_tris, cluster_aabb, org, direction, min_t,
                       max_t):
    """Plain torch version of `dense_trace_v4` (closest) on any device."""
    return _trace(packed_tris, cluster_aabb, org, direction, min_t, max_t,
                  plain=True)


def dense_trace_v4_dual_ref(packed_tris, cluster_aabb, org, direction,
                            min_t, max_t, sdir, smin_t, smax_t):
    """Plain torch version of `dense_trace_v4_dual` on any device."""
    return _trace(packed_tris, cluster_aabb, org, direction, min_t, max_t,
                  shadow=(sdir, smin_t, smax_t), plain=True)
