"""dense_v4 triangle trace: per-ray walk over 32-triangle clusters.

Port of pbrlab_tpu/ops/pallas/dense_v4.py. Two kernels, written by hand in
CUDA for Hopper (`csrc/dense_v4.cu`), replace the two Pallas kernels:

* `dense_trace_v4` -> `dense_v4_trace` replaces `_trace_kernel`: closest
  hit (or any-hit) of one ray per lane;
* `dense_trace_v4_dual` -> `dense_v4_trace_dual` replaces
  `_trace_kernel_dual`: the closest hit plus the deferred-NEE shadow
  any-hit from the same origin, in one launch.

Both walk per ray (`csrc/per_ray.cuh` `cluster_walk`, one thread per
ray): each lane slab-tests its ray against every cluster box, orders the
clusters it enters by entry t and tests them front to back until its own
best t lies before the next entry; any-hit ends a lane's walk after the
first cluster that gives it a hit. The dual walks a lane's closest ray,
then its shadow ray as an any-hit query from the same origin, so its
closest answer is `dense_trace_v4`'s to the bit. They replace the TPU's
group walk, in which an XLA prelude (`exact_group_survivors` + argsort)
reduced every ray's slab tests to one survivor list per 1024-ray group
and each ray walked its group's list. `_v4_ref` is the plain torch twin
(`per_ray.cluster_walk_ref`, each lane's own list). Against the JAX
package the two may differ on exact-t ties and on rays that graze a
cluster box (ROADMAP C3).

Each wrapper takes the kernel for CUDA tensors and the twin for CPU
tensors; `dense_trace_v4_ref` and `dense_trace_v4_dual_ref` run the twin
on any device, which is what the kernels are compared with on the card.
`LAUNCHES` counts kernel launches per entry point.

Contract (as the JAX package): rays (org, direction, min_t, max_t) are
float32, max_t < min_t marks a dead lane; results are t, u, v (float32)
and prim (int32 slot id, -1 on a miss, t = INF on a miss), and for the
dual query an occluded bool per lane (False where smax_t < smin_t).
"""
from __future__ import annotations

import ctypes

import torch

from ..core.math import INF
from . import cuda_lib, per_ray

CLUSTER = 32  # triangles per cluster (SAH leaf window)
MAX_CLUSTERS = 256  # the kernels' per-lane list (csrc/dense_v4.cu)

LAUNCHES = {"single": 0, "dual": 0}


def slab_interval(aabb, org, direction, min_t):
    """Ray-box slab test of N rays against M boxes (rows 0:3 lo, 3:6 hi of
    `aabb`) -> (tnear [N, M] clipped below by min_t, tfar [N, M]), in the
    arithmetic of the TPU kernels' prelude (`exact_group_survivors` of
    pbrlab_tpu/ops/pallas/dense_v4.py). The integrator's compaction
    signature uses it, and chip_smoke.py's count of the clusters a lane
    needs."""
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


def _v4_ref(tris, cluster_aabb, org, direction, min_t, max_t,
            any_hit=False, shadow=None, counts=False):
    """Plain torch twin of both kernels: every lane's own cluster walk
    (`per_ray.cluster_walk_ref`), and with shadow = (sdir, smin_t, smax_t)
    then its shadow ray's any-hit walk. Returns (t, u, v, prim, occluded
    or None) and, with counts, each lane's ray-triangle and ray-box tests
    [N, 3] over both walks; t = max_t where nothing was hit."""
    out = per_ray.cluster_walk_ref(tris, cluster_aabb, org, direction, min_t,
                                   max_t, any_hit=any_hit, counts=counts)
    occ = None
    if shadow is not None:
        s_out = per_ray.cluster_walk_ref(tris, cluster_aabb, org, *shadow,
                                         any_hit=True, counts=counts)
        occ = s_out[3] >= 0
    if not counts:
        return (*out, occ)
    work = out[4] if shadow is None else out[4] + s_out[4]
    return (*out[:4], occ, work)


_P, _I = ctypes.c_void_p, ctypes.c_int
# tris, slots, cluster_aabb, clusters, org, dir, min_t, max_t
_HEAD = [_P, _I, _P, _I, _P, _P, _P, _P]
_TRACE_ARGS = _HEAD + [_I, _I, _P, _P, _P, _P, _P]  # any_hit, n, outs, stream
_DUAL_ARGS = _HEAD + [_P, _P, _P, _I, _P, _P, _P, _P, _P, _P]


def _v4_cuda(tris, cluster_aabb, org, direction, min_t, max_t,
             any_hit=False, shadow=None):
    """Launch the dense_v4 kernel, or with shadow the dual one, on the
    current stream; same returns as `_v4_ref`."""
    dev = org.device
    n = org.shape[0]
    rows, m = cluster_aabb.shape
    f32, i32 = torch.float32, torch.int32
    if rows < 6 or not 0 < m <= MAX_CLUSTERS:
        raise ValueError(f"dense_v4 kernel wants [>= 6, M] cluster boxes "
                         f"with 0 < M <= {MAX_CLUSTERS}; got {rows} x {m}")
    checks = [(tris, f32, (12, CLUSTER * m)), (cluster_aabb, f32, (rows, m)),
              (org, f32, (n, 3)), (direction, f32, (n, 3)),
              (min_t, f32, (n,)), (max_t, f32, (n,))]
    if shadow is not None:
        checks += zip(shadow, (f32,) * 3, ((n, 3), (n,), (n,)))
    for x, dtype, shape in checks:
        cuda_lib.check_tensor("dense_v4", x, dtype, shape, dev)
    # cluster c's rows start at slot 32 c
    cuda_lib.check_float4_rows("dense_v4", tris, tris.shape[1])
    t = torch.empty((n,), dtype=f32, device=dev)
    u = torch.empty_like(t)
    v = torch.empty_like(t)
    prim = torch.empty((n,), dtype=i32, device=dev)
    outs = [t.data_ptr(), u.data_ptr(), v.data_ptr(), prim.data_ptr()]
    head = [tris.data_ptr(), tris.shape[1], cluster_aabb.data_ptr(), m,
            org.data_ptr(), direction.data_ptr(), min_t.data_ptr(),
            max_t.data_ptr()]
    occ = None
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if shadow is None:
            kind = "single"
            rc = cuda_lib.function("dense_v4_trace", _TRACE_ARGS)(
                *head, int(any_hit), n, *outs, stream)
        else:
            kind = "dual"
            occ = torch.empty((n,), dtype=torch.uint8, device=dev)
            rc = cuda_lib.function("dense_v4_trace_dual", _DUAL_ARGS)(
                *head, *(x.data_ptr() for x in shadow), n, *outs,
                occ.data_ptr(), stream)
    cuda_lib.launched(f"dense_v4 {kind}", rc)
    LAUNCHES[kind] += 1
    return t, u, v, prim, None if occ is None else occ.bool()


def _trace(packed_tris, cluster_aabb, org, direction, min_t, max_t,
           shadow=None, any_hit=False, plain=False):
    """Walk (the kernel on CUDA tensors unless plain); t = INF on a miss."""
    tables = [x.contiguous() for x in (packed_tris, cluster_aabb)]
    rays = [org.contiguous(), direction.contiguous(), min_t.contiguous(),
            torch.clamp(max_t, max=INF)]
    if shadow is not None:
        sdir, smin_t, smax_t = shadow
        shadow = (sdir.contiguous(), smin_t.contiguous(),
                  torch.clamp(smax_t, max=INF))
    walk = _v4_cuda if org.is_cuda and not plain else _v4_ref
    t, u, v, prim, occ = walk(*tables, *rays, any_hit=any_hit, shadow=shadow)
    res = {"t": torch.where(prim >= 0, t, INF), "u": u, "v": v, "prim": prim}
    return res if occ is None else (res, occ)


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
