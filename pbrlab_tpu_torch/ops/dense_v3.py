"""Legacy dense v3 triangle trace: brute force over 128-triangle Morton
clusters, each ray walking the clusters it enters front to back.

Port of pbrlab_tpu/ops/pallas/dense_v3.py. One kernel, written by hand in
CUDA for Hopper (`csrc/dense_v3.cu`, `dense_v3_trace`), replaces the
Pallas `_trace_kernel`. It traces the v1 tables (`ops/dense.py`
`pack_triangles`: the scene's `dense_tris`, `dense_cluster_aabb`); the
render reaches it with `tri_backend="dense3"`.

The walk is per ray (`csrc/per_ray.cuh` `cluster_walk`, one thread a
ray): in chunks of 256 clusters in cluster order, each lane slab-tests
its ray against the chunk's boxes (the legacy `(box - o) * inv`
arithmetic of the JAX package's `cluster_mask`) capped at its own best
t, orders the clusters it enters by entry t and tests their 128
triangles front to back until its best t lies before the next entry;
any-hit ends a lane's walk after the first cluster that gives it a hit.
The TPU kernel walks survivor lists of 128-ray groups instead, which an
XLA prelude builds (a conservative beam cull per group, or with
cull="exact" the per-ray box test reduced per group, and an argsort by
the group's least entry t); every lane of a group tests every triangle
of every survivor until the group's largest best t lies before the next
one. Each lane culls exactly here, so no prelude runs, on any device,
and `cull` no longer changes the answer: it stays in the signature for
parity with the JAX package's `dense_trace_v3`.

Ties: the TPU keeps one running best per slot (id mod 8) with max_t
folded into the initial best and a strict `t < best`, and at the end
takes the least t, the lowest slot with a hit on ties; one best per lane
with the rule of `per_ray.beats_ref` keeps the same lexicographic minimum
of (t, id mod 8), the first visited on a full tie. Against the JAX
package the two walks may differ on rays that graze a cluster box and on
full ties (ROADMAP C3).

The wrapper takes the kernel for CUDA tensors and the plain torch twin
(`_walk_ref`, each lane's own walk) for CPU tensors; `dense_trace_v3_ref`
runs the twin on any device, which is what the kernel is compared with on
the card. `LAUNCHES` counts kernel launches per mode. prim is the id in
the SORTED order, int32 (float32 on the TPU: ROADMAP C9).
"""
from __future__ import annotations

import ctypes

import torch

from . import cuda_lib, per_ray
from .dense import TRI_BLOCK, finish, tri_test
from .dense_curve import _inv, clamped_rays

CULLS = ("beam", "exact")  # the JAX package's; the answer is the same

LAUNCHES = {"closest": 0, "any_hit": 0}


def _walk_ref(tris, aabb, org, direction, min_t, max_t, any_hit=False,
              counts=False):
    """Plain torch twin of the kernel (max_t already clamped to INF): each
    lane's walk (`per_ray.cluster_walk` over `per_ray.diff_enter`), a
    cluster's 128 triangles tested as one [k, 128] block with the Pallas
    body's operations (`dense.tri_test`) and kept with
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
        per_ray.beats_ref(ln, ids, t, ok, u, v, best)

    return per_ray.cluster_walk(
        aabb.shape[1], TRI_BLOCK,
        per_ray.diff_enter(aabb, org, _inv(direction), min_t), visit, min_t,
        max_t, any_hit=any_hit, counts=counts)


_P, _I = ctypes.c_void_p, ctypes.c_int
# tris, fpad, aabb, clusters, org, dir, min_t, max_t, any_hit, n, outs,
# stream
_ARGS = [_P, _I, _P, _I, _P, _P, _P, _P, _I, _I, _P, _P, _P, _P, _P]


def _walk_cuda(tris, aabb, org, direction, min_t, max_t, any_hit=False):
    """Launch the dense v3 kernel on the current stream; same first four
    returns as `_walk_ref`."""
    dev = org.device
    n = org.shape[0]
    m = aabb.shape[1]
    f32 = torch.float32
    check = cuda_lib.check_tensor
    check("dense v3", tris, f32, (12, m * TRI_BLOCK), dev)
    check("dense v3", aabb, f32, (8, m), dev)
    for x, shape in ((org, (n, 3)), (direction, (n, 3)), (min_t, (n,)),
                     (max_t, (n,))):
        check("dense v3", x, f32, shape, dev)
    # cluster c's columns start at 128 c: one float4 is 4 triangles
    cuda_lib.check_float4_rows("dense v3", tris, tris.shape[1])
    t = torch.empty((n,), dtype=f32, device=dev)
    u = torch.empty_like(t)
    v = torch.empty_like(t)
    prim = torch.empty((n,), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = cuda_lib.function("dense_v3_trace", _ARGS)(
            tris.data_ptr(), tris.shape[1], aabb.data_ptr(), m,
            org.data_ptr(), direction.data_ptr(), min_t.data_ptr(),
            max_t.data_ptr(), int(any_hit), n, t.data_ptr(), u.data_ptr(),
            v.data_ptr(), prim.data_ptr(), stream)
    kind = "any_hit" if any_hit else "closest"
    cuda_lib.launched(f"dense v3 {kind}", rc)
    LAUNCHES[kind] += 1
    return t, u, v, prim


def _trace(packed, aabb, org, direction, min_t, max_t, any_hit, cull,
           plain):
    if cull not in CULLS:
        raise ValueError(f"unknown cull {cull!r}")
    walk = _walk_cuda if org.is_cuda and not plain else _walk_ref
    return finish(*walk(packed.contiguous(), aabb.contiguous(),
                        *clamped_rays(org, direction, min_t, max_t),
                        any_hit=any_hit), org.shape[0])


def dense_trace_v3(packed_tris, cluster_aabb, org, direction, min_t, max_t,
                   any_hit=False, cull="beam"):
    """Closest (or any) hit vs the v1 tables -> dict(t, u, v, prim): prim
    indexes the SORTED order (-1 and t = INF on a miss). cull ("beam" or
    "exact": the JAX package's group culls) does not change the answer:
    each lane culls exactly. With any_hit only `prim >= 0` is
    meaningful."""
    return _trace(packed_tris, cluster_aabb, org, direction, min_t, max_t,
                  any_hit, cull, plain=False)


def dense_trace_v3_ref(packed_tris, cluster_aabb, org, direction, min_t,
                       max_t, any_hit=False, cull="beam"):
    """Plain torch version of `dense_trace_v3` on any device."""
    return _trace(packed_tris, cluster_aabb, org, direction, min_t, max_t,
                  any_hit, cull, plain=True)
