"""Legacy dense v3 triangle trace: brute force over 128-triangle Morton
clusters, each ray walking the clusters it enters front to back.

Port of pbrlab_tpu/ops/pallas/dense_v3.py. One kernel, written by hand in
CUDA for Hopper (`csrc/dense_legacy.cu`, `dense_v3_trace`), replaces the
Pallas `_trace_kernel`. It traces the v1 tables (`ops/dense.py`
`pack_triangles`: the scene's `dense_tris`, `dense_cluster_aabb`); the
render reaches it with `tri_backend="dense3"`.

The walk is per ray (`csrc/per_ray.cuh` `cluster_walk`, one thread a
ray; the twin of all three legacy kernels is `ops/dense.py` `walk_ref`):
in chunks of 256 clusters in cluster order, each lane slab-tests
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
with `per_ray.SLOT_RULE` keeps the same lexicographic minimum of (t, id
mod 8), the first visited on a full tie (the TPU visits a group's
survivors in the group's entry order, not the lane's, so no id key is
added). Against the JAX package the two walks may differ on rays that
graze a cluster box and on full ties (ROADMAP C3).

The wrapper takes the kernel for CUDA tensors and the plain torch twin
(`_walk_ref`, each lane's own walk) for CPU tensors; `dense_trace_v3_ref`
runs the twin on any device, which is what the kernel is compared with on
the card. `LAUNCHES` counts kernel launches per mode. prim is the id in
the SORTED order, int32 (float32 on the TPU: ROADMAP C9).
"""
from __future__ import annotations

from functools import partial

from . import per_ray
from .dense import launch, trace, walk_ref

CULLS = ("beam", "exact")  # the JAX package's; the answer is the same

LAUNCHES = {"closest": 0, "any_hit": 0}

_walk_ref = partial(walk_ref, per_ray.SLOT_RULE)


def _walk_cuda(tris, aabb, org, direction, min_t, max_t, any_hit=False):
    """Launch the dense v3 kernel on the current stream; same first four
    returns as `_walk_ref`."""
    out = launch("dense_v3_trace", int(any_hit), tris, aabb, org, direction,
                 min_t, max_t)
    LAUNCHES["any_hit" if any_hit else "closest"] += 1
    return out


def _trace(packed, aabb, org, direction, min_t, max_t, any_hit, cull,
           plain):
    if cull not in CULLS:
        raise ValueError(f"unknown cull {cull!r}")
    return trace(_walk_cuda, _walk_ref, packed, aabb, org, direction, min_t,
                 max_t, any_hit, plain)


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
