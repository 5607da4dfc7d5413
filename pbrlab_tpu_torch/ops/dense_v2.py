"""Legacy dense v2 triangle trace: brute force over 128-triangle Morton
clusters, each ray walking the clusters it enters front to back.

Port of pbrlab_tpu/ops/pallas/dense_v2.py. One kernel, written by hand in
CUDA for Hopper (`csrc/dense_legacy.cu`, `dense_v2_trace`), replaces the
Pallas `_trace_kernel`. It traces the v1 tables (`ops/dense.py`
`pack_triangles`: the scene's `dense_tris`, `dense_cluster_aabb`); the
render reaches it with `tri_backend="dense"`.

The walk is the per-ray walk of all three legacy kernels (`ops/dense.py`:
each lane tests the clusters its own ray enters, in the order of its own
entry t, until its own best t; any-hit ends a lane's walk after the
first cluster that gives it a hit). The TPU walks 128-ray groups
instead: a group enters cluster c when any of its lanes' slab tests
passes against that lane's running best t (`jnp.any`), with any_hit
until every lane has a hit (`jnp.all`), and every lane tests the 128
triangles of every cluster its group enters.

Ties (`V2_RULE`): the TPU keeps one running best per sublane slot (id mod
8), max_t folded into the initial best and a strict `t < best`, walks the
clusters in index order and at the end takes the least t, the lowest
slot on ties: the lexicographic minimum of (t, id mod 8, id), which no
visit order changes. With any_hit only `prim >= 0` is meaningful.
Against the JAX package the walks may differ on rays that graze a
cluster box (ROADMAP C3).

The wrapper takes the kernel for CUDA tensors and the twin (`_walk_ref`)
for CPU tensors; `dense_trace_v2_ref` runs the twin on any device, which
is what the kernel is compared with on the card. `LAUNCHES` counts kernel
launches per mode. prim is the id in the SORTED order, int32 (float32 on
the TPU: ROADMAP C9); the caller maps it back through the scene's
`dense_order`.
"""
from __future__ import annotations

from functools import partial

from . import per_ray
from .dense import launch, trace, walk_ref

V2_RULE = per_ray.TieRule(slots=8, by_id=True)

LAUNCHES = {"closest": 0, "any_hit": 0}

_walk_ref = partial(walk_ref, V2_RULE)


def _walk_cuda(tris, aabb, org, direction, min_t, max_t, any_hit=False):
    """Launch the dense v2 kernel on the current stream; same first four
    returns as `_walk_ref`."""
    out = launch("dense_v2_trace", int(any_hit), tris, aabb, org, direction,
                 min_t, max_t)
    LAUNCHES["any_hit" if any_hit else "closest"] += 1
    return out


def dense_trace_v2(packed_tris, cluster_aabb, org, direction, min_t, max_t,
                   any_hit=False):
    """Closest (or any) hit vs the v1 tables -> dict(t, u, v, prim): prim
    indexes the SORTED order (-1 and t = INF on a miss). With any_hit only
    `prim >= 0` is meaningful."""
    return trace(_walk_cuda, _walk_ref, packed_tris, cluster_aabb, org,
                 direction, min_t, max_t, any_hit, plain=False)


def dense_trace_v2_ref(packed_tris, cluster_aabb, org, direction, min_t,
                       max_t, any_hit=False):
    """Plain torch version of `dense_trace_v2` on any device."""
    return trace(_walk_cuda, _walk_ref, packed_tris, cluster_aabb, org,
                 direction, min_t, max_t, any_hit, plain=True)
