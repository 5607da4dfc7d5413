"""dense_v5i instanced triangle trace: a per-ray two-level (TLAS/BLAS)
walk.

Port of pbrlab_tpu/ops/pallas/dense_v5i.py. One CUDA kernel, written by
hand for Hopper (`csrc/dense_v5i.cu`, `dense_v5i_trace`), replaces the
Pallas `_trace_kernel`: the closest hit (or any hit) per lane over a scene
of shared local triangle scenes (reference instancing,
raytracer_impl.cc:49-84). Each local scene is one BLAS built in local
space; the TLAS leaves are instances, each with its world-to-local affine
transform. `build_tlas` builds the TLAS on the host.

Node encoding (one array, TLAS nodes first, then every BLAS block):
node_meta[0] is the right child (-1 on a leaf); on a leaf node_meta[1] is
the packed slot base of a BLAS leaf (>= 0) or -(instance + 1) of a TLAS
leaf. inst_inv [12, K] holds each instance's world-to-local rows
(r00 r01 r02 t0 r10 ...), inst_meta [2, K] its BLAS root node and the
delta that turns a packed slot into its global instance-face id.

The walk is per ray (`csrc/per_ray.cuh`, one thread per ray): each lane
has its own stack of STACK (node, entry t) entries, culls against its own
best t, pushes the far child first, and at a TLAS leaf maps its ray into
the instance's space (the direction is not renormalised, so t stays
comparable across instances) and walks the BLAS above its own pointer
`sp_base`. Any-hit ends a lane's walk after the first leaf that gives it
a hit. It replaces the TPU's walk of 1024-ray groups (one stack per group,
a child entered if any ray of the group enters it, culled against the
group's largest best t), which made each ray pay for its group's union
of instances. `_walk_ref` is the plain torch twin (`per_ray.walk_ref`,
each lane's own pop sequence). `dense_trace_v5i` takes the kernel for
CUDA tensors and `_walk_ref` for CPU tensors; `dense_trace_v5i_ref` runs
`_walk_ref` on any device, which is what the kernel is compared with on
the card. `LAUNCHES` counts kernel launches per mode.

Against the JAX package the per-ray walk finds the same closest hits in
exact arithmetic; in float a lane may differ on an exact-t tie (the first
triangle it visits follows its own order) and on a grazing ray (its own
slab test misses a box its group entered): ROADMAP C3 / C7.

Contract (as the JAX package): rays (org, direction, min_t, max_t) are
float32, max_t < min_t marks a dead lane; results are t, u, v (float32)
and prim (int32 global instance-face id, -1 and t = INF on a miss). The
JAX kernel carries prim as float32, exact below 2^24 (ROADMAP C8); here it
is int32 throughout. With any_hit only `prim >= 0` is meaningful.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..core.math import INF
from ..geometry.bvh import build_bvh
from . import cuda_lib, per_ray
from .dense_v4 import _pad

GROUP = 1024  # the wrappers pad the rays to whole groups of GROUP
STACK = 160  # stack entries per lane for both levels (the build checks)

LAUNCHES = {"closest": 0, "any_hit": 0}

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGS = [_P, _I, _P, _P, _I, _P, _P, _I, _P, _P, _P, _P, _I, _I, _P, _P, _P,
         _P, _P]


def build_tlas(inst_aabb_min: np.ndarray, inst_aabb_max: np.ndarray):
    """TLAS over instance world AABBs [K, 3]: leaf i holds one instance.

    Returns (node_aabb [6, Nt], node_right [Nt], node_inst [Nt]) with
    node_inst >= 0 on leaves. The numpy binned-SAH build with leaf_size=1,
    never the native builder, as in the JAX package."""
    bvh = build_bvh(inst_aabb_min, inst_aabb_max, leaf_size=1,
                    use_native=False)
    nn = bvh.num_nodes
    is_leaf = bvh.prim_offset >= 0
    right = np.full((nn,), -1, np.int32)
    internal = np.nonzero(~is_leaf)[0]
    if internal.size:
        right[internal] = bvh.skip[internal + 1]
        if not (bvh.skip[right[internal]] == bvh.skip[internal]).all():
            raise RuntimeError("TLAS skip links do not give right children")
    inst = np.full((nn,), -1, np.int32)
    leaves = np.nonzero(is_leaf)[0]
    inst[leaves] = bvh.prim_ids[bvh.prim_offset[leaves]]
    aabb = np.concatenate([bvh.aabb_min.T, bvh.aabb_max.T]).astype(np.float32)
    return aabb, right, inst


def _walk_ref(tris, node_aabb, node_meta, inst_inv, inst_meta, org,
              direction, min_t, max_t, any_hit=False, counts=False):
    """Plain torch twin of the kernel: every lane's own two-level walk
    (`per_ray.walk_ref`). Returns (t, u, v, prim) and, with counts, each
    lane's ray-triangle tests, ray-box tests and transforms [N, 3]; t =
    max_t where nothing was hit."""
    return per_ray.walk_ref(per_ray.attr_major_rows(tris), node_aabb,
                            node_meta, org, direction, min_t, max_t, 0,
                            STACK, any_hit=any_hit, inst_inv=inst_inv,
                            inst_meta=inst_meta, counts=counts)


def _walk_cuda(tris, node_aabb, node_meta, inst_inv, inst_meta, org,
               direction, min_t, max_t, any_hit=False):
    """Launch the dense_v5i kernel on the current stream; same returns as
    `_walk_ref`."""
    dev = org.device
    n = org.shape[0]
    nn = node_aabb.shape[1]
    k = inst_inv.shape[1]
    f32, i32 = torch.float32, torch.int32
    for x, dtype, shape in (
            (tris, f32, (12, tris.shape[1])), (node_aabb, f32, (6, nn)),
            (node_meta, i32, (2, nn)), (inst_inv, f32, (12, k)),
            (inst_meta, i32, (2, k)), (org, f32, (n, 3)),
            (direction, f32, (n, 3)), (min_t, f32, (n,)),
            (max_t, f32, (n,))):
        cuda_lib.check_tensor("dense_v5i", x, dtype, shape, dev)
    cuda_lib.check_float4_rows("dense_v5i", tris, tris.shape[1])
    t = torch.empty((n,), dtype=f32, device=dev)
    u = torch.empty_like(t)
    v = torch.empty_like(t)
    prim = torch.empty((n,), dtype=i32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = cuda_lib.function("dense_v5i_trace", _ARGS)(
            tris.data_ptr(), tris.shape[1], node_aabb.data_ptr(),
            node_meta.data_ptr(), nn, inst_inv.data_ptr(),
            inst_meta.data_ptr(), k, org.data_ptr(), direction.data_ptr(),
            min_t.data_ptr(), max_t.data_ptr(), int(any_hit), n,
            t.data_ptr(), u.data_ptr(), v.data_ptr(), prim.data_ptr(),
            stream)
    kind = "any_hit" if any_hit else "closest"
    cuda_lib.launched(f"dense_v5i {kind}", rc)
    LAUNCHES[kind] += 1
    return t, u, v, prim


def _trace(tables, org, direction, min_t, max_t, any_hit, plain):
    """Pad to whole groups, walk (the kernel on CUDA tensors unless plain),
    unpad."""
    n = org.shape[0]
    n_pad = (n + GROUP - 1) // GROUP * GROUP
    rays = [_pad(org, n_pad, 0.0), _pad(direction, n_pad, 1.0),
            _pad(min_t, n_pad, 0.0),
            torch.clamp(_pad(max_t, n_pad, -1.0), max=INF)]
    walk = _walk_cuda if org.is_cuda and not plain else _walk_ref
    t, u, v, prim = walk(*(x.contiguous() for x in tables), *rays,
                         any_hit=any_hit)
    hit = prim[:n] >= 0
    return {"t": torch.where(hit, t[:n], INF), "u": u[:n], "v": v[:n],
            "prim": prim[:n]}


def dense_trace_v5i(packed_tris, node_aabb, node_meta, inst_inv, inst_meta,
                    org, direction, min_t, max_t, any_hit=False):
    """Closest (or any) hit per lane over an instanced scene's i5_* tables
    -> dict(t, u, v, prim); prim is the global instance-face id."""
    return _trace((packed_tris, node_aabb, node_meta, inst_inv, inst_meta),
                  org, direction, min_t, max_t, any_hit, plain=False)


def dense_trace_v5i_ref(packed_tris, node_aabb, node_meta, inst_inv,
                        inst_meta, org, direction, min_t, max_t,
                        any_hit=False):
    """Plain torch version of `dense_trace_v5i` on any device."""
    return _trace((packed_tris, node_aabb, node_meta, inst_inv, inst_meta),
                  org, direction, min_t, max_t, any_hit, plain=True)
