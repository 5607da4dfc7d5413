"""Ray-scene intersection dispatch (port of pbrlab_tpu.ops.intersect).

Replaces the reference's rtcIntersect1 / rtcOccluded1
(raytracer_impl.cc:268-287) over the scene's triangles AND hair curves.
Rays are SoA lanes [N, ...]; hits are dict(t, u, v, prim, seg, is_curve,
tangent): prim the triangle slot (= face) id, seg the Bezier segment id,
each -1 where the other (or nothing) was hit, with Embree's barycentric
convention P = (1-u-v)v0 + u v1 + v v2 on triangles and, on curves, u the
curve parameter, v the signed ribbon offset and tangent the sub-segment's
unit direction.

The triangle backend is the JAX package's choice on its accelerators:
dense_v5i for an instanced scene (`scene.instanced`; prim is then the
global instance-face id), dense_v5s past 18000 slots (the commit then adds
the v5s tables), dense_v4 up to 256 clusters, dense_v5 between. A caller
may force another backend (the render's `tri_backend`, the counterpart of
the JAX package's PBRLAB_TRACE_BACKEND), among them the legacy brute-force
ones: "dense3" (dense_v3) and "dense" or "dense2" (dense_v2), whose
Morton-order prim ids map back to slot ids through the scene's
`dense_order`; and "bvh", the threaded-BVH walk (`intersect_bvh`,
`occluded_bvh`: the `bvh_trace` kernel of `csrc/bvh_walk.cu`), which is
the JAX package's own default on its CPU. A backend whose tables the scene
lacks raises ValueError (an instanced scene has no `bvh_*` tables). Curves
follow the backend: "bvh" walks the curve BVH (`curves.curve_trace`, as
the JAX package does under that backend), every other backend goes
through dense_curve. dense_v5i, dense_v5l / v5s, the legacy backends, bvh
and the two curve walks have no dual kernel: a step launches their
closest and their any-hit query.

`intersect_bruteforce` is the chunked brute-force oracle of the walks'
tests.
"""
from __future__ import annotations

import torch

from ..core.math import INF
from .bvh_walk import cross3, dot3, safe_inv, walk_cuda, walk_ref
from .curves import curve_trace
from .dense_curve import dense_curve_trace
from .dense_v2 import dense_trace_v2
from .dense_v3 import dense_trace_v3
from .dense_v4 import MAX_CLUSTERS as MAX_DENSE4_CLUSTERS
from .dense_v4 import dense_trace_v4, dense_trace_v4_dual
from .dense_v5 import (dense_trace_v5, dense_trace_v5_dual, dense_trace_v5l,
                       dense_trace_v5s)
from .dense_v5i import dense_trace_v5i

# the legacy brute-force backends, whose prim ids are in Morton order
LEGACY = {"dense3": dense_trace_v3, "dense": dense_trace_v2,
          "dense2": dense_trace_v2}
TRI_EPS = 1e-9
BVH_TABLES = ("bvh_min", "bvh_max", "bvh_skip", "bvh_prim_offset",
              "bvh_prim_ids", "tri_v0", "tri_e1", "tri_e2")


def _mt_intersect(org, direction, v0, e1, e2, min_t, max_t):
    """Moller-Trumbore of lanes [..., 3] against triangles [..., 3] ->
    (hit, t, u, v), no backface cull (the reference shades both faces)."""
    pvec = cross3(direction, e2)
    det = dot3(e1, pvec)
    ok = torch.abs(det) > TRI_EPS
    inv_det = torch.where(ok, 1.0 / det, 0.0)
    tvec = org - v0
    u = dot3(tvec, pvec) * inv_det
    qvec = cross3(tvec, e1)
    v = dot3(direction, qvec) * inv_det
    t = dot3(e2, qvec) * inv_det
    hit = (ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t >= min_t)
           & (t <= max_t))
    return hit, t, u, v


def intersect_bruteforce(scene, org, direction, min_t, max_t, chunk=512):
    """Closest hit over every triangle, `chunk` at a time -> dict(t, u, v,
    prim): the oracle of the walks (plain torch on any device)."""
    v0, e1, e2 = scene["tri_v0"], scene["tri_e1"], scene["tri_e2"]
    n = org.shape[0]
    best_t = torch.full((n,), INF, dtype=torch.float32, device=org.device)
    best_u = torch.zeros_like(best_t)
    best_v = torch.zeros_like(best_t)
    best_p = torch.full((n,), -1, dtype=torch.int32, device=org.device)
    rows = torch.arange(n, device=org.device)
    for c0 in range(0, v0.shape[0], chunk):
        hit, t, u, v = _mt_intersect(
            org[:, None], direction[:, None], v0[None, c0:c0 + chunk],
            e1[None, c0:c0 + chunk], e2[None, c0:c0 + chunk],
            min_t[:, None], torch.minimum(max_t, best_t)[:, None])
        tj, j = torch.where(hit, t, INF).min(dim=1)  # the first least
        better = tj < best_t
        best_u = torch.where(better, u[rows, j], best_u)
        best_v = torch.where(better, v[rows, j], best_v)
        best_p = torch.where(better, (c0 + j).to(torch.int32), best_p)
        best_t = torch.where(better, tj, best_t)
    return {"t": best_t, "u": best_u, "v": best_v, "prim": best_p}


def _bvh_trace(bvh_min, bvh_max, bvh_skip, bvh_prim_offset, bvh_prim_ids,
               tri_v0, tri_e1, tri_e2, org, direction, min_t, max_t,
               any_hit=False, plain=False):
    """The threaded-BVH triangle walk (`bvh_walk`) -> dict(t, u, v, prim),
    t = INF and prim = -1 on a miss: the `bvh_trace` kernel on CUDA
    tensors unless plain, else its twin `_bvh_walk_ref`. Slab reciprocals
    clamp at 1e-20 (pbrlab_tpu/ops/intersect.py:138); a leaf's 4 slots go
    through Moller-Trumbore with TRI_EPS."""
    tree = [x.contiguous() for x in (bvh_min, bvh_max, bvh_skip,
                                     bvh_prim_offset, bvh_prim_ids)]
    tris = [x.contiguous() for x in (tri_v0, tri_e1, tri_e2)]
    rays = [x.contiguous() for x in (org, direction, min_t, max_t)]
    if org.is_cuda and not plain:
        t, u, v, prim = walk_cuda("bvh_trace", tree, tris, *rays,
                                  any_hit=any_hit)
    else:
        t, u, v, prim = _bvh_walk_ref(tree, tris, *rays, any_hit=any_hit)
    return {"t": t, "u": u, "v": v, "prim": prim}


def _bvh_walk_ref(tree, tris, org, direction, min_t, max_t, any_hit=False,
                  counts=False):
    """The plain torch twin of the `bvh_trace` kernel: `bvh_walk.walk_ref`
    with the Moller-Trumbore leaf test; with counts also the [N, 2]
    per-lane (triangle, box) tests."""
    v0, e1, e2 = tris

    def leaf(ln, pid, cap):
        safe = pid.clamp(min=0)
        return _mt_intersect(org[ln, None], direction[ln, None], v0[safe],
                             e1[safe], e2[safe], min_t[ln, None],
                             cap[:, None])

    return walk_ref(tree, leaf, org, safe_inv(direction, 1e-20), min_t,
                    max_t, any_hit=any_hit, counts=counts)


def _bvh_trace_ref(*args, any_hit=False):
    """Plain torch version of `_bvh_trace` on any device (same args)."""
    return _bvh_trace(*args, any_hit=any_hit, plain=True)


def intersect_bvh(scene, org, direction, min_t, max_t):
    """Closest hit through the scene's threaded BVH -> dict(t, u, v,
    prim)."""
    return _bvh_trace(*_tables(scene, "bvh", *BVH_TABLES), org, direction,
                      min_t, max_t)


def occluded_bvh(scene, org, direction, min_t, max_t):
    """Any-hit shadow query through the threaded BVH -> bool per lane
    (reference AnyHit1)."""
    return _bvh_trace(*_tables(scene, "bvh", *BVH_TABLES), org, direction,
                      min_t, max_t, any_hit=True)["prim"] >= 0


def _tri_backend(scene) -> str:
    """The triangle backend for a committed scene: "dense5i", "dense5s",
    "dense5l", "dense4" or "dense5" (the JAX package's choice on its
    accelerators; "bvh", its CPU choice, only when forced)."""
    if "i5_tris" in scene:
        # no baked world-space tables: the two-level walk is the only one
        return "dense5i"
    if "v5s_roots" in scene:
        return "dense5s"
    if "dense_tris_v5l" in scene:
        return "dense5l"
    if scene["dense_cluster_aabb_v4"].shape[1] <= MAX_DENSE4_CLUSTERS:
        return "dense4"
    return "dense5"


def _tables(scene, backend, *keys):
    """The committed tables `keys` that `backend` reads; raises ValueError
    when the scene's commit did not add them."""
    missing = [k for k in keys if k not in scene]
    if missing:
        raise ValueError(f"triangle backend {backend!r} needs the tables "
                         f"{missing}, which this scene's commit did not add")
    return [scene[k] for k in keys]


def sparse_backend(scene, tri_backend: str | None = None) -> str | None:
    """Backend for traces where most lanes are dead (unwindowed volume
    substeps: only walking lanes trace), derived from the scene's choice or
    the forced `tri_backend`, as the JAX package chooses it (dense4 scenes
    take dense5). In the per-ray walks a dead lane's thread ends at once,
    where dense_v5s's sorts run over every lane. None: the choice is
    already right (the legacy backends and bvh keep theirs: the JAX package
    reads its forced backend from the environment there too)."""
    return {"dense4": "dense5", "dense5s": "dense5l"}.get(
        tri_backend or _tri_backend(scene))


def _remap_legacy_prim(scene, res):
    """The legacy kernels' prim ids are in their own Morton order: map
    them back to slot ids through dense_order."""
    prim = res["prim"]
    order = scene["dense_order"]
    slot = order[torch.clamp(prim, min=0).to(torch.int64)] if order.numel() \
        else prim
    return {**res, "prim": torch.where(prim >= 0, slot, -1)}


def _closest(scene, backend, org, direction, min_t, max_t, any_hit=False):
    rays = (org, direction, min_t, max_t)
    if backend in LEGACY:
        tris, aabb, _ = _tables(scene, backend, "dense_tris",
                                "dense_cluster_aabb", "dense_order")
        return _remap_legacy_prim(scene, LEGACY[backend](
            tris, aabb, *rays, any_hit=any_hit))
    if backend == "dense5i":
        return dense_trace_v5i(*_tables(
            scene, backend, "i5_tris", "i5_node_aabb", "i5_node_meta",
            "i5_inst_inv", "i5_inst_meta"), *rays, any_hit=any_hit)
    if backend == "dense5s":
        return dense_trace_v5s(*_tables(
            scene, backend, "dense_tris_v5l", "v5_node_aabb", "v5_node_meta",
            "v5s_roots", "v5s_aabb"), *rays, any_hit=any_hit)
    if backend == "dense5l":
        return dense_trace_v5l(*_tables(
            scene, backend, "dense_tris_v5l", "v5_node_aabb",
            "v5_node_meta"), *rays, any_hit=any_hit)
    if backend == "dense5":
        return dense_trace_v5(*_tables(
            scene, backend, "dense_tris_v4", "v5_node_aabb", "v5_node_meta"),
            *rays, any_hit=any_hit)
    if backend == "dense4":
        return dense_trace_v4(*_tables(
            scene, backend, "dense_tris_v4", "dense_cluster_aabb_v4"),
            *rays, any_hit=any_hit)
    if backend == "bvh":
        return _bvh_trace(*_tables(scene, backend, *BVH_TABLES), *rays,
                          any_hit=any_hit)
    raise ValueError(f"unknown triangle backend {backend!r}")


def has_curves(scene) -> bool:
    """Whether the committed scene holds hair (a host-side shape test)."""
    return int(scene["curve_pts"].shape[0]) > 0


def _closest_curve(scene, backend, org, direction, min_t, max_t):
    """Hair closest hit -> dict(t, u, v, seg, tangent): the curve BVH walk
    under "bvh", else dense_curve, whose sorted sub-segment id maps to its
    source segment and tangent through one curve_sub_fat row."""
    if backend == "bvh":
        return curve_trace(scene, org, direction, min_t, max_t)
    res = dense_curve_trace(scene["dense_segs"], scene["dense_seg_aabb"],
                            org, direction, min_t, max_t)
    sub = res["sub"]
    fat = scene["curve_sub_fat"][torch.clamp(sub, min=0).to(torch.int64)]
    return {"t": res["t"], "u": res["u"], "v": res["v"],
            "seg": torch.where(sub >= 0, fat[:, 3].to(torch.int32), -1),
            "tangent": fat[:, 0:3]}


def _occluded_curve(scene, backend, org, direction, min_t, max_t):
    if backend == "bvh":
        return curve_trace(scene, org, direction, min_t, max_t,
                           any_hit=True)["seg"] >= 0
    return dense_curve_trace(scene["dense_segs"], scene["dense_seg_aabb"],
                             org, direction, min_t, max_t,
                             any_hit=True)["sub"] >= 0


def _merge(scene, backend, tri, org, direction, min_t, max_t):
    """The triangle hit merged with the closest curve hit: the curve wins
    where it hit and is strictly closer."""
    n = org.shape[0]
    if not has_curves(scene):
        return {**tri, "seg": torch.full((n,), -1, dtype=torch.int32,
                                         device=org.device),
                "is_curve": torch.zeros((n,), dtype=torch.bool,
                                        device=org.device),
                "tangent": torch.zeros((n, 3), device=org.device)}
    cur = _closest_curve(scene, backend, org, direction, min_t, max_t)
    curve_closer = (cur["seg"] >= 0) & (cur["t"] < tri["t"])
    return {
        "t": torch.where(curve_closer, cur["t"], tri["t"]),
        "u": torch.where(curve_closer, cur["u"], tri["u"]),
        "v": torch.where(curve_closer, cur["v"], tri["v"]),
        "prim": torch.where(curve_closer, -1, tri["prim"]),
        "seg": torch.where(curve_closer, cur["seg"], -1),
        "is_curve": curve_closer,
        "tangent": cur["tangent"],
    }


def trace_scene(scene, org, direction, min_t, max_t, backend=None):
    """Closest hit over the scene's triangles and curves -> dict(t, u, v,
    prim, seg, is_curve, tangent). backend overrides the scene's triangle
    choice (see `sparse_backend`)."""
    backend = backend or _tri_backend(scene)
    tri = _closest(scene, backend, org, direction, min_t, max_t)
    return _merge(scene, backend, tri, org, direction, min_t, max_t)


def occluded_scene(scene, org, direction, min_t, max_t, backend=None):
    """Shadow any-hit over triangles and curves -> bool per lane
    (rtcOccluded1)."""
    backend = backend or _tri_backend(scene)
    occ = _closest(scene, backend, org, direction, min_t, max_t,
                   any_hit=True)["prim"] >= 0
    if has_curves(scene):
        occ = occ | _occluded_curve(scene, backend, org, direction, min_t,
                                    max_t)
    return occ


def trace_scene_dual(scene, org, direction, min_t, max_t, sdir, smin_t,
                     smax_t, backend=None):
    """Closest hit + shadow any-hit sharing the origin (the deferred-NEE
    step) -> (trace_scene dict, occluded bool). Triangles: one dual-kernel
    launch for dense4 and dense5, two launches (closest, then shadow) for
    the large-scene, instanced and legacy backends, which have no dual
    kernel, and for bvh. Curves: a closest and an any-hit launch of the
    backend's curve walk."""
    backend = backend or _tri_backend(scene)
    rays = (org, direction, min_t, max_t, sdir, smin_t, smax_t)
    if backend == "dense4":
        tri, occ = dense_trace_v4_dual(*_tables(
            scene, backend, "dense_tris_v4", "dense_cluster_aabb_v4"), *rays)
    elif backend == "dense5":
        tri, occ = dense_trace_v5_dual(*_tables(
            scene, backend, "dense_tris_v4", "v5_node_aabb", "v5_node_meta"),
            *rays)
    else:
        tri = _closest(scene, backend, org, direction, min_t, max_t)
        occ = _closest(scene, backend, org, sdir, smin_t, smax_t,
                       any_hit=True)["prim"] >= 0
    if has_curves(scene):
        occ = occ | _occluded_curve(scene, backend, org, sdir, smin_t,
                                    smax_t)
    return _merge(scene, backend, tri, org, direction, min_t, max_t), occ
