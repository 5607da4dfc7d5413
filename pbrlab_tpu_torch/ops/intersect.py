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
`dense_order`. A backend whose tables the scene lacks raises ValueError;
the JAX package's threaded-BVH walk ("bvh") is not in the port. Curves
always go through dense_curve. dense_v5i, dense_v5l / v5s, the legacy
backends and dense_curve have no dual kernel: a step launches their
closest and their any-hit query.
"""
from __future__ import annotations

import torch

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


def _tri_backend(scene) -> str:
    """The triangle backend for a committed scene: "dense5i", "dense5s",
    "dense5l", "dense4" or "dense5"."""
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
    already right (the legacy backends keep theirs)."""
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
    raise ValueError(f"unknown triangle backend {backend!r} (the port has "
                     f"no threaded-BVH walk)")


def has_curves(scene) -> bool:
    """Whether the committed scene holds hair (a host-side shape test)."""
    return int(scene["curve_pts"].shape[0]) > 0


def _closest_curve(scene, org, direction, min_t, max_t):
    """Hair closest hit -> dict(t, u, v, seg, tangent); the sorted
    sub-segment id maps to its source segment and tangent through one
    curve_sub_fat row."""
    res = dense_curve_trace(scene["dense_segs"], scene["dense_seg_aabb"],
                            org, direction, min_t, max_t)
    sub = res["sub"]
    fat = scene["curve_sub_fat"][torch.clamp(sub, min=0).to(torch.int64)]
    return {"t": res["t"], "u": res["u"], "v": res["v"],
            "seg": torch.where(sub >= 0, fat[:, 3].to(torch.int32), -1),
            "tangent": fat[:, 0:3]}


def _occluded_curve(scene, org, direction, min_t, max_t):
    return dense_curve_trace(scene["dense_segs"], scene["dense_seg_aabb"],
                             org, direction, min_t, max_t,
                             any_hit=True)["sub"] >= 0


def _merge(scene, tri, org, direction, min_t, max_t):
    """The triangle hit merged with the closest curve hit: the curve wins
    where it hit and is strictly closer."""
    n = org.shape[0]
    if not has_curves(scene):
        return {**tri, "seg": torch.full((n,), -1, dtype=torch.int32,
                                         device=org.device),
                "is_curve": torch.zeros((n,), dtype=torch.bool,
                                        device=org.device),
                "tangent": torch.zeros((n, 3), device=org.device)}
    cur = _closest_curve(scene, org, direction, min_t, max_t)
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
    tri = _closest(scene, backend or _tri_backend(scene), org, direction,
                   min_t, max_t)
    return _merge(scene, tri, org, direction, min_t, max_t)


def occluded_scene(scene, org, direction, min_t, max_t, backend=None):
    """Shadow any-hit over triangles and curves -> bool per lane
    (rtcOccluded1)."""
    occ = _closest(scene, backend or _tri_backend(scene), org, direction,
                   min_t, max_t, any_hit=True)["prim"] >= 0
    if has_curves(scene):
        occ = occ | _occluded_curve(scene, org, direction, min_t, max_t)
    return occ


def trace_scene_dual(scene, org, direction, min_t, max_t, sdir, smin_t,
                     smax_t, backend=None):
    """Closest hit + shadow any-hit sharing the origin (the deferred-NEE
    step) -> (trace_scene dict, occluded bool). Triangles: one dual-kernel
    launch for dense4 and dense5, two launches (closest, then shadow) for
    the large-scene, instanced and legacy backends, which have no dual
    kernel. Curves: a closest and an any-hit dense_curve launch."""
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
        occ = occ | _occluded_curve(scene, org, sdir, smin_t, smax_t)
    return _merge(scene, tri, org, direction, min_t, max_t), occ
