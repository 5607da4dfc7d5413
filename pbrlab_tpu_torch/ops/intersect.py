"""Ray-scene intersection dispatch (port of pbrlab_tpu.ops.intersect).

Replaces the reference's rtcIntersect1 / rtcOccluded1
(raytracer_impl.cc:268-287). Rays are SoA lanes [N, ...]; hits are
dict(t, u, v, prim) with prim the scene's slot (= face) id, -1 on a miss,
and Embree's barycentric convention P = (1-u-v)v0 + u v1 + v v2.

The triangle backend is the JAX package's choice on its accelerators:
dense_v5s past 18000 slots (the commit then adds the v5s tables), dense_v4
up to 256 clusters, dense_v5 between. Hair and instancing raise: their
kernels are not ported yet.
"""
from __future__ import annotations

from .dense_v4 import dense_trace_v4, dense_trace_v4_dual
from .dense_v5 import (dense_trace_v5, dense_trace_v5_dual, dense_trace_v5l,
                       dense_trace_v5s)

MAX_DENSE4_CLUSTERS = 256


def _tri_backend(scene) -> str:
    """The triangle backend for a committed scene: "dense5s", "dense5l",
    "dense4" or "dense5"."""
    if scene.get("curve_pts") is not None and scene["curve_pts"].shape[0]:
        raise NotImplementedError(
            "hair curves need the dense_curve kernel, not ported yet "
            "(ROADMAP A11, B7)")
    if "i5_tris" in scene or "iface_material" in scene:
        raise NotImplementedError(
            "instanced scenes need the dense_v5i kernel, not ported yet "
            "(ROADMAP A13, B6)")
    if "v5s_roots" in scene:
        return "dense5s"
    if "dense_tris_v5l" in scene:
        return "dense5l"
    if scene["dense_cluster_aabb_v4"].shape[1] <= MAX_DENSE4_CLUSTERS:
        return "dense4"
    return "dense5"


def sparse_backend(scene) -> str | None:
    """Backend for traces where most lanes are dead (unwindowed volume
    substeps: only walking lanes trace). The packet kernels skip an
    all-dead group at once, where dense_v4's cull and dense_v5s's sorts
    run over every lane. None: the default is already that choice."""
    return {"dense4": "dense5", "dense5s": "dense5l"}.get(_tri_backend(scene))


def _closest(scene, backend, org, direction, min_t, max_t, any_hit=False):
    if backend == "dense5s":
        return dense_trace_v5s(scene["dense_tris_v5l"], scene["v5_node_aabb"],
                               scene["v5_node_meta"], scene["v5s_roots"],
                               scene["v5s_aabb"], org, direction, min_t,
                               max_t, any_hit=any_hit)
    if backend == "dense5l":
        return dense_trace_v5l(scene["dense_tris_v5l"], scene["v5_node_aabb"],
                               scene["v5_node_meta"], org, direction, min_t,
                               max_t, any_hit=any_hit)
    if backend == "dense5":
        return dense_trace_v5(scene["dense_tris_v4"], scene["v5_node_aabb"],
                              scene["v5_node_meta"], org, direction, min_t,
                              max_t, any_hit=any_hit)
    if backend == "dense4":
        return dense_trace_v4(scene["dense_tris_v4"],
                              scene["dense_cluster_aabb_v4"], org, direction,
                              min_t, max_t, any_hit=any_hit)
    raise ValueError(f"unknown triangle backend {backend!r}")


def trace_scene(scene, org, direction, min_t, max_t, backend=None):
    """Closest hit over the scene's triangles -> dict(t, u, v, prim).
    backend overrides the scene's choice (see `sparse_backend`)."""
    return _closest(scene, backend or _tri_backend(scene), org, direction,
                    min_t, max_t)


def occluded_scene(scene, org, direction, min_t, max_t, backend=None):
    """Shadow any-hit -> bool per lane (rtcOccluded1)."""
    return _closest(scene, backend or _tri_backend(scene), org, direction,
                    min_t, max_t, any_hit=True)["prim"] >= 0


def trace_scene_dual(scene, org, direction, min_t, max_t, sdir, smin_t,
                     smax_t, backend=None):
    """Closest hit + shadow any-hit sharing the origin (the deferred-NEE
    step) -> (trace_scene dict, occluded bool): one dual-kernel launch for
    dense4 and dense5, two launches (closest, then shadow) for the
    large-scene backends, which have no dual kernel."""
    backend = backend or _tri_backend(scene)
    if backend == "dense4":
        return dense_trace_v4_dual(scene["dense_tris_v4"],
                                   scene["dense_cluster_aabb_v4"],
                                   org, direction, min_t, max_t,
                                   sdir, smin_t, smax_t)
    if backend == "dense5":
        return dense_trace_v5_dual(scene["dense_tris_v4"],
                                   scene["v5_node_aabb"],
                                   scene["v5_node_meta"], org, direction,
                                   min_t, max_t, sdir, smin_t, smax_t)
    return (trace_scene(scene, org, direction, min_t, max_t, backend),
            occluded_scene(scene, org, sdir, smin_t, smax_t, backend))
