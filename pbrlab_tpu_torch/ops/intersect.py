"""Ray-scene intersection dispatch (port of pbrlab_tpu.ops.intersect).

Replaces the reference's rtcIntersect1 / rtcOccluded1
(raytracer_impl.cc:268-287). Rays are SoA lanes [N, ...]; hits are
dict(t, u, v, prim) with prim the scene's slot (= face) id, -1 on a miss,
and Embree's barycentric convention P = (1-u-v)v0 + u v1 + v v2.

The port has one triangle backend so far, dense_v4, which the JAX package
picks on its accelerators for scenes of <= 256 clusters. Where the JAX
package would pick another (more clusters, instancing, hair), the port
raises rather than substitute a backend it does not have.
"""
from __future__ import annotations

from .dense_v4 import dense_trace_v4, dense_trace_v4_dual

MAX_DENSE4_CLUSTERS = 256


def _tri_backend(scene) -> str:
    """The triangle backend for a committed scene (always "dense4")."""
    if scene.get("curve_pts") is not None and scene["curve_pts"].shape[0]:
        raise NotImplementedError(
            "hair curves need the dense_curve kernel, not ported yet "
            "(ROADMAP A11, B7)")
    if "i5_tris" in scene or "iface_material" in scene:
        raise NotImplementedError(
            "instanced scenes need the dense_v5i kernel, not ported yet "
            "(ROADMAP A13, B6)")
    m = scene["dense_cluster_aabb_v4"].shape[1]
    if m > MAX_DENSE4_CLUSTERS:
        raise NotImplementedError(
            f"{m} clusters > {MAX_DENSE4_CLUSTERS}: the JAX package traces "
            "this with dense_v5/v5l/v5s, not ported yet (ROADMAP A10, B3-B5)")
    return "dense4"


def trace_scene(scene, org, direction, min_t, max_t):
    """Closest hit over the scene's triangles -> dict(t, u, v, prim)."""
    _tri_backend(scene)
    return dense_trace_v4(scene["dense_tris_v4"],
                          scene["dense_cluster_aabb_v4"],
                          org, direction, min_t, max_t)


def occluded_scene(scene, org, direction, min_t, max_t):
    """Shadow any-hit -> bool per lane (rtcOccluded1)."""
    _tri_backend(scene)
    return dense_trace_v4(scene["dense_tris_v4"],
                          scene["dense_cluster_aabb_v4"],
                          org, direction, min_t, max_t,
                          any_hit=True)["prim"] >= 0


def trace_scene_dual(scene, org, direction, min_t, max_t, sdir, smin_t,
                     smax_t):
    """Closest hit + shadow any-hit sharing the origin (the deferred-NEE
    step), in one kernel launch -> (trace_scene dict, occluded bool)."""
    _tri_backend(scene)
    return dense_trace_v4_dual(scene["dense_tris_v4"],
                               scene["dense_cluster_aabb_v4"],
                               org, direction, min_t, max_t,
                               sdir, smin_t, smax_t)
