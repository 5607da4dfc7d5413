"""Hair curve flattening on the host (numpy; port of the host part of
pbrlab_tpu.ops.curves).

Replaces Embree's flat Bezier curves (raytracer_impl.cc:154-197): at
commit each cubic Bezier segment becomes CURVE_SUBDIV linear sub-segments
with lerped radii, which the dense_curve trace (ops/dense_curve.py) tests
as ray-facing ribbons. The JAX package's CPU walk over a curve BVH
(`curve_trace`) is not ported: the port's CPU trace is the plain version
of the dense_curve kernel, as for triangles.
"""
from __future__ import annotations

import numpy as np

CURVE_SUBDIV = 8


def flatten_curves(curve_pts: np.ndarray):
    """[S, 4, 4] Bezier control points (xyz + radius) -> dict of numpy
    sub-segment arrays: curve_p0, curve_p1 [C, 3], curve_r0, curve_r1 [C],
    curve_seg [C] (source segment id), curve_u0, curve_u1 [C]."""
    S = curve_pts.shape[0]
    if S == 0:
        return {
            "curve_p0": np.zeros((0, 3), np.float32),
            "curve_p1": np.zeros((0, 3), np.float32),
            "curve_r0": np.zeros((0,), np.float32),
            "curve_r1": np.zeros((0,), np.float32),
            "curve_seg": np.zeros((0,), np.int32),
            "curve_u0": np.zeros((0,), np.float32),
            "curve_u1": np.zeros((0,), np.float32),
        }
    t = np.linspace(0.0, 1.0, CURVE_SUBDIV + 1, dtype=np.float32)
    # cubic Bezier basis [K+1, 4]
    b = np.stack([(1 - t) ** 3, 3 * t * (1 - t) ** 2, 3 * t ** 2 * (1 - t),
                  t ** 3], axis=-1)
    pts = np.einsum("kc,scq->skq", b, curve_pts)  # [S, K+1, 4]
    p = pts[..., :3]
    r = pts[..., 3]
    return {
        "curve_p0": p[:, :-1].reshape(-1, 3).astype(np.float32),
        "curve_p1": p[:, 1:].reshape(-1, 3).astype(np.float32),
        "curve_r0": r[:, :-1].reshape(-1).astype(np.float32),
        "curve_r1": r[:, 1:].reshape(-1).astype(np.float32),
        "curve_seg": np.repeat(np.arange(S, dtype=np.int32), CURVE_SUBDIV),
        "curve_u0": np.tile(t[:-1], S).astype(np.float32),
        "curve_u1": np.tile(t[1:], S).astype(np.float32),
    }


def subsegment_bounds(flat):
    """Per sub-segment AABB (bmin, bmax) [C, 3] of both end spheres."""
    bmin = np.minimum(flat["curve_p0"] - flat["curve_r0"][:, None],
                      flat["curve_p1"] - flat["curve_r1"][:, None])
    bmax = np.maximum(flat["curve_p0"] + flat["curve_r0"][:, None],
                      flat["curve_p1"] + flat["curve_r1"][:, None])
    return bmin, bmax
