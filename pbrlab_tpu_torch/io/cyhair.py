"""CyHair binary loader + Catmull-Rom -> cubic Bezier conversion (numpy;
port of pbrlab_tpu.io.cyhair).

Reference: io/cyhair.{h,cc} (128-byte header, flag-gated segments /
points / thickness / transparency / color blocks, y/z swap when not y-up)
and curve-util.cc:7-199 (per-strand Catmull-Rom to cubic Bezier with
distinct start / in-between / end stencils, tau = 0.5), packed like
io/curve-mesh-io.cc:32-121 (4 control points per segment, indices at
multiples of 4).
"""
from __future__ import annotations

import struct

import numpy as np

from ..geometry.mesh import CubicBezierCurveMesh

TAU = 0.5


def load_cyhair(path: str, y_up: bool = True, with_colors: bool = False):
    """Returns (list of per-strand [P,3] points, list of [P] thicknesses),
    with with_colors=True also a list of per-strand [P,3] RGB colors (None
    when the file has no color block). The transparency block is read and
    discarded, as the reference does (io/cyhair.cc:20-127)."""
    with open(path, "rb") as f:
        header = f.read(128)
        if header[:4] != b"HAIR":
            raise ValueError(f"{path}: not a CyHair file")
        (num_strands, total_points, flags, default_segments,
         default_thickness, _default_transparency) = struct.unpack(
            "<IIIIff", header[4:28])
        has_segments = bool(flags & 0x1)
        has_points = bool(flags & 0x2)
        has_thickness = bool(flags & 0x4)
        has_transparency = bool(flags & 0x8)
        has_color = bool(flags & 0x10)
        if not has_points:
            raise ValueError("no point data in CyHair")
        if default_segments < 1 and not has_segments:
            raise ValueError("no segment information in CyHair")
        if has_segments:
            segments = np.fromfile(f, np.uint16, num_strands).astype(np.int64)
        else:
            segments = np.full(num_strands, default_segments, np.int64)
        points = np.fromfile(f, np.float32, total_points * 3).reshape(-1, 3)
        if has_thickness:
            thick = np.fromfile(f, np.float32, total_points)
        else:
            thick = np.full(total_points, default_thickness, np.float32)
        if has_transparency:  # skipped: keeps the color block aligned
            np.fromfile(f, np.float32, total_points)
        color = (np.fromfile(f, np.float32, total_points * 3).reshape(-1, 3)
                 if has_color else None)
    if not y_up:
        points = points[:, [0, 2, 1]]
    offsets = np.concatenate([[0], np.cumsum(segments + 1)])
    verts, thicks, colors = [], [], []
    for s in range(num_strands):
        a, b = offsets[s], offsets[s + 1]
        if b - a < 2:
            continue
        verts.append(points[a:b])
        thicks.append(thick[a:b])
        if color is not None:
            colors.append(color[a:b])
    if with_colors:
        return verts, thicks, (colors if color is not None else None)
    return verts, thicks


def _catmullrom_to_bezier_strand(cv: np.ndarray, radius: np.ndarray,
                                 tau: float = TAU):
    """One strand [P, C] control values -> [S, 4, C+1] Bezier segments
    (the radius rides as the last channel).

    The reference's layout: a start stencil for the first segment, the
    generic stencil for the in-between ones (s in [1, num_segments - 1)),
    and an end stencil, so P >= 4 control points give P - 1 segments.
    """
    cv = np.asarray(cv, np.float32)
    if cv.ndim == 1:
        cv = cv[:, None]
    radius = np.asarray(radius, np.float32)[:, None]
    P = np.concatenate([cv, radius], axis=1)  # [n, C+1]
    num_segments = P.shape[0] - 1
    tau3 = tau / 3.0
    # root (CatmullRomToCubicBezierStart)
    p0, p1, p2 = P[0], P[1], P[2]
    out = [np.stack([
        p0,
        ((tau + 1.0) / 3.0) * p0 + (2.0 / 3.0) * p1 - tau3 * p2,
        tau3 * (p0 - p2) + p1,
        p1])]
    # in-between (CatmullRomToCubicBezier over s in [1, num_segments-1))
    if num_segments > 2:
        i = np.arange(num_segments - 2)
        q0, q1, q2, q3 = P[i], P[i + 1], P[i + 2], P[i + 3]
        out.extend(np.stack([
            q1,
            tau3 * (q2 - q0) + q1,
            tau3 * (q1 - q3) + q2,
            q2], axis=1))
    # end (CatmullRomToCubicBezierEnd)
    if num_segments > 1:
        p0, p1, p2 = P[num_segments - 2], P[num_segments - 1], P[num_segments]
        out.append(np.stack([
            p1,
            tau3 * (p2 - p0) + p1,
            (-tau3) * p0 + (2.0 / 3.0) * p1 + ((tau + 1.0) / 3.0) * p2,
            p2]))
    return np.stack(out)


def load_cyhair_as_bezier(path: str, name: str = "") -> CubicBezierCurveMesh:
    """CyHair file -> CubicBezierCurveMesh (xyz + thickness control points).

    When the file carries a per-point color block, the mean RGB of each
    strand is expanded to its Bezier segments as `segment_colors`; the
    scene build surfaces those as `curve_color`, the integrator's
    per-strand hair base-color override (under rgb hair coloring)."""
    verts, thicks, colors = load_cyhair(path, y_up=True, with_colors=True)
    all_pts, indices = [], []
    seg_colors = [] if colors is not None else None
    offset = 0
    for si, (cv, r) in enumerate(zip(verts, thicks)):
        if cv.shape[0] < 3:
            continue
        flat = _catmullrom_to_bezier_strand(cv, r).reshape(-1, 4)
        all_pts.append(flat)
        indices.extend(range(offset, offset + flat.shape[0], 4))
        offset += flat.shape[0]
        if seg_colors is not None:
            seg_colors.append(np.broadcast_to(
                colors[si].mean(axis=0).astype(np.float32),
                (flat.shape[0] // 4, 3)))
    if not all_pts:
        raise ValueError(f"{path}: no usable strands")
    return CubicBezierCurveMesh(
        vertices_thickness=np.concatenate(all_pts),
        indices=np.asarray(indices, np.int32),
        name=name or path,
        segment_colors=(np.concatenate(seg_colors)
                        if seg_colors is not None else None))


def make_demo_hair(num_strands=64, points_per_strand=8, seed=0,
                   base=(0.0, 1.0, 0.0), spread=0.35, length=0.6,
                   thickness=0.004) -> CubicBezierCurveMesh:
    """Procedural hair tuft from a seed (the repository carries no .hair
    asset); the same strands as the JAX package's for the same arguments."""
    g = np.random.default_rng(seed)
    all_pts, indices = [], []
    offset = 0
    for _ in range(num_strands):
        root = np.asarray(base) + np.r_[g.normal(0, spread),
                                        0.0, g.normal(0, spread)]
        d = np.asarray([g.normal(0, 0.3), -1.0, g.normal(0, 0.3)])
        d /= np.linalg.norm(d)
        t = np.linspace(0, 1, points_per_strand)[:, None]
        wiggle = g.normal(0, 0.02, (points_per_strand, 3)).cumsum(axis=0)
        cv = root[None] + t * d[None] * length + wiggle
        r = np.full(points_per_strand, thickness, np.float32)
        flat = _catmullrom_to_bezier_strand(cv.astype(np.float32),
                                            r).reshape(-1, 4)
        all_pts.append(flat)
        indices.extend(range(offset, offset + flat.shape[0], 4))
        offset += flat.shape[0]
    return CubicBezierCurveMesh(
        vertices_thickness=np.concatenate(all_pts),
        indices=np.asarray(indices, np.int32), name="demo_hair")
