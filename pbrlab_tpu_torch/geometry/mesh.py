"""Host-side mesh containers (numpy; port of pbrlab_tpu.geometry.mesh):
triangle meshes (reference mesh/triangle-mesh.h:15-60) and cubic Bezier
hair curves (mesh/cubic-bezier-curve-mesh.h:12-34)."""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass
class TriangleMesh:
    """Indexed triangle mesh with optional shading normals / texcoords.

    vertices:    [V, 3] float32
    faces:       [F, 3] int32 vertex indices
    normals:     [N, 3] float32 or None
    normal_idx:  [F, 3] int32 into normals, or None (use geometric normal)
    texcoords:   [T, 2] float32 or None
    texcoord_idx:[F, 3] int32 into texcoords, or None
    material_ids:[F] int32 per-face material table index
    name:        mesh name (drives the reference's "light*" emission rule)
    """

    vertices: np.ndarray
    faces: np.ndarray
    normals: Optional[np.ndarray] = None
    normal_idx: Optional[np.ndarray] = None
    texcoords: Optional[np.ndarray] = None
    texcoord_idx: Optional[np.ndarray] = None
    material_ids: Optional[np.ndarray] = None
    name: str = ""

    def __post_init__(self):
        self.vertices = np.ascontiguousarray(self.vertices, np.float32)
        self.faces = np.ascontiguousarray(self.faces, np.int32)
        if self.material_ids is None:
            self.material_ids = np.zeros((self.faces.shape[0],), np.int32)
        else:
            self.material_ids = np.ascontiguousarray(self.material_ids, np.int32)
        if self.normals is not None:
            self.normals = np.ascontiguousarray(self.normals, np.float32)
        if self.normal_idx is not None:
            self.normal_idx = np.ascontiguousarray(self.normal_idx, np.int32)
        if self.texcoords is not None:
            self.texcoords = np.ascontiguousarray(self.texcoords, np.float32)
        if self.texcoord_idx is not None:
            self.texcoord_idx = np.ascontiguousarray(self.texcoord_idx, np.int32)

    @property
    def num_faces(self) -> int:
        return int(self.faces.shape[0])


@dataclasses.dataclass
class CubicBezierCurveMesh:
    """Cubic Bezier hair curves: float4 control points (xyz + thickness).

    vertices_thickness [P, 4] packed control points, indices [S] start
    index of each 4-point segment. segment_colors optionally carries
    per-segment RGB (from a CyHair color block, io/cyhair.py); the scene
    build surfaces it as a per-strand hair base-color override (the
    reference parses the block and never consumes it, io/cyhair.cc:105-116).
    """

    vertices_thickness: np.ndarray  # [P, 4] float32 (xyz + radius)
    indices: np.ndarray  # [S] int32 first-control-point index per segment
    material_id: int = 0
    name: str = ""
    segment_colors: Optional[np.ndarray] = None  # [S, 3] float32 or None

    def __post_init__(self):
        self.vertices_thickness = np.ascontiguousarray(
            self.vertices_thickness, np.float32)
        self.indices = np.ascontiguousarray(self.indices, np.int32)
        if self.segment_colors is not None:
            self.segment_colors = np.ascontiguousarray(
                self.segment_colors, np.float32)
            if self.segment_colors.shape != (self.indices.shape[0], 3):
                raise ValueError("segment_colors must be [S, 3]")

    @property
    def num_segments(self) -> int:
        return int(self.indices.shape[0])

    def segment_points(self) -> np.ndarray:
        """[S, 4, 4] per-segment control points (xyz + radius)."""
        idx = self.indices[:, None] + np.arange(4)[None, :]
        return self.vertices_thickness[idx]
