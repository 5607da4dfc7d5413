"""Host-side triangle mesh container (numpy; port of
pbrlab_tpu.geometry.mesh, reference mesh/triangle-mesh.h:15-60). The hair
curve container is not ported yet (ROADMAP A11)."""
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
