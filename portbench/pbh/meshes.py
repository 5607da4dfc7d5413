"""A scene as plain data: triangle meshes, principled materials and area
lights (`RawScene`), the shapes the scenes of `portbench/scenes/` are
built from, and `to_port`, which hands a raw scene to the program
through its own SceneBuilder. Nothing here imports the program at import
time; the plain reference builds its own tables from the same raw scene
(`pbref.scene`).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np


@dataclasses.dataclass
class Mesh:
    name: str
    vertices: np.ndarray  # [V, 3] float32
    faces: np.ndarray  # [F, 3] int32
    material: int
    normals: Optional[np.ndarray] = None  # [V, 3] float32, per vertex
    emission: Optional[tuple] = None  # area light rgb


@dataclasses.dataclass
class RawScene:
    meshes: List[Mesh]
    materials: List[tuple]  # (name, {principled parameter: value})

    @property
    def material_names(self):
        return [name for name, _ in self.materials]

    @property
    def num_faces(self):
        return sum(m.faces.shape[0] for m in self.meshes)


def quad(name, p0, p1, p2, p3, material, emission=None) -> Mesh:
    verts = np.asarray([p0, p1, p2, p3], np.float32)
    faces = np.asarray([[0, 1, 2], [0, 2, 3]], np.int32)
    return Mesh(name, verts, faces, material, emission=emission)


def icosphere(name, subdiv, radius, center, material, scale=(1, 1, 1),
              displace=0.0) -> Mesh:
    """Subdivided icosahedron with smooth normals: analytic for the
    ellipsoid, area-weighted vertex normals under the radial noise."""
    t = (1.0 + np.sqrt(5.0)) / 2.0
    verts = np.asarray(
        [[-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
         [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
         [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1]], np.float64)
    verts /= np.linalg.norm(verts, axis=1, keepdims=True)
    faces = np.asarray(
        [[0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
         [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
         [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
         [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1]], np.int64)
    for _ in range(subdiv):
        cache: Dict = {}
        new_faces = []
        verts_list = list(verts)

        def midpoint(a, b):
            key = (min(a, b), max(a, b))
            if key not in cache:
                m = verts_list[a] + verts_list[b]
                m /= np.linalg.norm(m)
                cache[key] = len(verts_list)
                verts_list.append(m)
            return cache[key]

        for f in faces:
            a, b, c = int(f[0]), int(f[1]), int(f[2])
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            new_faces += [[a, ab, ca], [ab, b, bc], [ca, bc, c], [ab, bc, ca]]
        verts = np.asarray(verts_list)
        faces = np.asarray(new_faces, np.int64)

    unit = verts.copy()
    r_mult = 1.0
    if displace:
        x, y, z = unit[:, 0], unit[:, 1], unit[:, 2]
        noise = (0.55 * np.sin(5.1 * x + 2.3 * y) * np.cos(4.7 * z - 1.1 * x)
                 + 0.3 * np.sin(11.3 * y * z + 3.7 * x)
                 + 0.15 * np.sin(23.0 * (x + y * z)))
        r_mult = (1.0 + displace * noise)[:, None]
    verts = (unit * r_mult * radius * np.asarray(scale)[None]
             + np.asarray(center)[None])
    faces = faces.astype(np.int32)
    if not displace:
        n = unit / (np.asarray(scale)[None] ** 2)
        n /= np.linalg.norm(n, axis=1, keepdims=True)
    else:
        fv = verts[faces]
        fn = np.cross(fv[:, 1] - fv[:, 0], fv[:, 2] - fv[:, 0])
        n = np.zeros_like(verts)
        for k in range(3):
            np.add.at(n, faces[:, k], fn)
        n /= np.maximum(np.linalg.norm(n, axis=1, keepdims=True), 1e-20)
    return Mesh(name, verts.astype(np.float32), faces, material,
                normals=n.astype(np.float32))


def to_port(raw: RawScene):
    """The program's committed numpy scene of `raw`, through its own
    SceneBuilder (one instance a mesh, as pbrlab's CreateSceneFromObj)."""
    from pbrlab_tpu_torch.geometry.mesh import TriangleMesh
    from pbrlab_tpu_torch.scene.scene import SceneBuilder, commit

    b = SceneBuilder()
    for name, params in raw.materials:
        b.materials.add_principled(name, **params)
    for m in raw.meshes:
        has_n = m.normals is not None
        mesh = TriangleMesh(m.vertices, m.faces,
                            normals=m.normals if has_n else None,
                            normal_idx=m.faces.copy() if has_n else None,
                            material_ids=np.full((m.faces.shape[0],),
                                                 m.material, np.int32),
                            name=m.name)
        light_ids = None
        if m.emission is not None:
            lid = b.add_area_light_param(m.emission)
            light_ids = [np.full((m.faces.shape[0],), lid, np.int32)]
        b.add_instance([mesh], light_ids=light_ids)
    return commit(b.build())
