"""Procedural demo scene: cornellbox + glossy "suzanne" + SSS "lucy", and
optionally a hair tuft (port of pbrlab_tpu.scene.demo; materials from the
reference's data/cornellbox_suzanne_lucy.mtl, lights as
pc/pc-common.cc:100-191)."""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from ..geometry.mesh import TriangleMesh
from ..io.cyhair import make_demo_hair
from .scene import SceneBuilder, commit


def quad_mesh(p0, p1, p2, p3, material_id=0, name="") -> TriangleMesh:
    """Two CCW triangles (p0,p1,p2) and (p0,p2,p3)."""
    verts = np.asarray([p0, p1, p2, p3], np.float32)
    faces = np.asarray([[0, 1, 2], [0, 2, 3]], np.int32)
    return TriangleMesh(verts, faces,
                        material_ids=np.full((2,), material_id, np.int32),
                        name=name)


def icosphere(subdiv=3, radius=1.0, center=(0, 0, 0), scale=(1, 1, 1),
              material_id=0, name="", smooth=True,
              displace=0.0) -> TriangleMesh:
    """Subdivided icosahedron with analytic smooth normals; displace > 0
    adds the JAX package's multi-octave radial noise displacement, with
    area-weighted vertex normals."""
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
        cache = {}
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
        noise = (0.55 * np.sin(5.1 * x + 2.3 * y)
                 * np.cos(4.7 * z - 1.1 * x)
                 + 0.3 * np.sin(11.3 * y * z + 3.7 * x)
                 + 0.15 * np.sin(23.0 * (x + y * z)))
        r_mult = (1.0 + displace * noise)[:, None]
    verts = (unit * r_mult * radius * np.asarray(scale)[None]
             + np.asarray(center)[None])
    faces = faces.astype(np.int32)
    normals = None
    normal_idx = None
    if smooth and not displace:
        # ellipsoid normal: unit / scale^2 renormalized
        n = unit / (np.asarray(scale)[None] ** 2)
        n /= np.linalg.norm(n, axis=1, keepdims=True)
        normals = n.astype(np.float32)
        normal_idx = faces.copy()
    elif smooth:
        fv = verts[faces]
        fn = np.cross(fv[:, 1] - fv[:, 0], fv[:, 2] - fv[:, 0])
        n = np.zeros_like(verts)
        for k in range(3):
            np.add.at(n, faces[:, k], fn)
        n /= np.maximum(np.linalg.norm(n, axis=1, keepdims=True), 1e-20)
        normals = n.astype(np.float32)
        normal_idx = faces.copy()
    return TriangleMesh(verts.astype(np.float32), faces, normals=normals,
                        normal_idx=normal_idx,
                        material_ids=np.full((faces.shape[0],), material_id,
                                             np.int32),
                        name=name)


def build_demo_scene(with_monkey=True, with_lucy=True, subdiv=3,
                     lambert_only=False, with_hair=False, irregular=False
                     ) -> Tuple[Dict, SceneBuilder]:
    """Returns (committed numpy scene dict, builder). irregular=True
    noise-displaces the two bodies; with_hair adds a 96-strand procedural
    tuft under the light (672 Bezier segments, Principled Hair BSDF)."""
    b = SceneBuilder()
    m = b.materials
    white = m.add_principled("Wall_White", base_color=(0.8, 0.8, 0.8),
                             specular=0.0, roughness=0.5)
    red = m.add_principled("Wall_Red", base_color=(0.4096, 0.050353, 0.037544),
                           specular=0.0)
    green = m.add_principled("Wall_Green",
                             base_color=(0.023333, 0.4096, 0.047991),
                             specular=0.0)
    light_m = m.add_principled("Light", base_color=(0.0, 0.0, 0.0),
                               specular=0.0)
    if lambert_only:
        monkey = m.add_principled("Monkey", base_color=(0.8, 0.5, 0.2),
                                  specular=0.0)
        lucy = m.add_principled("Lucy", base_color=(1.0, 0.8, 0.8),
                                specular=0.0)
    else:
        monkey = m.add_principled("Monkey", base_color=(0.8, 0.5, 0.2),
                                  specular=1.0, roughness=0.01)
        lucy = m.add_principled("Lucy", base_color=(1.0, 0.8, 0.8),
                                subsurface=1.0,
                                subsurface_radius=(1.0, 0.2, 0.1),
                                subsurface_color=(1.0, 0.8, 0.8),
                                specular=0.0, roughness=0.2)

    # Cornell box: x,z in [-1, 1], y in [0, 2], open toward +z
    meshes = [
        quad_mesh([-1, 0, -1], [-1, 0, 1], [1, 0, 1], [1, 0, -1],
                  white, "floor"),
        quad_mesh([-1, 2, -1], [1, 2, -1], [1, 2, 1], [-1, 2, 1],
                  white, "ceiling"),
        quad_mesh([-1, 0, -1], [1, 0, -1], [1, 2, -1], [-1, 2, -1],
                  white, "back"),
        quad_mesh([-1, 0, -1], [-1, 2, -1], [-1, 2, 1], [-1, 0, 1],
                  red, "left"),
        quad_mesh([1, 0, -1], [1, 0, 1], [1, 2, 1], [1, 2, -1],
                  green, "right"),
    ]
    s = 0.4  # light quad just below the ceiling, normal -y
    meshes.append(quad_mesh([-s, 1.98, -s], [s, 1.98, -s], [s, 1.98, s],
                            [-s, 1.98, s], light_m, "light"))
    if with_monkey:
        meshes.append(icosphere(subdiv, 0.45, center=(-0.45, 0.75, -0.2),
                                material_id=monkey, name="monkey",
                                displace=0.2 if irregular else 0.0))
    if with_lucy:
        meshes.append(icosphere(
            subdiv, 0.35,
            center=(0.45, 0.95 if irregular else 0.7, 0.25),
            scale=(1.0, 2.0, 1.0), material_id=lucy, name="lucy",
            displace=0.3 if irregular else 0.0))

    # one instance per shape, like CreateSceneFromObj (pc-common.cc:145-190)
    for mesh in meshes:
        light_ids = None
        if mesh.name.startswith("light"):
            lid = b.add_area_light_param((3.0, 3.0, 3.0))
            light_ids = [np.full((mesh.num_faces,), lid, np.int32)]
        b.add_instance([mesh], light_ids=light_ids)

    if with_hair:
        hair = make_demo_hair(num_strands=96, base=(0.0, 1.35, 0.0),
                              length=0.7)
        hair.material_id = m.add_hair("hair")
        b.add_instance([], curves=[hair])

    return commit(b.build()), b
