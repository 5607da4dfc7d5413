"""The plain reference's scene tables, built from the benchmark's raw
scene (`pbh.scenes.RawScene`) and from nothing the program made.

Per-face columns in mesh order (the program reorders its faces into BVH
slot order; the reference keeps the order it is given), the emissive
faces' CDF (pbrlab's light-manager: p(face) = power share, area
measure), the principled material columns with pbrlab's defaults
(material-param.h), and the scene box the camera frames. The layout of
the face rows follows pbrlab_tpu_torch's `build_fat_tables` as it stood
when the benchmark was written.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

# (column, default) of the principled material (material-param.h:24-49)
PRINCIPLED = [
    ("base_color", (0.8, 0.8, 0.8)), ("subsurface", 0.0),
    ("subsurface_radius", (1.0, 1.0, 1.0)),
    ("subsurface_color", (0.7, 0.1, 0.1)), ("metallic", 0.0),
    ("specular", 0.5), ("specular_tint", 0.0), ("roughness", 0.5),
    ("anisotropic", 0.0), ("anisotropic_rotation", 0.0), ("sheen", 0.0),
    ("sheen_tint", 0.5), ("clearcoat", 0.0), ("clearcoat_roughness", 0.03),
    ("ior", 1.45), ("transmission", 0.0), ("transmission_roughness", 0.0),
]


def material_columns(materials, device) -> Dict[str, torch.Tensor]:
    """[(name, params)] -> {column: [M] or [M, 3] float32 tensor}."""
    out = {}
    for key, default in PRINCIPLED:
        vals = [np.broadcast_to(np.asarray(p.get(key, default), np.float32),
                                np.shape(default)) for _, p in materials]
        out[key] = torch.from_numpy(np.stack(vals).astype(np.float32)).to(
            device)
    return out


class Geometry:
    """Host arrays of the raw scene's faces, in mesh order."""

    def __init__(self, raw):
        tri_v, ns, has_ns, mat, light, inst = [], [], [], [], [], []
        emissions = []
        for i, m in enumerate(raw.meshes):
            f = m.faces
            nf = f.shape[0]
            tri_v.append(m.vertices[f])
            if m.normals is not None:
                ns.append(m.normals[f])
                has_ns.append(np.ones((nf,), bool))
            else:
                ns.append(np.zeros((nf, 3, 3), np.float32))
                has_ns.append(np.zeros((nf,), bool))
            mat.append(np.full((nf,), m.material, np.int32))
            lid = -1
            if m.emission is not None:
                emissions.append(np.asarray(m.emission, np.float32))
                lid = len(emissions) - 1
            light.append(np.full((nf,), lid, np.int32))
            inst.append(np.full((nf,), i, np.int32))
        v = np.concatenate(tri_v).astype(np.float32)
        self.v0 = v[:, 0]
        self.e1 = v[:, 1] - v[:, 0]
        self.e2 = v[:, 2] - v[:, 0]
        ng = np.cross(self.e1, self.e2)
        area2 = np.linalg.norm(ng, axis=-1)
        self.ng = (ng / np.maximum(area2, 1e-30)[:, None]).astype(np.float32)
        self.area = (0.5 * area2).astype(np.float32)
        self.ns = np.concatenate(ns).astype(np.float32)
        self.has_ns = np.concatenate(has_ns)
        self.material = np.concatenate(mat)
        face_light = np.concatenate(light)
        self.instance = np.concatenate(inst)
        n = face_light.shape[0]
        self.emission = np.zeros((n, 3), np.float32)
        self.light_pdf = np.zeros((n,), np.float32)
        self.emissive = np.nonzero(face_light >= 0)[0].astype(np.int64)
        em = np.stack(emissions)[face_light[self.emissive]]
        self.emission[self.emissive] = em
        power = em.max(axis=-1) * self.area[self.emissive]
        p_choose = power / max(power.sum(), 1e-30)
        self.light_pdf[self.emissive] = p_choose / np.maximum(
            self.area[self.emissive], 1e-30)
        self.light_cdf = np.cumsum(p_choose).astype(np.float32)
        self.aabb_min = v.reshape(-1, 3).min(axis=0)
        self.aabb_max = v.reshape(-1, 3).max(axis=0)


def tables(geo: Geometry, materials: Dict[str, torch.Tensor],
           face_emission: torch.Tensor, device, dtype=torch.float32):
    """The per-lane lookup tables, differentiable in the material columns
    and `face_emission` [F, 3]:
    face [F, 26]: ng | 3x3 corner ns | 3x2 uv (zero) | has_ns | has_uv |
      material | light pdf | emission | instance
    light [LF, 16]: v0 e1 e2 ng emission pdf of the emissive faces
    mat: the material columns, light_cdf, aabb_min / aabb_max."""
    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)

    f = geo.v0.shape[0]
    f32 = torch.float32
    ng, pdf = t(geo.ng), t(geo.light_pdf)
    face = torch.cat([
        ng, t(geo.ns).reshape(f, 9), torch.zeros((f, 6), device=device),
        t(geo.has_ns).to(f32)[:, None], torch.zeros((f, 1), device=device),
        t(geo.material).to(f32)[:, None], pdf[:, None], face_emission,
        t(geo.instance).to(f32)[:, None]], dim=1)
    lf = t(geo.emissive)
    light = torch.cat([t(geo.v0)[lf], t(geo.e1)[lf], t(geo.e2)[lf], ng[lf],
                       face_emission[lf], pdf[lf][:, None]], dim=1)
    return {"face": face.to(dtype), "light": light.to(dtype),
            "mat": {k: v.to(dtype) for k, v in materials.items()},
            "light_cdf": t(geo.light_cdf).to(dtype),
            "aabb_min": t(geo.aabb_min).to(dtype),
            "aabb_max": t(geo.aabb_max).to(dtype)}
