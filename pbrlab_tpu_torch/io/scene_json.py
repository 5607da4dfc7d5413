"""Declarative JSON scene description + render config.

Port of pbrlab_tpu.io.scene_json (numpy and the standard library only, as
there). Ports the reference schema (src/scene-description/
scene-description.h:14-153 and src/render-config.h:9-18) with the behavior
the reference left as TODO implemented: transforms (translate / scale /
axis_angle / look_at chains) ARE applied to instances here (the reference
parses them but never uses them, scene-description.cc:456-460). The port
has no CLI yet (ROADMAP A15): `load_render_config` and the returned
"render" section are for its callers.

Schema (all sections optional):

{
  "wavefront_objs": [{"filepath": ..., "default_material": ...}],
  "cyhairs":        [{"filepath": ..., "name": ..., "default_material": ...}],
  "textures":       [{"name": ..., "filepath": ...}],
  "materials":      [{"type": "cycles_principled_bsdf"|"hair_bsdf",
                      "name": ..., <param>: <value>, ...,
                      "base_color_tex_name": ...}],
  "lights":         [{"type": "area", "name": ..., "emission": [r,g,b]}],
  "local_scenes":   [{"name": ..., "meshes": [mesh names]}],
  "instances":      [{"local_scene": ..., "materials": [names per mesh],
                      "lights": [light names per mesh],
                      "transform": [{"type": "translate", ...}, ...]}],
  "render":         {"width": 512, "height": 512, "max_pass": 32}
}
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, List, Optional

import numpy as np

from ..geometry.mesh import CubicBezierCurveMesh, TriangleMesh
from ..scene.instanced import build_instanced
from ..scene.scene import SceneBuilder, commit
from .cyhair import load_cyhair_as_bezier
from .image import load_image, srgb_to_linear
from .obj import load_obj, material_params_to_builder


@dataclasses.dataclass
class RenderConfig:
    """src/render-config.h:9-18 (thread is kept for schema compatibility;
    nothing reads it)."""

    scene_filepaths: List[str] = dataclasses.field(default_factory=list)
    width: int = 512
    height: int = 512
    max_pass: int = 32
    thread: int = -1


def load_render_config(path: str) -> RenderConfig:
    with open(path) as f:
        d = json.load(f)
    cfg = RenderConfig()
    for k in ("scene_filepaths", "width", "height", "max_pass", "thread"):
        if k in d:
            setattr(cfg, k, d[k])
    return cfg


def transform_matrix(transforms: List[Dict]) -> np.ndarray:
    """Compose a transform chain into a 4x4 (applied in list order)."""
    m = np.eye(4, dtype=np.float32)
    for t in transforms or []:
        kind = t.get("type", "translate")
        a = np.eye(4, dtype=np.float32)
        if kind == "translate":
            a[:3, 3] = t.get("translate", [0, 0, 0])
        elif kind == "scale":
            np.fill_diagonal(a[:3, :3], t.get("scale", [1, 1, 1]))
        elif kind == "axis_angle":
            axis = np.asarray(t.get("axis", [1, 0, 0]), np.float64)
            axis = axis / max(np.linalg.norm(axis), 1e-12)
            ang = np.deg2rad(t.get("angle", 0.0))
            c, s = np.cos(ang), np.sin(ang)
            x, y, z = axis
            a[:3, :3] = np.asarray([
                [c + x * x * (1 - c), x * y * (1 - c) - z * s,
                 x * z * (1 - c) + y * s],
                [y * x * (1 - c) + z * s, c + y * y * (1 - c),
                 y * z * (1 - c) - x * s],
                [z * x * (1 - c) - y * s, z * y * (1 - c) + x * s,
                 c + z * z * (1 - c)]], np.float32)
        elif kind == "look_at":
            origin = np.asarray(t.get("origin", [0, 0, 0]), np.float64)
            target = np.asarray(t.get("target", [0, 0, 1]), np.float64)
            up = np.asarray(t.get("up", [0, 1, 0]), np.float64)
            fwd = target - origin
            fwd /= max(np.linalg.norm(fwd), 1e-12)
            right = np.cross(fwd, up)
            right /= max(np.linalg.norm(right), 1e-12)
            up2 = np.cross(right, fwd)
            a[:3, 0] = right
            a[:3, 1] = up2
            a[:3, 2] = -fwd
            a[:3, 3] = origin
        else:
            raise ValueError(f"unknown transform type: {kind}")
        m = a @ m
    return m


_PRINCIPLED_JSON_KEYS = [
    "base_color", "subsurface", "subsurface_radius", "subsurface_color",
    "metallic", "specular", "specular_tint", "roughness", "anisotropic",
    "anisotropic_rotation", "sheen", "sheen_tint", "clearcoat",
    "clearcoat_roughness", "ior", "transmission", "transmission_roughness",
]
_HAIR_JSON_KEYS = {
    "base_color": "hair_base_color", "melanin": "melanin",
    "melanin_redness": "melanin_redness",
    "melanin_randomize": "melanin_randomize", "roughness": "hair_roughness",
    "azimuthal_roughness": "azimuthal_roughness", "ior": "hair_ior",
    "shift": "shift", "specular_tint": "hair_specular_tint",
    "second_specular_tint": "second_specular_tint",
    "transmission_tint": "transmission_tint",
}


def load_scene_json(path: str, return_names: bool = False):
    """Parse + build: returns (committed numpy scene dict, the "render"
    section) — with return_names=True, additionally the material-name
    list (glfw-window.cc:651-980 enumerates every scene material the same
    way). The scene goes to a device with `scene.scene_from_numpy`.

    Mirrors CreateSceneFromSceneDescription's resolution order
    (scene-description.cc:526-583): objs -> cyhairs -> textures ->
    materials -> lights -> local_scenes -> instances, names resolved to
    ids; per-mesh uniform material/light overrides per instance
    (scene-description.cc:442-524).
    """
    base_dir = os.path.dirname(os.path.abspath(path))
    with open(path) as f:
        root = json.load(f)

    b = SceneBuilder()
    meshes_by_name: Dict[str, TriangleMesh] = {}
    curves_by_name: Dict[str, CubicBezierCurveMesh] = {}
    auto_instance_meshes: List[TriangleMesh] = []
    auto_instance_curves: List[CubicBezierCurveMesh] = []

    # 1. wavefront objs
    for obj in root.get("wavefront_objs", []):
        fpath = os.path.join(base_dir, obj["filepath"])
        meshes, mat_list, mat_names = load_obj(fpath)
        ids = material_params_to_builder(mat_list, mat_names, b)
        for mesh in meshes:
            mesh.material_ids = np.asarray(
                [ids[m] for m in mesh.material_ids], np.int32)
            meshes_by_name[mesh.name] = mesh
            if obj.get("create_instances_automatically"):
                auto_instance_meshes.append(mesh)

    # 2. cyhairs
    for ch in root.get("cyhairs", []):
        fpath = os.path.join(base_dir, ch["filepath"])
        curve = load_cyhair_as_bezier(fpath, name=ch.get("name", ""))
        curves_by_name[curve.name] = curve
        if ch.get("create_instances_automatically"):
            auto_instance_curves.append(curve)

    # 3. textures
    tex_ids: Dict[str, int] = {}
    for tex in root.get("textures", []):
        img = load_image(os.path.join(base_dir, tex["filepath"]))
        if img is None:
            raise FileNotFoundError(tex["filepath"])
        ext = os.path.splitext(tex["filepath"])[1].lower()
        if ext not in (".exr", ".hdr"):
            img = srgb_to_linear(img)
        tex_ids[tex["name"]] = b.add_texture(img, tex["name"])

    # 4. materials
    mat_ids: Dict[str, int] = {}
    for mat in root.get("materials", []):
        name = mat.get("name", "")
        if mat.get("type", "cycles_principled_bsdf") == "hair_bsdf":
            kwargs = {}
            for jk, col in _HAIR_JSON_KEYS.items():
                if jk in mat:
                    kwargs[col] = mat[jk]
            if mat.get("coloring_hair") == "rgb":
                kwargs["hair_coloring"] = 0
            elif mat.get("coloring_hair") == "melanin":
                kwargs["hair_coloring"] = 1
            mat_ids[name] = b.materials.add_hair(name, **kwargs)
        else:
            kwargs = {k: mat[k] for k in _PRINCIPLED_JSON_KEYS if k in mat}
            if mat.get("base_color_tex_name"):
                kwargs["base_color_tex_id"] = tex_ids[
                    mat["base_color_tex_name"]]
            if mat.get("subsurface_color_tex_name"):
                kwargs["subsurface_color_tex_id"] = tex_ids[
                    mat["subsurface_color_tex_name"]]
            mat_ids[name] = b.materials.add_principled(name, **kwargs)

    # 5. lights
    light_ids: Dict[str, int] = {}
    for light in root.get("lights", []):
        if light.get("type", "area") != "area":
            raise NotImplementedError(
                f"light type {light['type']} (reference supports area only,"
                " light-param.h:19-24)")
        light_ids[light.get("name", "")] = b.add_area_light_param(
            light.get("emission", [1.0, 1.0, 1.0]))

    # 6. local scenes
    local_scenes: Dict[str, List[str]] = {
        ls["name"]: ls["meshes"] for ls in root.get("local_scenes", [])}

    # 7. instances — instances sharing a local scene (with identical
    # material/light overrides) become ONE shared-BLAS group traced by
    # the two-level instancing kernel (reference CreateInstanceFromLocal-
    # Scene shares the Embree BLAS the same way, raytracer_impl.cc:49-84).
    # Local scenes containing cyhairs participate too: their curves are
    # baked to world space per instance inside build_instanced while the
    # triangles keep the shared BLAS.
    shared_xforms: Dict[tuple, List[np.ndarray]] = {}
    any_triangles = False
    for inst in root.get("instances", []):
        key = (inst["local_scene"], tuple(inst.get("materials", [])),
               tuple(inst.get("lights", [])))
        shared_xforms.setdefault(key, []).append(
            transform_matrix(inst.get("transform")))
        names = local_scenes.get(inst["local_scene"], [inst["local_scene"]])
        any_triangles |= any(mn not in curves_by_name for mn in names)
    # build_instanced needs >= 1 triangle BLAS; a curves-only scene gains
    # nothing from sharing anyway (curves are baked per instance either way)
    use_shared = (any_triangles
                  and any(len(v) > 1 for v in shared_xforms.values()))
    done_shared = set()

    for inst in root.get("instances", []):
        mesh_names = local_scenes.get(inst["local_scene"],
                                      [inst["local_scene"]])
        xform = transform_matrix(inst.get("transform"))
        key = (inst["local_scene"], tuple(inst.get("materials", [])),
               tuple(inst.get("lights", [])))
        if use_shared and key in done_shared:
            continue
        tri_meshes, curve_meshes, lights_per_mesh = [], [], []
        mats = inst.get("materials", [])
        lights = inst.get("lights", [])
        for i, mn in enumerate(mesh_names):
            if mn in curves_by_name:
                cm = curves_by_name[mn]
                # transforms are applied at build time (SceneBuilder.build /
                # build_instanced bake control points per instance via
                # scene.transform_curve_points)
                cm = CubicBezierCurveMesh(cm.vertices_thickness, cm.indices,
                                          material_id=cm.material_id,
                                          name=cm.name,
                                          segment_colors=cm.segment_colors)
                if i < len(mats) and mats[i]:
                    cm.material_id = mat_ids[mats[i]]
                curve_meshes.append(cm)
                continue
            mesh = meshes_by_name[mn]
            mesh = TriangleMesh(mesh.vertices, mesh.faces, mesh.normals,
                                mesh.normal_idx, mesh.texcoords,
                                mesh.texcoord_idx,
                                mesh.material_ids.copy(), mesh.name)
            if i < len(mats) and mats[i]:
                mesh.material_ids[:] = mat_ids[mats[i]]
            tri_meshes.append(mesh)
            if i < len(lights) and lights[i]:
                lights_per_mesh.append(np.full((mesh.num_faces,),
                                               light_ids[lights[i]],
                                               np.int32))
            else:
                lights_per_mesh.append(None)
        if use_shared:
            done_shared.add(key)
            b.add_shared_instances(tri_meshes,
                                   np.stack(shared_xforms[key]),
                                   light_ids=lights_per_mesh,
                                   curves=curve_meshes)
        else:
            b.add_instance(tri_meshes, curves=curve_meshes,
                           light_ids=lights_per_mesh, transform=xform)

    # auto instances (identity transform)
    for mesh in auto_instance_meshes:
        b.add_instance([mesh])
    for curve in auto_instance_curves:
        b.add_instance([], curves=[curve])

    if use_shared:
        scene = build_instanced(b)
    else:
        scene = commit(b.build())
    if return_names:
        return scene, root.get("render", {}), list(b.materials.names)
    return scene, root.get("render", {})
