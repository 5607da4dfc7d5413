"""Wavefront OBJ + PBR/SSS .mtl extension loader (pure Python).

Port of pbrlab_tpu.io.obj (numpy and the standard library only, as
there). Replaces tinyobjloader + ParseTinyObjMaterial in the reference
(src/io/triangle-mesh-io.cc:34-325). Parses:

* OBJ v/vn/vt/f (with negative indices and polygon fan-triangulation, like
  tinyobj's triangulate=true), one mesh per object/group ("shape");
* the PBR extension keys the reference reads from the mtl
  `unknown_parameter` map (:143-220): base_color, subsurface,
  subsurface_radius, subsurface_color, metallic, specular, specular_tint,
  roughness, anisotropic, anisotropic_rotation, sheen, sheen_tint,
  clearcoat, clearcoat_roughness, ior, transmission,
  transmission_roughness, plus map_base_color / map_subsurface_color with
  colorspace-aware sRGB degamma (:117-141);
* later duplicate keys override earlier ones (std::map::find returns the
  single stored entry; our dict assignment matches the "last wins" result
  for the Lucy material whose mtl repeats `specular`).
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..geometry.mesh import TriangleMesh
from .image import load_image, log, srgb_to_linear

_MTL_FLOAT_KEYS = [
    "subsurface", "metallic", "specular", "specular_tint", "roughness",
    "anisotropic", "anisotropic_rotation", "sheen", "sheen_tint",
    "clearcoat", "clearcoat_roughness", "ior", "transmission",
    "transmission_roughness",
]
_MTL_FLOAT3_KEYS = ["base_color", "subsurface_radius", "subsurface_color"]
_MTL_TEX_KEYS = {"map_base_color": "base_color_tex",
                 "map_subsurface_color": "subsurface_color_tex"}


def parse_mtl(path: str) -> Dict[str, Dict]:
    """Parse a .mtl file -> {material_name: params dict}."""
    materials: Dict[str, Dict] = {}
    cur: Optional[Dict] = None
    with open(path, "r", errors="replace") as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            key, args = parts[0], parts[1:]
            if key == "newmtl":
                cur = {}
                materials[" ".join(args)] = cur
                continue
            if cur is None:
                continue
            if key in _MTL_FLOAT_KEYS and args:
                cur[key] = float(args[0])
            elif key in _MTL_FLOAT3_KEYS and len(args) >= 3:
                cur[key] = tuple(float(a) for a in args[:3])
            elif key in _MTL_TEX_KEYS:
                # texture options (e.g. -colorspace) precede the filename
                colorspace = ""
                fname_parts = []
                i = 0
                while i < len(args):
                    if args[i] == "-colorspace" and i + 1 < len(args):
                        colorspace = args[i + 1]
                        i += 2
                    else:
                        fname_parts.append(args[i])
                        i += 1
                cur[_MTL_TEX_KEYS[key]] = {
                    "file": " ".join(fname_parts), "colorspace": colorspace}
            elif key == "Ke" and len(args) >= 3:
                cur["Ke"] = tuple(float(a) for a in args[:3])
    return materials


def load_obj(path: str) -> Tuple[List[TriangleMesh], List[Dict], List[str]]:
    """Load an OBJ file.

    Returns (meshes, material_param_dicts, material_names). Each mesh's
    material_ids index into the returned material list; faces without a
    material get id 0 of a default-appended material (reference behavior:
    tinyobj assigns -1 which maps to a default principled parameter).
    """
    base_dir = os.path.dirname(os.path.abspath(path))
    verts: List[Tuple[float, float, float]] = []
    normals: List[Tuple[float, float, float]] = []
    texcoords: List[Tuple[float, float]] = []
    mtl_params: Dict[str, Dict] = {}
    mat_names: List[str] = []
    mat_list: List[Dict] = []

    shapes: List[dict] = []

    def new_shape(name):
        shapes.append({"name": name, "faces": [], "mats": []})

    new_shape("")
    cur_mat = -1

    def mat_index(name: str) -> int:
        if name in mat_names:
            return mat_names.index(name)
        mat_names.append(name)
        mat_list.append(mtl_params.get(name, {}))
        return len(mat_names) - 1

    with open(path, "r", errors="replace") as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            key, args = parts[0], parts[1:]
            if key == "v":
                verts.append(tuple(float(a) for a in args[:3]))
            elif key == "vn":
                normals.append(tuple(float(a) for a in args[:3]))
            elif key == "vt":
                texcoords.append(tuple(float(a) for a in args[:2]))
            elif key in ("o", "g"):
                name = " ".join(args)
                if shapes[-1]["faces"]:
                    new_shape(name)
                else:
                    shapes[-1]["name"] = name
            elif key == "mtllib":
                mtl_path = os.path.join(base_dir, " ".join(args))
                if os.path.exists(mtl_path):
                    mtl_params.update(parse_mtl(mtl_path))
            elif key == "usemtl":
                cur_mat = mat_index(" ".join(args))
            elif key == "f":
                corners = []
                for a in args:
                    w = a.split("/")
                    vi = int(w[0])
                    vi = vi - 1 if vi > 0 else len(verts) + vi
                    ti = ni = -1
                    if len(w) > 1 and w[1]:
                        ti = int(w[1])
                        ti = ti - 1 if ti > 0 else len(texcoords) + ti
                    if len(w) > 2 and w[2]:
                        ni = int(w[2])
                        ni = ni - 1 if ni > 0 else len(normals) + ni
                    corners.append((vi, ti, ni))
                for i in range(1, len(corners) - 1):  # fan triangulation
                    shapes[-1]["faces"].append(
                        (corners[0], corners[i], corners[i + 1]))
                    shapes[-1]["mats"].append(cur_mat)

    if not mat_names:
        mat_names.append("__default__")
        mat_list.append({})
    default_id = 0

    meshes: List[TriangleMesh] = []
    v_arr = np.asarray(verts, np.float32) if verts else np.zeros((0, 3),
                                                                 np.float32)
    n_arr = np.asarray(normals, np.float32) if normals else None
    t_arr = np.asarray(texcoords, np.float32) if texcoords else None
    for shape in shapes:
        if not shape["faces"]:
            continue
        fs = np.asarray([[c[0] for c in f] for f in shape["faces"]], np.int32)
        nidx = np.asarray([[c[2] for c in f] for f in shape["faces"]],
                          np.int32)
        tidx = np.asarray([[c[1] for c in f] for f in shape["faces"]],
                          np.int32)
        mids = np.asarray([m if m >= 0 else default_id
                           for m in shape["mats"]], np.int32)
        has_n = n_arr is not None and bool((nidx >= 0).any())
        has_t = t_arr is not None and bool((tidx >= 0).any())
        meshes.append(TriangleMesh(
            vertices=v_arr, faces=fs,
            normals=n_arr if has_n else None,
            normal_idx=nidx if has_n else None,
            texcoords=t_arr if has_t else None,
            texcoord_idx=tidx if has_t else None,
            material_ids=mids, name=shape["name"]))
    for params in mat_list:
        params["__base_dir__"] = base_dir
    return meshes, mat_list, mat_names


def material_params_to_builder(mat_list: List[Dict], mat_names: List[str],
                               builder) -> List[int]:
    """Register parsed mtl materials into a SceneBuilder's MaterialBuilder,
    loading any referenced textures. Returns material table ids."""
    ids = []
    for name, params in zip(mat_names, mat_list):
        kwargs = {}
        for key in _MTL_FLOAT_KEYS + _MTL_FLOAT3_KEYS:
            if key in params:
                kwargs[key] = params[key]
        for tex_key, col in (("base_color_tex", "base_color_tex_id"),
                             ("subsurface_color_tex",
                              "subsurface_color_tex_id")):
            if tex_key in params:
                spec = params[tex_key]
                fpath = os.path.join(params.get("__base_dir__", ""),
                                     spec["file"])
                img = load_image(fpath)
                if img is None:
                    log.warning(
                        "material %r: texture %s unreadable; falling back "
                        "to constant %s", name, fpath, col)
                if img is not None:
                    is_hdr = os.path.splitext(spec["file"])[1].lower() in (
                        ".exr", ".hdr")
                    degamma = (spec["colorspace"] in ("", "sRGB")
                               and not is_hdr)
                    if degamma:
                        img = srgb_to_linear(img)
                    kwargs[col] = builder.add_texture(img, spec["file"])
        ids.append(builder.materials.add_principled(name, **kwargs))
    return ids
