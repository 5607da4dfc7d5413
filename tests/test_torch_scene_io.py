"""Scene IO of the port (io/obj.py, io/scene_json.py) against the JAX
package's loaders, on files each test writes.

Both loaders are numpy and the standard library on both sides, so every
parsed value and every committed table must be equal exactly: every
table of JAX's scene dict is in the port's, equal, the threaded-BVH
tables (`bvh_*`, `cbvh_*`) included. The cornellbox files
are chip_smoke.py's `write_cornellbox`, the scene its `file` path renders.
"""
import importlib.util
import json
import os

import numpy as np
import pytest

from pbrlab_tpu_torch.io import obj as tobj
from pbrlab_tpu_torch.io import scene_json as tjson

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

MTL = """# PBR/SSS extension keys, as the reference's golden .mtl has them
specular 0.7
newmtl Body
base_color 0.8 0.5 0.2
subsurface 1.0
subsurface_radius 1.0 0.2 0.1
subsurface_color 1.0 0.8 0.8
specular 1.0
roughness 0.2
specular 0.0
anisotropic 0.3
clearcoat 0.5
ior 1.33
map_base_color -colorspace sRGB checker.png
Ke 0 0 0

newmtl Lamp
base_color 0 0 0
Ke 15 15 15
newmtl Wall Paint
base_color 0.4096 0.050353 0.037544
metallic 0.25
map_subsurface_color -colorspace linear lin.png
"""

OBJ = """mtllib scene.mtl
v 0 0 0
v 1 0 0
v 1 1 0
v 0 1 0
v 0.5 1.5 0
vt 0 0
vt 1 0
vt 1 1
vt 0 1
vn 0 0 1
o wall
usemtl Wall Paint
f 1/1/1 2/2/1 3/3/1 4/4/1
g pentagon
usemtl Body
f -5 -4 -3 -1 -2
o bare
v 0 0 2
v 1 0 2
v 0 1 2
f 6 7 8
usemtl Nowhere
f -3/-4 -2/-3 -1/-2
o lamp
usemtl Lamp
v 0 2 0
v 1 2 0
v 0 2 1
f 9 11 10
"""


def _write(tmp_path, name, text):
    path = tmp_path / name
    path.write_text(text)
    return str(path)


def _textures(tmp_path):
    from pbrlab_tpu_torch.io.image import write_png

    cells = np.indices((4, 6)).sum(0) % 2 * 0.8 + 0.1
    write_png(str(tmp_path / "checker.png"),
              np.repeat(cells[..., None], 3, axis=-1).astype(np.float32))
    write_png(str(tmp_path / "lin.png"),
              np.linspace(0, 1, 24, dtype=np.float32).reshape(2, 4, 3))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _assert_equal(got, want, path=""):
    """Nested dicts of arrays: the same keys and equal values, dtypes
    included."""
    keys = set(want)
    assert set(got) == keys, (path, set(got) ^ keys)
    for k in keys:
        if isinstance(want[k], dict):
            _assert_equal(got[k], want[k], f"{path}{k}.")
            continue
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.dtype == w.dtype, f"{path}{k}"
        np.testing.assert_array_equal(g, w, err_msg=f"{path}{k}")


def test_parse_mtl_matches_jax(tmp_path):
    """Extension keys, 'last duplicate wins', texture maps with their
    colourspace, Ke, a key before any newmtl ignored, a name with a
    space."""
    from pbrlab_tpu.io.obj import parse_mtl

    path = _write(tmp_path, "scene.mtl", MTL)
    got = tobj.parse_mtl(path)
    assert got == parse_mtl(path)
    assert got["Body"]["specular"] == 0.0  # the later of the two
    assert got["Body"]["base_color_tex"] == {"file": "checker.png",
                                             "colorspace": "sRGB"}
    assert got["Wall Paint"]["subsurface_color_tex"]["colorspace"] == \
        "linear"
    assert got["Lamp"]["Ke"] == (15.0, 15.0, 15.0)


def test_load_obj_matches_jax(tmp_path):
    """Objects and groups, fan triangulation of a quad and a pentagon,
    negative indices, v/vt/vn corners, faces before any usemtl (the
    default material) and with a material the mtl lacks."""
    from pbrlab_tpu.io.obj import load_obj

    _write(tmp_path, "scene.mtl", MTL)
    path = _write(tmp_path, "scene.obj", OBJ)
    meshes, mats, names = tobj.load_obj(path)
    want_meshes, want_mats, want_names = load_obj(path)
    assert names == want_names == ["Wall Paint", "Body", "Nowhere", "Lamp"]
    assert mats == want_mats
    assert [m.name for m in meshes] == ["wall", "pentagon", "bare", "lamp"]
    assert [m.num_faces for m in meshes] == [2, 3, 2, 1]
    for got, want in zip(meshes, want_meshes):
        for field in ("vertices", "faces", "normals", "normal_idx",
                      "texcoords", "texcoord_idx", "material_ids"):
            g, w = getattr(got, field), getattr(want, field)
            assert (g is None) == (w is None), field
            if g is not None:
                assert g.dtype == w.dtype, field
                np.testing.assert_array_equal(g, w, err_msg=field)


def test_material_params_to_builder_matches_jax(tmp_path):
    """Every parsed key into the builder, and the texture maps loaded
    (sRGB degamma on the colour map, none on the linear one)."""
    from pbrlab_tpu.io.obj import load_obj
    from pbrlab_tpu.io.obj import material_params_to_builder as jregister
    from pbrlab_tpu.scene.scene import SceneBuilder as JBuilder
    from pbrlab_tpu_torch.scene.scene import SceneBuilder

    _textures(tmp_path)
    _write(tmp_path, "scene.mtl", MTL)
    path = _write(tmp_path, "scene.obj", OBJ)
    got_b, want_b = SceneBuilder(), JBuilder()
    ids = tobj.material_params_to_builder(*tobj.load_obj(path)[1:], got_b)
    assert ids == jregister(*load_obj(path)[1:], want_b) == [0, 1, 2, 3]
    _assert_equal(got_b.materials.build(), want_b.materials.build())
    assert len(got_b._textures) == len(want_b._textures) == 2
    for g, w in zip(got_b._textures, want_b._textures):
        np.testing.assert_array_equal(g, w)


def _flat_scene(tmp_path):
    """A flat scene: two meshes of one OBJ under translate / scale /
    axis_angle / look_at chains, a JSON material with a texture, a hair
    material, an area light on one mesh."""
    _textures(tmp_path)
    _write(tmp_path, "tri.obj",
           "o wall\nv 0 0 0\nv 1 0 0\nv 0 1 0\nv 1 1 0\nf 1 2 4 3\n"
           "o lamp\nv 0 0 1\nv 1 0 1\nv 0 1 1\nf 5 7 6\n")
    desc = {
        "wavefront_objs": [{"filepath": "tri.obj"}],
        "textures": [{"name": "checker", "filepath": "checker.png"}],
        "materials": [
            {"type": "cycles_principled_bsdf", "name": "red",
             "base_color": [0.8, 0.1, 0.1], "roughness": 0.3,
             "base_color_tex_name": "checker"},
            {"type": "hair_bsdf", "name": "fur", "coloring_hair": "rgb",
             "base_color": [0.3, 0.2, 0.1], "roughness": 0.4},
        ],
        "lights": [{"type": "area", "name": "key", "emission": [5, 5, 5]}],
        "local_scenes": [{"name": "ls0", "meshes": ["wall"]},
                         {"name": "ls1", "meshes": ["lamp"]}],
        "instances": [
            {"local_scene": "ls0", "materials": ["red"],
             "transform": [{"type": "scale", "scale": [2, 1, 1]},
                           {"type": "axis_angle", "axis": [0, 1, 1],
                            "angle": 30},
                           {"type": "translate", "translate": [0, 0, -1]}]},
            {"local_scene": "ls1", "lights": ["key"],
             "transform": [{"type": "look_at", "origin": [0, 3, 0],
                            "target": [0, 0, 0], "up": [0, 0, 1]}]},
        ],
        "render": {"width": 64, "height": 32, "max_pass": 4},
    }
    return _write(tmp_path, "scene.json", json.dumps(desc))


def _shared_scene(tmp_path):
    """tests/test_scene_json.py:75: three instances of one local scene
    share one BLAS (build_instanced), plus a lamp."""
    _write(tmp_path, "tri.obj",
           "o blockmesh\nv 0 0 0\nv 1 0 0\nv 0 1 0\nf 1 2 3\n"
           "o lampmesh\nv 0 0 1\nv 1 0 1\nv 0 1 1\nf 4 6 5\n")
    desc = {
        "wavefront_objs": [{"filepath": "tri.obj"}],
        "materials": [{"type": "cycles_principled_bsdf", "name": "red",
                       "base_color": [0.8, 0.1, 0.1]}],
        "lights": [{"type": "area", "name": "key", "emission": [5, 5, 5]}],
        "local_scenes": [{"name": "block", "meshes": ["blockmesh"]},
                         {"name": "lamp", "meshes": ["lampmesh"]}],
        "instances": [
            {"local_scene": "block", "materials": ["red"],
             "transform": [{"type": "translate", "translate": [x, 0, 0]}]}
            for x in (0.0, 2.0, 4.0)
        ] + [{"local_scene": "lamp", "lights": ["key"]}],
    }
    return _write(tmp_path, "scene.json", json.dumps(desc))


def _cornellbox(tmp_path):
    return _chip_smoke().write_cornellbox(str(tmp_path), subdiv=1)


@pytest.mark.parametrize("make", [_flat_scene, _shared_scene, _cornellbox],
                         ids=["flat", "shared-instances", "cornellbox"])
def test_load_scene_json_matches_jax(tmp_path, make):
    from pbrlab_tpu.io.scene_json import load_scene_json

    path = make(tmp_path)
    got, got_cfg, got_names = tjson.load_scene_json(path, return_names=True)
    want, want_cfg, want_names = load_scene_json(path, return_names=True)
    assert got_cfg == want_cfg and got_names == want_names
    _assert_equal(got, want)
    assert ("i5_tris" in got) == (make is _shared_scene)
    assert got["light_emission"].shape == (1, 3)  # one area light
    assert 0 < got["emissive_faces"].shape[0] <= 2


def test_transforms_and_render_config_match_jax(tmp_path):
    from pbrlab_tpu.io import scene_json as jjson

    chains = [[], [{"type": "translate", "translate": [1, 2, 3]}],
              [{"type": "scale", "scale": [2, 3, 4]},
               {"type": "axis_angle", "axis": [1, 2, 3], "angle": 77},
               {"type": "look_at", "origin": [1, 0, 0],
                "target": [0, 1, 0], "up": [0, 0, 1]}]]
    for chain in chains:
        got = tjson.transform_matrix(chain)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, jjson.transform_matrix(chain))
    with pytest.raises(ValueError):
        tjson.transform_matrix([{"type": "shear"}])
    path = _write(tmp_path, "cfg.json", json.dumps(
        {"width": 256, "max_pass": 8, "scene_filepaths": ["a.obj"]}))
    got = tjson.load_render_config(path)
    assert got == tjson.RenderConfig(["a.obj"], 256, 512, 8, -1)
    assert vars(got) == vars(jjson.load_render_config(path))


def test_file_cornellbox_is_the_demo_scene():
    """The file path's scene (chip_smoke.py `load_file_scene`: the
    subdiv=3 cornellbox written as OBJ + MTL + JSON and loaded) commits to
    the demo's triangles and legacy tables bit for bit, 2572 faces, the
    demo's materials on every face and its one light, but for the floor's
    base colour, which its PNG checker texture gives (its material is the
    first the OBJ uses, so the empty slots carry it too); the bodies'
    vertex normals are renormalized under the instances' identity
    transform (1 ulp)."""
    from pbrlab_tpu_torch.scene.demo import build_demo_scene

    got = _chip_smoke().load_file_scene(subdiv=3)
    want = build_demo_scene(subdiv=3)[0]
    assert int((got["face_area"] > 0).sum()) == 2572
    for key in ("tri_v0", "tri_e1", "tri_e2", "face_ng", "face_emission",
                "emissive_faces", "light_emission", "dense_tris",
                "dense_cluster_aabb", "dense_order", "dense_tris_v4"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    np.testing.assert_allclose(got["face_ns"], want["face_ns"], atol=1e-7)
    textured = got["materials"]["base_color_tex_id"][got["face_material"]] == 0
    assert int((textured & (got["face_area"] > 0)).sum()) == 2  # the floor
    for key, col in want["materials"].items():
        w = col[want["face_material"]]
        if key == "base_color_tex_id":
            w = np.where(textured, 0, w)
        np.testing.assert_array_equal(
            got["materials"][key][got["face_material"]], w, err_msg=key)
