"""Small scenes of the gradient tests (tests/test_gradients.py:32-56 and
:121-150), built by either package's builder and commit.

`pkg` is "pbrlab_tpu" (the JAX package) or "pbrlab_tpu_torch" (the port);
both builders are numpy, so the committed dicts feed either package.
"""
import importlib

import numpy as np


def _modules(pkg):
    return (importlib.import_module(f"{pkg}.scene.scene"),
            importlib.import_module(f"{pkg}.geometry.mesh"))


def _quad(mesh_mod, y, s, m, uv=False):
    verts = np.asarray([[-s, y, -s], [s, y, -s], [s, y, s], [-s, y, s]],
                       np.float32)
    faces = np.asarray([[0, 1, 2], [0, 2, 3]], np.int32)
    kw = {}
    if uv:
        kw = dict(texcoords=np.asarray([[0, 0], [1, 0], [1, 1], [0, 1]],
                                       np.float32), texcoord_idx=faces)
    return mesh_mod.TriangleMesh(verts, faces,
                                 material_ids=np.full((2,), m, np.int32),
                                 **kw)


def glossy_scene(pkg):
    """Glossy floor under an area light: every camera path shades a
    surface whose radiance depends smoothly on roughness and specular."""
    scene_mod, mesh_mod = _modules(pkg)
    b = scene_mod.SceneBuilder()
    mat = b.materials.add_principled("floor", base_color=(0.8, 0.6, 0.4),
                                     specular=0.8, roughness=0.4)
    lmat = b.materials.add_principled("light", base_color=(0.0, 0.0, 0.0))
    lid = b.add_area_light_param((6.0, 6.0, 6.0))
    b.add_instance([_quad(mesh_mod, 0.0, 1.0, mat),
                    _quad(mesh_mod, 1.5, 0.5, lmat)],
                   light_ids=[None, np.full((2,), lid, np.int32)])
    return scene_mod.commit(b.build())


def textured_scene(pkg):
    """Emissive quad over a floor quad textured with a 4x4 ramp."""
    scene_mod, mesh_mod = _modules(pkg)
    b = scene_mod.SceneBuilder()
    tex = np.zeros((4, 4, 3), np.float32)
    tex[:, :, 0] = np.linspace(0.2, 0.9, 4)[None, :]
    tex[:, :, 1] = 0.5
    tex[:, :, 2] = np.linspace(0.9, 0.2, 4)[:, None]
    tid = b.add_texture(tex, "checker")
    mat = b.materials.add_principled("floor", base_color_tex_id=tid,
                                     roughness=0.8)
    lmat = b.materials.add_principled("light", base_color=(0.0, 0.0, 0.0))
    lid = b.add_area_light_param((6.0, 6.0, 6.0))
    b.add_instance([_quad(mesh_mod, 0.0, 1.0, mat, uv=True),
                    _quad(mesh_mod, 1.5, 0.5, lmat)],
                   light_ids=[None, np.full((2,), lid, np.int32)])
    return scene_mod.commit(b.build())
