"""A configuration's scene, found by the name its file gives (`"scene"`):
`portbench/scenes/<scene>.py`. Such a file defines `make_scene(config)`
-> `meshes.RawScene`, and may define, in place of the defaults here, the
hooks that hand the scene to the program and to the plain reference:
- `to_port(raw)`: the program's committed scene (`meshes.to_port`);
- `Reference`: the reference's renderer of sampled pixels
  (`checks.Reference`);
- `material_columns(raw, device)`: the reference's material columns,
  which a preview's edits change (`pbref.scene.material_columns`);
- `reference_steps`: the reference's train steps
  (`gradref.reference_steps`);
and the sizes its CPU tests run it at:
- `TINY_CONFIG`: the configuration's keys that the tests on the CPU
  shrink (`runner.resize_for`; default `{"subdiv": 1}`), over the
  configuration's own.
A scene of other shapes or closures (hair, instances, textures) brings
its hooks in its own file, or in new reference modules that file
imports; an unknown scene raises.
"""
from __future__ import annotations

from types import SimpleNamespace

from . import byname, checks, gradref, meshes


def _material_columns(raw, device):
    from pbref import scene as ref_scene

    return ref_scene.material_columns(raw.materials, device)


DEFAULTS = {"to_port": meshes.to_port, "Reference": checks.Reference,
            "material_columns": _material_columns,
            "reference_steps": gradref.reference_steps,
            "TINY_CONFIG": {"subdiv": 1}}


def load(name):
    """The scene `name`'s make_scene, hooks and `TINY_CONFIG`, as one
    namespace."""
    mod = byname.module("scenes", name)
    if not callable(getattr(mod, "make_scene", None)):
        raise KeyError(f"scenes/{name}.py defines no make_scene(config)")
    return SimpleNamespace(make_scene=mod.make_scene, **{
        k: getattr(mod, k, v) for k, v in DEFAULTS.items()})
