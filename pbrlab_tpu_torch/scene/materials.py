"""Material parameter tables as structure-of-arrays (port of
pbrlab_tpu.scene.materials; defaults mirror material-param.h:24-72).

The host-side builder is numpy, as in the JAX package. On the device the
table is packed into one [M, K] float32 matrix (`pack_material_fat`) and a
lane fetches its material as one row, unpacked by `unpack_material_rows`.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List

import numpy as np
import torch

KIND_PRINCIPLED = 0
KIND_HAIR = 1

# (column, default, width) for the principled BSDF (material-param.h:24-49).
PRINCIPLED_COLUMNS = [
    ("base_color", (0.8, 0.8, 0.8), 3),
    ("subsurface", 0.0, 1),
    ("subsurface_radius", (1.0, 1.0, 1.0), 3),
    ("subsurface_color", (0.7, 0.1, 0.1), 3),
    ("metallic", 0.0, 1),
    ("specular", 0.5, 1),
    ("specular_tint", 0.0, 1),
    ("roughness", 0.5, 1),
    ("anisotropic", 0.0, 1),
    ("anisotropic_rotation", 0.0, 1),
    ("sheen", 0.0, 1),
    ("sheen_tint", 0.5, 1),
    ("clearcoat", 0.0, 1),
    ("clearcoat_roughness", 0.03, 1),
    ("ior", 1.45, 1),
    ("transmission", 0.0, 1),
    ("transmission_roughness", 0.0, 1),
]

# Hair BSDF columns (material-param.h:52-72); hair_coloring 0 = RGB,
# 1 = melanin (shading/hair.py).
HAIR_COLUMNS = [
    ("hair_coloring", 1, 1),
    ("hair_base_color", (0.18, 0.06, 0.02), 3),
    ("melanin", 0.5, 1),
    ("melanin_redness", 0.8, 1),
    ("melanin_randomize", 0.0, 1),
    ("hair_roughness", 0.2, 1),
    ("azimuthal_roughness", 0.3, 1),
    ("hair_ior", 1.55, 1),
    ("shift", 2.0, 1),
    ("hair_specular_tint", (1.0, 1.0, 1.0), 3),
    ("second_specular_tint", (1.0, 1.0, 1.0), 3),
    ("transmission_tint", (1.0, 1.0, 1.0), 3),
]

ALL_COLUMNS = PRINCIPLED_COLUMNS + HAIR_COLUMNS
INT_COLUMNS = {"kind", "base_color_tex_id", "subsurface_color_tex_id",
               "hair_coloring"}


@dataclasses.dataclass
class MaterialBuilder:
    """Host-side accumulation of principled material rows -> SoA numpy dict."""

    rows: List[Dict[str, Any]] = dataclasses.field(default_factory=list)
    names: List[str] = dataclasses.field(default_factory=list)

    def add_principled(self, name: str = "", **params) -> int:
        row = {"kind": KIND_PRINCIPLED,
               "base_color_tex_id": params.pop("base_color_tex_id", -1),
               "subsurface_color_tex_id": params.pop("subsurface_color_tex_id", -1)}
        for key, default, _ in ALL_COLUMNS:
            row[key] = params.pop(key, default)
        if params:
            raise ValueError(f"unknown principled params: {sorted(params)}")
        self.rows.append(row)
        self.names.append(name)
        return len(self.rows) - 1

    def add_hair(self, name: str = "", **params) -> int:
        """A Principled Hair BSDF material (HairBsdfParameter)."""
        row = {"kind": KIND_HAIR, "base_color_tex_id": -1,
               "subsurface_color_tex_id": -1}
        for key, default, _ in ALL_COLUMNS:
            row[key] = params.pop(key, default)
        if params:
            raise ValueError(f"unknown hair params: {sorted(params)}")
        self.rows.append(row)
        self.names.append(name)
        return len(self.rows) - 1

    def build(self) -> Dict[str, np.ndarray]:
        """Pack rows into an SoA dict of numpy arrays ("material table")."""
        rows = self.rows or [dict(
            [("kind", KIND_PRINCIPLED), ("base_color_tex_id", -1),
             ("subsurface_color_tex_id", -1)]
            + [(k, d) for k, d, _ in ALL_COLUMNS])]
        table: Dict[str, np.ndarray] = {}
        for key, _, width in ALL_COLUMNS:
            vals = [np.broadcast_to(np.asarray(r[key], np.float32), (width,))
                    if width > 1 else np.asarray(r[key], np.float32)
                    for r in rows]
            table[key] = np.stack(vals).astype(np.float32)
        for key in ("kind", "base_color_tex_id", "subsurface_color_tex_id"):
            table[key] = np.asarray([r[key] for r in rows], np.int32)
        table["hair_coloring"] = table["hair_coloring"].astype(np.int32)
        return table


def lookup(name_list: List[str], name: str) -> int:
    return name_list.index(name)


_FAT_ORDER = (
    [("kind", 1), ("base_color_tex_id", 1), ("subsurface_color_tex_id", 1)]
    + [(k, w) for k, _, w in ALL_COLUMNS]
)


def fat_layout():
    """{column: (offset, width)} for the packed material matrix."""
    layout = {}
    off = 0
    for key, width in _FAT_ORDER:
        layout[key] = (off, width)
        off += width
    return layout, off


def pack_material_fat(table):
    """SoA table dict of tensors -> [M, K] float32 matrix."""
    cols = []
    for key, _ in _FAT_ORDER:
        col = table[key].to(torch.float32)
        cols.append(col[:, None] if col.ndim == 1 else col)
    return torch.cat(cols, dim=1)


def unpack_material_rows(rows):
    """[N, K] gathered fat rows -> per-lane column dict (ints restored)."""
    layout, _ = fat_layout()
    out = {}
    for key, (off, width) in layout.items():
        col = rows[..., off:off + width]
        if width == 1:
            col = col[..., 0]
        if key in INT_COLUMNS:
            col = col.to(torch.int32)
        out[key] = col
    return out
