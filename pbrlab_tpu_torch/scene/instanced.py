"""Trace-time instancing: shared local scenes plus per-instance transforms
(numpy; port of pbrlab_tpu.scene.instanced).

The reference builds one BLAS per local scene and instantiates it into
the global scene with a 4x4 transform (raytracer_impl.cc:49-84,
Scene::CreateLocalScene / CreateInstanceFromLocalScene, scene.cc:106-160);
per-instance id tables resolve materials and light params at hit time
(mesh-instance.h:23-36). `build_instanced` commits such a scene:

* one packed triangle table and dense_v5 BLAS node block per local scene,
  in local space, shared by every instance of it;
* a TLAS over the instances' world AABBs whose leaves carry the
  world-to-local affine (`ops.dense_v5i`);
* narrow per-(instance, face) columns (material, light pdf, emission,
  instance, local slot), while the geometric attributes (normals, uvs)
  stay per local face in `local_fat` and are rotated into world space per
  lane at shade time with the instance's normal matrix (`inst_shade`);
* world-space copies of the emissive faces only, for light sampling;
* hair curves of a group baked to world space per instance (an affine
  image of Bezier control points is the transformed curve); curve
  instance ids continue past the TLAS's, so the SSS same-instance test
  spans both geometries.

K instances of an F-face local scene cost K*F narrow rows plus one copy
of the local geometry and BVH, where the baked path copies all of it K
times.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

from ..geometry.mesh import CubicBezierCurveMesh, TriangleMesh
from ..ops.build import build_v5
from ..ops.dense_v5i import STACK, build_tlas
from .scene import (_signature_cut, commit_curves, texture_atlas,
                    transform_curve_points)


@dataclasses.dataclass
class SharedGroup:
    meshes: List[TriangleMesh]
    transforms: np.ndarray  # [K, 4, 4]
    light_ids: List[Optional[np.ndarray]]  # per mesh, shared by instances
    curves: List = dataclasses.field(default_factory=list)


def _affine(m):
    """[4, 4] or [3, 4] -> [4, 4] float64."""
    m = np.asarray(m, np.float64)
    if m.shape == (4, 4):
        return m
    out = np.eye(4)
    out[:3, :4] = m
    return out


def _depth(right: np.ndarray) -> int:
    """Depth of a preorder node block (left child n + 1, right `right`)."""
    d = np.zeros(right.shape[0], np.int32)
    for i in np.flatnonzero(right >= 0):
        d[i + 1] = d[right[i]] = d[i] + 1
    return int(d.max()) if right.shape[0] else 0


def _local_group(g: SharedGroup):
    """One group's local BLAS and per-slot attributes: (packed, node_aabb,
    node_meta, local fat rows [S, 20], material [S], light param [S],
    local triangles [S, 3, 3] (v0 e1 e2))."""
    v_list, ns_list, has_ns, uv_list, has_uv = [], [], [], [], []
    mats, lights = [], []
    for mi, mesh in enumerate(g.meshes):
        f = mesh.faces
        nf = f.shape[0]
        v_list.append(mesh.vertices[f])
        if mesh.normals is not None and mesh.normal_idx is not None:
            ns_list.append(mesh.normals[np.maximum(mesh.normal_idx, 0)])
            has_ns.append(np.all(mesh.normal_idx >= 0, axis=-1))
        else:
            ns_list.append(np.zeros((nf, 3, 3), np.float32))
            has_ns.append(np.zeros((nf,), bool))
        if mesh.texcoords is not None and mesh.texcoord_idx is not None:
            uv_list.append(mesh.texcoords[np.maximum(mesh.texcoord_idx, 0)])
            has_uv.append(np.all(mesh.texcoord_idx >= 0, axis=-1))
        else:
            uv_list.append(np.zeros((nf, 3, 2), np.float32))
            has_uv.append(np.zeros((nf,), bool))
        mats.append(np.asarray(mesh.material_ids, np.int32))
        lid = (g.light_ids[mi] if g.light_ids is not None
               and mi < len(g.light_ids) else None)
        lights.append(np.full((nf,), -1, np.int32) if lid is None
                      else np.asarray(lid, np.int32))
    V = np.concatenate(v_list).astype(np.float32)  # [F, 3, 3] local
    v0 = V[:, 0]
    e1 = V[:, 1] - V[:, 0]
    e2 = V[:, 2] - V[:, 0]
    packed, _, order, naabb, nmeta = build_v5(v0, e1, e2)
    src = np.maximum(order, 0)
    valid = (order >= 0).astype(np.float32)[:, None]
    ng = np.cross(e1, e2)
    ng = ng / np.maximum(np.linalg.norm(ng, axis=-1, keepdims=True), 1e-30)
    fat = np.concatenate([
        ng[src],
        np.concatenate(ns_list).astype(np.float32)[src].reshape(-1, 9),
        np.concatenate(uv_list).astype(np.float32)[src].reshape(-1, 6),
        np.concatenate(has_ns)[src].astype(np.float32)[:, None],
        np.concatenate(has_uv)[src].astype(np.float32)[:, None],
    ], axis=1) * valid
    mat = np.where(order >= 0, np.concatenate(mats)[src], 0).astype(np.int32)
    light = np.where(order >= 0, np.concatenate(lights)[src],
                     -1).astype(np.int32)
    tris = np.stack([v0[src], e1[src], e2[src]], axis=1) * valid[:, :, None]
    return (packed, naabb, nmeta, fat.astype(np.float32), mat, light, tris)


def build_instanced(builder) -> Dict[str, np.ndarray]:
    """SceneBuilder (with shared groups and/or plain instances) ->
    committed instanced scene dict. Plain instances become K = 1 groups."""
    groups: List[SharedGroup] = list(builder._shared)
    for inst in builder._instances:
        t = np.eye(4) if inst.transform is None else _affine(inst.transform)
        groups.append(SharedGroup(inst.meshes, t[None], inst.light_ids,
                                  inst.curves))
    if not groups:
        raise ValueError("no geometry")
    tri_gis = [gi for gi, g in enumerate(groups)
               if sum(m.num_faces for m in g.meshes) > 0]
    if not tri_gis:
        raise ValueError("curves-only scene: use the baked path "
                         "(commit(builder.build())); there is no triangle "
                         "BLAS to share")

    # ---- per-group local BLAS + local attributes ----
    local = {gi: _local_group(groups[gi]) for gi in tri_gis}
    slot_base, s_running = {}, 0
    for gi in tri_gis:
        slot_base[gi] = s_running
        s_running += local[gi][0].shape[1]

    # ---- instances ----
    inv_rows, shade_rows, inst_group, fid_delta = [], [], [], []
    inst_bmin, inst_bmax = [], []
    iface_mat, iface_light, iface_inst, iface_slot = [], [], [], []
    curve_jobs = []  # (curves, 4x4, instance id): baked after the TLAS
    f_running = 0
    for gi in tri_gis:
        g = groups[gi]
        naabb, mat, light = local[gi][1], local[gi][4], local[gi][5]
        s = mat.shape[0]
        lo, hi = naabb[0:3, 0], naabb[3:6, 0]
        corners = np.stack(np.meshgrid(*zip(lo, hi),
                                       indexing="ij")).reshape(3, 8).T
        for m4 in np.asarray(g.transforms, np.float64).reshape(-1, 4, 4):
            k = len(inst_group)
            a = m4[:3, :4]
            inv_rows.append(np.linalg.inv(m4)[:3, :4].reshape(12))
            shade_rows.append(np.concatenate([
                a.reshape(12), np.linalg.inv(m4[:3, :3]).T.reshape(9),
                np.zeros(3)]))
            inst_group.append(gi)
            fid_delta.append(f_running - slot_base[gi])
            wc = corners @ a[:, :3].T + a[:, 3]
            inst_bmin.append(wc.min(axis=0))
            inst_bmax.append(wc.max(axis=0))
            iface_mat.append(mat)
            iface_light.append(light)
            iface_inst.append(np.full((s,), k, np.int32))
            iface_slot.append(np.arange(slot_base[gi], slot_base[gi] + s,
                                        dtype=np.int32))
            if g.curves:
                curve_jobs.append((g.curves, m4, k))
            f_running += s
    # curve-only groups: instance ids continue past the TLAS ids (they
    # feed only the SSS same-instance test, never an id table)
    k_next = len(inst_group)
    for gi, g in enumerate(groups):
        if gi in slot_base or not g.curves:
            continue
        for m4 in np.asarray(g.transforms, np.float64).reshape(-1, 4, 4):
            curve_jobs.append((g.curves, m4, k_next))
            k_next += 1
    inst_shade = np.stack(shade_rows).astype(np.float32)  # [K, 24]
    iface_mat = np.concatenate(iface_mat)
    iface_light = np.concatenate(iface_light)
    iface_inst = np.concatenate(iface_inst)
    iface_slot = np.concatenate(iface_slot)

    # ---- TLAS + unified node array ----
    tlas_aabb, tlas_right, tlas_inst = build_tlas(
        np.stack(inst_bmin).astype(np.float32),
        np.stack(inst_bmax).astype(np.float32))
    blas_base, off = {}, tlas_right.shape[0]
    for gi in tri_gis:
        blas_base[gi] = off
        off += local[gi][2].shape[1]
    node_aabb = np.concatenate(
        [tlas_aabb] + [local[gi][1] for gi in tri_gis],
        axis=1).astype(np.float32)
    metas = [np.stack([np.where(tlas_right >= 0, tlas_right, -1),
                       np.where(tlas_inst >= 0, -(tlas_inst + 1), 0)])]
    for gi in tri_gis:
        nm = local[gi][2]
        metas.append(np.stack([
            np.where(nm[0] >= 0, nm[0] + blas_base[gi], -1),
            np.where(nm[0] < 0, nm[1] + slot_base[gi], 0)]))
    node_meta = np.concatenate(metas, axis=1).astype(np.int32)
    # the kernel reads a leaf's rows as float4 from its slot base
    bases = node_meta[1][(node_meta[0] < 0) & (node_meta[1] >= 0)]
    if (bases % 32).any():
        raise ValueError("BLAS leaf slot bases must be multiples of 32; "
                         f"got {np.unique(bases % 32).tolist()} mod 32")
    # stack bound: TLAS depth + the deepest BLAS
    td = _depth(tlas_right)
    bd = max(_depth(local[gi][2][0]) for gi in tri_gis)
    if td + bd + 4 >= STACK:
        raise RuntimeError(f"stack overflow: TLAS depth {td} + BLAS {bd}")

    scene: Dict[str, np.ndarray] = {
        "i5_tris": np.concatenate([local[gi][0] for gi in tri_gis], axis=1),
        "i5_node_aabb": node_aabb,
        "i5_node_meta": node_meta,
        "i5_inst_inv": np.stack(inv_rows).T.astype(np.float32),  # [12, K]
        "i5_inst_meta": np.stack([
            np.asarray([blas_base[gi] for gi in inst_group], np.int32),
            np.asarray(fid_delta, np.int32)]),
        "inst_shade": inst_shade,
        "local_fat": np.concatenate(
            [local[gi][3] for gi in tri_gis]).astype(np.float32),
        "iface_material": iface_mat,
        "iface_instance": iface_inst,
        "iface_local_slot": iface_slot,
    }

    # ---- lights: world-space emissive faces only ----
    light_emission = (np.stack(builder._light_params)
                      if builder._light_params
                      else np.zeros((0, 3), np.float32))
    n_faces = iface_mat.shape[0]
    emissive = np.nonzero(iface_light >= 0)[0].astype(np.int32)
    iface_emission = np.zeros((n_faces, 3), np.float32)
    iface_pdf = np.zeros((n_faces,), np.float32)
    if emissive.size:
        em = light_emission[iface_light[emissive]]
        iface_emission[emissive] = em
        ltris = np.concatenate(
            [local[gi][6] for gi in tri_gis])[iface_slot[emissive]]
        a_rows = inst_shade[iface_inst[emissive], :12].reshape(-1, 3, 4)
        v0w = np.einsum("lij,lj->li", a_rows[:, :, :3],
                        ltris[:, 0]) + a_rows[:, :, 3]
        e1w = np.einsum("lij,lj->li", a_rows[:, :, :3], ltris[:, 1])
        e2w = np.einsum("lij,lj->li", a_rows[:, :, :3], ltris[:, 2])
        ngw = np.cross(e1w, e2w)
        area2 = np.linalg.norm(ngw, axis=-1)
        ngw = ngw / np.maximum(area2, 1e-30)[:, None]
        area = 0.5 * area2
        power = em.max(axis=-1) * area
        p_choose = power / max(power.sum(), 1e-30)
        iface_pdf[emissive] = p_choose / np.maximum(area, 1e-30)
        scene["light_cdf"] = np.cumsum(p_choose).astype(np.float32)
        scene["light_v0"] = v0w.astype(np.float32)
        scene["light_e1"] = e1w.astype(np.float32)
        scene["light_e2"] = e2w.astype(np.float32)
        scene["light_ng"] = ngw.astype(np.float32)
    else:
        scene["light_cdf"] = np.zeros((0,), np.float32)
        for k in ("light_v0", "light_e1", "light_e2", "light_ng"):
            scene[k] = np.zeros((0, 3), np.float32)
    scene["iface_emission"] = iface_emission
    scene["iface_light_pdf"] = iface_pdf
    scene["emissive_faces"] = emissive
    scene["light_emission"] = light_emission

    # ---- shared with the baked path ----
    scene["materials"] = builder.materials.build()
    # the JAX package's instanced atlas is RGB: alpha channels are dropped
    scene["texture_atlas"], scene["texture_sizes"] = texture_atlas(
        builder._textures, channels=3)

    # ---- curves: baked to world space per instance ----
    curve_pts, curve_mat, curve_inst, curve_col = [], [], [], []
    any_colors = False
    for curves, m4, k in curve_jobs:
        for cm in curves:
            baked = CubicBezierCurveMesh(
                transform_curve_points(cm.vertices_thickness, m4),
                cm.indices, material_id=cm.material_id, name=cm.name,
                segment_colors=cm.segment_colors)
            curve_pts.append(baked.segment_points())
            curve_mat.append(np.full((baked.num_segments,), cm.material_id,
                                     np.int32))
            curve_inst.append(np.full((baked.num_segments,), k, np.int32))
            any_colors |= cm.segment_colors is not None
            curve_col.append(
                cm.segment_colors if cm.segment_colors is not None
                else np.full((baked.num_segments, 3), -1.0, np.float32))
    scene["curve_pts"] = (np.concatenate(curve_pts).astype(np.float32)
                          if curve_pts else np.zeros((0, 4, 4), np.float32))
    scene["curve_material"] = (np.concatenate(curve_mat) if curve_mat
                               else np.zeros((0,), np.int32))
    scene["curve_instance"] = (np.concatenate(curve_inst) if curve_inst
                               else np.zeros((0,), np.int32))
    if any_colors:  # per-strand hair base color (scene.py)
        scene["curve_color"] = np.concatenate(curve_col).astype(np.float32)
    scene["aabb_min"] = node_aabb[0:3, 0].copy()
    scene["aabb_max"] = node_aabb[3:6, 0].copy()
    if scene["curve_pts"].size:
        cp = scene["curve_pts"].reshape(-1, 4)
        scene["aabb_min"] = np.minimum(
            scene["aabb_min"], (cp[:, :3] - cp[:, 3:4]).min(axis=0))
        scene["aabb_max"] = np.maximum(
            scene["aabb_max"], (cp[:, :3] + cp[:, 3:4]).max(axis=0))
    scene["sig_aabb"] = _signature_cut(node_aabb, node_meta, max_nodes=29)
    return commit_curves(scene)
