"""Scene assembly: host-side builder -> flat scene dict -> device tensors
(port of pbrlab_tpu.scene.scene; reference scene.{h,cc}, light-manager.cc).

`SceneBuilder.build` and `commit` are numpy, as in the JAX package, and
produce the same arrays for the tables the port reads: every triangle
baked to world space, per-face columns in SAH slot order, the flattened
light CDF, the dense_v4 / v5 trace tables, the dense_v5l / v5s tables of
scenes past 18000 slots, the compaction signature boxes, the Morton-packed
tables of the legacy dense v1-v3 backends, the threaded BVH of the
"bvh" backend (`bvh_*`), and the hair tables of `commit_curves`
(sub-segment columns in Morton order, the dense_curve rows and cluster
boxes, the per-sub-segment tangent rows, and the curve BVH `cbvh_*` that
`curves.curve_trace` walks).
`scene_from_numpy` moves a committed scene (from either package) to torch
tensors on a device; `build_fat_tables` packs the per-lane fat rows there,
for a baked scene or an instanced one (`scene.instanced.build_instanced`),
and the quad-texel texture atlas of a textured scene.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from ..geometry.bvh import build_bvh, triangle_bounds
from ..geometry.mesh import CubicBezierCurveMesh, TriangleMesh
from ..ops.build import build_v5, leaf_major, subtree_cut
from ..ops.curves import flatten_curves, subsegment_bounds
from ..ops.dense import pack_triangles
from ..ops.dense_curve import pack_segments
from ..utils import profiling
from .materials import MaterialBuilder, pack_material_fat
from .textures import build_quad_atlas

V5L_MIN_SLOTS = 18000  # commit adds the dense_v5l / v5s tables above this

# per-face columns that commit reorders into slot order
_FACE_COLUMNS = ("tri_v0", "tri_e1", "tri_e2", "face_ng", "face_area",
                 "face_ns", "face_has_ns", "face_uv", "face_has_uv",
                 "face_material", "face_light", "face_instance",
                 "face_geom", "face_emission", "face_light_pdf")


def _apply_transform(verts: np.ndarray, m: Optional[np.ndarray]) -> np.ndarray:
    if m is None:
        return verts
    m = np.asarray(m, np.float32)
    return verts @ m[:3, :3].T + m[:3, 3]


def _apply_normal_transform(normals: np.ndarray, m: Optional[np.ndarray]):
    if m is None:
        return normals
    m = np.asarray(m, np.float32)
    nm = np.linalg.inv(m[:3, :3]).T
    n = normals @ nm.T
    return n / np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-30)


@dataclasses.dataclass
class _Instance:
    meshes: List[TriangleMesh]
    curves: List[CubicBezierCurveMesh]
    light_ids: List[Optional[np.ndarray]]  # per mesh: per-face light param id or None
    transform: Optional[np.ndarray]


class SceneBuilder:
    """Accumulates meshes/materials/lights, then `build()`s numpy arrays
    (reference Scene API, scene.h:14-111). A local scene is the list of
    meshes (and hair curves) passed to `add_instance`, with an optional
    4x4 transform."""

    def __init__(self):
        self.materials = MaterialBuilder()
        self._instances: List[_Instance] = []
        self._shared: List = []  # scene.instanced.SharedGroup
        self._light_params: List[np.ndarray] = []  # emission rgb per light param
        self._textures: List[np.ndarray] = []

    def add_area_light_param(self, emission) -> int:
        self._light_params.append(np.asarray(emission, np.float32))
        return len(self._light_params) - 1

    def add_texture(self, image: np.ndarray, name: str = "") -> int:
        """Register a linear float texture [H, W] or [H, W, 1|3|4]; one
        channel is repeated to RGB. The baked atlas is RGBA when any
        texture has 4 channels (reference Texture::FetchFloatN is channel
        generic, texture.h:28-34), else RGB. `name` is accepted as in the
        JAX package and not kept (nothing reads it)."""
        img = np.ascontiguousarray(np.asarray(image, np.float32))
        if img.ndim == 2:
            img = img[..., None]
        if img.shape[-1] == 1:
            img = np.repeat(img, 3, axis=-1)
        self._textures.append(img)
        return len(self._textures) - 1

    def add_instance(self, meshes: List[TriangleMesh],
                     curves: Optional[List[CubicBezierCurveMesh]] = None,
                     light_ids: Optional[List[Optional[np.ndarray]]] = None,
                     transform: Optional[np.ndarray] = None) -> int:
        if light_ids is None:
            light_ids = [None] * len(meshes)
        self._instances.append(_Instance(meshes, curves or [], light_ids,
                                         transform))
        return len(self._instances) - 1

    def add_shared_instances(self, meshes: List[TriangleMesh], transforms,
                             light_ids=None, curves=None) -> int:
        """K instances of ONE local scene (reference CreateLocalScene + K x
        CreateInstanceFromLocalScene, raytracer_impl.cc:49-84); transforms
        [K, 4, 4] or [K, 3, 4]. Curves of the local scene are baked to
        world space per instance at build time; the triangles share one
        BLAS. Such a scene commits through `scene.instanced.build_instanced`.
        """
        from .instanced import SharedGroup

        t = np.asarray(transforms, np.float32)
        if t.shape[1:] == (3, 4):
            pad = np.broadcast_to(np.asarray([0, 0, 0, 1], np.float32),
                                  (t.shape[0], 1, 4))
            t = np.concatenate([t, pad], axis=1)
        self._shared.append(SharedGroup(
            meshes, t, light_ids or [None] * len(meshes), curves or []))
        return len(self._shared) - 1

    def build(self) -> Dict[str, np.ndarray]:
        tri_v, tri_ns, tri_has_ns, tri_uv, tri_has_uv = [], [], [], [], []
        tri_mat, tri_light, tri_inst, tri_geom = [], [], [], []

        for inst_id, inst in enumerate(self._instances):
            for geom_id, mesh in enumerate(inst.meshes):
                f = mesh.faces
                nf = f.shape[0]
                tri_v.append(_apply_transform(mesh.vertices, inst.transform)[f])
                if mesh.normals is not None and mesh.normal_idx is not None:
                    ns = _apply_normal_transform(mesh.normals, inst.transform)
                    tri_ns.append(ns[np.maximum(mesh.normal_idx, 0)])
                    tri_has_ns.append(np.all(mesh.normal_idx >= 0, axis=-1))
                else:
                    tri_ns.append(np.zeros((nf, 3, 3), np.float32))
                    tri_has_ns.append(np.zeros((nf,), bool))
                if mesh.texcoords is not None and mesh.texcoord_idx is not None:
                    tri_uv.append(mesh.texcoords[np.maximum(mesh.texcoord_idx, 0)])
                    tri_has_uv.append(np.all(mesh.texcoord_idx >= 0, axis=-1))
                else:
                    tri_uv.append(np.zeros((nf, 3, 2), np.float32))
                    tri_has_uv.append(np.zeros((nf,), bool))
                tri_mat.append(mesh.material_ids)
                lids = inst.light_ids[geom_id]
                tri_light.append(np.full((nf,), -1, np.int32) if lids is None
                                 else np.asarray(lids, np.int32))
                tri_inst.append(np.full((nf,), inst_id, np.int32))
                tri_geom.append(np.full((nf,), geom_id, np.int32))

        def cat(parts, shape, dtype):
            return (np.concatenate(parts).astype(dtype) if parts
                    else np.zeros(shape, dtype))

        V = cat(tri_v, (0, 3, 3), np.float32)  # [F,3,3]
        scene: Dict[str, np.ndarray] = {}
        scene["tri_v0"] = V[:, 0]
        scene["tri_e1"] = V[:, 1] - V[:, 0]
        scene["tri_e2"] = V[:, 2] - V[:, 0]
        ng = np.cross(scene["tri_e1"], scene["tri_e2"])
        area2 = np.linalg.norm(ng, axis=-1)
        scene["face_ng"] = (
            ng / np.maximum(area2, 1e-30)[:, None]).astype(np.float32)
        scene["face_area"] = (0.5 * area2).astype(np.float32)
        scene["face_ns"] = cat(tri_ns, (0, 3, 3), np.float32)
        scene["face_has_ns"] = cat(tri_has_ns, (0,), bool)
        scene["face_uv"] = cat(tri_uv, (0, 3, 2), np.float32)
        scene["face_has_uv"] = cat(tri_has_uv, (0,), bool)
        scene["face_material"] = cat(tri_mat, (0,), np.int32)
        face_light = cat(tri_light, (0,), np.int32)
        scene["face_light"] = face_light
        scene["face_instance"] = cat(tri_inst, (0,), np.int32)
        scene["face_geom"] = cat(tri_geom, (0,), np.int32)

        # lights: one CDF over emissive faces, p(face) = p(light) p(prim|light)
        light_emission = (np.stack(self._light_params) if self._light_params
                          else np.zeros((0, 3), np.float32))
        emissive = np.nonzero(face_light >= 0)[0].astype(np.int32)
        F = face_light.shape[0]
        face_emission = np.zeros((F, 3), np.float32)
        face_light_pdf = np.zeros((F,), np.float32)
        if emissive.size:
            em = light_emission[face_light[emissive]]
            face_emission[emissive] = em
            # power = SpectrumNorm(emission) * area (light-manager.cc:118-140)
            power = em.max(axis=-1) * scene["face_area"][emissive]
            p_choose = power / max(power.sum(), 1e-30)
            face_light_pdf[emissive] = p_choose / np.maximum(
                scene["face_area"][emissive], 1e-30)
            cdf = np.cumsum(p_choose).astype(np.float32)
        else:
            cdf = np.zeros((0,), np.float32)
        scene["face_emission"] = face_emission
        scene["face_light_pdf"] = face_light_pdf
        scene["emissive_faces"] = emissive
        scene["light_cdf"] = cdf
        scene["light_emission"] = light_emission

        scene["materials"] = self.materials.build()
        scene["texture_atlas"], scene["texture_sizes"] = texture_atlas(
            self._textures)

        # hair: Bezier segments baked to world space, per-segment material
        # and instance; curve_color only when some mesh carries colors
        # (-1 rows: no file color, use the material's)
        curve_pts, curve_mat, curve_inst, curve_col = [], [], [], []
        any_colors = False
        for inst_id, inst in enumerate(self._instances):
            for cm in inst.curves:
                vt = transform_curve_points(cm.vertices_thickness,
                                            inst.transform)
                cm = CubicBezierCurveMesh(
                    vt, cm.indices, material_id=cm.material_id,
                    name=cm.name, segment_colors=cm.segment_colors)
                curve_pts.append(cm.segment_points())
                curve_mat.append(np.full((cm.num_segments,), cm.material_id,
                                         np.int32))
                curve_inst.append(np.full((cm.num_segments,), inst_id,
                                          np.int32))
                any_colors |= cm.segment_colors is not None
                curve_col.append(
                    cm.segment_colors if cm.segment_colors is not None
                    else np.full((cm.num_segments, 3), -1.0, np.float32))
        scene["curve_pts"] = cat(curve_pts, (0, 4, 4), np.float32)
        scene["curve_material"] = cat(curve_mat, (0,), np.int32)
        scene["curve_instance"] = cat(curve_inst, (0,), np.int32)
        if any_colors:
            scene["curve_color"] = cat(curve_col, (0, 3), np.float32)

        # scene AABB (reference Scene::FetchSceneAABB), curves by their
        # control points padded by the radius
        pts = [V.reshape(-1, 3)] if V.size else []
        if scene["curve_pts"].size:
            cp = scene["curve_pts"].reshape(-1, 4)
            pts += [cp[:, :3] - cp[:, 3:4], cp[:, :3] + cp[:, 3:4]]
        allp = np.concatenate(pts) if pts else np.zeros((1, 3), np.float32)
        scene["aabb_min"] = allp.min(axis=0).astype(np.float32)
        scene["aabb_max"] = allp.max(axis=0).astype(np.float32)
        return scene


def texture_atlas(textures: List[np.ndarray], channels: Optional[int] = None):
    """Textures [H, W, C] -> (atlas [T, Hmax, Wmax, ch] zero-padded, sizes
    [T, 2] (h, w)). ch is `channels`, else the largest C; a 4-channel
    atlas is opaque where a texture has no alpha. No textures: a dummy
    [1, 1, 1, 3] atlas, which `build_fat_tables` recognises."""
    if not textures:
        return np.zeros((1, 1, 1, 3), np.float32), np.ones((1, 2), np.int32)
    hmax = max(t.shape[0] for t in textures)
    wmax = max(t.shape[1] for t in textures)
    ch = channels or max(t.shape[2] for t in textures)
    atlas = np.zeros((len(textures), hmax, wmax, ch), np.float32)
    if ch == 4:
        atlas[..., 3] = 1.0
    sizes = np.zeros((len(textures), 2), np.int32)
    for i, t in enumerate(textures):
        t = t[..., :ch]
        atlas[i, :t.shape[0], :t.shape[1], :t.shape[2]] = t
        sizes[i] = t.shape[:2]
    return atlas, sizes


def _signature_cut(node_aabb: np.ndarray, node_meta: np.ndarray,
                   max_nodes: int = 29) -> np.ndarray:
    """BFS cut of the trace BVH: <= max_nodes subtree AABBs [6, K], the
    boxes of the integrator's one-word compaction signature. Padding
    columns are empty boxes (lo=+inf) that never set a bit."""
    _, aabb = subtree_cut(node_aabb, node_meta, max_nodes)
    out = np.full((6, max_nodes), np.inf, np.float32)
    out[3:6, :] = -np.inf
    out[:, :aabb.shape[1]] = aabb
    return out


def commit(scene: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Build the trace tables (reference Scene::CommitScene, scene.cc:96-104).

    The SAH slot layout is the canonical face order: every per-face column
    is scattered into the padded slot array (S = M * CLUSTER slots, padding
    rows zero), so the trace kernels' slot ids ARE face ids.
    """
    scene = dict(scene)
    packed4, cluster_aabb4, order, node_aabb5, node_meta5 = build_v5(
        scene["tri_v0"], scene["tri_e1"], scene["tri_e2"])
    F = scene["tri_v0"].shape[0]
    S = order.shape[0]
    if F:
        valid = order >= 0
        src = np.maximum(order, 0)
        for key in _FACE_COLUMNS:
            col = scene[key][src]
            scene[key] = np.where(
                valid.reshape((S,) + (1,) * (col.ndim - 1)), col,
                np.zeros_like(col))
        inv = np.full((F,), -1, np.int32)
        inv[order[valid]] = np.nonzero(valid)[0].astype(np.int32)
        if scene["emissive_faces"].size:
            scene["emissive_faces"] = inv[scene["emissive_faces"]]
    scene["dense_tris_v4"] = packed4
    scene["dense_cluster_aabb_v4"] = cluster_aabb4
    scene["v5_node_aabb"] = node_aabb5
    scene["v5_node_meta"] = node_meta5
    scene["sig_aabb"] = _signature_cut(node_aabb5, node_meta5, max_nodes=29)
    if packed4.shape[1] > V5L_MIN_SLOTS:
        # the JAX package's large-scene tables (its TPU kept the [12, S]
        # table in a 1 MB scalar memory up to here): the leaf-major table
        # of dense_v5l and the 64-subtree cut that dense_v5s schedules
        scene["dense_tris_v5l"] = leaf_major(packed4)
        roots, sub_aabb = subtree_cut(node_aabb5, node_meta5, max_nodes=64)
        scene["v5s_roots"] = roots
        scene["v5s_aabb"] = sub_aabb

    # the legacy v1-v3 tables: a Morton pack of the VALID slots only; their
    # sorted prim ids map back to slot ids through dense_order
    if F:
        vslots = np.nonzero(order >= 0)[0].astype(np.int32)
    else:
        vslots = np.zeros((0,), np.int32)
    packed, cluster_aabb, m_order = pack_triangles(
        scene["tri_v0"][vslots], scene["tri_e1"][vslots],
        scene["tri_e2"][vslots])
    scene["dense_tris"] = packed
    scene["dense_cluster_aabb"] = cluster_aabb
    scene["dense_order"] = (vslots[m_order] if m_order.size
                            else np.zeros((0,), np.int32))

    # the threaded BVH of the "bvh" backend over the valid slots, its leaf
    # ids remapped to slot ids
    if F:
        bmin, bmax = triangle_bounds(scene["tri_v0"][vslots],
                                     scene["tri_e1"][vslots],
                                     scene["tri_e2"][vslots])
    else:
        bmin, bmax = triangle_bounds(scene["tri_v0"], scene["tri_e1"],
                                     scene["tri_e2"])
    bvh = build_bvh(bmin, bmax)
    scene["bvh_min"] = bvh.aabb_min
    scene["bvh_max"] = bvh.aabb_max
    scene["bvh_skip"] = bvh.skip
    scene["bvh_prim_offset"] = bvh.prim_offset
    scene["bvh_prim_ids"] = np.where(
        bvh.prim_ids >= 0, vslots[np.maximum(bvh.prim_ids, 0)],
        -1).astype(np.int32) if F else bvh.prim_ids
    return commit_curves(scene)


def commit_curves(scene: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Hair tables: flatten the Bezier segments into linear sub-segments
    and Morton-order them for the dense_curve trace (reference: hair goes
    into the local scenes like triangles, raytracer_impl.cc:154-197).

    Adds the sub-segment columns curve_p0, p1, r0, r1, seg, u0, u1 in the
    sorted order, dense_segs [Cpad, 12], dense_seg_aabb [8, M], and
    curve_sub_fat [C, 4]: unit tangent + source segment id, the one row a
    dense_curve hit fetches; and the curve BVH of `curves.curve_trace`
    over the sorted sub-segments (cbvh_min, max, skip, prim_offset,
    prim_ids)."""
    scene = dict(scene)
    flat = flatten_curves(scene["curve_pts"])
    packed_segs, seg_aabb, seg_order = pack_segments(flat)
    if seg_order.size:
        flat = {key: col[seg_order] for key, col in flat.items()}
    scene.update(flat)
    scene["dense_segs"] = packed_segs
    scene["dense_seg_aabb"] = seg_aabb
    e = flat["curve_p1"] - flat["curve_p0"]
    elen = np.maximum(np.linalg.norm(e, axis=-1, keepdims=True), 1e-20)
    scene["curve_sub_fat"] = np.concatenate(
        [e / elen, flat["curve_seg"][:, None].astype(np.float32)],
        axis=1).astype(np.float32)
    cbvh = build_bvh(*subsegment_bounds(flat))
    scene["cbvh_min"] = cbvh.aabb_min
    scene["cbvh_max"] = cbvh.aabb_max
    scene["cbvh_skip"] = cbvh.skip
    scene["cbvh_prim_offset"] = cbvh.prim_offset
    scene["cbvh_prim_ids"] = cbvh.prim_ids
    return scene


def transform_curve_points(vt: np.ndarray, m: Optional[np.ndarray]):
    """Bake curve control points [P, 4] (xyz + radius) through a 4x4.

    The reference traces curves in local space under the instance
    transform (raytracer_impl.cc:154-197, :49-84); the affine image of the
    control points is the transformed curve. Radii scale by the mean
    singular value of the linear part: exact for uniform scale and
    rotation (a flat curve's radius under non-uniform scale is not defined
    in the reference either)."""
    if m is None:
        return vt
    m = np.asarray(m, np.float64)
    out = np.asarray(vt, np.float32).copy()
    out[:, :3] = (out[:, :3] @ m[:3, :3].T + m[:3, 3]).astype(np.float32)
    out[:, 3] *= float(np.mean(np.linalg.svd(m[:3, :3], compute_uv=False)))
    return out


def scene_from_numpy(scene_np: Dict, device) -> Dict:
    """Committed numpy scene dict (from this package's `commit` or the JAX
    package's) -> dict of torch tensors on `device`, recursing into
    `materials` (the counterpart of pbrlab_tpu's scene_to_device)."""
    out = {}
    for key, val in scene_np.items():
        if isinstance(val, dict):
            out[key] = scene_from_numpy(val, device)
        else:
            # C order: the kernels read the tables as they lie
            out[key] = torch.from_numpy(np.array(val, order="C")).to(device)
    return out


def scene_to_device(scene_np: Dict, device=None) -> Dict:
    """`scene_from_numpy` on `device`; None means CUDA. Without a CUDA
    device a CUDA placement raises: the scene never lands on the CPU
    unless the caller asks for it."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to place the "
                           "scene on the CPU")
    return scene_from_numpy(scene_np, device)


def build_fat_tables(scene: Dict) -> Dict:
    """Pack per-face / material / emissive-face data into fat row matrices
    on the scene's device, so a lane fetches each with one row gather.

    Baked scene:
    face_fat [F, 26]: 0:3 ng | 3:12 corner ns | 12:18 corner uv | 18 has_ns
      | 19 has_uv | 20 mat_id | 21 light_pdf | 22:25 emission | 25 instance
    Instanced scene (`scene.instanced`): the narrow rows
    iface_fat [F, 8]: 0 mat_id | 1 light_pdf | 2:5 emission | 5 instance
      | 6 local slot | 7 zero
    beside the per-local-face geometric rows local_fat [S, 20] (face_fat's
    0:20, in local space).
    light_fat [LF, 16]: v0 e1 e2 ng emission pdf (world space)
    mat_fat [M, K]: see materials.fat_layout().
    texture_quad [T, H, W, 4C]: a textured scene's quad-texel atlas
      (`textures.build_quad_atlas`).
    A `scene.build_fat_tables` span of `utils.profiling`.
    """
    with profiling.span("scene.build_fat_tables"):
        return _build_fat_tables(scene)


def _build_fat_tables(scene: Dict) -> Dict:
    scene = dict(scene)
    f32 = torch.float32
    lf = scene["emissive_faces"].to(torch.int64)
    if "iface_material" in scene:
        n = scene["iface_material"].shape[0]
        scene["iface_fat"] = torch.cat([
            scene["iface_material"].to(f32)[:, None],
            scene["iface_light_pdf"][:, None],
            scene["iface_emission"],
            scene["iface_instance"].to(f32)[:, None],
            scene["iface_local_slot"].to(f32)[:, None],
            torch.zeros((n, 1), dtype=f32, device=lf.device),
        ], dim=1)
        scene["light_fat"] = torch.cat([
            scene["light_v0"], scene["light_e1"], scene["light_e2"],
            scene["light_ng"], scene["iface_emission"][lf],
            scene["iface_light_pdf"][lf][:, None],
        ], dim=1)
    else:
        F = scene["tri_v0"].shape[0]
        scene["face_fat"] = torch.cat([
            scene["face_ng"],
            scene["face_ns"].reshape(F, 9),
            scene["face_uv"].reshape(F, 6),
            scene["face_has_ns"].to(f32)[:, None],
            scene["face_has_uv"].to(f32)[:, None],
            scene["face_material"].to(f32)[:, None],
            scene["face_light_pdf"][:, None],
            scene["face_emission"],
            scene["face_instance"].to(f32)[:, None],
        ], dim=1)
        scene["light_fat"] = torch.cat([
            scene["tri_v0"][lf], scene["tri_e1"][lf], scene["tri_e2"][lf],
            scene["face_ng"][lf], scene["face_emission"][lf],
            scene["face_light_pdf"][lf][:, None],
        ], dim=1)
    scene["mat_fat"] = pack_material_fat(scene["materials"])
    # the dummy atlas of a scene without textures gets no quad atlas, and
    # the integrator then skips the texture fetch
    if tuple(scene["texture_atlas"].shape[:3]) != (1, 1, 1):
        scene["texture_quad"] = build_quad_atlas(scene["texture_atlas"],
                                                 scene["texture_sizes"])
    return scene
