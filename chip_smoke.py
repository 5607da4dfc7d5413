"""Chip smoke test of the PyTorch/CUDA port (pbrlab_tpu_torch) on one GPU.

    python3 chip_smoke.py

Builds the port's CUDA library (every csrc/*.cu) and drives its seven
render paths on one card (and, in phase 8, the cornellbox and the hair
scene again through the "bvh" backend):

* cornellbox: `build_demo_scene(subdiv=3)`, dense_v4 (bench.py's headline
  scene), 512x512, 8 spp;
* mid: `build_demo_scene(subdiv=4)` (461 clusters), dense_v5 and its dual
  kernel, 256x256, 8 spp;
* large: `build_demo_scene(subdiv=5, irregular=True)` (40972 triangles,
  bench.py's large line), the dense_v5s scheduler over dense_v5l,
  512x512, 16 spp;
* xl: `build_demo_scene(subdiv=6, irregular=True)` (163852 triangles in
  7354 leaves, 64 v5s roots; bench.py's XL line), dense_v5s over
  dense_v5l, 512x512, 8 spp, as bench.py;
* hair: `build_demo_scene(subdiv=3, with_hair=True)`, the cornellbox plus
  the demo tuft (96 strands, 5376 sub-segments in 42 clusters): dense_v4
  for the triangles, dense_curve (closest and any-hit) for the hair,
  512x512, 8 spp;
* instanced: `instanced_builder()` through `build_instanced`, 256 shared
  icospheres (128 of subdiv 4 with the SSS material, 128 of subdiv 3
  glossy; 819k world triangles from 6.4k local faces) on a textured
  floor, dense_v5i (closest and any-hit), 256x256, 8 spp;
* file: the cornellbox of `build_demo_scene(subdiv=3)` written as OBJ +
  MTL + scene JSON (`write_cornellbox`; the floor textured by a PNG that
  `io.image.encode_png` writes and `io.image.decode_png` reads back) into
  a temporary directory and loaded with `io.scene_json.load_scene_json`
  (the texture's atlas checked), rendered twice through the
  legacy backends the render's `tri_backend` forces: dense_v3 ("dense3")
  at 512x512, 8 spp, and dense_v2 ("dense") at 256x256, 8 spp;

all at max_steps=12, k_volume=3. Phase 3 checks each kernel against its
plain torch version at its path's shapes and times both (dense_curve also
on a dense tuft of 8192 strands, 3584 clusters, its twin on the first
N_PLAIN_TUFT rays; the legacy v1 kernel, which no render path reaches,
at the file path's shapes; all ten kernels walk per ray and are
bit-equal to their twins, whose counts of each lane's tests print beside
the need, and each dual's closest answer is bit-equal to its single
kernel's; dense_v4 and dense_v3 also timed as whole wrapper calls);
phase 4 checks small renders on the card against the same renders on the
CPU (the instanced one on a 16-instance cut of its scene,
PARITY_INSTANCED; the textured file scene through both legacy backends);
phase 5
renders each path (`render_lanes_wavefront`: its loop as CUDA graphs,
captured and replayed in the call) with every launch counter set to 0
just before and read just after; phase 6 drives the user's entry points on the
cornellbox (`entry_phase`): the CLI's `demo` at 512x512x8 with the auto
k_volume (PNG checked), `render_scan` at 256x256x4, k_volume 3 (its
compiled program's phases as CUDA graphs, their captures and nodes
printed), with its launches counted (dense_v4 dual and any-hit, dense_v5
dual and closest) and held against `render`, `render_scan` card vs CPU at
32x32x2, and a `ProgressiveRenderer` at 512x512 behind a
`PreviewServer` (each pass against `render_sample`, the average of 3
against `render_scan`, an HTTP edit that captures nothing new, the
served PNG, a checkpoint round trip); phase 7 the training and parallel
paths (`training_phase`: the graphed gradient pass at 1024x1024x1, its
walls, peak memory and launches against the `torch.utils.checkpoint`
tape's, at most 1.5x its memory, the same image and loss, gradients in
the band; card vs CPU gradients; the emission FD; `render_sharded`; the
train step, run twice; the C12 reproducibility passes, bits compared; two
gloo ranks; then `hair_grad_phase`: the hair scene's graphed gradient
pass at 64x64x1, the hair material's columns among its leaves, against
the CPU's); phase
8 the threaded-BVH backend (`bvh_phase`): the `bvh_trace` and
`curve_bvh_trace` kernels (`csrc/bvh_walk.cu`, the JAX package's CPU
walks) against their twins on phase 3's cornellbox and hair rays, card
vs CPU renders of both scenes at 32x32x2, and both rendered at
BVH_SIZE^2 x BVH_SPP with tri_backend="bvh", their launches counted;
phase 9 the render loop's CUDA graphs (`graph_phase`): every phase-5 path
and the cornellbox at "bvh" rendered at GRAPH_SIZE^2 x GRAPH_SPP through
the graphs, every phase under `torch.cuda.set_sync_debug_mode("error")`,
and through the private eager loop, the images bit-equal and the
launches equal, with both walls, the capture cost, the nodes per graph
and the peak memory printed; then the scan path's programs
(`scan_graph_phase`): `render_scan` at GRAPH_SIZE^2 x GRAPH_SPP on every
phase-5 path, three progressive passes with an HTTP edit before the
third, and the gradient passes of the cornellbox and the hair scene at
SCAN_GRAD_SIZE^2 x 1, graphed (under sync
debug mode "error") and through the same phases op by op: bit-equal
images, passes and loss, equal launches, gradients in the band, no
capture made by the edit.
Exits non-zero, printing no result, on any failure or without a
CUDA card. The last lines are the kernels' JSON record, the card's name
and power limit, and {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

SEED = 7
SETTINGS = dict(max_steps=12, k_volume=3)
PATHS = {  # name: (build_demo_scene kwargs, width = height, spp)
    "cornellbox": (dict(subdiv=3), 512, 8),
    "mid": (dict(subdiv=4), 256, 8),
    "large": (dict(subdiv=5, irregular=True), 512, 16),
    "hair": (dict(subdiv=3, with_hair=True), 512, 8),
    "instanced": (None, 256, 8),  # instanced_builder() + build_instanced
    # last: phase 3 draws every path's rays from one generator in this
    # order, so the earlier paths keep theirs
    "xl": (dict(subdiv=6, irregular=True), 512, 8),  # bench.py:89-98
}
# the file path: the scene write_cornellbox() writes, rendered through each
# legacy backend: tri_backend -> (width = height, spp)
FILE_RENDERS = {"dense3": (512, 8), "dense": (256, 8)}
FILE_FACES = 2572  # build_demo_scene(subdiv=3): 5 walls, light, 2 bodies
FILE_TEXTURE = 16  # the file path's floor: a 16x16 checker PNG (texels)
# the instanced render parity's cut of the scene: the CPU's plain walk of
# the full one takes seconds a trace
PARITY_INSTANCED = dict(side=4, subdivs=(2, 1))
DENSE_TUFT = 8192  # strands of the dense tuft that times dense_curve
N_PLAIN_TUFT = 4096  # rays the twin checks on it (its time bound)
CLI_SIZE = 512  # phase 6's CLI demo: the CLI's default width
SCAN_SIZE, SCAN_SPP = 256, 4  # phase 6's render_scan: 65536 lanes
PROGRESSIVE_SIZE = 512  # phase 6's progressive renderer and preview server
# phase 7: the gradient pass at BASELINE config 5's resolution, one
# sample; its card-vs-CPU and finite-difference checks; the sharded render,
# the train step and the two-rank render
GRAD_SIZE = 1024
GRAD_PARITY = dict(size=32, max_steps=6)  # card vs CPU gradients
GRAD_BAND = 1e-4  # of the largest CPU entry (tests/test_torch_gradients.py)
FD_SIZE, FD_EPS = 64, 1e-2  # emission central differences, rtol 1e-2
SHARD_SIZE, SHARD_SPP = 256, 2  # render_sharded on 2 shards of the card
TRAIN_SIZE, TRAIN_STEPS = 64, 4  # train step on the textured quad scene
DIST_SIZE, DIST_SPP = 128, 2  # two ranks on the card, gloo
BVH_PATHS = ("cornellbox", "hair")  # phase 8: these at tri_backend="bvh"
BVH_SIZE, BVH_SPP = 256, 8  # phase 8's renders
GRAPH_SIZE, GRAPH_SPP = 128, 2  # phase 9: graphed and eager renders
SCAN_GRAD_SIZE = 64  # phase 9: graphed and eager gradient passes
# phase 7: the hair scene's gradient pass, card vs CPU, and the columns of
# the hair material it differentiates besides the train step's leaves
HAIR_GRAD_SIZE = 64
HAIR_GRAD_KEYS = ("melanin", "hair_roughness", "azimuthal_roughness")
REPRO_SIZE = 64  # phase 7: the C12 reproducibility passes
N_DUAL = 65536  # default n_lanes: every full step traces this many lanes
N_SINGLE = 24576  # default volume window (3/8 of the lanes): substeps 2-3
RTOL = 1e-5  # kernel vs plain: same float ops in the same order, no FMA
# H100 SXM peaks (NVIDIA data sheet): FP32 outside the tensor cores, HBM3
PEAK_FLOPS = 67e12
PEAK_BYTES = 3.35e12
OPS_TRI = 40  # f32 operations of one ray-triangle test (csrc/*.cu)
OPS_RIBBON = 56  # of one ray-ribbon test up to the hit (dense_curve.cu)
OPS_BOX = 27  # f32 operations of one ray-box slab test
OPS_XFORM = 42  # of one ray's transform into an instance (dense_v5i.cu)


def instanced_builder(side=16, subdivs=(4, 3)):
    """The instanced path's scene, built through the port's public API: a
    side x side textured floor (a 64 x 64 linear checker through its
    texcoords) in the xy plane facing +z, one 4 x 2 area light quad past
    its top edge, 3 above it, facing it (the auto-framed camera looks down
    -z, so the light does not hide the floor), and a side x side grid of
    shared icosphere instances on it, interleaved: group A
    icosphere(subdivs[0]) with the demo's random-walk SSS material, group
    B icosphere(subdivs[1]) with its glossy GGX one, each instance rotated
    about z and scaled 0.8-1.0 (tests/test_instancing.py:_transforms)."""
    from pbrlab_tpu_torch.geometry.mesh import TriangleMesh
    from pbrlab_tpu_torch.scene.demo import icosphere, quad_mesh
    from pbrlab_tpu_torch.scene.scene import SceneBuilder

    b = SceneBuilder()
    m = b.materials
    cells = np.indices((8, 8)).sum(0) % 2 * 0.6 + 0.2  # 8 x 8 cells
    checker = np.repeat(np.repeat(cells, 8, 0), 8, 1)[..., None] * np.ones(3)
    floor_m = m.add_principled("floor", base_color=(0.7, 0.7, 0.7),
                               specular=0.0, roughness=0.5,
                               base_color_tex_id=b.add_texture(
                                   checker.astype(np.float32), "checker"))
    light_m = m.add_principled("light", base_color=(0.0, 0.0, 0.0),
                               specular=0.0)
    sss = m.add_principled("sss", base_color=(1.0, 0.8, 0.8), subsurface=1.0,
                           subsurface_radius=(1.0, 0.2, 0.1),
                           subsurface_color=(1.0, 0.8, 0.8), specular=0.0,
                           roughness=0.2)  # scene/demo.py:124-128
    glossy = m.add_principled("glossy", base_color=(0.8, 0.5, 0.2),
                              specular=1.0, roughness=0.01)  # :122-123
    s = side / 2
    quad = quad_mesh([-s, s, 0], [-s, -s, 0], [s, -s, 0], [s, s, 0], floor_m,
                     "floor")
    b.add_instance([TriangleMesh(
        quad.vertices, quad.faces, material_ids=quad.material_ids,
        texcoords=np.asarray([[0, 0], [0, 1], [1, 1], [1, 0]], np.float32),
        texcoord_idx=quad.faces, name="floor")])
    lid = b.add_area_light_param((50.0, 50.0, 50.0))
    b.add_instance([quad_mesh([-2, s + 2.5, 3], [2, s + 2.5, 3],
                              [2, s + 0.5, 3], [-2, s + 0.5, 3], light_m,
                              "light")],
                   light_ids=[np.full((2,), lid, np.int32)])
    groups = ([], [])
    for i in range(side * side):
        gx, gy = i % side, i // side
        c, sn = np.cos(0.7 * i), np.sin(0.7 * i)
        t = np.eye(4)
        t[:3, :3] = (np.asarray([[c, -sn, 0], [sn, c, 0], [0, 0, 1]])
                     * (0.8 + 0.1 * (i % 3)))
        t[:3, 3] = (gx - s + 0.5, gy - s + 0.5, 0.5)
        groups[(gx + gy) % 2].append(t)
    for (mat, name), sub, ts in zip(((sss, "sss"), (glossy, "glossy")),
                                    subdivs, groups):
        b.add_shared_instances([icosphere(sub, 0.45, material_id=mat,
                                          name=name)], np.stack(ts))
    return b


def checker_texture(n=FILE_TEXTURE):
    """[n, n, 3] uint8: a checker of 4x4-texel squares in two greys, the
    file path's floor texture."""
    y, x = np.mgrid[0:n, 0:n]
    on = ((x // 4 + y // 4) % 2).astype(bool)[..., None]
    return np.where(on, [200, 180, 150], [70, 90, 120]).astype(np.uint8)


def write_cornellbox(dirpath, subdiv=3):
    """The cornellbox of `build_demo_scene(subdiv)` as the files a user
    renders: cornellbox.obj (one object per mesh: floor, ceiling, back,
    left, right, light, monkey, lucy; the bodies with their vertex
    normals, the floor with texcoords; usemtl names each mesh's
    material), cornellbox.mtl (every demo material with all 17
    principled keys, and Floor_Checker: the floor's material with
    `map_base_color floor.png`), floor.png (`checker_texture()` through
    `io.image.encode_png`), and cornellbox.json: the OBJ, the two bodies'
    materials again as JSON materials of the same names, the ceiling's
    area light, and one local scene and instance per mesh, the bodies
    with their JSON material, the light quad with the light. Every demo
    material parameter has a key in both formats. Returns the JSON's
    path."""
    from pbrlab_tpu_torch.io.image import encode_png
    from pbrlab_tpu_torch.scene.demo import build_demo_scene
    from pbrlab_tpu_torch.scene.materials import PRINCIPLED_COLUMNS

    _, b = build_demo_scene(subdiv=subdiv)
    names, rows = b.materials.names, b.materials.rows

    def fmt(x):  # repr round-trips every float32 and float64 exactly
        return " ".join(repr(float(v)) for v in np.atleast_1d(x))

    mtl = []
    for name, row in zip(names, rows):
        mtl.append(f"newmtl {name}")
        mtl += [f"{k} {fmt(row[k])}" for k, _, _ in PRINCIPLED_COLUMNS]
    floor_mat = None
    obj = ["mtllib cornellbox.mtl"]
    local_scenes, instances, materials, lights = [], [], [], []
    nv = nn = nt = 0
    for inst in b._instances:
        (mesh,) = inst.meshes
        (mat,) = np.unique(mesh.material_ids)
        obj += [f"o {mesh.name}"] + [f"v {fmt(p)}" for p in mesh.vertices]
        if mesh.normals is not None:
            obj += [f"vn {fmt(n)}" for n in mesh.normals]
        if mesh.name == "floor":  # texcoords over the floor's x and z
            xz = mesh.vertices[:, [0, 2]]
            uv = (xz - xz.min(0)) / (xz.max(0) - xz.min(0))
            obj += [f"vt {fmt(t)}" for t in uv]
            obj.append("usemtl Floor_Checker")
            floor_mat = mat
            obj += ["f " + " ".join(f"{nv + a + 1}/{nt + a + 1}"
                                    for a in face) for face in mesh.faces]
            nv += len(mesh.vertices)
            nt += len(uv)
            local_scenes.append({"name": mesh.name, "meshes": [mesh.name]})
            instances.append({"local_scene": mesh.name})
            continue
        obj.append(f"usemtl {names[mat]}")
        for k, face in enumerate(mesh.faces):
            if mesh.normals is None:
                obj.append("f " + " ".join(str(nv + a + 1) for a in face))
            else:
                obj.append("f " + " ".join(
                    f"{nv + a + 1}//{nn + c + 1}"
                    for a, c in zip(face, mesh.normal_idx[k])))
        nv += len(mesh.vertices)
        nn += 0 if mesh.normals is None else len(mesh.normals)
        local_scenes.append({"name": mesh.name, "meshes": [mesh.name]})
        instance = {"local_scene": mesh.name}
        if mesh.normals is not None:  # a body: its material from the JSON
            materials.append({"type": "cycles_principled_bsdf",
                              "name": names[mat],
                              **{k: rows[mat][k]
                                 for k, _, _ in PRINCIPLED_COLUMNS}})
            instance["materials"] = [names[mat]]
        if inst.light_ids[0] is not None:
            (lid,) = np.unique(inst.light_ids[0])
            lights.append({"type": "area", "name": f"{mesh.name}_area",
                           "emission": b._light_params[lid].tolist()})
            instance["lights"] = [f"{mesh.name}_area"]
        instances.append(instance)
    mtl.append("newmtl Floor_Checker")
    mtl += [f"{k} {fmt(rows[floor_mat][k])}" for k, _, _ in PRINCIPLED_COLUMNS]
    mtl.append("map_base_color floor.png")
    with open(os.path.join(dirpath, "floor.png"), "wb") as f:
        f.write(encode_png(checker_texture()))
    for name, text in (("cornellbox.obj", obj), ("cornellbox.mtl", mtl)):
        with open(os.path.join(dirpath, name), "w") as f:
            f.write("\n".join(text) + "\n")
    path = os.path.join(dirpath, "cornellbox.json")
    with open(path, "w") as f:
        json.dump({"wavefront_objs": [{"filepath": "cornellbox.obj"}],
                   "materials": materials, "lights": lights,
                   "local_scenes": local_scenes, "instances": instances,
                   "render": {"width": 512, "height": 512, "max_pass": 8}},
                  f, indent=1)
    return path


def load_file_scene(subdiv=3):
    """`write_cornellbox` into a temporary directory under build/, then
    the port's `load_scene_json` (which commits). Checks the faces, the
    one emissive light group and the floor's PNG texture: the atlas holds
    the checker, decoded and taken to linear, and the quad atlas is built
    from it (a texture that failed to load is only a warning in the
    loader: here it fails); returns the committed numpy scene."""
    from pbrlab_tpu_torch.io.image import srgb_to_linear
    from pbrlab_tpu_torch.io.scene_json import load_scene_json
    from pbrlab_tpu_torch.scene.textures import build_quad_atlas

    build = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "build")
    os.makedirs(build, exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="cornellbox_", dir=build) as d:
        scene, render_cfg = load_scene_json(write_cornellbox(d, subdiv))
    faces = int((scene["face_area"] > 0).sum())
    groups = np.unique(scene["face_light"][scene["emissive_faces"]])
    if subdiv == 3 and faces != FILE_FACES or len(groups) != 1 \
            or render_cfg["width"] != 512:
        raise AssertionError(f"file scene: {faces} faces, light groups "
                             f"{groups}, render section {render_cfg}")
    atlas, sizes = scene["texture_atlas"], scene["texture_sizes"]
    want = srgb_to_linear(checker_texture().astype(np.float32) / 255.0)
    if atlas.shape != (1, FILE_TEXTURE, FILE_TEXTURE, 3) \
            or not np.array_equal(atlas[0], want) \
            or sizes.tolist() != [[FILE_TEXTURE, FILE_TEXTURE]] \
            or not (scene["materials"]["base_color_tex_id"] == 0).any():
        raise AssertionError(f"file scene: the floor's PNG texture did not "
                             f"load (atlas {atlas.shape}, sizes "
                             f"{sizes.tolist()})")
    quad = build_quad_atlas(torch.from_numpy(atlas), torch.from_numpy(sizes))
    print(f"file scene texture: floor.png {FILE_TEXTURE}x{FILE_TEXTURE} "
          f"decoded by io.image.decode_png into texture_atlas "
          f"{tuple(atlas.shape)}, texture_quad {tuple(quad.shape)}")
    return scene


def instanced_summary(s):
    """The counts of an instanced commit: faces, slots, nodes, instances
    and the bytes of its per-instance-face and two-level tables."""
    nt = int(s["i5_inst_meta"][0].min())
    valid = (s["local_fat"][:, 0:3] != 0).any(1)  # per local slot
    by = {p: sum(v.nbytes for k, v in s.items() if k.startswith(p))
          for p in ("i5_", "iface_")}
    return (f"{int(valid[s['iface_local_slot']].sum())} world faces in "
            f"{s['iface_material'].shape[0]} instance-face slots, "
            f"{int(valid.sum())} local faces in {valid.shape[0]} local slots, "
            f"{s['i5_inst_inv'].shape[1]} instances, {nt} TLAS nodes, "
            f"{s['i5_node_meta'].shape[1] - nt} BLAS nodes, i5_* tables "
            f"{by['i5_']} B, iface_* tables {by['iface_']} B")


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps=20, warmup=2):
    """Median CUDA-event time of fn() in ms, after warm-up calls."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def bound(n_bytes, ops):
    """(bound ms, "bytes" or "operations"): the larger of the bytes over
    the memory rate and the operations over the FP32 rate."""
    t_bytes, t_ops = n_bytes / PEAK_BYTES, ops / PEAK_FLOPS
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def nbytes(*tensors):
    return sum(x.numel() * x.element_size() for x in tensors)


def check_hits(name, got, ref, occ=None, ref_occ=None):
    """Kernel vs plain version: equal hit masks (and occlusion), t/u/v
    within RTOL, prim equal where t is unique. Returns max |t| error."""
    hit = ref["prim"] >= 0
    if not torch.equal(got["prim"] >= 0, hit):
        raise AssertionError(f"{name}: hit masks differ")
    if occ is not None and not torch.equal(occ, ref_occ):
        raise AssertionError(f"{name}: occluded differs")
    for k in ("t", "u", "v"):
        torch.testing.assert_close(got[k][hit], ref[k][hit], rtol=RTOL,
                                   atol=1e-6, msg=f"{name}: {k} differs")
    same_t = got["t"] == ref["t"]
    bad = hit & same_t & (got["prim"] != ref["prim"])
    if bad.float().mean() > 1e-3:
        raise AssertionError(f"{name}: prim differs on {int(bad.sum())} lanes")
    return float((got["t"][hit] - ref["t"][hit]).abs().max()) if hit.any() \
        else 0.0


# (origin box lo, hi), (light quad lo, hi): the cornellbox's interior and
# its ceiling light; the instanced scene's slab over the floor and its light
CORNELL_FRAME = (([-0.95, 0.05, -0.95], [0.95, 1.95, 0.95]),
                 ([-0.4, 1.98, -0.4], [0.4, 1.98, 0.4]))
INSTANCED_FRAME = (([-8.0, -8.0, 0.05], [8.0, 8.0, 1.2]),
                   ([-2.0, 8.5, 3.0], [2.0, 10.5, 3.0]))


def path_rays(scene, dev, rng, frame=CORNELL_FRAME):
    """A path's trace inputs: N_DUAL bounce rays from points of the origin
    box with shadow queries towards a point of the light quad (30% ask
    none, 5% of the lanes dead), and N_SINGLE lanes of half camera rays
    (256^2 image), half bounce rays; `frame` holds the two boxes (a light
    point is uniform on the axes where its box is not flat). Returns (dual
    rays: org, dir, min_t, max_t, sdir, smin_t, smax_t; single rays: org,
    dir, min_t, max_t)."""
    from pbrlab_tpu_torch.core.math import EPS, INF
    from pbrlab_tpu_torch.render.camera import generate_rays

    def t32(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=dev)

    lane = torch.arange(N_DUAL, dtype=torch.int32, device=dev)
    cam_org, cam_dir = generate_rays(scene, 256, 256, t32(rng.random(N_DUAL)),
                                     t32(rng.random(N_DUAL)), lane)
    (lo, hi), (l_lo, l_hi) = frame
    b_org = rng.uniform(lo, hi, size=(N_DUAL, 3))
    b_dir = rng.normal(size=(N_DUAL, 3))
    b_dir /= np.linalg.norm(b_dir, axis=1, keepdims=True)
    lpt = np.tile(np.asarray(l_lo, np.float64), (N_DUAL, 1))
    for a in range(3):
        if l_lo[a] != l_hi[a]:
            lpt[:, a] = rng.uniform(l_lo[a], l_hi[a], N_DUAL)
    to_l = lpt - b_org
    dist = np.linalg.norm(to_l, axis=1)
    smax = np.where(rng.random(N_DUAL) < 0.3, -1.0, dist - EPS)
    maxt = np.where(rng.random(N_DUAL) < 0.05, -1.0, INF)
    dual = (t32(b_org), t32(b_dir), torch.full((N_DUAL,), 1e-3, device=dev),
            t32(maxt), t32(to_l / dist[:, None]),
            torch.full((N_DUAL,), EPS, device=dev), t32(smax))
    half = N_SINGLE // 2
    single = (torch.cat([cam_org[:half], t32(b_org[:half])]).contiguous(),
              torch.cat([cam_dir[:half], t32(b_dir[:half])]).contiguous(),
              torch.zeros((N_SINGLE,), device=dev),
              torch.full((N_SINGLE,), INF, device=dev))
    return dual, single


def v4_phase(dense_v4, scene, dual, single, card):
    """The per-ray dense_v4 kernels vs their twin on the cornellbox: the
    dual at N_DUAL, closest at N_SINGLE and N_DUAL, any-hit on the
    N_SINGLE rays and on the shadow rays, every output bit-equal, and the
    dual's closest answer the single kernel's."""
    tables = (scene["dense_tris_v4"], scene["dense_cluster_aabb_v4"])
    rec = {"dual": v4_case(dense_v4, "dense_v4 dual", tables, dual, card),
           "single": v4_case(dense_v4, "dense_v4 closest", tables, single,
                             card)}
    v4_case(dense_v4, "dense_v4 closest", tables, dual[:4], card,
            plain_reps=1)
    v4_case(dense_v4, "dense_v4 any-hit", tables, single, card,
            any_hit=True, plain_reps=1)
    v4_case(dense_v4, "dense_v4 any-hit (shadow rays)", tables,
            (dual[0], *dual[4:]), card, any_hit=True, plain_reps=1)
    both = dense_v4._v4_cuda(*tables, *dual[:4], shadow=dual[4:])
    alone = dense_v4._v4_cuda(*tables, *dual[:4])
    torch.cuda.synchronize()
    for key, x, y in zip("tuvp", both, alone):
        if not torch.equal(x, y):
            raise AssertionError(f"dense_v4 dual: closest {key} differs from "
                                 f"dense_v4_trace's on "
                                 f"{int((x != y).sum())} lanes")
    print(f"dense_v4 dual: closest t, u, v, prim bit-equal to "
          f"dense_v4_trace's on its {N_DUAL} rays")
    return rec


def v4_need(aabb, rays, best_t, occ, any_hit=False):
    """Ray-triangle tests these inputs need when each lane walks the
    clusters alone knowing its answer: the 32 of every cluster whose box
    it enters before its final best t (a shadow or any-hit lane: before
    its max t, or one cluster where it is occluded). rays as `v5_need`'s:
    a closest query, an any-hit query whose answer is occ, or a closest
    query and a shadow query from the same origins. The slab test is the
    TPU prelude's (`dense_v4.slab_interval`), each lane a group of one."""
    from pbrlab_tpu_torch.ops.dense_v4 import slab_interval

    org = rays[0]

    def entered(direction, min_t, cap):
        tnear, tfar = slab_interval(aabb, org, direction, min_t)
        enters = tnear <= torch.minimum(tfar, cap[:, None]) * 1.00000024
        return (enters & (cap >= min_t)[:, None]).sum(dim=1)

    def shadow(direction, min_t, max_t):
        return int(torch.where(occ, (max_t >= min_t).long(),
                               entered(direction, min_t, max_t)).sum())

    if any_hit:
        return 32 * shadow(*rays[1:4])
    need = int(entered(rays[1], rays[2], best_t).sum())
    if len(rays) > 4:
        need += shadow(*rays[4:])
    return 32 * need


def v4_case(dense_v4, name, tables, rays, card, any_hit=False,
            plain_reps=3):
    """One dense_v4 kernel vs its twin on the same inputs: closest (or
    any_hit) on 4 ray arrays, the dual on 7 (with the shadow query); every
    output equal to the bit, with the twin's own counts of each lane's
    tests beside the need (`v4_need`). CUDA-event times of the kernel, the
    twin and the whole wrapper call (`dense_trace_v4` / `_dual`)."""
    kw = {"any_hit": any_hit,
          "shadow": rays[4:] if len(rays) > 4 else None}
    args = (*tables, *rays[:4])

    def kernel():
        return dense_v4._v4_cuda(*args, **kw)

    def plain_walk():
        return dense_v4._v4_ref(*args, **kw)

    def wrapper():
        if kw["shadow"] is None:
            return dense_v4.dense_trace_v4(*args, any_hit=any_hit)
        return dense_v4.dense_trace_v4_dual(*tables, *rays)

    got = kernel()
    *ref, work = dense_v4._v4_ref(*args, counts=True, **kw)
    torch.cuda.synchronize()
    for key, x, y in zip(("t", "u", "v", "prim", "occluded"), got, ref):
        if x is not None and not torch.equal(x, y):
            raise AssertionError(f"{name}: {key} differs from the twin on "
                                 f"{int((x != y).sum())} lanes")
    hit = ref[3] >= 0
    err = float((got[0][hit] - ref[0][hit]).abs().max()) if hit.any() \
        else 0.0
    occ = ref[4]
    need = v4_need(tables[1], rays, ref[0], hit if any_hit else occ,
                   any_hit=any_hit)
    ms = cuda_ms(kernel)
    plain = cuda_ms(plain_walk, reps=plain_reps, warmup=1)
    whole = cuda_ms(wrapper)
    n = rays[0].shape[0]  # outputs: t, u, v, prim (+ occluded)
    out_bytes = 16 * n + (0 if occ is None else n)
    b_ms, b_by = bound(nbytes(*tables, *rays) + out_bytes, OPS_TRI * need)
    walked = int(work[:, 0].sum())
    occluded = "" if occ is None else f" occluded={int(occ.sum())}"
    print(f"{name}: N={n} hits={int(hit.sum())}{occluded} bit-equal to the "
          f"twin; kernel {ms:.4f} ms, twin {plain:.4f} ms, whole wrapper "
          f"call {whole:.4f} ms, bound {b_ms:.4f} ms ({b_by}; {need} "
          f"ray-triangle tests needed; the walk did {walked}, "
          f"{walked / max(need, 1):.3f}x, and {int(work[:, 1].sum())} "
          f"ray-box tests) ({card})")
    return dict(ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
                max_abs_err=err, whole_ms=whole)


def bvh_levels(node_meta):
    """Parent and depth of every node of the preorder BVH (left child =
    node + 1, right child = meta[0] when >= 0, else a leaf)."""
    right = node_meta[0].cpu().numpy()
    parent = np.full(right.shape, -1)
    depth = np.zeros(right.shape, np.int64)
    for i in np.flatnonzero(right >= 0):  # preorder: parents come first
        parent[[i + 1, right[i]]] = i
        depth[[i + 1, right[i]]] = depth[i] + 1
    return parent, depth, right < 0


def slab_enters(box, inv, oi, min_t, cap):
    """Whether each ray enters each box before cap: the kernels' slab test
    (box [6, ...] broadcast against the lanes' inv, o * inv)."""
    near, far = [], []
    for a in range(3):
        t0 = box[a] * inv[a] - oi[a]
        t1 = box[a + 3] * inv[a] - oi[a]
        near.append(torch.minimum(t0, t1))
        far.append(torch.maximum(t0, t1))
    tnear = torch.maximum(torch.maximum(near[0], near[1]),
                          torch.maximum(near[2], min_t))
    tfar = torch.minimum(torch.minimum(far[0], far[1]),
                         torch.minimum(far[2], cap))
    return tnear <= tfar * 1.00000024


def lane_visits(node_aabb, levels, org, direction, min_t, cap, lane_root):
    """[nodes, N] bool: the nodes a lane must visit on its own, knowing its
    final best t (`cap`): its start node, then every child of a visited
    node whose box it enters before cap (the kernels' slab test)."""
    from pbrlab_tpu_torch.ops.dense_v5 import _inv

    parent, depth, _ = levels
    dev = org.device
    inv = [_inv(d) for d in direction.unbind(1)]
    oi = [o * i for o, i in zip(org.unbind(1), inv)]
    vis = torch.zeros((parent.shape[0], org.shape[0]), dtype=torch.bool,
                      device=dev)
    for d in range(int(depth.max()) + 1):
        for chunk in np.array_split(np.flatnonzero(depth == d),
                                    max(1, int((depth == d).sum()) // 256)):
            ids = torch.as_tensor(chunk, device=dev)
            enters = slab_enters(node_aabb[:, ids][..., None], inv, oi,
                                 min_t, cap)
            par = torch.as_tensor(parent[chunk], device=dev)
            from_parent = vis[par.clamp(min=0)] & enters & (par >= 0)[:, None]
            vis[ids] = from_parent | (lane_root[None] == ids[:, None])
    return vis


def v5_need(scene, roots, rays, best_t, occ, any_hit=False):
    """(ray-triangle tests, ray-box tests) that these inputs need when each
    lane walks the BVH alone knowing its answer: a closest-hit lane tests
    the 32 triangles of every leaf it enters before its final best t and
    the 2 children of every inner node it enters; a shadow (or any-hit)
    lane that is not occluded does the same up to its max t, an occluded
    one tests one leaf and the children along the shortest path to a leaf
    it enters. rays: one closest query (org, dir, min_t, max_t), or with
    any_hit one any-hit query whose answer is occ, or 7 arrays: a closest
    query and a shadow query (dir, min_t, max_t) from the same origins."""
    na, nm = scene["v5_node_aabb"], scene["v5_node_meta"]
    levels = bvh_levels(nm)
    _, depth, is_leaf = levels
    leaf = torch.as_tensor(is_leaf, device=na.device)
    org, direction, min_t, max_t = rays[:4]
    n = org.shape[0]
    lane_root = torch.zeros((n,), dtype=torch.int64, device=org.device)
    if roots is not None:
        lane_root = roots.to(torch.int64).repeat_interleave(
            n // roots.shape[0])
    root_depth = torch.as_tensor(depth, device=org.device)[lane_root]

    def count(vis, live):
        vis = vis & live[None]
        return (32 * int(vis[leaf].sum()), 2 * int(vis[~leaf].sum()))

    def shadow(sdir, smin_t, smax_t):
        vis = lane_visits(na, levels, org, sdir, smin_t, smax_t, lane_root)
        s_live = smax_t >= smin_t
        t_s, b_s = count(vis, s_live & ~occ)
        leaf_depth = torch.as_tensor(depth, device=org.device)[leaf]
        shallow = torch.where(vis[leaf], leaf_depth[:, None],
                              1 << 30).amin(dim=0)
        hit = s_live & occ
        return (t_s + 32 * int(hit.sum()),
                b_s + 2 * int(torch.where(hit & (shallow < 1 << 30),
                                          shallow - root_depth, 0).sum()))

    if any_hit:
        return shadow(direction, min_t, max_t)
    tri, box = count(lane_visits(na, levels, org, direction, min_t, best_t,
                                 lane_root), max_t >= min_t)
    if len(rays) > 4:
        t_s, b_s = shadow(*rays[4:])
        tri, box = tri + t_s, box + b_s
    return tri, box


def v5_case(dense_v5, name, tris, scene, rays, card, roots=None,
            leaf_major=False, any_hit=False, plain_reps=3):
    """One per-ray dense_v5 kernel vs its twin on the same inputs: v5
    (closest, or any_hit) on 4 ray arrays, the dual on 7 (with the shadow
    query), v5l with leaf_major (roots: per-group root nodes); every
    output equal to the bit (any-hit too: both stop a lane after the same
    leaf), with the twin's own counts of tests. CUDA-event times, and the
    bound of the tests each lane needs (`v5_need`)."""
    na, nm = scene["v5_node_aabb"], scene["v5_node_meta"]
    if leaf_major:
        args, kw = (tris, na, nm, roots, *rays), {}
        launch, twin = dense_v5._v5l_cuda, dense_v5._v5l_ref
    else:
        args = (tris, na, nm, *rays[:4])
        kw = {"shadow": rays[4:]} if len(rays) > 4 else {}
        launch, twin = dense_v5._v5_cuda, dense_v5._v5_ref
    kw["any_hit"] = any_hit

    def kernel():
        return launch(*args, **kw)

    def plain_walk():
        return twin(*args, **kw)

    got = kernel()
    *ref, work = twin(*args, counts=True, **kw)
    torch.cuda.synchronize()
    for key, x, y in zip(("t", "u", "v", "prim", "occluded"), got, ref):
        if x is not None and not torch.equal(x, y):
            raise AssertionError(f"{name}: {key} differs from the twin on "
                                 f"{int((x != y).sum())} lanes")
    hit = ref[3] >= 0
    err = float((got[0][hit] - ref[0][hit]).abs().max()) if hit.any() \
        else 0.0
    occ = ref[4] if len(ref) > 4 else None
    tri_tests, box_tests = v5_need(scene, roots, rays, ref[0],
                                   hit if any_hit else occ, any_hit=any_hit)
    ms = cuda_ms(kernel)
    plain = cuda_ms(plain_walk, reps=plain_reps, warmup=1)
    ops = OPS_TRI * tri_tests + OPS_BOX * box_tests
    b_ms, b_by = bound(nbytes(tris, na, nm, *rays, *got[:4]), ops)
    occluded = "" if occ is None else f" occluded={int(occ.sum())}"
    print(f"{name}: N={rays[0].shape[0]} hits={int(hit.sum())}{occluded} "
          f"bit-equal to the twin; kernel {ms:.4f} ms, twin {plain:.4f} ms, "
          f"bound {b_ms:.4f} ms ({b_by}; {tri_tests} ray-triangle and "
          f"{box_tests} ray-box tests needed; the walk did "
          f"{int(work[:, 0].sum())} and {int(work[:, 1].sum())}) ({card})")
    return dict(ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
                max_abs_err=err)


def v5_phase(dense_v5, mid, large, xl, mid_rays, large_rays, xl_rays,
             card):
    """dense_v5 (dual at N_DUAL, closest at N_SINGLE and N_DUAL, any-hit on
    the shadow rays) on the mid scene, the dual's closest answer equal to
    the single kernel's; dense_v5l with and without group roots and
    dense_v5s on the large scene; on the XL scene, dense_v5l from the
    cut's group roots and dense_v5s, the main path's call."""
    dual, single = mid_rays
    tris = mid["dense_tris_v4"]
    rec = {"v5_dual": v5_case(dense_v5, "dense_v5 dual", tris, mid, dual,
                              card),
           "v5": v5_case(dense_v5, "dense_v5 closest", tris, mid, single,
                         card)}
    v5_case(dense_v5, "dense_v5 closest", tris, mid, dual[:4], card)
    v5_case(dense_v5, "dense_v5 any-hit (shadow rays)", tris, mid,
            (dual[0], *dual[4:]), card, any_hit=True)
    args = (tris, mid["v5_node_aabb"], mid["v5_node_meta"], *dual[:4])
    both = dense_v5._v5_cuda(*args, shadow=dual[4:])
    alone = dense_v5._v5_cuda(*args)
    torch.cuda.synchronize()
    for key, x, y in zip("tuvp", both, alone):
        if not torch.equal(x, y):
            raise AssertionError(f"dense_v5 dual: closest {key} differs from "
                                 f"dense_v5_trace's on "
                                 f"{int((x != y).sum())} lanes")
    print(f"dense_v5 dual: closest t, u, v, prim bit-equal to "
          f"dense_v5_trace's on its {N_DUAL} rays")
    args = (*args[:3], *single)
    anyh = dense_v5.dense_trace_v5(*args, any_hit=True)
    ref = dense_v5.dense_trace_v5_ref(*args)
    if not torch.equal(anyh["prim"] >= 0, ref["prim"] >= 0):
        raise AssertionError("dense_v5 any-hit: hit mask differs")
    print("dense_v5 any-hit: hit mask equal to the closest hit's")

    ldual = large_rays[0]
    tris = large["dense_tris_v5l"]
    rec["v5l"] = v5_case(dense_v5, "dense_v5l whole tree", tris, large,
                         ldual[:4], card, leaf_major=True, plain_reps=1)
    sub = large["v5s_roots"]
    roots = sub[torch.arange(N_DUAL // 1024, device=sub.device)
                % sub.shape[0]].contiguous()
    v5_case(dense_v5, "dense_v5l group roots", tris, large, ldual[:4], card,
            roots=roots, leaf_major=True, plain_reps=1)

    v5s_case(dense_v5, "dense_v5s", large, ldual, card)
    xdual = xl_rays[0]
    sub = xl["v5s_roots"]
    roots = sub[torch.arange(N_DUAL // 1024, device=sub.device)
                % sub.shape[0]].contiguous()
    rec["v5l_xl"] = v5_case(dense_v5, "dense_v5l group roots, xl",
                            xl["dense_tris_v5l"], xl, xdual[:4], card,
                            roots=roots, leaf_major=True, plain_reps=1)
    v5s_case(dense_v5, "dense_v5s xl", xl, xdual, card)
    return rec


def v5s_case(dense_v5, name, scene, dual, card):
    """dense_trace_v5s (closest and any-hit) on a large scene's rays
    against the same scheduler over the plain v5l walk; CUDA-event times
    of a call, of the v5l launches inside it and over the plain walk."""
    s_args = (scene["dense_tris_v5l"], scene["v5_node_aabb"],
              scene["v5_node_meta"], scene["v5s_roots"], scene["v5s_aabb"],
              *dual[:4])
    got = dense_v5.dense_trace_v5s(*s_args)
    ref = v5s_over_plain_v5l(dense_v5, s_args)
    torch.cuda.synchronize()
    err = check_hits(name, got, ref)
    anyh = dense_v5.dense_trace_v5s(*s_args, any_hit=True)
    if not torch.equal(anyh["prim"] >= 0, ref["prim"] >= 0):
        raise AssertionError(f"{name} any-hit: hit mask differs")
    total = cuda_ms(lambda: dense_v5.dense_trace_v5s(*s_args), reps=10)
    plain = cuda_ms(lambda: v5s_over_plain_v5l(dense_v5, s_args), reps=1,
                    warmup=1)
    kernel_ms = v5s_kernel_share(dense_v5, s_args)
    print(f"{name} N={N_DUAL}: max|dt|={err:.3g}, any-hit mask equal; "
          f"{total:.4f} ms a call (v5l inside: {kernel_ms:.4f} ms in "
          f"its launches, {total - kernel_ms:.4f} ms scheduling ops), "
          f"{plain:.4f} ms over the plain v5l ({card})")


def v5s_over_plain_v5l(dense_v5, s_args):
    """dense_trace_v5s with the plain v5l walk in place of the kernel."""
    kernel = dense_v5.dense_trace_v5l
    dense_v5.dense_trace_v5l = dense_v5.dense_trace_v5l_ref
    try:
        return dense_v5.dense_trace_v5s(*s_args)
    finally:
        dense_v5.dense_trace_v5l = kernel


def v5s_kernel_share(dense_v5, s_args, reps=10):
    """Median over reps of the CUDA-event time of the v5l launches inside
    one dense_trace_v5s call."""
    launch = dense_v5._v5l_cuda
    spans = []

    def timed(*a, **kw):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        out = launch(*a, **kw)
        ev[1].record()
        spans.append(ev)
        return out

    per_call = []
    dense_v5._v5l_cuda = timed
    try:
        for _ in range(reps):
            spans.clear()
            dense_v5.dense_trace_v5s(*s_args)
            torch.cuda.synchronize()
            per_call.append(sum(a.elapsed_time(b) for a, b in spans))
    finally:
        dense_v5._v5l_cuda = launch
    return float(np.median(per_call))


def curve_need(aabb, org, direction, min_t, max_t, cap, occluded=None):
    """(ray-ribbon tests, ray-box tests) these inputs need when each lane
    walks the clusters alone knowing its answer: every live lane tests the
    M cluster boxes and the 128 ribbons of every cluster whose box it
    enters before `cap` (its final t; an any-hit lane its max t, or one
    cluster where it is occluded)."""
    from pbrlab_tpu_torch.ops.dense_curve import SEG_BLOCK, _inv

    live = max_t >= min_t
    inv = [_inv(d) for d in direction.unbind(1)]
    o = org.unbind(1)
    entered = torch.zeros_like(min_t, dtype=torch.int64)
    for c0 in range(0, aabb.shape[1], 256):
        box = aabb[:, c0:c0 + 256, None]  # [8, k, 1]
        t0 = [(box[a] - o[a]) * inv[a] for a in range(3)]
        t1 = [(box[a + 3] - o[a]) * inv[a] for a in range(3)]
        tnear = torch.maximum(torch.maximum(torch.minimum(t0[0], t1[0]),
                                            torch.minimum(t0[1], t1[1])),
                              torch.minimum(t0[2], t1[2]))
        tfar = torch.minimum(torch.minimum(torch.maximum(t0[0], t1[0]),
                                           torch.maximum(t0[1], t1[1])),
                             torch.maximum(t0[2], t1[2]))
        entered += ((tnear <= tfar * 1.00000024) & (tfar >= min_t)
                    & (tnear <= cap)).sum(0)
    if occluded is not None:
        entered = torch.where(occluded, 1, entered)
    return (SEG_BLOCK * int(entered[live].sum()),
            aabb.shape[1] * int(live.sum()))


def curve_case(dense_curve, name, segs, aabb, rays, any_hit, card,
               n_plain=None, plain_reps=3):
    """The per-ray dense_curve kernel vs its twin `_walk_ref` (on the first
    n_plain rays when given: a lane's answer is its own): t, u, v, sub
    equal to the bit, the twin's own counts of each lane's tests beside
    the need (`curve_need`); CUDA-event times and the bound."""
    from pbrlab_tpu_torch.core.math import INF

    org, direction, min_t, max_t = rays
    n = org.shape[0]
    got = dense_curve._walk_cuda(segs, aabb, *rays, any_hit=any_hit)
    k = n if n_plain is None else n_plain
    part = [r[:k].contiguous() for r in rays]
    *ref, work = dense_curve._walk_ref(segs, aabb, *part, any_hit=any_hit,
                                       counts=True)
    torch.cuda.synchronize()
    for key, x, y in zip("tuvs", got, ref):
        if not torch.equal(x[:k], y):
            raise AssertionError(f"{name}: {key} differs from the twin on "
                                 f"{int((x[:k] != y).sum())} lanes")
    hit = ref[3] >= 0
    err = float((got[0][:k][hit] - ref[0][hit]).abs().max()) if hit.any() \
        else 0.0
    ghit = got[3] >= 0
    cap = torch.where(ghit, got[0], torch.clamp(max_t, max=INF))
    tests, boxes = curve_need(aabb, org, direction, min_t, max_t,
                              max_t if any_hit else cap,
                              ghit if any_hit else None)
    need_k = curve_need(aabb, *part, part[3] if any_hit else cap[:k],
                        hit if any_hit else None)[0]
    ms = cuda_ms(lambda: dense_curve._walk_cuda(segs, aabb, *rays,
                                                any_hit=any_hit))
    plain = cuda_ms(lambda: dense_curve._walk_ref(segs, aabb, *part,
                                                  any_hit=any_hit),
                    reps=plain_reps, warmup=1)
    b_ms, b_by = bound(nbytes(segs, aabb, *rays) + 16 * n,
                       OPS_RIBBON * tests + OPS_BOX * boxes)
    walked = int(work[:, 0].sum())
    print(f"{name}: N={n} hits={int(ghit.sum())} (twin on {k}: t, u, v, "
          f"sub bit-equal); kernel {ms:.4f} ms, twin {plain:.4f} ms on {k} "
          f"rays, bound {b_ms:.4f} ms ({b_by}; {tests} ray-ribbon and "
          f"{boxes} ray-box tests needed; on the twin's {k} rays {need_k} "
          f"ribbon tests needed, the walk did {walked}, "
          f"{walked / max(need_k, 1):.3f}x, and {int(work[:, 1].sum())} "
          f"ray-box tests) ({card})")
    return dict(ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
                max_abs_err=err)


def curve_phase(dense_curve, scene, path_rays_, card):
    """dense_curve at the hair path's shapes (closest and any-hit at
    N_DUAL, closest at N_SINGLE) and on a dense tuft of DENSE_TUFT strands
    (the kernel at N_DUAL, the plain walk on its first N_PLAIN_TUFT)."""
    from pbrlab_tpu_torch.io.cyhair import make_demo_hair
    from pbrlab_tpu_torch.ops.curves import flatten_curves

    dual, single = path_rays_
    segs, aabb = scene["dense_segs"], scene["dense_seg_aabb"]
    closest = dense_curve.clamped_rays(*dual[:4])
    shadow = dense_curve.clamped_rays(dual[0], *dual[4:])
    rec = {"curve": curve_case(dense_curve, "dense_curve closest", segs, aabb,
                               closest, False, card)}
    curve_case(dense_curve, "dense_curve any-hit (shadow rays)", segs, aabb,
               shadow, True, card)
    curve_case(dense_curve, "dense_curve closest", segs, aabb,
               dense_curve.clamped_rays(*single), False, card)

    t0 = time.perf_counter()
    tuft = make_demo_hair(num_strands=DENSE_TUFT, base=(0.0, 1.35, 0.0),
                          length=0.7)
    packed, tuft_aabb, _ = dense_curve.pack_segments(flatten_curves(
        tuft.segment_points()))
    dev = segs.device
    packed = torch.from_numpy(packed).to(dev)
    tuft_aabb = torch.from_numpy(tuft_aabb).to(dev)
    print(f"dense tuft: {DENSE_TUFT} strands, {tuft.num_segments} segments, "
          f"{packed.shape[0]} sub-segment rows, {tuft_aabb.shape[1]} "
          f"clusters, {nbytes(packed) / 1e6:.1f} MB, packed in "
          f"{time.perf_counter() - t0:.2f} s")
    rec["curve_tuft"] = curve_case(
        dense_curve, "dense_curve closest, dense tuft", packed, tuft_aabb,
        closest, False, card, n_plain=N_PLAIN_TUFT, plain_reps=1)
    curve_case(dense_curve, "dense_curve any-hit, dense tuft", packed,
               tuft_aabb, shadow, True, card, n_plain=N_PLAIN_TUFT,
               plain_reps=1)
    return rec


def v5i_need(scene, org, direction, min_t, cap, occluded=None):
    """(ray-triangle tests, ray-box tests, instance transforms) that these
    inputs need when each lane walks the two levels alone knowing its
    answer (`cap`: its final best t, or an any-hit lane's max t): the
    children of every TLAS inner node it enters; at every TLAS leaf it
    enters, the transform into the instance and the BLAS root's box; in
    the BLAS, where it enters the root, the children of every inner node
    and the 32 triangles of every leaf it enters. An occluded any-hit lane
    needs one leaf on its shortest such path: the boxes on the way, one
    transform and 32 tests."""
    from pbrlab_tpu_torch.ops.per_ray import _inv, to_instance

    na, nm = scene["i5_node_aabb"], scene["i5_node_meta"]
    inv, imeta = scene["i5_inst_inv"], scene["i5_inst_meta"]
    dev = org.device
    n = org.shape[0]
    levels = bvh_levels(nm)
    _, depth, is_leaf = levels
    leaf = torch.as_tensor(is_leaf, device=dev)
    depth = torch.as_tensor(depth, device=dev)
    tlas = torch.arange(nm.shape[1], device=dev) < int(imeta[0].min())
    occ = (torch.zeros((n,), dtype=torch.bool, device=dev)
           if occluded is None else occluded)
    live = cap >= min_t
    full = live & ~occ  # lanes that walk up to cap
    vis = lane_visits(na, levels, org, direction, min_t, cap,
                      torch.zeros((n,), dtype=torch.int64, device=dev))
    vis &= live[None]
    box = 2 * int(vis[tlas & ~leaf][:, full].sum())
    t_leaf, lane = torch.nonzero(vis & (tlas & leaf)[:, None], as_tuple=True)
    inst = -nm[1][t_leaf].to(torch.int64) - 1
    root = imeta[0][inst].to(torch.int64)
    xforms = int(full[lane].sum())
    box += xforms  # the BLAS root's box
    tri = 0
    big = 1 << 30
    path = torch.full((n,), big, dtype=torch.int64, device=dev)
    for c0 in range(0, lane.shape[0], 1 << 16):
        ln, k = lane[c0:c0 + (1 << 16)], inst[c0:c0 + (1 << 16)]
        r = root[c0:c0 + (1 << 16)]
        lo3, ld3 = to_instance(inv, k, org[ln], direction[ln])
        lo, ld = lo3.unbind(1), ld3.unbind(1)
        i3 = [_inv(x) for x in ld]
        enters = slab_enters(na[:, r], i3, [o * i for o, i in zip(lo, i3)],
                             min_t[ln], cap[ln])
        bv = lane_visits(na, levels, lo3, ld3, min_t[ln], cap[ln], r) \
            & enters[None]
        f = full[ln]
        tri += 32 * int(bv[leaf][:, f].sum())
        box += 2 * int(bv[~leaf][:, f].sum())
        if occluded is not None:
            shallow = torch.where(bv & leaf[:, None],
                                  depth[:, None] - depth[r][None], big).amin(0)
            cost = 2 * depth[t_leaf[c0:c0 + (1 << 16)]] + 1 + 2 * shallow
            path.scatter_reduce_(0, ln, torch.where(
                occ[ln] & (shallow < big), cost, big), "amin")
    hit = live & occ & (path < big)
    return (tri + 32 * int(hit.sum()), box + int(path[hit].sum()),
            xforms + int(hit.sum()))


def v5i_case(dense_v5i, name, scene, rays, any_hit, card):
    """The dense_v5i kernel vs its twin `_walk_ref`: every output equal to
    the bit; CUDA-event times (the twin timed on its one parity call, which
    also counts each lane's tests), the bound of the work each lane needs
    (`v5i_need`) beside the walk's own counts."""
    tables = [scene[k] for k in ("i5_tris", "i5_node_aabb", "i5_node_meta",
                                 "i5_inst_inv", "i5_inst_meta")]
    args = (*tables, *rays)
    got = dense_v5i._walk_cuda(*args, any_hit=any_hit)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    *ref, work = dense_v5i._walk_ref(*args, any_hit=any_hit, counts=True)
    ev[1].record()
    torch.cuda.synchronize()
    plain = ev[0].elapsed_time(ev[1])
    for key, a, b in zip("tuvp", got, ref):
        if not torch.equal(a, b):
            raise AssertionError(f"{name}: {key} differs from the twin on "
                                 f"{int((a != b).sum())} lanes")
    hit = ref[3] >= 0
    err = float((got[0][hit] - ref[0][hit]).abs().max()) if hit.any() \
        else 0.0
    org, direction, min_t, max_t = rays
    tri, box, xf = v5i_need(scene, org, direction, min_t,
                            max_t if any_hit else ref[0],
                            hit if any_hit else None)
    ms = cuda_ms(lambda: dense_v5i._walk_cuda(*args, any_hit=any_hit),
                 reps=10)
    b_ms, b_by = bound(nbytes(*tables, *rays, *got),
                       OPS_TRI * tri + OPS_BOX * box + OPS_XFORM * xf)
    walked = work.sum(0).tolist()
    print(f"{name}: N={org.shape[0]} hits={int(hit.sum())} t, u, v, prim "
          f"bit-equal to the twin (max|dt|={err:.3g}); kernel {ms:.4f} ms, "
          f"twin {plain:.4f} ms (one call), bound {b_ms:.4f} ms ({b_by}; "
          f"{tri} ray-triangle and {box} ray-box tests and {xf} transforms "
          f"needed; the walk did {walked[0]}, {walked[1]} and {walked[2]}) "
          f"({card})")
    return dict(ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
                max_abs_err=err)


def v5i_phase(dense_v5i, scene, path_rays_, card):
    """dense_v5i at the instanced path's shapes: closest at N_DUAL, any-hit
    on its shadow rays, closest at N_SINGLE."""
    dual, single = path_rays_
    rec = {"v5i": v5i_case(dense_v5i, "dense_v5i closest", scene, dual[:4],
                           False, card)}
    v5i_case(dense_v5i, "dense_v5i any-hit (shadow rays)", scene,
             (dual[0], *dual[4:]), True, card)
    v5i_case(dense_v5i, "dense_v5i closest", scene, single, False, card)
    return rec


def legacy_case(name, module, tables, rays, any_hit, card):
    """One legacy kernel (v1, v2 or v3: each walks per ray) vs its twin on
    the rays themselves, with the twin's own counts of each lane's tests;
    t, u, v, prim equal to the bit; times (the kernel median of 10
    CUDA-event launches, the twin median of 3) and the bound of the tests
    each lane needs (`curve_need`'s slab test is the legacy kernels'
    own), the walk against it."""
    from pbrlab_tpu_torch.ops import dense
    from pbrlab_tpu_torch.ops.dense_curve import clamped_rays

    tris, aabb = tables
    args = (tris, aabb, *clamped_rays(*rays))
    got = module._walk_cuda(*args, any_hit=any_hit)
    *ref, work = module._walk_ref(*args, any_hit=any_hit, counts=True)
    torch.cuda.synchronize()
    for key, a, b in zip("tuvp", got, ref):
        if not torch.equal(a, b):
            raise AssertionError(f"{name}: {key} differs from the twin on "
                                 f"{int((a != b).sum())} lanes")
    hit = ref[3] >= 0
    err = float((got[0][hit] - ref[0][hit]).abs().max()) if hit.any() \
        else 0.0
    org, direction, min_t, max_t = rays
    if any_hit and module is not dense:
        tests, boxes = curve_need(aabb, org, direction, min_t, max_t, max_t,
                                  hit)
    else:  # closest (v1 answers the closest hit for any-hit queries too)
        tests, boxes = curve_need(aabb, org, direction, min_t, max_t,
                                  torch.where(hit, ref[0], max_t))
    ms = cuda_ms(lambda: module._walk_cuda(*args, any_hit=any_hit), reps=10)
    plain = cuda_ms(lambda: module._walk_ref(*args, any_hit=any_hit),
                    reps=3, warmup=1)
    n = org.shape[0]
    b_ms, b_by = bound(nbytes(tris, aabb, *rays) + 16 * n,
                       OPS_TRI * tests + OPS_BOX * boxes)
    walked = int(work[:, 0].sum())
    print(f"{name}: N={n} hits={int(hit.sum())} t, u, v, prim bit-equal to "
          f"the twin (max|dt|={err:.3g}); kernel {ms:.4f} ms, twin "
          f"{plain:.4f} ms, bound {b_ms:.4f} ms ({b_by}; {tests} "
          f"ray-triangle and {boxes} ray-box tests needed; the walk did "
          f"{walked}, {walked / max(tests, 1):.3f}x, and "
          f"{int(work[:, 1].sum())} ray-box tests) ({card})")
    return dict(ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
                max_abs_err=err)


def legacy_phase(modules, scene, path_rays_, card):
    """The three legacy kernels at the file path's shapes (its legacy
    tables: 2572 faces, 2688 columns, 21 clusters): closest at N_DUAL,
    any-hit on the shadow rays, closest at N_SINGLE; v3 timed also as a
    whole wrapper call."""
    dual, single = path_rays_
    tables = (scene["dense_tris"], scene["dense_cluster_aabb"])
    shapes = (("closest", dual[:4], False), ("any-hit (shadow rays)",
                                             (dual[0], *dual[4:]), True),
              ("closest", single, False))
    rec = {}
    for key in ("v3", "v2", "v1"):
        cases = [legacy_case(f"dense {key} {label}", modules[key], tables,
                             rays, any_hit, card)
                 for label, rays, any_hit in shapes]
        rec[key] = cases[0]
    v3 = modules["v3"]
    whole = cuda_ms(lambda: v3.dense_trace_v3(*tables, *dual[:4]), reps=10)
    print(f"dense_trace_v3 N={N_DUAL} closest, whole call (no prelude: "
          f"clamp, kernel, the miss's INF): {whole:.4f} ms against "
          f"{rec['v3']['ms']:.4f} ms in the kernel ({card})")
    return rec


def bvh_case(name, kernel, tables, rays, any_hit, card, ops_prim):
    """A threaded-BVH walk kernel ("bvh_trace" or "curve_bvh_trace") vs its
    twin on the same rays: t, u, v, prim equal to the bit; the twin's
    counts of each lane's tests; CUDA-event times; the bound from the need
    (closest: the walk with each lane's final t as its cap from the
    start; any-hit: the walk's own tests)."""
    from pbrlab_tpu_torch.ops import bvh_walk, curves, intersect

    twin = (intersect._bvh_walk_ref if kernel == "bvh_trace"
            else curves._curve_walk_ref)
    tree, prims = tables
    org, direction, min_t, max_t = rays
    n = org.shape[0]
    got = bvh_walk.walk_cuda(kernel, tree, prims, *rays, any_hit=any_hit)
    *ref, work = twin(tree, prims, *rays, any_hit=any_hit, counts=True)
    torch.cuda.synchronize()
    for key, x, y in zip(("t", "u", "v", "prim"), got, ref):
        if not torch.equal(x, y):
            raise AssertionError(f"{name}: {key} differs from the twin on "
                                 f"{int((x != y).sum())} lanes")
    hit = ref[3] >= 0
    err = float((got[0][hit] - ref[0][hit]).abs().max()) if hit.any() \
        else 0.0
    need = work if any_hit else twin(
        tree, prims, org, direction, min_t,
        torch.where(hit, ref[0], max_t), counts=True)[-1]
    tests, boxes = int(need[:, 0].sum()), int(need[:, 1].sum())
    ms = cuda_ms(lambda: bvh_walk.walk_cuda(kernel, tree, prims, *rays,
                                            any_hit=any_hit))
    plain = cuda_ms(lambda: twin(tree, prims, *rays, any_hit=any_hit),
                    reps=3, warmup=1)
    b_ms, b_by = bound(nbytes(*tree, *prims, *rays) + 16 * n,
                       ops_prim * tests + OPS_BOX * boxes)
    live = max(int((max_t >= min_t).sum()), 1)
    walked = work.sum(0).tolist()
    print(f"{name}: N={n} hits={int(hit.sum())} (t, u, v, prim bit-equal "
          f"to the twin); kernel {ms:.4f} ms, twin {plain:.4f} ms, bound "
          f"{b_ms:.4f} ms ({b_by}; {tests} primitive and {boxes} box tests "
          f"needed; the walk did {walked[0]} and {walked[1]}, "
          f"{walked[0] / max(tests, 1):.3f}x and "
          f"{walked[1] / max(boxes, 1):.3f}x, per live lane "
          f"{walked[0] / live:.1f} and {walked[1] / live:.1f}, the longest "
          f"walk {int(work[:, 1].max())} nodes) ({card})")
    return dict(ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
                max_abs_err=err)


def bvh_phase(counters, scenes_np, scenes, rays, card):
    """Phase 8: the "bvh" backend. Both threaded-BVH walk kernels against
    their twins on phase 3's path rays (the cornellbox's triangles, the
    hair scene's curves; closest and any-hit at N_DUAL), card vs CPU
    renders at 32x32x2 in phase 4's band, then the cornellbox and the hair
    scene rendered at BVH_SIZE^2 x BVH_SPP with tri_backend="bvh", every
    launch counter set to 0 just before each render and read just after:
    the walks must run and no other trace kernel. Returns (kernel records,
    launches per render)."""
    from pbrlab_tpu_torch.ops import bvh_walk, curves, intersect
    from pbrlab_tpu_torch.render.integrator import render_lanes_wavefront

    corn, hair = scenes["cornellbox"], scenes["hair"]
    tri = ([corn[k] for k in intersect.BVH_TABLES[:5]],
           [corn[k] for k in intersect.BVH_TABLES[5:]])
    rib = ([hair[k] for k in curves.CBVH_TABLES],
           [hair[k] for k in curves.CURVE_COLUMNS])
    print(f"bvh tables: cornellbox {tri[0][2].shape[0]} nodes over "
          f"{tri[1][0].shape[0]} slots, hair tuft {rib[0][2].shape[0]} "
          f"nodes over {rib[1][0].shape[0]} sub-segments")
    dual, _ = rays["cornellbox"]
    rec = {"bvh": bvh_case("bvh_trace closest", "bvh_trace", tri, dual[:4],
                           False, card, OPS_TRI)}
    bvh_case("bvh_trace any-hit (shadow rays)", "bvh_trace", tri,
             (dual[0], *dual[4:]), True, card, OPS_TRI)
    dual, _ = rays["hair"]
    rec["curve_bvh"] = bvh_case("curve_bvh_trace closest", "curve_bvh_trace",
                                rib, dual[:4], False, card, OPS_RIBBON)
    bvh_case("curve_bvh_trace any-hit (shadow rays)", "curve_bvh_trace",
             rib, (dual[0], *dual[4:]), True, card, OPS_RIBBON)

    for name in BVH_PATHS:
        render_parity(f"{name} bvh", scenes_np[name], scenes[name],
                      width=32, height=32, spp=2, tri_backend="bvh",
                      **SETTINGS)
    launches = {}
    for name in BVH_PATHS:
        for c in counters.values():
            for k in c:
                c[k] = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        total, iters = render_lanes_wavefront(
            scenes[name], BVH_SIZE, BVH_SIZE, BVH_SPP, seed=SEED,
            return_iters=True, tri_backend="bvh", **SETTINGS)
        img = (total.reshape(BVH_SIZE, BVH_SIZE, 3) / BVH_SPP).cpu().numpy()
        wall = time.perf_counter() - t0
        counts = {f"{m}.{k}": v for m, c in counters.items()
                  for k, v in c.items() if v}
        launches[name] = dict(bvh_walk.LAUNCHES)
        print(f"path {name} bvh: render {BVH_SIZE}x{BVH_SIZE}x{BVH_SPP} "
              f"max_steps={SETTINGS['max_steps']} k_volume="
              f"{SETTINGS['k_volume']} in {wall:.3f} s, {iters} "
              f"sub-iterations, launches {counts}, mean {img.mean():.5f} "
              f"({card})")
        if not (np.isfinite(img).all() and (img >= 0).all()
                and img.mean() > 0):
            raise AssertionError(f"{name} bvh image is not finite, "
                                 "non-negative, lit")
        want = ["bvh_closest", "bvh_any_hit"]
        if name == "hair":
            want += ["curve_closest", "curve_any_hit"]
        if not all(bvh_walk.LAUNCHES[k] for k in want):
            raise AssertionError(f"{name} bvh path missed a walk: {counts}")
        if any(not k.startswith("bvh.") for k in counts):
            raise AssertionError(f"{name}: a trace left the bvh backend: "
                                 f"{counts}")
    return rec, launches


def graph_phase(scenes, file_scene, card):
    """Phase 9: the render loop's CUDA graphs against the loop op by op.
    Every phase-5 path and the cornellbox at tri_backend="bvh" render at
    GRAPH_SIZE^2 x GRAPH_SPP through `integrator._wavefront`, first with a
    `GraphRunner` whose every phase (warm-up, capture, replay) runs under
    `torch.cuda.set_sync_debug_mode("error")`, so a phase that
    synchronised raises (the host's reads sit between phases), then with
    the `EagerRunner`: the images must be bit-equal and the sub-iterations
    and launch counts equal. Prints both walls, each graph's capture and
    instantiate seconds, replays and nodes, and each render's peak
    allocated memory. Returns {path: record}."""
    from pbrlab_tpu_torch.render import graphs
    from pbrlab_tpu_torch.render.integrator import _wavefront

    Checked = checked_runner()
    renders = [(name, scenes[name], None) for name in PATHS]
    renders += [(f"file {backend}", file_scene, backend)
                for backend in FILE_RENDERS]
    renders.append(("cornellbox bvh", scenes["cornellbox"], "bvh"))
    size, spp = GRAPH_SIZE, GRAPH_SPP
    out = {}
    for name, scene, backend in renders:
        rec = {}
        for kind in ("graphs", "eager"):
            runner = Checked() if kind == "graphs" else graphs.EagerRunner()
            for c in graphs.COUNTERS.values():
                for k in c:
                    c[k] = 0
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            fb, iters = _wavefront(runner, scene, size, size, spp, seed=SEED,
                                   tri_backend=backend, **SETTINGS)
            torch.cuda.synchronize()
            rec[kind] = {
                "wall_s": time.perf_counter() - t0, "iters": iters,
                "fb": fb.cpu(),
                "peak_bytes": torch.cuda.max_memory_allocated(),
                "launches": {f"{m}.{k}": v for m, c in
                             graphs.COUNTERS.items() for k, v in c.items()
                             if v}}
            if kind == "graphs":
                nodes = runner.nodes()
                rec["phases"] = {ph: {**st, "nodes": nodes.get(ph)}
                                 for ph, st in runner.stats.items()}
        g, e = rec["graphs"], rec["eager"]
        err = (g["fb"] - e["fb"]).abs().max().item()
        capture = sum(st["capture_s"] + st["instantiate_s"]
                      for st in rec["phases"].values())
        print(f"graphs {name} {size}x{size}x{spp}: graphed {g['wall_s']:.3f}"
              f" s (captures {capture:.3f} s), eager {e['wall_s']:.3f} s, "
              f"{g['iters']} / {e['iters']} sub-iterations, max_abs_err "
              f"{err}, peak allocated {g['peak_bytes'] / 2**20:.1f} / "
              f"{e['peak_bytes'] / 2**20:.1f} MiB, launches {g['launches']}"
              f" ({card})")
        for phase, st in rec["phases"].items():
            print(f"  {phase}: {st['nodes']} nodes, capture "
                  f"{st['capture_s']:.4f} s, instantiate "
                  f"{st['instantiate_s']:.4f} s, {st['replays']} replays")
        if not (torch.equal(g["fb"], e["fb"]) and g["iters"] == e["iters"]
                and g["launches"] == e["launches"] and g["fb"].sum() > 0):
            raise AssertionError(f"{name}: the graphed render differs from "
                                 "the eager loop")
        if not any(st["replays"] for st in rec["phases"].values()):
            raise AssertionError(f"{name}: no graph was replayed")
        out[name] = rec
    return out


def scan_graph_phase(scenes, file_scene, names, card):
    """Phase 9, the scan path's compiled programs against their phases op
    by op: `render_scan` at GRAPH_SIZE^2 x GRAPH_SPP on every phase-5 path,
    three progressive passes of the cornellbox at GRAPH_SIZE^2 with an
    HTTP edit before the third, and the gradient passes of the cornellbox
    and of the hair scene (its HAIR_GRAD_KEYS too) at SCAN_GRAD_SIZE^2 x
    1, each once through a `Programs` of `GraphRunner`s
    whose every phase runs under sync debug mode "error" and once through
    `EagerRunner`s. The images, the passes and the loss must be bit-equal
    and the launches equal; the gradients within GRAD_BAND of the largest
    eager entry (the backward's index_add_ atomics order the sums anew);
    the edit must capture nothing new. Prints walls, captures, nodes and
    peak allocated memory."""
    import urllib.request

    from pbrlab_tpu_torch.app.viewer import PreviewServer
    from pbrlab_tpu_torch.render import graphs
    from pbrlab_tpu_torch.render.integrator import render_scan
    from pbrlab_tpu_torch.render.progressive import ProgressiveRenderer

    runners = {"graphs": checked_runner(), "eager": graphs.EagerRunner}
    size, spp = GRAPH_SIZE, GRAPH_SPP

    def launches():
        return {f"{m}.{k}": v for m, c in graphs.COUNTERS.items()
                for k, v in c.items() if v}

    def zero():
        for c in graphs.COUNTERS.values():
            for k in c:
                c[k] = 0

    renders = [(name, scenes[name], None) for name in PATHS]
    renders += [(f"file {backend}", file_scene, backend)
                for backend in FILE_RENDERS]
    for name, scene, backend in renders:
        rec = {}
        for kind, runner in runners.items():
            programs = graphs.Programs(runner=runner)
            zero()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            img = render_scan(scene, size, size, spp, seed=SEED,
                              tri_backend=backend, programs=programs,
                              **SETTINGS)
            torch.cuda.synchronize()
            rec[kind] = (time.perf_counter() - t0, img.cpu(), launches(),
                         torch.cuda.max_memory_allocated(), programs)
        g, e = rec["graphs"], rec["eager"]
        print(f"graphs scan {name} {size}x{size}x{spp}: graphed {g[0]:.3f} "
              f"s, eager {e[0]:.3f} s, max_abs_err "
              f"{(g[1] - e[1]).abs().max().item()}, peak allocated "
              f"{g[3] / 2**20:.1f} / {e[3] / 2**20:.1f} MiB, launches {g[2]}"
              f" ({card})")
        print(f"  {program_line(g[4])}")
        if not (torch.equal(g[1], e[1]) and g[2] == e[2] and g[1].sum() > 0):
            raise AssertionError(f"scan {name}: the graphed render_scan "
                                 "differs from its phases op by op")

    scene = scenes["cornellbox"]
    passes = {}
    for kind, runner in runners.items():
        r = ProgressiveRenderer(scene, size, size, seed=SEED,
                                material_names=names["cornellbox"],
                                **SETTINGS)
        r.programs = graphs.Programs(runner=runner)
        srv = PreviewServer(r, max_pass=8)
        port = srv.start(port=0)
        try:
            accums = []
            for i in range(3):
                if i == 2:
                    captured = captures(r.programs)
                    urllib.request.urlopen(urllib.request.Request(
                        f"http://127.0.0.1:{port}/edit", data=json.dumps(
                            {"material": "Wall_White", "param": "base_color",
                             "value": [0.1, 0.9, 0.1]}).encode(),
                        method="POST"), timeout=30).read()
                r.step()
                accums.append(r.accum.copy())
        finally:
            srv.stop()
        passes[kind] = (accums, r.pass_times, captured, captures(r.programs),
                        r.programs)
    g, e = passes["graphs"], passes["eager"]
    same = all(np.array_equal(a, b) for a, b in zip(g[0], e[0]))
    print(f"graphs progressive {size}x{size}, 3 passes, an HTTP edit before "
          f"the third: bit-equal {same}; pass times graphed "
          f"{[round(t, 4) for t in g[1]]} s, eager "
          f"{[round(t, 4) for t in e[1]]} s; graphs {g[2]} before the edit, "
          f"{g[3]} after ({card})")
    print(f"  {program_line(g[4])}")
    if not same or g[3] != g[2] or np.array_equal(g[0][2], g[0][1]):
        raise AssertionError("the graphed progressive passes differ from "
                             "the eager ones, or the edit recaptured")

    for name, extra in (("cornellbox", ()), ("hair", HAIR_GRAD_KEYS)):
        rec = {}
        for kind, runner in runners.items():
            programs = graphs.Programs(runner=runner)
            rec[kind] = grad_pass(scenes[name], SCAN_GRAD_SIZE,
                                  counters=graphs.COUNTERS, programs=programs,
                                  extra=extra, **SETTINGS)
            rec[kind]["programs"] = programs
        g, e = rec["graphs"], rec["eager"]
        same = torch.equal(g["img"], e["img"]) and torch.equal(g["loss"],
                                                               e["loss"])
        print(f"graphs grad pass {name} {SCAN_GRAD_SIZE}x{SCAN_GRAD_SIZE}x1:"
              f" image and loss bit-equal {same}, launches {g['counts']}; "
              f"forward {g['fwd']:.3f} / {e['fwd']:.3f} s, backward "
              f"{g['bwd']:.3f} / {e['bwd']:.3f} s, peak allocated "
              f"{g['peak'] / 2**20:.1f} / {e['peak'] / 2**20:.1f} MiB, "
              f"graphed / eager ({card})")
        print(f"  {program_line(g['programs'])}")
        if not same or g["counts"] != e["counts"]:
            raise AssertionError(f"the graphed gradient pass of {name} "
                                 "differs from its phases op by op")
        grads_agree(f"graphs grad pass {name} {SCAN_GRAD_SIZE}x"
                    f"{SCAN_GRAD_SIZE}x1 graphed vs eager", g["grads"],
                    e["grads"], GRAD_BAND, card)


def render_parity(name, scene_np, scene, fn=None, **kw):
    """`fn` (default `integrator.render`) on the card against the same
    call on the CPU, in the band of PERF.md section 2."""
    from pbrlab_tpu_torch.render.integrator import render
    from pbrlab_tpu_torch.scene.scene import scene_from_numpy

    fn = fn or render
    img_gpu = fn(scene, seed=SEED, **kw).cpu().numpy()
    img_cpu = fn(scene_from_numpy(scene_np, "cpu"), seed=SEED, **kw).numpy()
    close = np.isclose(img_gpu, img_cpu, rtol=1e-3, atol=1e-4).mean()
    rel_mean = abs(img_gpu.mean() - img_cpu.mean()) / img_cpu.mean()
    print(f"render parity {name} {kw['width']}x{kw['height']}x{kw['spp']}: "
          f"{close * 100:.2f}% of values within rtol 1e-3/atol 1e-4, mean "
          f"rel diff {rel_mean:.3g}, max |diff| "
          f"{np.abs(img_gpu - img_cpu).max():.3g}, "
          f"{(img_gpu == img_cpu).mean() * 100:.2f}% bit-equal")
    if not (np.isfinite(img_gpu).all() and close >= 0.99
            and rel_mean <= 1e-3):
        raise AssertionError(f"render of {name} on the card disagrees with "
                             "the CPU")


def png_pixels(data):
    """The [H, W, 3] pixels of an 8-bit RGB PNG (what `io.image.encode_png`
    writes), read by `io.image.decode_png` (every chunk's CRC checked);
    raises on anything else."""
    from pbrlab_tpu_torch.io.image import decode_png

    if data[12:16] != b"IHDR" or tuple(data[24:26]) != (8, 2):
        raise AssertionError(f"PNG is not 8-bit RGB: {data[:32]!r}")
    return decode_png(data)


def entry_phase(counters, scene_np, scene, names, card):
    """Phase 6: the user's entry points on the headline scene at seed 7,
    max_steps 12: the CLI's demo at 512x512x8 with the auto k_volume;
    `render_scan` at 256x256x4, k_volume 3, with its launches counted and
    against `render`; `render_scan` card vs CPU at 32x32x2; a
    `ProgressiveRenderer` at 512x512 behind a `PreviewServer`: each pass
    against `render_sample`, the 3-pass average against `render_scan`, an
    HTTP edit, the served PNG and a checkpoint round trip, all on the
    scene's device. Returns the scan's launch counts."""
    import contextlib
    import io
    import urllib.request

    from pbrlab_tpu_torch.app import cli
    from pbrlab_tpu_torch.app.viewer import PreviewServer
    from pbrlab_tpu_torch.render.integrator import (render, render_sample,
                                                    render_scan)
    from pbrlab_tpu_torch.render.graphs import Programs
    from pbrlab_tpu_torch.render.progressive import ProgressiveRenderer
    from pbrlab_tpu_torch.utils import log as plog
    from pbrlab_tpu_torch.utils.profiling import measure_sss_truncation

    steps = dict(max_steps=12)
    dev = scene["aabb_min"].device.type
    build = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "build")
    plog.get_logger()  # its handler keeps the real stderr
    with tempfile.TemporaryDirectory(prefix="entry_", dir=build) as tmp:
        out = os.path.join(tmp, "demo.png")
        err = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stderr(err):
            rc = cli.main(["demo", "--width", str(CLI_SIZE), "--height",
                           str(CLI_SIZE), "--spp", "8", "--max-steps", "12",
                           "--k-volume", "-1", "--device", dev, "--out",
                           out])
        wall = time.perf_counter() - t0
        with open(out, "rb") as f:
            data = f.read()
    for line in err.getvalue().splitlines():
        print(f"  cli: {line}")
    k = int(next(line.split()[1] for line in err.getvalue().splitlines()
                 if line.startswith("k_volume:")))
    frac = measure_sss_truncation(scene_np, 12, k_volume=k, device=dev)
    pix = png_pixels(data)
    print(f"entry cli: demo {CLI_SIZE}x{CLI_SIZE}x8 max_steps=12 "
          f"--k-volume -1 -> "
          f"k_volume {k} ({frac * 100:.2f}% of the 96x96 probe's SSS walks "
          f"truncated), rc {rc}, wall {wall:.3f} s (probe, render, PNG), "
          f"PNG {len(data)} bytes {pix.shape[1]}x{pix.shape[0]}, pixels "
          f"{pix.min()}-{pix.max()} ({card})")
    if rc != 0 or pix.shape != (CLI_SIZE, CLI_SIZE, 3) \
            or pix.min() == pix.max():
        raise AssertionError("the CLI demo did not write its image")

    for c in counters.values():
        for key in c:
            c[key] = 0
    programs = Programs()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    scan = render_scan(scene, SCAN_SIZE, SCAN_SIZE, SCAN_SPP, seed=SEED,
                       k_volume=3, programs=programs, **steps).cpu().numpy()
    scan_wall = time.perf_counter() - t0
    print(f"entry scan program: {program_line(programs)}, peak allocated "
          f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB ({card})")
    launches = {"v4.dual": counters["v4"]["dual"],
                "v4.single": counters["v4"]["single"],
                "v5.v5_dual": counters["v5"]["v5_dual"],
                "v5.v5": counters["v5"]["v5"]}
    counts = {f"{m}.{key}": v for m, c in counters.items()
              for key, v in c.items()}
    t0 = time.perf_counter()
    img = render(scene, SCAN_SIZE, SCAN_SIZE, SCAN_SPP, seed=SEED,
                 k_volume=3, **steps).cpu().numpy()
    render_wall = time.perf_counter() - t0
    equal = (scan == img).mean()
    print(f"entry scan: render_scan {SCAN_SIZE}x{SCAN_SIZE}x{SCAN_SPP} "
          f"k_volume=3 in {scan_wall:.3f} s, launches {counts}; render "
          f"(persistent lanes) in {render_wall:.3f} s; "
          f"{equal * 100:.4f}% of values bit-equal, max |diff| "
          f"{np.abs(scan - img).max():.3g}, mean {scan.mean():.5f} ({card})")
    if not all(launches.values()):
        raise AssertionError(f"the scan path missed a kernel: {counts}")
    if not (np.isfinite(scan).all() and scan.mean() > 0):
        raise AssertionError("the scan image is not finite and lit")
    if equal < 1.0:
        close = np.isclose(scan, img, rtol=1e-3, atol=1e-4).mean()
        rel = abs(scan.mean() - img.mean()) / img.mean()
        differ = scan != img
        largest = np.maximum(np.abs(scan), np.abs(img))[differ].max()
        print(f"entry scan: not bit-equal; {close * 100:.2f}% within rtol "
              f"1e-3/atol 1e-4, mean rel diff {rel:.3g}; {differ.sum()} "
              f"values differ, the largest of them {largest:.3g} (float32 "
              f"normals start at {np.finfo(np.float32).tiny:.3g})")
        if close < 0.99 or rel > 1e-3:
            raise AssertionError("render_scan disagrees with render")
    render_parity("cornellbox render_scan", scene_np, scene, fn=render_scan,
                  width=32, height=32, spp=2, k_volume=3, **steps)

    size = PROGRESSIVE_SIZE
    kw = dict(seed=SEED, k_volume=3, **steps)
    r = ProgressiveRenderer(scene, size, size, material_names=names, **kw)
    srv = PreviewServer(r, max_pass=8)
    port = srv.start(port=0)
    base = f"http://127.0.0.1:{port}"
    try:
        t0 = time.perf_counter()
        for i in range(3):
            prev = r.accum.copy()
            r.step()
            ref = render_sample(scene, size, size, i, **kw).cpu().numpy()
            if i == 0:  # the accumulator holds the pass itself
                same = np.array_equal(r.accum, ref)
            else:  # a fresh renderer resumed at pass i renders pass i
                r1 = ProgressiveRenderer(scene, size, size, **kw)
                r1.num_passes = i
                r1.step()
                same = (np.array_equal(r1.accum, ref)
                        and np.array_equal(r.accum, prev + ref))
            if not same:
                raise AssertionError(f"progressive pass {i} is not "
                                     f"render_sample(sample_id={i})")
        avg = r.average()
        want = render_scan(scene, size, size, 3, **kw).cpu().numpy()
        if not np.array_equal(avg, want):
            raise AssertionError("3 progressive passes are not "
                                 "render_scan(spp=3)")
        captured = captures(r.programs)
        urllib.request.urlopen(urllib.request.Request(
            base + "/edit", data=json.dumps(
                {"material": "Wall_White", "param": "base_color",
                 "value": [0.1, 0.9, 0.1]}).encode(), method="POST"),
            timeout=30).read()
        edited = r.step()
        if r.num_passes != 1 or np.array_equal(edited, avg):
            raise AssertionError("the HTTP edit did not reset the passes "
                                 "and change the image")
        if captures(r.programs) != captured:
            raise AssertionError("the edit made the renderer capture anew")
        served = png_pixels(urllib.request.urlopen(base + "/image.png",
                                                   timeout=30).read())
        if served.shape != (size, size, 3):
            raise AssertionError(f"served PNG is {served.shape}")
        ckpt = os.path.join(build, "entry_checkpoint.npz")
        r.save_checkpoint(ckpt)
        r2 = ProgressiveRenderer(scene, size, size, **kw)
        r2.load_checkpoint(ckpt)
        os.remove(ckpt)
        if not (r2.num_passes == 1 and np.array_equal(r2.accum, r.accum)):
            raise AssertionError("checkpoint round trip failed")
        wall = time.perf_counter() - t0
    finally:
        srv.stop()
    print(f"entry progressive: {size}x{size} k_volume=3, 3 passes each "
          f"bit-equal to render_sample, their average bit-equal to "
          f"render_scan(spp=3), an HTTP /edit reset to pass 1 with a new "
          f"image, /image.png {size}x{size}, checkpoint round trip; "
          f"pass times {[round(t, 3) for t in r.pass_times]} s; phase "
          f"wall {wall:.3f} s; the renderer's program: "
          f"{program_line(r.programs)}, unchanged by the edit ({card})")
    return launches


def textured_quad_scene():
    """An emissive quad over a floor quad textured with a 4x4 ramp
    (tests/torch_scenes.py `textured_scene`, the JAX package's
    tests/test_gradients.py:121-150), committed by the port."""
    from pbrlab_tpu_torch.geometry.mesh import TriangleMesh
    from pbrlab_tpu_torch.scene.scene import SceneBuilder, commit

    b = SceneBuilder()
    tex = np.zeros((4, 4, 3), np.float32)
    tex[:, :, 0] = np.linspace(0.2, 0.9, 4)[None, :]
    tex[:, :, 1] = 0.5
    tex[:, :, 2] = np.linspace(0.9, 0.2, 4)[:, None]
    mat = b.materials.add_principled(
        "floor", base_color_tex_id=b.add_texture(tex, "checker"),
        roughness=0.8)
    lmat = b.materials.add_principled("light", base_color=(0.0, 0.0, 0.0))
    faces = np.asarray([[0, 1, 2], [0, 2, 3]], np.int32)

    def quad(y, s, m):
        verts = np.asarray([[-s, y, -s], [s, y, -s], [s, y, s], [-s, y, s]],
                           np.float32)
        uv = np.asarray([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32)
        return TriangleMesh(verts, faces,
                            material_ids=np.full((2,), m, np.int32),
                            texcoords=uv, texcoord_idx=faces)

    lid = b.add_area_light_param((6.0, 6.0, 6.0))
    b.add_instance([quad(0.0, 1.0, mat), quad(1.5, 0.5, lmat)],
                   light_ids=[None, np.full((2,), lid, np.int32)])
    return commit(b.build())


def with_leaves(scene, extra=()):
    """(scene copy, {key: leaf}): the train step's eight leaves (six
    material columns, face_emission, texture_atlas) and the material
    columns `extra` as fresh tensors that require grad. The scene has no
    fat tables: `render_lanes` builds them from the leaves."""
    from pbrlab_tpu_torch.parallel.sharding import GRAD_KEYS, SCENE_KEYS

    s = dict(scene)
    mats = s["materials"] = dict(scene["materials"])
    leaves = {}
    for key in GRAD_KEYS + SCENE_KEYS + tuple(extra):
        src = mats if key in mats else s
        leaves[key] = src[key] = src[key].detach().clone().requires_grad_()
    return s, leaves


def grad_pass(scene, size, max_steps, k_volume, counters=None,
              programs=None, tape=False, extra=()):
    """The MSE of `render_lanes(remat=True)` (size^2, one sample, seed 7)
    against the same render at base_color x 0.5, and its backward to the
    eight leaves and the material columns `extra`: through the compiled
    program kept in `programs` (None: one for the call), or with `tape`
    through the `torch.utils.checkpoint` tape it replaced. Returns {"grads": {key: gradient or None}, "fwd",
    "bwd": walls, "img", "loss", "peak": peak allocated bytes from the
    forward on, "fwd_counts", "counts": launch counts forward and after
    the backward (when `counters` is given)}."""
    from pbrlab_tpu_torch.render.integrator import (_render_lanes_tape,
                                                    render_lanes)
    from pbrlab_tpu_torch.scene.scene import build_fat_tables

    dev = scene["aabb_min"].device
    kw = dict(max_steps=max_steps, k_volume=k_volume)
    dim = dict(scene)
    dim["materials"] = {**scene["materials"], "base_color":
                        scene["materials"]["base_color"] * 0.5}
    with torch.no_grad():
        target = render_lanes(dim, size, size, 0, SEED, **kw)
    s, leaves = with_leaves(scene, extra)

    def counts():
        return {f"{m}.{k}": v for m, c in (counters or {}).items()
                for k, v in c.items()}

    for c in (counters or {}).values():
        for key in c:
            c[key] = 0
    sync(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    if tape:
        img = _render_lanes_tape(build_fat_tables(s), size, size, 0, SEED,
                                 max_steps, None, True, 2, k_volume, None)
    else:
        img = render_lanes(s, size, size, 0, SEED, remat=True,
                           programs=programs, **kw)
    loss = ((img - target) ** 2).mean()
    sync(dev)
    fwd = time.perf_counter() - t0
    fwd_counts = counts()
    t0 = time.perf_counter()
    loss.backward()
    sync(dev)
    bwd = time.perf_counter() - t0
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else None)
    return {"grads": {k: None if v.grad is None else v.grad.detach()
                      for k, v in leaves.items()},
            "fwd": fwd, "bwd": bwd, "img": img.detach(),
            "loss": loss.detach(), "peak": peak, "fwd_counts": fwd_counts,
            "counts": counts()}


def grads_agree(name, got, want, band, card):
    """Each leaf's gradient within `band` of the largest `want` entry
    (+1e-6), read on both sides or on neither, else raise."""
    worst = {}
    for key in want:
        if got[key] is None or want[key] is None:
            if (got[key] is None) != (want[key] is None):
                raise AssertionError(f"{name} {key}: read on one side only")
            continue
        g, w = got[key].cpu().numpy(), want[key].cpu().numpy()
        scale = float(np.abs(w).max())
        worst[key] = (float(np.abs(g - w).max() / max(scale, 1e-30)), scale)
        if not (np.abs(g - w) <= band * scale + 1e-6).all():
            raise AssertionError(f"{name} {key} gradient off the band "
                                 f"(max |diff| / max |ref| "
                                 f"{worst[key][0]:.3g})")
    print(f"{name}: (max |diff| / max |ref|, max |ref|) per leaf {worst} "
          f"(band {band} of max |ref|, + 1e-6) ({card})")


def captures(programs):
    """Graphs captured by the programs of a `Programs`."""
    return sum(len(getattr(p.runner, "graphs", ()))
               for p in programs.programs.values())


def program_line(programs):
    """Each program's phases: nodes, capture + instantiate seconds,
    replays (a graph runner's), as one line."""
    parts = []
    for prog in programs.programs.values():
        runner = prog.runner
        if not hasattr(runner, "graphs"):
            continue
        nodes = runner.nodes()
        parts.append(", ".join(
            f"{ph} {nodes.get(ph)} nodes / "
            f"{st['capture_s'] + st['instantiate_s']:.3f} s / "
            f"{st['replays']} replays" for ph, st in runner.stats.items()))
    return "; ".join(parts) or "no graphs"


def checked_runner():
    """A `GraphRunner` class whose every phase (warm-up, capture, replay)
    runs under `torch.cuda.set_sync_debug_mode("error")`: a phase that
    synchronised raises (the host's reads sit between phases)."""
    from pbrlab_tpu_torch.render import graphs

    class Checked(graphs.GraphRunner):
        def run(self, name, phase):
            torch.cuda.set_sync_debug_mode("error")
            try:
                super().run(name, phase)
            finally:
                torch.cuda.set_sync_debug_mode(0)

    return Checked


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def images_agree(name, got, want, card):
    """Bit-equal but for denormal sums (the framebuffer's index_add_
    flushes them on CUDA, PERF.md section 6), else raise."""
    differ = got != want
    largest = (np.maximum(np.abs(got), np.abs(want))[differ].max()
               if differ.any() else 0.0)
    print(f"{name}: {(~differ).mean() * 100:.4f}% of values bit-equal, "
          f"{differ.sum()} differ, the largest of them {largest:.3g}, mean "
          f"{want.mean():.5f} ({card})")
    if not (np.isfinite(got).all() and want.mean() > 0
            and largest < np.finfo(np.float32).tiny):
        raise AssertionError(f"{name} differs beyond denormals")


def training_phase(counters, scene_np, scene, card):
    """Phase 7: the gradient pass of the cornellbox at GRAD_SIZE^2 x 1
    (`render_lanes(remat=True)`, max_steps 12, k_volume 3) with its
    walls, peak memory and launches forward and after the backward; its
    gradients on the card against the CPU at 32^2; the emission gradient
    against central differences at 64^2; `render_sharded` on two shards
    of the card against `render`; four train steps on the textured quad
    scene over two shards, run twice to compare their losses and atlases
    bit for bit (ROADMAP C12); the C12 gradient passes
    (`reproducibility`); two ranks on the card (gloo) against `render`.
    Returns the gradient pass's launch counts after the backward."""
    from pbrlab_tpu_torch.parallel import sharding
    from pbrlab_tpu_torch.render.graphs import Programs
    from pbrlab_tpu_torch.render.integrator import render, render_lanes
    from pbrlab_tpu_torch.scene.scene import scene_from_numpy

    dev = scene["aabb_min"].device
    base_mem = torch.cuda.memory_allocated(dev)
    programs = Programs()
    graphed = grad_pass(scene, GRAD_SIZE, counters=counters,
                        programs=programs, **SETTINGS)
    grads, counts, fwd_counts = (graphed["grads"], graphed["counts"],
                                 graphed["fwd_counts"])
    norms = {k: None if g is None else float(g.abs().max())
             for k, g in grads.items()}
    line = program_line(programs)
    del programs  # the eager pass's peak without the program's buffers
    torch.cuda.empty_cache()
    tape = grad_pass(scene, GRAD_SIZE, counters=counters, tape=True,
                     **SETTINGS)
    for kind, rec in (("graphed", graphed), ("eager", tape)):
        peak = rec["peak"]
        print(f"grad pass {kind}: render_lanes(remat=True) {GRAD_SIZE}x"
              f"{GRAD_SIZE}x1 max_steps={SETTINGS['max_steps']} k_volume="
              f"{SETTINGS['k_volume']}, MSE to base_color x 0.5: forward "
              f"{rec['fwd']:.3f} s, backward {rec['bwd']:.3f} s, peak "
              f"allocated {peak / 2**30:.3f} GiB "
              f"({(peak - base_mem) / 2**30:.3f} GiB above the "
              f"{base_mem / 2**30:.3f} GiB of the scenes), "
              f"launches forward {rec['fwd_counts']}, after the backward "
              f"{rec['counts']}; max |grad| "
              f"{norms if kind == 'graphed' else ''} ({card})")
    print(f"grad pass graphed program: {line} ({card})")
    ratio = graphed["peak"] / tape["peak"]
    same = (torch.equal(graphed["img"], tape["img"])
            and torch.equal(graphed["loss"], tape["loss"]))
    print(f"grad pass graphed vs eager: image and loss bit-equal {same}, "
          f"launches equal {graphed['counts'] == tape['counts']}, peak "
          f"allocated {ratio:.3f}x ({card})")
    if not same or graphed["counts"] != tape["counts"] or ratio > 1.5:
        raise AssertionError("the graphed gradient pass differs from the "
                             "eager one or holds over 1.5x its memory")
    grads_agree("grad pass graphed vs eager gradients", grads,
                tape["grads"], GRAD_BAND, card)
    bad = [k for k, g in grads.items()
           if g is not None and not torch.isfinite(g).all()]
    if bad or not norms["base_color"] or not norms["face_emission"]:
        raise AssertionError(f"gradients not finite ({bad}) or zero: {norms}")
    if counts["v4.dual"] != 2 * fwd_counts["v4.dual"]:
        raise AssertionError(f"the recompute did not relaunch dense_v4 dual "
                             f"once a depth: {fwd_counts} -> {counts}")
    if not all(counts[k] for k in ("v4.dual", "v4.single", "v5.v5_dual",
                                   "v5.v5")):
        raise AssertionError(f"the gradient pass missed a kernel: {counts}")

    t0 = time.perf_counter()
    size, steps = GRAD_PARITY["size"], GRAD_PARITY["max_steps"]
    gpu = grad_pass(scene, size, steps, SETTINGS["k_volume"])["grads"]
    cpu = grad_pass(scene_from_numpy(scene_np, "cpu"), size, steps,
                    SETTINGS["k_volume"])["grads"]
    grads_agree(f"grad parity: card vs CPU {size}x{size}x1 max_steps="
                f"{steps}, {time.perf_counter() - t0:.3f} s", gpu, cpu,
                GRAD_BAND, card)

    t0 = time.perf_counter()
    kw = dict(seed=SEED, **SETTINGS)
    x = torch.tensor(1.0, device=dev, requires_grad=True)

    def fd_loss(scale):  # the graphed gradient pass; no grad: the forward
        s = {**scene, "face_emission": scene["face_emission"] * scale}
        return render_lanes(s, FD_SIZE, FD_SIZE, 0, remat=True,
                            **kw).sum()

    g = float(torch.autograd.grad(fd_loss(x), [x])[0])
    with torch.no_grad():
        fd = (float(fd_loss(torch.tensor(1.0 + FD_EPS, device=dev)))
              - float(fd_loss(torch.tensor(1.0 - FD_EPS, device=dev)))) / (
                  2 * FD_EPS)
    print(f"emission FD: {FD_SIZE}x{FD_SIZE}x1 d sum(img) / d scale "
          f"(render_lanes(remat=True), graphed): "
          f"autograd {g:.6g}, central difference (eps {FD_EPS}) {fd:.6g}, "
          f"rel diff {abs(g - fd) / abs(fd):.3g} (rtol 1e-2), "
          f"{time.perf_counter() - t0:.3f} s ({card})")
    if not (np.isfinite(g) and abs(g - fd) <= 1e-2 * abs(fd)):
        raise AssertionError("emission gradient disagrees with FD")

    mesh = sharding.make_mesh(2, dev.type)
    t0 = time.perf_counter()
    shard = sharding.render_sharded(scene, SHARD_SIZE, SHARD_SIZE, SHARD_SPP,
                                    mesh, **kw).cpu().numpy()
    wall = time.perf_counter() - t0
    single = render(scene, SHARD_SIZE, SHARD_SIZE, SHARD_SPP,
                    **kw).cpu().numpy()
    images_agree(f"sharded render {SHARD_SIZE}x{SHARD_SIZE}x{SHARD_SPP} on "
                 f"{mesh} in {wall:.3f} s vs render", shard, single, card)

    quad = scene_from_numpy(textured_quad_scene(), dev)
    dim = {**quad, "texture_atlas": quad["texture_atlas"] * 0.5}
    target = sharding.render_sharded(dim, TRAIN_SIZE, TRAIN_SIZE, 1, mesh,
                                     max_steps=4)
    runs = []
    for run in range(2):  # the second run: C12, the same steps again
        t0 = time.perf_counter()
        # the loss sums squares over the pixels: the 8x8 test's lr of 0.2
        # scaled to the pixel count keeps its step
        step = sharding.train_step_builder(
            TRAIN_SIZE, TRAIN_SIZE, 1, mesh, max_steps=4,
            lr=0.2 * 64 / TRAIN_SIZE ** 2)
        s, losses = quad, []
        for _ in range(TRAIN_STEPS):
            loss, s = step(s, target)
            losses.append(float(loss))
        runs.append((losses, s["texture_atlas"]))
        moved = float((s["texture_atlas"] - quad["texture_atlas"]).abs()
                      .max())
        print(f"train step, run {run + 1}: textured quad {TRAIN_SIZE}x"
              f"{TRAIN_SIZE}x1 towards the atlas x 0.5, {TRAIN_STEPS} steps "
              f"on {mesh}: losses {losses}, atlas moved {moved:.4g}, "
              f"{time.perf_counter() - t0:.3f} s; its kept program: "
              f"{program_line(step.programs)} ({card})")
        if not (losses[-1] < 0.9 * losses[0] and moved > 1e-4):
            raise AssertionError("the train step did not lower the loss")
    (l1, a1), (l2, a2) = runs
    print(f"C12 train step reproducibility: two runs of {TRAIN_STEPS} steps "
          f"from the same inputs: losses bit-equal {l1 == l2} ({l1} / {l2}),"
          f" final atlas bit-equal {torch.equal(a1, a2)}, max |diff| "
          f"{float((a1 - a2).abs().max()):.3g} ({card})")

    reproducibility(scene, card)

    t0 = time.perf_counter()
    got = two_ranks(dev.type)
    wall = time.perf_counter() - t0
    want = render(scene, DIST_SIZE, DIST_SIZE, DIST_SPP, **kw).cpu().numpy()
    images_agree(f"two ranks (gloo) render_distributed {DIST_SIZE}x"
                 f"{DIST_SIZE}x{DIST_SPP} in {wall:.3f} s (processes "
                 f"included) vs render", got, want, card)
    return counts


def reproducibility(scene, card):
    """C12: the cornellbox's gradient pass at REPRO_SIZE^2 x 1 twice, each
    through a program of its own, from the same inputs. Prints whether
    the image, the loss and each leaf's gradient are bit-equal, and if a
    gradient is not, its largest difference over its largest entry (the
    fat tables' gradients are summed by index_add_, whose atomics on the
    card add in no fixed order). A measurement: only a non-finite value
    fails."""
    from pbrlab_tpu_torch.render.graphs import Programs

    a, b = (grad_pass(scene, REPRO_SIZE, programs=Programs(), **SETTINGS)
            for _ in range(2))
    rel, equal = {}, {}
    for key, g in a["grads"].items():
        if g is None:
            continue
        h = b["grads"][key]
        if not (torch.isfinite(g).all() and torch.isfinite(h).all()):
            raise AssertionError(f"C12: the {key} gradient is not finite")
        equal[key] = torch.equal(g, h)
        rel[key] = float((g - h).abs().max() / g.abs().max().clamp(
            min=1e-30))
    print(f"C12 gradient reproducibility: the cornellbox pass {REPRO_SIZE}x"
          f"{REPRO_SIZE}x1 twice: image bit-equal "
          f"{torch.equal(a['img'], b['img'])}, loss bit-equal "
          f"{torch.equal(a['loss'], b['loss'])}; leaves bit-equal "
          f"{sum(equal.values())} of {len(equal)} {equal}; max |diff| / "
          f"max |grad| per leaf {rel} ({card})")


def hair_grad_phase(counters, scene_np, scene, card):
    """Phase 7, hair: the gradient pass of the hair scene at HAIR_GRAD_SIZE^2
    x 1 (`render_lanes(remat=True)`, max_steps 12, k_volume 3) to the eight
    leaves and HAIR_GRAD_KEYS, twice through one kept program (graphed:
    the first pass captures, the second replays), with its walls, peak
    memory and launches (dense_curve's included); the replayed pass's
    gradients against the CPU's within GRAD_BAND of its largest entry."""
    from pbrlab_tpu_torch.render.graphs import Programs
    from pbrlab_tpu_torch.scene.scene import scene_from_numpy

    programs = Programs()
    passes = [grad_pass(scene, HAIR_GRAD_SIZE, counters=counters,
                        programs=programs, extra=HAIR_GRAD_KEYS, **SETTINGS)
              for _ in range(2)]
    t0 = time.perf_counter()
    cpu = grad_pass(scene_from_numpy(scene_np, "cpu"), HAIR_GRAD_SIZE,
                    extra=HAIR_GRAD_KEYS, **SETTINGS)
    cpu_s = time.perf_counter() - t0
    for i, rec in enumerate(passes):
        print(f"hair grad pass {i + 1} ({'captures' if i == 0 else 'replay'}"
              f"): render_lanes(remat=True) {HAIR_GRAD_SIZE}x{HAIR_GRAD_SIZE}"
              f"x1 max_steps={SETTINGS['max_steps']} k_volume="
              f"{SETTINGS['k_volume']}: forward {rec['fwd']:.3f} s, backward "
              f"{rec['bwd']:.3f} s, peak allocated "
              f"{rec['peak'] / 2**30:.3f} GiB, launches forward "
              f"{rec['fwd_counts']}, after the backward {rec['counts']} "
              f"({card})")
    print(f"hair grad pass program: {program_line(programs)}; the CPU's "
          f"pass {cpu_s:.1f} s ({card})")
    got = passes[1]
    counts = got["counts"]
    if not all(counts[k] for k in ("v4.dual", "curve.closest",
                                   "curve.any_hit")):
        raise AssertionError(f"the hair gradient pass missed a kernel: "
                             f"{counts}")
    for key in ("base_color", "face_emission") + HAIR_GRAD_KEYS:
        g = got["grads"][key]
        if not (torch.isfinite(g).all() and g.abs().max() > 0):
            raise AssertionError(f"hair gradient {key} not finite or zero")
    if not torch.equal(passes[0]["img"], got["img"]):
        raise AssertionError("the replayed hair pass's image differs")
    grads_agree(f"hair grad pass {HAIR_GRAD_SIZE}x{HAIR_GRAD_SIZE}x1: card "
                "(replayed) vs CPU", got["grads"], cpu["grads"], GRAD_BAND,
                card)


def two_ranks(device):
    """render_distributed of the cornellbox by two processes of this
    script on `device` (gloo); rank 0's image."""
    import socket

    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    port = sock.getsockname()[1]
    sock.close()
    build = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "build")
    os.makedirs(build, exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="ranks_", dir=build) as tmp:
        out = os.path.join(tmp, "img.npy")
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--rank", str(r),
             "--port", str(port), "--device", device, "--out", out],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(2)]
        try:
            logs = [p.communicate(timeout=300)[0] for p in procs]
        finally:
            for p in procs:
                p.kill()
                p.wait()
        for r, (p, log) in enumerate(zip(procs, logs)):
            if p.returncode != 0:
                raise AssertionError(f"rank {r} failed:\n{log}")
        return np.load(out)


def rank_main(argv):
    """One rank of `two_ranks`: joins the gloo group on 127.0.0.1:port,
    renders its half of the cornellbox with render_distributed on its
    global_mesh device, rank 0 saves the image."""
    import argparse

    import torch.distributed as dist

    from pbrlab_tpu_torch.parallel.distributed import (global_mesh,
                                                       init_distributed,
                                                       render_distributed)
    from pbrlab_tpu_torch.scene.demo import build_demo_scene

    ap = argparse.ArgumentParser()
    for name in ("--rank", "--port"):
        ap.add_argument(name, type=int, required=True)
    ap.add_argument("--device", required=True)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    init_distributed(f"127.0.0.1:{args.port}", 2, args.rank, backend="gloo")
    try:
        scene_np, _ = build_demo_scene(**PATHS["cornellbox"][0])
        img = render_distributed(scene_np, DIST_SIZE, DIST_SIZE, DIST_SPP,
                                 mesh=global_mesh(args.device), seed=SEED,
                                 **SETTINGS)
        if args.rank == 0:
            np.save(args.out, img)
    finally:
        dist.destroy_process_group()
    return 0


def path_scenes(dev):
    """The six paths' scenes (commit on the host, tables to `dev`) and
    the file path's -> (numpy scenes, scenes, material names, file numpy
    scene, file scene)."""
    from pbrlab_tpu_torch.scene.demo import build_demo_scene
    from pbrlab_tpu_torch.scene.instanced import build_instanced
    from pbrlab_tpu_torch.scene.scene import scene_from_numpy

    scenes_np, scenes, names = {}, {}, {}
    for name, (kw, _, _) in PATHS.items():
        t0 = time.perf_counter()
        if kw is None:
            scenes_np[name] = build_instanced(instanced_builder())
            scenes[name] = scene_from_numpy(scenes_np[name], dev)
            print(f"scene {name}: {instanced_summary(scenes_np[name])}, "
                  f"built in {time.perf_counter() - t0:.2f} s")
            continue
        scenes_np[name], builder = build_demo_scene(**kw)
        names[name] = list(builder.materials.names)
        scenes[name] = scene_from_numpy(scenes_np[name], dev)
        s = scenes_np[name]
        print(f"scene {name} {kw}: {int((s['face_area'] > 0).sum())} "
              f"faces, {s['dense_tris_v4'].shape[1]} slots, "
              f"{s['dense_cluster_aabb_v4'].shape[1]} clusters, "
              f"{s['v5_node_aabb'].shape[1]} nodes, "
              f"{s['dense_seg_aabb'].shape[1]} curve clusters of "
              f"{s['curve_pts'].shape[0]} segments, tables "
              f"{sorted(k for k in s if k.startswith(('dense_tris', 'v5s')))}"
              f", built in {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    file_np = load_file_scene()
    file_scene = scene_from_numpy(file_np, dev)
    print(f"scene file (write_cornellbox + load_scene_json): "
          f"{int((file_np['face_area'] > 0).sum())} faces, "
          f"{len(file_np['emissive_faces'])} emissive in 1 light group, "
          f"{file_np['materials']['kind'].shape[0]} materials, legacy "
          f"tables {file_np['dense_tris'].shape[1]} columns in "
          f"{file_np['dense_cluster_aabb'].shape[1]} clusters, written, "
          f"loaded and committed in {time.perf_counter() - t0:.2f} s")
    return scenes_np, scenes, names, file_np, file_scene


def graphs_only():
    """Phase 9 alone, after the library's build and the paths' scenes:
    python3 -c 'import sys, chip_smoke; sys.exit(chip_smoke.graphs_only())'
    """
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from pbrlab_tpu_torch.ops import cuda_lib

    card = card_line()
    print(f"card: {card}")
    t0 = time.perf_counter()
    path, _ = cuda_lib.build_library()
    print(f"build: {path.name} in {time.perf_counter() - t0:.2f} s")
    _, scenes, names, _, file_scene = path_scenes(torch.device("cuda:0"))
    t0 = time.perf_counter()
    graph_phase(scenes, file_scene, card)
    scan_graph_phase(scenes, file_scene, names, card)
    print(f"phase 9 took {time.perf_counter() - t0:.1f} s")
    print(card)
    return 0


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    if len(sys.argv) > 1:  # a rank of phase 7's two-rank render
        return rank_main(sys.argv[1:])
    from pbrlab_tpu_torch.ops import (cuda_lib, dense, dense_curve, dense_v2,
                                      dense_v3, dense_v4, dense_v5, dense_v5i)
    from pbrlab_tpu_torch.render import graphs
    from pbrlab_tpu_torch.render.integrator import render_lanes_wavefront
    from pbrlab_tpu_torch.scene.instanced import build_instanced
    from pbrlab_tpu_torch.scene.scene import scene_from_numpy

    dev = torch.device("cuda:0")
    card = card_line()
    t_start = time.perf_counter()
    # phase 1: card
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")

    # phase 2: build every csrc/*.cu into one library (one nvcc per source)
    t0 = time.perf_counter()
    path, log = cuda_lib.build_library()
    print(f"build: {path.name} in {time.perf_counter() - t0:.2f} s")
    for line in log.splitlines():
        if line.startswith("==") or "registers" in line or "spill" in line:
            print("  ptxas:", line.strip())

    scenes_np, scenes, names, file_np, file_scene = path_scenes(dev)

    # phase 3: kernel parity and times at each path's shapes
    rng = np.random.default_rng(SEED)
    rays = {name: path_rays(scenes[name], dev, rng, INSTANCED_FRAME
                            if name == "instanced" else CORNELL_FRAME)
            for name in PATHS}
    rec = v4_phase(dense_v4, scenes["cornellbox"], *rays["cornellbox"], card)
    rec.update(v5_phase(dense_v5, scenes["mid"], scenes["large"],
                        scenes["xl"], rays["mid"], rays["large"],
                        rays["xl"], card))
    rec.update(curve_phase(dense_curve, scenes["hair"], rays["hair"], card))
    rec.update(v5i_phase(dense_v5i, scenes["instanced"], rays["instanced"],
                         card))
    rec.update(legacy_phase({"v1": dense, "v2": dense_v2, "v3": dense_v3},
                            file_scene, path_rays(file_scene, dev, rng),
                            card))

    # phase 4: render parity, card (kernels) vs CPU (plain versions)
    render_parity("cornellbox", scenes_np["cornellbox"], scenes["cornellbox"],
                  width=32, height=32, spp=4, **SETTINGS)
    render_parity("mid", scenes_np["mid"], scenes["mid"], width=32,
                  height=32, spp=2, **SETTINGS)
    render_parity("large", scenes_np["large"], scenes["large"], width=32,
                  height=32, spp=2, **SETTINGS)
    render_parity("xl", scenes_np["xl"], scenes["xl"], width=32, height=32,
                  spp=2, **SETTINGS)
    render_parity("hair", scenes_np["hair"], scenes["hair"], width=32,
                  height=32, spp=2, **SETTINGS)
    cut = build_instanced(instanced_builder(**PARITY_INSTANCED))
    print(f"instanced parity scene {PARITY_INSTANCED}: "
          f"{instanced_summary(cut)}")
    render_parity("instanced", cut, scene_from_numpy(cut, dev), width=32,
                  height=32, spp=2, **SETTINGS)
    for backend in FILE_RENDERS:
        render_parity(f"file {backend}", file_np, file_scene, width=32,
                      height=32, spp=4, tri_backend=backend, **SETTINGS)
    print(f"phases 1-4 took {time.perf_counter() - t_start:.1f} s")

    # phase 5: the seven paths (the file path twice), each render with its
    # launches counted
    expect = {"cornellbox": (("v4", "dual"), ("v4", "single")),
              "mid": (("v5", "v5_dual"), ("v5", "v5")),
              "large": (("v5", "v5l"),),
              "xl": (("v5", "v5l"),),
              "hair": (("v4", "dual"), ("curve", "closest"),
                       ("curve", "any_hit")),
              "instanced": (("v5i", "closest"), ("v5i", "any_hit")),
              "file dense3": (("v3", "closest"), ("v3", "any_hit")),
              "file dense": (("v2", "closest"), ("v2", "any_hit"))}
    counters = graphs.COUNTERS  # every kernel wrapper's, by module
    renders = [(name, scenes[name], size, spp, None)
               for name, (_, size, spp) in PATHS.items()]
    renders += [(f"file {backend}", file_scene, size, spp, backend)
                for backend, (size, spp) in FILE_RENDERS.items()]
    launches, all_counts = {}, {}
    for name, scene, size, spp, backend in renders:
        for c in counters.values():
            for k in c:
                c[k] = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        total, iters = render_lanes_wavefront(
            scene, size, size, spp, seed=SEED, return_iters=True,
            tri_backend=backend, **SETTINGS)
        img = (total.reshape(size, size, 3) / spp).cpu().numpy()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2**20
        counts = {f"{m}.{k}": v for m, c in counters.items()
                  for k, v in c.items()}
        all_counts[name] = counts
        launches[name] = {f"{m}.{k}": counters[m][k]
                          for m, k in expect[name]}
        print(f"path {name}: render {size}x{size}x{spp} max_steps="
              f"{SETTINGS['max_steps']} k_volume={SETTINGS['k_volume']} in "
              f"{wall:.3f} s, {iters} sub-iterations, launches {counts}, "
              f"mean {img.mean():.5f}, {size * size * spp / wall / 1e6:.4f} "
              f"M camera samples/s, peak allocated {peak:.1f} MiB ({card})")
        if not (np.isfinite(img).all() and (img >= 0).all()
                and img.mean() > 0):
            raise AssertionError(f"{name} image is not finite, "
                                 "non-negative, lit")
        if not all(launches[name].values()):
            raise AssertionError(f"{name} path missed a kernel: {counts}")
        if backend and any(counters[m][k] for m in ("v4", "v5", "v5i")
                           for k in counters[m]):
            raise AssertionError(f"{name}: a trace left the forced "
                                 f"backend: {counts}")
    print(f"phases 1-5 took {time.perf_counter() - t_start:.1f} s")

    # phase 6: the entry points (CLI, scan path, progressive + server)
    t0 = time.perf_counter()
    scan = entry_phase(counters, scenes_np["cornellbox"],
                       scenes["cornellbox"], names["cornellbox"], card)
    print(f"phase 6 took {time.perf_counter() - t0:.1f} s")

    # phase 7: the training and parallel paths
    t0 = time.perf_counter()
    grad = training_phase(counters, scenes_np["cornellbox"],
                          scenes["cornellbox"], card)
    hair_grad_phase(counters, scenes_np["hair"], scenes["hair"], card)
    print(f"phase 7 took {time.perf_counter() - t0:.1f} s")

    # phase 8: the threaded-BVH backend (tri_backend="bvh")
    t0 = time.perf_counter()
    bvh_rec, bvh_launches = bvh_phase(counters, scenes_np, scenes, rays,
                                      card)
    print(f"phase 8 took {time.perf_counter() - t0:.1f} s")

    # phase 9: the render loop's CUDA graphs against the eager loop
    t0 = time.perf_counter()
    graph_phase(scenes, file_scene, card)
    scan_graph_phase(scenes, file_scene, names, card)
    print(f"phase 9 took {time.perf_counter() - t0:.1f} s")
    print(f"all phases took {time.perf_counter() - t_start:.1f} s")
    # v1 is on no render path, in JAX as here: its row carries the launches
    # that phase 5's renders made, which must be none
    v1_launches = sum(c["v1.closest"] + c["v1.any_hit"]
                      for c in all_counts.values())
    if v1_launches:
        raise AssertionError(f"a render launched dense_v1_trace "
                             f"{v1_launches} times: {all_counts}")

    v4_src = "pbrlab_tpu_torch/csrc/dense_v4.cu"
    v5_src = "pbrlab_tpu_torch/csrc/dense_v5.cu"
    v4_py = "pbrlab_tpu/ops/pallas/dense_v4.py"
    v5_py = "pbrlab_tpu/ops/pallas/dense_v5.py"
    hair, inst = launches["hair"], launches["instanced"]
    # the gradient pass's kernels (phase 7) add their forward and backward
    # launches to the paths' counts
    rows = [("dense_v4_trace_dual", v4_src, f"{v4_py}:248",
             launches["cornellbox"]["v4.dual"] + grad["v4.dual"],
             rec["dual"]),
            ("dense_v4_trace", v4_src, f"{v4_py}:115",
             launches["cornellbox"]["v4.single"] + grad["v4.single"],
             rec["single"]),
            ("dense_v5_trace_dual", v5_src, f"{v5_py}:357",
             launches["mid"]["v5.v5_dual"] + grad["v5.v5_dual"],
             rec["v5_dual"]),
            ("dense_v5_trace", v5_src, f"{v5_py}:134",
             launches["mid"]["v5.v5"] + grad["v5.v5"], rec["v5"]),
            ("dense_v5l_trace", v5_src, f"{v5_py}:646",
             launches["large"]["v5.v5l"] + launches["xl"]["v5.v5l"],
             rec["v5l"]),
            ("dense_curve_trace", "pbrlab_tpu_torch/csrc/dense_curve.cu",
             "pbrlab_tpu/ops/pallas/dense_curve.py:103",
             hair["curve.closest"] + hair["curve.any_hit"], rec["curve"]),
            ("dense_v5i_trace", "pbrlab_tpu_torch/csrc/dense_v5i.cu",
             "pbrlab_tpu/ops/pallas/dense_v5i.py:66",
             inst["v5i.closest"] + inst["v5i.any_hit"], rec["v5i"])]
    legacy_src = "pbrlab_tpu_torch/csrc/dense_legacy.cu"
    f3, f2 = launches["file dense3"], launches["file dense"]
    rows += [("dense_v3_trace", legacy_src,
              "pbrlab_tpu/ops/pallas/dense_v3.py:56",
              f3["v3.closest"] + f3["v3.any_hit"], rec["v3"]),
             ("dense_v2_trace", legacy_src,
              "pbrlab_tpu/ops/pallas/dense_v2.py:36",
              f2["v2.closest"] + f2["v2.any_hit"], rec["v2"]),
             ("dense_v1_trace", legacy_src,
              "pbrlab_tpu/ops/pallas/dense.py:112", v1_launches, rec["v1"])]
    bc, bh = bvh_launches["cornellbox"], bvh_launches["hair"]
    rows += [("bvh_trace", "pbrlab_tpu_torch/csrc/bvh_walk.cu",
              "pbrlab_tpu/ops/intersect.py:133",
              bc["bvh_closest"] + bc["bvh_any_hit"] + bh["bvh_closest"]
              + bh["bvh_any_hit"], bvh_rec["bvh"]),
             ("curve_bvh_trace", "pbrlab_tpu_torch/csrc/bvh_walk.cu",
              "pbrlab_tpu/ops/curves.py:108",
              bh["curve_closest"] + bh["curve_any_hit"],
              bvh_rec["curve_bvh"])]
    record = {"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": n, "max_abs_err": r["max_abs_err"], "ms": r["ms"],
         "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
         "bound_by": r["bound_by"], "library_ms": None}
        for name, src, rep, n, r in rows]}
    sparse = {name: all_counts[name]["v5.v5"]
              for name in ("cornellbox", "hair")}
    row = {k["name"]: k for k in record["kernels"]}
    row["dense_v5_trace"]["note"] = (
        f"launches: the mid path's; the unwindowed volume substeps of the "
        f"dense4 scenes add {sparse['cornellbox']} (cornellbox) and "
        f"{sparse['hair']} (hair)")
    scan_rows = {"dense_v4_trace_dual": "v4.dual",
                 "dense_v4_trace": "v4.single",
                 "dense_v5_trace_dual": "v5.v5_dual",
                 "dense_v5_trace": "v5.v5"}
    for name, key in scan_rows.items():
        note = row[name].get("note")
        row[name]["note"] = ((note + "; " if note else "") + (
            f"the scan path (render_scan {SCAN_SIZE}x{SCAN_SIZE}x{SCAN_SPP}"
            f", k_volume 3, phase 6) launched it {scan[key]} times; the "
            f"gradient pass (render_lanes remat, {GRAD_SIZE}x{GRAD_SIZE}x1, "
            f"phase 7) {grad[key]}, forward and backward, included"))
    row["dense_v5l_trace"]["note"] = (
        f"launches: the large path's {launches['large']['v5.v5l']} and the "
        f"xl path's {launches['xl']['v5.v5l']} (both through dense_v5s); "
        f"times: the large scene's whole tree (xl: "
        f"{rec['v5l_xl']['ms']:.4f} ms from the group roots, max_abs_err "
        f"{rec['v5l_xl']['max_abs_err']})")
    row["dense_v1_trace"]["note"] = (
        "on no render path (the JAX package reaches it only from "
        "tests/test_dense.py); launched in phase 3 only")
    row["bvh_trace"]["note"] = (
        f"launches: phase 8's renders at tri_backend=\"bvh\", "
        f"{BVH_SIZE}x{BVH_SIZE}x{BVH_SPP}: cornellbox {bc['bvh_closest']} "
        f"closest + {bc['bvh_any_hit']} any-hit, hair {bh['bvh_closest']} + "
        f"{bh['bvh_any_hit']}; a closest and an any-hit XLA while loop in "
        f"the JAX package, not Pallas")
    row["curve_bvh_trace"]["note"] = (
        f"launches: phase 8's hair render at tri_backend=\"bvh\": "
        f"{bh['curve_closest']} closest + {bh['curve_any_hit']} any-hit; an "
        f"XLA while loop in the JAX package, not Pallas")
    print(json.dumps(record))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
