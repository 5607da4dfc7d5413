"""Trace-time instancing in the port against the JAX package.

The scenes are tests/test_instancing.py's: k icospheres shared through one
BLAS under per-instance rotation and scale, over a floor with a light
quad; a hair variant (`_hair_builders(4)`: a sphere plus a tuft per
instance), and a textured variant (a texcoord floor with a base-colour
texture, random-walk SSS spheres whose subsurface colour is a texture read
at the barycentric uv). Each builder is fed the same numpy meshes in both
packages.

- `build_tlas` and `build_instanced` must give JAX's arrays bit for bit,
  key by key (JAX's commit_curves adds the curve-BVH `cbvh_*` tables of
  its CPU curve walk, which the port does not build).
- The plain dense_v5i walk, the per-ray twin of the kernel
  (`per_ray.walk_ref`: every lane its own stack and its own cull), against
  JAX's kernel in interpret mode, which walks 1024-ray groups, on 2048
  rays (dead lanes and clipped max_t among them). In exact arithmetic the
  two find the same closest hits; in float they may differ on exact-t ties
  (the first triangle a lane visits follows its own order) and on grazing
  lanes (its own slab test misses a box its group entered), and XLA:CPU
  may contract a product and a sum into one rounding where torch rounds
  twice (ROADMAP C7). Measured on the CPU: hit masks and prim equal on all
  427 hit lanes, closest and any-hit; t bit-equal on all but 43 (relative
  4.2e-7). So hit masks must be equal, prim equal except on grazing lanes
  (< 1%, each with t within rtol 1e-5 of JAX's or a barycentric margin
  below 1e-5), t within rtol 1e-5 and u, v within atol 4e-6 where prim
  agrees, as in test_torch_dense_v5.py.
- The instanced shading rows (`_fetch_face_fat`) against JAX's.
- One render of the textured SSS scene, 16x16x4 spp, max_steps 5, at the
  same n_lanes as JAX's `render`: the goldens' band (>= 99% of values
  within rtol 1e-3/atol 1e-4, mean within 1e-3 relative).
- 100 instances cost < 1/5 of the baked scene's bytes.

JAX runs twice in this file: one interpret-mode trace program (closest and
any-hit together) and one render. The requires_cuda test compares the
kernel with the plain walk on the card; it imports no JAX, so it runs there
with `python -m pytest tests/test_torch_instancing.py --noconftest
-o addopts="" -m requires_cuda`.
"""
import types

import numpy as np
import pytest
import torch

from pbrlab_tpu_torch.core.math import INF
from pbrlab_tpu_torch.ops import dense_v5i, intersect
from torch_threads import one_torch_thread  # noqa: F401

N = 2048
I5_KEYS = ("i5_tris", "i5_node_aabb", "i5_node_meta", "i5_inst_inv",
           "i5_inst_meta")


def _port():
    from pbrlab_tpu_torch.geometry import mesh
    from pbrlab_tpu_torch.io import cyhair
    from pbrlab_tpu_torch.scene import demo, instanced, scene

    return types.SimpleNamespace(demo=demo, scene=scene, instanced=instanced,
                                 mesh=mesh, cyhair=cyhair)


def _jax():
    from pbrlab_tpu.geometry import mesh
    from pbrlab_tpu.io import cyhair
    from pbrlab_tpu.scene import demo, instanced, scene

    return types.SimpleNamespace(demo=demo, scene=scene, instanced=instanced,
                                 mesh=mesh, cyhair=cyhair)


def _transforms(k, spacing=1.2):
    """k transforms on a grid with per-instance rotation and scale
    (tests/test_instancing.py:_transforms)."""
    out = []
    side = int(np.ceil(np.sqrt(k)))
    for i in range(k):
        c, s = np.cos(0.7 * i), np.sin(0.7 * i)
        m = np.eye(4)
        m[:3, :3] = (np.asarray([[c, 0, s], [0, 1, 0], [-s, 0, c]])
                     * (0.8 + 0.1 * (i % 3)))
        m[:3, 3] = ((i % side) * spacing - side * spacing / 2, 0.55,
                    (i // side) * spacing - side * spacing / 2)
        out.append(m)
    return np.stack(out).astype(np.float32)


def _builder(pkg, k, kind="spheres", baked=False):
    """SceneBuilder of the k-instance scene of `kind` ("spheres", "hair",
    "textured") in package `pkg`; baked=True adds every instance as its own
    world-space copy (the baked path's scene)."""
    b = pkg.scene.SceneBuilder()
    m = b.materials
    floor_kw, ball_kw = {}, dict(base_color=(0.8, 0.4, 0.2), specular=0.0,
                                 roughness=0.4)
    if kind == "textured":
        rng = np.random.default_rng(0)
        floor_kw["base_color_tex_id"] = b.add_texture(
            rng.random((8, 12, 3)).astype(np.float32))
        ball_kw = dict(  # scene/demo.py's SSS body, colour from a texture
            base_color=(1.0, 0.8, 0.8), subsurface=1.0,
            subsurface_radius=(1.0, 0.2, 0.1),
            subsurface_color=(1.0, 0.8, 0.8), specular=0.0, roughness=0.2,
            subsurface_color_tex_id=b.add_texture(
                0.5 + 0.5 * rng.random((5, 7)).astype(np.float32)))
    white = m.add_principled("floor", base_color=(0.7, 0.7, 0.7),
                             specular=0.0, **floor_kw)
    side = 4.0 if kind == "hair" else max(3.0, np.sqrt(k) * 1.2)
    floor = pkg.demo.quad_mesh([-side, 0, -side], [-side, 0, side],
                               [side, 0, side], [side, 0, -side], white,
                               "floor")
    if kind == "textured":
        floor.texcoords = np.asarray([[0, 0], [0, 2], [2, 2], [2, 0]],
                                     np.float32)
        floor.texcoord_idx = floor.faces.copy()
    b.add_instance([floor])
    lid = b.add_area_light_param((14.0,) * 3 if kind == "hair"
                                 else (12.0,) * 3)
    light = pkg.demo.quad_mesh([-1, 4.0, -1], [1, 4.0, -1], [1, 4.0, 1],
                               [-1, 4.0, 1], white, "light")
    b.add_instance([light], light_ids=[np.full((2,), lid, np.int32)])
    ball = m.add_principled("ball", **ball_kw)
    curves = []
    if kind == "hair":
        ts = _transforms(k, spacing=1.6)
        sphere = pkg.demo.icosphere(1, 0.3, center=(0, 0.35, 0),
                                    material_id=ball, name="ball")
        tuft = pkg.cyhair.make_demo_hair(num_strands=24, base=(0.0, 0.9, 0.0),
                                         length=0.5, thickness=0.01, seed=3)
        curves = [pkg.mesh.CubicBezierCurveMesh(
            tuft.vertices_thickness, tuft.indices,
            material_id=m.add_hair("hair"), name=tuft.name)]
    else:
        ts = _transforms(k)
        sphere = pkg.demo.icosphere(1, 0.45, material_id=ball, name="ball")
    if baked:
        for t in ts:
            b.add_instance([sphere], curves=curves, transform=t)
    else:
        b.add_shared_instances([sphere], ts, curves=curves)
    return b


@pytest.fixture(scope="module")
def textured_np():
    """The port's commit of the textured 9-instance scene (numpy)."""
    return _port().instanced.build_instanced(_builder(_port(), 9, "textured"))


def _rays(scene_np, n, seed):
    """test_instancing.py's rays: origins in the scene box, uniform
    directions; every 7th lane dead, every 5th from the 3rd clipped."""
    rng = np.random.default_rng(seed)
    lo, hi = scene_np["aabb_min"], scene_np["aabb_max"]
    org = lo + (hi - lo) * rng.random((n, 3))
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    max_t = np.full(n, 1e18)
    max_t[3::5] = rng.random(len(max_t[3::5])) * 3.0
    max_t[::7] = -1.0
    f32 = np.float32
    return (org.astype(f32), d.astype(f32), np.zeros(n, f32),
            max_t.astype(f32))


@pytest.mark.parametrize("k", [9, 100])
def test_build_tlas_matches_jax(k):
    from pbrlab_tpu.ops.pallas.dense_v5i import build_tlas

    rng = np.random.default_rng(k)
    lo = (rng.random((k, 3)) * 10.0).astype(np.float32)
    hi = lo + (0.2 + rng.random((k, 3))).astype(np.float32)
    want = build_tlas(lo, hi)
    got = dense_v5i.build_tlas(lo, hi)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert (got[2] >= 0).sum() == k  # one leaf per instance


@pytest.mark.parametrize("kind", ["spheres", "hair", "textured"])
def test_build_instanced_matches_jax(kind):
    k = 4 if kind == "hair" else 9
    want = _jax().instanced.build_instanced(_builder(_jax(), k, kind))
    got = _port().instanced.build_instanced(_builder(_port(), k, kind))
    assert set(want) - set(got) == {"cbvh_min", "cbvh_max", "cbvh_skip",
                                    "cbvh_prim_offset", "cbvh_prim_ids"}
    assert set(got) <= set(want)
    for key, val in got.items():
        ref = want[key]
        pairs = ([(val[c], ref[c], f"{key}.{c}") for c in val]
                 if isinstance(val, dict) else [(val, ref, key)])
        for a, b, name in pairs:
            b = np.asarray(b)
            assert a.dtype == b.dtype and a.shape == b.shape, name
            np.testing.assert_array_equal(a, b, err_msg=name)
    if kind == "hair":  # curve ids share the TLAS's instance ids
        assert got["curve_pts"].shape[0] > 0
        assert got["curve_instance"].max() < got["inst_shade"].shape[0]
    if kind == "textured":
        assert got["texture_atlas"].shape == (2, 8, 12, 3)


@pytest.fixture(scope="module")
def jax_traces(textured_np):
    """JAX's interpret-mode dense_trace_v5i, closest and any-hit, in one
    jitted program on the textured scene's rays."""
    import jax
    import jax.numpy as jnp
    from pbrlab_tpu.ops.pallas.dense_v5i import dense_trace_v5i

    rays = _rays(textured_np, N, 2)

    @jax.jit
    def both(*args):
        return (dense_trace_v5i(*args, interpret=True),
                dense_trace_v5i(*args, any_hit=True, interpret=True))

    out = both(*[jnp.asarray(textured_np[k]) for k in I5_KEYS],
               *[jnp.asarray(r) for r in rays])
    return rays, [{k: np.asarray(v) for k, v in o.items()} for o in out]


def _torch_args(scene_np, rays, device="cpu"):
    return ([torch.from_numpy(np.asarray(scene_np[k])).to(device)
             for k in I5_KEYS]
            + [torch.from_numpy(r).to(device) for r in rays])


def test_plain_walk_closest_matches_jax(textured_np, jax_traces):
    rays, (want, _) = jax_traces
    got = dense_v5i.dense_trace_v5i(*_torch_args(textured_np, rays))
    assert got["prim"].dtype == torch.int32 and got["t"].shape == (N,)
    got = {k: v.numpy() for k, v in got.items()}
    hit = want["prim"] >= 0
    np.testing.assert_array_equal(got["prim"] >= 0, hit)
    assert hit.mean() > 0.15  # the rays do hit the scene
    assert not hit[::7].any()  # dead lanes
    np.testing.assert_array_equal(got["t"][~hit], np.float32(INF))
    same = hit & (got["prim"] == want["prim"])
    np.testing.assert_allclose(got["t"][same], want["t"][same], rtol=1e-5,
                               atol=1e-6)
    for k in ("u", "v"):
        np.testing.assert_allclose(got[k][same], want[k][same], rtol=1e-5,
                                   atol=4e-6, err_msg=k)
    # a prim that differs is a grazing lane: a tie in t, or a hit within
    # 1e-5 of a triangle edge
    differ = hit & ~same
    assert differ.mean() < 1e-2
    u, v = got["u"][differ], got["v"][differ]
    margin = np.minimum(np.minimum(u, v), 1.0 - u - v)
    tie = np.isclose(got["t"][differ], want["t"][differ], rtol=1e-5)
    assert (tie | (margin < 1e-5)).all()


def test_plain_walk_any_hit_matches_jax(textured_np, jax_traces):
    rays, (closest, want) = jax_traces
    got = dense_v5i.dense_trace_v5i(*_torch_args(textured_np, rays),
                                    any_hit=True)
    hit = got["prim"].numpy() >= 0
    np.testing.assert_array_equal(hit, want["prim"] >= 0)
    np.testing.assert_array_equal(hit, closest["prim"] >= 0)
    assert not hit[::7].any()  # dead lanes never block the exit


def test_instanced_dispatch(textured_np):
    """intersect takes dense_v5i for an instanced scene, with no sparse
    override, and trace_scene_dual answers the shadow query apart."""
    scene = {k: torch.from_numpy(np.asarray(v)) for k, v in
             textured_np.items() if not isinstance(v, dict)}
    assert intersect._tri_backend(scene) == "dense5i"
    assert intersect.sparse_backend(scene) is None
    org, d, mint, maxt = (torch.from_numpy(r) for r in
                          _rays(textured_np, 1024, 5))
    sd = -d
    hit, occ = intersect.trace_scene_dual(scene, org, d, mint, maxt, sd,
                                          mint, maxt)
    ref = dense_v5i.dense_trace_v5i(*_torch_args(textured_np, ()), org, d,
                                    mint, maxt)
    anyh = dense_v5i.dense_trace_v5i(*_torch_args(textured_np, ()), org, sd,
                                     mint, maxt, any_hit=True)
    for k in ("t", "u", "v", "prim"):
        assert torch.equal(hit[k], ref[k]), k
    assert torch.equal(occ, anyh["prim"] >= 0)
    assert not hit["is_curve"].any()


def test_face_rows_match_jax(textured_np):
    """The instanced shading row of a lane (`_fetch_face_fat`) against
    JAX's: the same gathers, the normals rotated by the instance's normal
    matrix (XLA's einsum may round the 3-term sums differently: 1e-6);
    uv, flags, material, light and instance columns exact."""
    import jax.numpy as jnp
    from pbrlab_tpu.render import integrator as jint
    from pbrlab_tpu.scene.scene import build_fat_tables as jfat
    from pbrlab_tpu.scene.scene import scene_to_device
    from pbrlab_tpu_torch.render import integrator as tint
    from pbrlab_tpu_torch.scene.scene import build_fat_tables, scene_from_numpy

    prim = np.random.default_rng(3).integers(
        0, textured_np["iface_material"].shape[0], 4096).astype(np.int32)
    want = np.asarray(jint._fetch_face_fat(
        jfat(scene_to_device(textured_np)), jnp.asarray(prim)))
    got = tint._fetch_face_fat(
        build_fat_tables(scene_from_numpy(textured_np, "cpu")),
        torch.from_numpy(prim).to(torch.int64)).numpy()
    assert got.shape == want.shape == (4096, 26)
    np.testing.assert_allclose(got[:, :12], want[:, :12], rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_array_equal(got[:, 12:], want[:, 12:])
    no_ns = got[:, 18] == 0.0
    assert no_ns.any() and (got[no_ns, 3:12] == 0.0).all()
    # column 25 is the world instance: the floor, the light, then 9 balls
    assert set(np.unique(got[:, 25])) == set(range(11))


def test_textured_sss_render_matches_jax(textured_np):
    from pbrlab_tpu.render.integrator import render as jrender
    from pbrlab_tpu.scene.scene import scene_to_device
    from pbrlab_tpu_torch.render.integrator import render
    from pbrlab_tpu_torch.scene.scene import build_fat_tables, scene_from_numpy

    kw = dict(width=16, height=16, spp=4, seed=7, max_steps=5)
    want = np.asarray(jrender(scene_to_device(textured_np), **kw))
    scene = build_fat_tables(scene_from_numpy(textured_np, "cpu"))
    assert "texture_quad" in scene and "iface_fat" in scene
    got = render(scene, **kw).numpy()
    assert np.isfinite(got).all() and got.mean() > 1e-3
    assert np.isclose(got, want, rtol=1e-3, atol=1e-4).mean() >= 0.99
    np.testing.assert_allclose(got.mean(), want.mean(), rtol=1e-3)


def test_instanced_memory_is_shared():
    """100 instances cost under 1/5 of the baked scene's bytes
    (tests/test_instancing.py:test_instanced_memory_is_shared)."""
    pkg = _port()
    si = pkg.instanced.build_instanced(_builder(pkg, 100))
    sb = pkg.scene.commit(_builder(pkg, 100, baked=True).build())

    def nbytes(scene):
        return sum(np.asarray(v).nbytes for v in scene.values()
                   if not isinstance(v, dict))

    assert nbytes(si) < nbytes(sb) / 5


@pytest.mark.requires_cuda
def test_cuda_kernel_matches_plain(textured_np):
    """The per-ray kernel vs its twin on the card: same operations, no FMA
    contraction, IEEE division, the same pops per lane -> bit-equal t, u,
    v and prim, closest and any-hit, at one partial group and at 65536
    lanes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the dense_v5i kernel is CUDA-only)")
    for n, seed in ((1500, 7), (65536, 8)):
        args = _torch_args(textured_np, _rays(textured_np, n, seed), "cuda")
        for any_hit in (False, True):
            kind = "any_hit" if any_hit else "closest"
            before = dense_v5i.LAUNCHES[kind]
            got = dense_v5i.dense_trace_v5i(*args, any_hit=any_hit)
            ref = dense_v5i.dense_trace_v5i_ref(*args, any_hit=any_hit)
            torch.cuda.synchronize()
            assert dense_v5i.LAUNCHES[kind] == before + 1
            for k in got:
                assert torch.equal(got[k], ref[k]), (kind, k)
