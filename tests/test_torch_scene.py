"""Scene build and commit of the port against the JAX package.

Both sides are numpy up to `scene_from_numpy`, so every table the port
reads must be equal exactly; so must the fat rows packed on the device.
The large scenes (>= 4096 triangles) build their BVH with the native
builder on both sides (the port's copy of native/builder.cpp).
"""
import numpy as np
import pytest
import torch

from pbrlab_tpu.scene import demo as jdemo
from pbrlab_tpu.scene.scene import build_fat_tables as jbuild_fat_tables
from pbrlab_tpu.scene.scene import scene_to_device
from pbrlab_tpu_torch.ops.build import build_v5, pack_triangles_sah
from pbrlab_tpu_torch.scene import demo as tdemo
from pbrlab_tpu_torch.scene.scene import build_fat_tables, scene_from_numpy
from torch_threads import one_torch_thread  # noqa: F401

SLICE_KEYS = ("tri_v0", "tri_e1", "tri_e2", "face_ng", "face_area",
              "face_ns", "face_has_ns", "face_uv", "face_has_uv",
              "face_material", "face_light", "face_instance", "face_geom",
              "face_emission", "face_light_pdf", "emissive_faces",
              "light_cdf", "light_emission", "aabb_min", "aabb_max",
              "dense_tris_v4", "dense_cluster_aabb_v4", "v5_node_aabb",
              "v5_node_meta", "sig_aabb", "dense_tris", "dense_cluster_aabb",
              "dense_order")
CURVE_KEYS = ("curve_pts", "curve_material", "curve_instance", "curve_p0",
              "curve_p1", "curve_r0", "curve_r1", "curve_seg", "curve_u0",
              "curve_u1", "dense_segs", "dense_seg_aabb", "curve_sub_fat")
LARGE_KEYS = ("dense_tris_v5l", "v5s_roots", "v5s_aabb")
BVH_KEYS = ("bvh_min", "bvh_max", "bvh_skip", "bvh_prim_offset",
            "bvh_prim_ids", "cbvh_min", "cbvh_max", "cbvh_skip",
            "cbvh_prim_offset", "cbvh_prim_ids")


@pytest.mark.parametrize("kw", [dict(subdiv=1), dict(subdiv=3),
                                dict(subdiv=1, lambert_only=True,
                                     irregular=True),
                                dict(subdiv=4),
                                dict(subdiv=5, irregular=True),
                                dict(subdiv=3, with_hair=True)],
                         ids=["subdiv1", "subdiv3", "irregular", "subdiv4",
                              "large", "hair"])
def test_commit_matches_jax(kw):
    want, _ = jdemo.build_demo_scene(**kw)
    got, _ = tdemo.build_demo_scene(**kw)
    large = [k for k in LARGE_KEYS if k in want]
    assert large == [k for k in LARGE_KEYS if k in got]
    for key in SLICE_KEYS + CURVE_KEYS + BVH_KEYS + tuple(large):
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    for key, col in want["materials"].items():
        np.testing.assert_array_equal(got["materials"][key], col,
                                      err_msg=key)
    assert "curve_color" not in got and "curve_color" not in want
    if kw.get("with_hair"):  # the hair path: 96 strands, 42 clusters
        assert got["curve_pts"].shape == (672, 4, 4)
        assert got["dense_segs"].shape == (5376, 12)
        assert got["dense_seg_aabb"].shape == (8, 42)
        assert got["curve_sub_fat"].shape == (5376, 4)
    else:
        assert got["curve_pts"].shape == (0, 4, 4)
    if kw["subdiv"] == 3:  # the bench scene's sizes
        assert got["dense_tris_v4"].shape == (12, 3904)
        # the legacy tables: 2572 valid faces in 21 clusters of 128
        assert got["dense_tris"].shape == (12, 2688)
        assert got["dense_cluster_aabb"].shape == (8, 21)
        assert got["dense_order"].shape == (2572,)
        assert got["dense_cluster_aabb_v4"].shape == (8, 122)
        assert got["v5_node_aabb"].shape == (6, 243)
        assert np.isfinite(got["sig_aabb"]).all()  # 29 real subtrees
    if kw["subdiv"] == 4:  # the mid-size path: dense_v5, no v5l tables
        assert got["dense_tris_v4"].shape == (12, 14752) and not large
        assert got["dense_cluster_aabb_v4"].shape == (8, 461)
    if kw["subdiv"] == 5:  # bench.py's large scene: dense_v5s
        assert got["tri_v0"].shape[0] == 58464  # slots (40972 faces)
        assert got["dense_tris_v5l"].shape == (1827, 3, 128)
        assert got["v5s_roots"].shape == (64,)
        assert got["v5_node_aabb"].shape == (6, 3653)


def test_native_build_failure_raises(tmp_path, monkeypatch):
    """A failed compile of the native builder raises: the numpy build gives
    another tree, so falling back would change every slot id."""
    from pbrlab_tpu_torch.geometry import native

    monkeypatch.setattr(native, "_BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "CXX", "false")
    with pytest.raises(RuntimeError):
        native.build_library()


def test_pack_triangles_sah_matches_jax():
    from pbrlab_tpu.ops.pallas.dense_v4 import pack_triangles_sah as jpack

    scene, _ = tdemo.build_demo_scene(subdiv=2)
    args = (scene["tri_v0"], scene["tri_e1"], scene["tri_e2"])
    for got, want in zip(pack_triangles_sah(*args), jpack(*args)):
        np.testing.assert_array_equal(got, want)
    empty = np.zeros((0, 3), np.float32)
    assert [a.shape for a in build_v5(empty, empty, empty)] == [
        (12, 32), (8, 1), (32,), (6, 1), (2, 1)]


def test_fat_tables_match_jax():
    scene_np, _ = jdemo.build_demo_scene(subdiv=1)
    want = jbuild_fat_tables(scene_to_device(scene_np))
    got = build_fat_tables(scene_from_numpy(scene_np, "cpu"))
    for key in ("face_fat", "light_fat", "mat_fat"):
        np.testing.assert_array_equal(got[key].numpy(),
                                      np.asarray(want[key]), err_msg=key)


def test_lights_match_jax():
    """Light sampling on the same fat tables and uniforms: the face pick
    and the fetched rows are exact; the point p0 + u e1 + v e2 within rtol
    1e-6 (XLA:CPU may contract a product and sum into one rounding)."""
    import jax.numpy as jnp
    from pbrlab_tpu.scene import lights as jlights
    from pbrlab_tpu_torch.scene import lights as tlights

    scene_np, _ = jdemo.build_demo_scene(subdiv=1)
    jscene = jbuild_fat_tables(scene_to_device(scene_np))
    tscene = build_fat_tables(scene_from_numpy(scene_np, "cpu"))
    u = np.random.default_rng(11).random((3, 4096), dtype=np.float32)
    want = jlights.sample_all_light(jscene, *map(jnp.asarray, u))
    got = tlights.sample_all_light(tscene, *map(torch.from_numpy, u))
    for name in ("normal", "emission", "pdf", "valid"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)
    np.testing.assert_allclose(got.position.numpy(),
                               np.asarray(want.position), rtol=1e-6,
                               atol=1e-7)
    # random faces plus every emissive one, so both outcomes are covered
    prim = np.concatenate([np.random.default_rng(12).integers(
        0, scene_np["tri_v0"].shape[0], 512), scene_np["emissive_faces"]])
    prim = prim.astype(np.int32)
    got = tlights.implicit_area_light(tscene, torch.from_numpy(prim))
    want = jlights.implicit_area_light(jscene, jnp.asarray(prim))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[0].any() and not got[0].all()


def test_scene_from_numpy_keeps_dtypes():
    scene_np, _ = tdemo.build_demo_scene(subdiv=1)
    scene = scene_from_numpy(scene_np, "cpu")
    assert scene["face_has_ns"].dtype == torch.bool
    assert scene["face_material"].dtype == torch.int32
    assert scene["materials"]["kind"].dtype == torch.int32
    assert scene["tri_v0"].dtype == torch.float32
    np.testing.assert_array_equal(scene["v5_node_meta"].numpy(),
                                  scene_np["v5_node_meta"])


def _instanced_hair(pkg):
    """A floor and two colored hair tufts, one of them under a rotation,
    a uniform scale and a shift, built by package `pkg` (numpy colors
    from a seed; the second tuft carries none)."""
    scene_mod = __import__(f"{pkg}.scene.scene", fromlist=["SceneBuilder"])
    cyhair = __import__(f"{pkg}.io.cyhair", fromlist=["make_demo_hair"])
    demo = __import__(f"{pkg}.scene.demo", fromlist=["quad_mesh"])
    b = scene_mod.SceneBuilder()
    floor = demo.quad_mesh([-1, 0, -1], [-1, 0, 1], [1, 0, 1], [1, 0, -1],
                           b.materials.add_principled("floor"), "floor")
    b.add_instance([floor])
    hid = b.materials.add_hair("hair", hair_coloring=0)
    colored = cyhair.make_demo_hair(num_strands=12, seed=3)
    colored.segment_colors = np.random.default_rng(4).random(
        (colored.num_segments, 3)).astype(np.float32)
    plain = cyhair.make_demo_hair(num_strands=5, seed=5)
    c, s = np.cos(0.7), np.sin(0.7)
    m = np.asarray([[1.5 * c, 0, 1.5 * s, 0.2], [0, 1.5, 0, -0.1],
                    [-1.5 * s, 0, 1.5 * c, 0.3], [0, 0, 0, 1]])
    for cm in (colored, plain):
        cm.material_id = hid
    b.add_instance([], curves=[colored])
    b.add_instance([], curves=[plain], transform=m)
    return scene_mod.commit(b.build())


def test_instanced_colored_hair_matches_jax():
    """Curves under an instance transform, with and without CyHair colors
    (curve_color: -1 rows where a mesh has none), and the scene box."""
    want, got = _instanced_hair("pbrlab_tpu"), _instanced_hair(
        "pbrlab_tpu_torch")
    for key in CURVE_KEYS + ("curve_color", "aabb_min", "aabb_max"):
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    assert got["curve_pts"].shape == (84 + 35, 4, 4)  # 7 segments a strand
    assert (got["curve_color"][:84] >= 0).all()
    assert (got["curve_color"][84:] == -1).all()
    np.testing.assert_array_equal(np.unique(got["curve_instance"]), [1, 2])


def test_unported_features_raise():
    """What a scene lacks raises ValueError: a backend whose tables the
    scene's commit did not add (a legacy backend or the threaded-BVH walk
    on an instanced scene, dense5l without the large-scene tables), and an
    unknown backend. The legacy brute-force backends (ROADMAP B8), the
    threaded-BVH walk ("bvh"), instancing and textures, ported since,
    dispatch."""
    from pbrlab_tpu_torch.ops.intersect import _closest, _tri_backend

    scene = scene_from_numpy(tdemo.build_demo_scene(subdiv=1)[0], "cpu")
    ray = (torch.zeros((4, 3)), torch.ones((4, 3)), torch.zeros(4),
           torch.ones(4))
    for legacy in ("dense3", "dense", "dense2", "bvh"):
        assert _closest(scene, legacy, *ray)["prim"].shape == (4,)
    for backend, tables in (("bvh", {k: v for k, v in scene.items()
                                     if not k.startswith("bvh_")}),
                            ("dense5l", scene), ("dense9", scene),
                            ("dense3", {k: v for k, v in scene.items()
                                        if not k.startswith("dense_")})):
        with pytest.raises(ValueError):
            _closest(tables, backend, *ray)
    assert _tri_backend({**scene, "i5_tris": torch.zeros((12, 32))}) \
        == "dense5i"
    scene["texture_atlas"] = torch.zeros((1, 2, 2, 3))
    scene["texture_sizes"] = torch.full((1, 2), 2, dtype=torch.int32)
    assert build_fat_tables(scene)["texture_quad"].shape == (1, 2, 2, 12)
