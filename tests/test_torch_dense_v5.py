"""dense_v5 family of the port against the JAX package's Pallas kernels.

On the CPU the port's wrappers run the plain versions (the per-ray twins
`_v5_ref` for v5 and its dual, `_v5l_ref` for v5l); the reference is
pbrlab_tpu.ops.pallas.dense_v5 in interpret mode, on the
subdiv=1 scene and 512 rays of tests/test_dense.py (plus dead lanes,
clipped max_t and shadow queries). Both compute the same float32 slab
tests and linear forms in the same order, so hit masks and occlusion must
be equal and t, u, v agree to rtol 1e-5 (XLA:CPU may contract a product
and a sum into one rounding where torch rounds twice); prim must be equal
wherever the hit t is unique (on an exact tie the first-visited triangle
wins). u = (o.b1 - c1) + t (d.b1) cancels two terms of up to ~10 near an
edge, so its rounding error is absolute, a few ulps of those terms: u and
v also get atol 4e-6 (t gets 1e-6, as in test_torch_dense_v4.py).

The port walks per ray where JAX walks 1024-ray groups: the two may
differ on exact-t ties and grazing lanes (ROADMAP C3), so prim may differ
on < 1% of the hit lanes. Measured on the CPU: hit masks and prim equal on
every hit lane of the v5l cases (178 from the root, 149 from node 1) and
of v5s (163); t bit-equal on all but 9 / 4 / 9 (relative <= 1.1e-6,
XLA:CPU's contractions), inside the bands above; of v5 (177) and the
dual (162) too, with t bit-equal on all but 16 / 2 (relative <= 2.9e-6),
the any-hit masks equal and `occluded` equal on every lane (124 of 512
occluded).

dense_trace_v5s is checked at passes 1, 2 and 3 against one JAX v5s run
(passes 3: its paired, single and cleanup passes). The schedule changes
which subtrees a ray visits first, never its closest hit, so every pass
count must land in the same band.

The requires_cuda test compares the CUDA kernels with their twins on the
card. It imports no JAX, so it runs there with
`python -m pytest tests/test_torch_dense_v5.py --noconftest -o addopts=""
-m requires_cuda`.
"""
import numpy as np
import pytest
import torch

from pbrlab_tpu_torch.core.math import INF
from pbrlab_tpu_torch.ops import dense_v5, intersect
from pbrlab_tpu_torch.ops.build import leaf_major, subtree_cut
from pbrlab_tpu_torch.scene.demo import build_demo_scene
from pbrlab_tpu_torch.scene.scene import scene_from_numpy
from torch_threads import one_torch_thread  # noqa: F401

N = 512  # tests/test_dense.py's ray count (padded to one 1024-ray group)


@pytest.fixture(scope="module")
def scene_np():
    scene = build_demo_scene(subdiv=1)[0]
    scene["dense_tris_v5l"] = leaf_major(scene["dense_tris_v4"])
    roots, aabb = subtree_cut(scene["v5_node_aabb"], scene["v5_node_meta"],
                              max_nodes=16)
    scene["v5s_roots"], scene["v5s_aabb"] = roots, aabb
    return scene


def _rays(scene_np, n, seed):
    """test_dense.py's rays (origins over 1.5x the scene box, uniform
    directions), plus dead lanes, clipped max_t and a shadow query per lane
    (30% of lanes ask none: smax_t < smin_t)."""
    rng = np.random.default_rng(seed)
    bmin, bmax = scene_np["aabb_min"], scene_np["aabb_max"]
    org = bmin + rng.random((n, 3)) * (bmax - bmin) * 1.5 - 0.25 * (bmax - bmin)
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    max_t = np.full(n, INF)
    max_t[3::5] = rng.random(len(max_t[3::5])) * 2.0  # clipped queries
    max_t[::7] = -1.0  # dead lanes
    sd = rng.normal(size=(n, 3))
    sd /= np.linalg.norm(sd, axis=1, keepdims=True)
    smax = np.where(rng.random(n) < 0.3, -1.0, rng.random(n) * 4.0)
    f32 = np.float32
    return (org.astype(f32), d.astype(f32), np.full(n, 1e-3, f32),
            max_t.astype(f32), sd.astype(f32), np.full(n, 1e-3, f32),
            smax.astype(f32))


def _check(got, want, rtol=1e-5, min_hits=0.2):
    got = {k: np.asarray(v) for k, v in got.items()}
    want = {k: np.asarray(v) for k, v in want.items()}
    hit = want["prim"] >= 0
    np.testing.assert_array_equal(got["prim"] >= 0, hit)
    assert hit.mean() > min_hits  # the rays do hit the scene
    for k, atol in (("t", 1e-6), ("u", 4e-6), ("v", 4e-6)):
        np.testing.assert_allclose(got[k][hit], want[k][hit], rtol=rtol,
                                   atol=atol, err_msg=k)
    np.testing.assert_array_equal(got["t"][~hit], np.float32(INF))
    differ = hit & (got["prim"] != want["prim"])
    np.testing.assert_allclose(got["t"][differ], want["t"][differ],
                               rtol=rtol)
    assert differ.mean() < 1e-2


def _tables(scene_np, keys, device="cpu"):
    return [torch.from_numpy(np.asarray(scene_np[k])).to(device)
            for k in keys]


V5_KEYS = ("dense_tris_v4", "v5_node_aabb", "v5_node_meta")
V5L_KEYS = ("dense_tris_v5l", "v5_node_aabb", "v5_node_meta")
V5S_KEYS = V5L_KEYS + ("v5s_roots", "v5s_aabb")


def _jax(scene_np, keys, rays):
    import jax.numpy as jnp

    return ([jnp.asarray(scene_np[k]) for k in keys]
            + [jnp.asarray(r) for r in rays])


def _torch(scene_np, keys, rays, device="cpu"):
    return (_tables(scene_np, keys, device)
            + [torch.from_numpy(r).to(device) for r in rays])


def test_closest_and_any_hit_match_jax(scene_np):
    from pbrlab_tpu.ops.pallas import dense_v5 as jv5

    rays = _rays(scene_np, N, 1)[:4]
    want = jv5.dense_trace_v5(*_jax(scene_np, V5_KEYS, rays), interpret=True)
    got = dense_v5.dense_trace_v5(*_torch(scene_np, V5_KEYS, rays))
    assert got["prim"].dtype == torch.int32 and got["t"].shape == (N,)
    _check(got, want)
    # any-hit with the dead lanes mixed in: they must not block the exit
    want = jv5.dense_trace_v5(*_jax(scene_np, V5_KEYS, rays), any_hit=True,
                              interpret=True)
    args = _torch(scene_np, V5_KEYS, rays)
    got = dense_v5.dense_trace_v5(*args, any_hit=True)
    np.testing.assert_array_equal(got["prim"].numpy() >= 0,
                                  np.asarray(want["prim"]) >= 0)
    assert not (got["prim"].numpy()[::7] >= 0).any()  # dead lanes


def test_dual_matches_jax(scene_np):
    from pbrlab_tpu.ops.pallas import dense_v5 as jv5

    rays = _rays(scene_np, N, 2)
    want, want_occ = jv5.dense_trace_v5_dual(*_jax(scene_np, V5_KEYS, rays),
                                             interpret=True)
    got, occ = dense_v5.dense_trace_v5_dual(*_torch(scene_np, V5_KEYS, rays))
    _check(got, want)
    assert occ.dtype == torch.bool
    np.testing.assert_array_equal(occ.numpy(), np.asarray(want_occ))
    assert 0.05 < occ.float().mean() < 0.95
    assert not occ.numpy()[rays[6] < rays[5]].any()


@pytest.mark.parametrize("rooted", [False, True], ids=["root0", "roots"])
def test_v5l_matches_jax(scene_np, rooted):
    """Leaf-major table, from the tree's root or from a subtree root."""
    import jax.numpy as jnp
    from pbrlab_tpu.ops.pallas import dense_v5 as jv5

    rays = _rays(scene_np, N, 3)[:4]
    kw_j, kw_t = {}, {}
    if rooted:  # the one group walks the root's left subtree (node 1)
        roots = np.array([1], np.int32)
        kw_j, kw_t = ({"group_roots": jnp.asarray(roots)},
                      {"group_roots": torch.from_numpy(roots)})
    want = jv5.dense_trace_v5l(*_jax(scene_np, V5L_KEYS, rays),
                               interpret=True, **kw_j)
    got = dense_v5.dense_trace_v5l(*_torch(scene_np, V5L_KEYS, rays), **kw_t)
    _check(got, want, min_hits=0.05)


@pytest.fixture(scope="module")
def v5s_jax(scene_np):
    """One JAX v5s run (interpret mode; passes 3 runs its paired, single
    and cleanup passes) on test_dense.py's shapes."""
    from pbrlab_tpu.ops.pallas import dense_v5 as jv5

    rays = _rays(scene_np, N, 4)[:4]
    return rays, jv5.dense_trace_v5s(*_jax(scene_np, V5S_KEYS, rays),
                                      interpret=True, passes=3)


@pytest.mark.parametrize("passes", [1, 2, 3])
def test_v5s_matches_jax(scene_np, v5s_jax, passes):
    rays, want = v5s_jax
    got = dense_v5.dense_trace_v5s(*_torch(scene_np, V5S_KEYS, rays),
                                   passes=passes)
    _check(got, want)
    # the schedule changes no hit: the plain v5l walk of the whole tree
    whole = dense_v5.dense_trace_v5l(*_torch(scene_np, V5L_KEYS, rays))
    _check(got, whole)
    anyh = dense_v5.dense_trace_v5s(*_torch(scene_np, V5S_KEYS, rays),
                                    passes=passes, any_hit=True)
    np.testing.assert_array_equal(anyh["prim"].numpy() >= 0,
                                  np.asarray(want["prim"]) >= 0)


def test_wrappers_take_plain_walk_on_cpu(scene_np):
    """On CPU tensors the wrappers are the per-ray twins and launch no
    kernel; the dual's closest answer is the single walk's to the bit and
    its occlusion an any-hit walk's of the shadow rays."""
    rays = _rays(scene_np, 300, 5)
    before = dict(dense_v5.LAUNCHES)
    args = _torch(scene_np, V5_KEYS, rays)
    got, occ = dense_v5.dense_trace_v5_dual(*args)
    ref, ref_occ = dense_v5.dense_trace_v5_dual_ref(*args)
    single = dense_v5.dense_trace_v5(*args[:7])
    for k in got:
        assert torch.equal(got[k], ref[k])
        assert torch.equal(got[k], single[k])
    assert torch.equal(occ, ref_occ)
    twin = dense_v5._v5_ref(*args[:3], args[3], *args[7:10], any_hit=True)
    assert torch.equal(occ, twin[3] >= 0)
    dense_v5.dense_trace_v5s(*_torch(scene_np, V5S_KEYS, rays[:4]))
    assert dense_v5.LAUNCHES == before


def test_backend_dispatch(scene_np, monkeypatch):
    """The JAX package's choice: v5s tables -> dense5s, v5l table alone ->
    dense5l, <= 256 clusters -> dense4, else dense5; sparse_backend swaps
    dense4 -> dense5 and dense5s -> dense5l."""
    base = {k: v for k, v in scene_np.items()
            if k not in ("dense_tris_v5l", "v5s_roots", "v5s_aabb")}
    v5l = {**base, "dense_tris_v5l": scene_np["dense_tris_v5l"]}
    v5s = dict(scene_np)
    tb = intersect._tri_backend
    assert [tb(s) for s in (base, v5l, v5s)] == ["dense4", "dense5l",
                                                 "dense5s"]
    assert [intersect.sparse_backend(s) for s in (base, v5l, v5s)] == [
        "dense5", None, "dense5l"]
    monkeypatch.setattr(intersect, "MAX_DENSE4_CLUSTERS", 4)
    assert tb(base) == "dense5" and intersect.sparse_backend(base) is None
    # every backend finds the same hits through the dispatch
    scene = scene_from_numpy(v5s, "cpu")
    rays = [torch.from_numpy(r) for r in _rays(scene_np, 700, 6)]
    ref, ref_occ = intersect.trace_scene_dual(scene, *rays, backend="dense4")
    for backend in ("dense5", "dense5l", "dense5s"):
        got, occ = intersect.trace_scene_dual(scene, *rays, backend=backend)
        _check(got, ref)
        assert torch.equal(occ, ref_occ), backend
        assert torch.equal(intersect.occluded_scene(
            scene, rays[0], *rays[4:], backend=backend), ref_occ), backend


@pytest.mark.requires_cuda
def test_cuda_kernels_match_plain(scene_np, monkeypatch):
    """Kernels vs their per-ray twins on the card: same ops in the same
    order, no FMA contraction, IEEE division -> bit-equal closest hits and
    occlusion, and the dual's closest hits bit-equal to the single
    kernel's; any-hit equal hit masks. dense_trace_v5s is held against
    itself over the plain v5l. The wrapper refuses a table the kernel
    cannot read as float4."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the dense_v5 kernels are CUDA-only)")
    for n, seed in ((1500, 7), (65536, 8)):
        rays = _rays(scene_np, n, seed)
        args = _torch(scene_np, V5_KEYS, rays, "cuda")
        before = dict(dense_v5.LAUNCHES)
        got, occ = dense_v5.dense_trace_v5_dual(*args)
        ref, ref_occ = dense_v5.dense_trace_v5_dual_ref(*args)
        torch.cuda.synchronize()
        assert dense_v5.LAUNCHES["v5_dual"] == before["v5_dual"] + 1
        single = dense_v5.dense_trace_v5(*args[:7])
        for k in got:
            assert torch.equal(got[k], ref[k]), k
            assert torch.equal(got[k], single[k]), k
        assert torch.equal(occ, ref_occ)

        def v5s_ref(*a, **kw):
            with monkeypatch.context() as m:
                m.setattr(dense_v5, "dense_trace_v5l",
                          dense_v5.dense_trace_v5l_ref)
                return dense_v5.dense_trace_v5s(*a, **kw)

        for keys, fn, ref_fn, kw in [
                (V5_KEYS, dense_v5.dense_trace_v5, dense_v5.dense_trace_v5_ref,
                 {}),
                (V5L_KEYS, dense_v5.dense_trace_v5l,
                 dense_v5.dense_trace_v5l_ref, {}),
                (V5L_KEYS, dense_v5.dense_trace_v5l,
                 dense_v5.dense_trace_v5l_ref, {"group_roots": (
                     torch.arange((n + 1023) // 1024, device="cuda")
                     % 3).to(torch.int32)}),
                (V5S_KEYS, dense_v5.dense_trace_v5s, v5s_ref, {"passes": 2})]:
            a = _torch(scene_np, keys, rays[:4], "cuda")
            single = fn(*a, **kw)
            ref1 = ref_fn(*a, **kw)
            anyh = fn(*a, any_hit=True, **kw)
            torch.cuda.synchronize()
            for k in single:
                assert torch.equal(single[k], ref1[k]), (fn.__name__, k)
            assert torch.equal(anyh["prim"] >= 0, ref1["prim"] >= 0)
    tris = args[0]  # 4 bytes past a 16-byte boundary: no float4 loads
    shifted = torch.empty(tris.numel() + 1, device="cuda")[1:].view(
        tris.shape)
    with pytest.raises(ValueError, match="float4"):
        dense_v5._v5_cuda(shifted, *(x.contiguous() for x in args[1:7]))
