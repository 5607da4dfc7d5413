"""dense_v4 trace of the port against the JAX package's Pallas kernels.

On the CPU the port's wrappers run the per-ray twin
(`per_ray.cluster_walk_ref`): each lane tests the clusters its own ray
enters, in the order of its own entry t, until its own best t. The
reference is pbrlab_tpu.ops.pallas.dense_v4 in interpret mode, a group
walk (every ray of a 1024-ray group tests the group's survivor list), on
the scene and rays of tests/test_dense.py. The triangle arithmetic is the
same, but the walks visit clusters in other orders and the group test
admits clusters a lane's own slab test rejects, so prim may differ on
exact-t ties and grazing rays (ROADMAP C3), and XLA:CPU may round a sum
differently by an ulp (C7). Measured here (subdiv=1 scene, 1500 lanes,
CPU): closest 514 hit lanes, prim equal on all, t bit-equal on 487, the
largest relative t error 2.8e-6; dual 517 hit lanes, prim equal on all, t
bit-equal on 494, relative 9.9e-6, occluded equal on all 1500 lanes (381
occluded); any-hit masks equal (497 hits). The band: hit masks and
occlusion equal, t, u, v within rtol 1e-5 (atol 1e-6), prim differing
only where t agrees and on fewer than 0.1% of all lanes (none today).

The twin is also held against an independent per-lane numpy loop (scan
every box, stable order, the lane's own exit) on a few dozen lanes and
on a synthetic scene of MAX_CLUSTERS clusters whose rays enter every box,
so a lane's list is full.

The requires_cuda tests compare the CUDA kernels with the twin on the
card. They import no JAX, so they run there with
`python -m pytest tests/test_torch_dense_v4.py --noconftest -o addopts=""
-m requires_cuda`.
"""
import numpy as np
import pytest
import torch

from pbrlab_tpu_torch.core.math import INF
from pbrlab_tpu_torch.ops import dense_v4
from pbrlab_tpu_torch.ops.build import build_v5
from pbrlab_tpu_torch.ops.intersect import occluded_scene
from pbrlab_tpu_torch.scene.demo import build_demo_scene
from pbrlab_tpu_torch.scene.scene import scene_from_numpy
from test_torch_per_ray import BIG, F, NumpyWalk
from torch_threads import one_torch_thread  # noqa: F401

N = 1500  # not a multiple of 1024 or of the kernels' 128-thread blocks


@pytest.fixture(scope="module")
def scene_np():
    return build_demo_scene(subdiv=1)[0]


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


def _check(got, want, rtol=1e-5):
    """The band against JAX (module docstring)."""
    got = {k: np.asarray(v) for k, v in got.items()}
    want = {k: np.asarray(v) for k, v in want.items()}
    hit = want["prim"] >= 0
    np.testing.assert_array_equal(got["prim"] >= 0, hit)
    assert hit.mean() > 0.3  # the rays do hit the scene
    for k in ("t", "u", "v"):
        np.testing.assert_allclose(got[k][hit], want[k][hit], rtol=rtol,
                                   atol=1e-6)
    np.testing.assert_array_equal(got["t"][~hit], np.float32(INF))
    differ = hit & (got["prim"] != want["prim"])
    np.testing.assert_allclose(got["t"][differ], want["t"][differ],
                               rtol=rtol)
    assert differ.mean() < 1e-3


def _jax_args(scene_np, rays):
    import jax.numpy as jnp

    return ([jnp.asarray(scene_np["dense_tris_v4"]),
             jnp.asarray(scene_np["dense_cluster_aabb_v4"])]
            + [jnp.asarray(r) for r in rays])


def _torch_args(scene_np, rays, device="cpu"):
    scene = scene_from_numpy(scene_np, device)
    return ([scene["dense_tris_v4"], scene["dense_cluster_aabb_v4"]]
            + [torch.from_numpy(r).to(device) for r in rays])


def test_closest_matches_jax(scene_np):
    from pbrlab_tpu.ops.pallas import dense_v4 as jv4

    rays = _rays(scene_np, N, 1)[:4]
    want = jv4.dense_trace_v4(*_jax_args(scene_np, rays), interpret=True)
    got = dense_v4.dense_trace_v4(*_torch_args(scene_np, rays))
    assert got["prim"].dtype == torch.int32 and got["t"].shape == (N,)
    _check(got, want)
    # max_t clips: no hit at or beyond a lane's max_t
    t, mx = got["t"].numpy(), rays[3]
    assert (t[got["prim"].numpy() >= 0] < mx[got["prim"].numpy() >= 0]).all()


def test_any_hit_matches_jax(scene_np):
    from pbrlab_tpu.ops.pallas import dense_v4 as jv4

    rays = _rays(scene_np, N, 2)[:4]
    want = jv4.dense_trace_v4(*_jax_args(scene_np, rays), any_hit=True,
                              interpret=True)
    args = _torch_args(scene_np, rays)
    got = dense_v4.dense_trace_v4(*args, any_hit=True)
    np.testing.assert_array_equal(got["prim"].numpy() >= 0,
                                  np.asarray(want["prim"]) >= 0)
    assert not (got["prim"].numpy()[::7] >= 0).any()  # dead lanes
    scene = scene_from_numpy(scene_np, "cpu")
    assert torch.equal(occluded_scene(scene, *args[2:]), got["prim"] >= 0)


def test_dual_matches_jax(scene_np):
    from pbrlab_tpu.ops.pallas import dense_v4 as jv4

    rays = _rays(scene_np, N, 3)
    want, want_occ = jv4.dense_trace_v4_dual(*_jax_args(scene_np, rays),
                                             interpret=True)
    got, occ = dense_v4.dense_trace_v4_dual(*_torch_args(scene_np, rays))
    _check(got, want)
    assert occ.dtype == torch.bool
    np.testing.assert_array_equal(occ.numpy(), np.asarray(want_occ))
    assert 0.05 < occ.float().mean() < 0.95
    assert not occ.numpy()[rays[6] < rays[5]].any()


def test_wrappers_take_plain_walk_on_cpu(scene_np):
    """On CPU tensors the wrappers are the plain versions, and launch no
    kernel."""
    args = _torch_args(scene_np, _rays(scene_np, 300, 4))
    before = dict(dense_v4.LAUNCHES)
    got, occ = dense_v4.dense_trace_v4_dual(*args)
    ref, ref_occ = dense_v4.dense_trace_v4_dual_ref(*args)
    for k in got:
        assert torch.equal(got[k], ref[k])
    assert torch.equal(occ, ref_occ)
    assert dense_v4.LAUNCHES == before


class NumpyClusterWalk(NumpyWalk):
    """Each lane on its own, in numpy float32, written from the walk's
    rules: the slab test against every cluster box capped at max t, the
    entered clusters sorted by entry t (Python's stable sort: ties by the
    lower id), then each cluster's 32 triangles in order until `tn (1 -
    1e-6) - 1e-6 > best t`; any-hit stops after the first cluster with a
    hit. The slab and leaf tests are NumpyWalk's."""

    def __init__(self, tris, aabb):
        m = aabb.shape[1]
        super().__init__(lambda b: tris[:, b:b + 32], aabb[:6],
                         np.zeros((2, m), np.int32))
        self.m = m

    def clusters(self, org, direction, min_t, max_t, any_hit=False):
        """Per lane: t, u, v, prim, tie, the counts [n, 3] (triangle and
        box tests, 0) and the number of clusters entered."""
        out = {k: [] for k in ("t", "u", "v", "prim", "tie", "work",
                               "entered")}
        for i in range(org.shape[0]):
            fr = self.frame(org[i], direction[i])
            s = dict(t=max_t[i], u=F(0), v=F(0), prim=-1, tie=False,
                     mint=min_t[i], tri=0, box=0)
            entries = []
            if max_t[i] >= min_t[i]:
                s["box"] = self.m
                for c in range(self.m):
                    tn = self.slab(c, fr, min_t[i], max_t[i])
                    if tn < BIG:
                        entries.append((tn, c))
                entries.sort(key=lambda e: e[0])
            for tn, c in entries:
                if not tn * F(0.999999) - F(1e-6) <= s["t"]:
                    break
                self.leaf(32 * c, 0, fr, s)
                if any_hit and s["prim"] >= 0:
                    break
            for k in ("t", "u", "v", "prim", "tie"):
                out[k].append(s[k])
            out["work"].append((s["tri"], s["box"], 0))
            out["entered"].append(len(entries))
        return {k: np.asarray(v) for k, v in out.items()}


def _check_numpy(twin, want):
    """Twin (t, u, v, prim, counts) against the numpy walk: t and the
    counts equal, prim wherever no other triangle gave the lane its t."""
    t, u, v, prim, work = (x.numpy() for x in twin)
    np.testing.assert_array_equal(t, want["t"].astype(F))
    unique = ~want["tie"]
    assert unique.mean() > 0.9
    np.testing.assert_array_equal(prim[unique], want["prim"][unique])
    same = prim == want["prim"]
    np.testing.assert_array_equal(u[same], want["u"][same].astype(F))
    np.testing.assert_array_equal(v[same], want["v"][same].astype(F))
    np.testing.assert_array_equal(work, want["work"])


def _tables(scene_np):
    tris, aabb = (np.asarray(scene_np[k]) for k in (
        "dense_tris_v4", "dense_cluster_aabb_v4"))
    return tris, aabb, [torch.from_numpy(x) for x in (tris, aabb)]


@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any"])
def test_twin_matches_numpy_walk(scene_np, any_hit):
    """48 lanes of the JAX tests' rays (dead and clipped lanes among
    them)."""
    tris, aabb, tt = _tables(scene_np)
    rays = _rays(scene_np, 48, 21)[:4]
    want = NumpyClusterWalk(tris, aabb).clusters(*rays, any_hit)
    got = dense_v4._v4_ref(*tt, *(torch.from_numpy(r) for r in rays),
                           any_hit=any_hit, counts=True)
    assert got[4] is None  # no shadow query, no occlusion
    _check_numpy([*got[:4], got[5]], want)
    hit = want["prim"] >= 0
    assert hit.mean() > 0.2 and not hit[::7].any()  # dead lanes
    # the lanes' own cull: no lane walks more clusters than it enters,
    # and some stop before the end of their lists
    walked = want["work"][:, 0] // 32
    assert (walked <= want["entered"]).all()
    assert (walked < want["entered"]).any()


def test_dual_twin_matches_numpy_walk(scene_np):
    """The dual's closest answer is the single walk's to the bit, its
    occlusion the numpy any-hit walk's of the shadow rays from the same
    origins (30% of the lanes ask none), its counts the sum of both."""
    tris, aabb, tt = _tables(scene_np)
    rays = _rays(scene_np, 48, 22)
    rt = [torch.from_numpy(r) for r in rays]
    *dual, occ, work = dense_v4._v4_ref(*tt, *rt[:4], shadow=rt[4:],
                                        counts=True)
    *single, _, single_work = dense_v4._v4_ref(*tt, *rt[:4], counts=True)
    for a, b in zip(dual, single):
        assert torch.equal(a, b)
    want = NumpyClusterWalk(tris, aabb).clusters(rays[0], *rays[4:], True)
    np.testing.assert_array_equal(occ.numpy(), want["prim"] >= 0)
    np.testing.assert_array_equal((work - single_work).numpy(), want["work"])
    assert 0.05 < occ.float().mean() < 0.95
    assert not occ.numpy()[rays[6] < rays[5]].any()


def capacity_scene(m=dense_v4.MAX_CLUSTERS):
    """m clusters along +x, cluster c's box x in [3 (m - 1 - c), +1], y
    and z in [-1, 1] (the highest id nearest the origin), each with one
    triangle facing -x in its slot 32 c: cluster 0's across the rays,
    every other one beside them (y in [2, 3]). A ray along +x from x
    = -10 enters all m boxes, in the reverse of their ids, and walks them
    all to hit cluster 0's triangle last."""
    tris = np.zeros((12, 32 * m), F)
    aabb = np.zeros((8, m), F)
    for c in range(m):
        x = 3.0 * (m - 1 - c)
        aabb[:3, c] = (x, -1.0, -1.0)
        aabb[3:6, c] = (x + 1.0, 1.0, 1.0)
        # cluster 0: y, z >= -2 and y + z <= 4; the others: y in [2, 3]
        v0, e = ((-2.0, 8.0), (2.0, 1.0))[c > 0]
        tris[:, 32 * c] = build_v5(np.array([[x + 0.5, v0, -2.0]], F),
                                   np.array([[0, 0, 8.0]], F),
                                   np.array([[0, e, 0]], F))[0][:, 0]
    return tris, aabb


def _capacity_rays(n):
    rng = np.random.default_rng(23)
    org = np.zeros((n, 3), F)
    org[:, 0] = -10.0
    org[:, 1:] = rng.uniform(-0.5, 0.5, (n, 2))
    d = np.zeros((n, 3), F)
    d[:, 0] = 1.0
    d[:, 1:] = rng.uniform(-1e-4, 1e-4, (n, 2))
    return org, d, np.zeros(n, F), np.full(n, INF, F)


@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any"])
def test_twin_at_cluster_capacity(any_hit):
    """Every lane enters all MAX_CLUSTERS boxes (a kernel lane's list is
    full) in the reverse of their ids and tests them all."""
    tris, aabb = capacity_scene()
    rays = _capacity_rays(16)
    want = NumpyClusterWalk(tris, aabb).clusters(*rays, any_hit)
    assert (want["entered"] == dense_v4.MAX_CLUSTERS).all()
    got = dense_v4._v4_ref(*(torch.from_numpy(x) for x in (tris, aabb)),
                           *(torch.from_numpy(r) for r in rays),
                           any_hit=any_hit, counts=True)
    _check_numpy([*got[:4], got[5]], want)
    assert (got[3] == 0).all()  # cluster 0's triangle, the last walked
    assert (got[5][:, 0] == 32 * dense_v4.MAX_CLUSTERS).all()
    np.testing.assert_allclose(got[0].numpy(), 3.0 * 255 + 10.5, rtol=1e-6)


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the dense_v4 kernels are CUDA-only)")


@pytest.mark.requires_cuda
def test_cuda_kernels_match_plain(scene_np):
    """Kernels vs twin on the card: same walk, same ops, no FMA
    contraction, IEEE division -> every output bit-equal, closest, any-hit
    and the dual (whose closest answer is the single kernel's); a table
    of the wrong shape raises."""
    _need_cuda()
    for n, seed in ((N, 5), (65536, 6)):
        args = _torch_args(scene_np, _rays(scene_np, n, seed), "cuda")
        before = dict(dense_v4.LAUNCHES)
        got = dense_v4._v4_cuda(*args[:6], shadow=args[6:])
        ref = dense_v4._v4_ref(*args[:6], shadow=args[6:])
        single = dense_v4._v4_cuda(*args[:6])
        torch.cuda.synchronize()
        assert dense_v4.LAUNCHES["dual"] == before["dual"] + 1
        for a, b, c in zip(got, ref, single):
            assert torch.equal(a, b)
            assert c is None or torch.equal(a, c)
        for any_hit in (False, True):
            got = dense_v4._v4_cuda(*args[:6], any_hit=any_hit)
            ref = dense_v4._v4_ref(*args[:6], any_hit=any_hit)
            torch.cuda.synchronize()
            for a, b in zip(got[:4], ref[:4]):
                assert torch.equal(a, b)
        wrapped = dense_v4.dense_trace_v4(*args[:6])
        plain = dense_v4.dense_trace_v4_ref(*args[:6])
        for k in wrapped:
            assert torch.equal(wrapped[k], plain[k]), k
    with pytest.raises(ValueError):
        dense_v4._v4_cuda(args[0][:, :-32].contiguous(), *args[1:6])


@pytest.mark.requires_cuda
@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any"])
def test_cuda_kernel_at_cluster_capacity(any_hit):
    """The kernel bit-equal to the twin when every lane's list holds all
    MAX_CLUSTERS clusters; one more cluster raises."""
    _need_cuda()
    tables = [torch.from_numpy(x).cuda() for x in capacity_scene()]
    rays = [torch.from_numpy(r).cuda() for r in _capacity_rays(2048)]
    got = dense_v4._v4_cuda(*tables, *rays, any_hit=any_hit)
    ref = dense_v4._v4_ref(*tables, *rays, any_hit=any_hit)
    torch.cuda.synchronize()
    for a, b in zip(got[:4], ref[:4]):
        assert torch.equal(a, b)
    assert (got[3] == 0).all()
    big = [torch.from_numpy(x).cuda()
           for x in capacity_scene(dense_v4.MAX_CLUSTERS + 1)]
    with pytest.raises(ValueError):
        dense_v4._v4_cuda(*big, *rays)
