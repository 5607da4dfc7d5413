"""The legacy dense v1 / v2 / v3 traces of the port against the JAX
package's Pallas kernels, and the render's `tri_backend` override.

On the CPU the port's wrappers run their plain torch versions; the
reference is pbrlab_tpu.ops.pallas.dense / dense_v2 / dense_v3 in
interpret mode, on the subdiv=1 demo scene (2 clusters of 128) and 500
numpy-seeded rays (a partial last group, dead lanes, clipped max_t).
JAX's dense_trace_v3 is jitted anew over 128-ray tiles (RAY_TILE = 128,
GROUPS = 1 while it traces): its 128-ray groups are independent, so the
real lanes get the same result as over the 4096-ray tile, and the
interpret-mode program is 32 times smaller (compile ~2.5 s, not ~50 s;
the 500-ray results are bit-equal either way, CPU measurement). Its own
jitted function and cache are untouched.

All three walk per ray now, on one kernel and one twin (`dense.walk_ref`:
each lane walks the clusters its own ray enters, in the order of its own
entry t, until its own best t), where the TPU's kernels walk groups (v1
8-ray blocks, v2 128-ray groups, v3 a group's survivor list behind a beam
cull); so on rays that graze a cluster box they may differ from JAX
(ROADMAP C3), within the band below. Their tie rules differ: v1 takes the
lexicographic minimum of (t, id mod 128, id) up to max_t inclusive, v2
of (t, id mod 8, id) below max_t; neither depends on the visit order, so
both match JAX on full ties too. v3 takes (t, id mod 8), then the first
visited, which follows the walk (ROADMAP C3: a nested box's copy wins in
the port and in JAX's beam cull, the other copy in JAX's exact cull), and
its `cull` argument no longer changes the answer. Measured (CPU, 500
rays): closest, for each of v1, v2 and v3 (either cull), hit masks and
prim equal to JAX's on all 190 hit lanes, t bit-equal on 178
(relative <= 3.5e-6, XLA:CPU's contractions, below), u and v within
1.9e-6; any-hit masks equal (v2, v3; v1 answers the closest hit).
The three twins are also held against an independent per-lane numpy loop
(test_torch_dense_curve.py's `NumpyChunkWalk` with the legacy triangle
test and each kernel's tie rule), also on a synthetic scene of more
clusters than a lane's list holds.

Band (CPU measurement): the plain versions compute the Pallas bodies'
float32 linear forms in the same order, each product and sum rounded on
its own: t equals a numpy float32 evaluation of the winning triangle to
the bit. XLA:CPU contracts some products and sums into fused
multiply-adds (ROADMAP C7): against JAX, 12 of the 190 hit lanes differ
in t, 2 by more than rtol 1e-6 (3.5e-6 at most), u and v by 1.9e-6 at
most, for each of the four traces. So: hit masks equal except grazing
lanes (measured 0 of 500; allowed 1%), t within rtol 1e-6 on >= 98% of
hits and rtol 1e-5 on all, u and v within atol 1e-5, prim equal where t
is unique (measured: equal everywhere).

The requires_cuda tests compare the CUDA kernels with the plain versions
on the card. This file imports JAX only inside tests and fixtures, so
that test runs there with `python -m pytest tests/test_torch_legacy.py
--noconftest -o addopts="" -m requires_cuda`.
"""
from functools import partial

import numpy as np
import pytest
import torch

from pbrlab_tpu_torch.core.math import INF
from pbrlab_tpu_torch.ops import (dense, dense_curve, dense_v2, dense_v3,
                                  per_ray)
from pbrlab_tpu_torch.ops.dense_curve import _inv
from pbrlab_tpu_torch.ops.intersect import _closest, trace_scene_dual
from pbrlab_tpu_torch.scene.demo import build_demo_scene
from pbrlab_tpu_torch.scene.scene import scene_from_numpy
from test_torch_dense_curve import (CHUNK_M, F, NumpyChunkWalk, chunk_rays,
                                    chunk_segs)
from torch_threads import one_torch_thread  # noqa: F401

N = 500  # not a multiple of the 128-ray group: exercises the padding
KERNELS = {  # name: (port wrapper, its plain version, JAX module, kwargs)
    "v1": (dense.dense_trace, dense.dense_trace_ref, "dense", {}),
    "v2": (dense_v2.dense_trace_v2, dense_v2.dense_trace_v2_ref,
           "dense_v2", {}),
    "v3-beam": (dense_v3.dense_trace_v3, dense_v3.dense_trace_v3_ref,
                "dense_v3", {"cull": "beam"}),
    "v3-exact": (dense_v3.dense_trace_v3, dense_v3.dense_trace_v3_ref,
                 "dense_v3", {"cull": "exact"}),
}
_JAX_V3 = []


@pytest.fixture(scope="module")
def scene_np():
    return build_demo_scene(subdiv=1)[0]


def _rays(scene_np, n, seed):
    """tests/test_dense.py's rays (origins over 1.5x the scene box, uniform
    directions) with min_t 1e-3, every 7th lane dead and every 5th (from
    the 4th) clipped to a max_t in [0, 2)."""
    rng = np.random.default_rng(seed)
    bmin, bmax = scene_np["aabb_min"], scene_np["aabb_max"]
    ext = bmax - bmin
    org = bmin + rng.random((n, 3)) * ext * 1.5 - 0.25 * ext
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    max_t = np.full(n, INF)
    max_t[3::5] = rng.random(len(max_t[3::5])) * 2.0
    max_t[::7] = -1.0
    f32 = np.float32
    return (org.astype(f32), d.astype(f32), np.full(n, 1e-3, f32),
            max_t.astype(f32))


def _tables(scene_np, device="cpu"):
    scene = scene_from_numpy(scene_np, device)
    return scene["dense_tris"], scene["dense_cluster_aabb"]


def _jax_kernels(mp):
    """name -> JAX trace in interpret mode; dense_trace_v3 over 128-ray
    tiles through its own jitted copy (see the module docstring), while
    the monkeypatch mp holds RAY_TILE and GROUPS."""
    import jax
    from pbrlab_tpu.ops.pallas import dense as jv1
    from pbrlab_tpu.ops.pallas import dense_v2 as jv2
    from pbrlab_tpu.ops.pallas import dense_v3 as jv3

    mp.setattr(jv3, "RAY_TILE", 128)
    mp.setattr(jv3, "GROUPS", 1)
    if not _JAX_V3:
        _JAX_V3.append(jax.jit(jv3.dense_trace_v3.__wrapped__,
                               static_argnames=("any_hit", "interpret",
                                                "cull")))
    return {"dense": partial(jv1.dense_trace, interpret=True),
            "dense_v2": partial(jv2.dense_trace_v2, interpret=True),
            "dense_v3": partial(_JAX_V3[0], interpret=True)}


@pytest.fixture()
def jax_kernels(monkeypatch):
    return _jax_kernels(monkeypatch)


def _force_jax_legacy(mp, backend):
    """Force the JAX package onto a legacy backend, its kernels
    interpreted (its `_closest_tri` / `_occluded_tri` call dense_trace_v3
    / v2 without `interpret=`)."""
    from pbrlab_tpu.ops.pallas import dense_v2 as jv2
    from pbrlab_tpu.ops.pallas import dense_v3 as jv3

    kernels = _jax_kernels(mp)
    mp.setenv("PBRLAB_TRACE_BACKEND", backend)
    mp.setattr(jv3, "dense_trace_v3", kernels["dense_v3"])
    mp.setattr(jv2, "dense_trace_v2", kernels["dense_v2"])


def _numpy_t(tris, prim, rays):
    """t of each lane's winning (sorted) triangle in numpy float32, every
    product and sum rounded on its own, in the Pallas order."""
    org, d = rays[0], rays[1]
    col = tris[:, np.maximum(prim, 0)]
    den = (d[:, 0] * col[0] + d[:, 1] * col[1]) + d[:, 2] * col[2]
    num = col[3] - ((org[:, 0] * col[0] + org[:, 1] * col[1])
                    + org[:, 2] * col[2])
    return num / den


def _check(got, want, tris, rays, any_hit=False):
    got = {k: v.numpy() for k, v in got.items()}
    want = {k: np.asarray(v) for k, v in want.items()}
    hit = want["prim"] >= 0
    assert got["prim"].dtype == np.int32 and got["t"].shape == (N,)
    grazing = (got["prim"] >= 0) != hit
    assert grazing.mean() <= 0.01, int(grazing.sum())
    assert 0.3 < hit.mean() < 0.9  # the rays do hit the scene, not all
    assert not (got["prim"][::7] >= 0).any()  # dead lanes
    both = hit & (got["prim"] >= 0)
    np.testing.assert_array_equal(got["t"][got["prim"] < 0], np.float32(INF))
    if any_hit:
        return
    t, tw = got["t"][both], want["t"][both]
    np.testing.assert_array_equal(t, _numpy_t(tris, got["prim"],
                                              rays)[both])
    assert np.isclose(t, tw, rtol=1e-6, atol=0).mean() >= 0.98
    np.testing.assert_allclose(t, tw, rtol=1e-5)
    for k in ("u", "v"):
        np.testing.assert_allclose(got[k][both], want[k][both], atol=1e-5)
    differ = both & (got["prim"] != want["prim"])
    np.testing.assert_allclose(got["t"][differ], want["t"][differ],
                               rtol=1e-6)
    assert differ.mean() < 1e-2
    # max_t clips: a hit lies inside [min_t, max_t]
    assert (got["t"][got["prim"] >= 0]
            <= rays[3][got["prim"] >= 0]).all()


@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any-hit"])
@pytest.mark.parametrize("name", list(KERNELS))
def test_plain_matches_jax(scene_np, jax_kernels, name, any_hit):
    """Each plain version against JAX's interpret-mode kernel (v1 ignores
    any_hit, as in JAX: both give the closest hit)."""
    import jax.numpy as jnp

    fn, ref_fn, jax_name, kw = KERNELS[name]
    rays = _rays(scene_np, N, 1)
    want = jax_kernels[jax_name](
        jnp.asarray(scene_np["dense_tris"]),
        jnp.asarray(scene_np["dense_cluster_aabb"]),
        *map(jnp.asarray, rays), any_hit=any_hit, **kw)
    args = (*_tables(scene_np), *map(torch.from_numpy, rays))
    got = fn(*args, any_hit=any_hit, **kw)
    _check(got, want, scene_np["dense_tris"], rays,
           any_hit=any_hit and name != "v1")
    ref = ref_fn(*args, any_hit=any_hit, **kw)  # the CPU wrapper is plain
    for k in got:
        assert torch.equal(got[k], ref[k]), k


def _tie_scene(ids, nested=False):
    """Coincident copies of one triangle in the columns `ids` of an
    otherwise empty 2-cluster table, both clusters boxed around it (with
    nested, cluster 1's box grown by 0.5 on every side, so a ray enters
    it first), and 500 rays through its interior from above: every lane
    hits every copy at t = 1."""
    from pbrlab_tpu_torch.ops.dense import pack_triangles

    v0 = np.asarray([[0.0, 0.0, 0.0]], np.float32)
    e1 = np.asarray([[1.0, 0.0, 0.0]], np.float32)
    e2 = np.asarray([[0.0, 0.0, 1.0]], np.float32)
    col, box, _ = pack_triangles(v0, e1, e2)
    tris = np.zeros((12, 256), np.float32)
    for i in ids:
        tris[:, i] = col[:, 0]
    aabb = np.concatenate([box[:, :1], box[:, :1]], axis=1)
    if nested:
        aabb[0:3, 1] -= 0.5
        aabb[3:6, 1] += 0.5
    rng = np.random.default_rng(7)
    uv = rng.random((N, 2)) * 0.45
    org = np.stack([uv[:, 0], np.full(N, 1.0), uv[:, 1]], 1)
    d = np.tile([0.0, -1.0, 0.0], (N, 1))
    f32 = np.float32
    return tris, aabb, (org.astype(f32), d.astype(f32), np.zeros(N, f32),
                        np.full(N, INF, f32))


# (copies, nested): (port, JAX) per kernel; v3 on a full tie keeps the
# first visited, and the port's walk, JAX's beam and JAX's exact survivor
# lists visit the nested pair in other orders (ROADMAP C3)
TIES = {((10, 130), False): {"v1": (130, 130), "v2": (10, 10),
                             "v3-beam": (10, 10), "v3-exact": (10, 10)},
        ((13, 130), False): {"v1": (130, 130), "v2": (130, 130),
                             "v3-beam": (130, 130), "v3-exact": (130, 130)},
        ((10, 138), True): {"v1": (10, 10), "v2": (10, 10),
                            "v3-beam": (138, 138), "v3-exact": (138, 10)}}


@pytest.mark.parametrize("name", ["v1", "v2", "v3-beam", "v3-exact"])
def test_exact_tie_rules(jax_kernels, name):
    """Exact ties resolve as on the TPU. v1 keeps one best per triangle
    lane (id mod 128) and takes the lowest lane; v2 / v3 one per slot
    (id mod 8), the lowest slot, and within a slot v1 and v2 the lowest
    id, v3 the first visited. Copies at ids 10 (lane 10, slot 2) and 130
    (lane 2, slot 2): v1 takes 130, v2 / v3 take 10. Copies at 13 (slot 5)
    and 130 (slot 2): all take 130. Copies at 10 and 138 (one lane, one
    slot) with cluster 1's box around cluster 0's, so that every ray
    enters cluster 1 first: v1 and v2 take 10, as JAX does; the port's v3
    walks cluster 1 first and takes 138, as JAX's beam cull does, where
    JAX's exact cull takes 10 (`TIES`)."""
    import jax.numpy as jnp

    fn, _, jax_name, kw = KERNELS[name]
    for (ids, nested), expect in TIES.items():
        tris, aabb, rays = _tie_scene(ids, nested)
        got = fn(torch.from_numpy(tris), torch.from_numpy(aabb),
                 *map(torch.from_numpy, rays), **kw)
        want = jax_kernels[jax_name](jnp.asarray(tris), jnp.asarray(aabb),
                                     *map(jnp.asarray, rays), **kw)
        port, jax_ = expect[name]
        assert (got["prim"].numpy() == port).all(), (ids, name)
        np.testing.assert_array_equal(np.asarray(want["prim"]), jax_)
        np.testing.assert_array_equal(got["t"].numpy(), np.float32(1.0))


@pytest.mark.parametrize("name", list(KERNELS))
def test_hit_at_max_t(jax_kernels, name):
    """A hit at exactly max_t (t = 1 to the bit): v1 bounds t by max_t
    inclusive (its best starts at INF) and hits, v2 and v3 fold max_t
    into the initial best with a strict `t < best` and miss; each as
    JAX."""
    import jax.numpy as jnp

    fn, _, jax_name, kw = KERNELS[name]
    tris, aabb, (org, d, min_t, _) = _tie_scene((10,))
    rays = (org, d, min_t, np.ones_like(min_t))
    got = fn(torch.from_numpy(tris), torch.from_numpy(aabb),
             *map(torch.from_numpy, rays), **kw)
    want = jax_kernels[jax_name](jnp.asarray(tris), jnp.asarray(aabb),
                                 *map(jnp.asarray, rays), **kw)
    prim = 10 if name == "v1" else -1
    assert (got["prim"].numpy() == prim).all()
    np.testing.assert_array_equal(np.asarray(want["prim"]), prim)
    np.testing.assert_array_equal(got["t"].numpy(),
                                  np.float32(1.0 if prim >= 0 else INF))
    np.testing.assert_array_equal(np.asarray(want["t"]), got["t"].numpy())


def test_pack_triangles_matches_jax():
    from pbrlab_tpu.ops.pallas.dense import pack_triangles as jpack

    scene, _ = build_demo_scene(subdiv=2)
    args = (scene["tri_v0"], scene["tri_e1"], scene["tri_e2"])
    for got, want in zip(dense.pack_triangles(*args), jpack(*args)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    empty = np.zeros((0, 3), np.float32)
    for got, want in zip(dense.pack_triangles(empty, empty, empty),
                         jpack(empty, empty, empty)):
        np.testing.assert_array_equal(got, want)


def test_cull_matches_jax():
    """The v3 walk's box test (`per_ray.diff_enter`, capped at max_t)
    passes exactly where JAX's per-ray `cluster_mask` does, on the subdiv=3
    scene (21 clusters, 1024 rays: no Pallas, plain XLA); its entry t is
    the one JAX's slab gives, and JAX's group beam cull (the TPU kernel's
    prelude) passes every group the per-ray test passes: the per-ray walk
    culls no more than the test JAX builds its cull from."""
    import jax.numpy as jnp
    from pbrlab_tpu.ops.pallas import dense_v3 as jv3

    scene_np = build_demo_scene(subdiv=3)[0]
    rays = _rays(scene_np, 1024, 3)
    aabb = scene_np["dense_cluster_aabb"]
    org, d, mn, mx = map(torch.from_numpy, rays)
    tn = per_ray.diff_enter(torch.from_numpy(aabb), org, _inv(d), mn)(
        0, aabb.shape[1], mx)
    live = (mx >= mn)[:, None]
    enters = ((tn < 1e30) & live).numpy()
    jargs = (jnp.asarray(aabb), *map(jnp.asarray, rays))
    np.testing.assert_array_equal(enters,
                                  np.asarray(jv3.cluster_mask(*jargs)))
    assert 0.05 < enters.mean() < 0.9
    o, i = rays[0], 1.0 / np.where(np.abs(rays[1]) < 1e-12, 1e-12, rays[1])
    t0 = (aabb[None, 0:3] - o[:, :, None]) * i[:, :, None]
    t1 = (aabb[None, 3:6] - o[:, :, None]) * i[:, :, None]
    tnear = np.minimum(t0, t1).max(axis=1)  # numpy float32, no contraction
    np.testing.assert_array_equal(tn.numpy()[enters], tnear[enters])
    gm = np.asarray(jv3.group_survivors_beam(*jargs))
    exact = enters.reshape(8, 128, -1).any(axis=1)
    assert (gm | ~exact).all() and gm.sum() > exact.sum() > 0


class NumpyV3Walk(NumpyChunkWalk):
    """NumpyChunkWalk (test_torch_dense_curve.py: chunks, the legacy box
    test, stable order, the lane's own exit) over the v1 tables: the
    Pallas body's ray-triangle test on the linear forms, every product and
    sum rounded on its own, in its order, and a kernel's tie rule: a valid
    triangle taken when its t is smaller, or equal with a lower id mod
    `slots`, or with by_id an equal slot and a lower id; with up_to one
    at the lane's max t while it has no hit (`RULES`)."""

    def __init__(self, tris, aabb, slots=8, by_id=False, up_to=False):
        super().__init__(aabb)
        self.tris = tris
        self.slots, self.by_id, self.up_to = slots, by_id, up_to

    def beats(self, t, i, s):
        if t != s["t"]:
            return t < s["t"]
        if s["prim"] < 0:
            return self.up_to
        a, b = i % self.slots, s["prim"] % self.slots
        return a < b or (self.by_id and a == b and i < s["prim"])

    def test(self, c, o, d, mint):
        (nx, ny, nz, k0, b1x, b1y, b1z, c1, b2x, b2y, b2z,
         c2) = self.tris[:, c * self.size:(c + 1) * self.size]
        with np.errstate(all="ignore"):
            den = (d[0] * nx + d[1] * ny) + d[2] * nz
            num = k0 - ((o[0] * nx + o[1] * ny) + o[2] * nz)
            t = num / np.where(np.abs(den) < F(1e-12), F(1e-12), den)
            u = (((o[0] * b1x + o[1] * b1y) + o[2] * b1z) - c1) \
                + t * ((d[0] * b1x + d[1] * b1y) + d[2] * b1z)
            v = (((o[0] * b2x + o[1] * b2y) + o[2] * b2z) - c2) \
                + t * ((d[0] * b2x + d[1] * b2y) + d[2] * b2z)
        ok = ((np.abs(den) > F(1e-12)) & (u >= 0) & (v >= 0) & (u + v <= 1)
              & (t >= mint))
        return t, u, v, ok


def chunk_tris():
    """The legacy tables of test_torch_dense_curve.py's `chunk_segs`
    scene: the same CHUNK_M boxes, each cluster's one triangle facing -x
    across the x axis (y, z in [-0.5, 1], x at the box's middle) in
    column 128 c + (5 c mod 128)."""
    from pbrlab_tpu_torch.ops.dense import pack_triangles

    _, aabb = chunk_segs()
    tris = np.zeros((12, 128 * CHUNK_M), F)
    for c in range(CHUNK_M):
        x = 3.0 * (CHUNK_M - 1 - c) + 0.5
        col, _, _ = pack_triangles(np.array([[x, -0.5, -0.5]], F),
                                   np.array([[0.0, 0.0, 1.5]], F),
                                   np.array([[0.0, 1.5, 0.0]], F))
        tris[:, 128 * c + 5 * c % 128] = col[:, 0]
    return tris, aabb


# name: (module, NumpyV3Walk's rule); v1 ignores any_hit
RULES = {"v1": (dense, dict(slots=128, by_id=True, up_to=True)),
         "v2": (dense_v2, dict(by_id=True)),
         "v3": (dense_v3, {})}


@pytest.mark.parametrize("name", list(RULES))
@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any"])
@pytest.mark.parametrize("case", ["scene", "chunks"])
def test_v3_twin_matches_numpy_walk(case, any_hit, name):
    """The twins of the three legacy kernels on v3's walk against
    NumpyV3Walk with each kernel's rule: t, u, v, prim and each lane's
    triangle and box tests equal, on 48 of the JAX tests' rays through the
    subdiv=3 scene (21 clusters) and on 40 lanes of the synthetic scene
    of CHUNK_M clusters, whose walks go through two chunks."""
    module, rule = RULES[name]
    if case == "scene":
        scene_np = build_demo_scene(subdiv=3)[0]
        tris, aabb = scene_np["dense_tris"], scene_np["dense_cluster_aabb"]
        rays = _rays(scene_np, 48, 21)
    else:
        tris, aabb = chunk_tris()
        rays = chunk_rays(40)
    want = NumpyV3Walk(tris, aabb, **rule).walk(
        *rays, any_hit and name != "v1")
    if name == "v1":  # its miss's t is INF
        want["t"] = np.where(want["prim"] >= 0, want["t"], F(INF))
    got = module._walk_ref(torch.from_numpy(tris), torch.from_numpy(aabb),
                           *dense_curve.clamped_rays(
                               *map(torch.from_numpy, rays)),
                           any_hit=any_hit, counts=True)
    for x, key in zip(got, ("t", "u", "v", "prim", "work")):
        np.testing.assert_array_equal(x.numpy(), want[key], err_msg=key)
    hit = want["prim"] >= 0
    assert 0.1 < hit.mean() < 0.9 and not hit[::7].any()  # dead lanes
    walked = want["work"][:, 0] // 128
    assert (walked <= want["entered"]).all()
    if case == "chunks" and not any_hit:
        assert (want["entered"] > per_ray.LIST).any()
        assert (want["prim"][:20][rays[3][:20] == INF]
                == 128 * (CHUNK_M - 1) + 5 * (CHUNK_M - 1) % 128).all()


def test_wrappers_take_plain_version_on_cpu(scene_np):
    """On CPU tensors the wrappers launch no kernel."""
    before = [dict(m.LAUNCHES) for m in (dense, dense_v2, dense_v3)]
    args = (*_tables(scene_np), *map(torch.from_numpy,
                                      _rays(scene_np, 300, 4)))
    for fn, _, _, kw in KERNELS.values():
        fn(*args, **kw)
        fn(*args, any_hit=True, **kw)
    assert [m.LAUNCHES for m in (dense, dense_v2, dense_v3)] == before


def test_legacy_dispatch_remaps_prim(scene_np):
    """The dispatch maps the legacy kernels' sorted ids to slot ids
    through dense_order: the same hits as dense_v4 (bit-equal t, equal
    prim where t is unique), in two launches for the dual query."""
    scene = scene_from_numpy(scene_np, "cpu")
    org, d, mn, mx = map(torch.from_numpy, _rays(scene_np, N, 5))
    want = _closest(scene, "dense4", org, d, mn, mx)
    for backend in ("dense3", "dense", "dense2"):
        got = _closest(scene, backend, org, d, mn, mx)
        assert torch.equal(got["prim"] >= 0, want["prim"] >= 0)
        assert torch.equal(got["t"], want["t"])
        unique = got["prim"] >= 0
        assert (got["prim"] == want["prim"])[unique].float().mean() > 0.99
        before = dict(dense_v3.LAUNCHES), dict(dense_v2.LAUNCHES)
        hit, occ = trace_scene_dual(scene, org, d, mn, mx, d, mn, mx,
                                    backend=backend)
        assert torch.equal(hit["prim"], got["prim"])
        assert torch.equal(occ, got["prim"] >= 0)
        assert (dict(dense_v3.LAUNCHES), dict(dense_v2.LAUNCHES)) == before


STEP_KINDS = {  # tests/test_torch_integrator.py:139
    "full": {},
    "first-substep": dict(freeze_surface=True, resolve_pending=True,
                          windowed=True),
    "later-substep": dict(freeze_surface=True, resolve_pending=False,
                          windowed=True),
    "unwindowed-substep": dict(freeze_surface=True, resolve_pending=False),
}


@pytest.fixture(scope="module")
def step_scenes():
    """The demo scene (glossy + SSS bodies): the JAX package's commit,
    handed to both packages."""
    from pbrlab_tpu.scene.demo import build_demo_scene as jbuild
    from pbrlab_tpu.scene.scene import build_fat_tables as jfat
    from pbrlab_tpu.scene.scene import scene_to_device
    from pbrlab_tpu_torch.scene.scene import build_fat_tables

    scene_np, _ = jbuild(subdiv=1)
    return (jfat(scene_to_device(scene_np)),
            build_fat_tables(scene_from_numpy(scene_np, "cpu")))


@pytest.fixture(scope="module")
def legacy_states(step_scenes):
    """JAX's 32x16 camera lanes after two steps on a legacy backend, as
    `legacy_states(backend)`: computed once per backend in this module
    (JAX states are immutable; each test hands the port a copy)."""
    from pbrlab_tpu.render import integrator as jint

    scene_j = step_scenes[0]
    cache = {}

    def state(backend):
        if backend not in cache:
            with pytest.MonkeyPatch.context() as mp:
                _force_jax_legacy(mp, backend)
                st = jint.init_state(scene_j, 32, 16, np.uint32(0), 3)
                for _ in range(2):
                    st = jint.wavefront_step(scene_j, st, 0)
            cache[backend] = st
        return cache[backend]
    return state


@pytest.mark.parametrize("kind", list(STEP_KINDS))
@pytest.mark.parametrize("backend", ["dense3", "dense"])
def test_step_matches_jax(step_scenes, legacy_states, monkeypatch, backend,
                          kind):
    """One step of each kind with `tri_backend` forced to a legacy
    backend, against JAX forced by PBRLAB_TRACE_BACKEND to the same one
    (`_force_jax_legacy`). The state: JAX's 32x16 camera lanes after two
    steps on that backend. The band of tests/test_torch_integrator.py."""
    from pbrlab_tpu.render import integrator as jint
    from test_torch_integrator import _assert_state_close, _step, _to_torch

    scene_j, scene_t = step_scenes
    state = legacy_states(backend)
    _force_jax_legacy(monkeypatch, backend)
    if kind != "full":
        walking = np.asarray(state.alive & (state.mode == jint.MODE_VOLUME))
        assert walking.sum() > 5
    want = jint.wavefront_step(scene_j, state, 0, **STEP_KINDS[kind])
    got = _step(scene_t, _to_torch(state), tri_backend=backend,
                **STEP_KINDS[kind])
    _assert_state_close(got, want)


@pytest.mark.parametrize("backend", ["dense3", "dense"])
def test_render_through_legacy_backend(backend):
    """The golden SSS scene at the goldens' size (16x16, 4 spp,
    max_steps 6, k_volume 2) through a legacy backend against the scene's
    own (dense_v4). The hits are the same up to exact ties (another face
    of a shared edge: another interpolated normal) and grazing lanes, so
    the band is the goldens' (>= 99% of values within rtol 1e-3/atol
    1e-4, the mean within 1e-3 relative); measured on the CPU: all values
    bit-equal for both."""
    from pbrlab_tpu_torch.render.integrator import render

    scene = scene_from_numpy(build_demo_scene(subdiv=1,
                                              with_monkey=False)[0], "cpu")
    kw = dict(seed=7, max_steps=6, k_volume=2)
    want = render(scene, 16, 16, 4, **kw).numpy()
    before = dict(dense_v3.LAUNCHES), dict(dense_v2.LAUNCHES)
    img = render(scene, 16, 16, 4, tri_backend=backend, **kw).numpy()
    assert (dict(dense_v3.LAUNCHES), dict(dense_v2.LAUNCHES)) == before
    assert np.isfinite(img).all() and (img >= 0).all() and img.mean() > 0
    assert np.isclose(img, want, rtol=1e-3, atol=1e-4).mean() >= 0.99
    assert abs(img.mean() - want.mean()) <= 1e-3 * want.mean()


@pytest.mark.requires_cuda
@pytest.mark.parametrize("name", list(KERNELS))
def test_cuda_kernel_matches_plain(name):
    """Each kernel against its twin on the card, on the subdiv=3 scene
    (21 clusters): same ops, no FMA contraction, IEEE division, each
    lane's clusters in the same order -> t, u, v and prim bit-equal,
    closest and any-hit, at 1500 and 65536 lanes; one launch per call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the legacy kernels are CUDA-only)")
    fn, ref_fn, _, kw = KERNELS[name]
    module = {"v1": dense, "v2": dense_v2}.get(name, dense_v3)
    scene_np = build_demo_scene(subdiv=3)[0]
    tables = _tables(scene_np, "cuda")
    for n, seed in ((1500, 5), (65536, 6)):
        args = (*tables, *(torch.from_numpy(r).cuda()
                           for r in _rays(scene_np, n, seed)))
        for any_hit in (False, True):
            kind = "any_hit" if any_hit else "closest"
            before = module.LAUNCHES[kind]
            got = fn(*args, any_hit=any_hit, **kw)
            ref = ref_fn(*args, any_hit=any_hit, **kw)
            torch.cuda.synchronize()
            assert module.LAUNCHES[kind] == before + 1
            for k in ("t", "u", "v", "prim"):
                assert torch.equal(got[k], ref[k]), (n, kind, k)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any"])
@pytest.mark.parametrize("name", list(RULES))
def test_cuda_legacy_walks_chunks(name, any_hit):
    """Each legacy kernel vs its twin on the synthetic scene of CHUNK_M
    clusters (two chunks of a lane's list), 2048 lanes: t, u, v, prim
    bit-equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the legacy kernels are CUDA-only)")
    module = RULES[name][0]
    tris, aabb = (torch.from_numpy(x).cuda() for x in chunk_tris())
    rays = dense_curve.clamped_rays(*(torch.from_numpy(r).cuda()
                                      for r in chunk_rays(2048)))
    got = module._walk_cuda(tris, aabb, *rays, any_hit=any_hit)
    ref = module._walk_ref(tris, aabb, *rays, any_hit=any_hit)
    torch.cuda.synchronize()
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    assert bool((ref[3] >= 0).any())
