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

Band (CPU measurement): the plain versions compute the Pallas bodies'
float32 linear forms in the same order, each product and sum rounded on
its own: t equals a numpy float32 evaluation of the winning triangle to
the bit. XLA:CPU contracts some products and sums into fused
multiply-adds (ROADMAP C7): against JAX, 12 of the 190 hit lanes differ
in t, 2 by more than rtol 1e-6 (3.5e-6 at most), u and v by 1.6e-6 at
most, for each of the four traces. So: hit masks equal except grazing
lanes (measured 0 of 500; allowed 1%), t within rtol 1e-6 on >= 98% of
hits and rtol 1e-5 on all, u and v within atol 1e-5, prim equal where t
is unique (measured: equal everywhere).

The requires_cuda test compares the CUDA kernels with the plain versions
on the card. This file imports JAX only inside tests and fixtures, so
that test runs there with `python -m pytest tests/test_torch_legacy.py
--noconftest -o addopts="" -m requires_cuda`.
"""
from functools import partial

import numpy as np
import pytest
import torch

from pbrlab_tpu_torch.core.math import INF
from pbrlab_tpu_torch.ops import dense, dense_v2, dense_v3
from pbrlab_tpu_torch.ops.intersect import _closest, trace_scene_dual
from pbrlab_tpu_torch.scene.demo import build_demo_scene
from pbrlab_tpu_torch.scene.scene import scene_from_numpy
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


def _tie_scene(ids):
    """Two coincident copies of one triangle in the columns `ids` of an
    otherwise empty 2-cluster table, both clusters boxed around it, and
    500 rays through its interior from above: every lane hits both copies
    at the same t."""
    from pbrlab_tpu_torch.ops.dense import pack_triangles

    v0 = np.asarray([[0.0, 0.0, 0.0]], np.float32)
    e1 = np.asarray([[1.0, 0.0, 0.0]], np.float32)
    e2 = np.asarray([[0.0, 0.0, 1.0]], np.float32)
    col, box, _ = pack_triangles(v0, e1, e2)
    tris = np.zeros((12, 256), np.float32)
    for i in ids:
        tris[:, i] = col[:, 0]
    aabb = np.concatenate([box[:, :1], box[:, :1]], axis=1)
    rng = np.random.default_rng(7)
    uv = rng.random((N, 2)) * 0.45
    org = np.stack([uv[:, 0], np.full(N, 1.0), uv[:, 1]], 1)
    d = np.tile([0.0, -1.0, 0.0], (N, 1))
    f32 = np.float32
    return tris, aabb, (org.astype(f32), d.astype(f32), np.zeros(N, f32),
                        np.full(N, INF, f32))


@pytest.mark.parametrize("name", ["v1", "v2", "v3-beam"])
def test_exact_tie_rules(jax_kernels, name):
    """Exact ties resolve as on the TPU. v1 keeps one best per triangle
    lane (id mod 128) and takes the lowest lane; v2 / v3 one per slot
    (id mod 8), the lowest slot, and within a slot the first visited.
    Copies at ids 10 (lane 10, slot 2) and 130 (lane 2, slot 2): v1 takes
    130, v2 / v3 take 10. Copies at 13 (slot 5) and 130 (slot 2): all
    take 130."""
    import jax.numpy as jnp

    fn, _, jax_name, kw = KERNELS[name]
    for ids, want_v1, want_v23 in (((10, 130), 130, 10),
                                   ((13, 130), 130, 130)):
        tris, aabb, rays = _tie_scene(ids)
        got = fn(torch.from_numpy(tris), torch.from_numpy(aabb),
                 *map(torch.from_numpy, rays), **kw)
        want = jax_kernels[jax_name](jnp.asarray(tris), jnp.asarray(aabb),
                                     *map(jnp.asarray, rays), **kw)
        expect = want_v1 if name == "v1" else want_v23
        assert (got["prim"].numpy() == expect).all(), (ids, name)
        np.testing.assert_array_equal(np.asarray(want["prim"]), expect)
        np.testing.assert_array_equal(got["t"].numpy(), np.float32(1.0))


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
    """cluster_mask, group_survivors_beam (mask and tnear) and
    signature_key equal JAX's on the subdiv=3 scene (21 clusters, 1024
    rays: no Pallas, plain XLA), and the beam cull is conservative: every
    group the per-ray mask passes, it passes."""
    import jax.numpy as jnp
    from pbrlab_tpu.ops.pallas import dense_v3 as jv3

    scene_np = build_demo_scene(subdiv=3)[0]
    rays = _rays(scene_np, 1024, 3)
    aabb = scene_np["dense_cluster_aabb"]
    targs = (torch.from_numpy(aabb), *map(torch.from_numpy, rays))
    jargs = (jnp.asarray(aabb), *map(jnp.asarray, rays))
    mask = dense_v3.cluster_mask(*targs)
    np.testing.assert_array_equal(mask.numpy(),
                                  np.asarray(jv3.cluster_mask(*jargs)))
    gm, tn = dense_v3.group_survivors_beam(*targs, return_tnear=True)
    jgm, jtn = jv3.group_survivors_beam(*jargs, return_tnear=True)
    np.testing.assert_array_equal(gm.numpy(), np.asarray(jgm))
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jtn))
    exact = mask.reshape(8, 128, -1).any(dim=1)
    assert bool((gm | ~exact).all())
    assert int(gm.sum()) > int(exact.sum()) > 0
    key = dense_v3.signature_key(*targs)
    np.testing.assert_array_equal(
        key.numpy(), np.asarray(jv3.signature_key(*jargs)).astype(np.int64))
    assert len(np.unique(key.numpy())) > 10


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
    from pbrlab_tpu_torch.render import integrator as tint
    from test_torch_integrator import _assert_state_close, _to_torch

    scene_j, scene_t = step_scenes
    state = legacy_states(backend)
    _force_jax_legacy(monkeypatch, backend)
    if kind != "full":
        walking = np.asarray(state.alive & (state.mode == jint.MODE_VOLUME))
        assert walking.sum() > 5
    want = jint.wavefront_step(scene_j, state, 0, **STEP_KINDS[kind])
    got = tint.wavefront_step(scene_t, _to_torch(state), tri_backend=backend,
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
    """Each kernel against its plain version on the card, on the subdiv=3
    scene (21 clusters): same ops, no FMA contraction, IEEE division, the
    same group decisions -> t, u, v and prim bit-equal, closest and
    any-hit, at 1500 and 65536 lanes; one launch per call."""
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
