"""The port's threaded-BVH backend ("bvh") and curve-BVH walk against the
JAX package's CPU traces.

(a) `commit`, `commit_curves` and `build_instanced` give the `bvh_*` and
    `cbvh_*` tables of the JAX package bit for bit (the demo at subdiv 1
    and 3, the hair golden scene, a 4-instance scene with hair).
(b) tests/test_intersect.py's four cases on the port's walk against the
    port's `intersect_bruteforce` (the demo at subdiv 2, 512 rays).
(c) The port against JAX on the same numpy-seeded rays (512 lanes):
    `intersect_bvh`, `occluded_bvh` and `intersect_bruteforce` give equal
    hit masks and prim on every lane; t within rtol 1e-6 and u, v within
    1e-6 (measured: t bit-equal on all but 5 of the 74 hit lanes, 1.4e-7
    relative at most; u and v within 2.4e-7: XLA:CPU contracts some
    products and sums that torch rounds apart, ROADMAP C7).
(d) `curve_trace` against JAX's on 3000 rays at the demo tuft: hit mask
    and seg equal but on grazing lanes (< 1%; measured: none), t within
    rtol 1e-6, u within 1e-5, v within 1e-4 and the tangent within 1e-6
    (measured below each, see `test_curve_trace_matches_jax`).
(e) The twins against a per-lane numpy loop of the kernels' design (one
    node pointer, a leaf's slots in order with a strict `<` under the
    leaf's entry cap, any-hit stopping after the first leaf with a hit):
    t, u, v, prim and each lane's test counts bit-equal.
(f) "bvh" on an instanced scene raises ValueError: it has no baked
    triangles.
"""
import types

import numpy as np
import pytest
import torch

from pbrlab_tpu_torch.core.math import INF
from pbrlab_tpu_torch.ops import bvh_walk, curves, intersect
from pbrlab_tpu_torch.scene.scene import scene_from_numpy
from torch_threads import one_torch_thread  # noqa: F401

TABLES = ("bvh_min", "bvh_max", "bvh_skip", "bvh_prim_offset",
          "bvh_prim_ids", "cbvh_min", "cbvh_max", "cbvh_skip",
          "cbvh_prim_offset", "cbvh_prim_ids")
HAIR = dict(subdiv=1, with_monkey=False, with_lucy=False,
            with_hair=True)  # tests/test_goldens.py:43-47
N = 512


def _pkg(name):
    import importlib

    mods = {m: importlib.import_module(f"{name}.{p}") for m, p in (
        ("demo", "scene.demo"), ("scene", "scene.scene"),
        ("instanced", "scene.instanced"), ("mesh", "geometry.mesh"),
        ("cyhair", "io.cyhair"))}
    return types.SimpleNamespace(**mods)


def _hair_instances(pkg):
    """4 shared icospheres, each with a 24-strand tuft, on a floor
    (tests/test_torch_instancing.py's hair scene)."""
    b = pkg.scene.SceneBuilder()
    m = b.materials
    white = m.add_principled("floor", base_color=(0.7, 0.7, 0.7),
                             specular=0.0)
    b.add_instance([pkg.demo.quad_mesh([-4, 0, -4], [-4, 0, 4], [4, 0, 4],
                                       [4, 0, -4], white, "floor")])
    sphere = pkg.demo.icosphere(1, 0.3, center=(0, 0.35, 0),
                                material_id=m.add_principled("ball"),
                                name="ball")
    tuft = pkg.cyhair.make_demo_hair(num_strands=24, base=(0.0, 0.9, 0.0),
                                     length=0.5, thickness=0.01, seed=3)
    hair = pkg.mesh.CubicBezierCurveMesh(
        tuft.vertices_thickness, tuft.indices,
        material_id=m.add_hair("hair"), name=tuft.name)
    ts = np.tile(np.eye(4, dtype=np.float32), (4, 1, 1))
    ts[:, 0, 3] = [-1.6, 1.6, -1.6, 1.6]
    ts[:, 2, 3] = [-1.6, -1.6, 1.6, 1.6]
    b.add_shared_instances([sphere], ts, curves=[hair])
    return pkg.instanced.build_instanced(b)


SCENES = {"demo1": lambda p: p.demo.build_demo_scene(subdiv=1)[0],
          "demo3": lambda p: p.demo.build_demo_scene(subdiv=3)[0],
          "hair": lambda p: p.demo.build_demo_scene(**HAIR)[0],
          "instanced_hair": _hair_instances}


@pytest.mark.parametrize("name", sorted(SCENES))
def test_tables_match_jax(name):
    want = SCENES[name](_pkg("pbrlab_tpu"))
    got = SCENES[name](_pkg("pbrlab_tpu_torch"))
    keys = [k for k in TABLES if k in want]
    assert keys == [k for k in TABLES if k in got]
    assert keys[-5:] == list(TABLES[-5:])  # every scene has a curve BVH
    if name != "instanced_hair":
        assert keys == list(TABLES)
    for k in keys:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    if "hair" in name:
        assert got["cbvh_skip"].shape[0] > 1  # a real curve tree


@pytest.fixture(scope="module")
def demo2():
    """The demo at subdiv 2 (tests/conftest.py's demo_scene), the port's
    commit, numpy and on the CPU."""
    scene_np = _pkg("pbrlab_tpu_torch").demo.build_demo_scene(subdiv=2)[0]
    return scene_np, scene_from_numpy(scene_np, "cpu")


def _random_rays(scene_np, n, rng):
    """tests/test_intersect.py's rays, as numpy float32."""
    bmin, bmax = scene_np["aabb_min"], scene_np["aabb_max"]
    center = 0.5 * (bmin + bmax)
    ext = (bmax - bmin).max()
    org = center + (rng.random((n, 3)) - 0.5) * 2.5 * ext
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    f = np.float32
    return (org.astype(f), d.astype(f), np.zeros((n,), f),
            np.full((n,), INF, f))


def _t(rays):
    return [torch.from_numpy(x) for x in rays]


@pytest.fixture()
def rays(demo2):
    return _random_rays(demo2[0], N, np.random.default_rng(12345))


def test_bvh_matches_bruteforce(demo2, rays):
    scene = demo2[1]
    ref = intersect.intersect_bruteforce(scene, *_t(rays))
    got = intersect.intersect_bvh(scene, *_t(rays))
    hit_ref = ref["prim"].numpy() >= 0
    np.testing.assert_array_equal(got["prim"].numpy() >= 0, hit_ref)
    np.testing.assert_allclose(got["t"].numpy()[hit_ref],
                               ref["t"].numpy()[hit_ref], rtol=1e-4)
    same_prim = ref["prim"].numpy() == got["prim"].numpy()
    assert same_prim[hit_ref].mean() > 0.99
    uvok = same_prim & hit_ref
    np.testing.assert_allclose(got["u"].numpy()[uvok],
                               ref["u"].numpy()[uvok], atol=1e-4)


def test_bvh_respects_max_t(demo2, rays):
    scene = demo2[1]
    org, d, mn, _ = _t(rays)
    full = intersect.intersect_bvh(scene, org, d, mn,
                                   torch.full((N,), INF))
    hit = full["prim"] >= 0
    limited = intersect.intersect_bvh(
        scene, org, d, mn, torch.where(hit, full["t"] * 0.5, 1.0))
    assert (limited["prim"][hit] == -1).all()


def test_occluded_matches_closest(demo2, rays):
    scene = demo2[1]
    closest = intersect.intersect_bvh(scene, *_t(rays))
    occ = intersect.occluded_bvh(scene, *_t(rays))
    np.testing.assert_array_equal(occ.numpy(), closest["prim"].numpy() >= 0)


def test_inside_box_hits(demo2):
    g = np.random.default_rng(7)
    d = g.normal(size=(512, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d = torch.from_numpy(d[d[:, 2] < -0.05].astype(np.float32))
    n = d.shape[0]
    org = torch.tensor([[0.0, 1.0, 0.0]]).expand(n, 3)
    res = intersect.intersect_bvh(demo2[1], org, d, torch.zeros((n,)),
                                  torch.full((n,), INF))
    assert (res["prim"] >= 0).all()


@pytest.fixture(scope="module")
def jax_traces(demo2):
    """JAX's intersect_bvh, occluded_bvh and intersect_bruteforce on the
    port's commit (bit-equal to JAX's, test_tables_match_jax) and the
    numpy rays of `rays`, and its rays at half their closest t."""
    import jax.numpy as jnp

    from pbrlab_tpu.ops import intersect as jint
    from pbrlab_tpu.scene.scene import scene_to_device

    scene = scene_to_device(demo2[0])
    rays = [jnp.asarray(x) for x in _random_rays(
        demo2[0], N, np.random.default_rng(12345))]
    out = {"closest": jint.intersect_bvh(scene, *rays),
           "brute": jint.intersect_bruteforce(scene, *rays)}
    half = jnp.where(out["closest"]["prim"] >= 0,
                     out["closest"]["t"] * 0.5, INF)
    out["occluded"] = jint.occluded_bvh(scene, *rays)
    out["occluded_half"] = jint.occluded_bvh(scene, *rays[:3], half)
    return {k: ({key: np.asarray(x) for key, x in v.items()}
                if isinstance(v, dict) else np.asarray(v))
            for k, v in out.items()}


@pytest.mark.parametrize("fn", ["closest", "brute"])
def test_walk_matches_jax(demo2, rays, jax_traces, fn):
    want = jax_traces[fn]
    walk = (intersect.intersect_bvh if fn == "closest"
            else intersect.intersect_bruteforce)
    got = {k: x.numpy() for k, x in walk(demo2[1], *_t(rays)).items()}
    np.testing.assert_array_equal(got["prim"], want["prim"])
    hit = want["prim"] >= 0
    assert hit.sum() > 50  # measured 74 of 512
    np.testing.assert_array_equal(got["t"][~hit], want["t"][~hit])
    np.testing.assert_allclose(got["t"][hit], want["t"][hit], rtol=1e-6)
    for k in ("u", "v"):
        np.testing.assert_allclose(got[k][hit], want[k][hit], rtol=0,
                                   atol=1e-6, err_msg=k)


def test_occluded_matches_jax(demo2, rays, jax_traces):
    got = intersect.occluded_bvh(demo2[1], *_t(rays)).numpy()
    np.testing.assert_array_equal(got, jax_traces["occluded"])
    org, d, mn, _ = _t(rays)
    closest = intersect.intersect_bvh(demo2[1], org, d, mn,
                                      torch.full((N,), INF))
    half = torch.where(closest["prim"] >= 0, closest["t"] * 0.5, INF)
    got = intersect.occluded_bvh(demo2[1], org, d, mn, half).numpy()
    np.testing.assert_array_equal(got, jax_traces["occluded_half"])
    assert got.sum() < jax_traces["occluded"].sum()


@pytest.fixture(scope="module")
def hair_np():
    return _pkg("pbrlab_tpu_torch").demo.build_demo_scene(**HAIR)[0]


def _tuft_rays(scene_np, n, seed):
    """Rays from in front of the tuft to random points in its box
    (tests/test_torch_dense_curve.py's), every 7th lane dead, every 5th
    max_t clipped."""
    rng = np.random.default_rng(seed)
    lo = scene_np["cbvh_min"][0]
    hi = scene_np["cbvh_max"][0]
    target = lo + rng.random((n, 3)) * (hi - lo)
    org = np.asarray([0.0, 1.0, 3.0]) + rng.normal(0.0, 0.3, (n, 3))
    d = target - org
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    max_t = np.full(n, INF)
    max_t[3::5] = rng.random(len(max_t[3::5])) * 3.5
    max_t[::7] = -1.0
    f = np.float32
    return (org.astype(f), d.astype(f), np.zeros((n,), f), max_t.astype(f))


def _grazing(scene_np, rays, lane, sub):
    """Whether sub-segment `sub` grazes ray `lane`: |d2 - r^2| within 1e-5
    of r^2 (a few ulps of the terms that d2 cancels), or t within 1e-6
    relative of max_t (float64, the ribbon test of `_ribbon_intersect`)."""
    o, d, _, max_t = (np.asarray(x, np.float64)[lane] for x in rays)
    p0 = scene_np["curve_p0"][sub].astype(np.float64)
    p1 = scene_np["curve_p1"][sub].astype(np.float64)
    r0, r1 = scene_np["curve_r0"][sub], scene_np["curve_r1"][sub]
    a, b = p0 - o, p1 - o
    ad, bd = a @ d, b @ d
    ap, bp = a - ad * d, b - bd * d
    seg = bp - ap
    s = np.clip(-(ap @ seg) / max(seg @ seg, 1e-12), 0, 1)
    c = ap + s * seg
    r = r0 + (r1 - r0) * s
    t = ad + s * (bd - ad)
    return (abs(c @ c - r * r) <= 1e-5 * r * r
            or abs(t - max_t) <= 1e-6 * abs(max_t))


@pytest.mark.parametrize("any_hit", [False, True])
def test_curve_trace_matches_jax(hair_np, any_hit):
    """Measured on 3000 lanes (436 hits) and on two other seeds: seg equal
    on every lane, closest and any-hit; t bit-equal on ~75-80% of the hit
    lanes and within 4.8e-7 (1.6e-7 relative), u within 1e-6, v within
    2.1e-5 (v divides by |d x e| r, where XLA:CPU contracts what torch
    rounds apart), the tangent within 1.2e-7. A lane whose seg differs
    must graze a sub-segment of the port's or JAX's hit segment."""
    import jax.numpy as jnp

    from pbrlab_tpu.ops.curves import curve_trace as jcurve_trace
    from pbrlab_tpu.scene.scene import scene_to_device

    rays = _tuft_rays(hair_np, 3000, 5)
    want = {k: np.asarray(x) for k, x in jcurve_trace(
        scene_to_device(hair_np), *map(jnp.asarray, rays),
        any_hit=any_hit).items()}
    got = {k: x.numpy() for k, x in curves.curve_trace(
        scene_from_numpy(hair_np, "cpu"), *_t(rays),
        any_hit=any_hit).items()}
    differ = np.nonzero(got["seg"] != want["seg"])[0]
    assert differ.size < 0.01 * len(rays[0])
    for i in differ:
        subs = np.nonzero(np.isin(hair_np["curve_seg"],
                                  [got["seg"][i], want["seg"][i]]))[0]
        assert any(_grazing(hair_np, rays, i, k) for k in subs), i
    hit = (got["seg"] >= 0) & (got["seg"] == want["seg"])
    assert hit.sum() > 300
    np.testing.assert_array_equal(got["t"][got["seg"] < 0], np.float32(INF))
    for k, atol in (("t", 0.0), ("u", 1e-5), ("v", 1e-4)):
        np.testing.assert_allclose(got[k][hit], want[k][hit], rtol=1e-6,
                                   atol=atol, err_msg=k)
    np.testing.assert_allclose(got["tangent"], want["tangent"], rtol=0,
                               atol=1e-6)
    # max_t clips: no hit beyond a lane's max_t
    assert (got["t"][hit] <= rays[3][hit]).all()


def _np_walk(tree, leaf, o, d, mint, maxt, eps, any_hit):
    """One lane's walk as the kernels' thread does it, in float32 numpy:
    returns (t, u, v, prim, primitive tests, box tests)."""
    f = np.float32
    bmin, bmax, skip, poff, pids = tree
    n_nodes = skip.shape[0]
    inv = f(1) / np.where(np.abs(d) < f(eps),
                          np.where(d < 0, -f(eps), f(eps)), d).astype(f)
    best = [f(INF), f(0), f(0), -1]
    tests = [0, 0]
    node = 0 if maxt >= mint else n_nodes
    while node < n_nodes:
        cap = min(maxt, best[0])
        t0 = (bmin[node] - o) * inv
        t1 = (bmax[node] - o) * inv
        tnear = np.minimum(t0, t1).max()
        tfar = np.maximum(t0, t1).min()
        enter = (tnear <= tfar * f(1.00000024)) and tfar >= mint \
            and tnear <= cap
        tests[1] += 1
        if enter and poff[node] < 0:
            node += 1
            continue
        if enter:
            for k in range(4):
                slot = poff[node] + k
                pid = pids[slot] if slot < pids.shape[0] else -1
                if pid < 0:
                    continue
                tests[0] += 1
                hit, t, u, v = leaf(pid, o, d, mint, cap)
                if hit and t < best[0]:
                    best = [t, u, v, pid]
            if any_hit and best[3] >= 0:
                break
        node = skip[node]
    return (*best, *tests)


def _np_dot(a, b):
    return (a[0] * b[0] + a[1] * b[1]) + a[2] * b[2]


def _np_cross(a, b):
    return np.array([a[1] * b[2] - a[2] * b[1], a[2] * b[0] - a[0] * b[2],
                     a[0] * b[1] - a[1] * b[0]], np.float32)


def _np_triangle(scene_np):
    f = np.float32
    v0, e1, e2 = (scene_np[k] for k in ("tri_v0", "tri_e1", "tri_e2"))

    def leaf(pid, o, d, mint, cap):
        pvec = _np_cross(d, e2[pid])
        det = _np_dot(e1[pid], pvec)
        ok = abs(det) > f(1e-9)
        inv_det = f(1) / det if ok else f(0)
        tvec = o - v0[pid]
        u = _np_dot(tvec, pvec) * inv_det
        qvec = _np_cross(tvec, e1[pid])
        v = _np_dot(d, qvec) * inv_det
        t = _np_dot(e2[pid], qvec) * inv_det
        return (ok and u >= 0 and v >= 0 and u + v <= 1 and t >= mint
                and t <= cap), t, u, v
    return leaf


def _np_ribbon(scene_np):
    f = np.float32
    p0, p1, r0, r1, u0, u1 = (scene_np[k] for k in curves.CURVE_COLUMNS)

    def leaf(pid, o, d, mint, cap):
        a, b = p0[pid] - o, p1[pid] - o
        ad, bd = _np_dot(a, d), _np_dot(b, d)
        ap, bp = a - ad * d, b - bd * d
        seg = bp - ap
        denom = _np_dot(seg, seg)
        s = -_np_dot(ap, seg) / max(denom, f(1e-12))
        s = min(max(s, f(0)), f(1)) if denom > f(1e-12) else f(0)
        c = ap + s * seg
        d2 = _np_dot(c, c)
        r = r0[pid] + (r1[pid] - r0[pid]) * s
        t = ad + s * (bd - ad)
        bit = _np_cross(d, p1[pid] - p0[pid])
        blen = np.sqrt(max(_np_dot(bit, bit), f(1e-20)))
        v = -_np_dot(c, bit) / (blen * max(r, f(1e-12)))
        v = min(max(v, f(-1)), f(1))
        return (d2 <= r * r and t >= mint and t <= cap and r > 0), t, \
            u0[pid] + (u1[pid] - u0[pid]) * s, v
    return leaf


@pytest.mark.parametrize("kind", ["triangles", "curves"])
@pytest.mark.parametrize("any_hit", [False, True])
def test_twin_matches_per_lane_loop(demo2, hair_np, kind, any_hit):
    if kind == "triangles":
        scene_np = demo2[0]
        rays = _random_rays(scene_np, 64, np.random.default_rng(3))
        keys, leaf, eps = intersect.BVH_TABLES[:5], _np_triangle(scene_np), \
            1e-20
        twin = intersect._bvh_walk_ref
        prims = [scene_np[k] for k in intersect.BVH_TABLES[5:]]
    else:
        scene_np = hair_np
        rays = _tuft_rays(scene_np, 128, 9)
        keys, leaf, eps = curves.CBVH_TABLES, _np_ribbon(scene_np), 1e-12
        twin = curves._curve_walk_ref
        prims = [scene_np[k] for k in curves.CURVE_COLUMNS]
    tree = [scene_np[k] for k in keys]
    *got, work = twin([torch.from_numpy(x) for x in tree],
                      [torch.from_numpy(x) for x in prims], *_t(rays),
                      any_hit=any_hit, counts=True)
    want = [_np_walk(tree, leaf, *(x[i] for x in rays), eps, any_hit)
            for i in range(len(rays[0]))]
    want = [np.asarray(col) for col in zip(*want)]
    assert 5 <= (want[3] >= 0).sum() < len(rays[0]) - 5
    for k, g, w in zip("tuvp", got, want[:4]):
        np.testing.assert_array_equal(g.numpy(), w.astype(g.numpy().dtype),
                                      err_msg=k)
    np.testing.assert_array_equal(work.numpy(), np.stack(want[4:], 1))


def test_bvh_on_instanced_scene_raises():
    scene = scene_from_numpy(_hair_instances(_pkg("pbrlab_tpu_torch")),
                             "cpu")
    org = torch.zeros((4, 3))
    d = torch.tensor([[0.0, -1.0, 0.0]]).expand(4, 3)
    args = (org, d, torch.zeros((4,)), torch.full((4,), INF))
    with pytest.raises(ValueError, match="bvh"):
        intersect.trace_scene(scene, *args, backend="bvh")
    with pytest.raises(ValueError, match="bvh"):
        intersect.occluded_scene(scene, *args, backend="bvh")
    with pytest.raises(ValueError, match="bvh"):
        intersect.intersect_bvh(scene, *args)
    # its hair still walks the curve BVH
    assert curves.curve_trace(scene, *args)["seg"].shape == (4,)


def test_sparse_backend_keeps_bvh(demo2):
    """JAX's forced backend reaches sparse_backend through the
    environment and gives None: the substeps walk the BVH too."""
    assert intersect.sparse_backend(demo2[1], "bvh") is None


@pytest.mark.requires_cuda
@pytest.mark.parametrize("any_hit", [False, True])
def test_cuda_kernels_match_twins(demo2, hair_np, any_hit):
    """Both kernels bit-equal to their twins, one launch a call (the
    kernels are CUDA-only: the test runs on the card, without JAX, as
    `python -m pytest tests/test_torch_bvh.py --noconftest -o addopts=""
    -m requires_cuda`)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the bvh_walk kernels are "
                    "CUDA-only)")
    dev = torch.device("cuda")
    scene = scene_from_numpy(demo2[0], dev)
    rays = [x.to(dev) for x in _t(_random_rays(
        demo2[0], 4096, np.random.default_rng(1)))]
    got = intersect._bvh_trace(*(scene[k] for k in intersect.BVH_TABLES),
                               *rays, any_hit=any_hit)
    want = intersect._bvh_trace_ref(
        *(scene[k] for k in intersect.BVH_TABLES), *rays, any_hit=any_hit)
    for k in got:
        assert torch.equal(got[k], want[k]), k
    hair = scene_from_numpy(hair_np, dev)
    rays = [x.to(dev) for x in _t(_tuft_rays(hair_np, 4096, 2))]
    mode = "any_hit" if any_hit else "closest"
    before = dict(bvh_walk.LAUNCHES)
    got = curves.curve_trace(hair, *rays, any_hit=any_hit)
    want = curves.curve_trace(hair, *rays, any_hit=any_hit, plain=True)
    for k in got:
        assert torch.equal(got[k], want[k]), k
    assert bvh_walk.LAUNCHES[f"curve_{mode}"] == before[f"curve_{mode}"] + 1
    assert bool((want["seg"] >= 0).any())
