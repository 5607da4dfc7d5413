"""dense_curve hair trace of the port against the JAX package.

Tables: `pack_segments` and the commit's curve tables are numpy on both
sides and must be equal exactly.

Trace: on the CPU the port's wrapper runs the per-ray twin (`_walk_ref`:
each lane walks the clusters its own ray enters, in the order of its own
entry t, until its own best t); the reference is
pbrlab_tpu.ops.pallas.dense_curve in interpret mode, a group walk (a
128-lane group enters a cluster when any lane's box test passes, and
every lane tests its 128 ribbons), on the hair golden scene
(tests/test_goldens.py:43-47) with rays aimed through the tuft, plus dead
lanes and clipped max_t. Both compute the same float32 ops, but XLA:CPU
may contract a product and a sum into one rounding, and the ribbon
test's d2 = (aa - ad^2) + 2sq + s^2 ep2 cancels terms of ~|p0 - o|^2 ~ 10
down to r^2 ~ 1.6e-5. So a lane may hit on one side and miss on the
other where |d2 - r^2| lies within GRAZE_ULPS ulps of max(aa, ad^2) for
the segment either side picked (recomputed here in float32 with numpy,
which does not contract). Everywhere else hit masks and sub must be
equal, and the grazing lanes must stay under 1% of all lanes. Where both
pick the same segment t agrees to rtol 1e-5; u and v inherit
cancellations of their own (s = -q/ep2 with q = ae - ad*ed; the triple
product det over r ~ 0.004), which the contraction moves by up to 7.6e-6
in u and 5.3e-5 in v: u is held to atol 2e-5, v to atol 1e-4. Measured
with the per-ray twin (CPU, the tests' seeds): closest, 3000 lanes, 436
JAX hits, sub differs on 11 lanes (the hit mask on 5 of them), all
grazing; t bit-equal on 290 of the 426 hit lanes that agree, relative
<= 2.9e-7; any-hit masks differ on 8 grazing lanes of 3000.

The twin is also held against an independent per-lane numpy loop
(`NumpyChunkWalk`: the chunks, the box test, the stable order, the lane's
own exit and the (t, id mod 8) rule, written from the kernel's rules) on
48 lanes of the tuft and on a synthetic scene of 300 clusters, more than
a lane's list of 256, so the walk goes through two chunks.

The requires_cuda tests compare the CUDA kernel with the twin on the
card: the same walk, the same ops, no FMA contraction, IEEE division and
sqrt -> equal bits. They import no JAX, so they run there with `python
-m pytest tests/test_torch_dense_curve.py --noconftest -o addopts="" -m
requires_cuda`.
"""
import numpy as np
import pytest
import torch

from pbrlab_tpu_torch.core.math import INF
from pbrlab_tpu_torch.ops import dense_curve, per_ray
from pbrlab_tpu_torch.ops.curves import flatten_curves, subsegment_bounds
from pbrlab_tpu_torch.scene.demo import build_demo_scene
from pbrlab_tpu_torch.scene.scene import scene_from_numpy
from torch_threads import one_torch_thread  # noqa: F401

HAIR = dict(subdiv=1, with_monkey=False, with_lucy=False, with_hair=True)
N = 3000  # not a multiple of the 128-lane group: exercises the padding
GRAZE_ULPS = 16
F = np.float32
BIG = F(1e30)
CHUNK_M = 300  # clusters of the synthetic scene: more than one list
CURVE_KEYS = ("curve_pts", "curve_material", "curve_instance", "curve_p0",
              "curve_p1", "curve_r0", "curve_r1", "curve_seg", "curve_u0",
              "curve_u1", "dense_segs", "dense_seg_aabb", "curve_sub_fat")


@pytest.fixture(scope="module")
def scene_np():
    return build_demo_scene(**HAIR)[0]


def _rays(scene_np, n, seed):
    """Rays from in front of the tuft to random points in its box (about
    a seventh of them hit), every 7th lane dead, every 5th max_t clipped."""
    rng = np.random.default_rng(seed)
    aabb = scene_np["dense_seg_aabb"]
    lo, hi = aabb[0:3].min(axis=1), aabb[3:6].max(axis=1)
    target = lo + rng.random((n, 3)) * (hi - lo)
    org = np.asarray([0.0, 1.0, 3.0]) + rng.normal(0.0, 0.3, (n, 3))
    d = target - org
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    max_t = np.full(n, INF)
    max_t[3::5] = rng.random(len(max_t[3::5])) * 3.5
    max_t[::7] = -1.0
    f32 = np.float32
    return (org.astype(f32), d.astype(f32), np.full(n, 1e-3, f32),
            max_t.astype(f32))


def _grazing(segs, rays, lane, sub):
    """Whether segment `sub` of each lane is a grazing one for that lane:
    |d2 - r^2| within GRAZE_ULPS ulps of max(aa, ad^2), the ribbon test
    recomputed in float32 in the kernel's order (-1: not grazing)."""
    f = np.float32
    o, d = rays[0][lane], rays[1][lane]
    row = segs[np.maximum(sub, 0)]
    p0, e = row[:, 0:3], row[:, 3:6]

    def dot(a, b):
        return (a[:, 0] * b[:, 0] + a[:, 1] * b[:, 1]) + a[:, 2] * b[:, 2]

    ad = dot(p0, d) - dot(o, d)
    ed = dot(e, d)
    aa = (dot(p0, p0) - f(2.0) * dot(p0, o)) + dot(o, o)
    ep2 = np.maximum(row[:, 9] - ed * ed, f(1e-12))
    q = (row[:, 8] - dot(e, o)) - ad * ed
    s = np.clip(-q / ep2, f(0.0), f(1.0))
    d2 = ((aa - ad * ad) + (f(2.0) * s) * q) + (s * s) * ep2
    rad = row[:, 6] + s * row[:, 7]
    margin = GRAZE_ULPS * np.spacing(np.maximum(aa, ad * ad))
    return (sub >= 0) & (np.abs(d2 - rad * rad) <= margin)


def _jax_trace(scene_np, rays, any_hit):
    import jax.numpy as jnp
    from pbrlab_tpu.ops.pallas.dense_curve import dense_curve_trace

    out = dense_curve_trace(jnp.asarray(scene_np["dense_segs"]),
                            jnp.asarray(scene_np["dense_seg_aabb"]),
                            *map(jnp.asarray, rays), any_hit=any_hit,
                            interpret=True)
    return {k: np.asarray(v) for k, v in out.items()}


def _torch_args(scene_np, rays, device="cpu"):
    scene = scene_from_numpy(scene_np, device)
    return ([scene["dense_segs"], scene["dense_seg_aabb"]]
            + [torch.from_numpy(r).to(device) for r in rays])


def test_pack_and_commit_match_jax(scene_np):
    from pbrlab_tpu.ops.curves import flatten_curves as jflatten
    from pbrlab_tpu.ops.pallas.dense_curve import pack_segments as jpack
    from pbrlab_tpu.scene.demo import build_demo_scene as jbuild

    want, _ = jbuild(**HAIR)
    for key in CURVE_KEYS:
        assert scene_np[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(scene_np[key], want[key], err_msg=key)
    assert scene_np["curve_pts"].shape == (672, 4, 4)
    assert scene_np["dense_segs"].shape == (5376, 12)
    assert scene_np["dense_seg_aabb"].shape == (8, 42)
    # a ragged tail (the last cluster half padding) and the empty scene
    pts = scene_np["curve_pts"][:100]
    for got, want_ in zip(dense_curve.pack_segments(flatten_curves(pts)),
                          jpack(jflatten(pts))):
        np.testing.assert_array_equal(got, want_)
    empty = dense_curve.pack_segments(flatten_curves(pts[:0]))
    for got, want_ in zip(empty, jpack(jflatten(pts[:0]))):
        np.testing.assert_array_equal(got, want_)


def test_clusters_bound_their_subsegments(scene_np):
    """Every sub-segment (with both end radii) lies in its cluster box."""
    flat = {k: scene_np[k] for k in CURVE_KEYS if k.startswith("curve_")}
    bmin, bmax = subsegment_bounds(flat)
    cluster = np.arange(bmin.shape[0]) // dense_curve.SEG_BLOCK
    aabb = scene_np["dense_seg_aabb"]
    assert (bmin >= aabb[0:3, cluster].T).all()
    assert (bmax <= aabb[3:6, cluster].T).all()


@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any-hit"])
def test_trace_matches_jax(scene_np, any_hit):
    """Closest: sub equal off the grazing lanes. Any-hit: the hit masks (a
    grazing hit can end its group's walk early, which changes which hit
    the group's other lanes report, never whether they hit)."""
    rays = _rays(scene_np, N, 1 + any_hit)
    want = _jax_trace(scene_np, rays, any_hit)
    got = dense_curve.dense_curve_trace(*_torch_args(scene_np, rays),
                                        any_hit=any_hit)
    assert got["sub"].dtype == torch.int32 and got["t"].shape == (N,)
    got = {k: v.numpy() for k, v in got.items()}
    hit, ghit = want["sub"] >= 0, got["sub"] >= 0
    assert hit.mean() > 0.1  # the rays do hit the tuft
    assert not ghit[::7].any()  # dead lanes
    differ = np.nonzero(ghit != hit if any_hit
                        else got["sub"] != want["sub"])[0]
    graze = (_grazing(scene_np["dense_segs"], rays, differ, want["sub"][differ])
             | _grazing(scene_np["dense_segs"], rays, differ,
                        got["sub"][differ]))
    assert graze.all(), differ[~graze]
    assert differ.size < 0.01 * N
    np.testing.assert_array_equal(got["t"][~ghit], np.float32(INF))
    both = (got["sub"] == want["sub"]) & hit
    for k, atol in (("t", 1e-6), ("u", 2e-5), ("v", 1e-4)):
        np.testing.assert_allclose(got[k][both], want[k][both], rtol=1e-5,
                                   atol=atol, err_msg=k)
    # max_t clips: no hit at or beyond a lane's max_t
    assert (got["t"][ghit] < rays[3][ghit]).all()


def test_any_hit_stops_lanes_early(scene_np):
    """Rays aimed at sub-segment midpoints from all around, no dead lane:
    every lane finds a hit, so its any-hit walk stops early; it still
    reports a hit wherever the closest query does, as JAX does."""
    rng = np.random.default_rng(8)
    n = 1024
    mid = 0.5 * (scene_np["curve_p0"] + scene_np["curve_p1"])
    target = mid[rng.integers(0, mid.shape[0], n)]
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    org = target - 2.0 * d
    f32 = np.float32
    rays = (org.astype(f32), d.astype(f32), np.full(n, 1e-3, f32),
            np.full(n, INF, f32))
    args = _torch_args(scene_np, rays)
    closest = dense_curve.dense_curve_trace(*args)
    anyh = dense_curve.dense_curve_trace(*args, any_hit=True)
    want = _jax_trace(scene_np, rays, True)
    hit = anyh["sub"].numpy() >= 0
    assert hit.all()
    np.testing.assert_array_equal(hit, want["sub"] >= 0)
    assert torch.equal(closest["sub"] >= 0, anyh["sub"] >= 0)
    # the twin's own counts: up to its first hit a lane's any-hit walk is
    # its closest walk, so it tests no more ribbons and boxes, and in all
    # fewer ribbons: the walks stopped early
    clamped = dense_curve.clamped_rays(*args[2:])
    work = [dense_curve._walk_ref(*args[:2], *clamped, any_hit=a,
                                  counts=True)[4] for a in (False, True)]
    assert (work[1] <= work[0]).all()
    assert int(work[1][:, 0].sum()) < int(work[0][:, 0].sum())


def _tie_table(ids):
    """One cluster of padding rows (r0 = dr = 0: never hit) with the same
    segment (x = 0, y in [0, 1] at z = 0, radius 0.1) at each of `ids`."""
    segs = np.zeros((dense_curve.SEG_BLOCK, 12), np.float32)
    for i in ids:
        segs[i] = (0.0, 0.0, 0.0, 0.0, 1.0, 0.0, 0.1, 0.0, 0.0, 1.0,
                   0.125 * (i % 8), 0.125)
    aabb = np.asarray([[-0.1], [-0.1], [-0.1], [0.1], [1.1], [0.1], [0.0],
                       [0.0]], np.float32)
    return segs, aabb


@pytest.mark.parametrize("ids, want", [((3, 5), 3), ((13, 2), 2),
                                       ((6, 9), 9), ((1, 9, 17), 1)],
                         ids=["slots-3-5", "slots-5-2", "later-lower-slot",
                              "same-slot"])
def test_tie_rule(ids, want):
    """Duplicated rows give equal t; the winner is the lexicographic
    minimum of (t, id mod 8), the first visited on a full tie, as in the
    JAX package (id 9, slot 1, beats id 6, slot 6, visited earlier)."""
    import jax.numpy as jnp
    from pbrlab_tpu.ops.pallas.dense_curve import dense_curve_trace

    segs, aabb = _tie_table(ids)
    org = np.asarray([[0.02, 0.5, 2.0], [-0.05, 0.25, 2.0]], np.float32)
    d = np.asarray([[0.0, 0.0, -1.0]] * 2, np.float32)
    rays = (org, d, np.zeros(2, np.float32), np.full(2, INF, np.float32))
    got = dense_curve.dense_curve_trace(torch.from_numpy(segs),
                                        torch.from_numpy(aabb),
                                        *map(torch.from_numpy, rays))
    jax_out = dense_curve_trace(jnp.asarray(segs), jnp.asarray(aabb),
                                *map(jnp.asarray, rays), interpret=True)
    np.testing.assert_array_equal(got["sub"].numpy(), [want, want])
    np.testing.assert_array_equal(np.asarray(jax_out["sub"]), [want, want])
    np.testing.assert_allclose(got["t"].numpy(), [2.0, 2.0], rtol=1e-6)
    np.testing.assert_allclose(got["u"].numpy(),
                               0.125 * (want % 8) + 0.125 * np.asarray(
                                   [0.5, 0.25]), rtol=1e-6)


def test_wrapper_takes_plain_walk_on_cpu(scene_np):
    """On CPU tensors the wrapper is the plain version, and launches no
    kernel."""
    args = _torch_args(scene_np, _rays(scene_np, 300, 4))
    before = dict(dense_curve.LAUNCHES)
    for any_hit in (False, True):
        got = dense_curve.dense_curve_trace(*args, any_hit=any_hit)
        ref = dense_curve.dense_curve_trace_ref(*args, any_hit=any_hit)
        for k in got:
            assert torch.equal(got[k], ref[k])
    assert dense_curve.LAUNCHES == before


class NumpyChunkWalk:
    """Each lane on its own, in numpy float32, written from the kernels'
    walk (`per_ray::cluster_walk` with the legacy box test): in chunks of
    LIST clusters in cluster order, the `(box - o) * inv` slab test of
    every box of the chunk (inv: a |d| < 1e-12 component as +1e-12)
    capped at the lane's best t, the entered clusters sorted by entry t
    (Python's stable sort: ties by the lower id), then each cluster's
    primitives in order, a valid one taken when its t is smaller, or
    equal with a lower id mod 8, until `tn (1 - 1e-6) - 1e-6 > best t`;
    any-hit stops after the first cluster with a hit. `test(c, o, d,
    mint)` gives cluster c's (t, u, v, valid) [size] in the kernel's
    operations (subclasses)."""

    size = dense_curve.SEG_BLOCK

    def __init__(self, aabb):
        self.lo = np.ascontiguousarray(aabb[0:3].T, F)
        self.hi = np.ascontiguousarray(aabb[3:6].T, F)
        self.m = aabb.shape[1]

    def slab(self, c, o, inv, mint, cap):
        t0 = (self.lo[c] - o) * inv
        t1 = (self.hi[c] - o) * inv
        near, far = np.minimum(t0, t1), np.maximum(t0, t1)
        tnear = np.maximum(np.maximum(near[0], near[1]), near[2])
        tfar = np.minimum(np.minimum(far[0], far[1]), far[2])
        if tnear <= tfar * F(1.00000024) and tfar >= mint and tnear <= cap:
            return tnear
        return BIG

    def visit(self, c, o, d, s):
        t, u, v, ok = self.test(c, o, d, s["mint"])
        s["prims"] += self.size
        for k in np.flatnonzero(ok):
            i = c * self.size + k
            if t[k] < s["t"] or (t[k] == s["t"] and s["prim"] >= 0
                                 and i % 8 < s["prim"] % 8):
                s.update(t=t[k], u=u[k], v=v[k], prim=i)

    def walk(self, org, direction, min_t, max_t, any_hit=False):
        """Per lane: t, u, v, prim, the counts [n, 3] (primitive and box
        tests, 0) and the number of clusters entered."""
        out = {k: [] for k in ("t", "u", "v", "prim", "work", "entered")}
        for o, d, mint, maxt in zip(org, direction, min_t, max_t):
            inv = F(1) / np.where(np.abs(d) < F(1e-12), F(1e-12), d)
            s = dict(t=maxt, u=F(0), v=F(0), prim=-1, mint=mint, prims=0,
                     boxes=0, entered=0)
            for c0 in range(0, self.m if maxt >= mint else 0, per_ray.LIST):
                c1 = min(c0 + per_ray.LIST, self.m)
                s["boxes"] += c1 - c0
                entries = [(tn, c) for c in range(c0, c1)
                           if (tn := self.slab(c, o, inv, mint,
                                               s["t"])) < BIG]
                entries.sort(key=lambda e: e[0])
                s["entered"] += len(entries)
                for tn, c in entries:
                    if not tn * F(0.999999) - F(1e-6) <= s["t"]:
                        break
                    self.visit(c, o, d, s)
                    if any_hit and s["prim"] >= 0:
                        break
                if any_hit and s["prim"] >= 0:
                    break
            for k in ("t", "u", "v", "prim", "entered"):
                out[k].append(s[k])
            out["work"].append((s["prims"], s["boxes"], 0))
        return {k: np.asarray(v) for k, v in out.items()}


class NumpyCurveWalk(NumpyChunkWalk):
    """NumpyChunkWalk over a dense_curve table: the Pallas body's ribbon
    test, every product and sum rounded on its own, in its order."""

    def __init__(self, segs, aabb):
        super().__init__(aabb)
        self.segs = segs

    def test(self, c, o, d, mint):
        r = self.segs[c * self.size:(c + 1) * self.size].T

        def dot(x, y):  # x rows, y a 3-vector
            return (x[0] * y[0] + x[1] * y[1]) + x[2] * y[2]

        p0, e = r[0:3], r[3:6]
        ad = dot(p0, d) - dot(o, d)
        ed = dot(e, d)
        ae = r[8] - dot(e, o)
        aa = (dot(p0, p0) - F(2) * dot(p0, o)) + dot(o, o)
        with np.errstate(all="ignore"):
            ep2 = np.maximum(r[9] - ed * ed, F(1e-12))
            q = ae - ad * ed
            s = np.clip(-q / ep2, F(0), F(1))
            d2 = ((aa - ad * ad) + (F(2) * s) * q) + (s * s) * ep2
            t = ad + s * ed
            rad = r[6] + s * r[7]
            cx = d[1] * e[2] - d[2] * e[1]
            cy = d[2] * e[0] - d[0] * e[2]
            cz = d[0] * e[1] - d[1] * e[0]
            det = ((p0[0] - o[0]) * cx + (p0[1] - o[1]) * cy) \
                + (p0[2] - o[2]) * cz
            blen = np.sqrt(np.maximum((cx * cx + cy * cy) + cz * cz,
                                      F(1e-20)))
            v = np.clip(-det / (blen * np.maximum(rad, F(1e-12))), F(-1),
                        F(1))
        ok = (d2 <= rad * rad) & (t >= mint) & (rad > 0)
        return t, r[10] + s * r[11], v, ok


def _check_numpy(twin, want):
    """Twin (t, u, v, sub, counts) against the numpy walk: every output
    and count equal."""
    for got, key in zip(twin, ("t", "u", "v", "prim", "work")):
        np.testing.assert_array_equal(got.numpy(), want[key], err_msg=key)


def chunk_segs(m=CHUNK_M):
    """m clusters along +x, cluster c's box x in [3 (m - 1 - c), +1], y in
    [-1.3, 1.3], z in [-1, 1] (the highest id nearest the origin), each
    with one ribbon across the x axis in row 128 c + (5 c mod 128): p0 =
    (x + 0.5, -0.9, 0), e = (0, 1.8, 0), radius 0.3. A ray along +x from x
    = -10 enters every box, those of the second chunk (ids 256 and up)
    first; a ray along -x from beyond the far end enters the first
    chunk's first."""
    segs = np.zeros((m * dense_curve.SEG_BLOCK, 12), F)
    aabb = np.zeros((8, m), F)
    for c in range(m):
        x = 3.0 * (m - 1 - c)
        aabb[:3, c] = (x, -1.3, -1.0)
        aabb[3:6, c] = (x + 1.0, 1.3, 1.0)
        p0, e = np.array([x + 0.5, -0.9, 0.0], F), np.array([0, 1.8, 0], F)
        segs[c * dense_curve.SEG_BLOCK + 5 * c % 128] = (
            *p0, *e, 0.3, 0.0, p0 @ e, e @ e, 0.0, 1.0)
    return segs, aabb


def chunk_rays(n, m=CHUNK_M, seed=23):
    """Lanes along +x from x = -10 (half), along -x from x = 3 m + 10 (a
    quarter) and in random directions from the middle (a quarter, most of
    them missing), every 7th dead, every 5th (from the 4th) clipped."""
    rng = np.random.default_rng(seed)
    org = np.zeros((n, 3), F)
    d = np.zeros((n, 3), F)
    half, rest = n // 2, n - n // 2 - n // 4
    org[:half, 0], d[:half, 0] = -10.0, 1.0
    org[half:n - rest, 0], d[half:n - rest, 0] = 3.0 * m + 10.0, -1.0
    org[:n - rest, 1:] = rng.uniform(-0.15, 0.15, (n - rest, 2))
    d[:n - rest, 1:] = rng.uniform(-1e-4, 1e-4, (n - rest, 2))
    org[n - rest:] = (1.5 * m, 0.0, 0.0)
    rd = rng.normal(size=(rest, 3))
    d[n - rest:] = rd / np.linalg.norm(rd, axis=1, keepdims=True)
    max_t = np.full(n, INF, F)
    max_t[3::5] = rng.uniform(0.0, 3.0 * m, len(max_t[3::5]))
    max_t[::7] = -1.0
    return org, d / np.linalg.norm(d, axis=1, keepdims=True).astype(F), \
        np.full(n, 1e-3, F), max_t


@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any"])
def test_twin_matches_numpy_walk(scene_np, any_hit):
    """48 lanes of the JAX test's rays through the demo tuft (42 clusters,
    dead and clipped lanes among them)."""
    rays = _rays(scene_np, 48, 21)
    want = NumpyCurveWalk(scene_np["dense_segs"],
                          scene_np["dense_seg_aabb"]).walk(*rays, any_hit)
    args = _torch_args(scene_np, rays)
    got = dense_curve._walk_ref(*args[:2], *dense_curve.clamped_rays(
        *args[2:]), any_hit=any_hit, counts=True)
    _check_numpy(got, want)
    hit = want["prim"] >= 0
    assert hit.mean() > 0.1 and not hit[::7].any()  # dead lanes
    # the lanes' own cull: no lane walks more clusters than it enters,
    # and some stop before the end of their lists
    walked = want["work"][:, 0] // dense_curve.SEG_BLOCK
    assert (walked <= want["entered"]).all()
    assert (walked < want["entered"]).any()


@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any"])
def test_twin_walks_chunks(any_hit):
    """The synthetic scene of CHUNK_M clusters: a lane's walk goes through
    two chunks of the list, and the chunk order decides the answer (the
    +x lanes' closest hit lies in the second chunk, their any-hit in the
    first)."""
    segs, aabb = chunk_segs()
    rays = chunk_rays(40)
    want = NumpyCurveWalk(segs, aabb).walk(*rays, any_hit)
    got = dense_curve._walk_ref(torch.from_numpy(segs),
                                torch.from_numpy(aabb),
                                *(torch.from_numpy(r) for r in rays),
                                any_hit=any_hit, counts=True)
    _check_numpy(got, want)
    plus = np.arange(40) < 20
    live = rays[3] == INF
    if any_hit:  # the +x lanes stop in the first chunk
        assert (want["work"][plus & live, 1] == per_ray.LIST).all()
    else:
        assert (want["entered"] > per_ray.LIST).any()
    first = 128 * (CHUNK_M - 1) + 5 * (CHUNK_M - 1) % 128  # nearest +x
    chunk0 = 128 * 255 + 5 * 255 % 128  # nearest +x in the first chunk
    np.testing.assert_array_equal(want["prim"][plus & live],
                                  chunk0 if any_hit else first)
    minus = (np.arange(40) >= 20) & (np.arange(40) < 30)
    assert (want["prim"][minus & live] == 0).all()  # cluster 0's ribbon


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the dense_curve kernel is "
                    "CUDA-only)")


@pytest.mark.requires_cuda
def test_cuda_kernel_matches_plain(scene_np):
    """Kernel vs twin on the card: t, u, v, sub bit-equal, closest and
    any-hit, one launch a call; a table of the wrong shape raises."""
    _need_cuda()
    for n, seed in ((N, 5), (65536, 6)):
        args = _torch_args(scene_np, _rays(scene_np, n, seed), "cuda")
        for any_hit in (False, True):
            before = dict(dense_curve.LAUNCHES)
            got = dense_curve.dense_curve_trace(*args, any_hit=any_hit)
            ref = dense_curve.dense_curve_trace_ref(*args, any_hit=any_hit)
            torch.cuda.synchronize()
            kind = "any_hit" if any_hit else "closest"
            assert dense_curve.LAUNCHES[kind] == before[kind] + 1
            for k in got:
                assert torch.equal(got[k], ref[k]), (n, any_hit, k)
    with pytest.raises(ValueError):
        dense_curve._walk_cuda(args[0][:-1], *args[1:])


@pytest.mark.requires_cuda
@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any"])
def test_cuda_kernel_walks_chunks(any_hit):
    """Kernel vs twin on the synthetic scene of CHUNK_M clusters (two
    chunks of a lane's list), 2048 lanes: every output bit-equal."""
    _need_cuda()
    segs, aabb = (torch.from_numpy(x).cuda() for x in chunk_segs())
    rays = [torch.from_numpy(r).cuda() for r in chunk_rays(2048)]
    got = dense_curve._walk_cuda(segs, aabb, *dense_curve.clamped_rays(
        *rays), any_hit=any_hit)
    ref = dense_curve._walk_ref(segs, aabb, *dense_curve.clamped_rays(
        *rays), any_hit=any_hit)
    torch.cuda.synchronize()
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    assert bool((ref[3] >= 0).any())
