"""dense_curve hair trace of the port against the JAX package.

Tables: `pack_segments` and the commit's curve tables are numpy on both
sides and must be equal exactly.

Trace: on the CPU the port's wrapper runs the plain torch walk; the
reference is pbrlab_tpu.ops.pallas.dense_curve in interpret mode, on the
hair golden scene (tests/test_goldens.py:43-47) with rays aimed through
the tuft, plus dead lanes and clipped max_t. Both compute the same float32
ops, but XLA:CPU may contract a product and a sum into one rounding, and
the ribbon test's d2 = (aa - ad^2) + 2sq + s^2 ep2 cancels terms of
~|p0 - o|^2 ~ 10 down to r^2 ~ 1.6e-5. So a lane may hit on one side and
miss on the other where |d2 - r^2| lies within GRAZE_ULPS ulps of
max(aa, ad^2) for the segment either side picked (recomputed here in
float32 with numpy, which does not contract). Everywhere else hit masks
and sub must be equal, and the grazing lanes must stay under 1% of all
lanes (measured: 11-18 of 3000 over five seeds). Where both pick the same
segment t agrees to rtol 1e-5; u and v inherit cancellations of their own
(s = -q/ep2 with q = ae - ad*ed; the triple product det over r ~ 0.004),
which the contraction moves by up to 7.6e-6 in u and 5.3e-5 in v
(measured, same seeds): u is held to atol 2e-5, v to atol 1e-4.

The requires_cuda test compares the CUDA kernel with the plain walk on the
card: same ops, no FMA contraction, IEEE division and sqrt -> equal bits.
It imports no JAX, so it runs there with `python -m pytest
tests/test_torch_dense_curve.py --noconftest -o addopts="" -m requires_cuda`.
"""
import numpy as np
import pytest
import torch

from pbrlab_tpu_torch.core.math import INF
from pbrlab_tpu_torch.ops import dense_curve
from pbrlab_tpu_torch.ops.curves import flatten_curves, subsegment_bounds
from pbrlab_tpu_torch.scene.demo import build_demo_scene
from pbrlab_tpu_torch.scene.scene import scene_from_numpy

HAIR = dict(subdiv=1, with_monkey=False, with_lucy=False, with_hair=True)
N = 3000  # not a multiple of the 128-lane group: exercises the padding
GRAZE_ULPS = 16
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


def test_any_hit_stops_groups_early(scene_np):
    """Rays aimed at sub-segment midpoints from all around, no dead lane:
    whole groups find hits, so the any-hit walk stops early; it still
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
    # the groups entered fewer clusters: the walk stopped early
    padded = dense_curve.pad_rays(*args[2:])
    entered = [int(dense_curve._walk_ref(*args[:2], *padded,
                                         any_hit=a)[4].sum())
               for a in (False, True)]
    assert entered[1] < entered[0]


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


@pytest.mark.requires_cuda
def test_cuda_kernel_matches_plain(scene_np):
    """Kernel vs plain walk on the card: equal bits, closest and any-hit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the dense_curve kernel is "
                    "CUDA-only)")
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
        dense_curve._walk_cuda(args[0], args[1], *(a[:100] for a in args[2:]))
