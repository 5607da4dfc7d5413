"""dense_v4 trace of the port against the JAX package's Pallas kernels.

On the CPU the port's wrappers run the plain torch walk; the reference is
pbrlab_tpu.ops.pallas.dense_v4 in interpret mode, on the scene and rays of
tests/test_dense.py. Both compute the same float32 linear forms in the
same order, so hit masks and occlusion must be equal and t, u, v agree to
rtol 1e-5 (XLA:CPU may round a sum differently by an ulp). prim must be
equal wherever the hit t is unique: on an exact tie (a ray through a
shared edge) the first-visited triangle wins, so a differing prim must tie
in t.

The requires_cuda test compares the CUDA kernels with the plain walk on
the card. It imports no JAX, so it runs there with
`python -m pytest tests/test_torch_dense_v4.py --noconftest -o addopts=""
-m requires_cuda`.
"""
import numpy as np
import pytest
import torch

from pbrlab_tpu_torch.core.math import INF
from pbrlab_tpu_torch.ops import dense_v4
from pbrlab_tpu_torch.ops.intersect import occluded_scene
from pbrlab_tpu_torch.scene.demo import build_demo_scene
from pbrlab_tpu_torch.scene.scene import scene_from_numpy

N = 1500  # not a multiple of the 1024-ray group: exercises the padding


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


@pytest.mark.requires_cuda
def test_cuda_kernels_match_plain(scene_np):
    """Kernel vs plain walk on the card: same ops, no FMA contraction,
    IEEE division -> bit-equal closest hits and occlusion; any-hit equal
    hit masks."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the dense_v4 kernels are CUDA-only)")
    for n, seed in ((N, 5), (65536, 6)):
        args = _torch_args(scene_np, _rays(scene_np, n, seed), "cuda")
        before = dict(dense_v4.LAUNCHES)
        got, occ = dense_v4.dense_trace_v4_dual(*args)
        ref, ref_occ = dense_v4.dense_trace_v4_dual_ref(*args)
        torch.cuda.synchronize()
        assert dense_v4.LAUNCHES["dual"] == before["dual"] + 1
        for k in got:
            assert torch.equal(got[k], ref[k]), k
        assert torch.equal(occ, ref_occ)
        single = dense_v4.dense_trace_v4(*args[:6])
        ref1 = dense_v4.dense_trace_v4_ref(*args[:6])
        anyh = dense_v4.dense_trace_v4(*args[:6], any_hit=True)
        torch.cuda.synchronize()
        for k in single:
            assert torch.equal(single[k], ref1[k]), k
        assert torch.equal(anyh["prim"] >= 0, ref1["prim"] >= 0)
        with pytest.raises(ValueError):
            dense_v4._walk_cuda(args[0], *dense_v4._survivor_lists(
                torch.zeros((1, 4), dtype=torch.bool, device="cuda"),
                torch.zeros((1, 4), device="cuda")), *args[2:6])
