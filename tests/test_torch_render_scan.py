"""The port's scan path (`init_state(lane=None)`, `compact_state`,
`render_lanes`, `render_sample`, `render_scan`, `auto_k_volume`) against
the JAX package, at the goldens' size (16x16, 4 spp, max_steps 6, seed 7).

(a) `init_state(lane=None)` and `compact_state` field for field against
    JAX's: the same bits (but an ulp on a few camera directions), and the
    compaction the same permutation (its key is (primary << 29) |
    signature under a stable argsort in both).
(b) `render_scan` against tests/goldens/cpu_goldens.npz, JAX renders
    through its CPU BVH walk, in the goldens' band (>= 99% of values
    within rtol 1e-3/atol 1e-4, the mean within 1e-3 relative; measured:
    100% and a mean equal to the golden's on lambert, ggx and sss).
(c) One JAX `render_sample` (the sss scene, k_volume 2, 8x8, one sample,
    ~20 s of JAX compile on the CPU) against the port's in the same band
    (measured: 100% within the band, 64% of values bit-equal, largest
    difference 3.3e-7).
(d) The port's `render_scan` equals the port's `render` to the bit on the
    three scenes (measured): per lane the scan does the persistent lanes'
    work, both sum a pixel's samples in order from zero, and the scan's
    last any-hit answers what the wavefront's next dual trace does.
    sort_every 0 / 1 / 2 give the same bits (per-lane RNG).
(e) The auto k_volume rule gives 0 / 3 / > 3 (tests/test_integrator.py
    :174-194), and the port's truncation fraction on the sss scene beside
    JAX's (measured equal: 13 of 176 walks; JAX forces its CPU BVH walk,
    the port traces through dense_v4's twin, which can move a tied or
    grazing lane: band 1 walk in 100); forced to "bvh", the port's probe
    gives JAX's value exactly.
(f) `render_scan(tri_backend="bvh")` equals `render(tri_backend="bvh")`
    to the bit.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pbrlab_tpu.render import integrator as jint
from pbrlab_tpu.scene.demo import build_demo_scene as jbuild_demo_scene
from pbrlab_tpu.scene.scene import scene_to_device as jscene_to_device
from pbrlab_tpu_torch.render import integrator as tint
from pbrlab_tpu_torch.scene.scene import build_fat_tables, scene_from_numpy
from torch_threads import one_torch_thread  # noqa: F401

GOLDEN_PATH = "tests/goldens/cpu_goldens.npz"
GOLDEN_SCENES = {  # tests/test_goldens.py:25-41
    "lambert": (dict(subdiv=1, lambert_only=True), 0),
    "ggx": (dict(subdiv=1, with_lucy=False), 0),
    "sss": (dict(subdiv=1, with_monkey=False), 2),
}
W = H = 16
SPP = 4
SEED = 7


@pytest.fixture(scope="module")
def golden_scenes():
    """name -> (numpy scene from the JAX package's commit, the port's
    scene with its fat tables on the CPU, k_volume)."""
    out = {}
    for name, (kw, k_volume) in GOLDEN_SCENES.items():
        scene_np = jbuild_demo_scene(**kw)[0]
        out[name] = (scene_np,
                     build_fat_tables(scene_from_numpy(scene_np, "cpu")),
                     k_volume)
    return out


@pytest.fixture(scope="module")
def scans(golden_scenes):
    """The port's render_scan of each golden scene."""
    return {name: tint.render_scan(scene, W, H, SPP, seed=SEED, max_steps=6,
                                   k_volume=k).numpy()
            for name, (_, scene, k) in golden_scenes.items()}


@pytest.fixture(scope="module")
def demo():
    """The demo scene (glossy + SSS bodies), JAX's commit in both."""
    scene_np, _ = jbuild_demo_scene(subdiv=1)
    return jscene_to_device(scene_np), build_fat_tables(
        scene_from_numpy(scene_np, "cpu"))


def _to_jax(state):
    fields = []
    for x in state:
        a = x.numpy()
        fields.append(jnp.asarray(a.astype(np.uint32) if a.dtype == np.int64
                                  else a))
    return jint.PathState(*fields)


def _assert_state_equal(got, want):
    for name, g, w in zip(want._fields, got, want):
        w = np.asarray(w)
        g = g.numpy()
        if w.dtype == np.uint32:
            g = g.astype(np.uint32)
        assert g.shape == w.shape, name
        np.testing.assert_array_equal(g, w, err_msg=name)


def test_init_state_every_pixel_matches_jax(demo):
    """Every field equal but the normalised camera directions, which
    XLA:CPU and torch round differently on a few lanes (measured: 6 of
    1152 values, 1 ulp): those within rtol 1e-6."""
    scene_j, scene_t = demo
    want = jint.init_state(scene_j, 24, 16, jnp.uint32(3), SEED)
    got = tint.init_state(scene_t, 24, 16, 3, SEED)
    assert got.org.shape == (24 * 16, 3)
    np.testing.assert_allclose(got.direction.numpy(),
                               np.asarray(want.direction), rtol=1e-6, atol=0)
    _assert_state_equal(got._replace(direction=torch.from_numpy(
        np.asarray(want.direction))), want)


def test_compact_state_matches_jax(demo):
    """A state after three full steps and their volume substeps holds
    dead, walking and surface lanes; both compactions give the same
    permutation (the lane field) and every field equal."""
    scene_j, scene_t = demo
    rows = tint.pack_state(tint.init_state(scene_t, 32, 32, 0, SEED))
    for _ in range(3):
        rows = tint.wavefront_step(scene_t, rows)
        for i in range(2):
            rows = tint.wavefront_step(scene_t, rows, freeze_surface=True,
                                       resolve_pending=(i == 0))
    state = tint.unpack_state(rows)
    walking = state.alive & (state.mode == tint.MODE_VOLUME)
    assert (~state.alive).sum() > 10 and walking.sum() > 10
    assert (state.alive & ~walking).sum() > 10
    got = tint.compact_state(state, scene_t)
    want = jint.compact_state(_to_jax(state), scene_j)
    _assert_state_equal(got, want)
    # alive walkers first, then alive surface lanes, then the dead
    alive, mode = got.alive.numpy(), got.mode.numpy()
    primary = np.where(alive, 1 - mode, 2 + mode)
    assert (np.diff(primary) >= 0).all()


@pytest.mark.parametrize("name", sorted(GOLDEN_SCENES))
def test_render_scan_matches_goldens(scans, name):
    img = scans[name]
    golden = np.load(GOLDEN_PATH)[name]
    assert img.shape == golden.shape == (H, W, 3)
    assert np.isfinite(img).all() and (img >= 0).all()
    assert np.isclose(img, golden, rtol=1e-3, atol=1e-4).mean() >= 0.99
    assert abs(img.mean() - golden.mean()) <= 1e-3 * golden.mean()


@pytest.mark.parametrize("name", sorted(GOLDEN_SCENES))
def test_render_scan_equals_render(golden_scenes, scans, name):
    _, scene, k_volume = golden_scenes[name]
    img = tint.render(scene, W, H, SPP, seed=SEED, max_steps=6,
                      k_volume=k_volume).numpy()
    np.testing.assert_array_equal(scans[name], img)


def test_render_sample_matches_jax(golden_scenes):
    scene_np, scene, _ = golden_scenes["sss"]
    want = np.asarray(jint.render_sample(
        jscene_to_device(scene_np), 8, 8, jnp.uint32(0), seed=SEED,
        max_steps=6, k_volume=2))
    got = tint.render_sample(scene, 8, 8, 0, seed=SEED, max_steps=6,
                             k_volume=2).numpy()
    assert got.shape == want.shape == (8, 8, 3)
    assert np.isclose(got, want, rtol=1e-3, atol=1e-4).mean() >= 0.99
    assert abs(got.mean() - want.mean()) <= 1e-3 * want.mean()


@pytest.mark.parametrize("name", ["ggx", "sss"])
def test_sort_every_changes_no_bit(golden_scenes, name):
    """tests/test_integrator.py:133-145, plus sort_every 2 (the default)."""
    _, scene, k_volume = golden_scenes[name]
    imgs = [tint.render_lanes(scene, W, H, 1, seed=SEED, max_steps=6,
                              sort_every=se, k_volume=k_volume).numpy()
            for se in (0, 1, 2)]
    np.testing.assert_array_equal(imgs[1], imgs[0])
    np.testing.assert_array_equal(imgs[2], imgs[0])


def test_render_sample_deterministic_per_sample_id(golden_scenes):
    """tests/test_integrator.py:41-51."""
    _, scene, _ = golden_scenes["lambert"]
    a = tint.render_sample(scene, W, H, 3, seed=1, max_steps=6).numpy()
    b = tint.render_sample(scene, W, H, 3, seed=1, max_steps=6).numpy()
    np.testing.assert_array_equal(a, b)
    c = tint.render_sample(scene, W, H, 4, seed=1, max_steps=6).numpy()
    assert not np.array_equal(a, c)


def test_volume_substeps_noop_without_sss(golden_scenes, scans):
    """tests/test_integrator.py:104-111: no lane of the lambert scene
    enters volume mode."""
    _, scene, _ = golden_scenes["lambert"]
    assert not tint.scene_has_sss(scene)
    img = tint.render_scan(scene, W, H, SPP, seed=SEED, max_steps=6,
                           k_volume=3).numpy()
    np.testing.assert_array_equal(img, scans["lambert"])


def test_auto_k_volume_rule(golden_scenes):
    """tests/test_integrator.py:174-194, on the CPU."""
    lam = golden_scenes["lambert"][0]
    assert tint.auto_k_volume(lam, max_steps=16, probe=32, device="cpu") == 0
    sss = golden_scenes["sss"][0]
    assert tint.scene_has_sss(sss)
    assert tint.auto_k_volume(sss, max_steps=16, probe=32, device="cpu") == 3
    dense = dict(sss)
    mats = dict(dense["materials"])
    mats["subsurface_radius"] = (np.asarray(mats["subsurface_radius"])
                                 * 0.03).astype(np.float32)
    dense["materials"] = mats
    assert tint.auto_k_volume(dense, max_steps=16, probe=32,
                              device="cpu") > 3


@pytest.fixture(scope="module")
def jax_truncation(golden_scenes):
    """JAX's truncation fraction of the sss scene (its CPU BVH walk), 16
    steps, k_volume 3, a 32x32 probe."""
    from pbrlab_tpu.utils.profiling import measure_sss_truncation as jmeasure

    return jmeasure(golden_scenes["sss"][0], 16, k_volume=3, probe=32)


def test_sss_truncation_matches_jax(golden_scenes, jax_truncation):
    from pbrlab_tpu_torch.utils.profiling import measure_sss_truncation

    sss = golden_scenes["sss"][0]
    got = measure_sss_truncation(sss, 16, k_volume=3, probe=32, device="cpu")
    assert 0.0 < got < 0.08
    assert abs(got - jax_truncation) <= 0.01


def test_sss_truncation_bvh_equals_jax(golden_scenes, jax_truncation):
    """Through the "bvh" backend the probe traces what JAX's traces, and
    gives its value."""
    from pbrlab_tpu_torch.utils.profiling import measure_sss_truncation

    got = measure_sss_truncation(golden_scenes["sss"][0], 16, k_volume=3,
                                 probe=32, device="cpu", tri_backend="bvh")
    assert got == jax_truncation


def test_render_scan_bvh_equals_render(golden_scenes):
    """(d) through the "bvh" backend on the sss scene, whose k_volume
    substeps walk the BVH too."""
    _, scene, k = golden_scenes["sss"]
    scan = tint.render_scan(scene, W, H, SPP, seed=SEED, max_steps=6,
                            k_volume=k, tri_backend="bvh").numpy()
    img = tint.render(scene, W, H, SPP, seed=SEED, max_steps=6, k_volume=k,
                      tri_backend="bvh").numpy()
    np.testing.assert_array_equal(scan, img)
