"""The port's integrator against the JAX package.

(a) One `wavefront_step` from the same state: the state comes from the JAX
    package's own first steps, then both packages advance it once, JAX
    forced to the port's backend for the scene (dense_v4, or dense_v5 /
    dense_v5s with their sparse substep backends) with its Pallas kernels
    in interpret mode. Same float32 math, same trace: every bool and int
    field must be equal; floats within rtol 1e-5 on 99.5% of values and
    rtol 1e-2 on all (XLA:CPU and torch may round a sum or a
    transcendental differently by an ulp, which the GGX sample of a few
    ill-conditioned lanes grows; see test_torch_shading.py). bsdf_pdf
    takes the 99.5% band only: on the
    glossy body (roughness 0.01, alpha 1e-4) it is a near-delta density
    that moves ~1/alpha times an ulp change of the sampled direction.
(b) The whole `render` against tests/goldens/cpu_goldens.npz, JAX CPU
    renders through its threaded-BVH backend at the same n_lanes. A
    different intersection algorithm moves hit points by ulps, which a
    path can amplify: >= 99% of values within rtol 1e-3/atol 1e-4 and the
    image mean within 1e-3 relative.
(c) The volume-substep window is a speed choice only: window 1 (nearly
    always the overflow branch, whose unwindowed substeps trace with
    dense_v5 where the windowed ones use dense_v4), the default and window
    off give equal images.
(d) Two renders give the same bits.
(e) Hair: a full step and a first substep of the hair golden scene in the
    band of (a), JAX's curves through its interpret-mode dense_curve; the
    render against the hair golden in the wider band its test measures
    (that golden went through JAX's curve BVH walk, ROADMAP C7).
"""
from functools import partial

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pbrlab_tpu.render import integrator as jint
from pbrlab_tpu.scene.demo import build_demo_scene as jbuild_demo_scene
from pbrlab_tpu.scene.scene import build_fat_tables as jbuild_fat_tables
from pbrlab_tpu.scene.scene import scene_to_device
from pbrlab_tpu_torch.render import integrator as tint
from pbrlab_tpu_torch.scene.demo import build_demo_scene
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
def scenes():
    """The demo scene (glossy + SSS bodies): the JAX package's commit,
    handed to both packages."""
    scene_np, _ = jbuild_demo_scene(subdiv=1)
    return (jbuild_fat_tables(scene_to_device(scene_np)),
            build_fat_tables(scene_from_numpy(scene_np, "cpu")))


def _force_jax_dense4(mp):
    """Force the JAX package onto dense_v4, interpreted on the CPU
    (`_closest_tri` / `_occluded_tri` import the wrapper at call time)."""
    from pbrlab_tpu.ops.pallas import dense_v4 as jv4

    mp.setenv("PBRLAB_TRACE_BACKEND", "dense4")
    mp.setattr(jv4, "dense_trace_v4",
               partial(jv4.dense_trace_v4, interpret=True))


@pytest.fixture()
def jax_dense4(monkeypatch):
    _force_jax_dense4(monkeypatch)


@pytest.fixture(scope="module")
def jax_states():
    """JAX init (32x32 camera lanes) + `steps` full steps on dense_v4, as
    `jax_states(scene_j, steps)`: each (scene, steps) computed once in
    this module, step k from step k - 1. JAX states are immutable, and
    each test hands the port its own copy (`_to_torch`)."""
    cache = {}

    def state(scene_j, steps):
        key = (id(scene_j), steps)
        if key not in cache:
            if steps == 0:
                new = jint.init_state(scene_j, 32, 32, jnp.uint32(0), 3)
            else:
                prev = state(scene_j, steps - 1)
                with pytest.MonkeyPatch.context() as mp:
                    _force_jax_dense4(mp)
                    new = jint.wavefront_step(scene_j, prev, 0)
            cache[key] = (scene_j, new)  # the scene stays alive: its id
        return cache[key][1]
    return state


def _to_torch(state):
    fields = []
    for x in state:
        a = np.asarray(x)
        if a.dtype == np.uint32:  # the rng word rides in int64
            a = a.astype(np.int64)
        fields.append(torch.from_numpy(a.copy()))
    return tint.PathState(*fields)


def _assert_state_close(got, want):
    for name, g, w in zip(want._fields, got, want):
        w = np.asarray(w)
        g = g.numpy()
        if w.dtype == np.uint32:
            np.testing.assert_array_equal(g.astype(np.uint32), w,
                                          err_msg=name)
        elif w.dtype.kind in "biu":
            np.testing.assert_array_equal(g, w, err_msg=name)
        else:
            assert np.isclose(g, w, rtol=1e-5, atol=1e-6).mean() >= 0.995, name
            if name != "bsdf_pdf":
                np.testing.assert_allclose(g, w, rtol=1e-2, atol=1e-5,
                                           err_msg=name)


@pytest.mark.parametrize("steps", [0, 2])
def test_full_step_matches_jax(scenes, jax_states, jax_dense4, steps):
    """A full step: dual trace (closest + pending shadow queries)."""
    scene_j, scene_t = scenes
    state = jax_states(scene_j, steps)
    if steps:
        assert (np.asarray(state.nee_maxt) >= 0).any()
    want = jint.wavefront_step(scene_j, state, 0)
    got = tint.wavefront_step(scene_t, _to_torch(state))
    _assert_state_close(got, want)


@pytest.mark.parametrize("resolve_pending", [True, False],
                         ids=["first-substep-dual", "later-substep-single"])
def test_volume_substep_matches_jax(scenes, jax_states, jax_dense4,
                                    resolve_pending):
    """A windowed volume substep: the first resolves the walkers' pending
    NEE (dual trace), later ones trace closest only."""
    scene_j, scene_t = scenes
    state = jax_states(scene_j, 2)
    walking = np.asarray(state.alive & (state.mode == jint.MODE_VOLUME))
    assert walking.sum() > 10
    want = jint.wavefront_step(scene_j, state, 0, freeze_surface=True,
                               resolve_pending=resolve_pending,
                               windowed=True)
    got = tint.wavefront_step(scene_t, _to_torch(state), freeze_surface=True,
                              resolve_pending=resolve_pending, windowed=True)
    _assert_state_close(got, want)


STEP_KINDS = {  # wavefront_step arguments of each kind of step
    "full": {},
    "first-substep": dict(freeze_surface=True, resolve_pending=True,
                          windowed=True),
    "later-substep": dict(freeze_surface=True, resolve_pending=False,
                          windowed=True),
    "unwindowed-substep": dict(freeze_surface=True, resolve_pending=False),
}


@pytest.mark.parametrize("kind", list(STEP_KINDS))
@pytest.mark.parametrize("backend", ["dense5", "dense5s"])
def test_step_matches_jax_on_v5_backends(scenes, jax_states, jax_dense4,
                                         monkeypatch, backend, kind):
    """One step of each kind on a scene dispatched to dense_v5 (the
    cluster limit patched to 0) or dense_v5s (its tables added to the
    subdiv=1 scene): full and windowed steps take that backend, the
    unwindowed substep its sparse one (dense_v5 stays, dense_v5s ->
    dense_v5l). The state comes from JAX steps on dense_v4; then JAX is
    forced to the backend, its kernels interpreted (`_closest_tri` calls
    dense_trace_v5 / v5l without `interpret=`)."""
    import jax.numpy as jnp
    from pbrlab_tpu.ops.pallas import dense_v5 as jv5
    from pbrlab_tpu_torch.ops import build as tbuild
    from pbrlab_tpu_torch.ops import intersect as tisect

    scene_j, scene_t = scenes
    state = jax_states(scene_j, 2)
    if backend == "dense5s":
        tris = np.asarray(scene_j["dense_tris_v4"])
        cut = (np.asarray(scene_j["v5_node_aabb"]),
               np.asarray(scene_j["v5_node_meta"]))
        roots, aabb = jv5.subtree_cut(*cut)
        scene_j = {**scene_j, "dense_tris_v5l": jnp.asarray(
            jv5.leaf_major(tris)), "v5s_roots": jnp.asarray(roots),
            "v5s_aabb": jnp.asarray(aabb)}
        roots, aabb = tbuild.subtree_cut(*cut, max_nodes=64)
        scene_t = {**scene_t, "dense_tris_v5l": torch.from_numpy(
            tbuild.leaf_major(tris)), "v5s_roots": torch.from_numpy(roots),
            "v5s_aabb": torch.from_numpy(aabb)}
    else:
        monkeypatch.setattr(tisect, "MAX_DENSE4_CLUSTERS", 0)
    assert tisect._tri_backend(scene_t) == backend
    monkeypatch.setenv("PBRLAB_TRACE_BACKEND", backend)
    for name in ("dense_trace_v5", "dense_trace_v5l"):
        monkeypatch.setattr(jv5, name,
                            partial(getattr(jv5, name), interpret=True))
    want = jint.wavefront_step(scene_j, state, 0, **STEP_KINDS[kind])
    got = tint.wavefront_step(scene_t, _to_torch(state), **STEP_KINDS[kind])
    _assert_state_close(got, want)


HAIR_SCENE = dict(subdiv=1, with_monkey=False, with_lucy=False,
                  with_hair=True)  # tests/test_goldens.py:43-47


@pytest.fixture(scope="module")
def hair_scenes():
    """The hair golden scene (walls, light, the 96-strand tuft): the JAX
    package's commit, handed to both packages."""
    scene_np, _ = jbuild_demo_scene(**HAIR_SCENE)
    return (jbuild_fat_tables(scene_to_device(scene_np)),
            build_fat_tables(scene_from_numpy(scene_np, "cpu")))


@pytest.mark.parametrize("kind", ["full", "first-substep"])
def test_hair_step_matches_jax(hair_scenes, jax_states, jax_dense4, kind):
    """A full step and a first substep of the hair scene, from the state
    after two JAX steps: the triangles through dense_v4, the curves
    through dense_curve (JAX interprets it on the CPU whenever its
    triangle backend is a dense one), hair lanes shaded with the
    Principled Hair BSDF. Same band as the triangle steps."""
    scene_j, scene_t = hair_scenes
    state = jax_states(scene_j, 2)
    assert int(np.asarray(state.alive).sum()) > 100
    want = jint.wavefront_step(scene_j, state, 0, **STEP_KINDS[kind])
    got = tint.wavefront_step(scene_t, _to_torch(state), **STEP_KINDS[kind])
    _assert_state_close(got, want)


def test_colored_hair_step_matches_jax(hair_scenes, jax_states, jax_dense4):
    """The curve_color override (per-strand CyHair colors under RGB
    coloring, -1 rows keep the material's): the hair scene with colors on
    every other segment and its material switched to RGB coloring."""
    scene_j, scene_t = hair_scenes
    state = jax_states(scene_j, 1)
    s = scene_t["curve_pts"].shape[0]
    col = np.random.default_rng(3).random((s, 3)).astype(np.float32)
    col[1::2] = -1.0
    hair_mat = int(scene_t["curve_material"][0])
    coloring = np.asarray(scene_j["materials"]["hair_coloring"]).copy()
    coloring[hair_mat] = 0
    jmats = {**scene_j["materials"], "hair_coloring": jnp.asarray(coloring)}
    tmats = {**scene_t["materials"],
             "hair_coloring": torch.from_numpy(coloring)}
    scene_j = jbuild_fat_tables({**scene_j, "materials": jmats,
                                 "curve_color": jnp.asarray(col)})
    uncolored = build_fat_tables({**scene_t, "materials": tmats})
    scene_t = {**uncolored, "curve_color": torch.from_numpy(col)}
    want = jint.wavefront_step(scene_j, state, 0)
    got = tint.wavefront_step(scene_t, _to_torch(state))
    _assert_state_close(got, want)
    # the colors reach the throughput
    plain = tint.wavefront_step(uncolored, _to_torch(state))
    assert not torch.equal(got.throughput, plain.throughput)


def test_hair_step_shades_hair_lanes(hair_scenes, jax_states, jax_dense4):
    """The first step from the camera hits the tuft on some lanes, and
    those lanes go on (the hair closure sample is taken, not dropped)."""
    from pbrlab_tpu_torch.core.math import INF
    from pbrlab_tpu_torch.ops.intersect import trace_scene

    scene_j, scene_t = hair_scenes
    state = _to_torch(jax_states(scene_j, 0))
    hit = trace_scene(scene_t, state.org, state.direction, state.min_t,
                      torch.full_like(state.min_t, INF))
    assert int(hit["is_curve"].sum()) > 10
    got = tint.wavefront_step(scene_t, state)
    assert bool(got.alive[hit["is_curve"]].any())


def _render_port(name, **kw):
    scene_kw, k_volume = GOLDEN_SCENES[name]
    scene = scene_from_numpy(build_demo_scene(**scene_kw)[0], "cpu")
    img = tint.render(scene, W, H, SPP, seed=SEED, max_steps=6,
                      k_volume=k_volume, **kw)
    return img.numpy()


@pytest.mark.parametrize("name", sorted(GOLDEN_SCENES))
def test_render_matches_goldens(name):
    img = _render_port(name)
    golden = np.load(GOLDEN_PATH)[name]
    assert img.shape == golden.shape == (H, W, 3)
    assert np.isfinite(img).all() and (img >= 0).all()
    assert np.isclose(img, golden, rtol=1e-3, atol=1e-4).mean() >= 0.99
    assert abs(img.mean() - golden.mean()) <= 1e-3 * golden.mean()


def test_volume_window_changes_no_pixel():
    """Window 1 overflows into the every-lane branch on nearly every
    sub-iteration; the default window fits; window off (= n_lanes) runs
    the substeps before the sort."""
    imgs = [_render_port("sss", vol_window=vw) for vw in (1, None, W * H)]
    np.testing.assert_array_equal(imgs[0], imgs[1])
    np.testing.assert_array_equal(imgs[2], imgs[1])


def test_hair_render_matches_golden():
    """The hair golden went through the JAX package's CPU curve BVH walk,
    which disagrees with the dense_curve semantics the port holds on ~1% of
    grazing lanes, and hair scattering spreads an ulp of a sampled
    direction over the later bounces. Measured: 98.57% of values within
    rtol 1e-3/atol 1e-4 and the mean 2.19e-3 relative off the golden (JAX
    forced onto dense_v4 + dense_curve: 98.44%, 1.25e-3; that JAX render
    against the golden: 98.83%, 0.94e-3). Band: >= 98% and 5e-3."""
    scene = scene_from_numpy(build_demo_scene(**HAIR_SCENE)[0], "cpu")
    img = tint.render(scene, W, H, SPP, seed=SEED, max_steps=6).numpy()
    golden = np.load(GOLDEN_PATH)["hair"]
    assert img.shape == golden.shape == (H, W, 3)
    assert np.isfinite(img).all() and (img >= 0).all()
    assert np.isclose(img, golden, rtol=1e-3, atol=1e-4).mean() >= 0.98
    assert abs(img.mean() - golden.mean()) <= 5e-3 * golden.mean()


def test_render_is_deterministic():
    a = _render_port("ggx", n_lanes=100, flush_every=2)
    b = _render_port("ggx", n_lanes=100, flush_every=2)
    np.testing.assert_array_equal(a, b)
    # fewer lanes than pixels: the work queue reclaims lanes; the image
    # stays within the golden band of the full-occupancy render
    golden = np.load(GOLDEN_PATH)["ggx"]
    assert np.isclose(a, golden, rtol=1e-3, atol=1e-4).mean() >= 0.99
