"""Gradients through the port's `render_lanes` (autograd, with the JAX
package's stop-gradient sites) against `jax.grad`, against central
differences, and with `remat` on and off.

(a) Port against JAX, at the JAX tests' scenes and sizes
    (tests/test_integrator.py:68-100, tests/test_gradients.py:153-167):
    the `base_color` gradient and the `face_emission` scale gradient of
    sum(render_sample) on the lambert scene at 8x8, max_steps 6, and the
    atlas gradient of the textured scene at 8x8, 2 samples, max_steps 4.
    JAX traces through its CPU BVH walk, the port through dense_v4's
    twin; a grazing lane may hit in one and miss in the other (ROADMAP
    C3). Band: |port - jax| <= 1e-4 * max|g_jax| + 1e-6 per entry
    (measured: base_color 4.5e-6 of a largest 4.21, the scale 3.8e-6 of
    27.9, the atlas 2.1e-7 of 0.746; every pixel's path the same).
(b) The port alone, with the JAX tests' tolerances: central differences
    for the emission scale (rtol 1e-2), roughness and specular (rtol
    5e-2) and the largest-gradient texel (rtol 5e-2); the sign of the
    seed-averaged subsurface_radius gradient of an MSE against a
    smaller-radius target (tests/test_gradients.py:83-118).
(c) remat=True gives the remat=False gradients to the bit on all eight
    leaves of the train step (the six material keys, `face_emission`,
    `texture_atlas`), every one finite, on the demo scene (glossy + SSS,
    k_volume 2) and the textured scene. The JAX package's specular
    gradient is NaN on the demo scene (ROADMAP C11); the port's is
    finite (`core.math.safe_sqrt`, the anisotropic branch of
    `shading.ggx.eval_pdf`).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pbrlab_tpu.render.integrator import render_sample as jrender_sample
from pbrlab_tpu.scene.demo import build_demo_scene as jbuild_demo_scene
from pbrlab_tpu.scene.scene import scene_to_device as jscene_to_device
from pbrlab_tpu_torch.parallel.sharding import GRAD_KEYS, SCENE_KEYS
from pbrlab_tpu_torch.render.integrator import render_lanes, render_sample
from pbrlab_tpu_torch.scene.demo import build_demo_scene
from pbrlab_tpu_torch.scene.scene import scene_from_numpy
from torch_scenes import glossy_scene, textured_scene
from torch_threads import one_torch_thread  # noqa: F401

BAND = 1e-4  # of the largest JAX entry, (a)


def with_leaves(scene, keys):
    """(scene copy, {key: leaf}): each key (a material column or a scene
    entry) a fresh leaf that requires grad."""
    s = dict(scene)
    mats = s["materials"] = dict(scene["materials"])
    leaves = {}
    for key in keys:
        src = mats if key in mats else s
        leaves[key] = src[key] = src[key].detach().clone().requires_grad_()
    return s, leaves


def scaled(scene, key, scale):
    """Scene copy with a material column or scene entry times `scale`."""
    s = dict(scene)
    mats = s["materials"] = dict(scene["materials"])
    src = mats if key in mats else s
    src[key] = src[key] * scale
    return s


def sample_mean(scene, spp, max_steps, size=8, **kw):
    """mean over samples 0..spp-1 of sum(render_sample), summed in order
    as the JAX tests do."""
    acc = 0.0
    for sid in range(spp):
        acc = acc + render_sample(scene, size, size, sid,
                                  max_steps=max_steps, **kw).sum()
    return acc / spp


def assert_in_band(got, want):
    want = np.asarray(want)
    err = np.abs(np.asarray(got) - want)
    assert (err <= BAND * np.abs(want).max() + 1e-6).all(), (
        err.max(), np.abs(want).max())


@pytest.fixture(scope="module")
def lambert_np():
    return jbuild_demo_scene(subdiv=1, lambert_only=True)[0]


@pytest.fixture(scope="module")
def textured_np():
    return textured_scene("pbrlab_tpu")


@pytest.fixture(scope="module")
def jax_lambert_grads(lambert_np):
    """One jitted JAX program: the base_color and emission-scale
    gradients of sum(render_sample(8x8, sample 0, max_steps 6))."""
    sj = jscene_to_device(lambert_np)

    def loss(base_color, scale):
        s = dict(sj)
        s["materials"] = {**s["materials"], "base_color": base_color}
        s["face_emission"] = s["face_emission"] * scale
        return jnp.sum(jrender_sample(s, 8, 8, jnp.uint32(0), max_steps=6))

    g = jax.jit(jax.grad(loss, argnums=(0, 1)))(
        sj["materials"]["base_color"], jnp.float32(1.0))
    return tuple(np.asarray(x) for x in g)


@pytest.fixture(scope="module")
def jax_atlas_grad(textured_np):
    """jax.grad of the mean over 2 samples of sum(render_sample(8x8,
    max_steps 4)) in the texture atlas (tests/test_gradients.py:153)."""
    sj = jscene_to_device(textured_np)

    def loss(atlas):
        s = dict(sj)
        s["texture_atlas"] = atlas
        acc = 0.0
        for sid in range(2):
            acc = acc + jnp.sum(jrender_sample(s, 8, 8, jnp.uint32(sid),
                                               max_steps=4))
        return acc / 2

    return np.asarray(jax.jit(jax.grad(loss))(sj["texture_atlas"]))


@pytest.fixture(scope="module")
def port_lambert_grads(lambert_np):
    scene, leaves = with_leaves(scene_from_numpy(lambert_np, "cpu"),
                                ["base_color"])
    scale = torch.tensor(1.0, requires_grad=True)
    loss = render_sample(scaled(scene, "face_emission", scale), 8, 8, 0,
                         max_steps=6).sum()
    g_base, g_scale = torch.autograd.grad(loss,
                                          [leaves["base_color"], scale])
    return g_base.numpy(), g_scale.numpy()


def test_base_color_gradient_matches_jax(port_lambert_grads,
                                         jax_lambert_grads):
    """tests/test_integrator.py:68-83: the gradient exists (finite,
    nonzero) and is JAX's in the band."""
    got, want = port_lambert_grads[0], jax_lambert_grads[0]
    assert np.isfinite(got).all() and np.abs(got).sum() > 0.0
    assert_in_band(got, want)


def test_emission_scale_gradient_matches_jax(port_lambert_grads,
                                             jax_lambert_grads):
    """tests/test_integrator.py:86-100: d sum(img) / d emission scale."""
    got, want = port_lambert_grads[1], jax_lambert_grads[1]
    assert np.isfinite(got) and got > 0.0
    assert_in_band(got, want)


def test_atlas_gradient_matches_jax(textured_np, jax_atlas_grad):
    scene, leaves = with_leaves(scene_from_numpy(textured_np, "cpu"),
                                ["texture_atlas"])
    got, = torch.autograd.grad(sample_mean(scene, 2, 4),
                               [leaves["texture_atlas"]])
    got = got.numpy()
    assert np.isfinite(got).all() and np.abs(got).max() > 0.0
    assert_in_band(got, jax_atlas_grad)


def _fd_check(loss, x0=1.0, eps=2e-2, rtol=5e-2):
    """autograd against central differences of a scalar loss(scale)."""
    x = torch.tensor(x0, requires_grad=True)
    g = float(torch.autograd.grad(loss(x), [x])[0])
    with torch.no_grad():
        fd = (float(loss(torch.tensor(x0 + eps)))
              - float(loss(torch.tensor(x0 - eps)))) / (2 * eps)
    assert np.isfinite(g) and np.isfinite(fd)
    assert abs(fd) > 1e-7, f"degenerate FD check: fd={fd}"
    np.testing.assert_allclose(g, fd, rtol=rtol, atol=1e-5)


@pytest.fixture(scope="module")
def lambert():
    return scene_from_numpy(build_demo_scene(subdiv=1, lambert_only=True)[0],
                            "cpu")


@pytest.fixture(scope="module")
def glossy():
    return scene_from_numpy(glossy_scene("pbrlab_tpu_torch"), "cpu")


@pytest.fixture(scope="module")
def textured():
    return scene_from_numpy(textured_scene("pbrlab_tpu_torch"), "cpu")


def test_emission_gradient_matches_fd(lambert):
    """Emission enters linearly: the gradient is the central difference
    almost exactly (tests/test_integrator.py:86-100)."""
    _fd_check(lambda sc: sample_mean(scaled(lambert, "face_emission", sc),
                                     1, 6), eps=1e-2, rtol=1e-2)


@pytest.mark.parametrize("key", ["roughness", "specular"])
def test_glossy_gradient_matches_fd(glossy, key):
    """Roughness -> GGX alpha and specular -> Fresnel-weighted closure
    selection (tests/test_gradients.py:59-80), 2 samples, max_steps 4."""
    _fd_check(lambda sc: sample_mean(scaled(glossy, key, sc), 2, 4))


def test_texture_texel_gradient_matches_fd(textured):
    """The largest-gradient texel of the atlas against central
    differences with eps 5e-3 (tests/test_gradients.py:153-179)."""
    scene, leaves = with_leaves(textured, ["texture_atlas"])
    g, = torch.autograd.grad(sample_mean(scene, 2, 4),
                             [leaves["texture_atlas"]])
    g = g.numpy()
    assert np.isfinite(g).all()
    idx = np.unravel_index(np.argmax(np.abs(g)), g.shape)
    eps = 5e-3
    atlas = textured["texture_atlas"]

    def loss_at(delta):
        a = atlas.clone()
        a[idx] += delta
        with torch.no_grad():
            return float(sample_mean({**textured, "texture_atlas": a}, 2, 4))

    fd = (loss_at(eps) - loss_at(-eps)) / (2 * eps)
    assert abs(fd) > 1e-7
    np.testing.assert_allclose(g[idx], fd, rtol=5e-2, atol=1e-5)


def test_subsurface_radius_gradient_sign():
    """The seed-averaged gradient of an MSE against a target rendered at
    half the radius points downhill (positive at scale 1.0), which only
    the detached-denominator surrogate gives (tests/test_gradients.py
    :83-118): 12x12, one sample, max_steps 8, k_volume 2, seeds 0-7."""
    scene = scene_from_numpy(build_demo_scene(subdiv=1,
                                              with_monkey=False)[0], "cpu")

    def render_at(scale, seed):
        return render_sample(scaled(scene, "subsurface_radius", scale), 12,
                             12, 0, seed=seed, max_steps=8, k_volume=2)

    with torch.no_grad():
        target = sum(render_at(torch.tensor(0.5), sd) for sd in range(8)) / 8
    gs = []
    for sd in range(8):
        x = torch.tensor(1.0, requires_grad=True)
        loss = ((render_at(x, sd) - target) ** 2).mean()
        gs.append(float(torch.autograd.grad(loss, [x])[0]))
    assert np.isfinite(gs).all()
    assert np.mean(gs) > 0.0, gs


@pytest.mark.parametrize("name", ["demo", "textured"])
def test_remat_gives_the_same_gradients(name, textured):
    """Per-depth checkpointing recomputes each depth's activations in the
    backward (the same RNG bits, the same substep branch): the eight
    leaves' gradients are the remat=False ones to the bit, all finite.
    The demo scene walks SSS (k_volume 2) and has no texture: its atlas
    is not read and gets no gradient."""
    if name == "demo":
        scene = scene_from_numpy(build_demo_scene(subdiv=1)[0], "cpu")
    else:
        scene = textured
    grads = []
    for remat in (False, True):
        s, leaves = with_leaves(scene, GRAD_KEYS + SCENE_KEYS)
        img = render_lanes(s, 8, 8, 0, seed=3, max_steps=6, remat=remat,
                           k_volume=2)
        loss = ((img - 0.25) ** 2).sum()
        grads.append(torch.autograd.grad(loss, list(leaves.values()),
                                         allow_unused=True))
    grads = [dict(zip(GRAD_KEYS + SCENE_KEYS, g)) for g in grads]
    for key, a in grads[0].items():
        b = grads[1][key]
        if a is None:
            assert b is None and name == "demo" and key == "texture_atlas"
            continue
        assert torch.isfinite(a).all(), key
        assert torch.equal(a, b), key
    # the textured floor reads its colour from the atlas
    live = (("base_color", "roughness") if name == "demo"
            else ("texture_atlas",)) + ("face_emission",)
    for key in live:
        assert grads[0][key].abs().sum() > 0.0, key
