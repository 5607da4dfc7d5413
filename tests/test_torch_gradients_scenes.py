"""Gradients through the hair lanes and through an instanced scene:
the port's `torch.autograd.grad` against `jax.grad` on the same scenes,
and a central-difference check of a hair column.

(a) Hair: `build_demo_scene(subdiv=1, with_hair=True)` (the demo tuft
    over the glossy + SSS cornellbox), sum(render_sample(16x16, sample 0,
    max_steps 4)); at 8x8 one pixel sees the tuft and the hair columns'
    gradients are ~1e-7, at 16x16 five pixels do. One jitted JAX program
    gives the gradients in `base_color`, the emission scale and the hair
    material's columns that `pbrlab_tpu/shading/hair.py` reads from the
    material table (HAIR_KEYS), called twice: with the demo's melanin
    coloring and with `hair_coloring` 0 (RGB, so `hair_base_color` is
    read). JAX traces through its CPU BVH walk and its curve BVH walk;
    the port is forced to the same walks (`tri_backend="bvh"`), since its
    default dense route holds the hair golden only in C7's wider band.
    Band: |port - jax| <= 1e-4 * max|g_jax| + 1e-6 per entry (BAND and
    the band of tests/test_torch_gradients.py). Every column holds it but
    one (ROADMAP C15): under melanin coloring the transmission tint's
    largest gap, 5.5e-6, is 1.15x the band. A witness holds it instead
    of a wider band: at that entry each package's gradient equals the
    central difference of its own forward within WITNESS_TOL, a fifth of
    the gap. Each package differentiates its own forward; the forwards'
    derivatives differ (their images agree in C7's band, not to the bit).
(b) Hair on the port's default route (dense_v4 + dense_curve twins): the
    melanin gradient against central differences at the JAX tests'
    tolerance (tests/test_gradients.py:22, rtol 5e-2).
(c) Instanced: a cut of tests/test_torch_instancing.py's textured
    scene (`_builder(pkg, K, "textured")` + `build_instanced`: SSS
    spheres whose subsurface colour is a texture, over a floor whose
    base colour is a texture), sum(render_sample(16x16, sample 0,
    max_steps 4)). JAX traces it through its interpret-mode
    dense_trace_v5i (pbrlab_tpu/ops/intersect.py:279-285). Its integrator
    stops the gradient at the trace's outputs, not its inputs, so
    `jax.grad` reaches `pallas_call`'s JVP rule, which fails on the
    kernel's constants (an AssertionError in jax/_src/pallas/
    pallas_call.py, ROADMAP C16). The test stops the gradient at the
    trace's inputs too (`_stop_trace_inputs`); the outputs were stopped
    already, so no value or gradient changes. The port traces through
    the dense_v5i twin on detached rays. One change to the scene: the
    light quad gets an untextured colour of its own, so that `base_color`
    has a gradient. The `base_color`, `texture_atlas` and emission-scale
    gradients hold BAND. The `subsurface_radius` gradient, walked in
    small dense spheres, misses it (C15: 3.9e-4 of its largest entry).
    Its witness: with JAX's own interpret-mode dense_trace_v5i swapped
    into the port (`_jax_v5i_trace`), every column, the radius included,
    holds BAND. So the port's gradient code agrees with JAX's, and the
    radius gap is the port's trace rounding the hit t otherwise.

JAX compiles two gradient programs, a forward and the interpret-mode
trace in this file, the file's cost.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pbrlab_tpu.render.integrator import render_sample as jrender_sample
from pbrlab_tpu.scene.scene import scene_to_device as jscene_to_device
from pbrlab_tpu_torch.render.integrator import render_sample
from pbrlab_tpu_torch.scene.materials import KIND_HAIR
from pbrlab_tpu_torch.scene.scene import scene_from_numpy
from torch_threads import one_torch_thread  # noqa: F401

BAND = 1e-4  # of the largest JAX entry (tests/test_torch_gradients.py)
# the two extra columns that miss BAND against jax.grad (ROADMAP C15):
# (scene, key); each is held by a witness test instead (module docstring)
C15 = {("melanin", "transmission_tint"), ("instanced", "subsurface_radius")}
# a gradient entry against the Richardson-extrapolated central difference
# of its own forward (absolute; the tint's gap to jax.grad is 5.5e-6)
WITNESS_TOL, WITNESS_STEP = 1e-6, 0.04
SIZE, MAX_STEPS = 16, 4  # the goldens' size (tests/test_goldens.py:20)
# every column of the material table that shading/hair.py reads with a
# float value: the RGB absorption (hair_base_color, azimuthal_roughness),
# the melanin absorption (melanin, melanin_redness), the lobes' roughness
# (hair_roughness, azimuthal_roughness), the tints, the IOR and the
# cuticle shift; `hair_coloring` is an int switch
HAIR_KEYS = ("hair_base_color", "melanin", "melanin_redness",
             "hair_roughness", "azimuthal_roughness", "hair_specular_tint",
             "transmission_tint", "second_specular_tint", "hair_ior",
             "shift")
COLORINGS = ("melanin", "rgb")  # hair_coloring 1 (the demo's) and 0
N_INSTANCES = 4  # the cut of the 9-instance textured scene
# the material columns compared on it (the spheres' walks read the radius)
INSTANCED_KEYS = ("base_color", "subsurface_radius")


def assert_in_band(got, want, key, band=BAND):
    want = np.asarray(want)
    err = np.abs(np.asarray(got) - want)
    assert np.isfinite(got).all(), key
    assert (err <= band * np.abs(want).max() + 1e-6).all(), (
        key, err.max(), np.abs(want).max())


def jax_grads(scene_np, keys, emission="face_emission", colorings=(None,),
              **kw):
    """One jitted JAX program: the gradients of
    sum(render_sample(SIZE^2, sample 0, MAX_STEPS)) in each material
    column of `keys`, in the scale of the scene's `emission` table
    ("scale") and in the texture atlas ("texture_atlas"); one dict per
    entry of `colorings` (a `hair_coloring` column, None: the scene's)."""
    sj = jscene_to_device(scene_np)
    mat_keys = list(keys)

    def loss(cols, scale, atlas, coloring):
        s = dict(sj)
        s["materials"] = {**s["materials"], **dict(zip(mat_keys, cols)),
                          "hair_coloring": coloring}
        s[emission] = s[emission] * scale
        s["texture_atlas"] = atlas
        return jnp.sum(jrender_sample(s, SIZE, SIZE, jnp.uint32(0),
                                      max_steps=MAX_STEPS, **kw))

    grad = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))
    out = []
    for coloring in colorings:
        if coloring is None:
            coloring = sj["materials"]["hair_coloring"]
        g_cols, g_scale, g_atlas = grad(
            [sj["materials"][k] for k in mat_keys], jnp.float32(1.0),
            sj["texture_atlas"], jnp.asarray(coloring))
        g = {k: np.asarray(x) for k, x in zip(mat_keys, g_cols)}
        g["scale"] = np.asarray(g_scale)
        g["texture_atlas"] = np.asarray(g_atlas)
        out.append(g)
    return out


def port_grads(scene_np, keys, emission="face_emission", coloring=None,
               **kw):
    """The port's gradients of the same loss, keyed as `jax_grads`."""
    scene = scene_from_numpy(scene_np, "cpu")
    mats = scene["materials"] = dict(scene["materials"])
    if coloring is not None:
        mats["hair_coloring"] = torch.as_tensor(coloring)
    leaves = {}
    for key in keys:
        leaves[key] = mats[key] = mats[key].detach().clone().requires_grad_()
    leaves["scale"] = torch.tensor(1.0, requires_grad=True)
    leaves["texture_atlas"] = scene["texture_atlas"] = (
        scene["texture_atlas"].detach().clone().requires_grad_())
    scene[emission] = scene[emission] * leaves["scale"]
    loss = render_sample(scene, SIZE, SIZE, 0, max_steps=MAX_STEPS,
                         **kw).sum()
    got = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
    return {k: None if g is None else g.numpy()
            for k, g in zip(leaves, got)}


@pytest.fixture(scope="module")
def hair_np():
    from pbrlab_tpu_torch.scene.demo import build_demo_scene

    return build_demo_scene(subdiv=1, with_hair=True)[0]


@pytest.fixture(scope="module")
def hair_grads(hair_np):
    """{coloring: (JAX's gradients, the port's)}."""
    keys = ("base_color",) + HAIR_KEYS
    rgb = np.zeros_like(hair_np["materials"]["hair_coloring"])
    want = jax_grads(hair_np, keys, colorings=(None, rgb))
    return {name: (w, port_grads(hair_np, keys, coloring=c,
                                 tri_backend="bvh"))
            for name, w, c in zip(COLORINGS, want, (None, rgb))}


@pytest.mark.parametrize("coloring,key", [
    (c, k) for c in COLORINGS for k in ("base_color", "scale") + HAIR_KEYS
    if (c, k) not in C15])
def test_hair_gradient_matches_jax(hair_grads, coloring, key):
    want, got = hair_grads[coloring]
    assert got[key] is not None, key
    assert_in_band(got[key], want[key], key)


def _richardson(f, h):
    """The central difference of f at 0 with steps h and h / 2,
    Richardson-extrapolated (error O(h^4))."""
    d1, d2 = ((f(s) - f(-s)) / (2 * s) for s in (h, h / 2))
    return (4 * d2 - d1) / 3


def test_hair_tint_gradient_follows_its_forward(hair_np, hair_grads):
    """C15's witness for the transmission tint under melanin coloring:
    at the entry where the port's gradient and jax.grad's differ most,
    each equals the central difference of its own package's forward (the
    float32 image summed in float64) within WITNESS_TOL, a fifth of their
    gap. So each package differentiates its own forward; the gap is the
    forwards' (module docstring, (a))."""
    key = "transmission_tint"
    want, got = hair_grads["melanin"]
    hair = int(np.flatnonzero(hair_np["materials"]["kind"] == KIND_HAIR)[0])
    ch = int(np.abs(got[key][hair] - want[key][hair]).argmax())
    col0 = np.asarray(hair_np["materials"][key])

    def shifted(d):
        col = col0.copy()
        col[hair, ch] += d
        return col

    sj = jscene_to_device(hair_np)
    jimage = jax.jit(lambda col: jrender_sample(
        {**sj, "materials": {**sj["materials"], key: col}}, SIZE, SIZE,
        jnp.uint32(0), max_steps=MAX_STEPS))
    scene = scene_from_numpy(hair_np, "cpu")

    def port_loss(d):
        mats = {**scene["materials"], key: torch.from_numpy(shifted(d))}
        with torch.no_grad():
            img = render_sample({**scene, "materials": mats}, SIZE, SIZE, 0,
                                max_steps=MAX_STEPS, tri_backend="bvh")
        return img.numpy().astype(np.float64).sum()

    fd_jax = _richardson(lambda d: np.asarray(
        jimage(jnp.asarray(shifted(d))), np.float64).sum(), WITNESS_STEP)
    fd_port = _richardson(port_loss, WITNESS_STEP)
    g_jax, g_port = float(want[key][hair, ch]), float(got[key][hair, ch])
    print(f"C15 tint[{hair}, {ch}]: jax.grad {g_jax:.9f} FD {fd_jax:.9f}; "
          f"port {g_port:.9f} FD {fd_port:.9f}")
    assert abs(g_port - g_jax) > 5 * WITNESS_TOL  # the gap to decide
    assert abs(g_jax - fd_jax) <= WITNESS_TOL, (g_jax, fd_jax)
    assert abs(g_port - fd_port) <= WITNESS_TOL, (g_port, fd_port)


@pytest.mark.parametrize("coloring", COLORINGS)
def test_hair_gradients_are_read(hair_np, hair_grads, coloring):
    """The hair material's row moves the loss: the gradients of the
    coloring's absorption columns and of the roughness columns are
    nonzero on both sides (the tuft is in view and lit), the other
    coloring's zero."""
    want, got = hair_grads[coloring]
    hair = int(np.flatnonzero(hair_np["materials"]["kind"] == KIND_HAIR)[0])
    live = ("melanin",) if coloring == "melanin" else ("hair_base_color",)
    dead = ("hair_base_color",) if coloring == "melanin" else ("melanin",)
    for key in live + ("hair_roughness", "azimuthal_roughness"):
        assert np.abs(want[key][hair]).max() > 0.0, key
        assert np.abs(got[key][hair]).max() > 0.0, key
    for key in dead:
        assert not want[key].any() and not got[key].any(), key


def _fd_check(loss, x0=1.0, eps=2e-2, rtol=5e-2):
    """autograd against central differences of a scalar loss(scale), at
    the JAX tests' tolerance (tests/test_gradients.py:22)."""
    x = torch.tensor(x0, requires_grad=True)
    g = float(torch.autograd.grad(loss(x), [x])[0])
    with torch.no_grad():
        fd = (float(loss(torch.tensor(x0 + eps)))
              - float(loss(torch.tensor(x0 - eps)))) / (2 * eps)
    assert np.isfinite(g) and np.isfinite(fd)
    assert abs(fd) > 1e-7, f"degenerate FD check: fd={fd}"
    np.testing.assert_allclose(g, fd, rtol=rtol, atol=1e-5)


def test_hair_melanin_gradient_matches_fd(hair_np):
    """The default route (dense_v4 + dense_curve twins): d sum(img) / d
    melanin scale against central differences."""
    scene = scene_from_numpy(hair_np, "cpu")

    def loss(scale):
        mats = {**scene["materials"],
                "melanin": scene["materials"]["melanin"] * scale}
        return render_sample({**scene, "materials": mats}, SIZE, SIZE, 0,
                             max_steps=MAX_STEPS).sum()

    _fd_check(loss)


def _builder(k):
    """tests/test_torch_instancing.py's textured k-instance scene (test
    files do not import each other), built by the port: SSS spheres shared
    through one BLAS under per-instance rotation and scale, their
    subsurface colour a texture, over a floor whose base colour is a
    texture read through texcoords, under a light quad. One change: the
    light quad has a material of its own with an untextured base colour
    (there it shares the floor's), so that the `base_color` column has a
    gradient. Its commit is JAX's bit for bit (test_torch_instancing.py
    holds the builder's commits to JAX's)."""
    from pbrlab_tpu_torch.scene import demo, scene

    b = scene.SceneBuilder()
    m = b.materials
    rng = np.random.default_rng(0)
    white = m.add_principled(
        "floor", base_color=(0.7, 0.7, 0.7), specular=0.0,
        base_color_tex_id=b.add_texture(
            rng.random((8, 12, 3)).astype(np.float32)))
    side = max(3.0, np.sqrt(k) * 1.2)
    floor = demo.quad_mesh([-side, 0, -side], [-side, 0, side],
                           [side, 0, side], [side, 0, -side], white, "floor")
    floor.texcoords = np.asarray([[0, 0], [0, 2], [2, 2], [2, 0]],
                                 np.float32)
    floor.texcoord_idx = floor.faces.copy()
    b.add_instance([floor])
    lid = b.add_area_light_param((12.0,) * 3)
    lamp = m.add_principled("lamp", base_color=(0.8, 0.8, 0.8),
                            specular=0.0)  # the one untextured colour
    light = demo.quad_mesh([-1, 4.0, -1], [1, 4.0, -1], [1, 4.0, 1],
                           [-1, 4.0, 1], lamp, "light")
    b.add_instance([light], light_ids=[np.full((2,), lid, np.int32)])
    ball = m.add_principled(  # scene/demo.py's SSS body
        "ball", base_color=(1.0, 0.8, 0.8), subsurface=1.0,
        subsurface_radius=(1.0, 0.2, 0.1), subsurface_color=(1.0, 0.8, 0.8),
        specular=0.0, roughness=0.2,
        subsurface_color_tex_id=b.add_texture(
            0.5 + 0.5 * rng.random((5, 7)).astype(np.float32)))
    sphere = demo.icosphere(1, 0.45, material_id=ball, name="ball")
    per_row = int(np.ceil(np.sqrt(k)))
    ts = []
    for i in range(k):  # tests/test_instancing.py:_transforms
        c, s = np.cos(0.7 * i), np.sin(0.7 * i)
        t = np.eye(4)
        t[:3, :3] = (np.asarray([[c, 0, s], [0, 1, 0], [-s, 0, c]])
                     * (0.8 + 0.1 * (i % 3)))
        t[:3, 3] = ((i % per_row) * 1.2 - per_row * 1.2 / 2, 0.55,
                    (i // per_row) * 1.2 - per_row * 1.2 / 2)
        ts.append(t)
    b.add_shared_instances([sphere], np.stack(ts).astype(np.float32))
    return b


def _stop_trace_inputs(monkeypatch):
    """JAX's triangle traces with the gradient stopped at their inputs as
    well as at their outputs (module docstring, (c))."""
    from pbrlab_tpu.ops import intersect

    for name in ("_closest_tri", "_occluded_tri"):
        fn = getattr(intersect, name)

        def stopped(scene, org, direction, min_t, max_t, backend=None,
                    fn=fn):
            rays = map(jax.lax.stop_gradient, (org, direction, min_t, max_t))
            return fn(scene, *rays, backend)

        monkeypatch.setattr(intersect, name, stopped)


@pytest.fixture(scope="module")
def instanced_np():
    from pbrlab_tpu_torch.scene.instanced import build_instanced

    return build_instanced(_builder(N_INSTANCES))


def _jax_v5i_trace(monkeypatch):
    """The port's instanced trace replaced by JAX's: its interpret-mode
    dense_trace_v5i on the same tables and rays (C15's witness)."""
    from pbrlab_tpu.ops.pallas.dense_v5i import dense_trace_v5i
    from pbrlab_tpu_torch.ops import intersect

    programs = {}

    def trace(*args, any_hit=False):
        if any_hit not in programs:
            programs[any_hit] = jax.jit(functools.partial(
                dense_trace_v5i, any_hit=any_hit, interpret=True))
        res = programs[any_hit](*(jnp.asarray(a.detach().numpy())
                                  for a in args))
        return {k: torch.from_numpy(np.array(v)) for k, v in res.items()}

    monkeypatch.setattr(intersect, "dense_trace_v5i", trace)


INSTANCED_COLUMNS = INSTANCED_KEYS + ("texture_atlas", "scale")


@pytest.fixture(scope="module")
def instanced_grads(instanced_np):
    """(JAX's gradients, the port's, the port's on JAX's trace)."""
    kw = dict(emission="iface_emission")
    with pytest.MonkeyPatch.context() as mp:
        _stop_trace_inputs(mp)
        (want,) = jax_grads(instanced_np, INSTANCED_KEYS, **kw)
    got = port_grads(instanced_np, INSTANCED_KEYS, **kw)
    with pytest.MonkeyPatch.context() as mp:
        _jax_v5i_trace(mp)
        on_jax_trace = port_grads(instanced_np, INSTANCED_KEYS, **kw)
    return want, got, on_jax_trace


@pytest.mark.parametrize("key", [k for k in INSTANCED_COLUMNS
                                 if ("instanced", k) not in C15])
def test_instanced_gradient_matches_jax(instanced_grads, key):
    """Every compared column has a gradient: `base_color` through the
    light quad's untextured colour, the atlas through the floor's and the
    spheres' textures."""
    want, got, _ = instanced_grads
    assert got[key] is not None, key
    assert np.abs(want[key]).max() > 0.0, key
    assert_in_band(got[key], want[key], key)


@pytest.mark.parametrize("key", INSTANCED_COLUMNS)
def test_instanced_gradient_on_jax_trace_matches_jax(instanced_grads, key):
    """C15's witness for the radius: with JAX's own dense_trace_v5i in
    place of the port's, the port's gradients of every column, the
    radius included, are jax.grad's within BAND. So the port's gradient
    code is JAX's, and the radius's gap on the port's own trace is the
    trace's rounding of the hit t (module docstring, (c))."""
    want, got, on_jax_trace = instanced_grads
    scale = np.abs(want[key]).max()
    print(f"C15 {key}: port {np.abs(got[key] - want[key]).max() / scale:.3e}"
          f", on JAX's trace "
          f"{np.abs(on_jax_trace[key] - want[key]).max() / scale:.3e} "
          "of the largest jax.grad entry")
    assert_in_band(on_jax_trace[key], want[key], key)
