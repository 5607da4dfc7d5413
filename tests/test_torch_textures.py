"""Textures and image IO of the port against the JAX package.

The four fetch functions take the same random atlases (RGB and RGBA, three
textures of unequal sizes padded into one stack) and the same lanes, with
u and v in [-1.5, 2.5] so that clamp addressing runs on every edge. Both
compute the same float32 products in the same order; XLA:CPU may contract
a product and a sum (ROADMAP C7), so values agree within rtol 1e-6 /
atol 1e-6 and `build_quad_atlas` (a pure gather) exactly. The quad fetch
equals the naive four-texel fetch within the same tolerance (where a
corner is clamped the two paths weight equal texels differently).
`add_texture` + `build()` and the fat tables give JAX's atlas, sizes and
quad atlas exactly. The sRGB pair is numpy in both packages and must agree
to the bit; the PNG round trip needs Pillow and skips without it.
"""
import numpy as np
import pytest
import torch

from pbrlab_tpu_torch.io import image
from pbrlab_tpu_torch.scene import textures

SIZES = [(8, 12), (5, 7), (16, 3)]  # (h, w) of the three textures


def _atlas(channels, seed=0):
    rng = np.random.default_rng(seed)
    h = max(s[0] for s in SIZES)
    w = max(s[1] for s in SIZES)
    atlas = np.zeros((len(SIZES), h, w, channels), np.float32)
    for i, (th, tw) in enumerate(SIZES):
        atlas[i, :th, :tw] = rng.random((th, tw, channels))
    return atlas, np.asarray(SIZES, np.int32)


def _lanes(n=4096, seed=1):
    rng = np.random.default_rng(seed)
    tex = rng.integers(-1, len(SIZES), n).astype(np.int32)  # -1 -> texture 0
    u = rng.uniform(-1.5, 2.5, n).astype(np.float32)
    v = rng.uniform(-1.5, 2.5, n).astype(np.float32)
    return tex, u, v


@pytest.mark.parametrize("channels", [3, 4], ids=["rgb", "rgba"])
def test_fetch_functions_match_jax(channels):
    import jax.numpy as jnp
    from pbrlab_tpu.scene import textures as jtex

    atlas, sizes = _atlas(channels)
    lanes = _lanes()
    ja = [jnp.asarray(x) for x in (atlas, sizes)]
    jl = [jnp.asarray(x) for x in lanes]
    ta = [torch.from_numpy(x) for x in (atlas, sizes)]
    tl = [torch.from_numpy(x) for x in lanes]
    quad_j = jtex.build_quad_atlas(*ja)
    quad_t = textures.build_quad_atlas(*ta)
    assert quad_t.shape == (3, 16, 12, 4 * channels)
    np.testing.assert_array_equal(quad_t.numpy(), np.asarray(quad_j))
    for name, j_args, t_args, width in (
            ("fetch_float_n", (*ja, *jl), (*ta, *tl), channels),
            ("fetch_float3", (*ja, *jl), (*ta, *tl), 3),
            ("fetch_float3_quad", (quad_j, ja[1], *jl),
             (quad_t, ta[1], *tl), 3)):
        want = np.asarray(getattr(jtex, name)(*j_args))
        got = getattr(textures, name)(*t_args).numpy()
        assert got.shape == want.shape == (4096, width), name
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6,
                                   err_msg=name)


@pytest.mark.parametrize("channels", [3, 4], ids=["rgb", "rgba"])
def test_quad_fetch_equals_naive(channels):
    atlas, sizes = _atlas(channels, seed=2)
    tex, u, v = (torch.from_numpy(x) for x in _lanes(seed=3))
    atlas, sizes = torch.from_numpy(atlas), torch.from_numpy(sizes)
    quad = textures.build_quad_atlas(atlas, sizes)
    naive = textures.fetch_float3(atlas, sizes, tex, u, v)
    torch.testing.assert_close(
        textures.fetch_float3_quad(quad, sizes, tex, u, v), naive,
        rtol=1e-6, atol=1e-6)
    # inside a texture, away from the clamped border, the fetch is the
    # texel value at its centre
    th, tw = SIZES[0]
    x, y = 3, 5
    centre = textures.fetch_float3(
        atlas, sizes, torch.zeros(1, dtype=torch.int32),
        torch.tensor([(x + 0.5) / tw]), torch.tensor([(y + 0.5) / th]))
    torch.testing.assert_close(centre[0], atlas[0, y, x, :3])


def _textured_builder(pkg_scene, pkg_demo):
    """Three textures: a gray [H, W] image (repeated to RGB), an RGB and
    an RGBA one, on three quads."""
    rng = np.random.default_rng(4)
    b = pkg_scene.SceneBuilder()
    ids = [b.add_texture(rng.random((6, 9)).astype(np.float32), "gray"),
           b.add_texture(rng.random((4, 5, 3)).astype(np.float32), "rgb"),
           b.add_texture(rng.random((7, 3, 4)).astype(np.float32), "rgba")]
    for i, tid in enumerate(ids):
        mat = b.materials.add_principled(f"m{i}", base_color_tex_id=tid)
        q = pkg_demo.quad_mesh([i, 0, 0], [i + 1, 0, 0], [i + 1, 1, 0],
                               [i, 1, 0], mat, f"q{i}")
        b.add_instance([q])
    return b


def test_add_texture_atlas_matches_jax():
    from pbrlab_tpu.scene import demo as jdemo
    from pbrlab_tpu.scene import scene as jscene
    from pbrlab_tpu.scene.scene import build_fat_tables as jfat
    from pbrlab_tpu.scene.scene import scene_to_device
    from pbrlab_tpu_torch.scene import demo, scene

    want = jscene.commit(_textured_builder(jscene, jdemo).build())
    got = scene.commit(_textured_builder(scene, demo).build())
    for key in ("texture_atlas", "texture_sizes"):
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    assert got["texture_atlas"].shape == (3, 7, 9, 4)
    assert (got["texture_atlas"][:2, ..., 3] == 1.0).all()  # opaque
    fat = scene.build_fat_tables(scene.scene_from_numpy(got, "cpu"))
    np.testing.assert_array_equal(
        fat["texture_quad"].numpy(),
        np.asarray(jfat(scene_to_device(want))["texture_quad"]))
    # a scene without textures gets the dummy atlas and no quad atlas
    atlas, sizes = scene.texture_atlas([])
    assert atlas.shape == (1, 1, 1, 3) and sizes.shape == (1, 2)
    plain = scene.build_fat_tables(scene.scene_from_numpy(
        {**got, "texture_atlas": atlas, "texture_sizes": sizes}, "cpu"))
    assert "texture_quad" not in plain


def test_fetch_colors_matches_jax():
    """The integrator's colour fetch: texture where the tex id is >= 0,
    the material's constant elsewhere."""
    import jax.numpy as jnp
    from pbrlab_tpu.render import integrator as jint
    from pbrlab_tpu.scene import demo as jdemo
    from pbrlab_tpu.scene import scene as jscene
    from pbrlab_tpu.scene.scene import build_fat_tables as jfat
    from pbrlab_tpu.scene.scene import scene_to_device
    from pbrlab_tpu_torch.render import integrator as tint
    from pbrlab_tpu_torch.scene import scene

    b = _textured_builder(jscene, jdemo)
    b.materials.add_principled("plain", base_color=(0.1, 0.2, 0.3))
    scene_np = jscene.commit(b.build())
    rng = np.random.default_rng(5)
    mat_id = rng.integers(0, 4, 2048).astype(np.int32)
    uv = rng.uniform(-0.5, 1.5, (2048, 2)).astype(np.float32)
    js = jfat(scene_to_device(scene_np))
    jb, jsub = jint._fetch_colors(js, jint._gather_material(
        js, jnp.asarray(mat_id)), jnp.asarray(uv))
    ts = scene.build_fat_tables(scene.scene_from_numpy(scene_np, "cpu"))
    tb, tsub = tint._fetch_colors(ts, tint._gather_material(
        ts, torch.from_numpy(mat_id)), torch.from_numpy(uv))
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(tsub.numpy(), np.asarray(jsub), rtol=1e-6,
                               atol=1e-6)
    plain = mat_id == 3
    np.testing.assert_array_equal(tb.numpy()[plain],
                                  np.broadcast_to([0.1, 0.2, 0.3],
                                                  (plain.sum(), 3))
                                  .astype(np.float32))


def test_srgb_pair_matches_jax():
    from pbrlab_tpu.io import image as jimage

    x = np.linspace(-0.1, 1.2, 1001, dtype=np.float32).reshape(7, 11, 13)
    for name, arg in (("srgb_to_linear", np.abs(x)), ("linear_to_srgb", x)):
        got = getattr(image, name)(arg)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, getattr(jimage, name)(arg),
                                      err_msg=name)
    y = np.linspace(0.0, 1.0, 257, dtype=np.float32)
    np.testing.assert_allclose(image.srgb_to_linear(image.linear_to_srgb(y)),
                               y, rtol=1e-5, atol=1e-6)


def test_png_round_trip(tmp_path):
    pytest.importorskip("PIL")
    from pbrlab_tpu_torch.render import film

    rng = np.random.default_rng(6)
    img = rng.random((9, 13, 3)).astype(np.float32)
    path = str(tmp_path / "img.png")
    image.write_png(path, img)
    back = image.load_image(path)
    assert back.shape == (9, 13, 3) and back.dtype == np.float32
    # x256 then clamp to 255 and truncate: back = floor(min(256 x, 255)) / 255
    want = np.floor(np.clip(img * 256.0, 0.0, 255.0)) / 255.0
    np.testing.assert_allclose(back, want, atol=1e-6)
    # film: linear -> sRGB -> PNG, from a torch tensor
    film.save_png(str(tmp_path / "film.png"), torch.from_numpy(img))
    np.testing.assert_allclose(
        image.load_image(str(tmp_path / "film.png")),
        np.floor(np.clip(image.linear_to_srgb(img) * 256.0, 0.0, 255.0))
        / 255.0, atol=1e-6)
    assert image.load_image(str(tmp_path / "missing.png")) is None
