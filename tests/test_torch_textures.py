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

`io.image.decode_png` (zlib + struct) against Pillow, whose
`Image.open(p).convert("RGB")` is the JAX package's `load_image`: files
Pillow writes in modes 1, L, LA, P, RGB, RGBA and I;16 (plain and
optimised), and files written here with every row's filter forced
(None, Sub, Up, Average, Paeth in turn; Pillow's own writer uses only
None, Sub, Up and Paeth) at each colour type and bit depth the decoder
reads, plain and Adam7-interlaced; its pixels must equal Pillow's
exactly. Also the round trip through `encode_png`, `load_image` with
Pillow hidden, and the refusals (a bad CRC, an unknown interlace
method).
"""
import io
import struct
import sys
import zlib

import numpy as np
import pytest
import torch

from pbrlab_tpu_torch.io import image
from pbrlab_tpu_torch.scene import textures
from torch_threads import one_torch_thread  # noqa: F401

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


def _chunk(kind, body):
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body)))


def _filter_rows(samples, depth):
    """The rows of `samples` [H, W, spp] (integers < 2^depth), each with
    its filter byte, filtered with types 0, 1, 2, 3, 4, 0, ... in turn
    (the forward filters of the PNG specification, section 9)."""
    h, w, spp = samples.shape
    if depth == 16:
        raw = samples.astype(">u2").view(np.uint8).reshape(h, -1)
    elif depth == 8:
        raw = samples.astype(np.uint8).reshape(h, -1)
    else:
        bits = np.unpackbits(samples.astype(np.uint8)[..., None], axis=-1)
        bits = bits[..., 8 - depth:].reshape(h, -1)
        raw = np.packbits(bits, axis=1)
    bpp = max(1, spp * depth // 8)
    x = raw.astype(np.int32)
    prev = np.zeros_like(x[0])
    out = []
    for r in range(h):
        ftype = r % 5
        a = np.concatenate([np.zeros(bpp, np.int32), x[r, :-bpp]])
        c = np.concatenate([np.zeros(bpp, np.int32), prev[:-bpp]])
        b = prev
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        paeth = np.where((pa <= pb) & (pa <= pc), a,
                         np.where(pb <= pc, b, c))
        pred = [0, a, b, (a + b) // 2, paeth][ftype]
        out.append(bytes([ftype]) + ((x[r] - pred) & 0xFF).astype(
            np.uint8).tobytes())
        prev = x[r]
    return b"".join(out)


# Adam7's passes: (x0, y0, dx, dy) (PNG specification, section 8.2)
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
         (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def _filtered_png(samples, depth, ctype, palette=None, interlace=0):
    """PNG bytes of `samples` [H, W, spp] with every filter type in use;
    with `interlace` 1, Adam7: each non-empty pass's sub-image filtered
    on its own, the passes in order."""
    h, w, _ = samples.shape
    if interlace:
        body = b"".join(_filter_rows(samples[y0::dy, x0::dx], depth)
                        for x0, y0, dx, dy in ADAM7
                        if x0 < w and y0 < h)
    else:
        body = _filter_rows(samples, depth)
    extra = b"" if palette is None else _chunk(b"PLTE", palette.tobytes())
    return (b"\x89PNG\r\n\x1a\n"
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0,
                                          0, interlace))
            + extra + _chunk(b"IDAT", zlib.compress(body))
            + _chunk(b"IEND", b""))


def _pillow_rgb(data):
    from PIL import Image

    with Image.open(io.BytesIO(data)) as im:
        return np.asarray(im.convert("RGB"))


def _smooth(h, w, channels, top, seed):
    """A gradient plus noise, so that every filter has work to do."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    ramp = (x[..., None] * (1 + np.arange(channels))
            + y[..., None] * (3 - np.arange(channels)) % 5)
    return (ramp * top // (w + 3 * h) + rng.integers(0, 1 + top // 16,
                                                     (h, w, channels))
            ) % (top + 1)


def test_decode_png_round_trip():
    rng = np.random.default_rng(11)
    for h, w in ((1, 1), (7, 13), (32, 17)):
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        np.testing.assert_array_equal(image.decode_png(image.encode_png(img)),
                                      img)


@pytest.mark.parametrize("mode", ["1", "L", "LA", "P", "RGB", "RGBA", "I;16",
                                  "RGB-optimized"])
def test_decode_png_matches_pillow_files(mode):
    """Files Pillow writes, read by Pillow (the JAX package's load_image)
    and by decode_png: the same pixels. Pillow filters their rows with
    None, Sub, Up and Paeth."""
    Image = pytest.importorskip("PIL.Image")
    rgb = _smooth(40, 37, 3, 255, seed=3).astype(np.uint8)
    if mode in ("RGB", "RGB-optimized"):
        im = Image.fromarray(rgb)
    elif mode == "RGBA":
        im = Image.fromarray(np.concatenate([rgb, rgb[..., :1]], axis=2))
    elif mode == "LA":
        im = Image.fromarray(rgb[..., :2].copy())
    elif mode == "L":
        im = Image.fromarray(rgb[..., 0].copy())
    elif mode == "1":
        im = Image.fromarray(rgb[..., 0] > 100)
    elif mode == "P":
        im = Image.fromarray(rgb).convert(
            "P", palette=Image.Palette.ADAPTIVE, colors=50)
    else:  # "I;16": 16-bit grey, most values above 255
        im = Image.fromarray(rgb[..., 0].astype(np.uint16) * 7)
    assert im.mode == mode.split("-")[0]
    buf = io.BytesIO()
    im.save(buf, "PNG", optimize=mode.endswith("optimized"))
    data = buf.getvalue()
    got = image.decode_png(data)
    assert got.dtype == np.uint8 and got.shape == (40, 37, 3)
    np.testing.assert_array_equal(got, _pillow_rgb(data))


@pytest.mark.parametrize("interlace", [0, 1], ids=["plain", "adam7"])
@pytest.mark.parametrize("depth,ctype", [
    (1, 0), (2, 0), (4, 0), (8, 0), (16, 0), (8, 2), (16, 2), (1, 3),
    (2, 3), (4, 3), (8, 3), (8, 4), (16, 4), (8, 6), (16, 6)])
def test_decode_png_filters_match_pillow(depth, ctype, interlace):
    """Every colour type and bit depth, plain and Adam7-interlaced, each
    file's rows (each pass's) through all five filters (Average and Paeth
    included): decode_png equals Pillow, so 16-bit grey clips to 255 and
    other 16-bit samples keep their high byte, as Pillow converts them.
    Pillow's writer cannot interlace; its reader is the reference."""
    pytest.importorskip("PIL")
    spp = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[ctype]
    top = (1 << depth) - 1
    palette = None
    if ctype == 3:  # fewer entries than indices: the rest read black
        rng = np.random.default_rng(depth)
        palette = rng.integers(0, 256, (max(2, top), 3), dtype=np.uint8)
    samples = _smooth(21, 19, spp, top, seed=depth + ctype)
    if depth == 16 and ctype == 0:  # both sides of Pillow's clip at 255
        samples[::2] %= 300
    data = _filtered_png(samples, depth, ctype, palette, interlace)
    got = image.decode_png(data)
    assert got.shape == (21, 19, 3)
    np.testing.assert_array_equal(got, _pillow_rgb(data))


@pytest.mark.parametrize("h,w", [(1, 1), (2, 3), (5, 9), (9, 5), (8, 8)])
def test_decode_png_adam7_small_images(h, w):
    """Adam7 images small enough that some passes are empty (no bytes in
    the stream), at 8-bit RGB and 1-bit grey: decode_png equals Pillow and
    the plain file of the same samples."""
    pytest.importorskip("PIL")
    for depth, ctype, spp in ((8, 2, 3), (1, 0, 1)):
        samples = _smooth(h, w, spp, (1 << depth) - 1, seed=h * w)
        laced = _filtered_png(samples, depth, ctype, interlace=1)
        got = image.decode_png(laced)
        np.testing.assert_array_equal(got, _pillow_rgb(laced))
        np.testing.assert_array_equal(
            got, image.decode_png(_filtered_png(samples, depth, ctype)))


def test_load_image_png_without_pillow(tmp_path, monkeypatch):
    """A PNG texture loads the same with Pillow importable and hidden (the
    card's machine has no Pillow), as the JAX package loads it."""
    rgb = _smooth(9, 14, 3, 255, seed=5).astype(np.uint8)
    path = tmp_path / "tex.png"
    path.write_bytes(_filtered_png(rgb, 8, 2))
    with_pil = image.load_image(str(path))
    monkeypatch.setitem(sys.modules, "PIL", None)
    monkeypatch.setitem(sys.modules, "PIL.Image", None)
    without = image.load_image(str(path))
    assert without.dtype == np.float32 and without.shape == (9, 14, 3)
    np.testing.assert_array_equal(without, with_pil)
    np.testing.assert_array_equal(without, rgb.astype(np.float32) / 255.0)
    jpg = tmp_path / "tex.jpg"
    jpg.write_bytes(b"not read")
    assert image.load_image(str(jpg)) is None  # Pillow's formats need it


def test_decode_png_refuses_bad_files(tmp_path, caplog):
    rgb = _smooth(6, 5, 3, 255, seed=7).astype(np.uint8)
    data = bytearray(image.encode_png(rgb))
    data[45] ^= 1  # a byte of the IDAT body: its CRC no longer holds
    with pytest.raises(ValueError, match="CRC"):
        image.decode_png(bytes(data))
    odd = _filtered_png(rgb, 8, 2, interlace=2)  # no such method
    with pytest.raises(ValueError, match="header"):
        image.decode_png(odd)
    path = tmp_path / "odd.png"
    path.write_bytes(odd)
    with caplog.at_level("WARNING"):
        assert image.load_image(str(path)) is None
    assert "header" in caplog.text
