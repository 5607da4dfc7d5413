"""The port's preview server and CLI, case for case as tests/test_viewer.py
(the HTTP edit cycle, the material listing of a loaded scene), plus:
`build_scene_from_files` equal to the JAX package's array for array on an
OBJ and on a CyHair file the test writes; the CLI's `demo` on the CPU
writing a PNG; `scene_to_device` raising without a CUDA device; and the
standard-library PNG encoder decoded by Pillow to the pixels Pillow wrote
from the same array."""
import io
import json
import struct
import urllib.request

import numpy as np
import pytest
import torch

from pbrlab_tpu_torch.app.viewer import PreviewServer
from pbrlab_tpu_torch.render.progressive import ProgressiveRenderer
from pbrlab_tpu_torch.scene.demo import build_demo_scene
from pbrlab_tpu_torch.scene.scene import scene_to_device
from torch_threads import one_torch_thread  # noqa: F401

OMITTED = ("bvh_", "cbvh_")  # JAX-only tables (its CPU BVH walks)
PNG_SIG = b"\x89PNG\r\n\x1a\n"
OBJ = """mtllib two.mtl
o floor
v -1 0 -1
v 1 0 -1
v 1 0 1
v -1 0 1
usemtl MatA
f 1 2 3
usemtl MatB
f 1 3 4
o light_quad
v -0.3 1.5 -0.3
v 0.3 1.5 -0.3
v 0.3 1.5 0.3
v -0.3 1.5 0.3
usemtl MatA
f 5 8 7
f 5 7 6
"""
MTL = "newmtl MatA\nKd 0.8 0.2 0.2\nnewmtl MatB\nKd 0.2 0.8 0.2\n"


def _write_obj(tmp_path):
    (tmp_path / "two.mtl").write_text(MTL)
    path = tmp_path / "two_mats.obj"
    path.write_text(OBJ)
    return str(path)


def _write_cyhair(path):
    """Three strands of 5, 4 and 3 points with per-point thickness."""
    g = np.random.default_rng(3)
    counts = (5, 4, 3)
    pts = sum(counts)
    header = b"HAIR" + struct.pack("<IIIIff", len(counts), pts,
                                   0x1 | 0x2 | 0x4, 3, 0.01, 1.0)
    header += struct.pack("<fff", 0.5, 0.5, 0.5)
    header += b"\0" * (128 - len(header))
    with open(path, "wb") as f:
        f.write(header)
        f.write(struct.pack("<HHH", *(c - 1 for c in counts)))
        f.write(g.random((pts, 3)).astype(np.float32).tobytes())
        f.write(g.uniform(0.01, 0.03, pts).astype(np.float32).tobytes())
    return path


def _assert_equal(got, want, path=""):
    keys = {k for k in want if not k.startswith(OMITTED)}
    assert set(got) == keys, (path, set(got) ^ keys)
    for k in keys:
        if isinstance(want[k], dict):
            _assert_equal(got[k], want[k], f"{path}{k}.")
            continue
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.dtype == w.dtype, f"{path}{k}"
        np.testing.assert_array_equal(g, w, err_msg=f"{path}{k}")


def test_preview_server_edit_cycle():
    scene_np, builder = build_demo_scene(subdiv=1)
    r = ProgressiveRenderer(scene_to_device(scene_np, "cpu"), 16, 16,
                            material_names=builder.materials.names,
                            max_steps=4)
    srv = PreviewServer(r, max_pass=4)
    port = srv.start(port=0)
    base = f"http://127.0.0.1:{port}"
    try:
        r.step()
        status = json.loads(urllib.request.urlopen(
            base + "/status", timeout=10).read())
        assert status["pass"] == 1
        mats = json.loads(urllib.request.urlopen(
            base + "/materials", timeout=10).read())
        assert "Monkey" in mats and "base_color" in mats["Monkey"]
        png = urllib.request.urlopen(base + "/image.png", timeout=10).read()
        assert png[:8] == PNG_SIG
        page = urllib.request.urlopen(base + "/", timeout=10).read()
        assert b"/materials" in page

        req = urllib.request.Request(
            base + "/edit",
            data=json.dumps({"material": "Monkey", "param": "roughness",
                             "value": 0.77}).encode(), method="POST")
        urllib.request.urlopen(req, timeout=10).read()
        r.step()  # edit applied between passes; resets accumulation
        assert r.num_passes == 1
        got = float(r.scene["materials"]["roughness"][
            builder.materials.names.index("Monkey")])
        assert abs(got - 0.77) < 1e-6

        req = urllib.request.Request(
            base + "/replace",
            data=json.dumps({"material": "Monkey", "kind": 1}).encode(),
            method="POST")
        urllib.request.urlopen(req, timeout=10).read()
        r.step()
        assert r.num_passes == 1
        assert int(r.scene["materials"]["kind"][
            builder.materials.names.index("Monkey")]) == 1

        urllib.request.urlopen(urllib.request.Request(
            base + "/rerender", method="POST"), timeout=10).read()
        assert r.num_passes == 0
    finally:
        srv.stop()


def test_serve_lists_materials_for_loaded_scenes(tmp_path):
    from pbrlab_tpu_torch.app.cli import build_scene_from_files

    scene_np, names = build_scene_from_files([_write_obj(tmp_path)],
                                             return_names=True)
    assert set(names) >= {"MatA", "MatB"}
    r = ProgressiveRenderer(scene_to_device(scene_np, "cpu"), 8, 8,
                            material_names=names)
    srv = PreviewServer(r, max_pass=1)
    assert {"MatA", "MatB"} <= set(srv.materials_dict())


@pytest.mark.parametrize("kind", ["obj", "hair"])
def test_build_scene_from_files_matches_jax(tmp_path, kind):
    from pbrlab_tpu.app.cli import build_scene_from_files as jbuild
    from pbrlab_tpu_torch.app.cli import build_scene_from_files

    if kind == "obj":
        paths = [_write_obj(tmp_path)]
    else:
        paths = [_write_cyhair(str(tmp_path / "three.hair"))]
    got, got_names = build_scene_from_files(paths, return_names=True)
    want, want_names = jbuild(paths, return_names=True)
    assert got_names == want_names
    _assert_equal(got, want)
    if kind == "obj":
        assert got["emissive_faces"].shape[0] == 2  # the light_ mesh
    else:
        assert got["curve_pts"].shape[0] > 0


def test_cli_demo_writes_png(tmp_path):
    from pbrlab_tpu_torch.app import cli

    out = tmp_path / "demo.png"
    assert cli.main(["demo", "--width", "8", "--height", "8", "--spp", "2",
                     "--max-steps", "4", "--k-volume", "2", "--device",
                     "cpu", "--out", str(out)]) == 0
    data = out.read_bytes()
    assert data[:8] == PNG_SIG
    assert struct.unpack(">II", data[16:24]) == (8, 8)  # IHDR width, height
    from PIL import Image

    img = np.asarray(Image.open(io.BytesIO(data)))
    assert img.shape == (8, 8, 3) and img.max() > img.min()


def test_scene_to_device_needs_cuda(monkeypatch):
    scene_np, _ = build_demo_scene(subdiv=1, lambert_only=True)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        scene_to_device(scene_np)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        scene_to_device(scene_np, "cuda")
    assert scene_to_device(scene_np, "cpu")["tri_v0"].device.type == "cpu"


@pytest.mark.parametrize("shape", [(1, 1), (9, 13), (64, 37)])
def test_encode_png_matches_pillow(shape):
    """The encoder's bytes decode (Pillow) to the pixels Pillow itself
    wrote from the same array."""
    from PIL import Image

    from pbrlab_tpu_torch.io.image import encode_png

    rng = np.random.default_rng(sum(shape))
    img8 = rng.integers(0, 256, shape + (3,), dtype=np.uint8)
    buf = io.BytesIO()
    Image.fromarray(img8).save(buf, "PNG")  # the former writer
    ours = Image.open(io.BytesIO(encode_png(img8)))
    assert ours.mode == "RGB"
    np.testing.assert_array_equal(np.asarray(ours),
                                  np.asarray(Image.open(buf)))
    with pytest.raises(ValueError):
        encode_png(img8.astype(np.float32))


def test_write_png_pixels_match_pillow(tmp_path):
    """write_png keeps the reference's x256, clamp-to-255 quantisation."""
    from PIL import Image

    from pbrlab_tpu_torch.io.image import write_png

    lin = np.random.default_rng(5).random((11, 7, 3)).astype(np.float32) * 1.2
    path = str(tmp_path / "img.png")
    write_png(path, lin)
    q = np.clip(lin * 256.0, 0.0, 255.0).astype(np.uint8)
    np.testing.assert_array_equal(np.asarray(Image.open(path)), q)
