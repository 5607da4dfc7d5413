"""The port's progressive renderer, case for case as
tests/test_progressive.py: accumulation, an edit resets the passes and
changes the image, cancel, the checkpoint round trip, the texture path,
the whole-material type switch against a freshly built scene (bit-equal),
and a SIGKILL mid-run resumed from the checkpoint in a fresh process
(bit-equal to an uninterrupted run; tests/torch_preemption_worker.py,
which imports only the port). Also: a pass is `render_sample` of its
pass number, and the average of n passes is `render_scan(spp=n)`, both to
the bit (float32 sums in the same order on host and device)."""
import os
import signal
import subprocess
import sys
import time

import numpy as np
import torch

from pbrlab_tpu_torch.render.integrator import (render, render_sample,
                                                render_scan)
from pbrlab_tpu_torch.render.progressive import ProgressiveRenderer
from pbrlab_tpu_torch.scene.demo import build_demo_scene, quad_mesh
from pbrlab_tpu_torch.scene.materials import ALL_COLUMNS, KIND_PRINCIPLED
from pbrlab_tpu_torch.scene.scene import SceneBuilder, commit, scene_to_device
from torch_threads import one_torch_thread  # noqa: F401

W = H = 16


def _renderer():
    scene_np, builder = build_demo_scene(subdiv=1, lambert_only=True)
    return ProgressiveRenderer(scene_to_device(scene_np, "cpu"), W, H,
                               material_names=builder.materials.names,
                               max_steps=6)


def test_progressive_accumulation_matches_passes():
    r = _renderer()
    imgs = [np.asarray(r.step()).copy() for _ in range(3)]
    assert r.num_passes == 3
    assert not np.array_equal(imgs[0], imgs[2])
    assert np.isfinite(imgs[2]).all()
    # pass i is render_sample(sample_id=i); the average is render_scan's
    np.testing.assert_array_equal(
        imgs[0], render_sample(r.scene, W, H, 0, max_steps=6).numpy())
    np.testing.assert_array_equal(
        imgs[2], render_scan(r.scene, W, H, 3, max_steps=6).numpy())


def test_edit_resets_and_changes_image():
    r = _renderer()
    scene0 = r.scene
    before = np.asarray(r.render_until(2)).copy()
    r.queue_edit("Wall_White", "base_color", (0.1, 0.9, 0.1))
    after1 = np.asarray(r.step())
    assert r.num_passes == 1  # edit triggered rerender
    assert not np.allclose(before, after1)
    i = r.material_names.index("Wall_White")
    np.testing.assert_array_equal(
        r.scene["materials"]["base_color"][i].numpy(),
        np.float32([0.1, 0.9, 0.1]))
    # the edit wrote a new column: the scene it started from is unchanged
    assert not torch.equal(scene0["materials"]["base_color"],
                           r.scene["materials"]["base_color"])


def test_cancel_callback():
    r = _renderer()
    calls = []

    def cancel():
        calls.append(1)
        return len(calls) > 2

    r.render_until(100, cancel=cancel)
    assert r.num_passes == 2


def test_checkpoint_roundtrip(tmp_path):
    r = _renderer()
    r.render_until(2)
    path = str(tmp_path / "ckpt.npz")
    r.save_checkpoint(path)
    assert set(np.load(path).files) == {
        "accum", "num_passes", "seed", "width", "height", "max_steps",
        "k_volume"}
    r2 = _renderer()
    r2.load_checkpoint(path)
    assert r2.num_passes == 2
    np.testing.assert_array_equal(r2.accum, r.accum)
    # resume continues deterministically: both render pass 2 next
    np.testing.assert_array_equal(np.asarray(r.step()),
                                  np.asarray(r2.step()))


def test_texture_fetch_path():
    """A textured floor must show the texture's colours."""
    b = SceneBuilder()
    tex = np.zeros((2, 2, 3), np.float32)  # 2x2 checker: red / blue
    tex[0, 0] = tex[1, 1] = (1.0, 0.0, 0.0)
    tex[0, 1] = tex[1, 0] = (0.0, 0.0, 1.0)
    tid = b.add_texture(tex, "checker")
    m = b.materials.add_principled("floor", specular=0.0,
                                   base_color_tex_id=tid)
    light_m = b.materials.add_principled("light", base_color=(0, 0, 0),
                                         specular=0.0)
    floor = quad_mesh([-1, 0, -1], [-1, 0, 1], [1, 0, 1], [1, 0, -1], m,
                      "floor")
    floor.texcoords = np.asarray([[0, 0], [0, 1], [1, 1], [1, 0]],
                                 np.float32)
    floor.texcoord_idx = floor.faces.copy()
    lightq = quad_mesh([-0.5, 2, -0.5], [0.5, 2, -0.5], [0.5, 2, 0.5],
                       [-0.5, 2, 0.5], light_m, "light")
    b.add_instance([floor])
    lid = b.add_area_light_param((6.0, 6.0, 6.0))
    b.add_instance([lightq], light_ids=[np.full((2,), lid, np.int32)])
    scene = scene_to_device(commit(b.build()), "cpu")
    img = render(scene, 24, 24, 8, max_steps=4).numpy()
    assert np.isfinite(img).all()
    flat = img.reshape(-1, 3)
    lit = flat[flat.sum(1) > 0.01]
    assert (lit[:, 0] > 2 * lit[:, 2]).any(), "no red texel visible"
    assert (lit[:, 2] > 2 * lit[:, 0]).any(), "no blue texel visible"


def test_preemption_kill_and_resume(tmp_path):
    """SIGKILL a progressive render after its second pass, resume from its
    checkpoint in a fresh process: the final image is bit-identical to an
    uninterrupted run."""
    worker = os.path.join(os.path.dirname(__file__),
                          "torch_preemption_worker.py")
    ckpt = str(tmp_path / "ck.npz")
    out_resumed = str(tmp_path / "resumed.npy")
    out_clean = str(tmp_path / "clean.npy")

    p = subprocess.Popen([sys.executable, worker, ckpt, "/dev/null", "4"],
                         stdout=subprocess.PIPE, text=True)
    try:
        deadline = time.time() + 300
        seen = 0
        while seen < 2 and time.time() < deadline:
            line = p.stdout.readline()
            if line.startswith("pass"):
                seen = int(line.split()[1])
        assert seen >= 2, "victim never reached pass 2"
    finally:
        p.send_signal(signal.SIGKILL)
        p.wait(timeout=60)
        p.stdout.close()

    rc = subprocess.run([sys.executable, worker, ckpt, out_resumed, "4",
                         "resume"], timeout=300).returncode
    assert rc == 0
    rc = subprocess.run([sys.executable, worker, str(tmp_path / "ck2.npz"),
                         out_clean, "4"], timeout=300).returncode
    assert rc == 0
    np.testing.assert_array_equal(np.load(out_resumed), np.load(out_clean))


def test_material_type_switch_matches_fresh_scene():
    """Switching the hair material to Principled mid-render renders
    exactly like a scene built with that material from the start."""
    def build():
        return build_demo_scene(subdiv=1, with_monkey=False,
                                with_lucy=False, with_hair=True)

    scene_np, b = build()
    r = ProgressiveRenderer(scene_to_device(scene_np, "cpu"), W, H,
                            material_names=b.materials.names, max_steps=5)
    base = np.asarray(r.step()).copy()
    params = {"base_color": (0.9, 0.1, 0.1), "specular": 0.0,
              "roughness": 0.6}
    r.queue_material_replace("hair", KIND_PRINCIPLED, params)
    switched = np.asarray(r.step())
    assert r.num_passes == 1  # replacement triggered rerender
    assert not np.allclose(base, switched)

    scene2_np, b2 = build()
    i = b2.materials.names.index("hair")
    mats = scene2_np["materials"]
    for k, d, _ in ALL_COLUMNS:  # the rest reset to the defaults
        mats[k][i] = params.get(k, d)
    mats["kind"][i] = KIND_PRINCIPLED
    mats["base_color_tex_id"][i] = -1
    mats["subsurface_color_tex_id"][i] = -1
    r2 = ProgressiveRenderer(scene_to_device(scene2_np, "cpu"), W, H,
                             material_names=b2.materials.names, max_steps=5)
    np.testing.assert_array_equal(switched, np.asarray(r2.step()))
