"""The port's lane slice, sharded render, train step and multi-process
render on the CPU (ports of tests/test_integrator.py:147-171,
tests/test_sharding.py, tests/test_gradients.py:182-205 and
tests/test_distributed.py:19-50).

Band: none. The port's image does not depend on the lane count: at
n_lanes 7, 32 and 100 the 24x24x3 render is the n_lanes = pixels one to
the bit (measured), where the JAX package allows 1e-5 (XLA fuses each
lane count's program differently). So a render sharded over 8 CPU
shards, whose per-shard lane counts set other volume windows, is
`render`'s image to the bit on the lambert scene and on the SSS demo at
k_volume 3, the case the JAX package fails (ROADMAP C1); and so is the
two-process gloo render.
"""
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from pbrlab_tpu_torch.parallel import distributed, sharding
from pbrlab_tpu_torch.render.integrator import render, render_lanes_wavefront
from pbrlab_tpu_torch.scene.demo import build_demo_scene
from pbrlab_tpu_torch.scene.scene import build_fat_tables, scene_from_numpy
from torch_scenes import textured_scene
from torch_threads import one_torch_thread  # noqa: F401

W = H = 16


@pytest.fixture(scope="module")
def small():
    """tests/test_integrator.py's small_scene with its fat tables."""
    return build_fat_tables(scene_from_numpy(
        build_demo_scene(subdiv=1, lambert_only=True)[0], "cpu"))


@pytest.fixture(scope="module")
def queue_ref(small):
    """24x24x3, max_steps 8, n_lanes = pixels (no claims)."""
    return render_lanes_wavefront(small, 24, 24, 3, max_steps=8).numpy()


@pytest.mark.parametrize("n_lanes", [7, 32, 100])
def test_work_queue_lane_count_invariance(small, queue_ref, n_lanes):
    """With fewer lanes than pixels, finished lanes claim later pixels;
    a pixel's samples stay in order on one lane, so the image is the
    same bits for any lane count."""
    got = render_lanes_wavefront(small, 24, 24, 3, max_steps=8,
                                 n_lanes=n_lanes).numpy()
    np.testing.assert_array_equal(got, queue_ref)


@pytest.mark.parametrize("n_lanes", [32, 65536])
def test_lane_slice_renders_its_rows(small, queue_ref, n_lanes):
    """`lane=` renders the given pixel ids (a contiguous slice, then the
    same pixels in another order) and returns their rows of the full
    render, with claims inside the slice (32 lanes) or none."""
    lane = torch.arange(100, 300, dtype=torch.int32)
    for ids in (lane, lane.flip(0)):
        got = render_lanes_wavefront(small, 24, 24, 3, max_steps=8,
                                     n_lanes=n_lanes, lane=ids).numpy()
        assert got.shape == (200, 3)
        np.testing.assert_array_equal(got, queue_ref[ids.numpy()])


@pytest.mark.parametrize("name", ["lambert", "sss"])
def test_sharded_matches_single_device(name):
    """tests/test_sharding.py:16-22 and :47-57 on make_mesh(8, "cpu"):
    the lambert scene at max_steps 6, and the SSS demo at max_steps 4,
    k_volume 3, where 32 lanes a shard give another volume window than
    the single render's 256."""
    if name == "lambert":
        kw, steps = dict(subdiv=2, lambert_only=True), dict(max_steps=6)
    else:
        kw, steps = dict(subdiv=2), dict(max_steps=4, k_volume=3)
    scene = scene_from_numpy(build_demo_scene(**kw)[0], "cpu")
    mesh = sharding.make_mesh(8, "cpu")
    assert mesh == [torch.device("cpu")] * 8
    a = render(scene, W, H, 2, **steps).numpy()
    b = sharding.render_sharded(scene, W, H, 2, mesh, **steps).numpy()
    assert a.mean() > 0.0
    np.testing.assert_array_equal(a, b)


def test_meshes_need_a_card_unless_cpu_is_asked():
    """No fallback: without a CUDA card the default meshes raise."""
    if torch.cuda.is_available():
        assert all(d.type == "cuda" for d in sharding.make_mesh())
        assert all(d.type == "cuda" for d in distributed.global_mesh())
        return
    with pytest.raises(RuntimeError):
        sharding.make_mesh()
    with pytest.raises(RuntimeError):
        sharding.make_mesh(2, "cuda")
    with pytest.raises(RuntimeError):
        distributed.global_mesh()
    assert distributed.global_mesh("cpu") == [torch.device("cpu")]


def test_train_step_runs_and_reduces():
    """tests/test_sharding.py:25-35: one step over 8 CPU shards towards a
    black target gives a finite loss and moves base_color; the input
    scene is not changed."""
    scene = scene_from_numpy(
        build_demo_scene(subdiv=2, lambert_only=True)[0], "cpu")
    base = scene["materials"]["base_color"].clone()
    step = sharding.train_step_builder(W, H, 1, sharding.make_mesh(8, "cpu"),
                                       max_steps=4)
    loss, new_scene = step(scene, torch.zeros((H, W, 3)))
    assert np.isfinite(float(loss)) and float(loss) > 0.0
    moved = (new_scene["materials"]["base_color"] - base).abs()
    assert float(moved.sum()) > 0.0
    assert torch.equal(scene["materials"]["base_color"], base)


def test_train_step_texel_target_converges():
    """tests/test_gradients.py:182-205: towards the render of the same
    scene with every texel halved, four steps over 2 CPU shards lower the
    loss by more than 10% and move the atlas."""
    scene = scene_from_numpy(textured_scene("pbrlab_tpu_torch"), "cpu")
    mesh = sharding.make_mesh(2, "cpu")
    w = h = 8
    dim = {**scene, "texture_atlas": scene["texture_atlas"] * 0.5}
    target = sharding.render_sharded(dim, w, h, 1, mesh, max_steps=4)
    step = sharding.train_step_builder(w, h, 1, mesh, max_steps=4, lr=0.2)
    s = scene
    losses = []
    for _ in range(4):
        loss, s = step(s, target)
        losses.append(float(loss))
    assert losses[-1] < losses[0] * 0.9, losses
    moved = (s["texture_atlas"] - scene["texture_atlas"]).abs().max()
    assert float(moved) > 1e-4


def test_init_distributed_without_coordinator(monkeypatch):
    """No coordinator, argument or PBRLAB_COORDINATOR: one process, no
    group joined."""
    monkeypatch.delenv("PBRLAB_COORDINATOR", raising=False)
    assert distributed.init_distributed() is False
    assert not torch.distributed.is_initialized()


def test_one_process_render_distributed(small):
    """Outside a process group the one rank renders every pixel."""
    scene_np = build_demo_scene(subdiv=1, lambert_only=True)[0]
    got = distributed.render_distributed(
        scene_np, 16, 16, 2, mesh=distributed.global_mesh("cpu"),
        max_steps=6)
    np.testing.assert_array_equal(got, render(small, 16, 16, 2,
                                              max_steps=6).numpy())


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_render_matches_single(tmp_path, small):
    """Two gloo processes on the CPU (tests/torch_distributed_worker.py),
    each rendering half the pixels; the gathered image is the single
    process's `render` to the bit."""
    out = tmp_path / "img.npy"
    port = _free_port()
    worker = os.path.join(os.path.dirname(__file__),
                          "torch_distributed_worker.py")
    procs = []
    for pid in range(2):
        env = dict(os.environ, PBRLAB_COORDINATOR=f"127.0.0.1:{port}",
                   PBRLAB_NUM_PROCESSES="2", PBRLAB_PROCESS_ID=str(pid))
        procs.append(subprocess.Popen(
            [sys.executable, worker, str(out)], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE))
    try:
        outs = [p.communicate(timeout=300) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err.decode(errors="replace")
    got = np.load(out)
    ref = render(small, 16, 16, 2, max_steps=6).numpy()
    assert got.shape == (16, 16, 3) and got.dtype == np.float32
    np.testing.assert_array_equal(got, ref)
