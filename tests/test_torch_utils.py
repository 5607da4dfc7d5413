"""The port's profiling and logging utilities, case for case as
tests/test_utils.py (occupancy monotone, occupancy positive, the
logger's JSON fields; its RaysMeter is not ported: the port's recorder,
tests/test_torch_tracing.py, counts a render's live lanes), plus `ray_units` against the JAX package's on
the lambert scene (subdiv 2, 16x16, 6 steps; measured equal on every
step, band 1e-6: JAX traces its CPU BVH walk, the port dense_v4's twin,
which can move a tied or grazing lane), the profiler trace, and
`write_exr` logging its failure and returning False."""
import io
import json
import logging
import os

import numpy as np
import pytest

from pbrlab_tpu_torch.scene.demo import build_demo_scene
from pbrlab_tpu_torch.scene.scene import scene_to_device
from torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def lambert_np():
    return build_demo_scene(subdiv=2, lambert_only=True)[0]


def test_step_occupancy_monotone(lambert_np):
    """Occupancy starts at 1, stays in [0, 1] and decays as paths die."""
    from pbrlab_tpu_torch.utils.profiling import step_occupancy

    fracs = step_occupancy(scene_to_device(lambert_np, "cpu"), 16, 16,
                           max_steps=6).numpy()
    assert fracs.shape == (6,)
    assert fracs[0] == 1.0
    assert (fracs <= 1.0).all() and (fracs >= 0.0).all()
    assert (np.diff(fracs) <= 0).all()
    assert fracs[-1] < 1.0


def test_ray_units_match_jax():
    from pbrlab_tpu.scene.demo import build_demo_scene as jbuild_demo_scene
    from pbrlab_tpu.scene.scene import scene_to_device as jscene_to_device
    from pbrlab_tpu.utils.profiling import ray_units as jray_units
    from pbrlab_tpu_torch.utils.profiling import ray_units

    jscene_np = jbuild_demo_scene(subdiv=2, lambert_only=True)[0]
    want = np.asarray(jray_units(jscene_to_device(jscene_np), 16, 16, 6))
    got = ray_units(scene_to_device(jscene_np, "cpu"), 16, 16, 6).numpy()
    assert got.shape == want.shape == (6,)
    assert got[0] == 2.0
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_measure_occupancy_positive():
    from pbrlab_tpu_torch.utils.profiling import measure_occupancy

    scene_np, _ = build_demo_scene(subdiv=1)
    s = measure_occupancy(scene_np, max_steps=4, probe=16, device="cpu")
    # closest + shadow (x2): step 0 alone contributes 2; the cap is 2 per
    # step plus the k_volume substeps (0 here)
    assert 2.0 <= s <= 8.0
    s3 = measure_occupancy(scene_np, max_steps=4, probe=16, k_volume=2,
                           device="cpu")
    assert s3 >= s  # substep rays only add


def test_logger_json_fields():
    from pbrlab_tpu_torch.utils import log as plog

    logger = plog.get_logger("test")
    logger.setLevel(logging.INFO)
    buf = io.StringIO()
    h = logging.StreamHandler(buf)
    h.setFormatter(plog._JsonFormatter())
    root = logging.getLogger("pbrlab_tpu_torch")
    root.addHandler(h)
    try:
        plog.event(logger, "pass done", pass_id=3, mrays=1.5)
        plog.event(logger, "budget", level="warning", k_volume=12)
    finally:
        root.removeHandler(h)
    recs = [json.loads(line) for line in buf.getvalue().splitlines()]
    assert recs[0]["pass_id"] == 3 and recs[0]["mrays"] == 1.5
    assert recs[0]["level"] == "info"
    assert recs[0]["name"] == "pbrlab_tpu_torch.test"
    assert recs[1]["level"] == "warning" and recs[1]["k_volume"] == 12


def test_trace_writes_chrome_trace(tmp_path, lambert_np):
    from pbrlab_tpu_torch.utils.profiling import step_occupancy, trace

    scene = scene_to_device(lambert_np, "cpu")
    with trace(str(tmp_path)):
        step_occupancy(scene, 4, 4, max_steps=1)
    with open(os.path.join(tmp_path, "trace.json")) as f:
        assert json.load(f)["traceEvents"]


def test_write_exr_reports_failure(tmp_path):
    from pbrlab_tpu_torch.io.image import write_exr

    buf = io.StringIO()
    h = logging.StreamHandler(buf)
    logger = logging.getLogger("pbrlab_tpu_torch.io")
    logger.addHandler(h)
    try:
        path = str(tmp_path / "missing_dir" / "img.exr")
        assert write_exr(path, np.zeros((2, 2, 3), np.float32)) is False
    finally:
        logger.removeHandler(h)
    assert "write_exr failed" in buf.getvalue()
