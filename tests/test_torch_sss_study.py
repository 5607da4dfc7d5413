"""scripts/torch_sss_truncation_study.py, the port's SSS truncation study,
at a tiny size on the CPU: its table has a row for each radius scale and
k_volume (3 x 4) plus the auto_k_volume row, and its truncated fraction at
radius x 1, k_volume 3 is the JAX package's `measure_sss_truncation` on
the same scene within 0.01 absolute (both at a 32^2 probe, the script's
PROBE lowered from auto_k_volume's 96 to keep the test short), the band of
tests/test_torch_render_scan.py's probe test (the port traces through its
default dense route, JAX through its CPU BVH walk; a grazing lane may go
another way, ROADMAP C3)."""
import importlib.util
import os
import re

import numpy as np

from torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS, PROBE = 6, 32


def _script():
    spec = importlib.util.spec_from_file_location(
        "torch_sss_truncation_study",
        os.path.join(REPO, "scripts", "torch_sss_truncation_study.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_truncation_study_table(tmp_path, monkeypatch):
    from pbrlab_tpu.scene.demo import build_demo_scene
    from pbrlab_tpu.utils.profiling import measure_sss_truncation

    out = tmp_path / "sss_truncation_torch.md"
    script = _script()
    monkeypatch.setattr(script, "PROBE", PROBE)
    assert script.main(["--device", "cpu", "--res", "8", "--spp", "1",
                        "--steps", str(STEPS), "--out", str(out)]) == 0
    text = out.read_text()
    rows = re.findall(r"^\| ([^|]+) \| (\d+) \| ([\d.]+)% \| ([+-][\d.]+)%",
                      text, re.M)
    assert len(rows) == 3 * 4 + 1
    table = {(float(s), int(k)): float(t) / 100 for s, k, t, _ in rows[:-1]}
    assert sorted(table) == sorted((s, k) for s in script.RADIUS_SCALES
                                   for k in script.KS)
    assert "auto_k_volume" in rows[-1][0] and int(rows[-1][1]) >= 3
    assert "Device: CPU (no card)" in text and "The 8% rule" in text

    scene_np, _ = build_demo_scene(subdiv=2, with_monkey=False)
    want = measure_sss_truncation(scene_np, STEPS, k_volume=3, probe=PROBE)
    assert 0.0 < want < 1.0
    assert abs(table[(1.0, 3)] - want) <= 0.01, (table[(1.0, 3)], want)
    assert np.isfinite(list(table.values())).all()
