"""BENCHMARK.json against the benchmark's contract, and the harness's
lookup of cells, configurations, traffic mixes and metrics by name."""
import json
import re
import shutil
import subprocess
import sys

import pytest

from pbh import cells, runner, scenes

from conftest import HERE, ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_names_units_and_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("portbench/")
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
    names = set()
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert m["name"] not in names
        names.add(m["name"])
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    cells_named = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        # every per-layer metric lists the cells whose run reads it
        assert m["workloads"] and set(m["workloads"]) <= cells_named
    assert "setup_s" in e2e


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_resolves_to_its_files(cell):
    """Every cell finds its configuration and traffic files, and every
    metric it reports has a reader."""
    w, entry, config, traffic = runner.resolve(BENCH, ROOT, cell)
    assert config["max_steps"] > 0 and set(traffic["limits"])
    assert callable(scenes.load(config["scene"]).make_scene)
    assert issubclass(cells.load(traffic["kind"]), cells.Kind)
    for trace in (False, True):
        names = runner.metric_names(BENCH, cell, trace)
        assert names
        for m in names:
            assert callable(runner.reader(m))
    assert "setup_s" in runner.metric_names(BENCH, cell, False)


def test_unknown_scene_kind_or_mix_raises():
    """A name with no file behind it is refused, not served by another
    file: a configuration naming a scene that is not there renders no
    cornellbox in its place."""
    for load in (scenes.load, cells.load):
        with pytest.raises(KeyError):
            load("hair")
        with pytest.raises(ValueError):
            load("../pbh/cells")
    cell = next(w for w in BENCH["workloads"] if w["traffic"])
    bench = json.loads(json.dumps(BENCH))
    next(w for w in bench["workloads"] if w["name"] == cell["name"])[
        "traffic"] = "no_such_mix"
    with pytest.raises(KeyError):
        runner.resolve(bench, ROOT, cell["name"])
    import torch

    config = {**runner.resolve(BENCH, ROOT, cell["name"])[2],
              "scene": "hair"}
    with pytest.raises(KeyError):
        cells.load("render")(torch, cell, config, {}, 1, torch.device("cpu"))


SCENE = '''"""box: the cornellbox's walls and light around one diffuse sphere."""
from pbh.meshes import RawScene, icosphere, quad


def make_scene(config):
    materials = [("White", dict(base_color=(0.7, 0.7, 0.7), specular=0.0)),
                 ("Light", dict(base_color=(0.0, 0.0, 0.0), specular=0.0)),
                 ("Ball", dict(base_color=(0.2, 0.4, 0.8), specular=0.0))]
    meshes = [
        quad("floor", [-1, 0, -1], [-1, 0, 1], [1, 0, 1], [1, 0, -1], 0),
        quad("back", [-1, 0, -1], [1, 0, -1], [1, 2, -1], [-1, 2, -1], 0),
        quad("light", [-.4, 1.98, -.4], [.4, 1.98, -.4], [.4, 1.98, .4],
             [-.4, 1.98, .4], 1, emission=(4.0, 4.0, 4.0)),
        icosphere("ball", int(config["subdiv"]), 0.4, (0, 0.5, 0), 2),
    ]
    return RawScene(meshes, materials)
'''

KIND = '''"""stills: the render kind, every request at the window's first seed."""
from pbh import byname


class Stills(byname.module("kinds", "render").KIND):

    def request(self):
        self.seeds[self.attempted] = self.seeds[0]
        super().request()


KIND = Stills
'''


def test_added_cell_config_and_metric_need_no_edit(tmp_path):
    """A cell, a configuration, a scene, a traffic kind, a traffic mix and
    a per-layer metric added as new files and new entries are run and
    read, in a copy of the benchmark, with no file of it edited."""
    bench_dir = tmp_path / "portbench"
    shutil.copytree(HERE, bench_dir, ignore=shutil.ignore_patterns(
        "tests", "__pycache__"))
    before = {p.relative_to(bench_dir): p.read_bytes()
              for p in bench_dir.rglob("*") if p.is_file()}
    (bench_dir / "scenes" / "box.py").write_text(SCENE)
    (bench_dir / "kinds" / "stills.py").write_text(KIND)
    (bench_dir / "configs" / "tiny.json").write_text(json.dumps(
        {"scene": "box", "subdiv": 1, "max_steps": 4, "k_volume": 1}))
    (bench_dir / "traffic" / "stills_tiny.json").write_text(json.dumps(
        {"kind": "stills", "width": 8, "height": 8, "spp": 1, "warmup": 1,
         "check_pixels": 16, "slice": {"width": 8, "height": 8, "spp": 1},
         "limits": {"pixel_l1": 1e-3, "mean_bias": 1e-3}}))
    (bench_dir / "metrics" / "renders_done.tiny.py").write_text(
        '"""renders_done.tiny: renders in the window."""\n\n\n'
        "def read(run):\n    return float(run.window['requests'])\n")
    bench = json.loads(json.dumps(BENCH))
    bench["configs"].append({"name": "tiny", "source": "test",
                             "file": "portbench/configs/tiny.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "tiny.stills", "config": "tiny",
                               "traffic": "stills_tiny", "chips": 1,
                               "why": "test"})
    next(m for m in bench["end_to_end"] if m["name"] == "samples_per_s")[
        "workloads"].append("tiny.stills")
    bench["per_layer"].append({"name": "renders_done.tiny", "unit": "1",
                               "better": "higher",
                               "source": "program_counter", "layer": "test",
                               "moves": "samples_per_s",
                               "workloads": ["tiny.stills"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    code = f"""
import json, sys, time
sys.path[:0] = [{str(bench_dir)!r}, {str(ROOT)!r}]
import torch
from pbh import runner
bench = json.load(open({str(tmp_path / 'BENCHMARK.json')!r}))
res, nums = runner.run_cell(torch, bench, {str(tmp_path)!r}, 'tiny.stills',
                            5, 0.3, False, torch.device('cpu'),
                            time.perf_counter())
traced = runner.metric_names(bench, 'tiny.stills', True)
done = runner.reader('renders_done.tiny')(
    type('Run', (), {{'window': {{'requests': res['attempted']}}}}))
from pbh import cells, scenes
kind = cells.load('stills')
print(json.dumps([res['correct'], sorted(res['metrics']), traced, done,
                  kind.__name__, len(scenes.load('box').make_scene(
                      {{'subdiv': 1}}).meshes), res['attempted']]))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-3000:]
    correct, metrics, traced, done, kind, meshes, attempted = json.loads(
        out.stdout.strip().splitlines()[-1])
    assert correct and metrics == ["samples_per_s", "setup_s"]
    assert "renders_done.tiny" in traced and done >= 1
    assert kind == "Stills" and meshes == 4 and attempted >= 1
    after = {p.relative_to(bench_dir): p.read_bytes()
             for p in bench_dir.rglob("*")
             if p.is_file() and "__pycache__" not in p.parts}
    assert {k: v for k, v in after.items() if k in before} == before
