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
# and the cells held out of it while the program fails them
HELD = runner.with_held_out(BENCH)


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


def _entries_keep_the_contract(bench):
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("portbench/")
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
    names = set()
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert m["name"] not in names
        names.add(m["name"])
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in bench["end_to_end"]}
    cells_named = {w["name"] for w in bench["workloads"]}
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
        # every per-layer metric lists the cells whose run reads it
        assert m["workloads"] and set(m["workloads"]) <= cells_named
    assert "setup_s" in e2e


def test_names_units_and_keys():
    _entries_keep_the_contract(BENCH)


def test_held_out_entries_keep_the_contract():
    """The held-out cells' entries could go back into BENCHMARK.json as
    they are."""
    _entries_keep_the_contract(HELD)


@pytest.mark.parametrize("cell", [w["name"] for w in HELD["workloads"]])
def test_cell_resolves_to_its_files(cell):
    """Every cell finds its configuration and traffic files, and every
    metric it reports has a reader."""
    w, entry, config, traffic = runner.resolve(HELD, ROOT, cell)
    assert config["max_steps"] > 0 and set(traffic["limits"])
    assert callable(scenes.load(config["scene"]).make_scene)
    assert issubclass(cells.load(traffic["kind"]), cells.Kind)
    for trace in (False, True):
        names = runner.metric_names(HELD, cell, trace)
        assert names
        for m in names:
            assert callable(runner.reader(m))
    assert "setup_s" in runner.metric_names(HELD, cell, False)


def test_held_out_cells_stay_out_of_the_benchmark():
    """A held-out cell and its metrics are out of BENCHMARK.json, and
    `run.py` refuses the cell, printing no result."""
    import run

    held = [w["name"] for w in HELD["workloads"][len(BENCH["workloads"]):]]
    assert held and not set(held) & {w["name"] for w in BENCH["workloads"]}
    for m in HELD["end_to_end"] + HELD["per_layer"]:
        if m not in BENCH["end_to_end"] + BENCH["per_layer"]:
            assert set(m["workloads"]) <= set(held)
    for cell in held:
        assert run.main(["--workload", cell, "--seed", "1",
                         "--seconds", "1"]) == 2


def test_unknown_scene_kind_or_mix_raises():
    """A name with no file behind it is refused, not served by another
    file: a configuration naming a scene that is not there renders no
    cornellbox in its place."""
    for load, missing in ((scenes.load, "no_such_scene"),
                          (cells.load, "no_such_kind")):
        with pytest.raises(KeyError):
            load(missing)
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
              "scene": "no_such_scene"}
    with pytest.raises(KeyError):
        cells.load("render")(torch, cell, config, {}, 1, torch.device("cpu"))


# each cell's test sizes, as its scene and kind files give them
TEST_SIZES = {
    "cornellbox.render": ({"subdiv": 1},
                          {"width": 12, "height": 12, "spp": 2,
                           "check_pixels": 48}),
    "xl.render": ({"subdiv": 1, "irregular": True},
                  {"width": 12, "height": 12, "spp": 2, "check_pixels": 48}),
    "cornellbox.preview": ({"subdiv": 1},
                           {"width": 12, "height": 12, "check_pixels": 48,
                            "edit_every": 3}),
    "cornellbox.grad": ({"subdiv": 1},
                        {"width": 12, "height": 12, "ref_block": 64}),
}
CARD_SIZES = {"render": {"width": 64, "height": 64, "check_pixels": 512},
              "preview": {"width": 64, "height": 64, "check_pixels": 512},
              "grad": {"width": 64, "height": 64, "ref_block": 4096}}


@pytest.mark.parametrize("cell", sorted(TEST_SIZES))
def test_resize_for_gives_each_cells_test_sizes(cell):
    """`runner.resize_for` builds a cell's test sizes from its scene's
    `TINY_CONFIG` and its kind's `TINY_TRAFFIC` / `CARD_TRAFFIC`: the
    sizes these cells' tests ran at when they were keyed by cell name."""
    _, _, config, traffic = runner.resolve(HELD, ROOT, cell)
    tiny = runner.resize_for(HELD, ROOT, cell, "cpu")
    want_config, want_traffic = TEST_SIZES[cell]
    assert {**config, **tiny["config"]} == {**config, **want_config}
    assert tiny["traffic"] == want_traffic
    assert runner.resize_for(HELD, ROOT, cell, "card") == {
        "traffic": CARD_SIZES[traffic["kind"]]}


def test_kind_without_test_sizes_names_itself(monkeypatch):
    """A kind that gives no test sizes fails naming the kind and what it
    lacks."""
    class Bare(cells.Kind):
        pass

    monkeypatch.setattr(cells, "load", lambda name: Bare)
    for where, attr in (("cpu", "TINY_TRAFFIC"), ("card", "CARD_TRAFFIC")):
        with pytest.raises(AttributeError,
                           match=rf"'render' \(Bare\) gives no {attr}"):
            runner.resize_for(BENCH, ROOT, "cornellbox.render", where)


SCENE = '''"""box: the cornellbox's walls and light around one diffuse sphere."""
from pbh.meshes import RawScene, icosphere, quad

TINY_CONFIG = {"subdiv": 0}


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
    read, in a copy of the benchmark, with no file of it edited. The
    cell's test sizes come from its own files (the scene's `TINY_CONFIG`,
    the kind's `TINY_TRAFFIC`, inherited from render), it matches the
    reference at them, and `spans.split` finds its window by the request
    name its kind inherits."""
    bench_dir = tmp_path / "portbench"
    shutil.copytree(HERE, bench_dir, ignore=shutil.ignore_patterns(
        "tests", "__pycache__"))
    before = {p.relative_to(bench_dir): p.read_bytes()
              for p in bench_dir.rglob("*") if p.is_file()}
    (bench_dir / "scenes" / "box.py").write_text(SCENE)
    (bench_dir / "kinds" / "stills.py").write_text(KIND)
    (bench_dir / "configs" / "tiny.json").write_text(json.dumps(
        {"scene": "box", "subdiv": 2, "max_steps": 4, "k_volume": 1}))
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
from pbh import spans
resize = runner.resize_for(bench, {str(tmp_path)!r}, 'tiny.stills', 'cpu')
kinds = []
tiny, tiny_nums = runner.run_cell(
    torch, bench, {str(tmp_path)!r}, 'tiny.stills', 7, 0.3, False,
    torch.device('cpu'), time.perf_counter(), fault=kinds.append,
    resize=resize)
got = spans.split(kinds[0])
sizes = [resize, tiny['correct'], tiny_nums, tiny['attempted'],
         None if got is None else len(got[1]),
         [kinds[0].w, kinds[0].h, kinds[0].spp, len(kinds[0].pixels),
          len(kinds[0].raw.meshes[-1].faces)]]
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
                      {{'subdiv': 1}}).meshes), res['attempted'], sizes]))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-3000:]
    correct, metrics, traced, done, kind, meshes, attempted, sizes = \
        json.loads(out.stdout.strip().splitlines()[-1])
    assert correct and metrics == ["samples_per_s", "setup_s"]
    assert "renders_done.tiny" in traced and done >= 1
    assert kind == "Stills" and meshes == 4 and attempted >= 1
    resize, tiny_correct, tiny_nums, tiny_attempted, window, shape = sizes
    # the scene's own TINY_CONFIG, the render kind's TINY_TRAFFIC
    assert resize == {"config": {"subdiv": 0},
                      "traffic": cells.load("render").TINY_TRAFFIC}
    assert shape == [12, 12, 2, 48, 20]  # subdiv 0: the icosahedron
    assert tiny_correct, tiny_nums
    assert window == tiny_attempted >= 1
    after = {p.relative_to(bench_dir): p.read_bytes()
             for p in bench_dir.rglob("*")
             if p.is_file() and "__pycache__" not in p.parts}
    assert {k: v for k, v in after.items() if k in before} == before
