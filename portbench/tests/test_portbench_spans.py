"""`pbh/spans.py` on the CPU: each kind run at a tiny size, its window's
requests as the program's recorder kept them, and the new readers on
them. The window is exactly the requests the kind's `request()` made;
set-up's are the requests before the first; with the recorder off, or a
program without it, every reader gives None."""
import json
import time

import pytest
import torch

from pbh import cells, runner, spans

from conftest import ROOT

# BENCHMARK.json's cells and the held-out ones (`runner.with_held_out`)
BENCH = runner.with_held_out(json.loads((ROOT / "BENCHMARK.json").read_text()))
TINY = {
    "render": ("cornellbox.render",
               {"config": {"subdiv": 1},
                "traffic": {"width": 8, "height": 8, "spp": 2,
                            "check_pixels": 16}}),
    "preview": ("cornellbox.preview",
                {"config": {"subdiv": 1},
                 "traffic": {"width": 8, "height": 8, "check_pixels": 16,
                             "edit_every": 2}}),
    "grad": ("cornellbox.grad",
             {"config": {"subdiv": 1, "max_steps": 3},
              "traffic": {"width": 8, "height": 8, "ref_block": 64}}),
}
NEW = [m["name"] for m in BENCH["per_layer"]
       if m["source"].startswith("program_") and m["name"] != (
           "subiters_per_msample.render")]


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _run(kind, seconds):
    """Run the kind's cell -> (the kind object, the ids of the requests
    its window made, as the recorder named them)."""
    from pbrlab_tpu_torch.utils import profiling

    profiling.reset()
    cell, resize = TINY[kind]
    name = cells.load(kind).SPAN_REQUEST
    seen = {"made": []}

    def watch(k):
        request = k.request

        def counted():
            request()
            seen["made"].append([r for r in profiling.records()
                                 if r["name"] == name][-1]["id"])
        k.request = counted
        seen["kind"] = k
    runner.run_cell(torch, BENCH, ROOT, cell, 5, seconds, False,
                    torch.device("cpu"), time.perf_counter(), fault=watch,
                    resize=resize)
    return seen["kind"], seen["made"]


@pytest.mark.parametrize("kind", sorted(TINY))
def test_window_is_the_requests_the_kind_made(kind, monkeypatch):
    from pbrlab_tpu_torch.utils import profiling

    # the process's recorder comes back after the test's resets
    monkeypatch.setattr(profiling, "RECORDER", profiling.RECORDER)
    run, made = _run(kind, 0.5)
    assert run.attempted == len(made) >= 1
    setup, window = spans.split(run)
    assert [r["id"] for r in window] == made
    assert setup and max(r["id"] for r in setup) < made[0]
    name = type(run).SPAN_REQUEST
    # set-up's own requests of the kind: its warm-ups
    assert sum(r["name"] == name for r in setup) == run.setup_requests()
    cell = TINY[kind][0]
    for m in NEW:
        if cell in next(x["workloads"] for x in BENCH["per_layer"]
                        if x["name"] == m):
            value = runner.reader(m)(run)  # no device time on the CPU
            assert value is None or value >= 0
    if kind == "render":
        occ = runner.reader("lane_occupancy.render")(run)
        assert 0 < occ <= 100
        assert spans.counter(window, "subiters") == sum(run.iters)
    # the recorder off (PBRLAB_TRACE=0): nothing to read
    monkeypatch.setenv("PBRLAB_TRACE", "0")
    profiling.reset()
    assert spans.split(run) is None
    assert all(runner.reader(m)(run) is None for m in NEW)


def test_fused_share_over_the_windows_steps(monkeypatch):
    """step_fused_share: the window's fused steps over all its steps, summed
    over its requests (not a mean of per-request shares); None where
    neither counter counted (the CPU) or there is nothing to read."""
    window = [{"counters": {"launches.step.fused": 30}},
              {"counters": {"launches.step.fused": 10,
                            "launches.step.chain": 30}}]
    read = runner.reader("step_fused_share.render")
    assert read is runner.reader("step_fused_share.preview")
    monkeypatch.setattr(spans, "split", lambda run: ([], window))
    assert read(None) == pytest.approx(100.0 * 40 / 70)
    monkeypatch.setattr(spans, "split", lambda run: ([], [{"counters": {}}]))
    assert read(None) is None
    monkeypatch.setattr(spans, "split", lambda run: None)
    assert read(None) is None


def test_kind_without_a_request_name_has_no_spans():
    """A kind that names no program request is read by no span metric."""
    class Bare(cells.Kind):
        pass

    run = Bare.__new__(Bare)
    run.attempted = 1
    assert Bare.SPAN_REQUEST is None and spans.split(run) is None
