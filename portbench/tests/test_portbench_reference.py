"""The comparison that decides `correct`, at tiny sizes on the CPU: the
program (its kernels' plain versions) against the plain reference, the
precision control (the reference in bfloat16 in the program's place),
and a run with the timed path broken underneath, once for each fault a
cell can have; and the cells' runs on a card (requires_cuda)."""
import json
import time

import pytest
import torch

import control
from pbh import checks, faults, runner

from conftest import ROOT

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
TINY = {
    "cornellbox.render": {"config": {"subdiv": 1},
                          "traffic": {"width": 12, "height": 12, "spp": 2,
                                      "check_pixels": 48}},
    "xl.render": {"config": {"subdiv": 1, "irregular": True},
                  "traffic": {"width": 12, "height": 12, "spp": 2,
                              "check_pixels": 48}},
    "cornellbox.preview": {"config": {"subdiv": 1},
                           "traffic": {"width": 12, "height": 12,
                                       "check_pixels": 48, "edit_every": 3}},
    "cornellbox.grad": {"config": {"subdiv": 1},
                        "traffic": {"width": 12, "height": 12,
                                    "ref_block": 64}},
}
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def run(cell, seed=11, fault=None, seconds=0.0):
    return runner.run_cell(torch, BENCH, ROOT, cell, seed, seconds, False,
                           torch.device("cpu"), time.perf_counter(),
                           fault=fault, resize=TINY[cell])


@pytest.mark.parametrize("cell", CELLS)
def test_program_matches_reference(cell):
    res, numbers = run(cell, seed=2 ** 31 + 5)
    assert res["correct"], numbers
    for value, limit in numbers.values():
        assert value <= limit


@pytest.mark.parametrize("cell", CELLS)
def test_precision_control_fails(cell):
    """The reference computed in bfloat16 in the program's place reads over
    the cell's limits."""
    out = control.readings(torch, BENCH, cell, [7], {7}, torch.device("cpu"),
                           resize=TINY[cell], log=lambda s: None)
    (_, low), = out["control"]
    limits = runner.resolve(BENCH, ROOT, cell)[3]["limits"]
    assert not checks.judge({k: (low[k], limits[k]) for k in limits}), low


@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
@pytest.mark.parametrize("cell", CELLS)
def test_broken_timed_path_is_not_correct(cell, fault, monkeypatch):
    """Each fault a one-chip cell can have (a step that returns its state
    unchanged; half the work left out, the mean over the rest; an answer
    altered where it is produced) makes `correct` false."""
    res, numbers = run(cell, fault=lambda kind: faults.FAULTS[fault](
        kind, monkeypatch.setattr))
    assert not res["correct"], numbers


@pytest.mark.requires_cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_the_card(cell, cuda_device):
    """Each cell at a reduced size on the card: the kernels' answers
    against the reference."""
    sizes = {"render": {"width": 64, "height": 64, "check_pixels": 512},
             "preview": {"width": 64, "height": 64, "check_pixels": 512},
             "grad": {"width": 64, "height": 64, "ref_block": 4096}}
    traffic = runner.resolve(BENCH, ROOT, cell)[3]
    res, numbers = runner.run_cell(
        torch, BENCH, ROOT, cell, 3, 1.0, False, cuda_device,
        time.perf_counter(), resize={"traffic": sizes[traffic["kind"]]})
    assert res["correct"], numbers
