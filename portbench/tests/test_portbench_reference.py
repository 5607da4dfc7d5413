"""The comparison that decides `correct`, at tiny sizes on the CPU: the
program (its kernels' plain versions) against the plain reference, the
precision control (the reference in bfloat16 in the program's place),
and a run with the timed path broken underneath, once for each fault a
cell can have; and the cells' runs on a card (requires_cuda). Each cell
runs at the sizes its scene's and its kind's files give for tests
(`runner.resize_for`), so a new cell needs no edit here."""
import json
import time

import pytest
import torch

import control
from pbh import checks, faults, runner

from conftest import ROOT

# BENCHMARK.json's cells and the held-out ones (`runner.with_held_out`)
BENCH = runner.with_held_out(json.loads((ROOT / "BENCHMARK.json").read_text()))
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
                           fault=fault,
                           resize=runner.resize_for(BENCH, ROOT, cell, "cpu"))


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
                           resize=runner.resize_for(BENCH, ROOT, cell, "cpu"),
                           log=lambda s: None)
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
    res, numbers = runner.run_cell(
        torch, BENCH, ROOT, cell, 3, 1.0, False, cuda_device,
        time.perf_counter(),
        resize=runner.resize_for(BENCH, ROOT, cell, "card"))
    assert res["correct"], numbers
