"""One run of one cell, from BENCHMARK.json and the files it names.

`resolve` finds a cell's configuration and traffic files by name,
`metric_names` the metrics the cell reports (end to end with trace off,
per layer with trace on), and `run_cell` runs it: set-up, window, the
device peak, the profiled slice when traced, the comparison, and the
metrics, each read by its reader in `portbench/metrics/`.
"""
from __future__ import annotations

import json
import time
from pathlib import Path

from . import byname, cells, checks


def resolve(bench, root, name):
    """(cell, config entry, configuration, traffic) of cell `name`."""
    cell = next((w for w in bench["workloads"] if w["name"] == name), None)
    if cell is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
    with open(Path(root) / entry["file"]) as f:
        config = json.load(f)
    return cell, entry, config, byname.data("traffic", cell["traffic"])


def metric_names(bench, cell_name, trace):
    """The cell's metrics: with trace off its end-to-end metrics (those
    without `workloads` in every cell), with trace on the per-layer ones
    that list it under `workloads`."""
    if not trace:
        return [m["name"] for m in bench["end_to_end"]
                if cell_name in m.get("workloads", [cell_name])]
    return [m["name"] for m in bench["per_layer"]
            if cell_name in m["workloads"]]


def reader(name):
    """The `read(run)` of metric `name`: `metrics/<name>.py`, or, for a
    name with a dot, `metrics/<the part before the first dot>.py`, one
    file serving every cell's variant."""
    try:
        return byname.module("metrics", name).read
    except KeyError:
        if "." not in name:
            raise
        return byname.module("metrics", name.split(".", 1)[0]).read


def run_cell(torch, bench, root, name, seed, seconds, trace, device, t0,
             fault=None, resize=None):
    """Run cell `name` once -> (result dict without `checks`, compared
    numbers {name: (value, limit)}). For tests on the CPU: `fault` is
    called with the cell's kind object before set-up to break the timed
    path, and `resize` ({"config": {...}, "traffic": {...}}) shrinks the
    cell's sizes."""
    cell, entry, config, traffic = resolve(bench, root, name)
    if resize:
        config = {**config, **resize.get("config", {})}
        traffic = {**traffic, **resize.get("traffic", {})}
    kind = cells.load(traffic["kind"])(torch, cell, config, traffic, seed,
                                       device)
    cuda = device.type == "cuda"
    if fault is not None:
        fault(kind)
    kind.setup()
    kind.setup_s = time.perf_counter() - t0
    kind.begin_window()
    kind.run_window(seconds)
    kind.finish_window()
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    t_win = time.perf_counter()
    if trace:
        kind.profile()
    t_prof = time.perf_counter()
    lim = traffic["limits"]
    numbers = {k: (v, lim[k]) for k, v in kind.compare().items()}
    t_check = time.perf_counter()
    metrics = {}
    for m in metric_names(bench, name, trace):
        value = reader(m)(kind)
        if value is not None:
            unit = next(x["unit"] for x in bench["end_to_end"]
                        + bench["per_layer"] if x["name"] == m)
            metrics[m] = {"value": value, "unit": unit}
    result = {"correct": checks.judge(numbers),
              "attempted": kind.attempted, "failed": 0, "metrics": metrics}
    if cuda:
        from .common import device_line

        result["device"] = device_line(torch, 1, peak)
    else:
        result["device"] = {"platform": "cpu", "kind": "cpu", "count": 1,
                            "memory_peak_bytes": 0}
    if trace and kind.slice is not None:
        result["device"]["busy_s"] = kind.slice["busy_s"]
        result["device"]["window_s"] = kind.slice["window_s"]
        result["breakdown"] = {"device_ops": kind.slice["device_ops"],
                               "idle_gaps": kind.slice["idle_gaps"]}
    result["window"] = {"requests": kind.attempted,
                        "seconds": kind.window["seconds"],
                        "walls": kind.window["walls"],
                        "setup_s": kind.setup_s,
                        "profile_s": t_prof - t_win,
                        "check_s": t_check - t_prof,
                        "slice_kernels": (len(kind.slice["kernels"])
                                          if kind.slice else None),
                        "slice_read_s": (kind.slice["read_s"]
                                         if kind.slice else None),
                        "slice_untraced_s": (kind.slice["untraced_s"]
                                             if kind.slice else None)}
    return result, numbers
