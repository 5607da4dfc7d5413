"""The profiled slice: one bounded piece of a cell's work under
`torch.profiler`, reduced to what the per-layer readers take.

A window holds millions of device kernels (a render's sub-iteration
launches ~12750 of them as graph nodes), more than a trace can hold, so
the traced run profiles a slice at the cell's own lane count and shapes
after its window. The profiler records device activity (kernels, copies,
sets, and the host's CUDA runtime calls) and, only where a reader needs
them (`host=True`), the host's operators too: recording every eager
operator slows the host several times over, and the slice's idle share
would then read the profiler's cost. The trace is written by the
profiler's own exporter into a temporary file (the run's TMPDIR), read
once and deleted.

`reduce_trace` keeps, from the trace's events:
- device events (kernels, copies, sets) with name, start, duration,
  grid and correlation id;
- the host's operator spans (name, thread, start, duration) and CUDA
  runtime calls (name, correlation id, thread, start, duration);
and gives busy time as the union of the device intervals, the slice's
window, the top device operations and the longest idle gaps, each named
by the innermost host span or runtime call open at its middle.
"""
from __future__ import annotations

import bisect
import json
import os
import re
import tempfile
import time
from collections import defaultdict

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "python_function")


def profile(torch, fn, host=False):
    """Run fn() once under the profiler -> (fn's result, reduced trace);
    with `host` the host's operators are recorded too."""
    from torch.profiler import ProfilerActivity, profile as tprofile

    torch.cuda.synchronize()
    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if host else [])
    with tprofile(activities=acts) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        window = time.perf_counter() - t0
    t1 = time.perf_counter()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    finally:
        os.remove(path)
    red = reduce_trace(events)
    red["window_s"] = window
    red["read_s"] = time.perf_counter() - t1
    return out, red


def _union(intervals):
    total, end = 0.0, None
    start = None
    for s, e in sorted(intervals):
        if end is None or s > end:
            if end is not None:
                total += end - start
            start, end = s, e
        else:
            end = max(end, e)
    if end is not None:
        total += end - start
    return total


def reduce_trace(events):
    """Trace events (chrome format, microseconds) -> dict of device
    kernels, busy seconds, top operations, idle gaps and the host spans
    the readers correlate with."""
    dev, host, runtime = [], [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        args = e.get("args") or {}
        if cat in DEVICE_CATS:
            dev.append({"name": e.get("name", ""), "ts": float(e["ts"]),
                        "dur": float(e.get("dur", 0.0)), "cat": cat,
                        "grid": args.get("grid"),
                        "corr": args.get("correlation")})
        elif cat in HOST_CATS:
            host.append({"name": e.get("name", ""), "ts": float(e["ts"]),
                         "dur": float(e.get("dur", 0.0)),
                         "tid": e.get("tid")})
        elif cat in ("cuda_runtime", "cuda_driver"):
            runtime.append({"ts": float(e["ts"]), "tid": e.get("tid"),
                            "dur": float(e.get("dur", 0.0)),
                            "corr": args.get("correlation"),
                            "name": e.get("name", "")})
    dev.sort(key=lambda d: d["ts"])
    busy_us = _union([(d["ts"], d["ts"] + d["dur"]) for d in dev])
    by_name = defaultdict(float)
    for d in dev:
        by_name[d["name"]] += d["dur"]
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    top = [(_short(n), us) for n, us in top]
    return {"kernels": [d for d in dev if d["cat"] == "kernel"],
            "device": dev, "host": host, "runtime": runtime,
            "busy_s": busy_us * 1e-6,
            "device_ops": [[n, us * 1e-6] for n, us in top],
            "idle_gaps": idle_gaps(dev, host + runtime)}


def _short(name):
    """A kernel's name for the breakdown: the function, and the last
    functor or operation its template names (ATen's elementwise kernels
    differ only there) or its template arguments."""
    n = re.sub(r"^void\s+", "", name.replace("(anonymous namespace)::", ""))
    base = re.split(r"[<(]", n, maxsplit=1)[0].strip()
    rest = n[len(base):]
    ops = re.findall(r"(\w+Functor\w*|\w+_functor|where_kernel_impl|"
                     r"launch_clamp_scalar|compare_scalar_kernel|Reduce\w+)",
                     rest)
    if ops:
        return f"{base} [{ops[-1]}]"
    if rest.startswith("<"):
        return base + rest[:rest.find(">") + 1]
    return base


def idle_gaps(dev, host, count=10):
    """The longest gaps between device events, each named by the
    innermost host span (an operator or a CUDA runtime call) open at the
    gap's middle, or, where none is, by the last one that ended before it
    ("host after <name>")."""
    gaps = []
    end = None
    for d in dev:
        if end is not None and d["ts"] > end:
            gaps.append((d["ts"] - end, 0.5 * (d["ts"] + end)))
        end = d["ts"] + d["dur"] if end is None else max(end,
                                                         d["ts"] + d["dur"])
    gaps.sort(reverse=True)
    spans = sorted(host, key=lambda h: h["ts"])
    starts = [h["ts"] for h in spans]
    out = []
    for length, at in gaps[:count]:
        name, best, ended = None, None, None
        for h in spans[:bisect.bisect_right(starts, at)]:
            end = h["ts"] + h["dur"]
            if end >= at:
                if best is None or h["dur"] < best:
                    name, best = h["name"], h["dur"]
            elif ended is None or end > ended[0]:
                ended = (end, h["name"])
        if name is None:
            name = f"host after {ended[1]}" if ended else "host idle"
        out.append([name, length * 1e-6])
    return out


def busy_within(red, span_name):
    """Device seconds of the kernels launched from inside host spans
    whose name contains `span_name` (by thread, time and the runtime
    call's correlation id), as a union of intervals."""
    spans = [h for h in red["host"] if span_name in h["name"]]
    if not spans:
        return None
    corr = set()
    for r in red["runtime"]:
        for h in spans:
            if (r["tid"] == h["tid"]
                    and h["ts"] <= r["ts"] <= h["ts"] + h["dur"]):
                corr.add(r["corr"])
                break
    return _union([(d["ts"], d["ts"] + d["dur"]) for d in red["device"]
                   if d["corr"] in corr]) * 1e-6
