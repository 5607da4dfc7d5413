"""Profiling and observability (port of pbrlab_tpu.utils.profiling):
ray-count probes, the span recorder and profiler traces.

* `step_occupancy(scene, ...)`: the alive-lane fraction before each full
  step of one sample, on the scene's device.
* `ray_units(scene, ...)`: rays fired per pixel-sample at each step (a
  closest and a shadow ray per alive lane, one ray per volume lane per
  k_volume substep).
* `measure_sss_truncation(scene_np, ...)` / `measure_occupancy(scene_np,
  ...)`: the same probes on a `probe`^2 image of a numpy scene placed on
  `device` (None = CUDA, no fallback). Occupancy is the algorithm's, not
  the hardware's. The JAX package forces its threaded-BVH walk here; the
  port traces through the scene's own backend (the kernels on the card,
  their plain twins on the CPU), which can move a tied or grazing lane,
  unless the caller passes `tri_backend="bvh"`, which computes what the
  JAX probes compute.
* The recorder: `span(name, **attrs)` and `count(name, n)` at the
  program's layer boundaries, kept in memory, read back by `records()`.
  A request's counters: `subiters`, `lane_slots`, `lanes_alive` (a
  render), `device_ms.<phase>`, `warmup_device_ms.<phase>`,
  `nodes.<phase>`, and `launches.step.fused` / `launches.step.chain`
  (`render.graphs`: its wavefront steps that ran as `ops.step`'s kernels
  and as the torch chain). The span ring keeps the last 2^18 spans,
  ~320 bytes each (~84 MB when full; the ring grows as spans come): the
  render loop records ~3.5 spans a sub-iteration, so it holds ~75,000
  sub-iterations. A reader that needs a process's requests whole reads
  them before the ring wraps (`dropped()` says whether it has).
* `trace(logdir)`: a `torch.profiler` window written as a Chrome trace,
  the recorder's spans of the window merged into it.
"""
from __future__ import annotations

import contextlib
import itertools
import json
import os
import threading
import time
from collections import defaultdict, deque

import torch


def _probe_scene(scene_np, device):
    from ..scene.scene import build_fat_tables, scene_to_device

    return build_fat_tables(scene_to_device(scene_np, device))


@torch.no_grad()
def step_occupancy(scene, width: int, height: int, max_steps: int,
                   sample_id=0, seed: int = 0,
                   tri_backend: str | None = None) -> torch.Tensor:
    """Alive-lane fraction before each wavefront step -> [max_steps]
    (`tri_backend` forces the triangle backend)."""
    from ..render.integrator import (init_state, pack_state, unpack_state,
                                     wavefront_step)
    from ..scene.scene import build_fat_tables

    if "mat_fat" not in scene:
        scene = build_fat_tables(scene)
    rows = pack_state(init_state(scene, width, height, sample_id, seed))
    fracs = []
    for _ in range(max_steps):
        fracs.append(unpack_state(rows).alive.to(torch.float32).mean())
        rows = wavefront_step(scene, rows, tri_backend=tri_backend)
    return torch.stack(fracs)


@torch.no_grad()
def ray_units(scene, width: int, height: int, max_steps: int,
              k_volume: int = 0, sample_id=0, seed: int = 0,
              tri_backend: str | None = None) -> torch.Tensor:
    """Rays fired per pixel-sample, per step -> [max_steps].

    A full step fires one closest hit per alive lane plus one shadow ray
    per shading lane (counted as alive x 2); each k_volume substep fires
    one closest hit per volume lane (counted exactly). `tri_backend`
    forces the triangle backend."""
    from ..render.integrator import (MODE_VOLUME, init_state, pack_state,
                                     unpack_state, wavefront_step)
    from ..scene.scene import build_fat_tables

    if "mat_fat" not in scene:
        scene = build_fat_tables(scene)
    rows = pack_state(init_state(scene, width, height, sample_id, seed))
    per_step = []
    for _ in range(max_steps):
        units = 2.0 * unpack_state(rows).alive.to(torch.float32).mean()
        rows = wavefront_step(scene, rows, tri_backend=tri_backend)
        for i in range(k_volume):
            state = unpack_state(rows)
            vol = state.alive & (state.mode == MODE_VOLUME)
            units = units + vol.to(torch.float32).mean()
            rows = wavefront_step(scene, rows, freeze_surface=True,
                                  resolve_pending=(i == 0),
                                  tri_backend=tri_backend)
        per_step.append(units)
    return torch.stack(per_step)


@torch.no_grad()
def measure_sss_truncation(scene_np, max_steps: int, k_volume: int = 0,
                           probe: int = 96, sample_id=0, seed: int = 0,
                           device=None, tri_backend: str | None = None
                           ) -> float:
    """Fraction of SSS random walks still inside the medium when the
    (1 + k_volume) * max_steps budget runs out, over one sample of a
    `probe`^2 image on `device` (None = CUDA). The reference walks up to
    8192 steps (random-walk-sss.h:281); a truncated walk biases radiance
    down. `integrator.auto_k_volume` thresholds it. `tri_backend` forces
    the triangle backend ("bvh": the JAX probe's)."""
    from ..render.integrator import (MODE_VOLUME, init_state, pack_state,
                                     unpack_state, wavefront_step)

    scene = _probe_scene(scene_np, device)
    rows = pack_state(init_state(scene, probe, probe, sample_id, seed))
    started = torch.zeros((), dtype=torch.int64, device=rows.device)
    for _ in range(max_steps):
        pre = unpack_state(rows).mode == MODE_VOLUME
        rows = wavefront_step(scene, rows, tri_backend=tri_backend)
        state = unpack_state(rows)
        started += (~pre & (state.mode == MODE_VOLUME) & state.alive).sum()
        for i in range(k_volume):
            rows = wavefront_step(scene, rows, freeze_surface=True,
                                  resolve_pending=(i == 0),
                                  tri_backend=tri_backend)
    state = unpack_state(rows)
    truncated = (state.alive & (state.mode == MODE_VOLUME)).sum()
    return float(truncated) / max(float(started), 1.0)


def measure_occupancy(scene_np, max_steps: int, probe: int = 128,
                      k_volume: int = 0, device=None,
                      tri_backend: str | None = None) -> float:
    """Sum over the steps of rays fired per pixel-sample (`ray_units` on a
    `probe`^2 image on `device`, None = CUDA): the x2 closest + shadow
    factor and the k_volume substep rays included, so W*H*spp times it is
    a render's ray count. `tri_backend` forces the triangle backend
    ("bvh": the JAX probe's)."""
    scene = _probe_scene(scene_np, device)
    return float(ray_units(scene, probe, probe, max_steps, k_volume,
                           tri_backend=tri_backend).sum())


# --- the recorder --------------------------------------------------------
#
# Spans at the program's layer boundaries (the entry points, the graph
# runner, the kernel library's build, the fat tables' build) and counts
# beside them, kept in memory and read back with `records()`. The
# outermost open span starts a request; every span records its request
# and its parent. Requests run one at a time in a process (the CLI, the
# viewer's render loop, a train loop): a span opened on another thread
# while one is open, as autograd's device thread runs a backward, is a
# child of the innermost open span. Spans are stamped on the profiler
# trace's host clock (Unix ns, Kineto's `baseTimeNanoseconds` + ts x
# 1000) from a monotonic clock anchored to it once. The recorder is on
# unless PBRLAB_TRACE=0; off, `span` costs one attribute test.

_UNIX0 = time.time_ns()
_MONO0 = time.perf_counter_ns()
PENDING = 256  # event pairs waiting before a `device_interval` resolves


def _now_ns() -> int:
    """Unix time in ns on the monotonic clock."""
    return _UNIX0 + time.perf_counter_ns() - _MONO0


class _Request:
    __slots__ = ("id", "name", "attrs", "t0", "t1", "counters")

    def __init__(self, rid, name, attrs):
        self.id, self.name, self.attrs = rid, name, attrs
        self.t0 = self.t1 = 0
        self.counters = {}


class Recorder:
    """The spans of the last `capacity` (a ring that counts what it
    drops), the last `max_requests` finished requests with their
    counters, and the device-timed event pairs not yet resolved."""

    def __init__(self, capacity: int = 1 << 18, max_requests: int = 8192):
        self.on = os.environ.get("PBRLAB_TRACE", "1") != "0"
        self.spans = deque(maxlen=capacity)
        self.requests = deque(maxlen=max_requests)
        self.dropped = {"spans": 0, "requests": 0}
        self.top = None  # the innermost open span
        self.pending = []  # (counters, name, start event, end event, release)
        self.lock = threading.Lock()  # over `pending`
        self.ids = itertools.count(1)

    def keep(self, ring, item, what):
        if len(ring) == ring.maxlen:
            self.dropped[what] += 1
        ring.append(item)


class _Span:
    __slots__ = ("rec", "name", "attrs", "id", "parent", "request", "t0")

    def __init__(self, rec, name, attrs):
        self.rec, self.name, self.attrs = rec, name, attrs

    def __enter__(self):
        rec = self.rec
        self.parent = rec.top
        self.id = next(rec.ids)
        self.request = (_Request(self.id, self.name, self.attrs)
                        if self.parent is None else self.parent.request)
        rec.top = self
        self.t0 = _now_ns()
        return self

    def __exit__(self, *exc):
        t1 = _now_ns()
        rec = self.rec
        rec.top = self.parent
        parent = 0 if self.parent is None else self.parent.id
        rec.keep(rec.spans, (self.request.id, self.id, parent, self.name,
                             self.t0, t1 - self.t0, self.attrs), "spans")
        if self.parent is None:
            self.request.t0, self.request.t1 = self.t0, t1
            rec.keep(rec.requests, self.request, "requests")
        return False


RECORDER = Recorder()
_OFF = contextlib.nullcontext()


def reset():
    """A fresh recorder (PBRLAB_TRACE read again); what was kept goes."""
    global RECORDER
    RECORDER = Recorder()


def span(name: str, **attrs):
    """A context manager recording `name` over its block; the outermost
    open span starts a request."""
    if not RECORDER.on:
        return _OFF
    return _Span(RECORDER, name, attrs)


def request(name: str, **attrs):
    """`span(name)` when no span is open (the outermost entry point of a
    request), else nothing."""
    if not RECORDER.on or RECORDER.top is not None:
        return _OFF
    return _Span(RECORDER, name, attrs)


def count(name: str, n=1):
    """Add n to the current request's counter `name` (nothing when no
    request is open)."""
    rec = RECORDER
    if rec.on and rec.top is not None:
        counters = rec.top.request.counters
        counters[name] = counters.get(name, 0) + n


def device_interval(name: str, start, end, release=None):
    """Add the device ms from CUDA event `start` to `end` (both recorded,
    timing enabled) to the current request's counter `name` once `end`
    has completed (`resolve`); `release(start, end)` then takes the
    events back. With no request open they go back at once. A program
    that never reads (no `resolve`) resolves what has completed every
    `PENDING` pairs, so the pairs waiting stay few."""
    rec = RECORDER
    if rec.on and rec.top is not None:
        with rec.lock:
            rec.pending.append((rec.top.request.counters, name, start, end,
                                release))
        if len(rec.pending) >= PENDING:
            resolve()
    elif release is not None:
        release(start, end)


def resolve():
    """Fold every event pair whose end has completed into its request's
    counters. Never waits: a caller that has just waited on the stream
    (the graph runner's read) resolves everything queued before."""
    rec = RECORDER
    with rec.lock:
        left = []
        for item in rec.pending:
            counters, name, start, end, release = item
            if not end.query():
                left.append(item)
                continue
            counters[name] = counters.get(name, 0.0) + start.elapsed_time(end)
            if release is not None:
                release(start, end)
        rec.pending = left


GRAPH_SPANS = ("graphs.warmup", "graphs.capture", "graphs.instantiate",
               "graphs.launch", "graphs.eager")


def _phases(spans, counters):
    """A request's per-phase table, from its graph runner spans and
    counters: host s of warm-ups, captures, instantiations, launches and
    eager runs, replays, captured nodes, device ms of replays and
    warm-ups."""
    out = defaultdict(lambda: {"warmup_s": 0.0, "capture_s": 0.0,
                               "instantiate_s": 0.0, "launch_s": 0.0,
                               "eager_s": 0.0, "replays": 0, "nodes": None,
                               "device_ms": 0.0, "warmup_device_ms": 0.0})
    for s in spans:
        if s["name"] in GRAPH_SPANS:
            st = out[s["attrs"]["phase"]]
            key = s["name"].split(".")[1]
            st[key + "_s"] += s["dur_ns"] / 1e9
            st["replays"] += key == "launch"
    for name, v in counters.items():
        kind, _, phase = name.partition(".")
        if kind in ("device_ms", "warmup_device_ms"):
            out[phase][kind] += v
        elif kind == "nodes":
            out[phase]["nodes"] = v
    return dict(out)


def _record(req, spans):
    return {"id": req.id, "name": req.name, "attrs": req.attrs,
            "t0_ns": req.t0, "dur_ns": req.t1 - req.t0,
            "counters": dict(req.counters),
            "phases": _phases(spans, req.counters), "spans": spans}


def records(since: int = 0):
    """The finished requests with an id above `since`, oldest first, each
    a dict: id, name, attrs, t0_ns (Unix ns), dur_ns, counters, phases
    (`_phases`) and its spans still in the ring (id, parent (0 for the
    request's own), name, t0_ns, dur_ns, attrs). Event pairs that have
    completed are resolved first."""
    resolve()
    rec = RECORDER
    by_request = defaultdict(list)
    for rid, sid, parent, name, t0, dur, attrs in list(rec.spans):
        if rid > since:
            by_request[rid].append({"id": sid, "parent": parent,
                                    "name": name, "t0_ns": t0, "dur_ns": dur,
                                    "attrs": attrs})
    return [_record(req, by_request.get(req.id, []))
            for req in list(rec.requests) if req.id > since]


def dropped() -> dict:
    """Spans and requests the rings have dropped."""
    return dict(RECORDER.dropped)


_TRACE_TID = 0x70627200  # the merged spans' row


def merge_spans(path: str, t0_ns: int, t1_ns: int):
    """Write the recorder's spans that overlap [t0_ns, t1_ns] into the
    Chrome trace at `path`, on the trace's own clock (its
    `baseTimeNanoseconds`), on one row named pbrlab."""
    with open(path) as f:
        doc = json.load(f)
    base = int(doc.get("baseTimeNanoseconds", 0))
    events = doc.setdefault("traceEvents", [])
    pid = os.getpid()
    events.append({"ph": "M", "name": "thread_name", "pid": pid,
                   "tid": _TRACE_TID, "args": {"name": "pbrlab"}})
    for rid, sid, parent, name, t0, dur, attrs in list(RECORDER.spans):
        if t0 + dur < t0_ns or t0 > t1_ns:
            continue
        events.append({"ph": "X", "cat": "pbrlab", "name": name, "pid": pid,
                       "tid": _TRACE_TID, "ts": (t0 - base) / 1e3,
                       "dur": dur / 1e3,
                       "args": {**attrs, "request": rid, "span": sid,
                                "parent": parent}})
    with open(path, "w") as f:
        json.dump(doc, f)


@contextlib.contextmanager
def trace(logdir: str):
    """`torch.profiler.profile` over the block (CPU, and CUDA where a card
    is present), written to logdir/trace.json as a Chrome trace (open in
    chrome://tracing or Perfetto) with the recorder's spans of the block
    on a row of their own. Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    t0 = _now_ns()
    with profile(activities=activities) as prof:
        yield prof
    t1 = _now_ns()
    path = os.path.join(logdir, "trace.json")
    prof.export_chrome_trace(path)
    merge_spans(path, t0, t1)
