"""How the integrator's compiled programs run their phases: op by op,
or as CUDA graphs (the port of the JAX package's `jax.jit` programs:
the `lax.while_loop` render, pbrlab_tpu/render/integrator.py:1230-1301,
and the `lax.scan` of `render_lanes` / `render_scan`, :917-983 and
:1312-1326, forward and, under `jax.checkpoint`, its gradient).

The render loop (`integrator._WavefrontLoop`) splits the JAX while
loop's body into phases over buffers it allocates once per call; each
phase reads and writes only those buffers and the scene's tables, in
place. A runner runs the phases and reads the few bytes the JAX body
branches on (`lax.cond`) or loops on. `EagerRunner` runs a phase op by
op (the CPU, where the tests run it). `GraphRunner` runs a phase the
first time a render call needs it op by op, as its warm-up (the kernel
library is built and loaded, the caching allocator primed, every kernel
the phase launches loaded), captures it the second time with
`torch.cuda.CUDAGraph` and replays the capture from then on, so a phase
of thousands of kernels costs one host launch. A capture records
without executing, so the phase replays right after its capture. Every
graph of a call shares one memory pool (each phase's temporaries die
within it, so any replay order is safe) and lives only for the call.
A capture or replay error raises; nothing falls back to the eager
phase.

A render call's loop lives for the call. The scan path's program
(`integrator._LanesProgram`) outlives one: `Programs` is the counterpart
of `jax.jit`'s cache, a program per set of static arguments, kept by
the caller that renders many times (one `render_scan` call, the
progressive renderer, the train step) and never by this module. Each
program owns its buffers and one runner, so its phases are captured
once and replayed by every later call; what changes between calls (the
sample id, the seed, the material columns) is written into its buffers
(`put`, `copy_`).

Launch counts: the kernel wrappers add one to their module's `LAUNCHES`
where they launch, which under capture records and does not launch. A
capture therefore keeps the counts it added as the graph's own and takes
them back; every replay adds them again. A graphed render counts the
launches of its eager twin.
"""
from __future__ import annotations

import ctypes
import time

import torch

from ..ops import (bvh_walk, dense, dense_curve, dense_v2, dense_v3,
                   dense_v4, dense_v5, dense_v5i)

# every kernel wrapper's launch counter, by module
COUNTERS = {"v4": dense_v4.LAUNCHES, "v5": dense_v5.LAUNCHES,
            "curve": dense_curve.LAUNCHES, "v5i": dense_v5i.LAUNCHES,
            "v1": dense.LAUNCHES, "v2": dense_v2.LAUNCHES,
            "v3": dense_v3.LAUNCHES, "bvh": bvh_walk.LAUNCHES}


def _counts():
    return {(m, k): v for m, c in COUNTERS.items() for k, v in c.items()}


class Programs:
    """Compiled programs by their static arguments (`jax.jit`'s cache).
    `get(key, make)` returns the program made for `key` (its device
    first), making it with `make(runner)` the first time, a runner of its
    own with it. `runner` makes each program's runner
    (None: a `GraphRunner` for a program on a CUDA device, else an
    `EagerRunner`); a test or `chip_smoke.py` passes another."""

    def __init__(self, runner=None):
        self._runner = runner
        self.programs = {}

    def get(self, key, make):
        if key not in self.programs:
            dev = key[0]
            if self._runner is not None:
                runner = self._runner()
            elif dev.type == "cuda":
                with torch.cuda.device(dev):
                    runner = GraphRunner()
            else:
                runner = EagerRunner()
            self.programs[key] = make(runner)
        return self.programs[key]


def put(dst, values):
    """Write host integers into the int64 device tensor `dst` with no
    host sync: on a card through a fresh pinned tensor and a
    non-blocking copy (the host allocator keeps it until the copy ran)."""
    if dst.device.type != "cuda":
        dst.copy_(torch.tensor(values, dtype=dst.dtype))
        return
    host = torch.tensor(values, dtype=dst.dtype, pin_memory=True)
    dst.copy_(host, non_blocking=True)


class EagerRunner:
    """Runs each phase op by op; reads a probe with a host sync."""

    def run(self, name, phase):
        phase()

    def read(self, probe) -> int:
        return int(probe)


class GraphRunner:
    """Runs each phase of one render call as a CUDA graph on the current
    device (see the module docstring). `stats` holds, per phase, the
    capture and instantiate seconds and the replays; `nodes()` the
    captured nodes per graph. `cuda` is the `torch.cuda` namespace (a
    test passes a fake with the same names)."""

    def __init__(self, cuda=torch.cuda):
        self.cuda = cuda
        self.pool = cuda.graph_pool_handle()
        self.graphs = {}  # phase -> (graph, launches it captured)
        self.stats = {}  # phase -> capture_s, instantiate_s, replays
        self._pinned = None
        self._event = None

    def run(self, name, phase):
        if name not in self.stats:  # warm-up
            phase()
            self.stats[name] = {"capture_s": 0.0, "instantiate_s": 0.0,
                                "replays": 0}
            return
        if name not in self.graphs:
            self._capture(name, phase)
        graph, launches = self.graphs[name]
        graph.replay()
        for (m, k), n in launches.items():
            COUNTERS[m][k] += n
        self.stats[name]["replays"] += 1

    def _capture(self, name, phase):
        before = _counts()
        graph = self.cuda.CUDAGraph(keep_graph=True)
        t0 = time.perf_counter()
        with self.cuda.graph(graph, pool=self.pool):
            phase()
        t1 = time.perf_counter()
        graph.instantiate()
        t2 = time.perf_counter()
        launches = {key: n - before[key] for key, n in _counts().items()
                    if n != before[key]}
        for (m, k) in launches:  # the capture launched nothing
            COUNTERS[m][k] = before[(m, k)]
        self.graphs[name] = (graph, launches)
        self.stats[name].update(capture_s=t1 - t0, instantiate_s=t2 - t1)

    def read(self, probe) -> int:
        """The probe's value through one pinned host word: a copy after
        the work queued so far, then one wait on an event."""
        if self._pinned is None:
            self._pinned = torch.empty((), dtype=torch.int64,
                                       pin_memory=True)
            self._event = self.cuda.Event()
        self._pinned.copy_(probe, non_blocking=True)
        self._event.record()
        self._event.synchronize()
        return int(self._pinned)

    def nodes(self) -> dict:
        """Nodes per captured graph (libcuda's cuGraphGetNodes)."""
        cuda = ctypes.CDLL("libcuda.so.1")
        out = {}
        for name, (graph, _) in self.graphs.items():
            count = ctypes.c_size_t(0)
            rc = cuda.cuGraphGetNodes(ctypes.c_void_p(graph.raw_cuda_graph()),
                                      None, ctypes.byref(count))
            if rc != 0:
                raise RuntimeError(f"cuGraphGetNodes failed: CUresult {rc}")
            out[name] = count.value
        return out
