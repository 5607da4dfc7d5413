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

Spans and device times (`utils.profiling`): `GraphRunner` records a
span around each warm-up (`graphs.warmup`), capture (`graphs.capture`),
instantiation (`graphs.instantiate`), replay (`graphs.launch`, the host
time inside `replay()`) and read (`graphs.read`, the host blocked until
the probe's word arrives), each warm-up, capture and launch carrying its
phase; a pair of timing events on the current stream brackets each
warm-up and each replay, resolved into the request's `warmup_device_ms.
<phase>` and `device_ms.<phase>` by a later read, before it waits (or by
`profiling.records()`), never by a wait of their own; a capture's nodes
count into `nodes.<phase>`. A read waits on a timing event, which opens
the pair of the phase run next: a pair opened after the wait would put
its first event's record (~0.085 ms of host time on an H100, the first
submission after the stream went idle) on the host's path while the
device waits. A phase run right after a read therefore counts in its
device ms the read's round trip (the device idle from the probe's copy
to the launch); a capture drops the armed event. `EagerRunner` records `graphs.eager` and
`graphs.read` spans, the same tree op by op. A request's per-phase table
(host seconds, replays, device ms) is built from these alone
(`profiling.records()`'s `phases`).

Launch counts: the kernel wrappers add one to their module's `LAUNCHES`
where they launch, which under capture records and does not launch. A
capture therefore keeps the counts it added as the graph's own and takes
them back; every replay adds them again. A graphed render counts the
launches of its eager twin. The runners also count a phase's wavefront
steps into the open request, those that ran as `ops.step`'s kernels
(`launches.step.fused`) and as the torch chain (`launches.step.chain`):
a warm-up's and an eager run's as they happen, a replay's from its
capture.
"""
from __future__ import annotations

import ctypes

import torch

from ..ops import (bvh_walk, dense, dense_curve, dense_v2, dense_v3,
                   dense_v4, dense_v5, dense_v5i, step)
from ..utils import profiling

# every kernel wrapper's launch counter, by module (`step`: the wavefront
# step's, fused or chain)
COUNTERS = {"v4": dense_v4.LAUNCHES, "v5": dense_v5.LAUNCHES,
            "curve": dense_curve.LAUNCHES, "v5i": dense_v5i.LAUNCHES,
            "v1": dense.LAUNCHES, "v2": dense_v2.LAUNCHES,
            "v3": dense_v3.LAUNCHES, "bvh": bvh_walk.LAUNCHES,
            "step": step.LAUNCHES}


def _counts():
    return {(m, k): v for m, c in COUNTERS.items() for k, v in c.items()}


_STEPS = ("fused", "chain")  # the step counts a request carries


def _run_counted(phase):
    """Run a phase op by op, its fused and chain steps counted into the
    open request (`utils.profiling`)."""
    if not profiling.RECORDER.on:
        phase()
        return
    before = [step.LAUNCHES[k] for k in _STEPS]
    phase()
    for k, n in zip(_STEPS, before):
        if step.LAUNCHES[k] != n:
            profiling.count("launches.step." + k, step.LAUNCHES[k] - n)


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
        with profiling.span("graphs.eager", phase=name):
            _run_counted(phase)

    def read(self, probe) -> int:
        with profiling.span("graphs.read"):
            return int(probe)


class GraphRunner:
    """Runs each phase of one render call as a CUDA graph on the current
    device (see the module docstring). `warm` holds the phases run once;
    `nodes()` the captured nodes per graph. `cuda` is the `torch.cuda`
    namespace (a test passes a fake with the same names)."""

    def __init__(self, cuda=torch.cuda):
        self.cuda = cuda
        self.pool = cuda.graph_pool_handle()
        self.graphs = {}  # phase -> (graph, launches it captured)
        self.warm = set()  # phases run once, op by op
        self._pinned = None
        self._event = None
        self._timers = []  # timing events free for a pair
        self._armed = None  # the last read's timing event, opening a pair

    def run(self, name, phase):
        if name not in self.warm:
            with profiling.span("graphs.warmup", phase=name):
                self._timed("warmup_device_ms." + name, _run_counted, phase)
            self.warm.add(name)
            return
        if name not in self.graphs:
            self._disarm()  # the capture leaves the device idle
            self._capture(name, phase)
        graph, launches = self.graphs[name]
        self._timed("device_ms." + name, self._launch, graph, name)
        for (m, k), n in launches.items():
            COUNTERS[m][k] += n
            if m == "step" and k in _STEPS:
                profiling.count("launches.step." + k, n)

    @staticmethod
    def _launch(graph, name):
        with profiling.span("graphs.launch", phase=name):
            graph.replay()

    def _timed(self, counter, fn, *args):
        """fn(*args) between two timing events on the current stream (the
        first the last read's, if armed), their interval counted into the
        request's `counter` once passed (with the recorder off, fn
        alone)."""
        if not profiling.RECORDER.on:
            fn(*args)
            return
        start, self._armed = self._armed, None
        if start is None:
            start = self._timer()
            start.record()
        fn(*args)
        end = self._timer()
        end.record()
        profiling.device_interval(counter, start, end, self._free)

    def _timer(self):
        return (self._timers.pop() if self._timers else
                self.cuda.Event(enable_timing=True))

    def _free(self, start, end):
        self._timers += (start, end)

    def _disarm(self):
        if self._armed is not None:
            self._timers.append(self._armed)
            self._armed = None

    def _capture(self, name, phase):
        before = _counts()
        graph = self.cuda.CUDAGraph(keep_graph=True)
        with profiling.span("graphs.capture", phase=name):
            with self.cuda.graph(graph, pool=self.pool):
                phase()
        with profiling.span("graphs.instantiate", phase=name):
            graph.instantiate()
        launches = {key: n - before[key] for key, n in _counts().items()
                    if n != before[key]}
        for (m, k) in launches:  # the capture launched nothing
            COUNTERS[m][k] = before[(m, k)]
        self.graphs[name] = (graph, launches)
        if self.cuda is torch.cuda:  # a fake's graphs have no nodes
            profiling.count("nodes." + name, _node_count(graph))

    def read(self, probe) -> int:
        """The probe's value through one pinned host word: a copy after
        the work queued so far, then one wait on an event (with the
        recorder on, a timing event, armed to open the next phase's
        pair). The timing pairs that have completed are resolved first,
        while the device still runs the last phase."""
        with profiling.span("graphs.read"):
            if self._pinned is None:
                self._pinned = torch.empty((), dtype=torch.int64,
                                           pin_memory=True)
            self._pinned.copy_(probe, non_blocking=True)
            self._disarm()
            if profiling.RECORDER.on:
                event = self._armed = self._timer()
            else:
                if self._event is None:
                    self._event = self.cuda.Event()
                event = self._event
            event.record()
            profiling.resolve()
            event.synchronize()
        return int(self._pinned)

    def nodes(self) -> dict:
        """Nodes per captured graph (libcuda's cuGraphGetNodes)."""
        return {name: _node_count(graph)
                for name, (graph, _) in self.graphs.items()}


def _node_count(graph) -> int:
    """A captured graph's nodes (libcuda's cuGraphGetNodes)."""
    cuda = ctypes.CDLL("libcuda.so.1")
    count = ctypes.c_size_t(0)
    rc = cuda.cuGraphGetNodes(ctypes.c_void_p(graph.raw_cuda_graph()),
                              None, ctypes.byref(count))
    if rc != 0:
        raise RuntimeError(f"cuGraphGetNodes failed: CUresult {rc}")
    return count.value
