"""The render loop's phases (`integrator._WavefrontLoop`) and the runners
that issue them (`render.graphs`), at the goldens' size (16x16, 4 spp,
max_steps 6, seed 7). No JAX: the card runs the requires_cuda test with
`python -m pytest tests/test_torch_graphs.py --noconftest -o addopts=""
-m requires_cuda`.

(a) A phase reads no device value on the host and makes no tensor from
    host data (on the card a copy to the device, which a capture refuses
    from pageable memory): each runs with `Tensor.__bool__`, `__int__`,
    `__float__`, `item`, `tolist`, `numpy`, `new_tensor`, `torch.tensor`,
    `torch.as_tensor` of host data and `torch.from_numpy` recording a
    violation. The trace calls are let through: on
    the CPU they run the kernels' plain twins, which walk with host
    tests, and on the card the kernels, which a capture would refuse if
    they synchronised.
(b) A phase leaves the addresses of `packed`, `fb`, `next_pixel`,
    `probe` and `lane` as it found them (a graph replays those
    addresses).
(c) The phases come in the JAX body's order (pbrlab_tpu/render/
    integrator.py:1157-1227) as the host reads decide: with the window,
    (A) then (B-win) when the read count of walkers fits the window, else
    (B-full); without it but with substeps, (A-head), (B-any) when a lane
    walks, (A-tail); without substeps (A); each trip ends with (F), and a
    loop test read (its low bit; the lanes counted so far above it) starts
    every trip. Window 1 overflows whenever more
    than one lane walks, window n_lanes - 1 never does, window n_lanes is
    off.
(d) The phase-split loop gives `render`'s bits and those of `render_scan`
    (the scan path, a loop of its own) on the lambert, ggx and sss golden
    scenes.
(e) `GraphRunner`'s bookkeeping with a fake `torch.cuda`: a phase runs op
    by op the first time, is captured the second time and replayed from
    then on; a capture's launch counts are taken back and added at every
    replay, so the counters read what the eager phases launch; a replay
    error raises and nothing runs the phase instead.
(f) On the card: a graphed 32x32x2 SSS cornellbox render against the
    private eager loop, to the bit, with equal launch counts.
"""
import pytest
import torch

from pbrlab_tpu_torch.ops import dense_v4, dense_v5
from pbrlab_tpu_torch.render import graphs
from pbrlab_tpu_torch.render import integrator as tint
from pbrlab_tpu_torch.scene.demo import build_demo_scene
from pbrlab_tpu_torch.scene.scene import build_fat_tables, scene_from_numpy
from pbrlab_tpu_torch.utils import profiling
from torch_fakes import FakeCuda, FakeGraph
from torch_threads import one_torch_thread  # noqa: F401

W = H = 16
SPP = 4
SEED = 7
MAX_STEPS = 6
SCENES = {  # tests/test_goldens.py:25-41
    "lambert": dict(subdiv=1, lambert_only=True),
    "ggx": dict(subdiv=1, with_lucy=False),
    "sss": dict(subdiv=1, with_monkey=False),
}
# name: (scene, k_volume, render_lanes_wavefront kwargs)
RUNS = {
    "lambert": ("lambert", 0, {}),
    "ggx": ("ggx", 0, dict(n_lanes=100, flush_every=2)),
    "sss": ("sss", 2, {}),
    "sss-window-overflows": ("sss", 2, dict(vol_window=1)),
    "sss-window-fits": ("sss", 2, dict(vol_window=W * H - 1)),
    "sss-window-off": ("sss", 2, dict(vol_window=W * H)),
}
HOST_READS = ("__bool__", "__int__", "__float__", "item", "tolist", "numpy")
# tensors made from host data: on the card a copy to the device, which a
# capture refuses from pageable memory
HOST_DATA = ((torch, "tensor"), (torch, "as_tensor"), (torch, "from_numpy"),
             (torch.Tensor, "new_tensor"))
BUFFERS = ("packed", "fb", "next_pixel", "probe", "lane")


class WatchingRunner(graphs.EagerRunner):
    """Runs each phase op by op as `EagerRunner` does, recording the
    phases and reads in order, the buffers' addresses around each phase
    and every host read a phase makes."""

    def __init__(self):
        self.events = []
        self.moved = []
        self.violations = []
        self.watching = False

    def run(self, name, phase):
        loop = phase.__self__
        before = _addresses(loop)
        self.events.append(("run", name))
        self.watching = True
        try:
            phase()
        finally:
            self.watching = False
        if _addresses(loop) != before:
            self.moved.append(name)

    def read(self, probe):
        value = super().read(probe)
        self.events.append(("read", value))
        return value


def _addresses(loop):
    return {b: None if getattr(loop, b) is None else
            getattr(loop, b).data_ptr() for b in BUFFERS}


@pytest.fixture(scope="module")
def scenes():
    return {name: build_fat_tables(scene_from_numpy(
        build_demo_scene(**kw)[0], "cpu")) for name, kw in SCENES.items()}


@pytest.fixture(scope="module")
def watched(scenes):
    """name -> (runner, summed radiance, sub-iterations) of each RUNS
    render through a WatchingRunner, host reads inside a phase recorded."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        runner = None
        for attr in HOST_READS:
            orig = getattr(torch.Tensor, attr)

            def watched_read(t, *a, _orig=orig, _attr=attr, **k):
                if runner is not None and runner.watching:
                    runner.violations.append(_attr)
                return _orig(t, *a, **k)

            mp.setattr(torch.Tensor, attr, watched_read)
        for owner, attr in HOST_DATA:
            orig = getattr(owner, attr)

            def watched_copy(*a, _orig=orig, _attr=attr, **k):
                data = a[1] if _attr == "new_tensor" else a[0]
                if (runner is not None and runner.watching
                        and not torch.is_tensor(data)):
                    runner.violations.append(_attr)
                return _orig(*a, **k)

            mp.setattr(owner, attr, watched_copy)
        for attr in ("trace_scene", "trace_scene_dual"):
            fn = getattr(tint, attr)

            def unwatched(*a, _fn=fn, **k):
                watching, runner.watching = runner.watching, False
                try:
                    return _fn(*a, **k)
                finally:
                    runner.watching = watching

            mp.setattr(tint, attr, unwatched)
        for name, (scene, k_volume, kw) in RUNS.items():
            runner = WatchingRunner()
            fb, it = tint._wavefront(runner, scenes[scene], W, H, SPP, SEED,
                                     MAX_STEPS, k_volume, **kw)
            out[name] = runner, fb, it
            runner = None
    return out


@pytest.mark.parametrize("name", sorted(RUNS))
def test_phases_read_no_device_value(watched, name):
    runner = watched[name][0]
    assert runner.violations == []
    assert any(kind == "run" for kind, _ in runner.events)


@pytest.mark.parametrize("name", sorted(RUNS))
def test_phases_keep_buffer_addresses(watched, name):
    assert watched[name][0].moved == []


def _jax_order(events, k_volume, window_ok, vol_window, flush_every):
    """The phases the JAX body takes given the host's reads -> (expected
    run names, reads left over)."""
    reads = [v for kind, v in events if kind == "read"]
    runs = []

    def read():
        return reads.pop(0)

    while read() & 1:  # the loop test
        for _ in range(flush_every):
            if window_ok:
                runs.append("A")
                runs.append("B-win" if read() <= vol_window else "B-full")
            elif k_volume:
                runs.append("A-head")
                if read():
                    runs.append("B-any")
                runs.append("A-tail")
            else:
                runs.append("A")
        runs.append("F")
    return runs, reads


@pytest.mark.parametrize("name", sorted(RUNS))
def test_phase_order_is_the_jax_body(watched, name):
    runner, _, it = watched[name]
    _, k_volume, kw = RUNS[name]
    n_lanes = min(W * H, kw.get("n_lanes", 65536))
    vol_window = min(kw.get("vol_window", n_lanes * 3 // 8), n_lanes)
    flush_every = min(kw.get("flush_every", 4), SPP)
    window_ok = k_volume > 0 and vol_window < n_lanes
    want, left = _jax_order(runner.events, k_volume, window_ok, vol_window,
                            flush_every)
    got = [v for kind, v in runner.events if kind == "run"]
    assert got == want and left == []
    assert it == got.count("F") * flush_every
    # each run's reads sit where its body reads: one loop test a trip,
    # one window or walker read a sub-iteration when there are substeps
    reads = sum(kind == "read" for kind, _ in runner.events)
    assert reads == got.count("F") + 1 + (
        it if k_volume else 0)
    if name == "sss-window-overflows":
        assert "B-full" in got
    elif name in ("sss", "sss-window-fits"):
        assert "B-win" in got and "B-full" not in got
    elif name == "sss-window-off":
        assert "B-any" in got and "A" not in got
    else:
        assert set(got) == {"A", "F"}


@pytest.mark.parametrize("name", sorted(SCENES))
def test_phase_split_loop_gives_render_bits(scenes, watched, name):
    _, fb, _ = watched[name]
    _, k_volume, kw = RUNS[name]
    img = tint._mean(fb.reshape(H, W, 3), SPP)
    want = tint.render(scenes[name], W, H, SPP, seed=SEED,
                       max_steps=MAX_STEPS, k_volume=k_volume, **kw)
    scan = tint.render_scan(scenes[name], W, H, SPP, seed=SEED,
                            max_steps=MAX_STEPS, k_volume=k_volume)
    assert img.abs().sum() > 0
    assert torch.equal(img, want)
    assert torch.equal(img, scan)


@pytest.mark.parametrize("name", ["sss-window-overflows", "sss-window-fits",
                                  "sss-window-off"])
def test_window_branches_give_one_image(watched, name):
    assert torch.equal(watched[name][1], watched["sss"][1])


@pytest.fixture
def counters():
    saved = {m: dict(c) for m, c in graphs.COUNTERS.items()}
    for c in graphs.COUNTERS.values():
        for k in c:
            c[k] = 0
    yield graphs.COUNTERS
    for m, c in graphs.COUNTERS.items():
        c.update(saved[m])


def test_graph_runner_counts_the_eager_launches(counters):
    cuda = FakeCuda()
    runner = graphs.GraphRunner(cuda)
    calls = []

    def phase_a():  # launches a dual dense_v4 and a dense_v5 kernel
        calls.append("A")
        dense_v4.LAUNCHES["dual"] += 1
        dense_v5.LAUNCHES["v5"] += 1

    def phase_f():  # launches no kernel of the port
        calls.append("F")

    for _ in range(5):
        runner.run("A", phase_a)
    for _ in range(2):
        runner.run("F", phase_f)
    # A: a warm-up, a capture (which a real graph records without
    # running), then replays; F: a warm-up and a capture
    assert calls == ["A", "A", "F", "F"]
    graph_a, launches = runner.graphs["A"]
    assert launches == {("v4", "dual"): 1, ("v5", "v5"): 1}
    assert runner.graphs["F"][1] == {}
    assert graph_a.replays == 4 and runner.graphs["F"][0].replays == 1
    assert cuda.captures == [graph_a, runner.graphs["F"][0]]
    assert runner.warm == {"A", "F"}
    # five runs of A count five launches, as five eager runs do
    assert counters["v4"]["dual"] == 5 and counters["v5"]["v5"] == 5
    assert sum(sum(c.values()) for c in counters.values()) == 10


def test_graph_runner_raises_on_a_failed_replay(counters, monkeypatch):
    runner = graphs.GraphRunner(FakeCuda())
    calls = []

    def phase():
        calls.append(1)
        dense_v4.LAUNCHES["single"] += 1

    runner.run("B-win", phase)
    monkeypatch.setattr(FakeGraph, "fail_replay", True)
    with pytest.raises(RuntimeError, match="replay failed"):
        runner.run("B-win", phase)
    with pytest.raises(RuntimeError, match="replay failed"):
        runner.run("B-win", phase)
    # the warm-up and the capture ran the phase; no eager run replaced a
    # failed replay, and no launch was counted for one
    assert calls == [1, 1]
    assert counters["v4"]["single"] == 1


@pytest.mark.requires_cuda
def test_graphed_render_equals_eager_loop():
    """A 32x32x2 render of the SSS cornellbox (dense_v4, k_volume 3, the
    window overflowing on some sub-iterations at 3/8 of 1024 lanes)
    through CUDA graphs against the loop op by op: every bit and every
    launch count equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (graphs capture CUDA kernels)")
    scene = scene_from_numpy(build_demo_scene(subdiv=3)[0], "cuda")
    out = {}
    for kind in ("graphs", "eager"):
        for c in graphs.COUNTERS.values():
            for k in c:
                c[k] = 0
        runner = graphs.GraphRunner() if kind == "graphs" else \
            graphs.EagerRunner()
        mark = max([r["id"] for r in profiling.records()], default=0)
        fb, it = tint._wavefront(runner, scene, 32, 32, 2, seed=SEED,
                                 max_steps=12, k_volume=3)
        torch.cuda.synchronize()
        out[kind] = fb.cpu(), it, {(m, k): v for m, c in
                                   graphs.COUNTERS.items()
                                   for k, v in c.items()}
        if kind == "graphs":
            rec = profiling.records(since=mark)[-1]  # the render request
            assert rec["name"] == "render"
            assert any(st["replays"] for st in rec["phases"].values())
    assert out["graphs"][1] == out["eager"][1]
    assert torch.equal(out["graphs"][0], out["eager"][0])
    assert out["graphs"][2] == out["eager"][2]
    assert out["graphs"][2][("v4", "dual")] > 0
    assert out["graphs"][0].sum() > 0
