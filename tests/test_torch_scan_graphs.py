"""The scan path's compiled program (`integrator._LanesProgram`): the
phases of `render_lanes` / `render_sample` / `render_scan`, of the
progressive renderer's passes and of the gradient pass's per-depth
backward, at the goldens' size (16x16, 4 spp, max_steps 6, seed 7).

(a) A phase reads no device value on the host and makes no tensor from
    host data (`tests/test_torch_graphs.py`'s watch; the trace calls let
    through), forward and backward.
(b) A phase leaves the program's buffers (state, keys, pixel ids, probe,
    any-hit answer, output, the backward's buffers, the scene's tables)
    where it found them, across calls.
(c) The phases come in the JAX body's order (pbrlab_tpu/render/
    integrator.py:938-983) as the host reads decide: per sample (I), per
    depth (S), a read when there are substeps, (V) when a lane walks, (C)
    every sort_every-th depth, then (F); the backward (F-grad), then a
    (G) phase a depth, last first, on the forward's branches.
(d) Through `GraphRunner` with a fake `torch.cuda` whose graphs record
    the aten ops a capture runs (the trace calls as opaque nodes) and
    replay them on the captured tensors, as a CUDA graph does: each phase
    is captured once across `render_scan`'s samples, the progressive
    passes (an edit included) and the train step's calls, and the
    replays give the op-by-op bits, so no sample id, seed or table
    address is baked into a capture.
(e) Gradients of the per-depth backward (remat=True) against `jax.grad`
    (the band of tests/test_torch_gradients.py), central differences, and
    the `torch.utils.checkpoint` tape it replaces.
(f) `scripts/torch_preview_demo.py` at 16x16 on the CPU.
(g) On the card: a graphed `render_scan` and a graphed gradient pass
    against the same programs op by op (JAX is imported only by the JAX
    fixture, so the card runs this file with
    `python -m pytest tests/test_torch_scan_graphs.py --noconftest -o
    addopts="" -m requires_cuda`).
"""
import contextlib
import functools
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from pbrlab_tpu_torch.parallel import sharding
from pbrlab_tpu_torch.render import graphs
from pbrlab_tpu_torch.render import integrator as tint
from pbrlab_tpu_torch.render.progressive import ProgressiveRenderer
from pbrlab_tpu_torch.scene.demo import build_demo_scene
from pbrlab_tpu_torch.scene.scene import build_fat_tables, scene_from_numpy
from pbrlab_tpu_torch.utils import profiling
from torch_scenes import textured_scene
from torch_threads import one_torch_thread  # noqa: F401

W = H = 16
SPP = 4
SEED = 7
MAX_STEPS = 6
BAND = 1e-4  # of the largest JAX entry (tests/test_torch_gradients.py)
TAPE_BAND = 1e-6  # of the largest checkpoint-tape entry
SCENES = {  # tests/test_goldens.py:25-41
    "lambert": dict(subdiv=1, lambert_only=True),
    "ggx": dict(subdiv=1, with_lucy=False),
    "sss": dict(subdiv=1, with_monkey=False),
}
# name: (scene, k_volume, sort_every, gradient)
RUNS = {
    "lambert": ("lambert", 0, 2, False),
    "ggx": ("ggx", 0, 2, False),
    "ggx-k2": ("ggx", 2, 2, False),  # substeps, but no lane ever walks
    "sss": ("sss", 2, 2, False),
    "sss-sort3": ("sss", 2, 3, False),
    "sss-grad": ("sss", 2, 2, True),
}
HOST_READS = ("__bool__", "__int__", "__float__", "item", "tolist", "numpy")
HOST_DATA = ((torch, "tensor"), (torch, "as_tensor"), (torch, "from_numpy"),
             (torch.Tensor, "new_tensor"))
TRACES = ("trace_scene", "trace_scene_dual", "occluded_scene")
BUFFERS = ("packed", "keys", "lane", "probe", "occ", "out", "x", "g", "g_out")


def _program(phase):
    fn = phase.func if isinstance(phase, functools.partial) else phase
    return fn.__self__


def _addresses(prog):
    out = {b: getattr(prog, b).data_ptr() for b in BUFFERS
           if getattr(prog, b, None) is not None}
    out.update({("grads", k): g.data_ptr()
                for k, g in (prog.grads or {}).items()})
    out.update({path: t.data_ptr() for path, t in tint._tensors(prog.scene)})
    return out


class WatchingRunner(graphs.EagerRunner):
    """Runs each phase op by op, recording the phases and reads in order,
    every host read a phase makes, and the phases that moved one of the
    program's buffers."""

    def __init__(self):
        self.events = []
        self.moved = []
        self.violations = []
        self.watching = False
        self.seen = {}  # buffer addresses at the first phase

    def run(self, name, phase):
        prog = _program(phase)
        before = _addresses(prog)
        for key, ptr in before.items():
            if self.seen.setdefault(key, ptr) != ptr:
                self.moved.append((name, key))
        self.events.append(("run", name))
        self.watching = True
        try:
            phase()
        finally:
            self.watching = False
        if _addresses(prog) != before:
            self.moved.append(name)

    def read(self, probe):
        value = super().read(probe)
        self.events.append(("read", value))
        return value


@pytest.fixture(scope="module")
def scenes():
    return {name: build_fat_tables(scene_from_numpy(
        build_demo_scene(**kw)[0], "cpu")) for name, kw in SCENES.items()}


def with_leaves(scene, keys=sharding.GRAD_KEYS + sharding.SCENE_KEYS):
    """(scene copy without fat tables, {key: leaf}): each key a fresh
    leaf that requires grad."""
    s = {k: v for k, v in scene.items() if k not in tint.FAT_KEYS}
    mats = s["materials"] = dict(scene["materials"])
    leaves = {}
    for key in keys:
        src = mats if key in mats else s
        leaves[key] = src[key] = src[key].detach().clone().requires_grad_()
    return s, leaves


def _run(scene, k_volume, sort_every, grad, programs):
    """RUNS entry -> the image (the gradients' loss image with grad)."""
    if not grad and sort_every == 2:
        return tint.render_scan(scene, W, H, SPP, seed=SEED,
                                max_steps=MAX_STEPS, k_volume=k_volume,
                                programs=programs)
    if not grad:
        with torch.no_grad():
            return sum(tint.render_lanes(scene, W, H, i, SEED, MAX_STEPS,
                                         sort_every=sort_every,
                                         k_volume=k_volume,
                                         programs=programs)
                       for i in range(SPP))
    s, leaves = with_leaves(scene)
    img = tint.render_lanes(s, W, H, 1, SEED, MAX_STEPS, remat=True,
                            k_volume=k_volume, programs=programs)
    loss = ((img - 0.25) ** 2).sum()
    grads = torch.autograd.grad(loss, list(leaves.values()),
                                allow_unused=True)
    return img.detach(), dict(zip(leaves, grads))


@pytest.fixture(scope="module")
def watched(scenes):
    """name -> (runner, result) of each RUNS entry through a
    WatchingRunner, host reads inside a phase recorded."""
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
        for attr in TRACES:
            fn = getattr(tint, attr)

            def unwatched(*a, _fn=fn, **k):
                watching, runner.watching = runner.watching, False
                try:
                    return _fn(*a, **k)
                finally:
                    runner.watching = watching

            mp.setattr(tint, attr, unwatched)
        for name, (scene, k_volume, sort_every, grad) in RUNS.items():
            runner = WatchingRunner()
            programs = graphs.Programs(runner=lambda: runner)
            result = _run(scenes[scene], k_volume, sort_every, grad,
                          programs)
            out[name] = runner, result, programs
            runner = None
    return out


@pytest.mark.parametrize("name", sorted(RUNS))
def test_scan_phases_read_no_device_value(watched, name):
    runner = watched[name][0]
    assert runner.violations == []
    assert any(kind == "run" for kind, _ in runner.events)


@pytest.mark.parametrize("name", sorted(RUNS))
def test_scan_phases_keep_buffer_addresses(watched, name):
    runner, _, programs = watched[name]
    assert runner.moved == []
    assert len(programs.programs) == 1
    if RUNS[name][3]:
        assert ("grads", "mat_fat") in runner.seen


def _jax_order(reads, k_volume, sort_every, grad, samples):
    """The phases the JAX body takes given the host's reads."""
    reads = list(reads)
    runs = []
    walked = []
    for _ in range(samples):
        runs.append("I")
        walked = []
        for depth in range(MAX_STEPS):
            runs.append("S")
            walked.append(bool(k_volume) and bool(reads.pop(0)))
            if walked[-1]:
                runs.append("V")
            if (depth + 1) % sort_every == 0:
                runs.append("C")
        runs.append("F")
    if grad:
        runs.append("F-grad")
        for depth in reversed(range(MAX_STEPS)):
            runs.append("G" + "-V" * walked[depth]
                        + "-C" * ((depth + 1) % sort_every == 0))
    return runs, reads


@pytest.mark.parametrize("name", sorted(RUNS))
def test_scan_phase_order_is_the_jax_body(watched, name):
    runner = watched[name][0]
    _, k_volume, sort_every, grad = RUNS[name]
    reads = [v for kind, v in runner.events if kind == "read"]
    want, left = _jax_order(reads, k_volume, sort_every, grad,
                            1 if grad else SPP)
    got = [v for kind, v in runner.events if kind == "run"]
    assert got == want and left == []
    assert len(reads) == (k_volume > 0) * MAX_STEPS * (1 if grad else SPP)
    if name.startswith("sss"):  # SSS lanes walk
        assert "V" in got
    elif k_volume:  # no SSS material: the substeps are skipped
        assert "V" not in got and set(reads) == {0}


@pytest.mark.parametrize("name", sorted(SCENES))
def test_scan_program_gives_render_bits(scenes, watched, name):
    """render_scan through the program is `render`'s image to the bit
    (tests/test_torch_render_scan.py holds it to the goldens)."""
    scan = watched[name][1]
    want = tint.render(scenes[name], W, H, SPP, seed=SEED,
                       max_steps=MAX_STEPS, k_volume=RUNS[name][1])
    assert scan.abs().sum() > 0 and torch.equal(scan, want)


def test_sort_every_changes_no_bit(watched):
    """sort_every 3 (another compaction schedule, another program) gives
    the render_scan sum of sort_every 2."""
    img3 = watched["sss-sort3"][1].reshape(H, W, 3)
    assert torch.equal(tint._mean(img3, SPP), watched["sss"][1])


# --- a fake torch.cuda whose graphs replay what their capture ran ------


class Recorder(TorchDispatchMode):
    """Records each aten op a capture runs (op, arguments, outputs); an
    opaque call (`opaque`) is recorded as one node. Storages that existed
    before the capture and that an op writes are saved first and put back
    when the capture ends: a real capture records and does not run."""

    active = None

    def __init__(self, nodes):
        super().__init__()
        self.nodes = nodes
        self.paused = False
        self.fresh = set()  # storages the capture made
        self.saved = {}  # storages it wrote that existed before

    def made(self, out, args):
        """Mark the storages `out` allocated: not those of its inputs (a
        view or an in-place result)."""
        inputs = {t.untyped_storage().data_ptr() for t in _leaves(args)}
        for t in _leaves(out):
            ptr = t.untyped_storage().data_ptr()
            if ptr not in inputs:
                self.fresh.add(ptr)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if not self.paused:
            for i, spec in enumerate(func._schema.arguments):
                arg = args[i] if i < len(args) else kwargs.get(spec.name)
                if (spec.alias_info is not None and spec.alias_info.is_write
                        and torch.is_tensor(arg)):
                    st = arg.untyped_storage()
                    if (st.data_ptr() not in self.fresh
                            and st.data_ptr() not in self.saved):
                        self.saved[st.data_ptr()] = (st, st.clone())
        out = func(*args, **kwargs)
        if not self.paused:
            self.nodes.append((func, args, kwargs, out))
            self.made(out, (args, kwargs))
        return out

    def restore(self):
        for st, copy in self.saved.values():
            st.copy_(copy)


def _leaves(tree):
    if torch.is_tensor(tree):
        yield tree
    elif isinstance(tree, (tuple, list)):
        for x in tree:
            yield from _leaves(x)
    elif isinstance(tree, dict):
        for x in tree.values():
            yield from _leaves(x)


def _into(out, res):
    """Write a replayed node's results into its captured outputs."""
    if torch.is_tensor(out):
        if res is not out:
            out.copy_(res)
    elif isinstance(out, (tuple, list)):
        for o, r in zip(out, res):
            _into(o, r)
    elif isinstance(out, dict):
        for k in out:
            _into(out[k], res[k])


def opaque(fn):
    """A trace call: one node of a capture (its twin walks with host
    tests, which a real capture records as one kernel)."""
    @functools.wraps(fn)
    def call(*a, **k):
        rec = Recorder.active
        if rec is None or rec.paused:
            return fn(*a, **k)
        rec.paused = True
        try:
            out = fn(*a, **k)
        finally:
            rec.paused = False
        rec.nodes.append((fn, a, k, out))
        rec.made(out, (a, k))
        return out

    return call


class ReplayGraph:
    def __init__(self, keep_graph=False):
        assert keep_graph
        self.nodes = []
        self.replays = 0

    def instantiate(self):
        pass

    def replay(self):
        with torch.no_grad():
            for fn, a, k, out in self.nodes:
                _into(out, fn(*a, **k))
        self.replays += 1


class InstantEvent:
    """torch.cuda.Event's stand-in: complete once recorded, no time
    between two (the graph runner times its replays with pairs)."""

    def __init__(self, enable_timing=False):
        pass

    def record(self, stream=None):
        pass

    def query(self):
        return True

    def elapsed_time(self, end):
        return 0.0


class ReplayCuda:
    CUDAGraph = ReplayGraph
    Event = InstantEvent

    def __init__(self):
        self.captures = []

    def graph_pool_handle(self):
        return ("pool",)

    @contextlib.contextmanager
    def graph(self, graph, pool):
        assert pool == ("pool",)
        self.captures.append(graph)
        rec = Recorder(graph.nodes)
        Recorder.active = rec
        try:
            with rec:
                yield
        finally:
            Recorder.active = None
            rec.restore()


class ReplayRunner(graphs.GraphRunner):
    """`GraphRunner` on a `ReplayCuda`; reads the probe of a CPU program
    as `EagerRunner` does (its pinned word needs a card)."""

    read = graphs.EagerRunner.read


@pytest.fixture
def replaying(monkeypatch):
    """(ReplayCuda, Programs whose programs run through GraphRunners on
    it); the trace calls opaque."""
    for attr in TRACES:
        monkeypatch.setattr(tint, attr, opaque(getattr(tint, attr)))
    cuda = ReplayCuda()
    return cuda, graphs.Programs(runner=lambda: ReplayRunner(cuda))


def _captures(cuda):
    return len(cuda.captures)


@pytest.mark.parametrize("name", ["lambert", "sss"])
def test_replayed_scan_gives_eager_bits(scenes, watched, replaying, name,
                                       monkeypatch):
    """render_scan through replayed captures: the eager loop's image to
    the bit (sample 0's phases captured with sample 1's ids would render
    sample 1 again), each phase captured once across the samples and
    replayed after."""
    cuda, programs = replaying
    monkeypatch.setattr(profiling, "RECORDER", profiling.Recorder())
    profiling.RECORDER.on = True
    img = _run(scenes[name], RUNS[name][1], 2, False, programs)
    assert torch.equal(img, watched[name][1])
    prog, = programs.programs.values()
    phases = profiling.records()[-1]["phases"]  # the render request's
    warm = prog.runner.warm
    assert _captures(cuda) == len(prog.runner.graphs) == len(warm)
    # a warm-up, then a capture and its replay, then replays
    assert phases["I"]["replays"] == SPP - 1
    assert phases["S"]["replays"] == SPP * MAX_STEPS - 1
    # a second call captures nothing new
    img2 = tint.render_scan(scenes[name], W, H, SPP, seed=SEED,
                            max_steps=MAX_STEPS, k_volume=RUNS[name][1],
                            programs=programs)
    assert torch.equal(img2, img) and _captures(cuda) == len(warm)
    # another seed rides in the keys buffer: the eager image of seed 8
    other = tint.render_scan(scenes[name], W, H, 2, seed=SEED + 1,
                             max_steps=MAX_STEPS, k_volume=RUNS[name][1],
                             programs=programs)
    want = tint.render_scan(scenes[name], W, H, 2, seed=SEED + 1,
                            max_steps=MAX_STEPS, k_volume=RUNS[name][1])
    assert torch.equal(other, want) and _captures(cuda) == len(warm)


def test_replayed_progressive_passes_and_edit(replaying):
    """A progressive renderer on replayed captures: each pass is
    `render_sample` of its number, an edit between passes changes the
    image as on a fresh scene and captures nothing new."""
    cuda, programs = replaying
    scene_np, builder = build_demo_scene(subdiv=1, with_monkey=False)
    scene = scene_from_numpy(scene_np, "cpu")
    kw = dict(seed=SEED, max_steps=MAX_STEPS, k_volume=2)
    r = ProgressiveRenderer(scene, W, H, material_names=builder.materials
                            .names, **kw)
    r.programs = programs
    for i in range(3):
        prev = r.accum.copy()
        r.step()
        want = tint.render_sample(scene, W, H, i, **kw).numpy()
        assert np.array_equal(r.accum, prev + want)
    prog, = programs.programs.values()
    captured = _captures(cuda)
    assert captured == len(prog.runner.graphs) >= 4
    r.queue_edit("Wall_White", "base_color", (0.1, 0.9, 0.1))
    for i in range(2):
        r.step()
    edited = {**scene, "materials": r.scene["materials"]}
    want = sum(tint.render_sample(edited, W, H, i, **kw).numpy()
               for i in range(2))
    assert r.num_passes == 2 and np.array_equal(r.accum, want)
    assert not np.array_equal(r.accum, prev)
    assert _captures(cuda) == captured and len(programs.programs) == 1


def test_replayed_train_steps(replaying):
    """The train step's gradient passes through replayed captures of the
    forward and the per-depth backward: the losses and scenes of the
    op-by-op step to the bit, over calls that capture nothing new."""
    cuda, programs = replaying
    scene = scene_from_numpy(textured_scene("pbrlab_tpu_torch"), "cpu")
    mesh = sharding.make_mesh(2, "cpu")
    dim = {**scene, "texture_atlas": scene["texture_atlas"] * 0.5}
    target = sharding.render_sharded(dim, 8, 8, 1, mesh, max_steps=4)
    runs = {}
    for kind in ("eager", "replayed"):
        step = sharding.train_step_builder(8, 8, 1, mesh, max_steps=4,
                                           lr=0.2)
        if kind == "replayed":
            step.programs._runner = programs._runner
        s, losses = scene, []
        for _ in range(3):
            loss, s = step(s, target)
            losses.append(float(loss))
            if kind == "replayed" and len(losses) == 2:
                captured = _captures(cuda)
        runs[kind] = losses, s, step.programs
    assert runs["replayed"][0] == runs["eager"][0]
    assert runs["eager"][0][-1] < runs["eager"][0][0]
    for key in ("texture_atlas", "face_emission"):
        assert torch.equal(runs["replayed"][1][key], runs["eager"][1][key])
    prog, = runs["replayed"][2].programs.values()
    assert any(name.startswith("G") for name in prog.runner.graphs)
    assert "F-grad" in prog.runner.graphs
    assert _captures(cuda) == captured


# --- gradients of the per-depth backward --------------------------------


@pytest.fixture(scope="module")
def lambert_np():
    return build_demo_scene(subdiv=1, lambert_only=True)[0]


@pytest.fixture(scope="module")
def jax_lambert_grads(lambert_np):
    """jax.grad of sum(render_sample(8x8, sample 0, max_steps 6)) in
    base_color and an emission scale (tests/test_integrator.py:68-100).
    JAX is imported here: the card runs this file's requires_cuda test
    where JAX is not installed."""
    import jax
    import jax.numpy as jnp

    from pbrlab_tpu.render.integrator import render_sample as jrender_sample
    from pbrlab_tpu.scene.scene import scene_to_device as jscene_to_device

    sj = jscene_to_device(lambert_np)

    def loss(base_color, scale):
        s = dict(sj)
        s["materials"] = {**s["materials"], "base_color": base_color}
        s["face_emission"] = s["face_emission"] * scale
        return jnp.sum(jrender_sample(s, 8, 8, jnp.uint32(0), max_steps=6))

    g = jax.jit(jax.grad(loss, argnums=(0, 1)))(
        sj["materials"]["base_color"], jnp.float32(1.0))
    return tuple(np.asarray(x) for x in g)


def _lambert_loss(lambert_np, base_color, scale, remat=True):
    s = scene_from_numpy(lambert_np, "cpu")
    s["materials"] = {**s["materials"], "base_color": base_color}
    s["face_emission"] = s["face_emission"] * scale
    return tint.render_lanes(s, 8, 8, 0, max_steps=6, remat=remat).sum()


def test_per_depth_gradients_match_jax(lambert_np, jax_lambert_grads):
    base = torch.from_numpy(lambert_np["materials"]["base_color"].copy())
    base.requires_grad_()
    scale = torch.tensor(1.0, requires_grad=True)
    got = torch.autograd.grad(_lambert_loss(lambert_np, base, scale),
                              [base, scale])
    for g, want in zip(got, jax_lambert_grads):
        g = g.numpy()
        assert np.isfinite(g).all() and np.abs(g).sum() > 0.0
        err = np.abs(g - want)
        assert (err <= BAND * np.abs(want).max() + 1e-6).all(), err.max()


def test_per_depth_emission_gradient_matches_fd(lambert_np):
    """d sum(img) / d emission scale against central differences (eps
    1e-2, rtol 1e-2: emission enters linearly); the differences run the
    forward program."""
    base = torch.from_numpy(lambert_np["materials"]["base_color"].copy())
    x = torch.tensor(1.0, requires_grad=True)
    g = float(torch.autograd.grad(_lambert_loss(lambert_np, base, x),
                                  [x])[0])
    with torch.no_grad():
        fd = (float(_lambert_loss(lambert_np, base, torch.tensor(1.01)))
              - float(_lambert_loss(lambert_np, base,
                                    torch.tensor(0.99)))) / 0.02
    assert abs(fd) > 1e-7
    np.testing.assert_allclose(g, fd, rtol=1e-2, atol=1e-5)


@pytest.mark.parametrize("name", ["demo", "textured"])
def test_per_depth_gradients_match_checkpoint_tape(name):
    """The program's per-depth backward against the `torch.utils.
    checkpoint` tape it replaces, on the eight leaves of the train step:
    the same image, gradients within 1e-6 of the largest entry (the CPU
    adds in one order: equal to the bit here)."""
    if name == "demo":
        scene = scene_from_numpy(build_demo_scene(subdiv=1)[0], "cpu")
    else:
        scene = scene_from_numpy(textured_scene("pbrlab_tpu_torch"), "cpu")
    out = {}
    for kind in ("program", "tape"):
        s, leaves = with_leaves(scene)
        if kind == "program":
            img = tint.render_lanes(s, 8, 8, 0, seed=3, max_steps=6,
                                    remat=True, k_volume=2)
        else:
            img = tint._render_lanes_tape(build_fat_tables(s), 8, 8, 0, 3,
                                          6, None, True, 2, 2, None)
        loss = ((img - 0.25) ** 2).sum()
        out[kind] = img.detach(), dict(zip(leaves, torch.autograd.grad(
            loss, list(leaves.values()), allow_unused=True)))
    assert torch.equal(out["program"][0], out["tape"][0])
    for key, want in out["tape"][1].items():
        got = out["program"][1][key]
        if want is None:
            assert got is None and key == "texture_atlas"
            continue
        assert torch.isfinite(got).all()
        assert (got - want).abs().max() <= TAPE_BAND * want.abs().max()


def test_train_step_keeps_its_program():
    """The train step makes its program on the first call and keeps it:
    one program across steps and shards of one device."""
    scene = scene_from_numpy(textured_scene("pbrlab_tpu_torch"), "cpu")
    step = sharding.train_step_builder(8, 8, 1, sharding.make_mesh(2, "cpu"),
                                       max_steps=4)
    s = scene
    for _ in range(2):
        _, s = step(s, torch.zeros((8, 8, 3)))
        progs = list(step.programs.programs.values())
        assert len(progs) == 1
    assert progs[0].grads is not None


def test_preview_demo_script(tmp_path):
    """scripts/torch_preview_demo.py at 16x16 on the CPU: a progressive
    render behind the preview server, an HTTP edit mid-render, before and
    after PNGs that differ."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {**os.environ, "PYTHONPATH": root}
    proc = subprocess.run(
        [sys.executable, os.path.join(root, "scripts",
                                      "torch_preview_demo.py"),
         str(tmp_path), "--device", "cpu", "--size", "16", "--subdiv", "1"],
        capture_output=True, text=True, timeout=300, env=env)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "ok"
    for name in ("before.png", "after.png"):
        data = (tmp_path / name).read_bytes()
        assert data[:8] == b"\x89PNG\r\n\x1a\n" and len(data) > 100


@pytest.mark.requires_cuda
def test_graphed_scan_and_gradient_equal_eager():
    """On the card: render_scan 32x32x2 of the SSS cornellbox (k_volume
    3) through CUDA graphs against the same program op by op, every bit
    and launch count equal; the gradient pass at 32x32x1 (remat=True):
    the same image and loss, gradients within 1e-4 of the largest eager
    entry (the backward's index_add_ atomics order the sums anew)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (graphs capture CUDA kernels)")
    scene = scene_from_numpy(build_demo_scene(subdiv=3)[0], "cuda")
    out = {}
    for kind in ("graphs", "eager"):
        programs = graphs.Programs(runner=None if kind == "graphs"
                                   else graphs.EagerRunner)
        mark = max([r["id"] for r in profiling.records()], default=0)
        for c in graphs.COUNTERS.values():
            for k in c:
                c[k] = 0
        img = tint.render_scan(scene, 32, 32, 2, seed=SEED, max_steps=12,
                               k_volume=3, programs=programs)
        launches = {(m, k): v for m, c in graphs.COUNTERS.items()
                    for k, v in c.items()}
        s, leaves = with_leaves(scene)
        g_img = tint.render_lanes(s, 32, 32, 0, SEED, 12, remat=True,
                                  k_volume=3, programs=programs)
        loss = ((g_img - 0.25) ** 2).sum()
        grads = torch.autograd.grad(loss, list(leaves.values()),
                                    allow_unused=True)
        out[kind] = (img.cpu(), launches, g_img.detach().cpu(),
                     loss.detach().cpu(), dict(zip(leaves, grads)))
        if kind == "graphs":  # the render_scan request replayed
            phases = next(r for r in profiling.records(since=mark)
                          if r["name"] == "render")["phases"]
            assert any(st["replays"] for st in phases.values())
    g, e = out["graphs"], out["eager"]
    assert torch.equal(g[0], e[0]) and g[1] == e[1] and g[0].sum() > 0
    assert torch.equal(g[2], e[2]) and torch.equal(g[3], e[3])
    for key, want in e[4].items():
        got = g[4][key]
        if want is None:
            assert got is None
            continue
        assert (got - want).abs().max() <= 1e-4 * want.abs().max() + 1e-6
