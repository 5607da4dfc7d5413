"""The port's span recorder (`utils.profiling`) and what the program
records with it: spans nest into requests, each with its request and its
parent; the ring keeps its bound and counts what it drops; with
PBRLAB_TRACE=0 nothing is kept and a render keeps its bits; the graph
runner's spans and timing events (tests/torch_fakes.py's fake
`torch.cuda`); the fused and chain steps a request's phases make; an
eager render's request and its live-lane counter; a progressive pass
and its edit; a train step's forward and backward; the Chrome trace
exporter's clock. No JAX: the card
runs the requires_cuda test with `python -m pytest
tests/test_torch_tracing.py --noconftest -o addopts="" -m requires_cuda`.
"""
import contextlib
import json
import os
import time
from collections import Counter

import pytest
import torch

from pbrlab_tpu_torch.ops import dense_v4
from pbrlab_tpu_torch.parallel.sharding import train_step_builder
from pbrlab_tpu_torch.render import graphs
from pbrlab_tpu_torch.render import integrator as tint
from pbrlab_tpu_torch.render.progressive import ProgressiveRenderer
from pbrlab_tpu_torch.scene.demo import build_demo_scene
from pbrlab_tpu_torch.scene.scene import (build_fat_tables, scene_from_numpy,
                                          scene_to_device)
from pbrlab_tpu_torch.utils import profiling
from pbrlab_tpu_torch.utils.profiling import count, records, span
from torch_fakes import FakeCuda, FakeEvent
from torch_threads import one_torch_thread  # noqa: F401

W = H = 16
SPP = 4
SEED = 7
MAX_STEPS = 6


@pytest.fixture
def recorder(monkeypatch):
    """A fresh recorder for the test, the suite's given back after."""
    monkeypatch.delenv("PBRLAB_TRACE", raising=False)
    monkeypatch.setattr(profiling, "RECORDER", profiling.Recorder())
    return profiling.RECORDER


@pytest.fixture(scope="module")
def sss_scene():
    return build_fat_tables(scene_from_numpy(
        build_demo_scene(subdiv=1, with_monkey=False)[0], "cpu"))


def _names(rec):
    return Counter(s["name"] for s in rec["spans"])


def test_spans_nest_into_requests(recorder):
    with span("outer", size=3):
        count("items", 2)
        with span("inner"):
            with span("leaf"):
                count("items", 5)
        with span("inner"):
            pass
    count("items", 100)  # no request open: nothing
    with span("second"):
        pass
    first, second = records()
    assert first["name"] == "outer" and first["attrs"] == {"size": 3}
    assert first["counters"] == {"items": 7}
    assert second["name"] == "second" and second["counters"] == {}
    assert second["id"] > first["id"]
    spans = {s["id"]: s for s in first["spans"]}
    outer = next(s for s in spans.values() if s["name"] == "outer")
    assert outer["id"] == first["id"] and outer["parent"] == 0
    inners = [s for s in spans.values() if s["name"] == "inner"]
    leaf, = [s for s in spans.values() if s["name"] == "leaf"]
    assert [s["parent"] for s in inners] == [outer["id"], outer["id"]]
    assert leaf["parent"] == inners[0]["id"]
    for s in spans.values():  # children lie inside their parents
        if s["parent"]:
            p = spans[s["parent"]]
            assert p["t0_ns"] <= s["t0_ns"]
            assert s["t0_ns"] + s["dur_ns"] <= p["t0_ns"] + p["dur_ns"]
    # a request's clock is Unix time
    assert abs(first["t0_ns"] - time.time_ns()) < 60e9
    assert records(since=first["id"]) == [second]


def test_ring_keeps_its_bound_and_counts_drops(monkeypatch):
    rec = profiling.Recorder(capacity=5, max_requests=2)
    rec.on = True
    monkeypatch.setattr(profiling, "RECORDER", rec)
    for i in range(3):
        with span("request", i=i):
            with span("a"):
                pass
            with span("b"):
                pass
    # 9 spans into a ring of 5, 3 requests into a ring of 2
    assert profiling.dropped() == {"spans": 4, "requests": 1}
    got = records()
    assert [r["attrs"]["i"] for r in got] == [1, 2]
    assert len(got[0]["spans"]) == 2 and len(got[1]["spans"]) == 3
    assert len(rec.spans) == 5


def test_trace_off_records_nothing_and_keeps_the_bits(monkeypatch,
                                                      sss_scene):
    monkeypatch.setattr(profiling, "RECORDER", profiling.Recorder())
    on = tint.render(sss_scene, W, H, SPP, seed=SEED, max_steps=MAX_STEPS,
                     k_volume=2)
    assert [r["name"] for r in records()] == ["render"]
    monkeypatch.setenv("PBRLAB_TRACE", "0")
    profiling.reset()
    assert not profiling.RECORDER.on
    assert isinstance(span("x"), contextlib.nullcontext)
    off = tint.render(sss_scene, W, H, SPP, seed=SEED, max_steps=MAX_STEPS,
                      k_volume=2)
    with span("outer"):
        count("n", 1)
    assert records() == [] and profiling.dropped() == {"spans": 0,
                                                       "requests": 0}
    assert torch.equal(on, off)


def test_graph_runner_spans_and_event_pairs(recorder, monkeypatch):
    """Per phase: one warm-up, one capture and instantiation, a launch a
    replay, a read span per read; one timing pair around each warm-up and
    replay, resolved by the next read into the request's device ms, the
    pair of a run right after a read opened by the read's own event."""
    empty = torch.empty
    monkeypatch.setattr(torch, "empty", lambda *a, pin_memory=False, **k:
                        empty(*a, **k))  # no pinned memory without a card
    monkeypatch.setattr(FakeEvent, "made", 0)
    monkeypatch.setattr(FakeEvent, "clock", 0.0)  # one a record
    saved = dict(dense_v4.LAUNCHES)
    runner = graphs.GraphRunner(FakeCuda())
    probe = torch.tensor(3)
    try:
        with span("render"):
            for _ in range(4):
                runner.run("A", lambda: dense_v4.LAUNCHES.__setitem__(
                    "dual", dense_v4.LAUNCHES["dual"] + 1))
                assert runner.read(probe) == 3
            runner.run("F", lambda: None)
            runner.run("F", lambda: None)
            pending = len(profiling.RECORDER.pending)
    finally:
        dense_v4.LAUNCHES.update(saved)
    assert pending == 2  # F's warm-up and replay pairs, after the last read
    rec, = records()
    assert profiling.RECORDER.pending == []
    names = _names(rec)
    assert names["graphs.warmup"] == 2 and names["graphs.capture"] == 2
    assert names["graphs.instantiate"] == 2 and names["graphs.read"] == 4
    # A: a warm-up, then a capture replayed at once and two more replays
    assert names["graphs.launch"] == 4
    launches = [s["attrs"]["phase"] for s in rec["spans"]
                if s["name"] == "graphs.launch"]
    assert launches == ["A", "A", "A", "F"]
    a, f = rec["phases"]["A"], rec["phases"]["F"]
    assert a["replays"] == 3 and f["replays"] == 1
    # each pair is 1 ms apart on the fake clock
    assert a["device_ms"] == 3.0 and a["warmup_device_ms"] == 1.0
    assert f["device_ms"] == 1.0 and f["warmup_device_ms"] == 1.0
    assert rec["counters"]["device_ms.A"] == 3.0
    assert a["capture_s"] > 0 and a["warmup_s"] > 0
    # 6 pairs and 4 reads; the runs after 3 of the reads (A's last two
    # replays, F's warm-up) opened by the read's event, A's capture
    # having dropped the first read's: 6 * 2 + 4 - 3 records
    assert FakeEvent.clock == 13
    # from a pool: a read frees the pairs before it, so F's two pairs,
    # the one of them the last read's event, are all that were made
    assert FakeEvent.made == 4
    assert runner.warm == {"A", "F"}


def test_requests_count_their_fused_and_chain_steps(recorder, monkeypatch):
    """A request counts its phases' wavefront steps that ran fused and as
    the chain (`launches.step.fused` / `.chain`): a warm-up's and an eager
    run's as they happen, a replay's from its capture, none for the
    capture itself; no other launch counter goes into the request."""
    from pbrlab_tpu_torch.ops import step

    for module in (dense_v4, step):
        monkeypatch.setattr(module, "LAUNCHES", dict(module.LAUNCHES))
    monkeypatch.setitem(graphs.COUNTERS, "v4", dense_v4.LAUNCHES)
    monkeypatch.setitem(graphs.COUNTERS, "step", step.LAUNCHES)

    def phase():  # a fused step and its dual trace, then a chain step
        step.LAUNCHES["pre"] += 1
        step.LAUNCHES["fused"] += 1
        dense_v4.LAUNCHES["dual"] += 1
        step.LAUNCHES["chain"] += 1

    runner = graphs.GraphRunner(FakeCuda())
    with span("render"):
        for _ in range(4):  # a warm-up, a capture and replay, two replays
            runner.run("A", phase)
        graphs.EagerRunner().run("B", phase)
    rec, = records()
    assert {k: v for k, v in rec["counters"].items()
            if k.startswith("launches.")} == {"launches.step.fused": 5,
                                               "launches.step.chain": 5}
    assert step.LAUNCHES == {"pre": 5, "fused": 5, "chain": 5}


def test_eager_render_request_counts_its_lanes(recorder, sss_scene,
                                               monkeypatch):
    """The render request counts the sub-iterations `return_iters` gives,
    n_lanes a sub-iteration as lane slots, and as alive lanes the lanes
    entering every full step (counted here from the steps themselves)."""
    entering = []
    step = tint.wavefront_step

    def counting_step(scene, state, *a, freeze_surface=False, **k):
        if not freeze_surface:  # the loop steps its packed rows
            entering.append(int((state[:, 15] > 0.5).sum()))
        return step(scene, state, *a, freeze_surface=freeze_surface, **k)

    monkeypatch.setattr(tint, "wavefront_step", counting_step)
    _, it = tint.render_lanes_wavefront(sss_scene, W, H, SPP, SEED,
                                        MAX_STEPS, k_volume=2, n_lanes=100,
                                        return_iters=True)
    rec, = records()
    c = rec["counters"]
    assert rec["name"] == "render" and rec["attrs"]["spp"] == SPP
    assert c["subiters"] == it == len(entering)
    assert c["lane_slots"] == 100 * it
    assert c["lanes_alive"] == sum(entering)
    assert 0 < c["lanes_alive"] <= c["lane_slots"]
    names = _names(rec)
    assert names["graphs.eager"] > it and names["graphs.read"] > it
    assert set(rec["phases"]) >= {"A", "F"}


def test_entry_points_are_one_request(recorder, sss_scene):
    """`render` and `render_scan` are one `render` request each; inside
    another span they open none."""
    tint.render(sss_scene, 8, 8, 2, seed=SEED, max_steps=4)
    tint.render_scan(sss_scene, 8, 8, 2, seed=SEED, max_steps=4)
    with span("job"):
        tint.render(sss_scene, 8, 8, 1, seed=SEED, max_steps=4)
    got = records()
    assert [r["name"] for r in got] == ["render", "render", "job"]
    assert _names(got[0])["render"] == 1
    assert got[0]["counters"]["subiters"] > 0
    assert _names(got[1])["lanes.load"] == 2  # a load a sample
    assert got[2]["counters"]["subiters"] > 0


def test_progressive_edit_span_only_on_an_edit_pass(recorder):
    scene_np, builder = build_demo_scene(subdiv=1, lambert_only=True)
    r = ProgressiveRenderer(scene_to_device(scene_np, "cpu"), 8, 8,
                            material_names=builder.materials.names,
                            max_steps=4)
    r.step()
    r.queue_edit(builder.materials.names[0], "base_color", [0.2, 0.5, 0.3])
    r.step()
    r.step()
    passes = records()[-3:]
    assert [p["name"] for p in passes] == ["progressive.pass"] * 3
    assert all(p["attrs"]["renderer"] == id(r) for p in passes)
    assert [_names(p)["progressive.edit"] for p in passes] == [0, 1, 0]
    for p in passes:
        top = p["spans"][-1]["id"]  # the pass's own span closes last
        assert top == p["id"]
        load, = [s for s in p["spans"] if s["name"] == "lanes.load"]
        assert load["parent"] == p["id"]
    edit, = [s for s in passes[1]["spans"] if s["name"] == "progressive.edit"]
    tables = [s for s in passes[1]["spans"]
              if s["name"] == "scene.build_fat_tables"]
    assert [s["parent"] for s in tables] == [edit["id"]]
    assert r.pass_seconds == pytest.approx(passes[2]["dur_ns"] / 1e9,
                                           abs=0.05)


def test_train_step_records_forward_and_backward(recorder):
    scene = scene_from_numpy(build_demo_scene(subdiv=1,
                                              lambert_only=True)[0], "cpu")
    step = train_step_builder(8, 8, 1, [torch.device("cpu")], max_steps=3)
    step(scene, torch.zeros((8, 8, 3)))
    rec, = [r for r in records() if r["name"] == "train.step"]
    spans = {s["id"]: s for s in rec["spans"]}
    fwd, = [s for s in spans.values() if s["name"] == "lanes.forward"]
    bwd, = [s for s in spans.values() if s["name"] == "lanes.backward"]
    assert fwd["parent"] == bwd["parent"] == rec["id"]
    assert fwd["t0_ns"] + fwd["dur_ns"] <= bwd["t0_ns"]

    def under(s, top):
        while s["parent"] and s["id"] != top["id"]:
            s = spans[s["parent"]]
        return s["id"] == top["id"]
    phases = [s for s in spans.values() if s["name"] == "graphs.eager"]
    assert {s["attrs"]["phase"] for s in phases if under(s, bwd)} >= \
        {"F-grad"}
    assert any(s["attrs"]["phase"].startswith("G") for s in phases
               if under(s, bwd))
    assert {s["attrs"]["phase"] for s in phases if under(s, fwd)} >= \
        {"I", "S", "F"}


def _pbrlab_events(events, name):
    return [e for e in events if e.get("cat") == "pbrlab"
            and e["name"] == name]


def test_exporter_puts_spans_on_the_trace_clock(recorder, tmp_path):
    """A merged span lines up with the profiler's own record of the same
    block within 1 ms."""
    with profiling.trace(str(tmp_path)):
        with span("probe"):
            with torch.profiler.record_function("probe"):
                time.sleep(0.01)
    with open(os.path.join(tmp_path, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    ours, = _pbrlab_events(events, "probe")
    theirs, = [e for e in events if e.get("cat") == "user_annotation"
               and e["name"] == "probe"]
    assert abs(ours["ts"] - theirs["ts"]) < 1000
    assert abs(ours["ts"] + ours["dur"] - theirs["ts"] - theirs["dur"]) < 1000
    assert ours["args"]["parent"] == 0
    assert any(e.get("ph") == "M" and e["args"].get("name") == "pbrlab"
               for e in events)


@pytest.mark.requires_cuda
def test_span_brackets_its_kernel_on_the_card(tmp_path, monkeypatch):
    """On the card, in the merged trace: five spans, each around a sleep
    kernel and a synchronize, bracket the profiler's own host events of
    the two (its launch call and the synchronize's return) and the
    kernel's device event, and the closest of them lie within 50 us of
    the span's start and end: spans, host events and device events share
    the trace's clock to 50 us on both sides (the host's own time between
    a span's stamp and the call varies from call to call)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    monkeypatch.setattr(profiling, "RECORDER", profiling.Recorder())
    profiling.RECORDER.on = True
    torch.cuda._sleep(1000)  # load the kernel
    torch.cuda.synchronize()
    with profiling.trace(str(tmp_path)):
        for _ in range(5):
            with span("sleep"):
                torch.cuda._sleep(2_000_000)
                torch.cuda.synchronize()
    with open(os.path.join(tmp_path, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    ours = sorted(_pbrlab_events(events, "sleep"), key=lambda e: e["ts"])
    kernels = sorted((e for e in events if e.get("cat") == "kernel"
                      and "spin" in e["name"]), key=lambda e: e["ts"])
    runtime = [e for e in events if e.get("cat") == "cuda_runtime"]
    assert len(ours) == len(kernels) == 5
    leads, tails = [], []
    for sp, kernel in zip(ours, kernels):
        end = sp["ts"] + sp["dur"]
        launch, = [e for e in runtime if e.get("args", {}).get(
            "correlation") == kernel["args"]["correlation"]]
        sync = min((e for e in runtime if "Synchronize" in e["name"]
                    and e["ts"] > launch["ts"]), key=lambda e: e["ts"])
        leads.append(launch["ts"] - sp["ts"])
        tails.append(end - sync["ts"] - sync["dur"])
        assert sp["ts"] < kernel["ts"]
        assert kernel["ts"] + kernel["dur"] < end
        assert kernel["dur"] > 100
    print(f"span start to launch call {[round(t, 1) for t in leads]} us; "
          f"synchronize's return to span end {[round(t, 1) for t in tails]}"
          f" us")
    assert min(leads) >= 0 and min(tails) >= 0
    assert min(leads) < 50 and min(tails) < 50
