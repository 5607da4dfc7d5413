"""The harness's arithmetic: rates and percentiles over every request of
the window, the trace kernels' bytes, the trace reduction, and the check
for JAX modules by whole top-level name."""
import statistics
from types import SimpleNamespace

import pytest

from pbh import common, gradref, roofline, runner, tracing


def test_rate_is_all_work_over_all_time():
    """samples_per_s takes every render's samples over the window's whole
    time: not a mean of per-render rates."""
    window = {"samples": 5 * 4 * 1024 * 1024, "seconds": 26.5}
    got = runner.reader("samples_per_s")(SimpleNamespace(window=window))
    assert got == pytest.approx(5 * 4 * 1024 * 1024 / 26.5 / 1e6)
    walls = [4.0, 4.5, 9.0, 4.5, 4.5]  # one slow render
    per_render = statistics.mean(4 * 2 ** 20 / w for w in walls) / 1e6
    assert got != pytest.approx(per_render)


def test_step_time_is_window_over_steps():
    run = SimpleNamespace(window={"steps": 7, "seconds": 35.7})
    assert runner.reader("grad_step_s")(run) == pytest.approx(5.1)


def test_percentile_over_every_pass():
    """p90 by nearest rank over all passes, edit passes included: not a
    median of chunks' percentiles."""
    ms = [400.0] * 90 + [500.0 + i for i in range(10)]
    run = SimpleNamespace(window={"pass_ms": ms})
    assert runner.reader("preview_p90_ms")(run) == 400.0
    ms = ms + [900.0]  # 101 passes: rank ceil(90.9) = 91
    run = SimpleNamespace(window={"pass_ms": ms})
    assert runner.reader("preview_p90_ms")(run) == 500.0
    assert common.nearest_rank([3, 1, 2], 1.0) == 3
    assert common.nearest_rank([5], 0.9) == 5
    chunks = [common.nearest_rank(ms[i:i + 10], 0.9)
              for i in range(0, 100, 10)]
    # a median of chunks' percentiles would read 400 here
    assert statistics.median(chunks) == 400.0


def test_edit_pass_mean():
    run = SimpleNamespace(window={"edit_pass_ms": [600.0, 700.0]})
    assert runner.reader("edit_pass_ms.preview")(run) == 650.0
    assert runner.reader("edit_pass_ms.preview")(
        SimpleNamespace(window={})) is None


def test_trace_bytes():
    """Rays from the grid at 128 threads, 48 bytes a ray (+21 for a dual's
    shadow query), the backend's tables once a launch."""
    tables = {"dense_tris_v4": 12 * 3904 * 4, "dense_cluster_aabb_v4":
              8 * 122 * 4, "v5_node_aabb": 6 * 243 * 4,
              "v5_node_meta": 2 * 243 * 4, "dense_tris_v5l": 100}
    dual = "void (anonymous namespace)::v4_kernel<false, true>(Params)"
    single = "void (anonymous namespace)::v4_kernel<false, false>(Params)"
    v5l = "void (anonymous namespace)::v5l_kernel<true>(Params)"
    assert roofline.launch_bytes(dual, [512, 1, 1], tables) == \
        512 * 128 * 69 + 12 * 3904 * 4 + 8 * 122 * 4
    assert roofline.launch_bytes(single, [192, 1, 1], tables) == \
        192 * 128 * 48 + 12 * 3904 * 4 + 8 * 122 * 4
    assert roofline.launch_bytes(v5l, [512, 1, 1], tables) == \
        512 * 128 * 48 + 100 + 6 * 243 * 4 + 2 * 243 * 4
    assert roofline.launch_bytes("void at::native::mul_kernel",
                                 [512, 1, 1], tables) is None
    kernels = [{"name": dual, "dur": 200.0, "grid": [512, 1, 1]},
               {"name": "void at::native::mul_kernel", "dur": 5.0,
                "grid": [1, 1, 1]}]
    bound, spent = roofline.bound_share(kernels, tables)
    assert spent == pytest.approx(200e-6)
    assert bound == pytest.approx(roofline.launch_bytes(
        dual, [512, 1, 1], tables) / 3.35e12)
    share = runner.reader("trace_roofline")(SimpleNamespace(
        slice={"kernels": kernels}, table_bytes=tables))
    assert 0 < share < 100
    assert runner.reader("trace_roofline")(SimpleNamespace(
        slice={"kernels": kernels[1:]}, table_bytes=tables)) is None


def _ev(cat, name, ts, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "tid": args.pop("tid", 1), "args": args}


def test_trace_reduction():
    events = [
        _ev("cpu_op", "aten::mul", 0, 10),
        _ev("cuda_runtime", "cudaLaunchKernel", 2, 1, correlation=1),
        _ev("kernel", "k1", 5, 10, correlation=1, grid=[1, 1, 1]),
        _ev("kernel", "k2", 12, 8, correlation=2, grid=[1, 1, 1]),
        _ev("cpu_op", "autograd::engine::evaluate_function: "
            "_LanesGradBackward", 30, 40, tid=2),
        _ev("cuda_runtime", "cudaGraphLaunch", 32, 1, correlation=3, tid=2),
        _ev("kernel", "k3", 50, 10, correlation=3, grid=[1, 1, 1]),
        _ev("gpu_memcpy", "Memcpy", 100, 5, correlation=4),
    ]
    red = tracing.reduce_trace(events)
    assert red["busy_s"] == pytest.approx((15 + 10 + 5) * 1e-6)
    assert len(red["kernels"]) == 3
    gaps = red["idle_gaps"]
    assert gaps[0][1] == pytest.approx(40e-6)  # 60 -> 100
    assert gaps[1] == ["autograd::engine::evaluate_function: "
                       "_LanesGradBackward", pytest.approx(30e-6)]
    assert tracing.busy_within(red, "_LanesGradBackward") == \
        pytest.approx(10e-6)
    assert tracing.busy_within(red, "nothing") is None
    run = SimpleNamespace(slice={**red, "window_s": 240e-6,
                                 "untraced_s": 120e-6, "subiters": 2})
    # busy over the wall of the same slice run without the profiler
    assert runner.reader("device_idle_share.render")(run) == \
        pytest.approx(75.0)
    assert runner.reader("step_kernels_per_subiter.render")(run) == 1.5


def test_idle_gaps_of_a_device_only_trace():
    """Traced with device activity only, a gap is named by the runtime
    call open at its middle, or by the last one that ended before it."""
    events = [
        _ev("cuda_runtime", "cudaGraphLaunch", 0, 2, correlation=1),
        _ev("kernel", "k1", 3, 10, correlation=1, grid=[1, 1, 1]),
        _ev("cuda_runtime", "cudaStreamSynchronize", 14, 30),
        _ev("kernel", "k2", 40, 10, correlation=2, grid=[1, 1, 1]),
        _ev("cuda_runtime", "cudaLaunchKernel", 55, 1, correlation=3),
        _ev("kernel", "k3", 100, 10, correlation=3, grid=[1, 1, 1]),
    ]
    red = tracing.reduce_trace(events)
    assert red["idle_gaps"] == [
        ["host after cudaLaunchKernel", pytest.approx(50e-6)],
        ["cudaStreamSynchronize", pytest.approx(27e-6)]]
    assert red["busy_s"] == pytest.approx(30e-6)


@pytest.mark.parametrize("name", ["device_idle_share.render",
                                  "device_idle_share.grad",
                                  "device_idle_share.preview"])
def test_one_reader_serves_a_name_prefix(name):
    assert runner.reader(name) is runner.reader("device_idle_share")
    with pytest.raises(KeyError):
        runner.reader("no_such_metric.render")


def test_device_memory_reading():
    run = SimpleNamespace(window={"device_used_bytes": 3 * 2 ** 30})
    assert runner.reader("grad_peak_mem_gib")(run) == 3.0
    assert runner.reader("grad_peak_mem_gib")(
        SimpleNamespace(window={})) is None


def test_gradient_gaps():
    """The worst of the gaps is NaN where one is (a control with no number
    fails); a step's gap compares the gradient as the optimizer got it
    from the same leaves, by the worst leaf's gap of norms."""
    import math

    assert math.isnan(gradref.worst([1e-5, float("nan"), 2.0]))
    assert math.isnan(gradref.worst([float("nan"), 1e-5]))
    assert gradref.worst([1e-5, 3e-5]) == 3e-5
    import numpy as np

    def arrays(**kw):
        return {k: np.asarray(v) for k, v in kw.items()}
    before = arrays(a=[1.0, 1.0], b=[2.0, 0.0], c=[1e-9, 0.0])
    ref_grad = arrays(a=[1.0, 0.0], b=[0.0, 2.0], c=[0.0, 0.0])
    ref_after = arrays(a=[0.9, 1.0], b=[2.0, -0.2], c=[1e-9, 0.0])
    prog_after = arrays(a=[0.9, 1.0], b=[2.0, -0.22], c=[5.0, 0.0])
    loss_gap, grad_gap = gradref.step_numbers(
        10.5, before, prog_after, 10.0, ref_after, ref_grad, 0.1)
    assert loss_gap == pytest.approx(0.05)
    # "c" has no reference gradient and is left out; "b" is 10% off
    assert grad_gap == pytest.approx(0.1)


@pytest.mark.parametrize("modules,bad", [
    (["pbrlab_tpu_torch", "pbrlab_tpu_torch.render.integrator", "torch",
      "jaxtyping", "flax_like", "numpy"], []),
    (["jax", "jax.numpy"], ["jax"]),
    (["jaxlib.xla_client"], ["jaxlib"]),
    (["flax.linen"], ["flax"]),
    (["pbrlab_tpu.scene.demo", "pbrlab_tpu_torch"], ["pbrlab_tpu"]),
])
def test_forbidden_modules_by_whole_top_level_name(modules, bad):
    assert common.forbidden_modules(modules) == bad
