"""Chip smoke test of the PyTorch/CUDA port (pbrlab_tpu_torch) on one GPU.

    python3 chip_smoke.py

Builds the dense_v4 CUDA kernels from csrc/, checks each against its plain
torch version at the main path's shapes on the bench scene (the cornellbox
at subdiv=3), checks a small render on the card against the same render on
the CPU, then renders the bench scene at 512x512, 8 spp, max_steps=12,
k_volume=3 through the kernels and checks the image and the launch counts.
Exits non-zero, printing no result, on any failure or without a CUDA card.
The last lines are the kernels' JSON record, the card's name and power
limit, and {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 7
MAIN = dict(width=512, height=512, spp=8, max_steps=12, k_volume=3)
N_DUAL = 65536  # default n_lanes: every full step traces this many lanes
N_SINGLE = 24576  # default volume window (3/8 of the lanes): substeps 2-3
RTOL = 1e-5  # kernel vs plain: same float ops in the same order, no FMA


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps=20):
    """Median CUDA-event time of fn() in ms, after two warm-up calls."""
    for _ in range(2):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def check_hits(name, got, ref, occ=None, ref_occ=None):
    """Kernel vs plain version: equal hit masks (and occlusion), t/u/v
    within RTOL, prim equal where t is unique. Returns max |t| error."""
    hit = ref["prim"] >= 0
    if not torch.equal(got["prim"] >= 0, hit):
        raise AssertionError(f"{name}: hit masks differ")
    if occ is not None and not torch.equal(occ, ref_occ):
        raise AssertionError(f"{name}: occluded differs")
    for k in ("t", "u", "v"):
        torch.testing.assert_close(got[k][hit], ref[k][hit], rtol=RTOL,
                                   atol=1e-6, msg=f"{name}: {k} differs")
    same_t = got["t"] == ref["t"]
    bad = hit & same_t & (got["prim"] != ref["prim"])
    if bad.float().mean() > 1e-3:
        raise AssertionError(f"{name}: prim differs on {int(bad.sum())} lanes")
    return float((got["t"][hit] - ref["t"][hit]).abs().max())


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from pbrlab_tpu_torch.core.math import EPS, INF
    from pbrlab_tpu_torch.ops import dense_v4
    from pbrlab_tpu_torch.render.camera import generate_rays
    from pbrlab_tpu_torch.render.integrator import render, render_lanes_wavefront
    from pbrlab_tpu_torch.scene.demo import build_demo_scene
    from pbrlab_tpu_torch.scene.scene import scene_from_numpy

    dev = torch.device("cuda:0")
    card = card_line()
    # phase 1: card
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")

    # phase 2: build
    t0 = time.perf_counter()
    path, log = dense_v4.build_library()
    print(f"build: {path.name} in {time.perf_counter() - t0:.2f} s")
    for line in log.splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print("  ptxas:", line.strip())

    # phase 3: kernel parity and times at the main path's shapes
    scene_np, _ = build_demo_scene(subdiv=3)
    scene = scene_from_numpy(scene_np, dev)
    tris = scene["dense_tris_v4"]
    aabb = scene["dense_cluster_aabb_v4"]
    print(f"bench scene: {tris.shape[1]} slots, {aabb.shape[1]} clusters")
    rng = np.random.default_rng(SEED)

    def unit(n):
        d = rng.normal(size=(n, 3))
        return d / np.linalg.norm(d, axis=1, keepdims=True)

    def t32(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=dev)

    # 65536 camera rays (256^2 pixels) and 65536 bounce rays from interior
    # points; shadow rays aim at the light quad (y = 1.98, |x|, |z| < 0.4)
    lane = torch.arange(N_DUAL, dtype=torch.int32, device=dev)
    cam_org, cam_dir = generate_rays(scene, 256, 256, t32(rng.random(N_DUAL)),
                                     t32(rng.random(N_DUAL)), lane)
    b_org = rng.uniform([-0.95, 0.05, -0.95], [0.95, 1.95, 0.95],
                        size=(N_DUAL, 3))
    b_dir = unit(N_DUAL)
    lpt = np.stack([rng.uniform(-0.4, 0.4, N_DUAL), np.full(N_DUAL, 1.98),
                    rng.uniform(-0.4, 0.4, N_DUAL)], axis=1)
    to_l = lpt - b_org
    dist = np.linalg.norm(to_l, axis=1)
    smax = np.where(rng.random(N_DUAL) < 0.3, -1.0, dist - EPS)
    maxt = np.where(rng.random(N_DUAL) < 0.05, -1.0, INF)  # some dead lanes
    dual_args = (tris, aabb, t32(b_org), t32(b_dir),
                 torch.full((N_DUAL,), 1e-3, device=dev), t32(maxt),
                 t32(to_l / dist[:, None]),
                 torch.full((N_DUAL,), EPS, device=dev), t32(smax))
    half = N_SINGLE // 2
    s_org = torch.cat([cam_org[:half], t32(b_org[:half])]).contiguous()
    s_dir = torch.cat([cam_dir[:half], t32(b_dir[:half])]).contiguous()
    single_args = (tris, aabb, s_org, s_dir,
                   torch.zeros((N_SINGLE,), device=dev),
                   torch.full((N_SINGLE,), INF, device=dev))

    got, occ = dense_v4.dense_trace_v4_dual(*dual_args)
    ref, ref_occ = dense_v4.dense_trace_v4_dual_ref(*dual_args)
    torch.cuda.synchronize()
    err_dual = check_hits("dual", got, ref, occ, ref_occ)
    got = dense_v4.dense_trace_v4(*single_args)
    ref = dense_v4.dense_trace_v4_ref(*single_args)
    torch.cuda.synchronize()
    err_single = check_hits("single", got, ref)
    anyh = dense_v4.dense_trace_v4(*single_args, any_hit=True)
    if not torch.equal(anyh["prim"] >= 0, ref["prim"] >= 0):
        raise AssertionError("single any-hit: hit mask differs")
    print(f"parity: dual N={N_DUAL} max|dt|={err_dual:.3g} "
          f"hits={int((ref['prim'] >= 0).sum())}; single N={N_SINGLE} "
          f"max|dt|={err_single:.3g}; any-hit mask equal")

    times = {}
    for name, args, fn, ref_fn in [
            ("dual", dual_args, dense_v4.dense_trace_v4_dual,
             dense_v4.dense_trace_v4_dual_ref),
            ("single", single_args, dense_v4.dense_trace_v4,
             dense_v4.dense_trace_v4_ref)]:
        # kernel and plain walk alone on one prepared survivor list, then
        # the whole wrapper (prelude included) for context
        walk, plain_walk = walk_timers(dense_v4, *args,
                                       dual=(name == "dual"))
        times[name] = (cuda_ms(walk), cuda_ms(plain_walk, reps=5),
                       cuda_ms(lambda: fn(*args)),
                       cuda_ms(lambda: ref_fn(*args), reps=5))
        print(f"time {name}: kernel {times[name][0]:.4f} ms, plain walk "
              f"{times[name][1]:.4f} ms; wrapper with prelude "
              f"{times[name][2]:.4f} ms vs plain {times[name][3]:.4f} ms "
              f"({card})")

    # phase 4: render parity, card (kernels) vs CPU (plain versions)
    small = dict(width=32, height=32, spp=4, max_steps=12, k_volume=3)
    img_gpu = render(scene, seed=SEED, **small).cpu().numpy()
    img_cpu = render(scene_from_numpy(scene_np, "cpu"), seed=SEED,
                     **small).numpy()
    close = np.isclose(img_gpu, img_cpu, rtol=1e-3, atol=1e-4).mean()
    rel_mean = abs(img_gpu.mean() - img_cpu.mean()) / img_cpu.mean()
    print(f"render parity 32x32x4: {close * 100:.2f}% of values within "
          f"rtol 1e-3/atol 1e-4, mean rel diff {rel_mean:.3g}, max |diff| "
          f"{np.abs(img_gpu - img_cpu).max():.3g}, "
          f"{(img_gpu == img_cpu).mean() * 100:.2f}% bit-equal")
    if not (np.isfinite(img_gpu).all() and close >= 0.99
            and rel_mean <= 1e-3):
        raise AssertionError("render on the card disagrees with the CPU")

    # phase 5: the main path, counted
    for k in dense_v4.LAUNCHES:
        dense_v4.LAUNCHES[k] = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    total, iters = render_lanes_wavefront(
        scene, MAIN["width"], MAIN["height"], MAIN["spp"], seed=SEED,
        max_steps=MAIN["max_steps"], k_volume=MAIN["k_volume"],
        return_iters=True)
    img = (total.reshape(MAIN["height"], MAIN["width"], 3)
           / MAIN["spp"]).cpu().numpy()
    wall = time.perf_counter() - t0
    launches = dict(dense_v4.LAUNCHES)
    rays = MAIN["width"] * MAIN["height"] * MAIN["spp"]
    print(f"main path: render 512x512x8 max_steps=12 k_volume=3 in "
          f"{wall:.3f} s, {iters} sub-iterations, launches {launches}, "
          f"mean {img.mean():.5f}, {rays / wall / 1e6:.3f} M camera "
          f"samples/s ({card})")
    if not (np.isfinite(img).all() and (img >= 0).all() and img.mean() > 0):
        raise AssertionError("main-path image is not finite, non-negative, lit")
    if not (launches["dual"] > 0 and launches["single"] > 0):
        raise AssertionError(f"main path missed a kernel: {launches}")

    src = "pbrlab_tpu_torch/csrc/dense_v4.cu"
    record = {"kernels": [
        {"name": "dense_v4_trace_dual", "route": "cuda", "source": src,
         "replaces": "pbrlab_tpu/ops/pallas/dense_v4.py:248",
         "launches": launches["dual"], "max_abs_err": err_dual,
         "ms": times["dual"][0], "plain_ms": times["dual"][1]},
        {"name": "dense_v4_trace", "route": "cuda", "source": src,
         "replaces": "pbrlab_tpu/ops/pallas/dense_v4.py:115",
         "launches": launches["single"], "max_abs_err": err_single,
         "ms": times["single"][0], "plain_ms": times["single"][1]},
    ]}
    print(json.dumps(record))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def walk_timers(dense_v4, tris, aabb, org, direction, min_t, max_t,
                sdir=None, smin_t=None, smax_t=None, dual=False):
    """(kernel, plain walk) closures over one prepared survivor list (the
    rays are whole groups, so no padding is needed)."""
    gm, tn = dense_v4.exact_group_survivors(aabb, org, direction, min_t,
                                            max_t)
    extra = ()
    if dual:
        gm_s, tn_s = dense_v4.exact_group_survivors(aabb, org, sdir, smin_t,
                                                    smax_t)
        gm, tn = gm | gm_s, torch.minimum(tn, tn_s)
        extra = (sdir, smin_t, smax_t)
    surv, cnt, tnear = dense_v4._survivor_lists(gm, tn)
    args = (tris, surv, cnt, tnear, org, direction, min_t, max_t, *extra)

    def kernel():
        dense_v4._walk_cuda(*args)

    def plain():
        dense_v4._walk_ref(tris, surv, cnt, org, direction, min_t, max_t,
                           *extra)
    return kernel, plain


if __name__ == "__main__":
    sys.exit(main())
