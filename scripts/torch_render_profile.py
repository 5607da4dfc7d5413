"""Profile one render of the PyTorch/CUDA port on a GPU: wall time, device
busy time and idle share, and the device time by kernel.

    python scripts/torch_render_profile.py --path large --size 256 --spp 2

--path picks the scene of one of chip_smoke.py's paths (cornellbox:
subdiv=3, dense_v4; mid: subdiv=4, dense_v5; large: subdiv=5 irregular,
dense_v5s/v5l; hair: subdiv=3 with the demo tuft, dense_v4 and
dense_curve; instanced: chip_smoke.instanced_builder() through
build_instanced, dense_v5i); the render runs at max_steps=12, k_volume=3,
seed 7. The render is timed unprofiled first (host clock around work
that ends in a synchronize), then once under torch.profiler; the idle
share is 1 - device busy / unprofiled wall. The trace kernels' device
time is printed in all and, for the hair and instanced paths, the
dense_curve or dense_v5i kernel's alone. Fails without a CUDA device.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

import torch

SCENES = {"cornellbox": dict(subdiv=3), "mid": dict(subdiv=4),
          "large": dict(subdiv=5, irregular=True),
          "hair": dict(subdiv=3, with_hair=True), "instanced": None}
CURVE = "curve_kernel"  # csrc/dense_curve.cu
V5I = "v5i_kernel"  # csrc/dense_v5i.cu
OWN = ("v5_kernel", "trace_kernel", "trace_dual_kernel", CURVE, V5I)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--path", choices=sorted(SCENES), default="large")
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--spp", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_render_profile: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from pbrlab_tpu_torch.render.integrator import render_lanes_wavefront
    from pbrlab_tpu_torch.scene.demo import build_demo_scene
    from pbrlab_tpu_torch.scene.scene import scene_from_numpy

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    if SCENES[args.path] is None:
        from chip_smoke import instanced_builder
        from pbrlab_tpu_torch.scene.instanced import build_instanced

        scene_np = build_instanced(instanced_builder())
    else:
        scene_np = build_demo_scene(**SCENES[args.path])[0]
    scene = scene_from_numpy(scene_np, torch.device("cuda:0"))

    def run(size, spp):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, iters = render_lanes_wavefront(scene, size, size, spp, seed=7,
                                          max_steps=12, k_volume=3,
                                          return_iters=True)
        torch.cuda.synchronize()
        return time.perf_counter() - t0, iters

    run(32, 1)  # builds the kernels, warms the allocator
    wall, iters = run(args.size, args.spp)
    act = [torch.profiler.ProfilerActivity.CPU,
           torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=act) as prof:
        prof_wall, _ = run(args.size, args.spp)
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels) / 1e6
    count = sum(e.count for e in kernels)
    own = [e for e in kernels if any(k in e.key for k in OWN)]
    own_s = sum(e.self_device_time_total for e in own) / 1e6
    one = V5I if args.path == "instanced" else CURVE
    one_s = sum(e.self_device_time_total for e in own
                if one in e.key) / 1e6
    one_n = sum(e.count for e in own if one in e.key)
    print(f"{args.path} {args.size}x{args.size}x{args.spp}: {iters} "
          f"sub-iterations; wall {wall:.3f} s unprofiled, {prof_wall:.3f} s "
          f"profiled; {count} device kernels ({count / iters:.0f} per "
          f"sub-iteration), device busy {busy:.3f} s, idle share "
          f"{1 - busy / wall:.3f}; trace kernels {own_s:.3f} s "
          f"({own_s / busy * 100:.1f}% of busy), of which {one} "
          f"{one_s:.3f} s ({one_s / busy * 100:.1f}% of busy, {one_n} "
          f"launches) ({card})")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"  {e.self_device_time_total / 1e6:9.4f} s {e.count:8d}x "
              f"{e.key[:90]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
