"""Time and profile renders of the PyTorch/CUDA port on a GPU: wall time,
device busy time and idle share, and the device time by kernel.

    python scripts/torch_render_profile.py --path large --size 256 --spp 2
    python scripts/torch_render_profile.py --root build/parent \
        --path instanced large --reps 3 --no-profile

--path picks the scenes of chip_smoke.py's paths (cornellbox: subdiv=3,
dense_v4; mid: subdiv=4, dense_v5; large: subdiv=5 irregular,
dense_v5s/v5l; hair: subdiv=3 with the demo tuft, dense_v4 and
dense_curve; instanced: chip_smoke.instanced_builder() through
build_instanced, dense_v5i; dense and dense3: the cornellbox, whose
legacy tables are the file path's, with the render's tri_backend forced
to "dense" (dense_v2) or "dense3" (dense_v3)); each render runs at
max_steps=12, k_volume=3, seed 7. --root is the checkout whose `pbrlab_tpu_torch` and
`chip_smoke.py` are imported (default: the one holding this script), so
two commits can be compared on one card in one call by running them in
turns (A, B, B, A). For each path the scene is rendered once at 32x32x1
(builds the kernels, warms the allocator), then --reps times unprofiled
(host clock around work that ends in a synchronize), then, unless
--no-profile, once under torch.profiler; the idle share is 1 - device
busy / the median unprofiled wall. The trace kernels' device time is
printed in all and, for the cornellbox, mid, large, hair, instanced,
dense and dense3 paths, the dense_v4 (with its dual), dense_v5 (with its
dual), dense_v5l, dense_curve, dense_v5i, dense_v2 or dense_v3 kernels'
alone (the legacy kernels by their names before and after their
template, so that older checkouts profile too). Fails without a CUDA
device.
"""
from __future__ import annotations

import argparse
import os
import statistics
import subprocess
import sys
import time

import torch

SCENES = {"cornellbox": dict(subdiv=3), "mid": dict(subdiv=4),
          "large": dict(subdiv=5, irregular=True),
          "hair": dict(subdiv=3, with_hair=True), "instanced": None,
          "dense": dict(subdiv=3), "dense3": dict(subdiv=3)}
BACKEND = {"dense": "dense", "dense3": "dense3"}  # forced tri_backend
CURVE = ("curve_kernel",)  # csrc/dense_curve.cu
V5I = ("v5i_kernel",)  # csrc/dense_v5i.cu
V4 = ("v4_kernel",)  # csrc/dense_v4.cu: dense_v4 and its dual
V5 = ("v5_kernel",)  # csrc/dense_v5.cu: dense_v5 and its dual
V5L = ("v5l_kernel",)  # csrc/dense_v5.cu: dense_v5l
# csrc/dense_legacy.cu: one template for v1-v3 (a forced backend runs one
# of them); older checkouts name them v1_kernel, v2_kernel and v3_kernel
LEGACY = ("legacy_kernel", "v1_kernel", "v2_kernel", "v3_kernel")
OWN = V4 + V5 + CURVE + V5I + V5L + LEGACY
# the kernels each path reports
ONE = {"cornellbox": V4, "instanced": V5I, "large": V5L, "mid": V5,
       "hair": CURVE, "dense": LEGACY, "dense3": LEGACY}


def profile(path, run, size, spp, wall, iters, card):
    """One render under torch.profiler; prints the device time by kernel."""
    act = [torch.profiler.ProfilerActivity.CPU,
           torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=act) as prof:
        prof_wall, _ = run(size, spp)
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels) / 1e6
    count = sum(e.count for e in kernels)
    own = [e for e in kernels if any(k in e.key for k in OWN)]
    own_s = sum(e.self_device_time_total for e in own) / 1e6
    one = [e for e in own if any(k in e.key for k in ONE[path])]
    one_s = sum(e.self_device_time_total for e in one) / 1e6
    one_n = sum(e.count for e in one)
    print(f"{path} {size}x{size}x{spp}: {iters} sub-iterations; wall "
          f"{wall:.3f} s unprofiled, {prof_wall:.3f} s profiled; {count} "
          f"device kernels ({count / iters:.0f} per sub-iteration), device "
          f"busy {busy:.3f} s, idle share {1 - busy / wall:.3f}; trace "
          f"kernels {own_s:.3f} s ({own_s / busy * 100:.1f}% of busy), of "
          f"which {'/'.join(ONE[path])} {one_s:.3f} s ({one_s / busy * 100:.1f}% of busy, "
          f"{one_n} launches) ({card})")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"  {e.self_device_time_total / 1e6:9.4f} s {e.count:8d}x "
              f"{e.key[:90]}")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--path", nargs="+", choices=sorted(SCENES),
                    default=["large"])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--spp", type=int, default=2)
    ap.add_argument("--reps", type=int, default=1)
    ap.add_argument("--no-profile", action="store_true")
    args = ap.parse_args()
    if args.reps < 1:
        ap.error("--reps must be at least 1")
    if not torch.cuda.is_available():
        print("torch_render_profile: no CUDA device", file=sys.stderr)
        return 1
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import pbrlab_tpu_torch
    from chip_smoke import instanced_builder
    from pbrlab_tpu_torch.render.integrator import render_lanes_wavefront
    from pbrlab_tpu_torch.scene.demo import build_demo_scene
    from pbrlab_tpu_torch.scene.instanced import build_instanced
    from pbrlab_tpu_torch.scene.scene import scene_from_numpy

    print(f"port imported from {os.path.dirname(pbrlab_tpu_torch.__file__)}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    for path in args.path:
        if SCENES[path] is None:
            scene_np = build_instanced(instanced_builder())
        else:
            scene_np = build_demo_scene(**SCENES[path])[0]
        scene = scene_from_numpy(scene_np, torch.device("cuda:0"))

        def run(size, spp):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, iters = render_lanes_wavefront(
                scene, size, size, spp, seed=7, max_steps=12, k_volume=3,
                return_iters=True, tri_backend=BACKEND.get(path))
            torch.cuda.synchronize()
            return time.perf_counter() - t0, iters

        run(32, 1)
        walls = []
        for rep in range(args.reps):
            wall, iters = run(args.size, args.spp)
            walls.append(wall)
            print(f"{root} {path} {args.size}x{args.size}x{args.spp} rep "
                  f"{rep}: {wall:.3f} s, {iters} sub-iterations ({card})",
                  flush=True)
        if not args.no_profile:
            profile(path, run, args.size, args.spp, statistics.median(walls),
                    iters, card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
