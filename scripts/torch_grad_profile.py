"""Time and profile the port's gradient pass on a GPU: the forward and the
backward of chip_smoke.py phase 7's loss, each with its wall, device busy
time, idle share and device time by kernel.

    python scripts/torch_grad_profile.py --size 1024 --max-steps 4

The cornellbox (`build_demo_scene(subdiv=3)`) on the card, seed 7,
k_volume 3: `render_lanes(remat=True)` of one sample at --size^2, the MSE
to the same render at base_color x 0.5, and its backward to the eight
leaves (`chip_smoke.with_leaves`). One warm-up pass at 32x32, --reps
unprofiled passes (host clock around work that ends in a synchronize),
then, unless --no-profile, one pass whose forward and backward run under
two torch.profiler sessions; a share is of the profiled wall's busy
device time over the median unprofiled wall of that half. Fewer depths
(--max-steps) keep the profiler's event count (~3000 kernels a step,
forward, recompute and backward) in its post-processing's reach. Fails
without a CUDA device.
"""
from __future__ import annotations

import argparse
import os
import statistics
import subprocess
import sys
import time

import torch


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=1024)
    ap.add_argument("--max-steps", type=int, default=4)
    ap.add_argument("--reps", type=int, default=1)
    ap.add_argument("--no-profile", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_grad_profile: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from chip_smoke import SEED, with_leaves
    from pbrlab_tpu_torch.render.integrator import render_lanes
    from pbrlab_tpu_torch.scene.demo import build_demo_scene
    from pbrlab_tpu_torch.scene.scene import scene_from_numpy

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    scene = scene_from_numpy(build_demo_scene(subdiv=3)[0],
                             torch.device("cuda:0"))
    kw = dict(max_steps=args.max_steps, k_volume=3)

    def halves(size):
        """(forward, backward) closures of one pass at size^2."""
        dim = dict(scene)
        dim["materials"] = {**scene["materials"], "base_color":
                            scene["materials"]["base_color"] * 0.5}
        with torch.no_grad():
            target = render_lanes(dim, size, size, 0, SEED, **kw)
        s, _ = with_leaves(scene)
        out = {}

        def forward():
            img = render_lanes(s, size, size, 0, SEED, remat=True, **kw)
            out["loss"] = ((img - target) ** 2).mean()

        def backward():
            out["loss"].backward()

        return forward, backward

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    for fn in halves(32):
        timed(fn)
    walls = {"forward": [], "backward": []}
    for rep in range(args.reps):
        fwd, bwd = halves(args.size)
        walls["forward"].append(timed(fwd))
        walls["backward"].append(timed(bwd))
        print(f"grad pass {args.size}x{args.size}x1 max_steps="
              f"{args.max_steps} k_volume=3 rep {rep}: forward "
              f"{walls['forward'][-1]:.3f} s, backward "
              f"{walls['backward'][-1]:.3f} s ({card})", flush=True)
    if args.no_profile:
        return 0
    act = [torch.profiler.ProfilerActivity.CPU,
           torch.profiler.ProfilerActivity.CUDA]
    for name, fn in zip(("forward", "backward"), halves(args.size)):
        with torch.profiler.profile(activities=act) as prof:
            prof_wall = timed(fn)
        kernels = [e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        busy = sum(e.self_device_time_total for e in kernels) / 1e6
        count = sum(e.count for e in kernels)
        wall = statistics.median(walls[name])
        trace = sum(e.self_device_time_total for e in kernels
                    if "v4_kernel" in e.key or "v5_kernel" in e.key) / 1e6
        print(f"{name}: wall {wall:.3f} s unprofiled, {prof_wall:.3f} s "
              f"profiled; {count} device kernels, device busy {busy:.3f} s, "
              f"idle share {1 - busy / wall:.3f}; trace kernels (dense_v4, "
              f"dense_v5) {trace:.3f} s ({trace / busy * 100:.1f}% of busy) "
              f"({card})")
        for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]:
            print(f"  {e.self_device_time_total / 1e6:9.4f} s {e.count:8d}x "
                  f"{e.key[:100]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
