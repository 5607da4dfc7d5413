"""SSS walk-budget truncation study on the port: the counterpart of
scripts/sss_truncation_study.py, on `pbrlab_tpu_torch`'s `render` and
`utils.profiling.measure_sss_truncation`.

    python3 scripts/torch_sss_truncation_study.py [--device cuda]
        [--res 48] [--spp 8] [--steps 24]
        [--out docs/sss_truncation_torch.md]

The reference walks up to 8192 volume steps inside one surface bounce
(random-walk-sss.h:281); the wavefront gives a walk one step per full
step plus k_volume substeps, a budget of about (1 + k_volume) x the
remaining max_steps. A walk that exhausts it is truncated and biases the
radiance down. On the demo scene at subdiv=2 without the monkey, with the
subsurface radius scaled by 1, 0.25 and 0.0625 (a denser medium each
time), the script renders k_volume 0, 1, 3 and 6 against k_volume 12 and
writes, for each, the probe's truncated-walk fraction and the bias of the
mean radiance over the right half of the image (the SSS body's). One more
row: the k that `integrator.auto_k_volume`, the CLI's rule (raise k until
under 8% of the probed walks are truncated), picks for the demo medium
(radius x 1) at the CLI's max_steps 32, with its fraction and its bias
against k_volume 12 at that max_steps. The defaults are the JAX study's
sizes. `--device` defaults to cuda and never falls back: without a card,
pass `--device cpu`. The table names the card and its power limit.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

KS = (0, 1, 3, 6)
K_REF = 12  # the "converged" budget, as the JAX study's
RADIUS_SCALES = (1.0, 0.25, 0.0625)
CLI_STEPS = 32  # the CLI's default max_steps, where auto_k_volume runs
THRESHOLD = 0.08  # auto_k_volume's rule
PROBE = 96  # the side of auto_k_volume's truncation probe
JAX_BIAS = 0.003  # the JAX study's bound under ~10% truncated walks


def build(radius_scale):
    """The demo scene at subdiv=2 without the monkey, its subsurface
    radius scaled (scripts/sss_truncation_study.py:35-46)."""
    from pbrlab_tpu_torch.scene.demo import build_demo_scene

    scene_np, _ = build_demo_scene(subdiv=2, with_monkey=False)
    scene_np = dict(scene_np)
    mats = dict(scene_np["materials"])
    mats["subsurface_radius"] = (np.asarray(mats["subsurface_radius"])
                                 * radius_scale).astype(np.float32)
    scene_np["materials"] = mats
    return scene_np


def lucy_mean(img):
    """Mean radiance over the right half (the SSS body's region)."""
    _, w, _ = img.shape
    return float(img[:, w // 2:, :].mean())


def card_line(device):
    """The card's name and power limit as nvidia-smi prints them."""
    if device.type != "cuda":
        return "CPU (no card)"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def study(device, res, spp, steps):
    """-> (rows (scale, k, truncated, bias), the auto row (k, truncated,
    bias), seconds)."""
    from pbrlab_tpu_torch.render.integrator import auto_k_volume, render
    from pbrlab_tpu_torch.scene.scene import scene_from_numpy
    from pbrlab_tpu_torch.utils.profiling import measure_sss_truncation

    t0 = time.perf_counter()

    def bias_of(scene, k, max_steps):
        ref = render(scene, res, res, spp, max_steps=max_steps,
                     k_volume=K_REF).cpu().numpy()
        img = render(scene, res, res, spp, max_steps=max_steps,
                     k_volume=k).cpu().numpy()
        mref = lucy_mean(ref)
        return (lucy_mean(img) - mref) / max(mref, 1e-9)

    rows = []
    for scale in RADIUS_SCALES:
        scene_np = build(scale)
        scene = scene_from_numpy(scene_np, device)
        ref = render(scene, res, res, spp, max_steps=steps,
                     k_volume=K_REF).cpu().numpy()
        if not np.isfinite(ref).all() or ref.mean() <= 0:
            raise RuntimeError(f"radius x {scale}: the k_volume={K_REF} "
                               "render is not finite and lit")
        mref = lucy_mean(ref)
        for k in KS:
            img = render(scene, res, res, spp, max_steps=steps,
                         k_volume=k).cpu().numpy()
            trunc = measure_sss_truncation(scene_np, steps, k_volume=k,
                                           probe=PROBE, device=device)
            bias = (lucy_mean(img) - mref) / max(mref, 1e-9)
            rows.append((scale, k, trunc, bias))
            print(f"radius_scale={scale:<7} k={k:<3} truncated="
                  f"{trunc * 100:6.2f}%  bias={bias * 100:+6.2f}%",
                  file=sys.stderr)
    demo_np = build(1.0)
    k_auto = auto_k_volume(demo_np, max_steps=CLI_STEPS, probe=PROBE,
                           device=device)
    trunc = measure_sss_truncation(demo_np, CLI_STEPS, k_volume=k_auto,
                                   probe=PROBE, device=device)
    bias = bias_of(scene_from_numpy(demo_np, device), k_auto, CLI_STEPS)
    print(f"auto_k_volume (radius x 1, max_steps {CLI_STEPS}): k={k_auto} "
          f"truncated={trunc * 100:.2f}% bias={bias * 100:+.2f}%",
          file=sys.stderr)
    return rows, (k_auto, trunc, bias), time.perf_counter() - t0


def write_table(path, rows, auto, card, res, spp, steps, seconds):
    k_auto, t_auto, b_auto = auto
    under = [abs(b) for _, _, t, b in rows + [(None, k_auto, t_auto, b_auto)]
             if t < THRESHOLD]
    lines = [
        "# SSS walk-budget truncation, the PyTorch/CUDA port",
        "",
        "Written by `scripts/torch_sss_truncation_study.py` (the port's "
        "`render` and `utils.profiling.measure_sss_truncation`); the JAX "
        "study it repeats is `docs/sss_truncation.md`. Demo SSS scene "
        f"(subdiv=2, no monkey), {res}^2 x {spp} spp, max_steps={steps}; "
        "bias: the mean radiance of the right half (the SSS body) against "
        f"a k_volume={K_REF} render; truncated: the probe's fraction of "
        f"walks still inside the medium when the budget ran out ({PROBE}^2 "
        "probe, one sample), the quantity the CLI's auto k rule "
        f"(`integrator.auto_k_volume`) holds under {THRESHOLD:.0%}.",
        "",
        f"Device: {card}. Wall time of the study: {seconds:.1f} s.",
        "",
        "| radius scale | k_volume | truncated walks | radiance bias |",
        "|---|---|---|---|",
    ]
    lines += [f"| {scale} | {k} | {t * 100:.2f}% | {b * 100:+.2f}% |"
              for scale, k, t, b in rows]
    lines.append(f"| 1.0, auto_k_volume at the CLI's max_steps "
                 f"{CLI_STEPS} | {k_auto} | {t_auto * 100:.2f}% | "
                 f"{b_auto * 100:+.2f}% (against k_volume {K_REF} at "
                 f"max_steps {CLI_STEPS}) |")
    if under:
        worst = max(under)
        verdict = (f"the largest |bias| among the {len(under)} rows under "
                   f"{THRESHOLD:.0%} truncated walks (the auto row "
                   f"included) is {worst * 100:.2f}%; the JAX study bounded "
                   f"it by ~{JAX_BIAS * 100:.1f}%, so the rule "
                   f"{'holds' if worst <= JAX_BIAS else 'does not hold'} "
                   "on these numbers.")
    else:
        verdict = (f"no row is under {THRESHOLD:.0%} truncated walks, so "
                   "these numbers do not test it.")
    lines += ["", f"The {THRESHOLD:.0%} rule: {verdict}", ""]
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        f.write("\n".join(lines))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; no fallback)")
    ap.add_argument("--res", type=int, default=48)
    ap.add_argument("--spp", type=int, default=8)
    ap.add_argument("--steps", type=int, default=24)
    ap.add_argument("--out", default="docs/sss_truncation_torch.md")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("torch_sss_truncation_study: no CUDA device (pass --device "
              "cpu to run on the CPU)", file=sys.stderr)
        return 1
    rows, auto, seconds = study(device, args.res, args.spp, args.steps)
    write_table(args.out, rows, auto, card_line(device), args.res, args.spp,
                args.steps, seconds)
    print(f"wrote {args.out} ({seconds:.1f} s)", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
