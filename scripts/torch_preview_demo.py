"""Scripted live-edit demo of the port: a progressive render behind the
preview server, a material edit made mid-render through the server's own
HTTP endpoints, and the frames before and after it as PNGs (the port of
scripts/preview_demo.py; reference behaviour pbrlab-gui.cc:207-238 and the
material editor, glfw-window.cc:651-980).

    python scripts/torch_preview_demo.py [outdir] [--device cuda|cpu]
        [--size 128] [--passes 3] [--subdiv 2]

On the card (the default device) the passes replay one compiled program,
its CUDA graphs captured by the first passes; the edit writes the new
material into the program's buffers and captures nothing new, and the
script prints the capture count before and after it. Writes
outdir/before.png and outdir/after.png (`io.image.encode_png`) and prints
"ok" last, after the passes' walls (the recorder's `progressive.pass`
requests).
"""
import argparse
import json
import os
import sys
import urllib.request

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402


def _captures(renderer):
    return sum(len(getattr(p.runner, "graphs", ()))
               for p in renderer.programs.programs.values())


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("outdir", nargs="?", default="preview_demo")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--size", type=int, default=128)
    ap.add_argument("--passes", type=int, default=3)
    ap.add_argument("--subdiv", type=int, default=2)
    args = ap.parse_args(argv)
    os.makedirs(args.outdir, exist_ok=True)

    from pbrlab_tpu_torch.app.viewer import PreviewServer
    from pbrlab_tpu_torch.render.film import save_png
    from pbrlab_tpu_torch.render.progressive import ProgressiveRenderer
    from pbrlab_tpu_torch.scene.demo import build_demo_scene
    from pbrlab_tpu_torch.scene.scene import scene_to_device
    from pbrlab_tpu_torch.utils import profiling

    scene_np, builder = build_demo_scene(subdiv=args.subdiv)
    r = ProgressiveRenderer(scene_to_device(scene_np, args.device),
                            args.size, args.size,
                            material_names=builder.materials.names,
                            max_steps=8)
    srv = PreviewServer(r, max_pass=2 * args.passes)
    port = srv.start(port=0)  # ephemeral
    base = f"http://127.0.0.1:{port}"
    print(f"preview at {base}", file=sys.stderr)
    try:
        for _ in range(args.passes):  # the original scene
            r.step()
        before = r.average()
        save_png(os.path.join(args.outdir, "before.png"), before)
        captured = _captures(r)

        # the edit goes through the HTTP surface: the monkey turns green
        urllib.request.urlopen(urllib.request.Request(
            base + "/edit",
            data=json.dumps({"material": "Monkey", "param": "base_color",
                             "value": [0.05, 0.8, 0.15]}).encode(),
            method="POST"), timeout=30).read()
        status = json.loads(urllib.request.urlopen(
            base + "/status", timeout=30).read())
        print(f"status: {status}; Monkey base_color edit queued",
              file=sys.stderr)

        # applied before the next pass, which resets the accumulation
        for _ in range(args.passes):
            r.step()
        after = r.average()
        save_png(os.path.join(args.outdir, "after.png"), after)
    finally:
        srv.stop()

    d = float(np.abs(before - after).max())
    pass_seconds = [rec["dur_ns"] / 1e9 for rec in profiling.records()
                    if rec["name"] == "progressive.pass"]
    print(f"{args.size}x{args.size} on {args.device}: pass times "
          f"{[round(t, 4) for t in pass_seconds]} s; graphs captured "
          f"{captured} before the edit, {_captures(r)} after; before/after "
          f"max pixel delta {d:.4f} ({args.outdir}/before.png, after.png)",
          file=sys.stderr)
    if d <= 0.01:
        raise SystemExit("the edit had no visible effect")
    if _captures(r) != captured:
        raise SystemExit("the edit made new captures")
    print("ok")


if __name__ == "__main__":
    main()
