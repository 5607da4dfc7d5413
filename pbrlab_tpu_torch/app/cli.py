"""CLI renderer (port of pbrlab_tpu.app.cli), the analogue of pbrlab-cli.

Reference: pc/pbrlab-cli.cc:16-60 + pc-common.cc:239-270: obj / hair
file arguments -> scene -> render -> average -> sRGB -> PNG.

Usage: python -m pbrlab_tpu_torch.app.cli scene.obj [more.obj ...] \\
           [--width 512 --height 512 --spp 32 --out rgba.png]
`demo` renders the built-in procedural cornellbox; a single `.json`
argument is a scene description with its render config. The scene goes to
`--device` (default cuda; `--device cpu` renders on the CPU with the
kernels' plain twins), and the triangle backend is the scene's.
"""
from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np


def build_scene_from_files(paths, return_names=False):
    """Scene from .obj / .hair files. return_names=True also returns the
    SceneBuilder's material names, so the progressive editor can address
    every scene material by name, like the reference GUI's per-material
    editor (pc/glfw-window.cc:651-980)."""
    from ..io.obj import load_obj, material_params_to_builder
    from ..scene.scene import SceneBuilder, commit

    b = SceneBuilder()
    for path in paths:
        if path.endswith((".hair", ".cyhair")):
            from ..io.cyhair import load_cyhair_as_bezier

            curve = load_cyhair_as_bezier(path)
            curve.material_id = b.materials.add_hair("hair")
            b.add_instance([], curves=[curve])
            continue
        meshes, mat_list, mat_names = load_obj(path)
        ids = material_params_to_builder(mat_list, mat_names, b)
        for mesh in meshes:
            mesh.material_ids = np.asarray(
                [ids[m] for m in mesh.material_ids], np.int32)
            light_ids = None
            # meshes named light* get an emission=3 area light
            # (pc-common.cc:172-186)
            if mesh.name.startswith("light"):
                lid = b.add_area_light_param((3.0, 3.0, 3.0))
                light_ids = [np.full((mesh.num_faces,), lid, np.int32)]
            b.add_instance([mesh], light_ids=light_ids)
    scene = commit(b.build())
    if return_names:
        return scene, list(b.materials.names)
    return scene


def main(argv=None):
    ap = argparse.ArgumentParser(description="pbrlab_tpu_torch renderer")
    ap.add_argument("scenes", nargs="+",
                    help=".obj / .hair files, a scene .json, or 'demo'")
    ap.add_argument("--width", type=int, default=512)
    ap.add_argument("--height", type=int, default=512)
    ap.add_argument("--spp", type=int, default=32)
    ap.add_argument("--max-steps", type=int, default=32)
    ap.add_argument("--k-volume", type=int, default=-1,
                    help="volume-only substeps per wavefront step for SSS "
                         "walks (-1 = auto: probe the scene and raise k "
                         "until < 8%% of walks truncate; "
                         "docs/sss_truncation.md)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="rgba.png")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the scene and the render "
                         "(cuda, or cpu for the kernels' plain twins)")
    ap.add_argument("--serve", type=int, default=None, metavar="PORT",
                    help="progressive render with the HTTP preview/editor "
                         "(reference GUI analogue) on this port")
    args = ap.parse_args(argv)

    from ..render.film import save_png
    from ..render.integrator import auto_k_volume, render
    from ..scene.scene import scene_to_device

    # material names ride along from every loader so --serve lists every
    # scene material in the editor (glfw-window.cc:651-980)
    if args.scenes == ["demo"]:
        from ..scene.demo import build_demo_scene

        scene_np, builder = build_demo_scene()
        mat_names = list(builder.materials.names)
    else:
        for path in args.scenes:
            if not os.path.exists(path):
                print(f"error: failed loading scene file [{path}]",
                      file=sys.stderr)
                return 1
        if len(args.scenes) == 1 and args.scenes[0].endswith(".json"):
            # scene description + its optional render config
            from ..io.scene_json import load_scene_json

            scene_np, render_cfg, mat_names = load_scene_json(
                args.scenes[0], return_names=True)
            args.width = render_cfg.get("width", args.width)
            args.height = render_cfg.get("height", args.height)
            args.spp = render_cfg.get("max_pass", args.spp)
        else:
            scene_np, mat_names = build_scene_from_files(
                args.scenes, return_names=True)
    ntri = (scene_np["tri_v0"].shape[0] if "tri_v0" in scene_np
            else scene_np["iface_material"].shape[0])
    print(f"scene: {ntri} triangles, "
          f"{scene_np['curve_pts'].shape[0]} curve segments", file=sys.stderr)
    k_volume = args.k_volume
    if k_volume < 0:
        k_volume = auto_k_volume(scene_np, max_steps=args.max_steps,
                                 device=args.device)
        print(f"k_volume: {k_volume} (auto)", file=sys.stderr)
    scene = scene_to_device(scene_np, args.device)

    if args.serve is not None:
        from ..app.viewer import PreviewServer
        from ..render.progressive import ProgressiveRenderer

        r = ProgressiveRenderer(scene, args.width, args.height,
                                material_names=mat_names,
                                seed=args.seed, max_steps=args.max_steps,
                                k_volume=k_volume)
        srv = PreviewServer(r, max_pass=args.spp)
        port = srv.start(port=args.serve)
        print(f"preview at http://127.0.0.1:{port} "
              f"(progressive, {args.spp} passes)", file=sys.stderr)
        try:
            img = srv.render_loop()
        finally:
            srv.stop()
        save_png(args.out, img)
        print(f"wrote {args.out}", file=sys.stderr)
        return 0

    t0 = time.time()
    img = render(scene, args.width, args.height, args.spp, seed=args.seed,
                 max_steps=args.max_steps, k_volume=k_volume).cpu()
    dt = time.time() - t0
    print(f"rendered {args.width}x{args.height}@{args.spp}spp in {dt:.2f}s",
          file=sys.stderr)
    save_png(args.out, img)
    print(f"wrote {args.out}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
