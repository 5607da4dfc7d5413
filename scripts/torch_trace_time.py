"""Time the dense_v4 and dense_v5 trace wrappers of a checkout on a GPU,
on chip_smoke.py's phase-3 rays with every lane live and with a share of
them live.

    python scripts/torch_trace_time.py --root build/parent --live 1 0.05
    python scripts/torch_trace_time.py --root build/parent --kernels

The cornellbox (`build_demo_scene(subdiv=3)`, dense_v4) and the mid scene
(`build_demo_scene(subdiv=4)`, dense_v5), each with chip_smoke.py's
phase-3 rays (`path_rays`, seed 7): `dense_trace_v4_dual` /
`dense_trace_v5_dual` on 65536 bounce rays with their shadow queries and
`dense_trace_v4` / `dense_trace_v5` on 24576 rays. With --live f, the
lanes outside a random share f (seed 1) get max_t = -1 and no shadow
query: dead lanes, as most lanes of an unwindowed volume substep are.
Times: median CUDA-event ms of 20 wrapper calls after 2 warm-up calls,
each line beside the card's name and power limit. With --kernels the
checkout's own `chip_smoke.v4_phase` runs too: its dense_v4 kernels alone
against its plain versions on the cornellbox rays. --root is the checkout
whose `pbrlab_tpu_torch` and `chip_smoke.py` are imported (default: the
one holding this script), so two commits compare on one card in one call,
in turns (A, B, B, A). Fails without a CUDA device.
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--live", type=float, nargs="+", default=[1.0, 0.05])
    ap.add_argument("--kernels", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_trace_time: no CUDA device", file=sys.stderr)
        return 1
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import chip_smoke
    from pbrlab_tpu_torch.ops import dense_v4, dense_v5
    from pbrlab_tpu_torch.scene.demo import build_demo_scene
    from pbrlab_tpu_torch.scene.scene import scene_from_numpy

    dev = torch.device("cuda:0")
    card = chip_smoke.card_line()
    paths = (("cornellbox", 3, ("dense_tris_v4", "dense_cluster_aabb_v4"),
              dense_v4.dense_trace_v4_dual, dense_v4.dense_trace_v4),
             ("mid", 4, ("dense_tris_v4", "v5_node_aabb", "v5_node_meta"),
              dense_v5.dense_trace_v5_dual, dense_v5.dense_trace_v5))
    for path, subdiv, keys, dual_fn, single_fn in paths:
        scene = scene_from_numpy(build_demo_scene(subdiv=subdiv)[0], dev)
        tables = [scene[k] for k in keys]
        dual, single = chip_smoke.path_rays(scene, dev,
                                            np.random.default_rng(7))
        if args.kernels and path == "cornellbox":
            chip_smoke.v4_phase(dense_v4, scene, dual, single, card)
        for live in args.live:
            gen = torch.Generator(device=dev).manual_seed(1)

            def dead(n):
                return torch.rand((n,), generator=gen, device=dev) >= live

            d = dead(dual[0].shape[0])
            rays = list(dual)
            rays[3] = torch.where(d, -1.0, rays[3])
            rays[6] = torch.where(d, -1.0, rays[6])
            ms_dual = chip_smoke.cuda_ms(lambda: dual_fn(*tables, *rays))
            s = dead(single[0].shape[0])
            srays = list(single)
            srays[3] = torch.where(s, -1.0, srays[3])
            ms_single = chip_smoke.cuda_ms(lambda: single_fn(*tables, *srays))
            print(f"{root} {path} live {live}: {dual_fn.__name__} "
                  f"N={rays[0].shape[0]} ({int((~d).sum())} live) "
                  f"{ms_dual:.4f} ms; {single_fn.__name__} "
                  f"N={srays[0].shape[0]} ({int((~s).sum())} live) "
                  f"{ms_single:.4f} ms ({card})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
