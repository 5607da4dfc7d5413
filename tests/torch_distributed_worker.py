"""Worker process of tests/test_torch_parallel.py's two-process render.

Joins the gloo process group named by PBRLAB_COORDINATOR,
PBRLAB_NUM_PROCESSES and PBRLAB_PROCESS_ID, renders its slice of the
lambert scene (build_demo_scene(subdiv=1, lambert_only=True), 16x16, 2
spp, max_steps 6) on the CPU with `render_distributed`, and rank 0 saves
the gathered image to argv[1].
"""
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    import torch.distributed as dist

    from pbrlab_tpu_torch.parallel.distributed import (global_mesh,
                                                       init_distributed,
                                                       render_distributed)
    from pbrlab_tpu_torch.scene.demo import build_demo_scene

    torch.set_num_threads(1)
    if not init_distributed(backend="gloo"):
        raise RuntimeError("PBRLAB_* environment not set")
    mesh = global_mesh("cpu")
    if len(mesh) != 2:
        raise RuntimeError(f"mesh {mesh}")
    scene_np, _ = build_demo_scene(subdiv=1, lambert_only=True)
    img = render_distributed(scene_np, 16, 16, 2, mesh=mesh, max_steps=6)
    if dist.get_rank() == 0:
        np.save(sys.argv[1], img)
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
