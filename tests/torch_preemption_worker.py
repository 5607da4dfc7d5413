"""Worker process for the port's preemption test: a progressive render
on the CPU with a checkpoint after every pass, optionally resumed first.
Imports only the port.

argv: ckpt_path out_path max_pass [resume]
Prints "pass <n>" after each completed pass (the parent SIGKILLs it
mid-run).
"""
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    import torch

    from pbrlab_tpu_torch.render.progressive import ProgressiveRenderer
    from pbrlab_tpu_torch.scene.demo import build_demo_scene
    from pbrlab_tpu_torch.scene.scene import scene_to_device

    torch.set_num_threads(1)
    ckpt, out, max_pass = sys.argv[1], sys.argv[2], int(sys.argv[3])
    resume = len(sys.argv) > 4 and sys.argv[4] == "resume"

    scene_np, _ = build_demo_scene(subdiv=1)
    r = ProgressiveRenderer(scene_to_device(scene_np, "cpu"), 16, 16,
                            max_steps=4)
    if resume:
        r.load_checkpoint(ckpt)
    while r.num_passes < max_pass:
        r.step()
        r.save_checkpoint(ckpt)
        print(f"pass {r.num_passes}", flush=True)
    np.save(out, r.average())


if __name__ == "__main__":
    main()
