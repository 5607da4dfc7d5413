"""Pixel-sharded rendering and training (port of
pbrlab_tpu.parallel.sharding).

A mesh is a list of `torch.device`s, one per shard. The pixels are padded
to a multiple of the shard count (padded lanes re-render the last pixel)
and each shard renders its contiguous slice with the persistent-lane
wavefront on its device, the scene copied there. The shards of one
process run one after another: the single-process counterpart of the JAX
package's `shard_map` over a 1-D mesh. The per-lane counter-seeded RNG
makes the image independent of the layout, so a sharded render is the
single-device one to the bit (the port's image does not depend on the
lane count either). Training sums the shards' gradients, the counterpart
of the JAX package's `psum`; `parallel.distributed` spreads the shards
over processes.
"""
from __future__ import annotations

from typing import Dict, List

import torch

from ..render.graphs import Programs
from ..render.integrator import _mean, render_lanes, render_lanes_wavefront
from ..scene.scene import build_fat_tables
from ..utils import profiling

# the train step's differentiable leaves: six material columns, and the
# per-face emission and texture atlas of the scene
GRAD_KEYS = ("base_color", "subsurface_color", "subsurface_radius",
             "roughness", "specular", "metallic")
SCENE_KEYS = ("face_emission", "texture_atlas")


def make_mesh(n_devices: int | None = None, device=None) -> List[torch.device]:
    """The shards' devices. With no `device`, the first n_devices CUDA
    cards (None: every card); it raises without a card or with fewer
    than asked. With `device` ("cpu", "cuda", "cuda:1", ...), n_devices
    shards (None: 1) on that one device."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: no CUDA device; pass device='cpu' "
                               "to shard on the CPU")
        count = torch.cuda.device_count()
        n = n_devices or count
        if n > count:
            raise RuntimeError(f"make_mesh: {n} devices asked, {count} "
                               "CUDA devices present")
        return [torch.device("cuda", i) for i in range(n)]
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: no CUDA device")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return [dev] * (n_devices or 1)


def _pad_to(n: int, m: int) -> int:
    return (n + m - 1) // m * m


def padded_lanes(n: int, n_shards: int) -> torch.Tensor:
    """Pixel ids [n_pad] (CPU int32): 0..n-1, padded to a multiple of
    the shard count with the last pixel."""
    n_pad = _pad_to(n, n_shards)
    return torch.clamp(torch.arange(n_pad, dtype=torch.int32), max=n - 1)


def scene_on(scene: Dict, device) -> Dict:
    """The scene dict with every tensor on `device` (nested dicts too)."""
    return {k: scene_on(v, device) if isinstance(v, dict)
            else v.to(device) if torch.is_tensor(v) else v
            for k, v in scene.items()}


def render_sharded(scene: Dict, width: int, height: int, spp: int,
                   mesh: List[torch.device], seed=0, max_steps: int = 32,
                   k_volume: int = 0) -> torch.Tensor:
    """Mean radiance [H, W, 3] on mesh[0], the pixels sharded over
    `mesh`: shard i renders lanes i*per .. (i+1)*per - 1 of the padded
    pixel ids with `render_lanes_wavefront(lane=...)` on mesh[i]. Pass
    the render's k_volume (the CLI's auto choice) to get its image."""
    n = width * height
    lanes = padded_lanes(n, len(mesh))
    per = lanes.shape[0] // len(mesh)
    tables = {}  # one copy of the scene and its fat tables per device
    parts = []
    for i, dev in enumerate(mesh):
        if dev not in tables:
            tables[dev] = build_fat_tables(scene_on(scene, dev))
        parts.append(render_lanes_wavefront(
            tables[dev], width, height, spp, seed, max_steps,
            k_volume=k_volume, lane=lanes[i * per:(i + 1) * per]).to(mesh[0]))
    return _mean(torch.cat(parts)[:n].reshape(height, width, 3), spp)


def train_step_builder(width: int, height: int, spp: int,
                       mesh: List[torch.device], max_steps: int = 8,
                       lr: float = 0.05, k_volume: int = 0):
    """A differentiable-rendering training step over the pixel shards.

    train_step(scene, target [H, W, 3]) -> (loss, new_scene): each shard
    renders its lanes' `spp` samples with `render_lanes(remat=True)`
    (seed 0), the loss is the sum over every padded lane of the squared
    difference of its mean to the target (padded lanes repeat the last
    pixel and its target), the shards' gradients of GRAD_KEYS and
    SCENE_KEYS are summed, and each leaf steps by -lr * gradient,
    clipped at 0. The fat tables are built inside from the leaves. The
    gradient passes run through compiled programs (CUDA graphs on the
    card, forward and per-depth backward) that the step keeps from one
    call to the next, in `train_step.programs`. A step is a `train.step`
    request of `utils.profiling`, its passes' forward and backward
    `lanes.forward` and `lanes.backward` spans.
    `new_scene` is a new dict on the scene's devices; `scene` is not
    changed. The reference's training surface is its GUI edit loop
    (pc/pc-common.h EditQueue); here the same parameters descend a
    gradient towards a target image."""
    n = width * height
    lanes = padded_lanes(n, len(mesh))
    per = lanes.shape[0] // len(mesh)
    programs = Programs()

    def train_step(scene: Dict, target: torch.Tensor):
        with profiling.span("train.step", width=width, height=height,
                            spp=spp):
            return _step(scene, target)

    def _step(scene, target):
        tgt = target.detach().reshape(-1, 3)
        tgt = torch.cat([tgt, tgt[-1:].expand(lanes.shape[0] - n, 3)])
        params = {k: scene["materials"][k] for k in GRAD_KEYS}
        params.update({k: scene[k] for k in SCENE_KEYS})
        loss = 0.0
        grads = {k: torch.zeros_like(v) for k, v in params.items()}
        for i, dev in enumerate(mesh):
            leaves = {k: v.detach().to(dev).requires_grad_()
                      for k, v in params.items()}
            s = scene_on(scene, dev)
            s["materials"].update({k: leaves[k] for k in GRAD_KEYS})
            s.update({k: leaves[k] for k in SCENE_KEYS})
            s = build_fat_tables(s)
            lane = lanes[i * per:(i + 1) * per].to(dev)
            acc = 0.0
            with profiling.span("lanes.forward"):
                for sample_id in range(spp):
                    acc = acc + render_lanes(s, width, height, sample_id, 0,
                                             max_steps, lane, remat=True,
                                             k_volume=k_volume,
                                             programs=programs)
            shard_loss = ((acc / spp - tgt[i * per:(i + 1) * per].to(dev))
                          ** 2).sum()
            with profiling.span("lanes.backward"):
                g = torch.autograd.grad(shard_loss, list(leaves.values()),
                                        allow_unused=True)
            for key, gk in zip(leaves, g):
                if gk is not None:  # an unread leaf (a scene's dummy atlas)
                    grads[key] = grads[key] + gk.to(grads[key].device)
            loss = loss + shard_loss.detach().to(mesh[0])
        new_scene = dict(scene)
        new_scene["materials"] = dict(scene["materials"])
        for key, value in params.items():
            dst = new_scene["materials"] if key in GRAD_KEYS else new_scene
            dst[key] = torch.clamp(value.detach() - lr * grads[key], min=0.0)
        return loss, new_scene

    train_step.programs = programs
    return train_step
