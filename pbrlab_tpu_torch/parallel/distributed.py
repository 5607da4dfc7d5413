"""Multi-process rendering over `torch.distributed` (port of
pbrlab_tpu.parallel.distributed).

Each process (rank) owns one device of the mesh and renders one
contiguous slice of the padded pixel ids (`parallel.sharding`); the
scene is broadcast from rank 0 and the image all-gathered as host
copies, so every rank returns the whole image. The only traffic is that
broadcast and that gather, as in the JAX package: the render itself is
embarrassingly parallel, and the per-lane counter-seeded RNG keeps the
image the single-process render's to the bit. The reference's only
parallelism is a thread pool over tiles (render.cc:192-241).
"""
from __future__ import annotations

import os
from typing import Dict, List

import numpy as np
import torch
import torch.distributed as dist

from ..render.integrator import render_lanes_wavefront
from ..scene.scene import build_fat_tables, scene_from_numpy
from .sharding import padded_lanes, scene_on


def init_distributed(coordinator: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None,
                     backend: str | None = None) -> bool:
    """Join the process group from the arguments or the JAX package's
    environment names: PBRLAB_COORDINATOR (host:port, or a URL such as
    tcp://host:port), PBRLAB_NUM_PROCESSES, PBRLAB_PROCESS_ID. No
    coordinator: nothing to join (one process), returns False. The
    backend is "nccl" when CUDA is present and "gloo" without it, unless
    named; NCCL refuses two ranks on one card, so such ranks name
    "gloo". Returns True when more than one process runs."""
    coordinator = coordinator or os.environ.get("PBRLAB_COORDINATOR")
    if num_processes is None and "PBRLAB_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["PBRLAB_NUM_PROCESSES"])
    if process_id is None and "PBRLAB_PROCESS_ID" in os.environ:
        process_id = int(os.environ["PBRLAB_PROCESS_ID"])
    if coordinator is None:
        return False
    if num_processes is None or process_id is None:
        raise ValueError("init_distributed: a coordinator needs the number "
                         "of processes and this process's id")
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if "://" not in coordinator:
        coordinator = f"tcp://{coordinator}"
    dist.init_process_group(backend, init_method=coordinator,
                            world_size=num_processes, rank=process_id)
    return dist.get_world_size() > 1


def _world():
    """(rank, world size); (0, 1) outside a process group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def global_mesh(device=None) -> List[torch.device]:
    """One device per rank. With no `device`, rank r's card
    `cuda:{r mod cards}` (the ranks of a host take its cards in turn; more
    ranks than cards share them), raising without a card; with
    device="cpu", the CPU for every rank."""
    _, world = _world()
    if device is not None and torch.device(device).type == "cpu":
        return [torch.device("cpu")] * world
    if not torch.cuda.is_available():
        raise RuntimeError("global_mesh: no CUDA device; pass device='cpu' "
                           "for CPU ranks")
    cards = torch.cuda.device_count()
    return [torch.device("cuda", r % cards) for r in range(world)]


def _comm_device(device: torch.device) -> torch.device:
    """Where a collective's tensors live: the card under NCCL, the host
    under gloo (which cannot all-gather CUDA tensors)."""
    if dist.get_backend() == "nccl":
        return device
    return torch.device("cpu")


def replicate_scene(scene: Dict, mesh: List[torch.device]) -> Dict:
    """The scene (a numpy or torch dict, the same keys and shapes on
    every rank) as tensors on this rank's device, every value broadcast
    from rank 0."""
    rank, world = _world()
    device = mesh[rank]
    if not all(torch.is_tensor(v) or isinstance(v, dict)
               for v in scene.values()):
        scene = scene_from_numpy(scene, "cpu")
    if world == 1:
        return scene_on(scene, device)
    comm = _comm_device(device)
    out = {}
    for key in sorted(scene):  # one order on every rank
        val = scene[key]
        if isinstance(val, dict):
            out[key] = replicate_scene(val, mesh)
            continue
        buf = val.to(comm).contiguous()
        if buf.dtype == torch.bool:  # gloo has no bool broadcast
            buf = buf.to(torch.uint8)
        dist.broadcast(buf, src=0)
        out[key] = buf.to(device=device, dtype=val.dtype)
    return out


def render_distributed(scene: Dict, width: int, height: int, spp: int,
                       mesh: List[torch.device] | None = None, seed=0,
                       max_steps: int = 32, k_volume: int = 0) -> np.ndarray:
    """Mean radiance [H, W, 3] (numpy float32) on every rank: rank r
    renders slice r of the padded pixel ids on mesh[r]
    (`render_lanes_wavefront(lane=...)`), then the slices are
    all-gathered. `scene` is the host scene dict, the same on every
    rank (rank 0's is broadcast)."""
    mesh = mesh or global_mesh()
    rank, world = _world()
    if len(mesh) != world:
        raise ValueError(f"render_distributed: a mesh of {len(mesh)} "
                         f"devices for {world} ranks (one device a rank)")
    n = width * height
    lanes = padded_lanes(n, world)
    per = lanes.shape[0] // world
    scene_r = build_fat_tables(replicate_scene(scene, mesh))
    local = render_lanes_wavefront(scene_r, width, height, spp, seed,
                                   max_steps, k_volume=k_volume,
                                   lane=lanes[rank * per:(rank + 1) * per])
    if world > 1:
        local = local.to(_comm_device(mesh[rank]))
        parts = [torch.empty_like(local) for _ in range(world)]
        dist.all_gather(parts, local)
        local = torch.cat(parts)
    total = local.cpu().numpy()[:n].reshape(height, width, 3)
    return total / np.float32(spp)  # the IEEE quotient, as `render`'s
