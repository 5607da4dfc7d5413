"""Profiling and observability (port of pbrlab_tpu.utils.profiling):
ray-count probes, a rays/s meter and profiler traces.

* `step_occupancy(scene, ...)`: the alive-lane fraction before each full
  step of one sample, on the scene's device.
* `ray_units(scene, ...)`: rays fired per pixel-sample at each step (a
  closest and a shadow ray per alive lane, one ray per volume lane per
  k_volume substep).
* `measure_sss_truncation(scene_np, ...)` / `measure_occupancy(scene_np,
  ...)`: the same probes on a `probe`^2 image of a numpy scene placed on
  `device` (None = CUDA, no fallback). Occupancy is the algorithm's, not
  the hardware's; the JAX package forces its CPU BVH walk here, the port
  traces through the scene's own backend (the kernels on the card, their
  plain twins on the CPU), which can move a tied or grazing lane.
* `RaysMeter`: accumulates (rays, seconds) over timed render calls.
* `trace(logdir)`: a `torch.profiler` window written as a Chrome trace.
"""
from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass, field
from typing import List

import torch


def _probe_scene(scene_np, device):
    from ..scene.scene import build_fat_tables, scene_to_device

    return build_fat_tables(scene_to_device(scene_np, device))


@torch.no_grad()
def step_occupancy(scene, width: int, height: int, max_steps: int,
                   sample_id=0, seed: int = 0) -> torch.Tensor:
    """Alive-lane fraction before each wavefront step -> [max_steps]."""
    from ..render.integrator import init_state, wavefront_step
    from ..scene.scene import build_fat_tables

    if "mat_fat" not in scene:
        scene = build_fat_tables(scene)
    state = init_state(scene, width, height, sample_id, seed)
    fracs = []
    for _ in range(max_steps):
        fracs.append(state.alive.to(torch.float32).mean())
        state = wavefront_step(scene, state)
    return torch.stack(fracs)


@torch.no_grad()
def ray_units(scene, width: int, height: int, max_steps: int,
              k_volume: int = 0, sample_id=0, seed: int = 0
              ) -> torch.Tensor:
    """Rays fired per pixel-sample, per step -> [max_steps].

    A full step fires one closest hit per alive lane plus one shadow ray
    per shading lane (counted as alive x 2); each k_volume substep fires
    one closest hit per volume lane (counted exactly)."""
    from ..render.integrator import MODE_VOLUME, init_state, wavefront_step
    from ..scene.scene import build_fat_tables

    if "mat_fat" not in scene:
        scene = build_fat_tables(scene)
    state = init_state(scene, width, height, sample_id, seed)
    per_step = []
    for _ in range(max_steps):
        units = 2.0 * state.alive.to(torch.float32).mean()
        state = wavefront_step(scene, state)
        for i in range(k_volume):
            vol = state.alive & (state.mode == MODE_VOLUME)
            units = units + vol.to(torch.float32).mean()
            state = wavefront_step(scene, state, freeze_surface=True,
                                   resolve_pending=(i == 0))
        per_step.append(units)
    return torch.stack(per_step)


@torch.no_grad()
def measure_sss_truncation(scene_np, max_steps: int, k_volume: int = 0,
                           probe: int = 96, sample_id=0, seed: int = 0,
                           device=None) -> float:
    """Fraction of SSS random walks still inside the medium when the
    (1 + k_volume) * max_steps budget runs out, over one sample of a
    `probe`^2 image on `device` (None = CUDA). The reference walks up to
    8192 steps (random-walk-sss.h:281); a truncated walk biases radiance
    down. `integrator.auto_k_volume` thresholds it."""
    from ..render.integrator import MODE_VOLUME, init_state, wavefront_step

    scene = _probe_scene(scene_np, device)
    state = init_state(scene, probe, probe, sample_id, seed)
    started = torch.zeros((), dtype=torch.int64, device=state.org.device)
    for _ in range(max_steps):
        pre = state.mode == MODE_VOLUME
        state = wavefront_step(scene, state)
        started += (~pre & (state.mode == MODE_VOLUME) & state.alive).sum()
        for i in range(k_volume):
            state = wavefront_step(scene, state, freeze_surface=True,
                                   resolve_pending=(i == 0))
    truncated = (state.alive & (state.mode == MODE_VOLUME)).sum()
    return float(truncated) / max(float(started), 1.0)


def measure_occupancy(scene_np, max_steps: int, probe: int = 128,
                      k_volume: int = 0, device=None) -> float:
    """Sum over the steps of rays fired per pixel-sample (`ray_units` on a
    `probe`^2 image on `device`, None = CUDA): the x2 closest + shadow
    factor and the k_volume substep rays included, so W*H*spp times it is
    a render's ray count."""
    scene = _probe_scene(scene_np, device)
    return float(ray_units(scene, probe, probe, max_steps, k_volume).sum())


@dataclass
class RaysMeter:
    """Accumulates timed render work and reports throughput.

    rays per sample-pass = n_pixels * occupancy_steps * 2
    (one closest hit + one any-hit trace per alive lane per step).
    """

    n_pixels: int
    occupancy_steps: float
    rays: float = 0.0
    seconds: float = 0.0
    laps: List[float] = field(default_factory=list)

    @contextlib.contextmanager
    def lap(self, spp: int = 1):
        """Time a block that renders `spp` sample passes (the block ends
        its device work, e.g. with torch.cuda.synchronize())."""
        t0 = time.perf_counter()
        yield
        dt = time.perf_counter() - t0
        self.laps.append(dt)
        self.seconds += dt
        self.rays += self.n_pixels * spp * self.occupancy_steps * 2.0

    @property
    def mrays_per_s(self) -> float:
        return self.rays / max(self.seconds, 1e-12) / 1e6

    def report(self) -> dict:
        return {
            "rays": self.rays,
            "seconds": round(self.seconds, 4),
            "mrays_per_s": round(self.mrays_per_s, 3),
            "laps": len(self.laps),
        }


@contextlib.contextmanager
def trace(logdir: str):
    """`torch.profiler.profile` over the block (CPU, and CUDA where a card
    is present), written to logdir/trace.json as a Chrome trace (open in
    chrome://tracing or Perfetto). Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
