"""The general generator: a traffic kind is a class (`KIND`) in its own
file, `portbench/kinds/<kind>.py`, found by the name the cell's traffic
file gives (`"kind"`), and driven by that traffic file
(`portbench/traffic/<mix>.json`) and the configuration's file
(`portbench/configs/<config>.json`), whose `"scene"` names the scene
(`portbench/scenes/<scene>.py`, `pbh.scenes`).

Every kind builds its scene from the configuration, warms up the shapes
its traffic uses (set-up), runs back-to-back requests of one closed-loop
user until `seconds` have passed (the window: every request that starts
in it is completed and counted, with all of its time), optionally
profiles a slice, and compares the window's answers with the plain
reference once the window has closed and the device peak was read.

A kind subclasses `Kind` and gives `setup()`, `request()` (one request
of the window), `finish_window()`, `profile()` (the traced slice) and
`compare()` ({number: value} of the window's answers against the
reference); `kinds/render.py`, `kinds/preview.py` and `kinds/grad.py`
are the first. It also names, in its own file, what the harness's
readers and tests need of it, so that a new kind needs no edit
elsewhere:
- `SPAN_REQUEST`: the name of the program's request (`utils.profiling`)
  that one request of the window makes, and `setup_requests()`, how many
  of them set-up made first (`pbh.spans`); a kind without it has no
  span metric;
- `TINY_TRAFFIC` and `CARD_TRAFFIC`: the traffic's keys that the tests
  shrink, on the CPU and on a card (`runner.resize_for`).
A subclass inherits them.
"""
from __future__ import annotations

import time

import numpy as np

from . import byname, checks, scenes


def seed_words(seed, n):
    """n seeds in [0, 2^31) drawn from the run's seed (any whole number)."""
    return np.random.default_rng(seed).integers(0, 2 ** 31, size=n)


class Kind:
    SPAN_REQUEST = None  # no span metric reads the kind's requests

    def __init__(self, torch, cell, config, traffic, seed, device):
        self.torch = torch
        self.cell, self.config, self.traffic = cell, config, traffic
        self.seed, self.device = seed, device
        self.rng = np.random.default_rng([seed, 1])
        self.scene_def = scenes.load(config["scene"])
        self.raw = self.scene_def.make_scene(config)
        self.window = {}
        self.slice = None
        self.attempted = 0

    def sync(self):
        if self.device.type == "cuda":
            self.torch.cuda.synchronize(self.device)

    def port_scene(self):
        from pbrlab_tpu_torch.scene.scene import (build_fat_tables,
                                                  scene_from_numpy)

        self.scene_np = self.scene_def.to_port(self.raw)
        self.table_bytes = {k: int(v.nbytes) for k, v in self.scene_np.items()
                            if isinstance(v, np.ndarray)}
        return build_fat_tables(scene_from_numpy(self.scene_np, self.device))

    def sample_pixels(self, width, height, count):
        return np.sort(self.rng.choice(width * height, size=min(
            count, width * height), replace=False))

    def compare(self, dtype=None):
        """{number: value} of the window's answers against the reference
        (a render or a preview: the sampled pixels)."""
        got, want = self.check(dtype)
        l1, bias = checks.image_numbers(got, want)
        return {"pixel_l1": l1, "mean_bias": bias}

    def reference(self, dtype=None, **kw):
        """The scene's reference renderer, in float32 or `dtype`."""
        return self.scene_def.Reference(self.torch, self.raw, self.device,
                                        dtype, **kw)

    def begin_window(self):
        pass

    def run_window(self, seconds):
        start = last = time.perf_counter()
        walls = []
        while True:
            self.request()
            self.attempted += 1
            now = time.perf_counter()
            walls.append(now - last)
            last = now
            if now - start >= seconds:
                break
        self.window["seconds"] = now - start
        self.window["requests"] = self.attempted
        self.window["walls"] = walls


def load(name):
    """The traffic kind `name`: `KIND` of `portbench/kinds/<name>.py`."""
    kind = getattr(byname.module("kinds", name), "KIND", None)
    if not (isinstance(kind, type) and issubclass(kind, Kind)):
        raise KeyError(f"kinds/{name}.py defines no KIND (a cells.Kind)")
    return kind
