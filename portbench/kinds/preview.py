"""preview: one progressive renderer, passes back to back, live material
edits between them (the GUI's edit queue): an edit drawn from the seed
queued before every `edit_every`-th pass; the average image's sampled
pixels are kept at the end of each run of passes between edits and
compared, for runs drawn from the seed, with the reference under the
materials the edits had set. The traced slice is `slice_passes` passes,
the first after an edit."""
import time

import numpy as np

from pbh import cells, tracing


class Preview(cells.Kind):
    SPAN_REQUEST = "progressive.pass"
    TINY_TRAFFIC = {"width": 12, "height": 12, "check_pixels": 48,
                    "edit_every": 3}
    CARD_TRAFFIC = {"width": 64, "height": 64, "check_pixels": 512}

    def setup_requests(self):
        """The warm-up passes and the edit pass after them."""
        return self.traffic.get("warmup_passes", 2) + 1

    def setup(self):
        from pbrlab_tpu_torch.render.progressive import ProgressiveRenderer

        t = self.traffic
        self.w, self.h = t["width"], t["height"]
        self.pixels = self.sample_pixels(self.w, self.h, t["check_pixels"])
        self.render_seed = int(cells.seed_words([self.seed, 3], 1)[0])
        self.r = ProgressiveRenderer(
            self.port_scene(), self.w, self.h,
            material_names=self.raw.material_names, seed=self.render_seed,
            max_steps=self.config["max_steps"],
            k_volume=self.config["k_volume"])
        self.edits = []  # (material, param, value)
        self.segments = []  # (edits applied, passes, sampled average)
        self.pass_ms, self.edit_pass_ms = [], []
        for _ in range(t.get("warmup_passes", 2)):
            self._pass()
        self._pass(edit=True)
        self.sync()

    def _edit(self):
        t = self.traffic
        mat = str(self.rng.choice(t["edit_materials"]))
        param = str(self.rng.choice(sorted(t["edit_params"])))
        lo, hi = t["edit_params"][param]
        width = 3 if param in ("base_color", "subsurface_radius",
                               "subsurface_color") else 1
        val = self.rng.uniform(lo, hi, size=width).astype(np.float32)
        value = [float(x) for x in val] if width == 3 else float(val[0])
        return mat, param, value

    def _pass(self, edit=False):
        if edit:
            if self.r.num_passes:
                self.segments.append((len(self.edits), self.r.num_passes,
                                      self.r.average().reshape(-1, 3)[
                                          self.pixels].copy()))
            e = self._edit()
            self.edits.append(e)
            self.r.queue_edit(*e)
        t0 = time.perf_counter()
        self.r.step()
        return (time.perf_counter() - t0) * 1e3

    def request(self):
        edit = (self.attempted + 1) % self.traffic["edit_every"] == 0
        ms = self._pass(edit)
        self.pass_ms.append(ms)
        if edit:
            self.edit_pass_ms.append(ms)

    def requests_per_answer(self):
        return 2 * self.traffic["edit_every"]

    def begin_window(self):
        self.first_segment = len(self.segments)
        self.pick = None

    def finish_window(self):
        self.window["pass_ms"] = self.pass_ms
        self.window["edit_pass_ms"] = self.edit_pass_ms
        # the runs of passes that the window completed, and the last one
        self.segments.append((len(self.edits), self.r.num_passes,
                              self.r.average().reshape(-1, 3)[
                                  self.pixels].copy()))
        self.last_segment = len(self.segments)

    def profile(self):
        """`slice_passes` passes across an edit, once untraced (their
        wall) and once under the profiler (device activity only)."""
        def passes():
            for i in range(self.traffic["slice_passes"]):
                self._pass(edit=(i == 0))
            self.sync()
        t0 = time.perf_counter()
        passes()
        untraced = time.perf_counter() - t0
        _, red = tracing.profile(self.torch, passes)
        red["untraced_s"] = untraced
        self.slice = red

    def check(self, dtype=None):
        """The average image after a run of passes, for runs drawn from the
        seed (the last one always), against the reference with the
        materials the edits had set."""
        segs = self.segments[self.first_segment:self.last_segment]
        if self.pick is None:  # drawn once a window
            self.pick = sorted({len(segs) - 1} | set(self.rng.choice(
                len(segs), size=min(len(segs), self.traffic["check_runs"])
                - 1, replace=False).tolist()))
        got, want = [], []
        names = self.raw.material_names
        for i in self.pick:
            n_edits, passes, avg = segs[i]
            mats = self.scene_def.material_columns(self.raw, self.device)
            for mat, param, value in self.edits[:n_edits]:
                mats[param][names.index(mat)] = self.torch.as_tensor(
                    value, dtype=self.torch.float32)
            want.append(self._accumulate(
                self.reference(dtype, materials=mats), passes))
            got.append(avg)
        return np.concatenate(got), np.concatenate(want)

    def _accumulate(self, ref, passes):
        """The progressive average: passes 0..n-1 (one sample a pixel,
        sample id = pass) summed in order, divided by n."""
        return ref.pixel_means(self.w, self.h, self.pixels,
                               [self.render_seed] * len(self.pixels), passes,
                               self.config["max_steps"],
                               self.config["k_volume"]).cpu().numpy()


KIND = Preview
