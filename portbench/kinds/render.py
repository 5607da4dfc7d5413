"""render: back-to-back renders of one user (the CLI's closed loop):
`render_lanes_wavefront` (the loop of `render`) at the traffic's width,
height and spp, a new seed a call; the sampled pixels of each image are
kept on the device and compared with the reference after the window.
The traced slice is one render at the traffic's `slice` size."""
import time

import numpy as np

from pbh import cells, tracing


class Render(cells.Kind):
    SPAN_REQUEST = "render"
    TINY_TRAFFIC = {"width": 12, "height": 12, "spp": 2, "check_pixels": 48}
    CARD_TRAFFIC = {"width": 64, "height": 64, "check_pixels": 512}

    def setup_requests(self):
        """The warm-up renders."""
        return self.traffic.get("warmup", 1)

    def setup(self):
        from pbrlab_tpu_torch.render.integrator import render_lanes_wavefront

        self.render_fn = render_lanes_wavefront
        t = self.traffic
        self.w, self.h, self.spp = t["width"], t["height"], t["spp"]
        self.scene = self.port_scene()
        self.reseed(self.seed)
        for i in range(t.get("warmup", 1)):
            self._render(int(self.seeds[-1 - i]))
        self.sync()

    def reseed(self, seed):
        """Draw the seed's pixels and render seeds anew (the scene and its
        warm-up are kept)."""
        self.seed = seed
        self.rng = np.random.default_rng([seed, 1])
        self.pixels = self.sample_pixels(self.w, self.h,
                                         self.traffic["check_pixels"])
        self.pix_t = self.torch.as_tensor(self.pixels, device=self.device)
        self.seeds = cells.seed_words([seed, 2], 4096)
        self.kept, self.iters = [], []
        self.attempted = 0
        self.window = {}

    def requests_per_answer(self):
        return 1

    def _render(self, seed, w=None, h=None, spp=None):
        c = self.config
        return self.render_fn(self.scene, w or self.w, h or self.h,
                              spp or self.spp, seed, c["max_steps"],
                              k_volume=c["k_volume"], return_iters=True)

    def request(self):
        total, iters = self._render(int(self.seeds[self.attempted]))
        img = total / self.torch.tensor(float(self.spp), device=self.device)
        self.kept.append(img[self.pix_t])
        self.iters.append(int(iters))
        self.sync()

    def finish_window(self):
        n = self.attempted
        self.window["samples"] = n * self.w * self.h * self.spp
        self.window["subiters"] = sum(self.iters)

    def profile(self):
        """One render at the slice's size, once untraced (its wall, to
        show what tracing costs) and once under the profiler, which
        records device activity only."""
        s = self.traffic["slice"]

        def one():
            out = self._render(int(self.seeds[-100]), s["width"],
                               s["height"], s["spp"])
            self.sync()
            return out
        t0 = time.perf_counter()
        one()
        untraced = time.perf_counter() - t0
        out, red = tracing.profile(self.torch, one)
        red["untraced_s"] = untraced
        red["subiters"] = int(out[1])
        red["samples"] = s["width"] * s["height"] * s["spp"]
        self.slice = red

    def check(self, dtype=None):
        """The sampled pixels, assigned to the window's renders in turn,
        against the reference."""
        n = self.attempted
        k = len(self.pixels)
        got = self.torch.stack([self.kept[j % n][j] for j in range(k)])
        got = got.float().cpu().numpy()
        seeds = [int(self.seeds[j % n]) for j in range(k)]
        want = self.reference(dtype).pixel_means(
            self.w, self.h, self.pixels, seeds, self.spp,
            self.config["max_steps"], self.config["k_volume"]).cpu().numpy()
        return got, want


KIND = Render
