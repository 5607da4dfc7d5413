"""grad: back-to-back steps of `train_step_builder`'s differentiable-
rendering step (the inverse-rendering user), each against a target image
drawn from the seed. Set-up builds the step and drives it through its
first `ref_steps` steps (the graphs' captures), keeping the leaves after
each; the window steps the same object on, and keeps the leaves from
before its last step, that step's target, and the leaves after it.

The reference follows the set-up's steps from the scene's own leaves,
and the window's last step from the leaves the program held before it:
each step's loss, the gradient as the optimizer got it, and the change
of the leaves over the set-up's steps. The device memory in use is read
from the driver after every step of the window. The traced slice is one
step under the profiler recording device activity only (busy, idle,
breakdown), and once more recording the host's operators too, for the
per-depth backward's kernels."""
import time

from pbh import cells, gradref, tracing


class Grad(cells.Kind):
    SPAN_REQUEST = "train.step"
    TINY_TRAFFIC = {"width": 12, "height": 12, "ref_block": 64}
    CARD_TRAFFIC = {"width": 64, "height": 64, "ref_block": 4096}

    def setup_requests(self):
        """The steps the reference follows from the scene's leaves."""
        return self.traffic["ref_steps"]

    def setup(self):
        from pbrlab_tpu_torch.parallel.sharding import train_step_builder

        t, c = self.traffic, self.config
        self.w, self.h, self.spp = t["width"], t["height"], t["spp"]
        # the loss sums over pixels, so the step that keeps the leaves on
        # a stable descent shrinks with their number
        self.lr = t["lr_pixels"] / (self.w * self.h)
        self.scene_np = self.scene_def.to_port(self.raw)
        self.face_slots = gradref.face_slots(self.scene_np, self.raw)
        self.step = train_step_builder(
            self.w, self.h, self.spp, [self.device], max_steps=c["max_steps"],
            lr=self.lr, k_volume=c["k_volume"])
        self.gen = self.torch.Generator(device=self.device)
        self.reseed(self.seed)

    def reseed(self, seed):
        """The initial scene, the seed's targets, and the first
        `ref_steps` steps, the leaves kept after each."""
        from pbrlab_tpu_torch.scene.scene import scene_from_numpy

        if seed != getattr(self, "ref_seed", None):
            self.ref_setup = None  # the reference of the set-up's steps
        self.seed = self.ref_seed = seed
        self.attempted = 0
        self.window = {}
        self.ref = None
        self.last = None
        self.state = scene_from_numpy(self.scene_np, self.device)
        self.gen.manual_seed(int(cells.seed_words([seed, 4], 1)[0]))
        self.losses = []
        self.states = [self._leaves()]
        self.targets = []
        for _ in range(self.traffic["ref_steps"]):
            self._step()
            self.states.append(self._leaves())
        self.sync()

    def _leaves(self, state=None):
        from pbrlab_tpu_torch.parallel.sharding import GRAD_KEYS

        state = self.state if state is None else state
        out = {k: state["materials"][k].cpu().numpy() for k in GRAD_KEYS}
        out["face_emission"] = state["face_emission"].cpu().numpy()[
            self.face_slots]  # the reference's face order
        return out

    def _target(self):
        """A target image [H, W, 3] in [0, scale): drawn on the device."""
        return self.traffic["target_scale"] * self.torch.rand(
            (self.h, self.w, 3), generator=self.gen, device=self.device)

    def _step(self):
        """One step -> (the scene it started from, its target); the step
        makes a new scene and leaves the one it is given as it was."""
        tgt = self._target()
        if len(self.targets) < self.traffic["ref_steps"]:
            self.targets.append(tgt)
        before = self.state
        loss, self.state = self.step(self.state, tgt)
        self.losses.append(float(loss))
        return before, tgt

    def requests_per_answer(self):
        return 2

    def begin_window(self):
        """What set-up left in the allocator's cache is given back, so the
        window's reading of device memory is what its steps hold: the
        kept programs' graph pools and the steps' own tensors."""
        self.sync()
        self.used = 0
        if self.device.type == "cuda":
            self.torch.cuda.empty_cache()

    def request(self):
        self.last = self._step()
        if self.device.type == "cuda":
            free, total = self.torch.cuda.mem_get_info(self.device)
            self.used = max(self.used, total - free)

    def finish_window(self):
        self.window["steps"] = self.attempted
        if self.device.type == "cuda":
            self.window["device_used_bytes"] = self.used
        before, tgt = self.last
        self.window_step = (self._leaves(before), tgt, self.losses[-1],
                            self._leaves())

    def profile(self):
        """One step from the window's last scene against a fresh target,
        run three times on the same inputs: untraced (its wall), traced
        with device activity only, and traced with the host's operators
        (for the backward's kernels). The step leaves the scene as it
        was, so the three do the same work."""
        tgt = self._target()

        def one():
            loss, _ = self.step(self.state, tgt)
            return float(loss)
        self.sync()
        t0 = time.perf_counter()
        one()
        untraced = time.perf_counter() - t0
        _, self.slice = tracing.profile(self.torch, one)
        _, self.slice["with_host"] = tracing.profile(self.torch, one,
                                                     host=True)
        self.slice["untraced_s"] = untraced

    def followed(self, dtype=None):
        """The reference's (set-up steps, window step), each as
        `reference_steps` gives it, in float32 or `dtype`. The set-up
        steps' float32 reference depends on the seed alone (the scene's
        leaves, the seed's targets) and is kept for a rerun of the seed
        (a fault's)."""
        t, c = self.traffic, self.config

        def steps(targets, n, start=None):
            return self.scene_def.reference_steps(
                self.torch, self.raw, self.device, self.w, self.h, self.spp,
                c["max_steps"], c["k_volume"], self.lr, targets, n,
                t["ref_block"], dtype, start=start)
        before, tgt, _, _ = self.window_step
        if dtype is not None:
            setup = steps(self.targets, t["ref_steps"])
        else:
            if self.ref_setup is None:
                self.ref_setup = steps(self.targets, t["ref_steps"])
            setup = self.ref_setup
        return setup, steps([tgt], 1, start=before)

    def gaps(self, side):
        """{number: value} of one side (the program's, or the control's:
        (set-up losses, set-up leaf states, window step's loss, leaves
        after it)) against the float32 reference."""
        lr = self.lr
        (losses, states, grads), (w_losses, w_states, w_grads) = self.ref
        loss_gap, grad_gap, change_gap = gradref.numbers(
            side[0], side[1], losses, states, grads, lr)
        w_loss, w_grad = gradref.step_numbers(
            side[2], self.window_step[0], side[3], w_losses[0], w_states[1],
            w_grads[0], lr)
        return {"loss_gap": gradref.worst([loss_gap, w_loss]),
                "grad_gap": gradref.worst([grad_gap, w_grad]),
                "change_gap": change_gap}

    def compare(self, keep_program=False):
        if not keep_program:
            self.step = None  # the program's programs and buffers go
            if self.device.type == "cuda":
                self.torch.cuda.empty_cache()
        if self.ref is None:
            self.ref = self.followed()
        _, _, loss, after = self.window_step
        return self.gaps((self.losses, self.states, loss, after))

    def control(self):
        """The reference in bfloat16 in the program's place."""
        (losses, states, _), (w_losses, w_states, _) = self.followed(
            self.torch.bfloat16)
        return self.gaps((losses, states, w_losses[0], w_states[1]))


KIND = Grad
