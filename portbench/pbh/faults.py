"""Faults planted in the program's timed path, to show that the comparison
catches them: each is called with the cell's kind object before its
set-up (or, for a kept train step, before the steps it breaks) and a
`patch(obj, name, value)` that replaces an attribute until the caller
undoes it. Used by the tests (on the CPU) and by `control.py` (on the
card, where a training cell's faults set the upper readings)."""
from __future__ import annotations

import torch


def step_unchanged(kind, patch):
    """wavefront_step returns the paths it was given (render, preview);
    the train step returns the scene it was given (grad)."""
    import pbrlab_tpu_torch.parallel.sharding as sharding
    import pbrlab_tpu_torch.render.integrator as integrator

    patch(integrator, "wavefront_step",
          lambda scene, state, *a, **k: state)
    build = sharding.train_step_builder

    def builder(*a, **k):
        step = build(*a, **k)
        return lambda scene, target: (step(scene, target)[0], scene)
    patch(sharding, "train_step_builder", builder)
    step = getattr(kind, "step", None)
    if step is not None:
        patch(kind, "step", lambda scene, target: (step(scene, target)[0],
                                                   scene))


def half_batch(kind, patch):
    """Half of the work left out, the mean taken over the rest: a render
    of half the samples, scaled back (render); each pass's odd pixels
    replaced by their even neighbours (preview); the gradient taken from
    the even pixels only, doubled (grad)."""
    import pbrlab_tpu_torch.parallel.sharding as sharding
    import pbrlab_tpu_torch.render.integrator as integrator
    import pbrlab_tpu_torch.render.progressive as progressive

    wave = integrator.render_lanes_wavefront

    def half_render(scene, w, h, spp, *a, **k):
        total, it = wave(scene, w, h, max(1, spp // 2), *a, **k)
        return total * (spp / max(1, spp // 2)), it
    patch(integrator, "render_lanes_wavefront", half_render)
    sample = progressive.render_sample

    def half_sample(*a, **k):
        img = sample(*a, **k)
        flat = img.reshape(-1, 3).clone()
        flat[1::2] = flat[0:-1:2][:flat[1::2].shape[0]]
        return flat.reshape(img.shape)
    patch(progressive, "render_sample", half_sample)
    lanes = sharding.render_lanes

    def half_lanes(*a, **k):
        out = lanes(*a, **k)
        even = (torch.arange(out.shape[0], device=out.device) % 2 == 0)
        return torch.where(even[:, None], 2 * out - out.detach(),
                           out.detach())
    patch(sharding, "render_lanes", half_lanes)


def answer_altered(kind, patch):
    """The answer changed where it is produced, by 5%: the render's sum, a
    pass's image, the train step's loss."""
    import pbrlab_tpu_torch.parallel.sharding as sharding
    import pbrlab_tpu_torch.render.integrator as integrator
    import pbrlab_tpu_torch.render.progressive as progressive

    wave = integrator.render_lanes_wavefront

    def render(*a, **k):
        total, it = wave(*a, **k)
        return total * 1.05, it
    patch(integrator, "render_lanes_wavefront", render)
    sample = progressive.render_sample
    patch(progressive, "render_sample",
          lambda *a, **k: sample(*a, **k) * 1.05)
    build = sharding.train_step_builder

    def altered(step):
        def run(scene, target):
            loss, new = step(scene, target)
            return loss * 1.05, new
        return run
    patch(sharding, "train_step_builder",
          lambda *a, **k: altered(build(*a, **k)))
    step = getattr(kind, "step", None)
    if step is not None:
        patch(kind, "step", altered(step))


FAULTS = {"step_unchanged": step_unchanged, "half_batch": half_batch,
          "answer_altered": answer_altered}


class Patches:
    """`patch(obj, name, value)` and `undo()`, for use outside pytest."""

    def __init__(self):
        self._saved = []

    def __call__(self, obj, name, value):
        self._saved.append((obj, name, getattr(obj, name)))
        setattr(obj, name, value)

    def undo(self):
        while self._saved:
            obj, name, value = self._saved.pop()
            setattr(obj, name, value)
