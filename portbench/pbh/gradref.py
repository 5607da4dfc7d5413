"""The plain reference of the gradient cell: pbrlab's path tracer under
torch autograd (`pbref.path.radiance`), the program's train step's
loss and clipped SGD step, and the numbers that compare the two.

A train step renders `spp` samples of every pixel (seed 0, as the
program's step does), takes the sum over pixels of the squared
difference of their mean to the target, its gradient to the six
material columns and the face emission, and steps each leaf by
-lr * gradient, clipped at 0. The reference renders the pixels in blocks
of rows, each block's loss backpropagated into the leaves, so it fits
beside nothing but itself on the card. It follows the program's first
steps from the scene's own leaves, and one step of the window from the
leaves the program held before it.
"""
from __future__ import annotations

import numpy as np

from pbref import path as ref_path
from pbref import scene as ref_scene
from pbref.trace import Tracer

GRAD_KEYS = ("base_color", "subsurface_color", "subsurface_radius",
             "roughness", "specular", "metallic")
ZERO_GRAD = 1e-3  # leaves whose reference gradient is under this share of
# the median leaf's move by round-off alone: they are not compared


def reference_steps(torch, raw, device, width, height, spp, max_steps,
                    k_volume, lr, targets, steps, block, dtype=None,
                    start=None):
    """-> (losses [steps], leaf states [steps + 1] of {leaf: numpy array},
    each step's gradients [steps] of {leaf: numpy array}), from the
    scene's leaves or from `start` ({leaf: numpy array}); with dtype
    (bfloat16: the precision control) the paths are traced in it."""
    dtype = dtype or torch.float32
    geo = ref_scene.Geometry(raw)
    tracer = Tracer(geo.v0, geo.e1, geo.e2, device, dtype)
    base = ref_scene.material_columns(raw.materials, device)
    params = {k: base[k] for k in GRAD_KEYS}
    params["face_emission"] = torch.from_numpy(geo.emission).to(device)
    if start is not None:
        params = {k: torch.from_numpy(start[k]).to(device) for k in params}
    states = [{k: v.cpu().numpy() for k, v in params.items()}]
    losses, all_grads = [], []
    n = width * height
    for i in range(steps):
        leaves = {k: v.detach().clone().requires_grad_()
                  for k, v in params.items()}
        tgt = targets[i].reshape(-1, 3)
        total = 0.0
        for b0 in range(0, n, block):
            b1 = min(n, b0 + block)
            mats = {**base, **{k: leaves[k] for k in GRAD_KEYS}}
            tab = ref_scene.tables(geo, mats, leaves["face_emission"], device,
                                   dtype)
            pix = torch.arange(b0, b1, device=device)
            acc = 0.0
            for s in range(spp):
                acc = acc + ref_path.radiance(
                    tab, tracer, width, height, pix,
                    torch.full_like(pix, s), torch.zeros_like(pix),
                    max_steps, k_volume, dtype)
            loss = ((acc / spp - tgt[b0:b1]) ** 2).sum()
            loss.backward()
            total += float(loss.detach())
        grads = {k: v.grad if v.grad is not None else torch.zeros_like(v)
                 for k, v in leaves.items()}
        all_grads.append({k: g.cpu().numpy() for k, g in grads.items()})
        params = {k: torch.clamp(v.detach() - lr * grads[k], min=0.0)
                  for k, v in leaves.items()}
        losses.append(total)
        states.append({k: v.cpu().numpy() for k, v in params.items()})
    return losses, states, all_grads


def face_slots(scene_np, raw):
    """The program's slot of each of the reference's faces (mesh order),
    found by the face's exact corner and edges in the program's committed
    scene: the program's per-face leaves are read in the reference's
    order through it, and one window step starts the reference from
    them."""
    geo = ref_scene.Geometry(raw)

    def key(v0, e1, e2):
        return v0.tobytes() + e1.tobytes() + e2.tobytes()
    slots = {key(scene_np["tri_v0"][i], scene_np["tri_e1"][i],
                 scene_np["tri_e2"][i]): i
             for i in np.nonzero(scene_np["face_area"] > 0)[0]}
    out = np.asarray([slots.get(key(geo.v0[i], geo.e1[i], geo.e2[i]), -1)
                      for i in range(geo.v0.shape[0])], np.int64)
    if (out < 0).any() or np.unique(out).size != out.size:
        raise ValueError("the program's faces do not match the scene's")
    return out


def worst(values):
    """The largest value; NaN where any is NaN (a side that gives no
    number fails)."""
    values = [float(v) for v in values]
    return float("nan") if not values or any(np.isnan(v) for v in values) \
        else max(values)


def _norm(x):
    return float(np.linalg.norm(np.asarray(x, np.float64).ravel()))


def compared_leaves(first_grad):
    """The leaves whose reference gradient is not nought to rounding:
    norm at least ZERO_GRAD of the median leaf's."""
    norms = {k: _norm(g) for k, g in first_grad.items()}
    med = float(np.median(list(norms.values())))
    return [k for k, v in norms.items() if v >= ZERO_GRAD * med]


def worst_gap(prog, ref, keys):
    """max over leaves of |norm(prog) - norm(ref)| / max(norm(ref), the
    median leaf's norm(ref)): a gap of norms, not a norm of the gap."""
    if not keys:  # no leaf to compare: a non-finite gradient
        return float("nan")
    rn = {k: _norm(ref[k]) for k in keys}
    med = float(np.median(list(rn.values())))
    return worst(abs(_norm(prog[k]) - rn[k]) / max(rn[k], med, 1e-30)
                 for k in keys)


def numbers(prog_losses, prog_states, ref_losses, ref_states, ref_grads,
            lr):
    """(loss_gap, grad_gap, change_gap) over the steps the reference
    followed: the worst step's relative loss gap; the first gradient as
    the optimizer got it, (leaf before - leaf after) / lr, by the worst
    leaf; the leaves' change over the steps, by the worst leaf."""
    steps = len(ref_losses)
    loss_gap = worst(abs(p - r) / max(abs(r), 1e-30)
                     for p, r in zip(prog_losses[:steps], ref_losses))
    keys = compared_leaves(ref_grads[0])

    def first(states):
        return {k: (states[0][k] - states[1][k]) / lr for k in keys}

    def change(states):
        return {k: states[steps][k] - states[0][k] for k in keys}

    return (loss_gap, worst_gap(first(prog_states), first(ref_states), keys),
            worst_gap(change(prog_states), change(ref_states), keys))


def step_numbers(prog_loss, before, prog_after, ref_loss, ref_after,
                 ref_grad, lr):
    """(loss_gap, grad_gap) of one step that both sides took from the same
    leaves `before`: the relative loss gap, and the gradient as the
    optimizer got it, (before - after) / lr, by the worst leaf (leaves
    chosen by this step's reference gradient)."""
    keys = compared_leaves(ref_grad)

    def grad(after):
        return {k: (before[k] - after[k]) / lr for k in keys}

    return (abs(prog_loss - ref_loss) / max(abs(ref_loss), 1e-30),
            worst_gap(grad(prog_after), grad(ref_after), keys))
