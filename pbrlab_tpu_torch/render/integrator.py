"""Wavefront path-tracing integrator (port of pbrlab_tpu.render.integrator:
`wavefront_step`, the persistent-lane `render_lanes_wavefront` / `render`,
and the scan path `render_lanes` / `render_sample` / `render_scan`).

One SoA `PathState` of N lanes; every `wavefront_step` advances each lane
by one trace: a surface bounce, or one step of the random-walk SSS
("volume mode"). Next-event estimation is deferred: the shadow ray a step
emits is answered inside the next step's closest-hit launch (the dual
dense_v4 or dense_v5 kernel; a second launch on the large-scene backends).
RNG streams are per lane and counter-seeded, so a
lane's result does not depend on where it sits in the wavefront.

The JAX package's `lax.while_loop` / `lax.scan` / `lax.cond` are Python
control flow here. The loop test, the volume-window test and the scan's
"any lane in volume mode" test read a device value, one host read each
per trip. On the card the while loop's body runs as CUDA graphs of its
branches (`_WavefrontLoop`, `render.graphs`), the counterpart of the
JAX package's compiled `render`; the scan path's steps run as the
captured phases of a program that outlives a call (`_LanesProgram`,
kept in a `render.graphs.Programs`), forward and, under autograd, its
per-depth backward: the counterparts of the jitted `render_scan` and of
the train step's `jax.value_and_grad`.

Gradients flow through `render_lanes` (and so `render_sample`) by torch
autograd, to the material, emission and texture leaves the fat tables
are built from. Geometry is not differentiated: the gradient stops where
the JAX package stops it (the trace results, the shading frame and hit
point, the sampled scatter distance and the pdf denominators; see
`render_lanes`), and the trace kernels run outside autograd. The
persistent-lane `render_lanes_wavefront` and `render_scan` run under
`torch.no_grad()`: they are forward-only, as the JAX package's while
loop is; gradients go through `render_lanes` and `render_sample`.

The scan path renders one sample of every pixel per `render_lanes` call:
`max_steps` full steps, each followed by `k_volume` unwindowed volume
substeps while a lane walks, the compaction every `sort_every` steps, and
one any-hit trace for the last step's deferred NEE. `render_scan` sums
`render_sample` over the samples in order; per lane the work is the
wavefront's, so `render_scan` and `render` give the same image: to the
bit on the CPU, and on CUDA but for denormal sums, which the
framebuffer's atomic adds (`index_add_`) flush to zero.

On a CUDA device with grad mode off, on a baked scene with no texture
atlas and no hair (`fused_step`), a step runs as two CUDA kernels
around its trace launch (`ops/step.py`), one thread a lane, in place of
the ~3,600 kernels of its torch chain, with the chain's bits; the loops
step their packed rows. The chain (`_wavefront_step_chain`) is the
kernels' plain twin, the autograd path (the gradient pass's per-depth
recompute) and every other case's.

Hair: a lane whose closest hit is a curve with a hair material shades in
the hair frame (tangent, ribbon offset h) with the Principled Hair BSDF
(`shading/hair.py`): NEE without the hemisphere test, 4 closure draws, no
SSS entry.

Instanced scenes (`scene.instanced`) trace through dense_v5i and shade
from a narrow per-(instance, face) row plus the shared local face row,
with the normals rotated into world space per lane. Textured scenes fetch
base and subsurface colour from the quad-texel atlas at the hit's uv.

The triangle backend is the scene's (`intersect._tri_backend`) unless the
caller forces one with `tri_backend`, the counterpart of the JAX package's
PBRLAB_TRACE_BACKEND knob: "dense4", "dense5", "dense5l", "dense5s",
"dense5i", a legacy one, "dense3" (dense_v3) or "dense" / "dense2"
(dense_v2), or "bvh", the threaded-BVH walk that is the JAX package's
default on its CPU (hair then walks the curve BVH, as there); every
`commit` adds the legacy and bvh tables.

The JAX package's other PBRLAB_* environment knobs are not ported
(ROADMAP A17).
"""
from __future__ import annotations

import contextlib
import functools
from typing import NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

from ..core import rng as prng
from ..core.math import (EPS, F32_EPS, INF, gather_rows, saturate,
                         spectrum_norm, vdot, vnormalize)
from ..core.onb import branchless_onb, to_global, to_local
from ..core.sampling import (cosine_sample_hemisphere, power_heuristic_weight,
                             uniform_sample_sphere)
from ..ops import step as step_kernels
from ..ops.dense_v4 import slab_interval
from ..ops.intersect import (has_curves, occluded_scene, sparse_backend,
                             trace_scene, trace_scene_dual)
from ..scene.lights import sample_all_light
from ..scene.materials import KIND_HAIR, unpack_material_rows
from ..scene.scene import build_fat_tables
from ..scene.textures import fetch_float3_quad
from ..shading import hair, principled
from ..shading.principled import PrincipledBsdf
from ..shading.sss import sample_scatter_distance, scattering_coefficients
from ..utils import profiling
from .camera import generate_rays
from .graphs import EagerRunner, GraphRunner, Programs, put

MODE_SURFACE = 0
MODE_VOLUME = 1

FRONT = 0
BACK = 1
AMBIGUOUS = 2


class PathState(NamedTuple):
    org: torch.Tensor  # [N,3]
    direction: torch.Tensor  # [N,3]
    min_t: torch.Tensor  # [N]
    throughput: torch.Tensor  # [N,3]
    contribution: torch.Tensor  # [N,3]
    bsdf_pdf: torch.Tensor  # [N] previous bounce bsdf pdf (MIS)
    rng: torch.Tensor  # [N] uint32 value in int64 (core.rng)
    alive: torch.Tensor  # [N] bool
    first: torch.Tensor  # [N] bool: no surface shade done yet
    mode: torch.Tensor  # [N] int32
    vol_first: torch.Tensor  # [N] bool: next volume step keeps entry dir
    sss_sigma_t: torch.Tensor  # [N,3]
    sss_sigma_s: torch.Tensor  # [N,3]
    sss_tp: torch.Tensor  # [N,3] walk throughput
    sss_instance: torch.Tensor  # [N] entry instance id
    lane: torch.Tensor  # [N] claimed pixel
    sample: torch.Tensor  # [N] sample index within the pixel
    depth: torch.Tensor  # [N] full steps taken for the current sample
    nee_dir: torch.Tensor  # [N,3] pending shadow direction (origin = org)
    nee_contrib: torch.Tensor  # [N,3] contribution if unoccluded
    nee_maxt: torch.Tensor  # [N] shadow max distance; < 0 = no pending


def _signature_word(scene, direction, org, min_t):
    """Coarse BVH-subtree-hit signature per lane: bit i is set iff the
    ray's slab test can hit subtree i of the commit-time cut
    (scene["sig_aabb"], <= 29 subtrees). Sorting lanes by it keeps the
    trace kernels' per-group survivor unions tight."""
    aabb = scene["sig_aabb"]
    tnear, tfar = slab_interval(aabb, org, direction, min_t)
    mask = tnear <= tfar * 1.00000024
    bits = torch.arange(aabb.shape[1], device=org.device)
    return (mask.to(torch.int64) << bits).sum(dim=1)


# --- packed loop carry ---------------------------------------------------
# The loop state rides as ONE [N, 39] float32 matrix, so the compaction
# permutes it with one row gather. unpack(pack(s)) == s exactly (ints are
# < 2^24; the rng word rides bit-cast).
_PACK_COLS = 39  # layout below; update both functions together


def pack_state(state: PathState) -> torch.Tensor:
    """PathState -> [N, 39] f32 rows (org 0:3 | dir 3:6 | min_t 6 |
    throughput 7:10 | contribution 10:13 | bsdf_pdf 13 | rng 14 (bit-cast)
    | alive 15 | first 16 | mode 17 | vol_first 18 | sss_sigma_t 19:22 |
    sss_sigma_s 22:25 | sss_tp 25:28 | sss_instance 28 | lane 29 |
    sample 30 | depth 31 | nee_dir 32:35 | nee_contrib 35:38 | nee_maxt 38)."""
    def col(x):
        return x.to(torch.float32)[:, None]

    return torch.cat([
        state.org, state.direction, col(state.min_t), state.throughput,
        state.contribution, col(state.bsdf_pdf),
        prng.state_to_f32(state.rng)[:, None], col(state.alive),
        col(state.first), col(state.mode), col(state.vol_first),
        state.sss_sigma_t, state.sss_sigma_s, state.sss_tp,
        col(state.sss_instance), col(state.lane), col(state.sample),
        col(state.depth), state.nee_dir, state.nee_contrib,
        col(state.nee_maxt),
    ], dim=1)


def unpack_state(packed: torch.Tensor) -> PathState:
    """[N, 39] rows -> PathState (slices)."""
    i32 = torch.int32
    return PathState(
        org=packed[:, 0:3], direction=packed[:, 3:6], min_t=packed[:, 6],
        throughput=packed[:, 7:10], contribution=packed[:, 10:13],
        bsdf_pdf=packed[:, 13], rng=prng.state_from_f32(packed[:, 14]),
        alive=packed[:, 15] > 0.5, first=packed[:, 16] > 0.5,
        mode=packed[:, 17].to(i32), vol_first=packed[:, 18] > 0.5,
        sss_sigma_t=packed[:, 19:22], sss_sigma_s=packed[:, 22:25],
        sss_tp=packed[:, 25:28], sss_instance=packed[:, 28].to(i32),
        lane=packed[:, 29].to(i32), sample=packed[:, 30].to(i32),
        depth=packed[:, 31].to(i32), nee_dir=packed[:, 32:35],
        nee_contrib=packed[:, 35:38], nee_maxt=packed[:, 38])


def compact_packed(packed: torch.Tensor, scene) -> torch.Tensor:
    """Sort lanes by (alive volume, alive surface, dead) then the subtree
    signature, with one gather of the packed rows. Alive volume lanes come
    first, so the k_volume substeps can run on a leading window."""
    sig = _signature_word(scene, packed[:, 3:6], packed[:, 0:3], packed[:, 6])
    mode = packed[:, 17].to(torch.int64)
    primary = torch.where(packed[:, 15] > 0.5, 1 - mode, 2 + mode)
    return packed[torch.argsort((primary << 29) | sig, stable=True)]


def compact_state(state: PathState, scene) -> PathState:
    """`compact_packed` on a PathState: the JAX package's compact_state
    permutation (key (primary << 29) | signature, stable argsort), every
    field carried through one gather of the packed rows."""
    return unpack_state(compact_packed(pack_state(state), scene))


def _classify(direction, ng, ns):
    """Front/back/ambiguous (shader-utils.h:151-159)."""
    dg = vdot(direction, ng)
    ds = vdot(direction, ns)
    return torch.where((dg < 0.0) & (ds < 0.0), FRONT,
                       torch.where((dg > 0.0) & (ds > 0.0), BACK, AMBIGUOUS))


def _surface_attribs(frow, u, v):
    """Shading attributes (ng, ns, uv) from gathered fat face rows
    (scene.cc:210-249; layout: scene.build_fat_tables)."""
    ng = frow[:, 0:3]
    corner_ns = frow[:, 3:12].reshape(-1, 3, 3)
    w0 = (1.0 - u - v)[..., None]
    ns_lerp = vnormalize(corner_ns[:, 0] * w0 + corner_ns[:, 1] * u[..., None]
                         + corner_ns[:, 2] * v[..., None])
    ns = torch.where(frow[:, 18:19] > 0.0, ns_lerp, ng)
    corner_uv = frow[:, 12:18].reshape(-1, 3, 2)
    uv_lerp = (corner_uv[:, 0] * w0 + corner_uv[:, 1] * u[..., None]
               + corner_uv[:, 2] * v[..., None])
    uv = torch.where(frow[:, 19:20] > 0.0, uv_lerp, torch.stack([u, v], dim=-1))
    return ng, ns, uv


def _rows(table, idx):
    """table[clip(idx, 0, rows - 1)] for an index column idx [N] (int or
    float)."""
    i = torch.clamp(idx.to(torch.int64), 0, table.shape[0] - 1)
    return gather_rows(table, i)


def _fetch_face_fat(scene, safe_prim):
    """Per-lane face row [N, 26] (layout: build_fat_tables' face_fat).
    Baked scenes: one face_fat row. Instanced scenes: the narrow iface_fat
    row and the shared local_fat row, the local normals rotated into world
    space by the instance's normal matrix (inst_shade[:, 12:21]); the
    instance column is the world instance (mesh-instance.h:23-36)."""
    if "iface_fat" not in scene:
        return gather_rows(scene["face_fat"], safe_prim)
    irow = gather_rows(scene["iface_fat"], safe_prim)  # mat pdf em3 inst slot 0
    lrow = _rows(scene["local_fat"], irow[:, 6])  # ng cns uv has_ns has_uv
    nrm = _rows(scene["inst_shade"], irow[:, 5])[:, 12:21].detach().reshape(
        -1, 3, 3)

    def rot(v):  # nrm @ v per lane, summed in index order
        return (nrm[:, :, 0] * v[:, 0:1] + nrm[:, :, 1] * v[:, 1:2]
                + nrm[:, :, 2] * v[:, 2:3])

    cns = lrow[:, 3:12].reshape(-1, 3, 3)
    cns_w = torch.cat([vnormalize(rot(cns[:, i])) for i in range(3)], dim=1)
    # rows without shading normals (zero corners) stay exactly zero
    cns_w = torch.where(lrow[:, 18:19] > 0.0, cns_w, 0.0)
    return torch.cat([vnormalize(rot(lrow[:, 0:3])), cns_w, lrow[:, 12:20],
                      irow[:, 0:6]], dim=1)


def _gather_material(scene, mat_id):
    return unpack_material_rows(_rows(scene["mat_fat"], mat_id))


def _fetch_colors(scene, mat, uv):
    """base_color / subsurface_color, fetched from the quad-texel atlas at
    uv where the material's tex id is >= 0 (cycles-principled-shader.cc
    :281-301). A scene without textures has no texture_quad and skips the
    fetch."""
    if "texture_quad" not in scene:
        return mat["base_color"], mat["subsurface_color"]
    out = []
    for key in ("base_color", "subsurface_color"):
        tid = mat[f"{key}_tex_id"]
        out.append(torch.where(
            (tid >= 0)[..., None],
            fetch_float3_quad(scene["texture_quad"], scene["texture_sizes"],
                              tid, uv[..., 0], uv[..., 1]), mat[key]))
    return tuple(out)


def _nee(scene, pos, geom_normal, omega_out_local, ex, ey, ez,
         bsdf: PrincipledBsdf, hair_b, is_hair, u0, u1, u2, shade_mask):
    """Deferred next-event estimation (DirectIllumination,
    shader-utils.h:166-212) without the trace: returns
    (contribution if unoccluded, shadow direction, shadow max t, -1 where
    there is no query). The next step's trace launch answers the query.

    geom_normal is the flipped shading normal ez on principled lanes, the
    curve tangent on hair lanes (hair-shader.cc:190). Hair lanes (is_hair;
    hair_b None in a hair-free scene) skip the hemisphere test (:199) and
    divide f*cos by |omega_l.x| (:196-198)."""
    light = sample_all_light(scene, u0, u1, u2)
    to_light = light.position - pos
    dist = torch.sqrt(torch.clamp(vdot(to_light, to_light), min=1e-12))
    wl = to_light / dist[..., None]
    wl_dot_nl = -vdot(wl, light.normal)
    wl_dot_np = vdot(wl, geom_normal)
    denom = wl_dot_nl * wl_dot_np
    pdf_sigma = torch.clamp(torch.abs(
        light.pdf * dist * dist
        / torch.where(torch.abs(denom) > 1e-12, denom, 1e-12)), max=1e30)
    hemisphere_ok = (wl_dot_nl > 0.0) & (wl_dot_np > 0.0)
    if hair_b is not None:
        hemisphere_ok = hemisphere_ok | is_hair
    candidate = shade_mask & light.valid & hemisphere_ok & (pdf_sigma > 0.0)
    shadow_max = torch.clamp(dist - EPS, min=EPS)
    omega_l = to_local(wl, ex, ey, ez)
    f, pdf_b = principled.eval_bsdf(omega_l, omega_out_local, bsdf)
    if hair_b is not None:
        fh_cos, pdf_h = hair.eval_cos_pdf(omega_l, omega_out_local, hair_b)
        fh = fh_cos / torch.clamp(torch.abs(omega_l[..., 0]),
                                  min=1e-12)[..., None]
        f = torch.where(is_hair[..., None], fh, f)
        pdf_b = torch.where(is_hair, pdf_h, pdf_b)
    w = power_heuristic_weight(pdf_sigma, pdf_b)
    contrib = f * light.emission * (w / torch.clamp(pdf_sigma, min=1e-12))[..., None]
    contrib = torch.where(
        candidate[..., None] & torch.isfinite(contrib).all(-1, keepdim=True),
        contrib, 0.0)
    return contrib, wl, torch.where(candidate, shadow_max, -1.0)


def fused_step(scene, device) -> bool:
    """Whether `wavefront_step` runs as the two kernels of `ops.step` for
    `scene` on `device`: a CUDA device, grad mode off, and a baked scene
    (no `iface_fat`) with no texture atlas (`texture_quad`) and no hair
    (`has_curves`). Everything else takes the torch chain, which is also
    the kernels' plain twin and the autograd path. The rule reads only
    what it can observe; it has no switch."""
    return (torch.device(device).type == "cuda"
            and not torch.is_grad_enabled() and "iface_fat" not in scene
            and "texture_quad" not in scene and not has_curves(scene))


def wavefront_step(scene, rows: torch.Tensor, freeze_surface: bool = False,
                   resolve_pending: bool = False, windowed: bool = False,
                   tri_backend: str | None = None) -> torch.Tensor:
    """Advance every lane by one trace: the packed state rows ([n, >= 39],
    `pack_state`'s columns first) -> the new rows [n, 39].

    Where `fused_step` holds, the step runs as two kernels around its
    trace launch (`ops.step`), with the torch chain's bits; else as the
    torch chain (`_wavefront_step_chain`, on the rows' PathState).

    freeze_surface=True runs a volume-only substep: surface-mode lanes do
    not trace, shade or draw, while volume-mode lanes advance one
    random-walk step (with the diffuse re-shade and deferred NEE on a valid
    exit). Pass resolve_pending=True on the first substep of a group:
    volume-entry lanes' deferred NEE must resolve before the walk moves
    their origin. Full steps always resolve every pending query.

    Traces take the scene's backend (`intersect._tri_backend`), or
    `tri_backend` where the caller forces one, except an unwindowed
    substep (freeze_surface and not windowed), whose wavefront is mostly
    dead lanes: it takes `sparse_backend` of that choice (dense_v5 for
    dense_v4, dense_v5l for dense_v5s; the legacy backends and bvh keep
    theirs), as the JAX package does. The lanes of a windowed substep are mostly
    walkers, so it keeps the choice. The choice changes the work, never a
    hit (the legacy kernels' group decisions aside: a grazing ray may hit
    in one cluster walk and miss in another).
    """
    args = (freeze_surface, resolve_pending, windowed, tri_backend)
    if fused_step(scene, rows.device):
        return _fused_step(scene, rows, *args)
    return pack_state(_wavefront_step_chain(scene, unpack_state(rows), *args))


def _fused_step(scene, rows, freeze_surface, resolve_pending, windowed,
                tri_backend):
    """`wavefront_step` on packed rows as `ops.step`'s two kernels around
    the chain's own trace launch -> the new rows [n, 39]."""
    backend = tri_backend
    if freeze_surface and not windowed:
        backend = sparse_backend(scene, tri_backend) or backend
    resolving = not freeze_surface or resolve_pending
    rays, shadow = step_kernels.pre(rows, freeze_surface, resolving)
    if resolving:
        hit, occ = trace_scene_dual(scene, *rays, *shadow, backend=backend)
    else:
        hit, occ = trace_scene(scene, *rays, backend=backend), None
    return step_kernels.shade(scene, rows, hit, occ, freeze_surface,
                              resolving)


def _volume_substeps(step, scene, state, k_volume, **kw):
    """The k_volume volume-only substeps of `state` through `step`:
    `wavefront_step` on packed rows, `_wavefront_step_chain` on a
    PathState."""
    for i in range(k_volume):
        state = step(scene, state, freeze_surface=True,
                     resolve_pending=(i == 0), **kw)
    return state


def _wavefront_step_chain(scene, state: PathState, freeze_surface=False,
                          resolve_pending=False, windowed=False,
                          tri_backend=None) -> PathState:
    """`wavefront_step` as a chain of torch operations on a PathState: the
    kernels' twin and the autograd path. A chain step on a CUDA device
    counts one `chain` in `ops.step.LAUNCHES`."""
    n = state.org.shape[0]
    dev = state.org.device
    if dev.type == "cuda":
        step_kernels.LAUNCHES["chain"] += 1
    surface_mode = state.mode == MODE_SURFACE
    volume_mode = state.mode == MODE_VOLUME

    # ---- pre-trace: volume direction + distance draws (fixed budget) ----
    rng_state, (ud1, ud2, uc, ut) = prng.draw_n(state.rng, 4)
    need_new_dir = volume_mode & ~state.vol_first
    direction = torch.where(need_new_dir[..., None],
                            uniform_sample_sphere(ud1, ud2), state.direction)
    min_t = torch.where(need_new_dir, 0.0, state.min_t)
    t_scatter, channel_pdf = sample_scatter_distance(
        state.sss_tp, state.sss_sigma_s, state.sss_sigma_t, uc, ut)
    # the sampled distance is detached, and so are the pdf denominators
    # below: g / detach(p) is the unbiased surrogate of the transport
    # derivative, a live p biases it (render_lanes)
    t_scatter = t_scatter.detach()
    max_t = torch.where(volume_mode, t_scatter,
                        -1.0 if freeze_surface else INF)
    max_t = torch.where(state.alive, max_t, -1.0)  # dead lanes: no traversal

    # ---- one trace launch: closest hit (+ the pending shadow queries) ----
    backend = tri_backend
    if freeze_surface and not windowed:
        backend = sparse_backend(scene, tri_backend) or backend
    nee_active = state.nee_maxt >= 0.0
    contribution = state.contribution
    resolved_now = torch.zeros((n,), dtype=torch.bool, device=dev)
    # the traces see detached rays: the kernels are outside autograd, and
    # their plain versions would otherwise record every walk
    rays = [x.detach() for x in (state.org, direction, min_t, max_t)]
    if not freeze_surface or resolve_pending:
        # full steps resolve every pending query; the first substep only
        # those of alive volume lanes, whose origin the walk moves next
        resolve_mask = (volume_mode & state.alive & nee_active
                        if freeze_surface else nee_active)
        hit, occ_prev = trace_scene_dual(
            scene, *rays, state.nee_dir.detach(),
            torch.full((n,), EPS, device=dev),
            torch.where(resolve_mask, state.nee_maxt, -1.0).detach(),
            backend=backend)
        contribution = contribution + torch.where(
            (resolve_mask & ~occ_prev)[..., None], state.nee_contrib, 0.0)
        resolved_now = resolve_mask
    else:
        # later substeps resolve nothing (the JAX package's all-dead
        # shadow trace here has no effect and is skipped)
        hit = trace_scene(scene, *rays, backend=backend)
    hit = {key: x.detach() for key, x in hit.items()}
    prim = hit["prim"]
    is_curve = hit["is_curve"]
    hit_ok = (prim >= 0) | is_curve
    t_eff = torch.where(volume_mode & ~hit_ok, t_scatter, hit["t"])
    # missed surface lanes carry t = INF; shade them at a finite dummy t
    t_shade = torch.where(hit_ok | volume_mode, t_eff, 1.0)
    pos = state.org + t_shade[..., None] * direction
    frow = _fetch_face_fat(scene, torch.clamp(prim, min=0).to(torch.int64))
    ng, ns, uv = _surface_attribs(frow, hit["u"], hit["v"])
    hit_instance = frow[:, 25].to(torch.int32)
    mat_id = frow[:, 20].to(torch.int32)
    with_hair = has_curves(scene)
    if with_hair:
        # a curve hit delivers its tangent through the normal slots
        # (scene.cc:222-224, hair-shader.cc:165) and its (u, v) as uv;
        # instance and material come from the segment's columns
        ic = is_curve[..., None]
        ng = torch.where(ic, hit["tangent"], ng)
        ns = torch.where(ic, hit["tangent"], ns)
        uv = torch.where(ic, torch.stack([hit["u"], hit["v"]], dim=-1), uv)
        seg = torch.clamp(hit["seg"], min=0).to(torch.int64)
        hit_instance = torch.where(is_curve, scene["curve_instance"][seg],
                                   hit_instance)
        mat_id = torch.where(is_curve, scene["curve_material"][seg], mat_id)
    ng, ns, uv, pos = (x.detach() for x in (ng, ns, uv, pos))
    face_dir = _classify(direction, ng, ns)

    alive = state.alive
    throughput = state.throughput

    # =========== SURFACE lanes: emission MIS + russian roulette ==========
    s_alive = alive & surface_mode
    if freeze_surface:
        s_alive = torch.zeros_like(s_alive)  # surface lanes pass through
    pdf_area = frow[:, 21].detach()
    nsd = vdot(ns, direction)
    a2sa = torch.abs(t_shade * t_shade
                     / torch.where(torch.abs(nsd) > 1e-12, nsd, 1e-12))
    mis_w = torch.where(state.first, 1.0,
                        power_heuristic_weight(state.bsdf_pdf, pdf_area * a2sa))
    add_em = (s_alive & hit_ok & ~is_curve & (face_dir == FRONT)
              & (pdf_area > 0.0))
    contribution = contribution + torch.where(
        add_em[..., None], mis_w[..., None] * frow[:, 22:25] * throughput, 0.0)

    rng_state, urr = prng.draw(rng_state)
    rr_p = spectrum_norm(throughput)
    rr_die = rr_p < urr
    throughput = torch.where(
        (s_alive & ~rr_die)[..., None],
        throughput / torch.clamp(rr_p, min=1e-12)[..., None], throughput)
    s_alive = s_alive & hit_ok & ~rr_die

    # ================== VOLUME lanes: one walk step ======================
    v_alive = alive & volume_mode
    rng_state, uvrr = prng.draw(rng_state)
    trans = torch.exp(-state.sss_sigma_t * t_eff[..., None])
    # detached pdf denominators; the numerators stay live, so radius and
    # albedo gradients flow
    pdf_hit = vdot(channel_pdf, trans).detach()
    pdf_scatter = vdot(channel_pdf, state.sss_sigma_t * trans).detach()
    sss_tp_hit = state.sss_tp * trans / torch.clamp(pdf_hit, min=1e-12)[..., None]
    sss_tp_scat = (state.sss_tp * (state.sss_sigma_s * trans)
                   / torch.clamp(pdf_scatter, min=1e-12)[..., None])
    sss_tp = torch.where(hit_ok[..., None], sss_tp_hit, sss_tp_scat)
    # a valid exit leaves through a back face of the entry instance
    # (random-walk-sss.h:371-384); any other hit kills the path
    exit_ok = (v_alive & hit_ok & ~is_curve
               & (hit_instance == state.sss_instance) & (face_dir == BACK))
    v_dead_exit = v_alive & hit_ok & ~exit_ok
    # scatter lanes: volume russian roulette (random-walk-sss.h:349-358)
    v_scatter = v_alive & ~hit_ok
    pv = saturate(spectrum_norm(sss_tp)).detach()
    v_rr_die = v_scatter & (uvrr >= pv)
    sss_tp = torch.where(v_scatter[..., None],
                         sss_tp / torch.clamp(pv, min=1e-12)[..., None], sss_tp)

    # ===================== SHADE (surface hit or SSS exit) ===============
    is_exit = exit_ok
    s_shade = s_alive & (face_dir != AMBIGUOUS)
    s_dead_amb = s_alive & (face_dir == AMBIGUOUS)
    shade_mask = s_shade | is_exit

    mat = _gather_material(scene, mat_id)
    hair_lane = is_curve & (mat["kind"] == KIND_HAIR) & s_shade
    # principled frame: ez = front ? ns : -ns (cycles-principled-shader.cc
    # :427-432); an SSS exit keeps +ns (random-walk-sss.h:386-398)
    ez = torch.where(is_exit[..., None] | (face_dir == FRONT)[..., None],
                     ns, -ns)
    geom_normal = ez  # of the NEE terms
    ex, ey = branchless_onb(ez)
    omega_out_g = torch.where(is_exit[..., None], direction, -direction)
    if with_hair:
        # hair frame: ex = tangent, ey = normalize((wo x ex) x ex),
        # ez = ex x ey (hair-shader.cc:164-173)
        ex_h = ns
        ey_h = vnormalize(torch.linalg.cross(
            torch.linalg.cross(omega_out_g, ex_h), ex_h))
        hl = hair_lane[..., None]
        ex = torch.where(hl, ex_h, ex)
        ey = torch.where(hl, ey_h, ey)
        ez = torch.where(hl, torch.linalg.cross(ex_h, ey_h), ez)
        geom_normal = torch.where(hl, ex_h, geom_normal)
    omega_out = to_local(omega_out_g, ex, ey, ez)

    base_color, sub_color = _fetch_colors(scene, mat, uv)
    bsdf = principled.param_to_bsdf(mat, base_color, sub_color)
    exit_bsdf = principled.diffuse_only_bsdf(sss_tp)
    bsdf = PrincipledBsdf(*[
        torch.where(is_exit.reshape(is_exit.shape + (1,) * (a.ndim - 1)), b, a)
        for a, b in zip(bsdf, exit_bsdf)])
    hair_b = None
    if with_hair:
        if "curve_color" in scene:
            # per-strand base color of a CyHair color block (rgb hair
            # coloring; -1 rows: no file color)
            ccol = scene["curve_color"][seg]
            use_c = is_curve & (ccol[:, 0] >= 0.0)
            mat = {**mat, "hair_base_color": torch.where(
                use_c[..., None], ccol, mat["hair_base_color"])}
        hair_b = hair.param_to_bsdf(mat, hit["v"])

    # --- NEE: deferred; the shade point is the lane's org until its next
    # trace, so the parked query's implicit origin stays valid ---
    rng_state, un = prng.draw_n(rng_state, 3)
    keep_maxt = torch.where(resolved_now, -1.0, state.nee_maxt)
    nee_c, wl_nee, smax_nee = _nee(scene, pos, geom_normal, omega_out, ex,
                                   ey, ez, bsdf, hair_b, hair_lane, un[0],
                                   un[1], un[2], shade_mask)
    sm = shade_mask[..., None]
    new_nee_dir = torch.where(sm, wl_nee, state.nee_dir)
    new_nee_contrib = torch.where(sm, throughput * nee_c, state.nee_contrib)
    new_nee_maxt = torch.where(shade_mask, smax_nee, keep_maxt)

    # --- closure sampling (principled: 3 draws, the 4th kept for the
    # stream layout; hair: 4, hair-shader.cc:207-211) ---
    rng_state, ub = prng.draw_n(rng_state, 4)
    omega_in, f, pdf_b, pick_sss_raw = principled.sample_surface(
        omega_out, bsdf, ub[0], ub[1], ub[2])
    # SSS entry only from front faces (random-walk-sss.h:236-239), never
    # from hair
    pick_sss = pick_sss_raw & s_shade & (face_dir == FRONT) & ~hair_lane
    sss_die = pick_sss_raw & s_shade & (face_dir != FRONT) & ~hair_lane

    factor = f * (torch.abs(omega_in[..., 2])
                  / torch.clamp(pdf_b, min=1e-12))[..., None]
    if with_hair:
        wi_h, fh_cos, pdf_h = hair.sample(omega_out, hair_b, *ub)
        omega_in = torch.where(hl, wi_h, omega_in)
        # hair throughput is f*cos / pdf with cos folded into f (:225)
        factor = torch.where(
            hl, fh_cos / torch.clamp(pdf_h, min=1e-12)[..., None], factor)
        pdf_b = torch.where(hair_lane, pdf_h, pdf_b)
    bad = ((pdf_b <= 0.0) | ~torch.isfinite(factor).all(-1)
           | ~torch.isfinite(pdf_b))
    cont_surface = shade_mask & ~pick_sss & ~bad
    new_dir_g = to_global(omega_in, ex, ey, ez)

    # SSS entry reuses the closure-sample draws for the entry cosine sample
    entry_g = to_global(-cosine_sample_hemisphere(ub[1], ub[2]), ex, ey, ez)
    entry_ok = pick_sss & (vdot(-ng, entry_g) > 0.0)
    sigma_t, sigma_s, sss_tp0 = scattering_coefficients(
        bsdf.subsurface_weight, bsdf.subsurface_albedo, bsdf.subsurface_radius)

    # ======================= state merge ================================
    new_alive = torch.where(surface_mode, cont_surface | entry_ok,
                            torch.where(v_scatter, v_alive & ~v_rr_die,
                                        cont_surface))
    new_alive = new_alive & alive & ~s_dead_amb & ~v_dead_exit & ~sss_die
    new_mode = torch.where(entry_ok | (v_scatter & ~v_rr_die), MODE_VOLUME,
                           MODE_SURFACE).to(torch.int32)
    new_throughput = torch.where(cont_surface[..., None],
                                 throughput * factor, throughput)
    new_org = torch.where(
        (shade_mask | entry_ok)[..., None], pos,
        torch.where(v_scatter[..., None],
                    state.org + t_eff[..., None] * direction, state.org))
    new_direction = torch.where(cont_surface[..., None], new_dir_g,
                                torch.where(entry_ok[..., None], entry_g,
                                            direction))
    new_min_t = torch.where(cont_surface | entry_ok, 1e-3,
                            torch.where(v_scatter, 0.0, min_t))
    # throughput black -> dead (render.cc:31)
    new_alive = new_alive & (torch.abs(new_throughput).sum(-1) > F32_EPS)
    e3 = entry_ok[..., None]

    new_state = PathState(
        org=new_org, direction=new_direction, min_t=new_min_t,
        throughput=new_throughput, contribution=contribution,
        bsdf_pdf=torch.where(cont_surface, pdf_b, state.bsdf_pdf),
        rng=rng_state, alive=new_alive, first=state.first & ~shade_mask,
        mode=new_mode,
        vol_first=entry_ok | (state.vol_first & ~volume_mode),
        sss_sigma_t=torch.where(e3, sigma_t, state.sss_sigma_t),
        sss_sigma_s=torch.where(e3, sigma_s, state.sss_sigma_s),
        sss_tp=torch.where(e3, sss_tp0,
                           torch.where(volume_mode[..., None], sss_tp,
                                       state.sss_tp)),
        sss_instance=torch.where(entry_ok, hit_instance, state.sss_instance),
        lane=state.lane, sample=state.sample, depth=state.depth,
        nee_dir=new_nee_dir, nee_contrib=new_nee_contrib,
        nee_maxt=new_nee_maxt)
    if freeze_surface:
        # surface lanes (incl. their RNG stream) pass through untouched;
        # lanes that left volume mode in this substep keep their new state
        new_state = PathState(*[
            torch.where(surface_mode.reshape(
                surface_mode.shape + (1,) * (new.ndim - 1)), old, new)
            for old, new in zip(state, new_state)])
    return new_state


def init_state(scene, width: int, height: int, sample_id, seed,
               lane=None) -> PathState:
    """Fresh camera paths for pixel ids `lane` [N] int32; None takes every
    pixel, arange(width * height) on the scene's device."""
    if lane is None:
        lane = torch.arange(width * height, dtype=torch.int32,
                            device=scene["aabb_min"].device)
    n = lane.shape[0]
    dev = lane.device
    rng_state = prng.seed_state(lane, sample_id, seed)
    rng_state, (u1, u2) = prng.draw_n(rng_state, 2)
    org, direction = generate_rays(scene, width, height, u1, u2, lane)
    f3 = torch.zeros((n, 3), device=dev)
    i32 = torch.int32
    return PathState(
        org=org, direction=direction, min_t=torch.zeros((n,), device=dev),
        throughput=torch.ones((n, 3), device=dev), contribution=f3,
        bsdf_pdf=torch.zeros((n,), device=dev), rng=rng_state,
        alive=torch.ones((n,), dtype=torch.bool, device=dev),
        first=torch.ones((n,), dtype=torch.bool, device=dev),
        mode=torch.zeros((n,), dtype=i32, device=dev),
        vol_first=torch.zeros((n,), dtype=torch.bool, device=dev),
        sss_sigma_t=torch.ones((n, 3), device=dev),
        sss_sigma_s=torch.ones((n, 3), device=dev),
        sss_tp=torch.ones((n, 3), device=dev),
        sss_instance=torch.full((n,), -1, dtype=i32, device=dev),
        lane=torch.arange(n, dtype=i32, device=dev),
        sample=torch.zeros((n,), dtype=i32, device=dev),
        depth=torch.zeros((n,), dtype=i32, device=dev),
        nee_dir=f3, nee_contrib=f3,
        nee_maxt=torch.full((n,), -1.0, device=dev))


# the tables `build_fat_tables` packs from the differentiable leaves (the
# material columns, face_emission, texture_atlas): a render's gradient
# reaches the leaves through them
FAT_KEYS = ("mat_fat", "face_fat", "iface_fat", "local_fat", "light_fat",
            "texture_quad")


def render_lanes(scene, width: int, height: int, sample_id, seed=0,
                 max_steps: int = 32, lane=None, remat: bool = False,
                 sort_every: int = 2, k_volume: int = 0,
                 tri_backend: str | None = None, programs=None):
    """One sample for pixel ids `lane` (None: every pixel) -> radiance
    [n_lanes, 3] in lane order, differentiable.

    `max_steps` full steps; after each, while a lane is alive in volume
    mode, `k_volume` volume-only substeps (unwindowed, so they trace
    through `sparse_backend`), giving a walk a (1 + k_volume) * max_steps
    budget like the reference's inner loop (random-walk-sss.h:281). With
    sort_every > 0 the lanes are compacted after every sort_every-th step
    and scattered back at the end (the same bits, per-lane RNG). A lane
    still alive after max_steps stops where it is. The last step's
    deferred NEE is answered by one any-hit trace. `tri_backend` forces
    the triangle backend (see `wavefront_step`).

    The steps run as the phases of a compiled program
    (`_LanesProgram`): CUDA graphs on a CUDA scene, op by op on the CPU.
    `programs` (`render.graphs.Programs`) keeps the program for later
    calls with the same static arguments, as `jax.jit`'s cache does; None
    makes one for this call.

    Gradients reach the scene's material, `face_emission` and
    `texture_atlas` leaves: the fat tables are built here from them when
    the scene has none. They stop where the JAX package stops them: the
    trace results (the kernels run outside autograd, on detached rays),
    the instance normal matrix, the hit point and shading frame (ng, ns,
    uv, pos), the emitter's area pdf, and the sampled scatter distance
    with the walk's pdf denominators (pdf_hit, pdf_scatter, the volume
    roulette's pv). The sampled value is detached, so a live pdf in the
    denominator would make a biased surrogate (its expectation picks up
    -E[f d(log p)], which flipped the sign of subsurface_radius
    gradients in the JAX package); g / detach(p) is equal in value and
    its derivative's expectation is the transport derivative.

    remat=True differentiates through the program, the counterpart of
    `lax.scan(jax.checkpoint(body))`'s VJP: the forward keeps one packed
    state a depth, and the backward recomputes each depth's activations
    from it, last depth first, one phase a depth (so the trace kernels
    launch once more). The RNG is counter-based and rides in the state,
    and the recompute takes the forward's recorded substep branch, so it
    gives the same bits; the gradients are remat=False's, whose eager
    autograd tape keeps every depth's activations."""
    if "mat_fat" not in scene:
        scene = build_fat_tables(scene)
    tables = [scene[k] for k in FAT_KEYS if k in scene]
    grad = torch.is_grad_enabled() and any(t.requires_grad for t in tables)
    if grad and not remat:
        return _render_lanes_tape(scene, width, height, sample_id, seed,
                                  max_steps, lane, False, sort_every,
                                  k_volume, tri_backend)
    prog = _lanes_program(programs or Programs(), scene, width, height,
                          lane, max_steps, sort_every, k_volume, tri_backend)
    if grad:
        return _LanesGrad.apply(prog, scene, sample_id, seed, lane, *tables)
    prog.forward(scene, sample_id, seed, lane)
    return prog.out.clone()


def _render_lanes_tape(scene, width, height, sample_id, seed, max_steps,
                       lane, remat, sort_every, k_volume, tri_backend):
    """`render_lanes` op by op on autograd's eager tape (the gradient of
    remat=False); with remat, each depth under `torch.utils.checkpoint`,
    which `chip_smoke.py` and the tests hold the program's backward
    against. The substeps' test reads the device once a depth."""
    state = init_state(scene, width, height, sample_id, seed, lane)
    n = state.org.shape[0]

    def body(state, depth):
        state = _wavefront_step_chain(scene, state, tri_backend=tri_backend)
        if k_volume and bool(  # host sync: skip when no lane walks
                (state.alive & (state.mode == MODE_VOLUME)).any()):
            state = _volume_substeps(_wavefront_step_chain, scene, state,
                                     k_volume, tri_backend=tri_backend)
        if sort_every and (depth + 1) % sort_every == 0:
            state = compact_state(state, scene)
        return state

    for depth in range(max_steps):
        if remat:
            state = checkpoint(body, state, depth, use_reentrant=False)
        else:
            state = body(state, depth)
    nee_active = state.nee_maxt >= 0.0
    occ = occluded_scene(
        scene, state.org.detach(), state.nee_dir.detach(),
        torch.full((n,), EPS, device=state.org.device),
        torch.where(nee_active, state.nee_maxt, -1.0).detach(),
        backend=tri_backend)
    return _finish(state, occ, sort_every)


def _finish(state, occ, sort_every):
    """The last deferred NEE's answer `occ` added, non-finite sums
    zeroed, and with sort_every the rows scattered back to lane order."""
    nee_active = state.nee_maxt >= 0.0
    contribution = state.contribution + torch.where(
        (nee_active & ~occ)[..., None], state.nee_contrib, 0.0)
    contribution = torch.where(torch.isfinite(contribution), contribution,
                               0.0)
    if sort_every:  # back to lane order
        contribution = torch.zeros_like(contribution).index_copy_(
            0, state.lane.to(torch.int64), contribution)
    return contribution


def _tensors(tree, path=()):
    """(path, tensor) of a scene dict, nested dicts included."""
    for key, val in tree.items():
        if isinstance(val, dict):
            yield from _tensors(val, path + (key,))
        else:
            yield path + (key,), val


def _own(tree):
    """A copy of a scene dict's tensors, detached (nested dicts too)."""
    return {k: _own(v) if isinstance(v, dict) else v.detach().clone()
            for k, v in tree.items()}


def _at(tree, path):
    for key in path:
        tree = tree[key]
    return tree


def _lanes_program(programs, scene, width, height, lane, max_steps,
                   sort_every, k_volume, tri_backend):
    """The `_LanesProgram` of these static arguments, from `programs`."""
    n = width * height if lane is None else lane.shape[0]
    dev = scene["mat_fat"].device
    shapes = tuple((path, tuple(t.shape), t.dtype)
                   for path, t in _tensors(scene))
    key = (dev, "render_lanes", width, height, n, max_steps, sort_every,
           k_volume, tri_backend, shapes)
    return programs.get(key, lambda runner: _LanesProgram(
        scene, width, height, n, max_steps, sort_every, k_volume,
        tri_backend, runner))


class _LanesProgram:
    """`render_lanes`'s compiled program: the JAX package's `lax.scan`
    body (pbrlab_tpu/render/integrator.py:938-983) as phases over
    buffers it allocates once, so CUDA graphs of them replay on every
    later call. Its scene is its own copy of the caller's tensors (fat
    tables included), refreshed in place by `load`; the sample id and
    the seed ride in `keys` and the pixel ids in `lane`, device buffers
    that (I) reads, so a replay renders the call's sample.

    Phases, in the JAX body's order: (I) `init_state` into `packed` (the
    [n, 39] state); per depth (S) one full step, the any-walker test in
    `probe` (the `lax.cond` at :949, read by the host), (V) the k_volume
    substeps when a lane walks, (C) the compaction every sort_every-th
    depth (host-known, :951); then (F) the last NEE's any-hit (its answer
    kept in `occ`), the isfinite mask and the scatter into `out`.

    The backward (`backward`, through `_LanesGrad`) is the VJP of
    `lax.scan(jax.checkpoint(body))`: (F-grad) the gradient of `out` to
    the last state, then per depth, last first, a (G) phase that
    recomputes the depth with grad from its saved entry state and takes
    the forward's substep branch (one graph per branch pair), giving the
    entry state's gradient and adding the fat tables' into `grads`."""

    def __init__(self, scene, width, height, n, max_steps, sort_every,
                 k_volume, tri_backend, runner):
        self.dev = dev = scene["mat_fat"].device
        self.width, self.height = width, height
        self.max_steps, self.sort_every = max_steps, sort_every
        self.k_volume, self.tri_backend = k_volume, tri_backend
        self.runner = runner
        self.tables = [k for k in FAT_KEYS if k in scene]
        self.scene = _own(scene)
        self._loaded = {path: (t, t._version) for path, t in _tensors(scene)}
        i64 = torch.int64
        self.keys = torch.zeros((2,), dtype=i64, device=dev)  # sample, seed
        self.pixels = torch.arange(n, dtype=torch.int32, device=dev)
        self.lane = self.pixels.clone()
        self.packed = torch.zeros((n, _PACK_COLS), device=dev)
        self.probe = torch.zeros((), dtype=i64, device=dev)
        self.occ = torch.zeros((n,), dtype=torch.bool, device=dev)
        self.out = torch.zeros((n, 3), device=dev)
        self.grads = None  # the backward's buffers, made by its first call

    @torch.no_grad()
    def load(self, scene):
        """Copy the caller's tensors that changed since the last load
        (another tensor, or one written in place) into the program's."""
        with profiling.span("lanes.load"):
            self._load(scene)

    def _load(self, scene):
        for path, src in _tensors(scene):
            last = self._loaded.get(path)
            if last is None or last[0] is not src or last[1] != src._version:
                _at(self.scene, path).copy_(src)
                self._loaded[path] = (src, src._version)

    def _compacts(self, depth):
        return bool(self.sort_every) and (depth + 1) % self.sort_every == 0

    @torch.no_grad()
    def forward(self, scene, sample_id, seed, lane, saved=None):
        """One sample into `out`; with `saved` ([max_steps + 1, n, 39]),
        each depth's entry state and the last state kept there. Returns
        each depth's substep branch (whether a lane walked)."""
        with _on(self.dev):
            self.load(scene)
            put(self.keys, [int(sample_id) & 0xFFFFFFFF,
                            int(seed) & 0xFFFFFFFF])
            self.lane.copy_(self.pixels if lane is None else lane)
            run = self.runner.run
            run("I", self.init)
            walked = []
            for depth in range(self.max_steps):
                if saved is not None:
                    saved[depth].copy_(self.packed)
                run("S", self.step)
                walked.append(bool(self.k_volume)
                              and bool(self.runner.read(self.probe)))
                if walked[-1]:
                    run("V", self.substeps)
                if self._compacts(depth):
                    run("C", self.compact)
            if saved is not None:
                saved[self.max_steps].copy_(self.packed)
            run("F", self.finish)
        return walked

    def backward(self, scene, saved, occ, walked, grad_out):
        """The gradient of `forward`'s `out` (cotangent `grad_out`) to
        the fat tables -> {key: gradient}, from the forward's `saved`
        states, its any-hit answer `occ` and its branches `walked`."""
        with _on(self.dev):
            if self.grads is None:
                self.x = torch.zeros_like(self.packed)  # a depth's entry
                self.g = torch.zeros_like(self.packed)  # its cotangent
                self.g_out = torch.zeros_like(self.out)
                self.grads = {k: torch.zeros_like(self.scene[k])
                              for k in self.tables}
            self.load(scene)
            self.g_out.copy_(grad_out)
            self.occ.copy_(occ)
            self.x.copy_(saved[self.max_steps])
            for g in self.grads.values():
                g.zero_()
            run = self.runner.run
            run("F-grad", self.finish_grad)
            for depth in reversed(range(self.max_steps)):
                self.x.copy_(saved[depth])
                vol, comp = walked[depth], self._compacts(depth)
                run("G" + "-V" * vol + "-C" * comp,
                    functools.partial(self.depth_grad, vol, comp))
            return {k: g.clone() for k, g in self.grads.items()}

    # --- phases ----------------------------------------------------------

    def init(self):
        """(I) fresh camera paths of the pixel ids in `lane`."""
        self.packed.copy_(pack_state(init_state(
            self.scene, self.width, self.height, self.keys[0], self.keys[1],
            self.lane)))

    def step(self):
        """(S) one full step; with substeps, whether a lane walks in the
        probe."""
        p = wavefront_step(self.scene, self.packed,
                           tri_backend=self.tri_backend)
        self.packed.copy_(p)
        if self.k_volume:
            self.probe.copy_(((p[:, 15] > 0.5) & (p[:, 17] > 0.5)).any())

    def substeps(self):
        """(V) the k_volume volume-only substeps."""
        self.packed.copy_(_volume_substeps(
            wavefront_step, self.scene, self.packed, self.k_volume,
            tri_backend=self.tri_backend))

    def compact(self):
        """(C) the compaction."""
        self.packed.copy_(compact_packed(self.packed, self.scene))

    def finish(self):
        """(F) the last deferred NEE's any-hit into `occ`, the radiance in
        lane order into `out`."""
        st = unpack_state(self.packed)
        self.occ.copy_(occluded_scene(
            self.scene, st.org, st.nee_dir,
            torch.full(st.min_t.shape, EPS, device=self.dev),
            torch.where(st.nee_maxt >= 0.0, st.nee_maxt, -1.0),
            backend=self.tri_backend))
        self.out.copy_(_finish(st, self.occ, self.sort_every))

    def finish_grad(self):
        """(F-grad) the cotangent `g` of the last state, from `g_out`."""
        with torch.enable_grad():
            x = self.x.detach().requires_grad_()
            g, = torch.autograd.grad(
                _finish(unpack_state(x), self.occ, self.sort_every), [x],
                [self.g_out])
        self.g.copy_(g)

    def depth_grad(self, walked, compacts):
        """(G) one depth's backward: its step (and substeps, compaction)
        recomputed with grad from the entry state `x`; the cotangent `g`
        of its exit state becomes the entry state's, and the fat tables'
        gradients add into `grads`. Each running sum enters the backward
        first (through a view), so the depth's terms add onto it in the
        order of one eager tape's backward."""
        with torch.enable_grad():
            x = self.x.detach().requires_grad_()
            tables = {k: self.scene[k].detach().requires_grad_()
                      for k in self.tables}
            scene = {**self.scene, **tables}
            st = _wavefront_step_chain(scene, unpack_state(x),
                                       tri_backend=self.tri_backend)
            if walked:
                st = _volume_substeps(_wavefront_step_chain, scene, st,
                                      self.k_volume,
                                      tri_backend=self.tri_backend)
            p = pack_state(st)
            if compacts:
                p = compact_packed(p, scene)
            leaves = list(tables.values())
            got = torch.autograd.grad(
                [p] + [t.view_as(t) for t in leaves], [x] + leaves,
                [self.g] + [self.grads[k] for k in tables])
        self.g.copy_(got[0])
        for k, gk in zip(tables, got[1:]):
            self.grads[k].copy_(gk)


class _LanesGrad(torch.autograd.Function):
    """`render_lanes(remat=True)` with grad: the program's forward, which
    keeps each depth's entry state, and its per-depth backward, whose fat
    tables' gradients autograd carries on to the leaves through
    `build_fat_tables`."""

    @staticmethod
    def forward(ctx, prog, scene, sample_id, seed, lane, *tables):
        saved = torch.empty((prog.max_steps + 1,) + tuple(prog.packed.shape),
                            device=prog.dev)
        ctx.walked = prog.forward(scene, sample_id, seed, lane, saved)
        ctx.prog, ctx.scene, ctx.saved = prog, scene, saved
        ctx.occ = prog.occ.clone()
        return prog.out.clone()

    @staticmethod
    def backward(ctx, grad_out):
        grads = ctx.prog.backward(ctx.scene, ctx.saved, ctx.occ, ctx.walked,
                                  grad_out)
        ctx.saved = None
        return (None,) * 5 + tuple(
            grads[k] if need else None
            for k, need in zip(ctx.prog.tables, ctx.needs_input_grad[5:]))


def _on(dev):
    """The device context a program's CUDA calls run in."""
    return torch.cuda.device(dev) if dev.type == "cuda" else \
        contextlib.nullcontext()


def render_lanes_wavefront(scene, width: int, height: int, spp: int,
                           seed=0, max_steps: int = 32, k_volume: int = 0,
                           n_lanes: int = 65536, vol_window: int | None = None,
                           flush_every: int = 4, return_iters: bool = False,
                           tri_backend: str | None = None, lane=None):
    """Full-occupancy forward render: persistent lanes + a pixel work queue
    (the reference's atomic tile queue, render.cc:203-222). Returns the
    summed radiance [n, 3] of the pixel ids `lane` [n] (None: every
    pixel, n = width * height) in their order (divide by spp for the
    mean), and with return_iters the number of sub-iterations run. The
    queue runs over local slots 0..n-1; a claim of slot p seeds the RNG
    and the camera ray from pixel lane[p], so a slice renders its pixels'
    bits of the whole image (a shard of `parallel.sharding`).

    A lane that finishes its pixel's last sample claims the next unclaimed
    pixel (rank among same-iteration claimants via a cumsum). A pixel's
    samples run on one lane in order, each sample's RNG stream is a pure
    function of (pixel, sample, seed), so the image does not depend on the
    claim schedule or on the compaction permutation.

    Each sub-iteration: refill, one full `wavefront_step`, the compaction
    sort, then k_volume volume-only substeps. They run on the leading
    `vol_window` rows (alive volume lanes sort first) when the walkers fit,
    and on every lane otherwise; vol_window=None takes 3/8 of the lanes,
    vol_window >= n_lanes runs them on every lane before the sort. Per lane
    the window changes nothing, only the work done. Finished pixels park
    their sum in a pend slot that is scattered into the framebuffer once
    every flush_every sub-iterations. `tri_backend` forces the triangle
    backend of every trace (see `wavefront_step`); None keeps the scene's.

    On a CUDA scene the loop's phases run as CUDA graphs, captured in the
    call and replayed (`render.graphs.GraphRunner`), the port of the JAX
    package's compiled loop; on the CPU they run op by op. The host reads
    only what the JAX body branches on: the loop test once every
    flush_every sub-iterations and the window test once a sub-iteration.

    The call is a `render` request of `utils.profiling` (when no span is
    open) counting `subiters`, `lane_slots` (n_lanes x sub-iterations)
    and `lanes_alive` (the alive lanes entering each full step, summed on
    the device and read with the last loop test).
    """
    fb, it = _wavefront(None, scene, width, height, spp, seed, max_steps,
                        k_volume, n_lanes, vol_window, flush_every,
                        tri_backend, lane)
    return (fb, it) if return_iters else fb


@torch.no_grad()
def _wavefront(runner, scene, width: int, height: int, spp: int, seed=0,
               max_steps: int = 32, k_volume: int = 0, n_lanes: int = 65536,
               vol_window: int | None = None, flush_every: int = 4,
               tri_backend: str | None = None, lane=None):
    """`render_lanes_wavefront`'s loop through `runner` (`render.graphs`;
    None: a `GraphRunner` on a CUDA scene, else an `EagerRunner`) ->
    (summed radiance, sub-iterations). With an `EagerRunner` on the card
    it is the loop op by op, which `chip_smoke.py` and a test hold the
    graphs against."""
    with profiling.request("render", width=width, height=height, spp=spp):
        loop = _WavefrontLoop(scene, width, height, spp, seed, max_steps,
                              k_volume, n_lanes, vol_window, flush_every,
                              tri_backend, lane)
        if loop.dev.type != "cuda":
            return loop.run(runner or EagerRunner())
        with torch.cuda.device(loop.dev):
            return loop.run(runner or GraphRunner())


class _WavefrontLoop:
    """`render_lanes_wavefront`'s loop state and the branches of the JAX
    package's while-loop body (pbrlab_tpu/render/integrator.py:1157-1227)
    as phases. The state lives in buffers allocated once: `packed` (the
    [n_lanes, 46] loop carry: the 39 state columns, then pix_acc 3 |
    pend_rgb 3 | pend_pix 1), `fb` [n, 3], `next_pixel` (0-dim) and the
    pixel ids `lane`. A phase reads them and the scene's tables and ends
    by writing its results into them in place, so a CUDA graph of it
    reads and writes the captured addresses on every replay; what the
    host branches on it leaves in `probe` (0-dim int64). With the
    recorder on (`utils.profiling`, read when the loop is made) `lanes`
    (0-dim int64) sums the alive lanes entering each full step and the
    flush puts it in the probe above the loop test's bit; with it off
    neither is captured. `run` issues the phases in the JAX body's order
    through a runner (`render.graphs`)."""

    def __init__(self, scene, width, height, spp, seed, max_steps, k_volume,
                 n_lanes, vol_window, flush_every, tri_backend, lane):
        if "mat_fat" not in scene:
            scene = build_fat_tables(scene)
        self.scene = scene
        self.dev = dev = scene["mat_fat"].device
        self.width, self.height, self.spp, self.seed = width, height, spp, seed
        self.max_steps, self.k_volume = max_steps, k_volume
        self.tri_backend = tri_backend
        i32 = torch.int32
        self.lane = (None if lane is None
                     else lane.to(device=dev, dtype=i32))
        self.n = n = width * height if lane is None else lane.shape[0]
        self.n_lanes = n_lanes = max(1, min(n, n_lanes))
        if vol_window is None:
            vol_window = max(1, n_lanes * 3 // 8)
        self.vol_window = max(1, min(vol_window, n_lanes))
        self.window_ok = k_volume > 0 and self.vol_window < n_lanes
        self.flush_every = max(1, min(flush_every, spp))
        # generous iteration cap (a pixel costs <= spp * max_steps *
        # (1 + k_volume) iterations on one lane; claims overlap lanes)
        self.cap = (spp * max_steps * (1 + k_volume)
                    * ((n + n_lanes - 1) // n_lanes + 2))
        # state.lane = currently claimed local slot; state.sample = sample
        # index within it; sample == spp marks a retired lane.
        state = init_state(scene, width, height, 0, seed,
                           self._pixel(torch.arange(n_lanes, dtype=i32,
                                                    device=dev)))
        zeros3 = torch.zeros((n_lanes, 3), device=dev)
        self.packed = self._pack_ext(
            pack_state(state), zeros3, zeros3,
            torch.full((n_lanes,), -1, dtype=i32, device=dev))
        self.fb = torch.zeros((n, 3), device=dev)
        self.next_pixel = torch.full((), n_lanes, dtype=i32, device=dev)
        self.probe = torch.zeros((), dtype=torch.int64, device=dev)
        self.probe.copy_(self._pending())
        self.count_lanes = profiling.RECORDER.on
        self.lanes = torch.zeros((), dtype=torch.int64, device=dev)

    def run(self, runner):
        """The while loop -> (fb, sub-iterations). Per trip (`cond` at
        :1123, the body at :1157): flush_every sub-iterations, then the
        framebuffer flush. A sub-iteration with the window: (A), then
        (B-win) if the walkers fit the window (`lax.cond` at :1210), else
        (B-full); without the window but with substeps: (A-head), (B-any)
        if a lane walks (`lax.cond` at :1168), (A-tail); without
        substeps: (A). With `count_lanes` the loop test's read brings the
        lanes counted so far above its bit; the last one's are counted
        into the request (`utils.profiling`)."""
        it = alive = 0
        while it < self.cap:
            word = runner.read(self.probe)  # the loop test
            alive = word >> 1
            if not word & 1:
                break
            for _ in range(self.flush_every):
                if self.window_ok:
                    runner.run("A", self.full_step)
                    if runner.read(self.probe) <= self.vol_window:
                        runner.run("B-win", self.window_substeps)
                    else:
                        runner.run("B-full", self.all_substeps)
                elif self.k_volume:
                    runner.run("A-head", self.step_head)
                    if runner.read(self.probe):
                        runner.run("B-any", self.any_substeps)
                    runner.run("A-tail", self.step_tail)
                else:
                    runner.run("A", self.full_step)
            runner.run("F", self.flush)
            it += self.flush_every
        # safety flush for a cap exit: the current pixel's finished
        # samples plus the in-flight sample's contribution
        spp, n = self.spp, self.n
        state = unpack_state(self.packed)
        contrib = torch.where(
            ((state.sample < spp) & ~state.alive)[..., None]
            & torch.isfinite(state.contribution), state.contribution, 0.0)
        self.fb.index_add_(0, torch.clamp(state.lane, max=n - 1).to(
            torch.int64), self.packed[:, _PACK_COLS:_PACK_COLS + 3] + contrib)
        profiling.count("subiters", it)
        profiling.count("lane_slots", self.n_lanes * it)
        if self.count_lanes:
            profiling.count("lanes_alive", alive)
        return self.fb, it

    # --- phases ----------------------------------------------------------

    def full_step(self):
        """(A) refill, one full step, the per-sample step budget (with the
        window the kill waits until after the substeps, so a max-depth
        walker still gets them), the compaction; with the window, the
        count of walkers in the probe."""
        p = self._refill_step()
        if not self.window_ok:
            _kill_spent(p, self.max_steps)
        self.packed.copy_(compact_packed(p, self.scene))
        if self.window_ok:
            # alive volume lanes occupy rows [0, nv) after the sort
            self.probe.copy_(self._walkers())

    def step_head(self):
        """(A-head) refill and one full step, unsorted; the count of
        walkers in the probe."""
        self.packed.copy_(self._refill_step())
        self.probe.copy_(self._walkers())

    def step_tail(self):
        """(A-tail) the per-sample step budget and the compaction."""
        _kill_spent(self.packed, self.max_steps)
        self.packed.copy_(compact_packed(self.packed, self.scene))

    def window_substeps(self):
        """(B-win) the k_volume substeps on the leading vol_window rows,
        then the step budget on every row."""
        self._substeps(self.packed[:self.vol_window], windowed=True)
        _kill_spent(self.packed, self.max_steps)

    def all_substeps(self):
        """(B-full) the k_volume substeps on every row, unwindowed, then
        the step budget."""
        self._substeps(self.packed, windowed=False)
        _kill_spent(self.packed, self.max_steps)

    def any_substeps(self):
        """(B-any) the k_volume substeps on every row, unwindowed."""
        self._substeps(self.packed, windowed=False)

    def flush(self):
        """(F) the amortized framebuffer flush: every pend slot drained
        once a trip (a pixel is in at most one slot; empty slots add 0 to
        pixel 0) and emptied; the loop test in the probe's low bit, the
        lanes counted so far above it (`count_lanes`)."""
        pc = _PACK_COLS
        pend_pix = self.packed[:, pc + 6].to(torch.int64)
        self.fb.index_add_(0, torch.clamp(pend_pix, 0, self.n - 1),
                           torch.where((pend_pix >= 0)[:, None],
                                       self.packed[:, pc + 3:pc + 6], 0.0))
        self.packed[:, pc + 3:pc + 6] = 0.0
        self.packed[:, pc + 6] = -1.0
        if self.count_lanes:
            self.probe.copy_(self._pending() + 2 * self.lanes)
        else:
            self.probe.copy_(self._pending())

    # --- their parts -----------------------------------------------------

    def _pixel(self, p_loc):
        """The pixel id of local slot p_loc."""
        return p_loc if self.lane is None else self.lane[
            torch.clamp(p_loc, max=self.n - 1).to(torch.int64)]

    @staticmethod
    def _pack_ext(rows, pix_acc, pend_rgb, pend_pix):
        return torch.cat([rows, pix_acc, pend_rgb,
                          pend_pix.to(torch.float32)[:, None]], dim=1)

    def _walkers(self):
        """Alive lanes in volume mode."""
        p = self.packed
        return ((p[:, 15] > 0.5) & (p[:, 17] > 0.5)).sum()

    def _pending(self):
        """The loop test: a lane alive or a pixel sample not done."""
        p = self.packed
        return ((p[:, 15] > 0.5) | (p[:, 30] < self.spp)).any()

    def _refill_step(self):
        """Refill, one full wavefront_step and the depth count -> the new
        packed rows (a new tensor); advances next_pixel and adds the
        lanes it steps to `lanes` (`count_lanes`)."""
        pc = _PACK_COLS
        p = self.packed
        state, pix_acc, pend_rgb, pend_pix = self._refill(
            unpack_state(p), p[:, pc:pc + 3], p[:, pc + 3:pc + 6],
            p[:, pc + 6].to(torch.int32))
        stepped = state.alive
        if self.count_lanes:
            self.lanes += stepped.sum()
        rows = wavefront_step(self.scene, pack_state(state),
                              tri_backend=self.tri_backend)
        rows[:, 31] += stepped.to(torch.float32)  # the depth count
        return self._pack_ext(rows, pix_acc, pend_rgb, pend_pix)

    def _refill(self, state, pix_acc, pend_rgb, pend_pix):
        """Flush finished samples into pix_acc; advance the sample or claim
        a new pixel; park completed pixels in the pend slot."""
        spp, n, i32 = self.spp, self.n, torch.int32
        # a dead lane with an unresolved deferred-NEE query keeps its slot
        # for one more step (the trace resolves it, then it flushes here)
        flush = (~state.alive & (state.sample < spp)
                 & (state.nee_maxt < 0.0))
        pix_acc = pix_acc + torch.where(
            flush[..., None] & torch.isfinite(state.contribution),
            state.contribution, 0.0)
        contribution = torch.where(flush[..., None], 0.0, state.contribution)
        sn = state.sample + 1
        adv = flush & (sn < spp)  # next sample of the same pixel
        want = flush & (sn >= spp)  # pixel finished: claim the next one
        pend_rgb = torch.where(want[..., None], pix_acc, pend_rgb)
        pend_pix = torch.where(want, state.lane, pend_pix)
        pix_acc = torch.where(want[..., None], 0.0, pix_acc)
        next_pixel = self.next_pixel
        newp = next_pixel + torch.cumsum(want.to(i32), 0).to(i32) - 1
        got = want & (newp < n)
        p_loc = torch.where(got, newp, state.lane)
        s2 = torch.where(adv, sn, torch.where(
            got, 0, torch.where(want, spp, state.sample))).to(i32)
        need = adv | got
        self.next_pixel.copy_(torch.clamp(next_pixel + want.sum(), max=n))

        pix = self._pixel(p_loc)
        rng0 = prng.seed_state(pix, s2 % spp, self.seed)
        rng0, (u1, u2) = prng.draw_n(rng0, 2)
        org0, dir0 = generate_rays(self.scene, self.width, self.height, u1,
                                   u2, pix)
        nd = need[..., None]
        state = state._replace(
            org=torch.where(nd, org0, state.org),
            direction=torch.where(nd, dir0, state.direction),
            min_t=torch.where(need, 0.0, state.min_t),
            throughput=torch.where(nd, 1.0, state.throughput),
            bsdf_pdf=torch.where(need, 0.0, state.bsdf_pdf),
            rng=torch.where(need, rng0, state.rng),
            alive=state.alive | need,
            first=state.first | need,
            mode=torch.where(need, MODE_SURFACE, state.mode).to(i32),
            vol_first=state.vol_first & ~need,
            lane=p_loc, sample=s2,
            depth=torch.where(need, 0, state.depth).to(i32),
            contribution=contribution)
        return state, pix_acc, pend_rgb, pend_pix

    def _substeps(self, rows, windowed):
        """The k_volume volume-only substeps of the packed `rows`, in
        place."""
        rows[:, :_PACK_COLS].copy_(_volume_substeps(
            wavefront_step, self.scene, rows[:, :_PACK_COLS], self.k_volume,
            windowed=windowed, tri_backend=self.tri_backend))


def _kill_spent(packed, max_steps):
    """The per-sample step budget, in place: lanes at max_steps full
    steps die."""
    packed[:, 15] = torch.where(packed[:, 31] >= max_steps, 0.0,
                                packed[:, 15])


def render(scene, width: int, height: int, spp: int, seed=0,
           max_steps: int = 32, k_volume: int = 0,
           tri_backend: str | None = None, **kwargs):
    """spp-sample mean radiance [H, W, 3] via the persistent-lane
    wavefront; tri_backend forces the triangle backend (None: the
    scene's); kwargs go to `render_lanes_wavefront`."""
    with profiling.request("render", width=width, height=height, spp=spp):
        total = render_lanes_wavefront(scene, width, height, spp, seed,
                                       max_steps, k_volume=k_volume,
                                       tri_backend=tri_backend, **kwargs)
    return _mean(total.reshape(height, width, 3), spp)


def _mean(total, spp: int):
    """total / spp, the IEEE quotient on every device, as numpy's (the
    progressive renderer's average). The divisor is a tensor: on CUDA,
    torch computes a tensor over a Python number as a product with the
    number's reciprocal, an ulp off on some values."""
    return total / torch.tensor(float(spp), device=total.device)


def scene_has_sss(scene) -> bool:
    """Any material with subsurface weight > 0 (numpy or torch scene):
    k_volume substeps can only matter there."""
    sub = scene.get("materials", {}).get("subsurface")
    return sub is not None and bool((sub > 0.0).any())


def auto_k_volume(scene_np, max_steps: int = 32, cap: int = 12,
                  probe: int = 96, device=None) -> int:
    """The CLI's rule for the SSS walk budget: 0 without SSS; else start
    at 3 and double (up to `cap`) until fewer than 8% of the probed walks
    are truncated (`utils.profiling.measure_sss_truncation` on `device`,
    None = CUDA); warn when the cap still truncates. The threshold is
    docs/sss_truncation.md's: below ~10% truncated walks the radiance bias
    measured <= ~0.3% even at 16x the demo medium's density."""
    if not scene_has_sss(scene_np):
        return 0
    from ..utils.profiling import measure_sss_truncation

    thresh = 0.08
    k = 3
    while True:
        frac = measure_sss_truncation(scene_np, max_steps, k_volume=k,
                                      probe=probe, device=device)
        if frac < thresh or k >= cap:
            break
        k = min(cap, k * 2)
    if frac >= thresh:
        from ..utils import log as plog

        plog.event(plog.get_logger("integrator"), "sss walk budget",
                   level="warning", k_volume=k,
                   truncated_pct=round(frac * 100, 2),
                   hint="medium denser than the k_volume cap can cover; "
                        "raise --k-volume or --max-steps")
    return k


def render_sample(scene, width: int, height: int, sample_id, seed=0,
                  max_steps: int = 32, k_volume: int = 0,
                  tri_backend: str | None = None, programs=None):
    """One sample per pixel -> radiance [H, W, 3] (linear); tri_backend
    forces the triangle backend; `programs` keeps the compiled program
    (see `render_lanes`)."""
    contribution = render_lanes(scene, width, height, sample_id, seed,
                                max_steps, k_volume=k_volume,
                                tri_backend=tri_backend, programs=programs)
    return contribution.reshape(height, width, 3)


@torch.no_grad()
def render_scan(scene, width: int, height: int, spp: int, seed=0,
                max_steps: int = 32, k_volume: int = 0,
                tri_backend: str | None = None, programs=None):
    """spp independent `render_sample` passes summed in order 0..spp-1,
    then divided by spp (the reference's pass loop,
    render-layer.h:11-26); `render` is the same image from the
    persistent lanes. tri_backend forces the triangle backend. The
    samples run through one compiled program (kept in `programs` when
    given) and sum into one device buffer, as the JAX package's
    `lax.scan` carries its accumulator. The call is a `render` request
    of `utils.profiling` when no span is open."""
    with profiling.request("render", width=width, height=height, spp=spp):
        if "mat_fat" not in scene:
            scene = build_fat_tables(scene)
        prog = _lanes_program(programs or Programs(), scene, width, height,
                              None, max_steps, 2, k_volume, tri_backend)
        acc = torch.zeros_like(prog.out)
        for sample_id in range(spp):
            prog.forward(scene, sample_id, seed, None)
            acc += prog.out
        return _mean(acc.reshape(height, width, 3), spp)
