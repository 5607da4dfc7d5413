"""The plain reference's paths: pbrlab's path tracer, one path a lane.

A frozen copy of pbrlab_tpu_torch's `render/integrator.py`
(`wavefront_step`, `init_state`, `_finish`), `render/camera.py` and
`scene/lights.py` as they stood when the benchmark was written, cut to
triangle scenes without textures or hair, with the reference's own
tables (`pbref.scene`) and ray queries (`pbref.trace`). A path is a
pure function of (pixel, sample, seed): `max_steps` full steps (a
surface bounce or one random-walk SSS step, next-event estimation
deferred to the next trace), after each `k_volume` volume-only substeps,
then one any-hit query for the last shadow ray. `radiance` returns
each path's sum; it runs under autograd, which reaches the material
columns and the face emission as the program's gradient does (the trace
results, frame, hit point, emitter pdf and the walk's pdf denominators
detached where the program detaches them).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from . import shading as sh

SURFACE, VOLUME = 0, 1
FRONT, BACK, AMBIGUOUS = 0, 1, 2


class Path(NamedTuple):
    org: torch.Tensor
    direction: torch.Tensor
    min_t: torch.Tensor
    throughput: torch.Tensor
    contribution: torch.Tensor
    bsdf_pdf: torch.Tensor
    rng: torch.Tensor
    alive: torch.Tensor
    first: torch.Tensor
    mode: torch.Tensor
    vol_first: torch.Tensor
    sss_sigma_t: torch.Tensor
    sss_sigma_s: torch.Tensor
    sss_tp: torch.Tensor
    sss_instance: torch.Tensor
    nee_dir: torch.Tensor
    nee_contrib: torch.Tensor
    nee_maxt: torch.Tensor


def camera_rays(tab, width, height, u1, u2, pixel):
    """pbrlab's auto-framing pinhole camera (render.cc:132-167)."""
    lo, hi = tab["aabb_min"], tab["aabb_max"]
    ext = hi - lo
    wide = ext[0] > ext[1]
    horizontal = torch.where(wide, ext[0], ext[1] * width / height)
    vertical = torch.where(wide, ext[0] * height / width, ext[1])
    x_center = (hi[0] + lo[0]) * 0.5
    y_center = (hi[1] + lo[1]) * 0.5
    z_center = hi[2] + horizontal * 0.5 * math.sqrt(3.0)
    org = torch.stack([x_center, y_center, z_center])
    x_corner = x_center - horizontal * 0.5
    y_corner = y_center + vertical * 0.5
    dx, dy = horizontal / width, vertical / height
    px = (pixel % width).to(u1.dtype)
    py = (pixel // width).to(u1.dtype)
    target = torch.stack([x_corner + dx * (px + u1), y_corner - dy * (py + u2),
                          hi[2].expand(pixel.shape[0])], dim=-1)
    ray_org = org[None, :].expand(pixel.shape[0], 3)
    return ray_org, sh.vnormalize(target - ray_org)


def start(tab, width, height, pixel, sample, seed, dtype):
    """Fresh camera paths for pixel ids, sample ids and seeds [n]."""
    n = pixel.shape[0]
    dev = pixel.device
    rng = sh.seed_state(pixel, sample, seed)
    rng, (u1, u2) = sh.draw_n(rng, 2, dtype)
    org, direction = camera_rays(tab, width, height, u1, u2, pixel)
    z3 = torch.zeros((n, 3), device=dev, dtype=dtype)
    one3 = torch.ones((n, 3), device=dev, dtype=dtype)
    z = torch.zeros((n,), device=dev, dtype=dtype)
    b = torch.ones((n,), dtype=torch.bool, device=dev)
    return Path(org=org, direction=direction, min_t=z, throughput=one3,
                contribution=z3, bsdf_pdf=z, rng=rng, alive=b, first=b,
                mode=torch.zeros((n,), dtype=torch.int32, device=dev),
                vol_first=~b, sss_sigma_t=one3, sss_sigma_s=one3,
                sss_tp=one3,
                sss_instance=torch.full((n,), -1, dtype=torch.int32,
                                        device=dev),
                nee_dir=z3, nee_contrib=z3, nee_maxt=z - 1.0)


def _gather(table, idx):
    i = torch.clamp(idx.to(torch.int64), 0, table.shape[0] - 1)
    return torch.index_select(table, 0, i)


def _nee(tab, pos, geom_normal, omega_out_local, ex, ey, ez, bsdf, u0, u1,
         u2, shade_mask):
    """Deferred next-event estimation (shader-utils.h:166-212)."""
    row = _gather(tab["light"], sh.sample_cdf(tab["light_cdf"], u0))
    u, v = sh.triangle_uniform_sample(u1, u2)
    lpos = (row[:, 0:3] + u[..., None] * row[:, 3:6]
            + v[..., None] * row[:, 6:9])
    lnormal, emission, lpdf = row[:, 9:12], row[:, 12:15], row[:, 15]
    to_light = lpos - pos
    dist = torch.sqrt(torch.clamp(sh.vdot(to_light, to_light), min=1e-12))
    wl = to_light / dist[..., None]
    wl_dot_nl = -sh.vdot(wl, lnormal)
    wl_dot_np = sh.vdot(wl, geom_normal)
    denom = wl_dot_nl * wl_dot_np
    pdf_sigma = torch.clamp(torch.abs(
        lpdf * dist * dist
        / torch.where(torch.abs(denom) > 1e-12, denom, 1e-12)), max=1e30)
    hemisphere_ok = (wl_dot_nl > 0.0) & (wl_dot_np > 0.0)
    candidate = shade_mask & hemisphere_ok & (pdf_sigma > 0.0)
    shadow_max = torch.clamp(dist - sh.EPS, min=sh.EPS)
    omega_l = sh.to_local(wl, ex, ey, ez)
    f, pdf_b = sh.eval_bsdf(omega_l, omega_out_local, bsdf)
    w = sh.power_heuristic_weight(pdf_sigma, pdf_b)
    contrib = f * emission * (w / torch.clamp(pdf_sigma, min=1e-12))[..., None]
    contrib = torch.where(
        candidate[..., None] & torch.isfinite(contrib).all(-1, keepdim=True),
        contrib, 0.0)
    return contrib, wl, torch.where(candidate, shadow_max, -1.0)


def step(tab, tracer, st: Path, freeze_surface=False, resolve_pending=False):
    """One trace for every path: a surface bounce, or with freeze_surface
    one random-walk step of the paths in volume mode only (the first
    such substep resolves their pending shadow query)."""
    n = st.org.shape[0]
    dt = st.org.dtype
    surface_mode = st.mode == SURFACE
    volume_mode = st.mode == VOLUME
    rng, (ud1, ud2, uc, ut) = sh.draw_n(st.rng, 4, dt)
    need_new_dir = volume_mode & ~st.vol_first
    direction = torch.where(need_new_dir[..., None],
                            sh.uniform_sample_sphere(ud1, ud2), st.direction)
    min_t = torch.where(need_new_dir, 0.0, st.min_t)
    t_scatter, channel_pdf = sh.sample_scatter_distance(
        st.sss_tp, st.sss_sigma_s, st.sss_sigma_t, uc, ut)
    t_scatter = t_scatter.detach()
    max_t = torch.where(volume_mode, t_scatter,
                        -1.0 if freeze_surface else sh.INF)
    max_t = torch.where(st.alive, max_t, -1.0)

    nee_active = st.nee_maxt >= 0.0
    contribution = st.contribution
    resolved_now = torch.zeros((n,), dtype=torch.bool, device=st.org.device)
    rays = [x.detach() for x in (st.org, direction, min_t, max_t)]
    if not freeze_surface or resolve_pending:
        resolve_mask = (volume_mode & st.alive & nee_active
                        if freeze_surface else nee_active)
        occ = tracer.query(rays[0], st.nee_dir.detach(),
                           torch.full((n,), sh.EPS, device=st.org.device,
                                      dtype=dt),
                           torch.where(resolve_mask, st.nee_maxt,
                                       -1.0).detach(), any_hit=True)
        contribution = contribution + torch.where(
            (resolve_mask & ~occ)[..., None], st.nee_contrib, 0.0)
        resolved_now = resolve_mask
    t_hit, hu, hv, prim = tracer.query(*rays)
    hit_ok = prim >= 0
    t_eff = torch.where(volume_mode & ~hit_ok, t_scatter, t_hit)
    t_shade = torch.where(hit_ok | volume_mode, t_eff, 1.0)
    pos = st.org + t_shade[..., None] * direction
    frow = _gather(tab["face"], torch.clamp(prim, min=0))
    ng = frow[:, 0:3]
    corner_ns = frow[:, 3:12].reshape(-1, 3, 3)
    w0 = (1.0 - hu - hv)[..., None]
    ns_lerp = sh.vnormalize(corner_ns[:, 0] * w0
                            + corner_ns[:, 1] * hu[..., None]
                            + corner_ns[:, 2] * hv[..., None])
    ns = torch.where(frow[:, 18:19] > 0.0, ns_lerp, ng)
    hit_instance = frow[:, 25].to(torch.int32)
    mat_id = frow[:, 20].to(torch.int32)
    ng, ns, pos = ng.detach(), ns.detach(), pos.detach()
    dg = sh.vdot(direction, ng)
    ds = sh.vdot(direction, ns)
    face_dir = torch.where((dg < 0.0) & (ds < 0.0), FRONT,
                           torch.where((dg > 0.0) & (ds > 0.0), BACK,
                                       AMBIGUOUS))
    alive = st.alive
    throughput = st.throughput

    # surface paths: emission with MIS, russian roulette
    s_alive = alive & surface_mode
    if freeze_surface:
        s_alive = torch.zeros_like(s_alive)
    pdf_area = frow[:, 21].detach()
    nsd = sh.vdot(ns, direction)
    a2sa = torch.abs(t_shade * t_shade
                     / torch.where(torch.abs(nsd) > 1e-12, nsd, 1e-12))
    mis_w = torch.where(st.first, 1.0,
                        sh.power_heuristic_weight(st.bsdf_pdf,
                                                  pdf_area * a2sa))
    add_em = s_alive & hit_ok & (face_dir == FRONT) & (pdf_area > 0.0)
    contribution = contribution + torch.where(
        add_em[..., None], mis_w[..., None] * frow[:, 22:25] * throughput, 0.0)
    rng, urr = sh.draw(rng, dt)
    rr_p = sh.spectrum_norm(throughput)
    rr_die = rr_p < urr
    throughput = torch.where(
        (s_alive & ~rr_die)[..., None],
        throughput / torch.clamp(rr_p, min=1e-12)[..., None], throughput)
    s_alive = s_alive & hit_ok & ~rr_die

    # volume paths: one walk step
    v_alive = alive & volume_mode
    rng, uvrr = sh.draw(rng, dt)
    trans = torch.exp(-st.sss_sigma_t * t_eff[..., None])
    pdf_hit = sh.vdot(channel_pdf, trans).detach()
    pdf_scatter = sh.vdot(channel_pdf, st.sss_sigma_t * trans).detach()
    sss_tp_hit = st.sss_tp * trans / torch.clamp(pdf_hit, min=1e-12)[..., None]
    sss_tp_scat = (st.sss_tp * (st.sss_sigma_s * trans)
                   / torch.clamp(pdf_scatter, min=1e-12)[..., None])
    sss_tp = torch.where(hit_ok[..., None], sss_tp_hit, sss_tp_scat)
    exit_ok = (v_alive & hit_ok & (hit_instance == st.sss_instance)
               & (face_dir == BACK))
    v_dead_exit = v_alive & hit_ok & ~exit_ok
    v_scatter = v_alive & ~hit_ok
    pv = sh.saturate(sh.spectrum_norm(sss_tp)).detach()
    v_rr_die = v_scatter & (uvrr >= pv)
    sss_tp = torch.where(v_scatter[..., None],
                         sss_tp / torch.clamp(pv, min=1e-12)[..., None],
                         sss_tp)

    # shade: surface hit or SSS exit
    is_exit = exit_ok
    s_shade = s_alive & (face_dir != AMBIGUOUS)
    s_dead_amb = s_alive & (face_dir == AMBIGUOUS)
    shade_mask = s_shade | is_exit
    mat = {k: _gather(col, mat_id) for k, col in tab["mat"].items()}
    ez = torch.where(is_exit[..., None] | (face_dir == FRONT)[..., None],
                     ns, -ns)
    geom_normal = ez
    ex, ey = sh.branchless_onb(ez)
    omega_out_g = torch.where(is_exit[..., None], direction, -direction)
    omega_out = sh.to_local(omega_out_g, ex, ey, ez)
    bsdf = sh.param_to_bsdf(mat, mat["base_color"], mat["subsurface_color"])
    exit_bsdf = sh.diffuse_only_bsdf(sss_tp)
    bsdf = sh.PrincipledBsdf(*[
        torch.where(is_exit.reshape(is_exit.shape + (1,) * (a.ndim - 1)), b, a)
        for a, b in zip(bsdf, exit_bsdf)])

    rng, un = sh.draw_n(rng, 3, dt)
    keep_maxt = torch.where(resolved_now, -1.0, st.nee_maxt)
    nee_c, wl_nee, smax_nee = _nee(tab, pos, geom_normal, omega_out, ex, ey,
                                   ez, bsdf, un[0], un[1], un[2], shade_mask)
    sm = shade_mask[..., None]
    new_nee_dir = torch.where(sm, wl_nee, st.nee_dir)
    new_nee_contrib = torch.where(sm, throughput * nee_c, st.nee_contrib)
    new_nee_maxt = torch.where(shade_mask, smax_nee, keep_maxt)

    rng, ub = sh.draw_n(rng, 4, dt)
    omega_in, f, pdf_b, pick_sss_raw = sh.sample_surface(
        omega_out, bsdf, ub[0], ub[1], ub[2])
    pick_sss = pick_sss_raw & s_shade & (face_dir == FRONT)
    sss_die = pick_sss_raw & s_shade & (face_dir != FRONT)
    factor = f * (torch.abs(omega_in[..., 2])
                  / torch.clamp(pdf_b, min=1e-12))[..., None]
    bad = ((pdf_b <= 0.0) | ~torch.isfinite(factor).all(-1)
           | ~torch.isfinite(pdf_b))
    cont_surface = shade_mask & ~pick_sss & ~bad
    new_dir_g = sh.to_global(omega_in, ex, ey, ez)
    entry_g = sh.to_global(-sh.cosine_sample_hemisphere(ub[1], ub[2]),
                           ex, ey, ez)
    entry_ok = pick_sss & (sh.vdot(-ng, entry_g) > 0.0)
    sigma_t, sigma_s, sss_tp0 = sh.scattering_coefficients(
        bsdf.subsurface_weight, bsdf.subsurface_albedo, bsdf.subsurface_radius)

    new_alive = torch.where(surface_mode, cont_surface | entry_ok,
                            torch.where(v_scatter, v_alive & ~v_rr_die,
                                        cont_surface))
    new_alive = new_alive & alive & ~s_dead_amb & ~v_dead_exit & ~sss_die
    new_mode = torch.where(entry_ok | (v_scatter & ~v_rr_die), VOLUME,
                           SURFACE).to(torch.int32)
    new_throughput = torch.where(cont_surface[..., None],
                                 throughput * factor, throughput)
    new_org = torch.where(
        (shade_mask | entry_ok)[..., None], pos,
        torch.where(v_scatter[..., None],
                    st.org + t_eff[..., None] * direction, st.org))
    new_direction = torch.where(cont_surface[..., None], new_dir_g,
                                torch.where(entry_ok[..., None], entry_g,
                                            direction))
    new_min_t = torch.where(cont_surface | entry_ok, 1e-3,
                            torch.where(v_scatter, 0.0, min_t))
    new_alive = new_alive & (torch.abs(new_throughput).sum(-1) > sh.F32_EPS)
    e3 = entry_ok[..., None]
    new = Path(
        org=new_org, direction=new_direction, min_t=new_min_t,
        throughput=new_throughput, contribution=contribution,
        bsdf_pdf=torch.where(cont_surface, pdf_b, st.bsdf_pdf),
        rng=rng, alive=new_alive, first=st.first & ~shade_mask,
        mode=new_mode, vol_first=entry_ok | (st.vol_first & ~volume_mode),
        sss_sigma_t=torch.where(e3, sigma_t, st.sss_sigma_t),
        sss_sigma_s=torch.where(e3, sigma_s, st.sss_sigma_s),
        sss_tp=torch.where(e3, sss_tp0,
                           torch.where(volume_mode[..., None], sss_tp,
                                       st.sss_tp)),
        sss_instance=torch.where(entry_ok, hit_instance, st.sss_instance),
        nee_dir=new_nee_dir, nee_contrib=new_nee_contrib,
        nee_maxt=new_nee_maxt)
    if freeze_surface:
        new = Path(*[
            torch.where(surface_mode.reshape(
                surface_mode.shape + (1,) * (b.ndim - 1)), a, b)
            for a, b in zip(st, new)])
    return new


def radiance(tab, tracer, width, height, pixel, sample, seed, max_steps,
             k_volume, dtype=torch.float32):
    """Each path's radiance [n, 3] (float32) for pixel, sample and seed
    ids [n] (int64)."""
    st = start(tab, width, height, pixel, sample, seed, dtype)
    n = pixel.shape[0]
    for _ in range(max_steps):
        st = step(tab, tracer, st)
        if k_volume and bool((st.alive & (st.mode == VOLUME)).any()):
            for i in range(k_volume):
                st = step(tab, tracer, st, freeze_surface=True,
                          resolve_pending=(i == 0))
    active = st.nee_maxt >= 0.0
    occ = tracer.query(st.org.detach(), st.nee_dir.detach(),
                       torch.full((n,), sh.EPS, device=pixel.device,
                                  dtype=dtype),
                       torch.where(active, st.nee_maxt, -1.0).detach(),
                       any_hit=True)
    c = st.contribution + torch.where((active & ~occ)[..., None],
                                      st.nee_contrib, 0.0)
    return torch.where(torch.isfinite(c), c, 0.0).float()
