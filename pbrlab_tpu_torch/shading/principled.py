"""Cycles-compatible Principled BSDF over lanes (port of
pbrlab_tpu.shading.principled; reference shader/cycles-principled-shader.cc).

ParamToBsdf closure setup (:244-412), luminance-normalized one-sample
closure selection (:63-112), EvalBsdf (:114-155) and SampleBsdf (:169-242),
with the reference's enable_* flags as per-lane masks. Directions are in
the shading-local frame. The SSS closure is only flagged here (`pick_sss`);
the integrator's volume mode runs the walk.
"""
from __future__ import annotations

from typing import Dict, NamedTuple

import torch

from ..core.math import (EPS, INV_PI, fresnel_dielectric_cos, lerp, rgb_to_y,
                         safe_sqrt, saturate, vnormalize)
from ..core.sampling import cosine_sample_hemisphere
from . import ggx
from .sss import bssrdf_setup


class PrincipledBsdf(NamedTuple):
    """Per-lane closure parameters (CyclesPrincipledBsdf struct, :20-45)."""

    enable_diffuse: torch.Tensor  # [N] bool
    diffuse_weight: torch.Tensor  # [N,3]
    enable_subsurface: torch.Tensor
    subsurface_weight: torch.Tensor
    subsurface_albedo: torch.Tensor
    subsurface_radius: torch.Tensor
    enable_specular: torch.Tensor
    specular_weight: torch.Tensor  # [N,3]
    alpha_x: torch.Tensor
    alpha_y: torch.Tensor
    ior: torch.Tensor
    specular_color: torch.Tensor
    enable_clearcoat: torch.Tensor
    clearcoat_weight: torch.Tensor
    clearcoat_alpha: torch.Tensor
    clearcoat_ior: torch.Tensor
    clearcoat_color: torch.Tensor


def diffuse_only_bsdf(weight):
    """A pure-diffuse PrincipledBsdf (used at SSS exit re-shading)."""
    n = weight.shape[0]
    t = torch.ones((n,), dtype=torch.bool, device=weight.device)
    f = weight.new_zeros((n,))
    f3 = weight.new_zeros((n, 3))
    return PrincipledBsdf(
        enable_diffuse=t, diffuse_weight=weight,
        enable_subsurface=~t, subsurface_weight=f3, subsurface_albedo=f3,
        subsurface_radius=f3,
        enable_specular=~t, specular_weight=f3, alpha_x=f, alpha_y=f,
        ior=torch.full_like(f, 1.5), specular_color=f3,
        enable_clearcoat=~t, clearcoat_weight=f3, clearcoat_alpha=f,
        clearcoat_ior=torch.full_like(f, 1.5), clearcoat_color=f3)


def param_to_bsdf(mat: Dict[str, torch.Tensor], base_color, subsurface_color):
    """ParamToBsdf (:244-412). `mat` holds per-lane material columns;
    base_color/subsurface_color are pre-fetched."""
    subsurface = mat["subsurface"]
    metallic = mat["metallic"]
    specular = mat["specular"]
    roughness = mat["roughness"]
    clearcoat = mat["clearcoat"]
    transmission = mat["transmission"]
    cutoff = EPS

    diffuse_w = (1.0 - saturate(metallic)) * (1.0 - saturate(transmission))
    final_transmission = saturate(transmission) * (1.0 - saturate(metallic))
    specular_w = 1.0 - final_transmission

    # diffuse / subsurface (:333-365)
    mixed_ss_base = (subsurface_color * subsurface[..., None]
                     + base_color * (1.0 - subsurface[..., None]))
    mixed_ok = mixed_ss_base.mean(-1) > cutoff
    pick_diffuse = mixed_ok & (subsurface < cutoff) & (diffuse_w > cutoff)
    pick_sss = mixed_ok & (subsurface > cutoff)
    ps3 = pick_sss[..., None]

    diffuse_weight = torch.where(pick_diffuse[..., None],
                                 base_color * diffuse_w[..., None], 0.0)
    w2, albedo2, radius2, add_diffuse = bssrdf_setup(
        mixed_ss_base * diffuse_w[..., None], mixed_ss_base,
        mat["subsurface_radius"] * subsurface[..., None])
    add_diffuse = torch.where(ps3, add_diffuse, 0.0)
    has_add = torch.abs(add_diffuse).sum(-1) > 0.0

    # specular (:372-394)
    enable_specular = (specular_w > cutoff) & (
        (specular > cutoff) | (metallic > cutoff))
    aspect = safe_sqrt(1.0 - mat["anisotropic"] * 0.9)
    r2 = roughness * roughness
    y_base = rgb_to_y(base_color)
    rho_tint = torch.where(y_base[..., None] > 0.0,
                           base_color / torch.clamp(y_base[..., None], min=1e-12),
                           0.0)
    rho_specular = lerp(torch.ones_like(rho_tint), rho_tint,
                        mat["specular_tint"][..., None])
    specular_weight = torch.where(enable_specular[..., None],
                                  specular_w[..., None].expand_as(base_color),
                                  0.0)

    # clearcoat (:396-409)
    enable_clearcoat = clearcoat > cutoff
    clearcoat_weight = torch.where(enable_clearcoat[..., None],
                                   0.25 * clearcoat[..., None]
                                   * torch.ones_like(base_color), 0.0)
    clearcoat_alpha = mat["clearcoat_roughness"] * mat["clearcoat_roughness"]

    return PrincipledBsdf(
        enable_diffuse=pick_diffuse | (pick_sss & has_add),
        diffuse_weight=diffuse_weight + add_diffuse,
        enable_subsurface=pick_sss,
        subsurface_weight=torch.where(ps3, w2, 0.0),
        subsurface_albedo=torch.where(ps3, albedo2, 0.0),
        subsurface_radius=torch.where(ps3, radius2, 0.0),
        enable_specular=enable_specular,
        specular_weight=specular_weight,
        alpha_x=r2 / torch.clamp(aspect, min=1e-12),
        alpha_y=r2 * aspect,
        ior=(2.0 / (1.0 - safe_sqrt(0.08 * specular))) - 1.0,
        specular_color=lerp(0.08 * specular[..., None] * rho_specular,
                            base_color, metallic[..., None]),
        enable_clearcoat=enable_clearcoat,
        clearcoat_weight=clearcoat_weight,
        clearcoat_alpha=clearcoat_alpha,
        clearcoat_ior=torch.full_like(clearcoat_alpha, 1.5),
        clearcoat_color=torch.full_like(clearcoat_weight, 0.04))


def _specular_color(omega_in, omega_out, color, ior):
    """Fresnel-blended specular tint (:54-61)."""
    h = vnormalize(omega_in + omega_out)
    f0 = fresnel_dielectric_cos(torch.ones_like(ior), ior)
    fh = (fresnel_dielectric_cos((h * omega_out).sum(-1), ior) - f0) \
        / torch.clamp(1.0 - f0, min=1e-12)
    return color * (1.0 - fh[..., None]) + fh[..., None]


def closure_sample_weights(omega_out, bsdf: PrincipledBsdf):
    """FetchClosureSampleWeight (:63-112): luminance-normalized one-sample
    weights. Returns (w_diffuse, w_sss, w_specular, w_clearcoat)."""
    mirror = torch.stack([-omega_out[..., 0], -omega_out[..., 1],
                          omega_out[..., 2]], dim=-1)
    wd = torch.where(bsdf.enable_diffuse, rgb_to_y(bsdf.diffuse_weight), 0.0)
    ws = torch.where(bsdf.enable_subsurface,
                     rgb_to_y(bsdf.subsurface_weight), 0.0)
    wsp = torch.where(
        bsdf.enable_specular,
        rgb_to_y(bsdf.specular_weight * _specular_color(
            mirror, omega_out, bsdf.specular_color, bsdf.ior)), 0.0)
    wcc = torch.where(
        bsdf.enable_clearcoat,
        rgb_to_y(bsdf.clearcoat_weight * _specular_color(
            mirror, omega_out, bsdf.clearcoat_color, bsdf.clearcoat_ior)),
        0.0)
    total = wd + ws + wsp + wcc
    inv = torch.where(total > 0.0,
                      1.0 / torch.where(total > 0.0, total, 1.0), 0.0)
    return wd * inv, ws * inv, wsp * inv, wcc * inv


def eval_bsdf(omega_in, omega_out, bsdf: PrincipledBsdf):
    """EvalBsdf (:114-155): sum of closure f, selection-weighted pdf sum."""
    wd, _ws, wsp, wcc = closure_sample_weights(omega_out, bsdf)
    f = torch.zeros_like(bsdf.diffuse_weight)
    pdf = torch.zeros_like(wd)

    # diffuse: f = 1/pi, pdf = cos/pi (closure/lambert.h:11-20)
    f = f + torch.where(bsdf.enable_diffuse[..., None],
                        bsdf.diffuse_weight * INV_PI, 0.0)
    pdf = pdf + torch.where(bsdf.enable_diffuse,
                            wd * (omega_in[..., 2] * INV_PI), 0.0)

    sf, sp = ggx.eval_pdf(omega_in, omega_out, bsdf.alpha_x, bsdf.alpha_y, 2)
    spec_col = _specular_color(omega_in, omega_out, bsdf.specular_color,
                               bsdf.ior)
    f = f + torch.where(bsdf.enable_specular[..., None],
                        bsdf.specular_weight * spec_col * sf[..., None], 0.0)
    pdf = pdf + torch.where(bsdf.enable_specular, wsp * sp, 0.0)

    cf, cp = ggx.eval_pdf(omega_in, omega_out, bsdf.clearcoat_alpha,
                          bsdf.clearcoat_alpha, 1)
    cc_col = _specular_color(omega_in, omega_out, bsdf.clearcoat_color,
                             bsdf.clearcoat_ior)
    f = f + torch.where(bsdf.enable_clearcoat[..., None],
                        bsdf.clearcoat_weight * cc_col * cf[..., None], 0.0)
    pdf = pdf + torch.where(bsdf.enable_clearcoat, wcc * cp, 0.0)
    return f, pdf


def sample_surface(omega_out, bsdf: PrincipledBsdf, u_select, u1, u2):
    """SampleBsdf surface branches (:176-242): pick a closure by the
    sample-weight CDF and sample a direction; SSS lanes are only flagged.
    Returns (omega_in, f, pdf, pick_sss)."""
    wd, ws, wsp, _wcc = closure_sample_weights(omega_out, bsdf)
    pick_diffuse = u_select < wd
    pick_sss = (~pick_diffuse) & (u_select < wd + ws)
    pick_spec = (~pick_diffuse) & (~pick_sss) & (u_select < wd + ws + wsp)
    # else clearcoat

    wi_d = cosine_sample_hemisphere(u1, u2)
    wi_s, _, _ = ggx.sample(omega_out, bsdf.alpha_x, bsdf.alpha_y, u1, u2, 2)
    wi_c, _, _ = ggx.sample(omega_out, bsdf.clearcoat_alpha,
                            bsdf.clearcoat_alpha, u1, u2, 1)
    omega_in = torch.where(pick_diffuse[..., None], wi_d,
                           torch.where(pick_spec[..., None], wi_s, wi_c))
    f, pdf = eval_bsdf(omega_in, omega_out, bsdf)
    return omega_in, f, pdf, pick_sss
