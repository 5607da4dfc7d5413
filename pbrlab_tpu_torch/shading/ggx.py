"""Microfacet GGX closure with VNDF sampling, over lanes (port of
pbrlab_tpu.shading.ggx; reference closure/microfacet-ggx.h).

D_GTR1 (clearcoat, distrib=1 with alpha2 fixed to 0.0625 in G) and D_GTR2,
Smith G1, Heitz-d'Eon stretched-slope visible-normal sampling, reflection
only. Directions are in the shading-local frame (n = +z).
"""
from __future__ import annotations

import torch

from ..core.math import F32_EPS, PI, grad_safe_sqrt, safe_sqrt, vnormalize


def d_gtr1(h, alpha):
    """GTR1 distribution (microfacet-ggx.h:48-53)."""
    alpha2 = alpha * alpha
    t = 1.0 + (alpha2 - 1.0) * h[..., 2] * h[..., 2]
    val = (alpha2 - 1.0) / (PI * torch.log(torch.clamp(alpha2, min=1e-12)) * t)
    return torch.where(alpha >= 1.0, 1.0 / PI, val)


def d_gtr2(h, alpha2):
    c2 = h[..., 2] * h[..., 2]
    c4 = c2 * c2
    tan2 = (1.0 - c2) / torch.clamp(c2, min=1e-12)
    return alpha2 / torch.clamp(PI * c4 * (alpha2 + tan2) * (alpha2 + tan2),
                                min=1e-12)


def _sample_slopes(cos_theta_i, sin_theta_i, randu, randv):
    """GGX visible-slope sampling (microfacet-ggx.h:65-118)."""
    tan_theta_i = sin_theta_i / torch.clamp(cos_theta_i, min=1e-12)
    g1_inv = 0.5 * (1.0 + safe_sqrt(1.0 + tan_theta_i * tan_theta_i))
    g1i = 1.0 / g1_inv

    a = 2.0 * randu * g1_inv - 1.0
    aa = a * a
    tmp = 1.0 / torch.where(torch.abs(aa - 1.0) < 1e-12, 1e-12, aa - 1.0)
    b = tan_theta_i
    bb = b * b
    d = grad_safe_sqrt(bb * (tmp * tmp) - (aa - bb) * tmp, 1e-24)
    slope_x_1 = b * tmp - d
    slope_x_2 = b * tmp + d
    slope_x = torch.where((a < 0.0) | (slope_x_2 * tan_theta_i > 1.0),
                          slope_x_1, slope_x_2)

    s = torch.where(randv > 0.5, 1.0, -1.0)
    rv = torch.where(randv > 0.5, 2.0 * (randv - 0.5), 2.0 * (0.5 - randv))
    z = (rv * (rv * (rv * 0.27385 - 0.73369) + 0.46341)) / (
        rv * (rv * (rv * 0.093073 + 0.309420) - 1.0) + 0.597999)
    slope_y = s * z * safe_sqrt(1.0 + slope_x * slope_x)

    # special case: normal incidence (cos >= 0.99999)
    r = torch.sqrt(randu / torch.clamp(1.0 - randu, min=1e-12))
    phi = 2.0 * PI * randv
    near_normal = cos_theta_i >= 0.99999
    slope_x = torch.where(near_normal, r * torch.cos(phi), slope_x)
    slope_y = torch.where(near_normal, r * torch.sin(phi), slope_y)
    g1i = torch.where(near_normal, 1.0, g1i)
    return slope_x, slope_y, g1i


def sample_stretched(omega_i, alpha_x, alpha_y, randu, randv):
    """Sample the half-vector m (microfacet-ggx.h:121-162)."""
    wi = vnormalize(torch.stack(
        [alpha_x * omega_i[..., 0], alpha_y * omega_i[..., 1],
         omega_i[..., 2]], dim=-1))
    not_normal = wi[..., 2] < 0.99999
    costheta = torch.where(not_normal, wi[..., 2], 1.0)
    sintheta = torch.where(not_normal,
                           grad_safe_sqrt(1.0 - wi[..., 2] * wi[..., 2]), 0.0)
    invlen = 1.0 / torch.clamp(sintheta, min=1e-12)
    cosphi = torch.where(not_normal, wi[..., 0] * invlen, 1.0)
    sinphi = torch.where(not_normal, wi[..., 1] * invlen, 0.0)

    slope_x, slope_y, _g1i = _sample_slopes(costheta, sintheta, randu, randv)

    tmp = cosphi * slope_x - sinphi * slope_y
    slope_y = sinphi * slope_x + cosphi * slope_y
    slope_x = alpha_x * tmp
    slope_y = alpha_y * slope_y
    return vnormalize(torch.stack(
        [-slope_x, -slope_y, torch.ones_like(slope_x)], dim=-1))


def eval_pdf(omega_in, omega_out, alpha_x, alpha_y, distrib):
    """BSDF value + pdf for reflection (microfacet-ggx.h:164-245).
    distrib: 1 = GTR1 clearcoat, 2 = GTR2. Returns (f, pdf), both [...]."""
    cos_no = omega_out[..., 2]
    cos_ni = omega_in[..., 2]
    reflect = (cos_no > 0.0) & (cos_ni > 0.0)

    m = vnormalize(omega_in + omega_out)
    alpha2 = alpha_x * alpha_y
    iso = torch.abs(alpha_x - alpha_y) < F32_EPS

    if distrib == 1:
        d_iso = d_gtr1(m, alpha_x)
        alpha2_g = torch.full_like(alpha2, 0.0625)
    else:
        d_iso = d_gtr2(m, alpha2)
        alpha2_g = alpha2
    cos_no2 = cos_no * cos_no
    cos_ni2 = cos_ni * cos_ni
    g1o_iso = 2.0 / (1.0 + safe_sqrt(
        1.0 + alpha2_g * (1.0 - cos_no2) / torch.clamp(cos_no2, min=1e-12)))
    g1i_iso = 2.0 / (1.0 + safe_sqrt(
        1.0 + alpha2_g * (1.0 - cos_ni2) / torch.clamp(cos_ni2, min=1e-12)))

    # the anisotropic branch, which isotropic lanes do not take, sees a
    # unit alpha and the normal half vector there: its value (inf * 0
    # for a grazing m at alpha 0) is masked in the forward, but NaN
    # partials would turn the masked zero cotangent into NaN
    ax = torch.where(iso, 1.0, alpha_x)
    ay = torch.where(iso, 1.0, alpha_y)
    ma = torch.where(iso[..., None], m.new_tensor([0.0, 0.0, 1.0]), m)
    mz = torch.where(torch.abs(ma[..., 2]) < 1e-12, 1e-12, ma[..., 2])
    slope_x = -ma[..., 0] / (mz * torch.clamp(ax, min=1e-12))
    slope_y = -ma[..., 1] / (mz * torch.clamp(ay, min=1e-12))
    slope_len = 1.0 + slope_x * slope_x + slope_y * slope_y
    cos_m2 = ma[..., 2] * ma[..., 2]
    cos_m4 = cos_m2 * cos_m2
    d_aniso = 1.0 / torch.clamp(
        (slope_len * slope_len) * PI * (ax * ay) * cos_m4, min=1e-12)

    def aniso_g1(omega, cos_n):
        tan2 = (1.0 - cos_n * cos_n) / torch.clamp(cos_n * cos_n, min=1e-12)
        cph, sph = omega[..., 0], omega[..., 1]
        denom = torch.clamp(cph * cph + sph * sph, min=1e-12)
        a2 = ((cph * cph) * (ax * ax) + (sph * sph) * (ay * ay)) / denom
        return 2.0 / (1.0 + safe_sqrt(1.0 + a2 * tan2))

    d = torch.where(iso, d_iso, d_aniso)
    g1o = torch.where(iso, g1o_iso, aniso_g1(omega_out, cos_no))
    g1i = torch.where(iso, g1i_iso, aniso_g1(omega_in, cos_ni))

    common = d * 0.25 / torch.clamp(cos_no * cos_ni, min=1e-12)
    f = g1o * g1i * common
    if distrib == 1:
        f = 0.25 * f
    pdf = g1o * common
    return torch.where(reflect, f, 0.0), torch.where(reflect, pdf, 0.0)


def sample(omega_out, alpha_x, alpha_y, u1, u2, distrib):
    """Importance-sample a reflected direction (microfacet-ggx.h:247-286).
    Returns (omega_in, f, pdf); invalid samples get f = pdf = 0."""
    m = sample_stretched(omega_out, alpha_x, alpha_y, u1, u2)
    cos_mo = (m * omega_out).sum(-1)
    omega_in = 2.0 * cos_mo[..., None] * m - omega_out
    f, pdf = eval_pdf(omega_in, omega_out, alpha_x, alpha_y, distrib)
    ok = (omega_out[..., 2] > 0.0) & (cos_mo > 0.0)
    return omega_in, torch.where(ok, f, 0.0), torch.where(ok, pdf, 0.0)
