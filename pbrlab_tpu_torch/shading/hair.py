"""Principled (energy-conserving) Hair BSDF on torch lanes (port of
pbrlab_tpu.shading.hair).

Semantics from the reference's closure/energy-conserving-hair-bsdf.h
(pbrt-v3 / Cycles lineage with the "improved robe evaluation" of Path
Tracing in Production 2018: the SafeLogI0 Horner polynomials, :92-170) and
shader/hair-shader.cc (BetamToV roughness mapping :19-27, CalcS azimuthal
logistic scale :29-33, sigma_a from RGB :35-46 or melanin :48-64, 4-lobe
tints, shift in degrees). The SafeLogI0 and melanin constants are the
reference's, digit for digit.

Hair frame (hair-shader.cc:164-173): ex = curve tangent, omega[0] =
sin(theta) along the hair, phi = atan2(omega[2], omega[1]).
`eval_cos_pdf` returns f*cos; callers divide by |omega_in[0]| for NEE
(hair-shader.cc:196-198) and use f_cos / pdf for the throughput (:225).
"""
from __future__ import annotations

from typing import Dict, NamedTuple

import torch

from ..core.math import PI, rgb_to_y, safe_sqrt, saturate, sqr

_V_MIN, _V_MAX = 1e-5, 1e4
# SafeLogI0 (energy-conserving-hair-bsdf.h:141-170), lowest order first
_P_SMALL = (1.00000003928615375e+00, 2.49999576572179639e-01,
            2.77785268558399407e-02, 1.73560257755821695e-03,
            6.96166518788906424e-05, 1.89645733877137904e-06,
            4.29455004657565361e-08, 3.90565476357034480e-10,
            1.48095934745267240e-11)
_P_LARGE = (3.98942651588301770e-01, 4.98327234176892844e-02,
            2.91866904423115499e-02, 1.35614940793742178e-02,
            1.31409251787866793e-01)


class HairBsdf(NamedTuple):
    sigma_a: torch.Tensor  # [N,3]
    h: torch.Tensor  # [N] azimuthal offset in [-1,1]
    v: torch.Tensor  # [N,4] longitudinal variances per lobe
    s: torch.Tensor  # [N] azimuthal logistic scale
    eta: torch.Tensor  # [N]
    alpha: torch.Tensor  # [N] scale tilt (radians)
    tints: torch.Tensor  # [N,4,3]


def _ipow(x, n: int):
    """x ** n for a positive int n by square-and-multiply, the product
    order of XLA's integer_pow (the JAX package's `x ** 20`)."""
    acc = None
    while n:
        if n & 1:
            acc = x if acc is None else acc * x
        n >>= 1
        if n:
            x = x * x
    return acc


def _horner(coeffs, x):
    """sum coeffs[i] x^i evaluated as jnp.polyval does: from 0, y*x + c
    over the coefficients highest order first, each rounded to float32."""
    y = torch.zeros_like(x)
    for c in reversed(coeffs):
        y = y * x + c
    return y


def betam_to_v(beta_m):
    """Roughness -> longitudinal variance of the 4 lobes
    (hair-shader.cc:19-27)."""
    v0 = sqr(0.726 * beta_m + 0.812 * sqr(beta_m) + 3.7 * _ipow(beta_m, 20))
    return torch.stack([v0, 0.25 * v0, 4.0 * v0, 4.0 * v0], dim=-1)


# sqrt(pi / 8) rounded as float32 arithmetic rounds it (the JAX package's
# jnp.sqrt of a float32), held exactly by a Python float
_SQRT_PI_8 = float(torch.sqrt(torch.tensor(PI / 8.0, dtype=torch.float32)))


def calc_s(beta_n):
    """Azimuthal roughness -> trimmed-logistic scale (hair-shader.cc:29-33)."""
    b2 = sqr(beta_n)
    return _SQRT_PI_8 * (0.265 * beta_n + 1.194 * b2 + 5.372 * _ipow(b2, 11))


def sigma_a_from_rgb(c, beta_n):
    """Absorption from an RGB color (hair-shader.cc:35-46)."""
    denom = (5.969 - 0.215 * beta_n + 2.532 * sqr(beta_n)
             - 10.73 * _ipow(beta_n, 3) + 5.574 * _ipow(beta_n, 4)
             + 0.245 * _ipow(beta_n, 5))
    return sqr(torch.log(torch.clamp(c, min=1e-6)) / denom[..., None])


def sigma_a_from_melanin(melanin, melanin_redness, random_value=0.5):
    """Absorption from eumelanin / pheomelanin (hair-shader.cc:48-64)."""
    factor = 1.0 + 2.0 * (random_value - 0.5)
    m = saturate(melanin) * factor
    redness = saturate(melanin_redness)
    m = -torch.log(torch.clamp(1.0 - m, min=1e-4))
    eu = m * (1.0 - redness)
    pheo = m * redness
    return torch.stack([
        torch.clamp(eu * 0.506 + pheo * 0.343, min=0.0),
        torch.clamp(eu * 0.841 + pheo * 0.733, min=0.0),
        torch.clamp(eu * 1.653 + pheo * 1.924, min=0.0)], dim=-1)


def param_to_bsdf(mat: Dict[str, torch.Tensor], geom_v) -> HairBsdf:
    """HairBsdfParameter -> closure (hair-shader.cc ParamToBsdf:103-153).
    geom_v is the curve hit's ribbon offset (the reference's
    TraceResult.v as h, hair-shader.cc:183)."""
    rgb = sigma_a_from_rgb(mat["hair_base_color"], mat["azimuthal_roughness"])
    mel = sigma_a_from_melanin(mat["melanin"], mat["melanin_redness"])
    sigma_a = torch.where((mat["hair_coloring"] == 0)[..., None], rgb, mel)
    tints = torch.stack([mat["hair_specular_tint"], mat["transmission_tint"],
                         mat["second_specular_tint"],
                         torch.ones_like(mat["hair_specular_tint"])], dim=-2)
    return HairBsdf(
        sigma_a=sigma_a, h=geom_v, v=betam_to_v(mat["hair_roughness"]),
        s=calc_s(mat["azimuthal_roughness"]), eta=mat["hair_ior"],
        alpha=mat["shift"] * (PI / 180.0), tints=tints)


def _safe_log_i0(x):
    """SafeLogI0 with the improved-robe Horner evaluation (:141-170)."""
    x = torch.abs(x)
    x22 = x * x / 4.0
    small = torch.log(torch.clamp(x22 * _horner(_P_SMALL, x22),
                                  min=1e-38)) + 1.0
    inv_x = 1.0 / torch.clamp(x, min=7.5)
    px = _horner(_P_LARGE, inv_x)
    large = x + 0.5 * torch.log(torch.clamp(px * px * inv_x, min=1e-38))
    return torch.where(x < 7.5, small, large)


def _mp(sin_i, cos_i, sin_o, cos_o, v):
    """Longitudinal lobe Mp (:172-202, improved-robe branch)."""
    v = torch.clamp(v, _V_MIN, _V_MAX)
    ccv = cos_i * cos_o / v
    ssv = sin_i * sin_o / v
    return torch.exp(_safe_log_i0(ccv) - ssv - 1.0 / v + torch.log(1.0 / v)
                     - torch.log(torch.clamp(1.0 - torch.exp(-2.0 / v),
                                             min=1e-38)))


def _fr_dielectric(cos_i, eta_i, eta_t):
    """pbrt dielectric Fresnel (:205-229)."""
    cos_i = torch.clamp(cos_i, -1.0, 1.0)
    entering = cos_i > 0.0
    ei = torch.where(entering, eta_i, eta_t)
    et = torch.where(entering, eta_t, eta_i)
    ci = torch.abs(cos_i)
    si = safe_sqrt(1.0 - ci * ci)
    st = ei / et * si
    tir = st >= 1.0
    ct = safe_sqrt(1.0 - st * st)
    r_parl = (et * ci - ei * ct) / torch.clamp(et * ci + ei * ct, min=1e-12)
    r_perp = (ei * ci - et * ct) / torch.clamp(ei * ci + et * ct, min=1e-12)
    return torch.where(tir, 1.0, 0.5 * (r_parl * r_parl + r_perp * r_perp))


def _ap(cos_theta_o, eta, h, T):
    """Lobe attenuations (R, TT, TRT, residual) (:231-255) -> [N,4,3]."""
    cos_gamma_o = safe_sqrt(1.0 - h * h)
    cos_theta = cos_theta_o * cos_gamma_o
    f = _fr_dielectric(cos_theta, torch.ones_like(eta), eta)[..., None]
    ap0 = f.expand(T.shape)
    ap1 = sqr(1.0 - f) * T
    ap2 = ap1 * T * f
    ap3 = ap2 * f * T / torch.clamp(1.0 - T * f, min=1e-12)
    ap3 = torch.where(torch.isfinite(ap3), ap3, 0.0)
    return torch.stack([ap0, ap1, ap2, ap3], dim=-2)


def _logistic(x, s):
    x = torch.abs(x)
    num = torch.exp(-x / s)
    return num / torch.clamp(s * sqr(1.0 + num), min=1e-38)


def _logistic_cdf(x, s):
    return 1.0 / (1.0 + torch.exp(-x / s))


def _trimmed_logistic(x, s, a, b):
    return _logistic(x, s) / torch.clamp(
        _logistic_cdf(b, s) - _logistic_cdf(a, s), min=1e-12)


def _phi_lobe(p, gamma_o, gamma_t):
    return 2.0 * p * gamma_t - 2.0 * gamma_o + p * PI


def _np_lobe(phi, p, s, gamma_o, gamma_t):
    dphi = phi - _phi_lobe(p, gamma_o, gamma_t)
    dphi = dphi - torch.floor(dphi / (2.0 * PI)) * (2.0 * PI)
    dphi = torch.where(dphi >= PI, dphi - 2.0 * PI, dphi)
    return _trimmed_logistic(dphi, s, -PI, PI)


def _tilted_angles(sin_o, cos_o, alpha):
    """Scale-tilt 2k-angle recurrences (:309-339) -> sin/cos per lobe."""
    s1 = torch.sin(alpha)
    c1 = torch.cos(alpha)
    s2 = 2.0 * s1 * c1
    c2 = c1 * c1 - s1 * s1
    s4 = 2.0 * s2 * c2
    c4 = c2 * c2 - s2 * s2
    sin_crt = torch.stack([
        sin_o * c2 - cos_o * s2,  # R: rotate by -2 alpha
        sin_o * c1 + cos_o * s1,  # TT: rotate by alpha
        sin_o * c4 + cos_o * s4,  # TRT: rotate by 4 alpha
        sin_o], dim=-1)
    cos_crt = torch.stack([
        cos_o * c2 + sin_o * s2,
        cos_o * c1 - sin_o * s1,
        cos_o * c4 - sin_o * s4,
        cos_o], dim=-1)
    return sin_crt, cos_crt


def _common_terms(omega_out, bsdf: HairBsdf):
    sin_o = omega_out[..., 0]
    cos_o = safe_sqrt(1.0 - sqr(sin_o))
    sin_crt, cos_crt = _tilted_angles(sin_o, cos_o, bsdf.alpha)
    phi_o = torch.atan2(omega_out[..., 2], omega_out[..., 1])
    sin_theta_t = sin_o / bsdf.eta
    cos_theta_t = safe_sqrt(1.0 - sqr(sin_theta_t))
    etap = torch.sqrt(torch.clamp(bsdf.eta * bsdf.eta - sqr(sin_o),
                                  min=1e-12)) / torch.clamp(cos_o, min=1e-12)
    sin_gamma_t = bsdf.h / etap
    cos_gamma_t = safe_sqrt(1.0 - sqr(sin_gamma_t))
    gamma_t = torch.asin(torch.clamp(sin_gamma_t, -1.0, 1.0))
    l = 2.0 * cos_gamma_t / torch.clamp(cos_theta_t, min=1e-12)  # noqa: E741
    T = torch.exp(-bsdf.sigma_a * l[..., None])
    gamma_o = torch.asin(torch.clamp(bsdf.h, -1.0, 1.0))
    ap = _ap(cos_o, bsdf.eta, bsdf.h, T)  # [N,4,3]
    ap_y = rgb_to_y(ap)  # [N,4]
    ap_pdf = ap_y / torch.clamp(ap_y.sum(-1, keepdim=True), min=1e-12)
    return (sin_o, cos_o, sin_crt, cos_crt, phi_o, gamma_o, gamma_t, ap,
            ap_pdf)


def _eval_lobes(sin_i, cos_i, phi, sin_crt, cos_crt, bsdf, gamma_o, gamma_t,
                ap, ap_pdf):
    """Sum the 4 lobes -> (f_cos [N,3], pdf [N]) (:377-405)."""
    f = torch.zeros_like(bsdf.sigma_a)
    pdf = torch.zeros_like(sin_i)
    for p in range(3):
        mpnp = _mp(sin_i, cos_i, sin_crt[..., p], cos_crt[..., p],
                   bsdf.v[..., p]) * _np_lobe(phi, float(p), bsdf.s, gamma_o,
                                              gamma_t)
        pdf = pdf + mpnp * ap_pdf[..., p]
        f = f + mpnp[..., None] * ap[..., p, :] * bsdf.tints[..., p, :]
    mpnp = _mp(sin_i, cos_i, sin_crt[..., 3], cos_crt[..., 3],
               bsdf.v[..., 3]) * (1.0 / (2.0 * PI))
    pdf = pdf + mpnp * ap_pdf[..., 3]
    f = f + mpnp[..., None] * ap[..., 3, :] * bsdf.tints[..., 3, :]
    bad = ~torch.isfinite(f).all(-1) | ~torch.isfinite(pdf)
    return torch.where(bad[..., None], 0.0, f), torch.where(bad, 0.0, pdf)


def eval_cos_pdf(omega_in, omega_out, bsdf: HairBsdf):
    """EnergyConservingHairBsdfCosPdf (:295-405) -> (f*cos [N,3], pdf [N])."""
    (sin_o, cos_o, sin_crt, cos_crt, phi_o, gamma_o, gamma_t, ap,
     ap_pdf) = _common_terms(omega_out, bsdf)
    sin_i = omega_in[..., 0]
    cos_i = safe_sqrt(1.0 - sqr(sin_i))
    phi = torch.atan2(omega_in[..., 2], omega_in[..., 1]) - phi_o
    return _eval_lobes(sin_i, cos_i, phi, sin_crt, cos_crt, bsdf, gamma_o,
                       gamma_t, ap, ap_pdf)


def _sample_trimmed_logistic(s, a, b, u):
    T = _logistic_cdf(b, s) - _logistic_cdf(a, s)
    inner = 1.0 / torch.clamp(
        u * T + 1.0 / (1.0 + torch.exp(-a / s)), min=1e-12) - 1.0
    ret = -s * torch.log(torch.clamp(inner, min=1e-38))
    return torch.clamp(ret, a, b)


def sample(omega_out, bsdf: HairBsdf, u0, u1, u2, u3):
    """EnergyConservingHairSample (:419-572) -> (omega_in [N,3],
    f_cos [N,3], pdf [N])."""
    (sin_o, cos_o, sin_crt, cos_crt, phi_o, gamma_o, gamma_t, ap,
     ap_pdf) = _common_terms(omega_out, bsdf)

    # lobe selection by the ap luminance CDF (:484-497)
    cdf = torch.cumsum(ap_pdf, dim=-1)
    p = torch.where(u0 < cdf[..., 0], 0,
                    torch.where(u0 < cdf[..., 1], 1,
                                torch.where(u0 < cdf[..., 2], 2, 3)))
    idx = p[..., None].to(torch.int64)
    vp = torch.clamp(torch.gather(bsdf.v, -1, idx)[..., 0], _V_MIN, _V_MAX)
    sin_oc = torch.gather(sin_crt, -1, idx)[..., 0]
    cos_oc = torch.gather(cos_crt, -1, idx)[..., 0]

    # theta via lobe-variance inversion (:499-511)
    u = 1.0 + vp * torch.log(torch.clamp(
        u1 + (1.0 - u1) * torch.exp(-2.0 / vp), min=1e-38))
    sin_i = -u * sin_oc + safe_sqrt(1.0 - sqr(u)) \
        * torch.cos(2.0 * PI * u2) * cos_oc
    cos_i = safe_sqrt(1.0 - sqr(sin_i))

    # phi (:513-519)
    dphi_lobe = (_phi_lobe(p.to(torch.float32), gamma_o, gamma_t)
                 + _sample_trimmed_logistic(bsdf.s, -PI, PI, u3))
    dphi = torch.where(p < 3, dphi_lobe, 2.0 * PI * u3)
    phi_i = phi_o + dphi
    omega_in = torch.stack([sin_i, cos_i * torch.cos(phi_i),
                            cos_i * torch.sin(phi_i)], dim=-1)
    f, pdf = _eval_lobes(sin_i, cos_i, dphi, sin_crt, cos_crt, bsdf, gamma_o,
                         gamma_t, ap, ap_pdf)
    return omega_in, f, pdf
