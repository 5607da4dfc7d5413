"""Shading math of the plain reference: counter-seeded PCG, vector math,
the branchless frame, sampling, random-walk SSS coefficients, GGX and the
Cycles-compatible Principled BSDF.

A frozen copy of pbrlab_tpu_torch's `core/rng.py`, `core/math.py`,
`core/onb.py`, `core/sampling.py`, `shading/sss.py`, `shading/ggx.py` and
`shading/principled.py` as they stood when the benchmark was written
(which follow pbrlab's shader/ and closure/ sources), cut to what a
triangle scene without textures or hair reads. The benchmark keeps it so
that no change to the program can move its yardstick. Every function is
generic in the float type of its tensor arguments: the precision control
runs the same code on bfloat16 tensors.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

# ---- PCG (core/rng.py) --------------------------------------------------
_MASK = 0xFFFFFFFF
_MULT = 747796405
_INC = 2891336453
_OUT_MULT = 277803737
_GOLDEN = 0x9E3779B9


def _u32(x):
    return x & _MASK


def _pcg_out(state):
    word = _u32(((state >> ((state >> 28) + 4)) ^ state) * _OUT_MULT)
    return (word >> 22) ^ word


def hash_u32(x):
    return _pcg_out(_u32(x * _MULT + _INC))


def seed_state(pixel_id, sample_id, seed):
    """Per-path uint32 states (int64 carrier) from (pixel, sample, seed);
    each argument an int64 tensor or a Python int."""
    pixel_id = torch.as_tensor(pixel_id).to(torch.int64) & _MASK
    sample_id = torch.as_tensor(sample_id).to(torch.int64) & _MASK
    seed = (seed.to(torch.int64) if torch.is_tensor(seed) else int(seed)) \
        & _MASK
    h = hash_u32(pixel_id ^ ((seed * _GOLDEN) & _MASK))
    return hash_u32(h ^ _u32(sample_id * 0x85EBCA6B))


def draw(state, dtype):
    """Advance each path and return (state, uniform in [0, 1) as dtype)."""
    state = _u32(state * _MULT + _INC)
    bits = (_pcg_out(state) >> 9) | 0x3F800000
    return state, (bits.to(torch.int32).view(torch.float32) - 1.0).to(dtype)


def draw_n(state, n, dtype):
    us = []
    for _ in range(n):
        state, u = draw(state, dtype)
        us.append(u)
    return state, us


# ---- vector math (core/math.py) -----------------------------------------
PI = 3.141592653589793
INV_PI = 1.0 / PI
EPS = 1e-3
INF = 1.844e18
F32_EPS = 1.1920929e-07


def vdot(a, b):
    return (a * b).sum(-1)


def vnormalize(a):
    inv = 1.0 / torch.sqrt(torch.clamp(vdot(a, a), min=1e-20))
    return a * inv[..., None]


def saturate(x):
    return torch.clamp(x, 0.0, 1.0)


def lerp(a, b, t):
    return a + (b - a) * t


def sqr(x):
    return x * x


def safe_sqrt(x):
    """sqrt(max(x, 0)), with a zero cotangent where x <= 0."""
    y = torch.sqrt(torch.clamp(x, min=0.0))
    if not (x.requires_grad and torch.is_grad_enabled()):
        return y
    pos = x > 0.0
    return torch.where(pos, torch.sqrt(torch.where(pos, x, 1.0)), y.detach())


def grad_safe_sqrt(x, eps=1e-12):
    return torch.sqrt(torch.clamp(x, min=eps))


def spectrum_norm(c):
    return c.amax(-1)


def rgb_to_y(c):
    return 0.212671 * c[..., 0] + 0.715160 * c[..., 1] + 0.072169 * c[..., 2]


def safe_divide_spectrum(a, b):
    small = torch.abs(b) < F32_EPS
    return torch.where(small, 0.0, a / torch.where(small, 1.0, b))


def fresnel_dielectric_cos(cos_i, eta):
    eta_eff = torch.where(cos_i < 0.0,
                          1.0 / torch.where(eta == 0.0, 1.0, eta), eta)
    c = torch.abs(cos_i)
    g2 = eta_eff * eta_eff - 1.0 + c * c
    g = torch.sqrt(torch.clamp(g2, min=1e-20))
    a = (g - c) / (g + c)
    b = (c * (g + c) - 1.0) / (c * (g - c) + 1.0)
    refl = 0.5 * a * a * (1.0 + b * b)
    refl = torch.where(g2 > 0.0, refl, 1.0)
    return torch.where(torch.abs(eta) < F32_EPS, 1.0, refl)


# ---- frame (core/onb.py) ------------------------------------------------
def branchless_onb(n):
    sign = torch.where(n[..., 2] >= 0.0, 1.0, -1.0).to(n.dtype)
    a = -1.0 / (sign + n[..., 2])
    b = n[..., 0] * n[..., 1] * a
    ex = torch.stack(
        [1.0 + sign * n[..., 0] * n[..., 0] * a, sign * b, -sign * n[..., 0]],
        dim=-1)
    ey = torch.stack([b, sign + n[..., 1] * n[..., 1] * a, -n[..., 1]], dim=-1)
    return ex, ey


def to_local(v, ex, ey, ez):
    return torch.stack([vdot(v, ex), vdot(v, ey), vdot(v, ez)], dim=-1)


def to_global(v, ex, ey, ez):
    return v[..., 0:1] * ex + v[..., 1:2] * ey + v[..., 2:3] * ez


# ---- sampling (core/sampling.py) ----------------------------------------
def cosine_sample_hemisphere(u1, u2):
    phi = u1 * (2.0 * PI)
    r = torch.sqrt(u2)
    z = torch.sqrt(torch.clamp(1.0 - u2, min=0.0))
    return torch.stack([torch.cos(phi) * r, torch.sin(phi) * r, z], dim=-1)


def uniform_sample_sphere(u1, u2):
    y = 2.0 * u2 - 1.0
    norm = torch.sqrt(torch.clamp(1.0 - y * y, min=0.0))
    theta = 2.0 * PI * u1
    return torch.stack([norm * torch.cos(theta), y, norm * torch.sin(theta)],
                       dim=-1)


def power_heuristic_weight(sampled_pdf, other_pdf):
    big = torch.maximum(sampled_pdf, other_pdf)
    big = torch.where(big > 0.0, big, 1.0)
    r_gt = other_pdf / big
    r_lt = sampled_pdf / big
    mis_gt = 1.0 / (1.0 + r_gt * r_gt)
    mis_lt = 1.0 - 1.0 / (1.0 + r_lt * r_lt)
    return torch.where(sampled_pdf > other_pdf, mis_gt,
                       torch.where(sampled_pdf < other_pdf, mis_lt, 0.5))


def triangle_uniform_sample(u1, u2):
    big = torch.maximum(u1, u2)
    small = torch.minimum(u1, u2)
    return 1.0 - big, big - small


def sample_cdf(cdf, u):
    idx = torch.searchsorted(cdf, u.contiguous(), side="left")
    return torch.clamp(idx, max=cdf.shape[0] - 1)


# ---- random-walk SSS (shading/sss.py) -----------------------------------
BSSRDF_MIN_RADIUS = 1e-8


def burley_fitting5(a):
    return 1.85 - a + 7.0 * torch.abs((a - 0.8) ** 3)


def bssrdf_setup(weight, albedo, radius):
    tiny = radius < BSSRDF_MIN_RADIUS
    diffuse_weight = torch.where(tiny, weight, 0.0)
    weight = torch.where(tiny, 0.0, weight)
    radius = torch.where(tiny, 0.0, radius)
    radius_out = 0.25 * (1.0 / PI) * radius / torch.clamp(
        burley_fitting5(albedo), min=1e-12)
    radius_out = torch.where(tiny, 0.0, radius_out)
    return weight, albedo, radius_out, diffuse_weight


def scattering_coefficients(weight, albedo, radius):
    a = albedo
    alpha = 1.0 - torch.exp(a * (-5.09406 + a * (2.61188 - a * 4.31805)))
    s = 1.9 - a + 3.5 * sqr(a - 0.8)
    sigma_t = 1.0 / torch.clamp(radius * s, min=1e-16)
    sigma_s = sigma_t * alpha
    return sigma_t, sigma_s, safe_divide_spectrum(weight, albedo)


def sample_channel_pdf(albedo, throughput):
    w = torch.abs(throughput * albedo)
    total = w.sum(-1, keepdim=True)
    return torch.where(total > 0.0, w / torch.where(total > 0.0, total, 1.0),
                       1.0 / 3.0)


def sample_scatter_distance(throughput, sigma_s, sigma_t, u0, u1):
    pdf = sample_channel_pdf(safe_divide_spectrum(sigma_s, sigma_t),
                             throughput)
    cdf0 = pdf[..., 0]
    cdf1 = pdf[..., 0] + pdf[..., 1]
    channel = torch.where(u0 < cdf0, 0, torch.where(u0 < cdf1, 1, 2))
    sig = torch.gather(sigma_t, -1, channel[..., None])[..., 0]
    distance = (-torch.log(torch.clamp(1.0 - u1, min=1e-12))
                / torch.clamp(sig, min=1e-12))
    return distance, pdf


# ---- GGX (shading/ggx.py) -----------------------------------------------
def d_gtr1(h, alpha):
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
    tan_theta_i = sin_theta_i / torch.clamp(cos_theta_i, min=1e-12)
    g1_inv = 0.5 * (1.0 + safe_sqrt(1.0 + tan_theta_i * tan_theta_i))
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
    s = torch.where(randv > 0.5, 1.0, -1.0).to(randv.dtype)
    rv = torch.where(randv > 0.5, 2.0 * (randv - 0.5), 2.0 * (0.5 - randv))
    z = (rv * (rv * (rv * 0.27385 - 0.73369) + 0.46341)) / (
        rv * (rv * (rv * 0.093073 + 0.309420) - 1.0) + 0.597999)
    slope_y = s * z * safe_sqrt(1.0 + slope_x * slope_x)
    r = torch.sqrt(randu / torch.clamp(1.0 - randu, min=1e-12))
    phi = 2.0 * PI * randv
    near_normal = cos_theta_i >= 0.99999
    slope_x = torch.where(near_normal, r * torch.cos(phi), slope_x)
    slope_y = torch.where(near_normal, r * torch.sin(phi), slope_y)
    return slope_x, slope_y


def sample_stretched(omega_i, alpha_x, alpha_y, randu, randv):
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
    slope_x, slope_y = _sample_slopes(costheta, sintheta, randu, randv)
    tmp = cosphi * slope_x - sinphi * slope_y
    slope_y = sinphi * slope_x + cosphi * slope_y
    slope_x = alpha_x * tmp
    slope_y = alpha_y * slope_y
    return vnormalize(torch.stack(
        [-slope_x, -slope_y, torch.ones_like(slope_x)], dim=-1))


def ggx_eval_pdf(omega_in, omega_out, alpha_x, alpha_y, distrib):
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
    ax = torch.where(iso, 1.0, alpha_x)
    ay = torch.where(iso, 1.0, alpha_y)
    z_axis = torch.zeros_like(m)
    z_axis[..., 2] = 1.0
    ma = torch.where(iso[..., None], z_axis, m)
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


def ggx_sample(omega_out, alpha_x, alpha_y, u1, u2, distrib):
    m = sample_stretched(omega_out, alpha_x, alpha_y, u1, u2)
    cos_mo = (m * omega_out).sum(-1)
    omega_in = 2.0 * cos_mo[..., None] * m - omega_out
    f, pdf = ggx_eval_pdf(omega_in, omega_out, alpha_x, alpha_y, distrib)
    ok = (omega_out[..., 2] > 0.0) & (cos_mo > 0.0)
    return omega_in, torch.where(ok, f, 0.0), torch.where(ok, pdf, 0.0)


# ---- Principled BSDF (shading/principled.py) ----------------------------
class PrincipledBsdf(NamedTuple):
    enable_diffuse: torch.Tensor
    diffuse_weight: torch.Tensor
    enable_subsurface: torch.Tensor
    subsurface_weight: torch.Tensor
    subsurface_albedo: torch.Tensor
    subsurface_radius: torch.Tensor
    enable_specular: torch.Tensor
    specular_weight: torch.Tensor
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


def param_to_bsdf(mat, base_color, subsurface_color):
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
    enable_specular = (specular_w > cutoff) & (
        (specular > cutoff) | (metallic > cutoff))
    aspect = safe_sqrt(1.0 - mat["anisotropic"] * 0.9)
    r2 = roughness * roughness
    y_base = rgb_to_y(base_color)
    rho_tint = torch.where(
        y_base[..., None] > 0.0,
        base_color / torch.clamp(y_base[..., None], min=1e-12), 0.0)
    rho_specular = lerp(torch.ones_like(rho_tint), rho_tint,
                        mat["specular_tint"][..., None])
    specular_weight = torch.where(enable_specular[..., None],
                                  specular_w[..., None].expand_as(base_color),
                                  0.0)
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
    h = vnormalize(omega_in + omega_out)
    f0 = fresnel_dielectric_cos(torch.ones_like(ior), ior)
    fh = (fresnel_dielectric_cos((h * omega_out).sum(-1), ior) - f0) \
        / torch.clamp(1.0 - f0, min=1e-12)
    return color * (1.0 - fh[..., None]) + fh[..., None]


def closure_sample_weights(omega_out, bsdf: PrincipledBsdf):
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
    wd, _ws, wsp, wcc = closure_sample_weights(omega_out, bsdf)
    f = torch.zeros_like(bsdf.diffuse_weight)
    pdf = torch.zeros_like(wd)
    f = f + torch.where(bsdf.enable_diffuse[..., None],
                        bsdf.diffuse_weight * INV_PI, 0.0)
    pdf = pdf + torch.where(bsdf.enable_diffuse,
                            wd * (omega_in[..., 2] * INV_PI), 0.0)
    sf, sp = ggx_eval_pdf(omega_in, omega_out, bsdf.alpha_x, bsdf.alpha_y, 2)
    spec_col = _specular_color(omega_in, omega_out, bsdf.specular_color,
                               bsdf.ior)
    f = f + torch.where(bsdf.enable_specular[..., None],
                        bsdf.specular_weight * spec_col * sf[..., None], 0.0)
    pdf = pdf + torch.where(bsdf.enable_specular, wsp * sp, 0.0)
    cf, cp = ggx_eval_pdf(omega_in, omega_out, bsdf.clearcoat_alpha,
                          bsdf.clearcoat_alpha, 1)
    cc_col = _specular_color(omega_in, omega_out, bsdf.clearcoat_color,
                             bsdf.clearcoat_ior)
    f = f + torch.where(bsdf.enable_clearcoat[..., None],
                        bsdf.clearcoat_weight * cc_col * cf[..., None], 0.0)
    pdf = pdf + torch.where(bsdf.enable_clearcoat, wcc * cp, 0.0)
    return f, pdf


def sample_surface(omega_out, bsdf: PrincipledBsdf, u_select, u1, u2):
    wd, ws, wsp, _wcc = closure_sample_weights(omega_out, bsdf)
    pick_diffuse = u_select < wd
    pick_sss = (~pick_diffuse) & (u_select < wd + ws)
    pick_spec = (~pick_diffuse) & (~pick_sss) & (u_select < wd + ws + wsp)
    wi_d = cosine_sample_hemisphere(u1, u2)
    wi_s, _, _ = ggx_sample(omega_out, bsdf.alpha_x, bsdf.alpha_y, u1, u2, 2)
    wi_c, _, _ = ggx_sample(omega_out, bsdf.clearcoat_alpha,
                            bsdf.clearcoat_alpha, u1, u2, 1)
    omega_in = torch.where(pick_diffuse[..., None], wi_d,
                           torch.where(pick_spec[..., None], wi_s, wi_c))
    f, pdf = eval_bsdf(omega_in, omega_out, bsdf)
    return omega_in, f, pdf, pick_sss
