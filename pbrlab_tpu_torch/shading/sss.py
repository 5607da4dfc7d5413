"""Random-walk subsurface scattering math over lanes (port of
pbrlab_tpu.shading.sss; reference shader/random-walk-sss.h).

Burley radius fitting with the compatible-MFP scale, the tiny-radius ->
diffuse fallback of BssrdfSetup, and the Chiang/Kutz/Burley albedo
inversion with channel-MIS distance sampling. The walk itself is the
integrator's volume mode.
"""
from __future__ import annotations

import torch

from ..core.math import PI, safe_divide_spectrum, sqr

BSSRDF_MIN_RADIUS = 1e-8


def burley_fitting5(a):
    """Eq. 5 diffuse surface transmission (random-walk-sss.h:40-43)."""
    return 1.85 - a + 7.0 * torch.abs((a - 0.8) ** 3)


def burley_compatible_mfp(r):
    return 0.25 * (1.0 / PI) * r


def bssrdf_setup(weight, albedo, radius):
    """BssrdfSetup as the principled shader calls it
    (cycles-principled-shader.cc:352-363): per channel, radius < 1e-8 turns
    that channel diffuse. Returns (weight, albedo, radius_out,
    diffuse_weight)."""
    tiny = radius < BSSRDF_MIN_RADIUS
    diffuse_weight = torch.where(tiny, weight, 0.0)
    weight = torch.where(tiny, 0.0, weight)
    radius = torch.where(tiny, 0.0, radius)
    radius_out = burley_compatible_mfp(radius) / torch.clamp(
        burley_fitting5(albedo), min=1e-12)
    radius_out = torch.where(tiny, 0.0, radius_out)
    return weight, albedo, radius_out, diffuse_weight


def scattering_coefficients(weight, albedo, radius):
    """Albedo inversion (random-walk-sss.h:111-136) -> sigma_t, sigma_s,
    initial walk throughput = weight / albedo."""
    a = albedo
    alpha = 1.0 - torch.exp(a * (-5.09406 + a * (2.61188 - a * 4.31805)))
    s = 1.9 - a + 3.5 * sqr(a - 0.8)
    sigma_t = 1.0 / torch.clamp(radius * s, min=1e-16)
    sigma_s = sigma_t * alpha
    return sigma_t, sigma_s, safe_divide_spectrum(weight, albedo)


def sample_channel_pdf(albedo, throughput):
    """Channel selection pdf proportional to |throughput * albedo|
    (random-walk-sss.h:141-172). Returns pdf [..., 3]."""
    w = torch.abs(throughput * albedo)
    total = w.sum(-1, keepdim=True)
    return torch.where(total > 0.0, w / torch.where(total > 0.0, total, 1.0),
                       1.0 / 3.0)


def sample_scatter_distance(throughput, sigma_s, sigma_t, u0, u1):
    """Distance sampling with channel MIS (random-walk-sss.h:174-187).
    Returns (distance, channel_pdf[..., 3])."""
    pdf = sample_channel_pdf(safe_divide_spectrum(sigma_s, sigma_t), throughput)
    cdf0 = pdf[..., 0]
    cdf1 = pdf[..., 0] + pdf[..., 1]
    channel = torch.where(u0 < cdf0, 0, torch.where(u0 < cdf1, 1, 2))
    sig = torch.gather(sigma_t, -1, channel[..., None])[..., 0]
    distance = (-torch.log(torch.clamp(1.0 - u1, min=1e-12))
                / torch.clamp(sig, min=1e-12))
    return distance, pdf
