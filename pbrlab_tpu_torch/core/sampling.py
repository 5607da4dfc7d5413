"""Sampling primitives over wavefront lanes (port of
pbrlab_tpu.core.sampling; reference sampler/sampling-utils.h)."""
from __future__ import annotations

import torch

from .math import PI


def cosine_sample_hemisphere(u1, u2):
    """Cosine-weighted hemisphere around +z (sampling-utils.h:10-14)."""
    phi = u1 * (2.0 * PI)
    r = torch.sqrt(u2)
    z = torch.sqrt(torch.clamp(1.0 - u2, min=0.0))
    return torch.stack([torch.cos(phi) * r, torch.sin(phi) * r, z], dim=-1)


def uniform_sample_sphere(u1, u2):
    """Uniform sphere, y-up convention as the reference (sampling-utils.h:16-23)."""
    y = 2.0 * u2 - 1.0
    norm = torch.sqrt(torch.clamp(1.0 - y * y, min=0.0))
    theta = 2.0 * PI * u1
    return torch.stack([norm * torch.cos(theta), y, norm * torch.sin(theta)],
                       dim=-1)


def power_heuristic_weight(sampled_pdf, other_pdf):
    """Power heuristic (beta=2) with the reference's exact-tie 0.5 case
    (sampling-utils.h:27-57). Safe for zero pdfs."""
    big = torch.maximum(sampled_pdf, other_pdf)
    big = torch.where(big > 0.0, big, 1.0)
    r_gt = other_pdf / big
    r_lt = sampled_pdf / big
    mis_gt = 1.0 / (1.0 + r_gt * r_gt)
    mis_lt = 1.0 - 1.0 / (1.0 + r_lt * r_lt)
    return torch.where(sampled_pdf > other_pdf, mis_gt,
                       torch.where(sampled_pdf < other_pdf, mis_lt, 0.5))


def triangle_uniform_sample(u1, u2):
    """Uniform barycentric (u, v) via sorted pair (sampling-utils.h:59-66)."""
    big = torch.maximum(u1, u2)
    small = torch.minimum(u1, u2)
    return 1.0 - big, big - small


def sample_cdf(cdf, u):
    """Per-lane lower_bound over a normalized inclusive CDF [K]
    (std::lower_bound, light-manager.h:93-96)."""
    idx = torch.searchsorted(cdf, u.contiguous(), side="left")
    return torch.clamp(idx, max=cdf.shape[0] - 1)
