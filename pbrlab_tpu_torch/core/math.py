"""Vector math on torch tensors with a trailing xyz axis.

Port of pbrlab_tpu.core.math: every function is shape-polymorphic over
[..., 3] lanes. The TPU's `small_table_fetch` (a masked select-sum that
avoided slow TPU gathers) is a plain index here, so it is not ported.
"""
from __future__ import annotations

import torch

PI = 3.141592653589793
INV_PI = 1.0 / PI
EPS = 1e-3
# Embree-safe "infinity" (reference kInf, pbrlab_math.h:11).
INF = 1.844e18
F32_EPS = 1.1920929e-07  # float32 machine epsilon


def vdot(a, b):
    """Dot product over the trailing xyz axis -> [...]."""
    return (a * b).sum(-1)


def vnormalize(a):
    """Normalize like the reference (1/sqrt with a tiny floor)."""
    inv = 1.0 / torch.sqrt(torch.clamp(vdot(a, a), min=1e-20))
    return a * inv[..., None]


def gather_rows(table, idx):
    """table[idx] for a 1-D int64 index, through `index_select`: its
    backward adds each lane's cotangent into the table with `index_add_`.
    Indexing's backward sorts the indices and sums each row's duplicates
    in turn, which for a million lanes into a table of a few rows (the
    materials) took ~0.3 s a call on an H100 80GB HBM3 (PERF.md
    section 6)."""
    return torch.index_select(table, 0, idx)


def saturate(x):
    return torch.clamp(x, 0.0, 1.0)


def lerp(a, b, t):
    return a + (b - a) * t


def sqr(x):
    return x * x


def safe_sqrt(x):
    """SafeSqrtf (reference pbrlab_math.h): sqrt(max(x, 0)).

    Where x carries a gradient, its cotangent is 0 at x <= 0 and the
    value the same bits: sqrt's derivative is infinite at 0, and a zero
    cotangent (a masked lane, a specular of 0) times it is NaN."""
    y = torch.sqrt(torch.clamp(x, min=0.0))
    if not (x.requires_grad and torch.is_grad_enabled()):
        return y
    pos = x > 0.0
    return torch.where(pos, torch.sqrt(torch.where(pos, x, 1.0)), y.detach())


def grad_safe_sqrt(x, eps=1e-12):
    """sqrt with a floor (kept for value parity with the JAX package, where
    the floor keeps the backward pass finite)."""
    return torch.sqrt(torch.clamp(x, min=eps))


def spectrum_norm(c):
    """max(r,g,b) — reference pbrlab-util.h SpectrumNorm."""
    return c.amax(-1)


def rgb_to_y(c):
    """Luminance — reference pbrlab-util.h RgbToY."""
    return 0.212671 * c[..., 0] + 0.715160 * c[..., 1] + 0.072169 * c[..., 2]


def safe_divide_spectrum(a, b):
    """Component-wise a/b with 0 where |b| < float eps (pbrlab-util.h)."""
    small = torch.abs(b) < F32_EPS
    return torch.where(small, 0.0, a / torch.where(small, 1.0, b))


def fresnel_dielectric_cos(cos_i, eta):
    """Dielectric Fresnel without computing the refracted direction
    (closure-util.h:10-31): eta==0 -> 1, cos<0 flips eta, g<=0 -> TIR -> 1."""
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
