"""Shading of the port against the JAX package and the numpy oracle.

Same float32 formulas on the same numpy inputs: rtol 1e-5 against JAX.
Torch and XLA:CPU may round sums and transcendentals differently by an
ulp; on the few ill-conditioned lanes (the GGX slope solve near |a| = 1,
near-specular pdfs of roughness 0.02) that ulp grows, so sampled values
are held to rtol 1e-5 on 99.5% of values and rtol 1e-2 on all of them.
Against the float64 oracle (tests/oracle_pbr.py, an independent
transcription) the band is float32 rounding: rtol 1e-4 on 99.5% of
values, rtol 1e-2 on all. Unit directions take atol 1e-5.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oracle_pbr import _eval as oracle_eval
from oracle_pbr import _ggx_eval_pdf as oracle_ggx_eval_pdf
from oracle_pbr import _ggx_sample as oracle_ggx_sample
from oracle_pbr import _setup as oracle_setup
from pbrlab_tpu.shading import ggx as jggx
from pbrlab_tpu.shading import principled as jpr
from pbrlab_tpu.shading import sss as jsss
from pbrlab_tpu_torch.shading import ggx as tggx
from pbrlab_tpu_torch.shading import principled as tpr
from pbrlab_tpu_torch.shading import sss as tsss

N = 4096
RTOL = 1e-5


def _close(got, want, rtol=RTOL, atol=1e-6, tail=False):
    """Every value within (rtol, atol); with tail, 99.5% of values within
    it and every value within rtol 1e-2 (see the module docstring)."""
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    if not tail:
        np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)
        return
    assert np.isclose(got, want, rtol=rtol, atol=atol).mean() >= 0.995
    np.testing.assert_allclose(got, want, rtol=1e-2, atol=atol)


def _dirs(rng, n, upper=True):
    d = rng.normal(size=(n, 3))
    if upper:
        d[:, 2] = np.abs(d[:, 2]) + 1e-3
    return (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)


def _materials(rng, n, full=True):
    """Per-lane principled parameters; full=False keeps the oracle's subset
    (no metallic / transmission / anisotropy / clearcoat)."""
    f = lambda lo=0.0, hi=1.0: rng.uniform(lo, hi, n).astype(np.float32)  # noqa: E731
    z = np.zeros(n, np.float32)
    mat = {
        "subsurface": np.where(rng.random(n) < 0.4, f(), 0.0).astype(np.float32),
        "subsurface_radius": rng.uniform(0, 1.2, (n, 3)).astype(np.float32),
        "metallic": f() if full else z, "specular": f(),
        "specular_tint": f(), "roughness": f(0.02, 1.0),
        "anisotropic": np.where(rng.random(n) < 0.5, f(), 0.0).astype(
            np.float32) if full else z,
        "clearcoat": f() if full else z, "clearcoat_roughness": f(0.01, 0.5),
        "transmission": f() if full else z,
    }
    mat["subsurface_radius"][:64] = 0.0  # tiny radius -> diffuse fallback
    base = rng.random((n, 3)).astype(np.float32)
    sub = rng.random((n, 3)).astype(np.float32)
    return mat, base, sub


def _both_bsdfs(mat, base, sub):
    jb = jpr.param_to_bsdf({k: jnp.asarray(v) for k, v in mat.items()},
                           jnp.asarray(base), jnp.asarray(sub))
    tb = tpr.param_to_bsdf({k: torch.from_numpy(v) for k, v in mat.items()},
                           torch.from_numpy(base), torch.from_numpy(sub))
    return jb, tb


def test_param_to_bsdf_matches_jax():
    rng = np.random.default_rng(10)
    jb, tb = _both_bsdfs(*_materials(rng, N))
    for name, w, g in zip(jb._fields, jb, tb):
        if g.dtype == torch.bool:
            np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                          err_msg=name)
        else:
            _close(g, w)


def test_principled_eval_and_sample_match_jax():
    rng = np.random.default_rng(11)
    jb, tb = _both_bsdfs(*_materials(rng, N))
    wo = _dirs(rng, N)
    wi = _dirs(rng, N, upper=False)
    jf, jp = jpr.eval_bsdf(jnp.asarray(wi), jnp.asarray(wo), jb)
    tf, tp = tpr.eval_bsdf(torch.from_numpy(wi), torch.from_numpy(wo), tb)
    _close(tf, jf)
    _close(tp, jp)
    u = rng.random((3, N)).astype(np.float32)
    jw, jf, jp, js = jpr.sample_surface(jnp.asarray(wo), jb, *map(jnp.asarray, u))
    tw, tf, tp, ts = tpr.sample_surface(torch.from_numpy(wo), tb,
                                        *map(torch.from_numpy, u))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    _close(tw, jw, atol=1e-5, tail=True)
    for g, w in ((tf, jf), (tp, jp)):
        _close(g, w, tail=True)


@pytest.mark.parametrize("distrib", [1, 2])
def test_ggx_eval_and_sample_match_jax(distrib):
    rng = np.random.default_rng(12 + distrib)
    wo = _dirs(rng, N)
    wi = _dirs(rng, N)
    ax = rng.uniform(0.01, 1.0, N).astype(np.float32)
    ay = np.where(rng.random(N) < 0.5, ax,
                  rng.uniform(0.01, 1.0, N)).astype(np.float32)
    targs = [torch.from_numpy(x) for x in (wi, wo, ax, ay)]
    jargs = [jnp.asarray(x) for x in (wi, wo, ax, ay)]
    for g, w in zip(tggx.eval_pdf(*targs, distrib),
                    jggx.eval_pdf(*jargs, distrib)):
        _close(g, w)
    u = rng.random((2, N)).astype(np.float32)
    got = tggx.sample(targs[1], targs[2], targs[3],
                      *map(torch.from_numpy, u), distrib)
    want = jggx.sample(jargs[1], jargs[2], jargs[3], *map(jnp.asarray, u),
                       distrib)
    _close(got[0], want[0], atol=1e-5, tail=True)
    for g, w in zip(got[1:], want[1:]):
        _close(g, w, tail=True)


def test_ggx_matches_oracle():
    """Isotropic GTR2 eval/pdf and VNDF sample against the float64 oracle."""
    rng = np.random.default_rng(14)
    wo = _dirs(rng, N)
    wi = _dirs(rng, N)
    alpha = rng.uniform(0.05, 1.0, N).astype(np.float32)
    a = torch.from_numpy(alpha)
    f, pdf = tggx.eval_pdf(torch.from_numpy(wi), torch.from_numpy(wo), a, a, 2)
    of, opdf = oracle_ggx_eval_pdf(wi.astype(np.float64),
                                   wo.astype(np.float64), alpha)
    _close(f, of, rtol=1e-4, tail=True)
    _close(pdf, opdf, rtol=1e-4, tail=True)
    u = rng.random((2, N)).astype(np.float32)
    w, f, _ = tggx.sample(torch.from_numpy(wo), a, a,
                          *map(torch.from_numpy, u), 2)
    ow, ok = oracle_ggx_sample(wo.astype(np.float64), alpha.astype(np.float64),
                               u[0].astype(np.float64), u[1].astype(np.float64))
    np.testing.assert_array_equal(f.numpy() > 0, ok & (f.numpy() > 0))
    _close(w.numpy()[ok], ow[ok], rtol=1e-4, atol=1e-5, tail=True)


def test_principled_eval_matches_oracle():
    """Diffuse + GGX specular + SSS flags against the oracle's subset."""
    rng = np.random.default_rng(15)
    mat, base, sub = _materials(rng, N, full=False)
    _, tb = _both_bsdfs(mat, base, sub)
    mats = dict(mat, base_color=base, subsurface_color=sub)
    bs = oracle_setup({k: v.astype(np.float64) for k, v in mats.items()},
                      np.arange(N))
    np.testing.assert_array_equal(tb.enable_subsurface.numpy(), bs["enable_sss"])
    np.testing.assert_array_equal(tb.enable_diffuse.numpy(),
                                  bs["enable_diffuse"])
    wo = _dirs(rng, N)
    wi = _dirs(rng, N)
    f, pdf = tpr.eval_bsdf(torch.from_numpy(wi), torch.from_numpy(wo), tb)
    of, opdf = oracle_eval(wi.astype(np.float64), wo.astype(np.float64), bs)
    _close(f, of, rtol=1e-4, tail=True)
    _close(pdf, opdf, rtol=1e-4, tail=True)


def test_sss_matches_jax():
    rng = np.random.default_rng(16)
    weight = rng.random((N, 3)).astype(np.float32)
    albedo = rng.random((N, 3)).astype(np.float32)
    radius = rng.uniform(0, 1, (N, 3)).astype(np.float32)
    radius[:32] = 0.0
    tt = [torch.from_numpy(x) for x in (weight, albedo, radius)]
    jj = [jnp.asarray(x) for x in (weight, albedo, radius)]
    for g, w in zip(tsss.bssrdf_setup(*tt), jsss.bssrdf_setup(*jj)):
        _close(g, w)
    tco = tsss.scattering_coefficients(*tt)
    jco = jsss.scattering_coefficients(*jj)
    for g, w in zip(tco, jco):
        _close(g, w)
    u = rng.random((2, N)).astype(np.float32)
    dist, pdf = tsss.sample_scatter_distance(
        tt[0], tco[1], tco[0], *map(torch.from_numpy, u))
    jdist, jpdf = jsss.sample_scatter_distance(
        jj[0], jco[1], jco[0], *map(jnp.asarray, u))
    _close(dist, jdist)
    _close(pdf, jpdf)
