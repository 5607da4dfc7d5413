"""Hair of the port against the JAX package and the numpy oracle: the
Principled Hair BSDF (shading/hair.py) and the CyHair / Catmull-Rom IO
(io/cyhair.py).

BSDF: the same float32 formulas on the same seeded numpy inputs as
pbrlab_tpu.shading.hair. The closure parameters are elementwise algebra
plus one log: rtol 1e-5. eval and sample chain exp, log, atan2, asin and
a ratio of logistic CDFs, which torch and XLA:CPU may each round an ulp
apart; near a grazing direction (cos ~ 0) or a steep Mp (roughness 0.05,
variance ~3e-3) that ulp grows. So f*cos, pdf and omega_in are held to
rtol 1e-4 (atol 1e-6) on 99.5% of values and rtol 1e-2 on all of them.
Against the float64 oracle (tests/oracle_hair.py, a transcription of the
reference C++, not of either package) the band is float32 rounding of the
same chain: rtol 1e-3 on 99% of values. The Monte Carlo checks of
tests/test_hair.py:88-115 run on the port with the same seeds and bounds.

IO: numpy on both sides, so every array must be equal exactly.
"""
import struct

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oracle_hair
from pbrlab_tpu.io import cyhair as jcyhair
from pbrlab_tpu.shading import hair as jhair
from pbrlab_tpu_torch.io import cyhair as tcyhair
from pbrlab_tpu_torch.shading import hair as thair

N = 4096
H_VALUES = (-0.9, -0.3, 0.0, 0.5, 0.95)


def _materials(rng, n, coloring):
    """Per-lane hair parameters (HairBsdfParameter columns)."""
    f = lambda lo, hi, *shape: rng.uniform(  # noqa: E731
        lo, hi, (n,) + shape).astype(np.float32)
    return {
        "hair_coloring": np.full(n, coloring, np.int32),
        "hair_base_color": f(0.02, 0.95, 3),
        "melanin": f(0.0, 1.0),
        "melanin_redness": f(0.0, 1.0),
        "hair_roughness": f(0.05, 0.9),
        "azimuthal_roughness": f(0.05, 0.9),
        "hair_ior": f(1.3, 1.8),
        "shift": f(-5.0, 5.0),
        "hair_specular_tint": f(0.5, 1.0, 3),
        "second_specular_tint": f(0.5, 1.0, 3),
        "transmission_tint": f(0.5, 1.0, 3),
    }


def _dirs(rng, n):
    d = rng.normal(size=(n, 3))
    return (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)


def _bsdfs(mat, h):
    """(JAX closure, port closure) of the same numpy parameters."""
    jb = jhair.param_to_bsdf({k: jnp.asarray(v) for k, v in mat.items()},
                             jnp.asarray(h))
    tb = thair.param_to_bsdf({k: torch.from_numpy(v) for k, v in mat.items()},
                             torch.from_numpy(h))
    return jb, tb


def _close(got, want, rtol=1e-4, atol=1e-6):
    """rtol on 99.5% of values, rtol 1e-2 on all (module docstring)."""
    got, want = got.numpy(), np.asarray(want)
    assert np.isfinite(got).all()
    assert np.isclose(got, want, rtol=rtol, atol=atol).mean() >= 0.995
    np.testing.assert_allclose(got, want, rtol=1e-2, atol=atol)


def _lanes(coloring, seed):
    rng = np.random.default_rng(seed)
    mat = _materials(rng, N, coloring)
    h = rng.choice(np.asarray(H_VALUES, np.float32), N)
    return rng, mat, h


@pytest.mark.parametrize("coloring", [0, 1], ids=["rgb", "melanin"])
def test_param_to_bsdf_matches_jax(coloring):
    _, mat, h = _lanes(coloring, 20 + coloring)
    jb, tb = _bsdfs(mat, h)
    for name, g, w in zip(jb._fields, tb, jb):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-7, err_msg=name)


@pytest.mark.parametrize("coloring", [0, 1], ids=["rgb", "melanin"])
def test_eval_cos_pdf_matches_jax(coloring):
    rng, mat, h = _lanes(coloring, 30 + coloring)
    jb, tb = _bsdfs(mat, h)
    wi, wo = _dirs(rng, N), _dirs(rng, N)
    want = jhair.eval_cos_pdf(jnp.asarray(wi), jnp.asarray(wo), jb)
    got = thair.eval_cos_pdf(torch.from_numpy(wi), torch.from_numpy(wo), tb)
    assert float(np.asarray(want[1]).min()) >= 0.0
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("coloring", [0, 1], ids=["rgb", "melanin"])
def test_sample_matches_jax(coloring):
    rng, mat, h = _lanes(coloring, 40 + coloring)
    jb, tb = _bsdfs(mat, h)
    wo = _dirs(rng, N)
    u = rng.random((4, N), dtype=np.float32)
    want = jhair.sample(jnp.asarray(wo), jb, *map(jnp.asarray, u))
    got = thair.sample(torch.from_numpy(wo), tb, *map(torch.from_numpy, u))
    _close(got[0], want[0], atol=1e-5)  # omega_in
    for g, w in zip(got[1:], want[1:]):
        _close(g, w)
    # every lobe is drawn
    lobe = np.searchsorted(np.array([0.25, 0.5, 0.75]), u[0])
    assert len(np.unique(lobe)) == 4


@pytest.mark.parametrize("seed", [50, 51, 52])
def test_eval_matches_oracle(seed):
    """RGB coloring against the float64 transcription of the reference,
    one random material (the oracle takes one) over N lanes."""
    rng, mat, h = _lanes(0, seed)
    mat = {k: np.broadcast_to(v[:1], v.shape).copy() for k, v in mat.items()}
    _, tb = _bsdfs(mat, h)
    wi, wo = _dirs(rng, N), _dirs(rng, N)
    got = thair.eval_cos_pdf(torch.from_numpy(wi), torch.from_numpy(wo), tb)
    names = {"base_color": "hair_base_color",
             "azimuthal_roughness": "azimuthal_roughness",
             "roughness": "hair_roughness", "ior": "hair_ior",
             "shift": "shift", "specular_tint": "hair_specular_tint",
             "transmission_tint": "transmission_tint",
             "second_specular_tint": "second_specular_tint"}
    om = {k: mat[v][0].astype(np.float64) for k, v in names.items()}
    want = oracle_hair.hair_eval(wi.astype(np.float64), wo.astype(np.float64),
                                 oracle_hair.HairBsdfO(om, h.astype(np.float64)))
    for g, w in zip(got, want):
        assert np.isclose(g.numpy(), w, rtol=1e-3, atol=1e-6).mean() >= 0.99


def _default_bsdf(n, h):
    """tests/test_hair.py's default melanin hair."""
    mat = {
        "hair_coloring": torch.ones((n,), dtype=torch.int32),
        "hair_base_color": torch.tensor([0.18, 0.06, 0.02]).expand(n, 3),
        "melanin": torch.full((n,), 0.5),
        "melanin_redness": torch.full((n,), 0.8),
        "hair_roughness": torch.full((n,), 0.2),
        "azimuthal_roughness": torch.full((n,), 0.3),
        "hair_ior": torch.full((n,), 1.55),
        "shift": torch.full((n,), 2.0),
        "hair_specular_tint": torch.ones((n, 3)),
        "second_specular_tint": torch.ones((n, 3)),
        "transmission_tint": torch.ones((n, 3)),
    }
    return thair.param_to_bsdf(mat, torch.full((n,), h))


def _sphere(rng, n):
    return torch.from_numpy(_dirs(rng, n))


def test_eval_sample_pdf_consistency():
    """sample() returns the f and pdf that eval gives at the sampled
    direction (tests/test_hair.py:65-85)."""
    n = 512
    g = np.random.default_rng(5)
    b = _default_bsdf(n, 0.3)
    wo = _sphere(g, n)
    us = torch.from_numpy(g.random((4, n), dtype=np.float32))
    wi, f_s, pdf_s = thair.sample(wo, b, *us)
    f_e, pdf_e = thair.eval_cos_pdf(wi, wo, b)
    ok = pdf_s > 1e-6
    np.testing.assert_allclose(pdf_e[ok], pdf_s[ok], rtol=2e-2)
    np.testing.assert_allclose(f_e[ok], f_s[ok], rtol=2e-2, atol=1e-5)
    assert torch.isfinite(f_s).all() and (pdf_s >= 0).all()
    np.testing.assert_allclose(torch.linalg.norm(wi[ok], dim=1), 1.0,
                               atol=1e-4)


def test_pdf_integrates_to_one():
    """MC estimate of the sphere integral of the pdf (tests/test_hair.py
    :88-100): within 0.1 of 1."""
    n = 1 << 15
    g = np.random.default_rng(6)
    b = _default_bsdf(n, 0.2)
    wo = torch.tensor([0.3, 0.5, np.sqrt(1 - 0.09 - 0.25)],
                      dtype=torch.float32).expand(n, 3)
    _, pdf = thair.eval_cos_pdf(_sphere(g, n), wo, b)
    est = float(pdf.mean()) * 4.0 * np.pi
    assert abs(est - 1.0) < 0.1, f"pdf integral {est}"


def test_energy_conservation():
    """The sphere integral of f*cos is <= 1.05 per channel
    (tests/test_hair.py:103-114)."""
    n = 1 << 15
    g = np.random.default_rng(7)
    b = _default_bsdf(n, 0.1)
    wo = torch.tensor([0.1, 0.6, np.sqrt(1 - 0.01 - 0.36)],
                      dtype=torch.float32).expand(n, 3)
    f_cos, _ = thair.eval_cos_pdf(_sphere(g, n), wo, b)
    integral = f_cos.mean(dim=0).numpy() * 4.0 * np.pi
    assert (integral <= 1.05).all(), f"energy {integral}"


def _write_cyhair(path, flags, colors=True):
    """A 3-strand CyHair file: 5, 4 and 2 points (the last too short to
    convert), thickness and transparency and color blocks per `flags`."""
    g = np.random.default_rng(9)
    counts = (5, 4, 2)
    pts = sum(counts)
    header = b"HAIR" + struct.pack("<IIIIff", len(counts), pts, flags, 3,
                                   0.01, 1.0)
    header += struct.pack("<fff", 0.5, 0.5, 0.5)
    header += b"\0" * (128 - len(header))
    with open(path, "wb") as f:
        f.write(header)
        if flags & 0x1:
            f.write(struct.pack("<HHH", *(c - 1 for c in counts)))
        f.write(g.random((pts, 3)).astype(np.float32).tobytes())
        if flags & 0x4:
            f.write(g.uniform(0.01, 0.03, pts).astype(np.float32).tobytes())
        if flags & 0x8:
            f.write(g.random(pts).astype(np.float32).tobytes())
        if colors:
            f.write(g.random((pts, 3)).astype(np.float32).tobytes())


@pytest.mark.parametrize("flags", [0x1 | 0x2 | 0x4 | 0x8 | 0x10,
                                   0x1 | 0x2 | 0x4, 0x2 | 0x10],
                         ids=["all-blocks", "no-color", "default-segments"])
def test_cyhair_matches_jax(tmp_path, flags):
    path = str(tmp_path / "t.hair")
    _write_cyhair(path, flags, colors=bool(flags & 0x10))
    for y_up in (True, False):
        got = tcyhair.load_cyhair(path, y_up=y_up, with_colors=True)
        want = jcyhair.load_cyhair(path, y_up=y_up, with_colors=True)
        for g_list, w_list in zip(got, want):
            if w_list is None:
                assert g_list is None
                continue
            assert len(g_list) == len(w_list)
            for g, w in zip(g_list, w_list):
                np.testing.assert_array_equal(g, w)
    if flags & 0x1:  # the default segment count gives one 4-point strand
        got = tcyhair.load_cyhair_as_bezier(path)
        want = jcyhair.load_cyhair_as_bezier(path)
        np.testing.assert_array_equal(got.vertices_thickness,
                                      want.vertices_thickness)
        np.testing.assert_array_equal(got.indices, want.indices)
        if want.segment_colors is None:
            assert got.segment_colors is None
        else:
            np.testing.assert_array_equal(got.segment_colors,
                                          want.segment_colors)


@pytest.mark.parametrize("points", [3, 4, 5, 9])
def test_catmullrom_and_demo_hair_match_jax(points):
    g = np.random.default_rng(points)
    cv = g.random((points, 3)).astype(np.float32)
    r = g.uniform(0.01, 0.02, points).astype(np.float32)
    np.testing.assert_array_equal(
        tcyhair._catmullrom_to_bezier_strand(cv, r),
        jcyhair._catmullrom_to_bezier_strand(cv, r))
    got = tcyhair.make_demo_hair(num_strands=3 * points, points_per_strand=
                                 points, seed=points)
    want = jcyhair.make_demo_hair(num_strands=3 * points,
                                  points_per_strand=points, seed=points)
    np.testing.assert_array_equal(got.vertices_thickness,
                                  want.vertices_thickness)
    np.testing.assert_array_equal(got.indices, want.indices)
    np.testing.assert_array_equal(got.segment_points(), want.segment_points())
