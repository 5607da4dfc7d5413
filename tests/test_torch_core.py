"""pbrlab_tpu_torch.core against pbrlab_tpu.core on the same numpy inputs.

The PCG streams must be bit-exact: the port's images are only comparable
with the JAX package's because every lane draws the same numbers. The
float helpers compare at rtol 1e-6: the same float32 formulas, but sums
and transcendentals may round differently between XLA:CPU and torch.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pbrlab_tpu.core import onb as jonb
from pbrlab_tpu.core import rng as jrng
from pbrlab_tpu.core import sampling as jsampling
from pbrlab_tpu_torch.core import onb as tonb
from pbrlab_tpu_torch.core import rng as trng
from pbrlab_tpu_torch.core import sampling as tsampling


def _t(x):
    return torch.as_tensor(np.asarray(x))


def test_pcg_bit_exact():
    """seed_state + 52 draws over 120k lanes (pixel ids past 2^31, sample
    ids and seeds that overflow 32-bit products): identical u32 states and
    identical float32 draws."""
    n = 120_000
    rng = np.random.default_rng(3)
    pix = rng.integers(0, 2**32, size=n, dtype=np.uint64).astype(np.uint32)
    pix[:4] = [0, 1, 2**31, 2**32 - 1]
    for sample, seed in [(0, 0), (7, 12345), (2**32 - 1, 2**32 - 3)]:
        js = jrng.seed_state(jnp.asarray(pix), jnp.uint32(sample),
                             jnp.uint32(seed))
        ts = trng.seed_state(_t(pix.astype(np.int64)), sample, seed)
        np.testing.assert_array_equal(ts.numpy().astype(np.uint32),
                                      np.asarray(js))
        for _ in range(52):
            js, ju = jrng.draw(js)
            ts, tu = trng.draw(ts)
            np.testing.assert_array_equal(ts.numpy().astype(np.uint32),
                                          np.asarray(js))
            np.testing.assert_array_equal(tu.numpy(), np.asarray(ju))
        assert ts.dtype == torch.int64 and int(ts.max()) < 2**32


def test_pcg_state_f32_roundtrip():
    """The packed carry bit-casts the u32 state to float32 (NaN patterns
    included) and moves it through cat and row gathers: bits survive."""
    rng = np.random.default_rng(4)
    s = _t(rng.integers(0, 2**32, size=10_000, dtype=np.uint64)
           .astype(np.int64))
    s[:2] = torch.tensor([0x7FC00001, 0xFFFFFFFF])  # NaN bit patterns
    f = trng.state_to_f32(s)
    assert f.dtype == torch.float32
    packed = torch.cat([f[:, None], torch.ones_like(f)[:, None]], dim=1)
    perm = torch.randperm(s.shape[0])
    assert torch.equal(trng.state_from_f32(packed[perm][:, 0]), s[perm])


@pytest.mark.parametrize("name", ["cosine_sample_hemisphere",
                                  "uniform_sample_sphere",
                                  "power_heuristic_weight",
                                  "triangle_uniform_sample"])
def test_sampling_matches_jax(name):
    rng = np.random.default_rng(5)
    a = rng.random(4096).astype(np.float32)
    b = rng.random(4096).astype(np.float32)
    if name == "power_heuristic_weight":
        a[:64] = 0.0
        b[32:96] = 0.0
        b[200:300] = a[200:300]  # exact ties -> 0.5
    want = getattr(jsampling, name)(jnp.asarray(a), jnp.asarray(b))
    got = getattr(tsampling, name)(_t(a), _t(b))
    if isinstance(want, tuple):
        for w, g in zip(want, got):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                       atol=1e-7)
    else:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-7)


def test_sample_cdf_matches_jax():
    rng = np.random.default_rng(6)
    cdf = np.cumsum(rng.random(7)).astype(np.float32)
    cdf /= cdf[-1]
    u = rng.random(5000).astype(np.float32)
    u[:7] = cdf  # exact boundaries: lower_bound picks that entry
    want = jsampling.sample_cdf(jnp.asarray(cdf), jnp.asarray(u))
    got = tsampling.sample_cdf(_t(cdf), _t(u))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_onb_matches_jax():
    rng = np.random.default_rng(8)
    n = rng.normal(size=(4096, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    n[:3] = [[0, 0, 1], [0, 0, -1], [1, 0, 0]]
    v = rng.normal(size=(4096, 3)).astype(np.float32)
    jex, jey = jonb.branchless_onb(jnp.asarray(n))
    tex, tey = tonb.branchless_onb(_t(n))
    for w, g in ((jex, tex), (jey, tey)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-7)
    jl = jonb.to_local(jnp.asarray(v), jex, jey, jnp.asarray(n))
    tl = tonb.to_local(_t(v), tex, tey, _t(n))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-6,
                               atol=1e-6)
    jg = jonb.to_global(jl, jex, jey, jnp.asarray(n))
    tg = tonb.to_global(tl, tex, tey, _t(n))
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-6,
                               atol=1e-6)
