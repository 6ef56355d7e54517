"""``split_rhat``, ``ess_autocorr`` and ``summarize`` against the JAX
package on the same numpy chains: iid, AR(1) and a multi-parameter
batch, to 1e-5 relative. The port caps the ESS at ``c·n·log10(c·n)``
(Stan's cap; the JAX package has none): an antithetic chain, where the
cap binds, gets the cap, and the iid and AR(1) chains, where it does
not, get the JAX package's value."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genjax_torch.inference import diagnostics as td
from genjax_tpu.inference import diagnostics as jd

RTOL = 1e-5


def _iid(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _ar1(c, n, rho, seed=1):
    rng = np.random.default_rng(seed)
    x = np.zeros((c, n), np.float32)
    e = rng.standard_normal((c, n)).astype(np.float32)
    for t in range(1, n):
        x[:, t] = rho * x[:, t - 1] + e[:, t]
    return x


CHAINS = {
    "iid": _iid((4, 400)),
    "iid_params": _iid((3, 300, 2, 3), seed=2),
    "ar1": _ar1(4, 600, 0.8),
    "ar1_short": _ar1(2, 60, 0.5, seed=3),
}


@pytest.mark.parametrize("name", sorted(CHAINS))
def test_split_rhat_matches_jax(name):
    x = CHAINS[name]
    np.testing.assert_allclose(td.split_rhat(torch.tensor(x)).numpy(),
                               np.asarray(jd.split_rhat(jnp.asarray(x))),
                               rtol=RTOL)


@pytest.mark.parametrize("name", sorted(CHAINS))
def test_ess_matches_jax_where_the_cap_does_not_bind(name):
    x = CHAINS[name]
    got = td.ess_autocorr(torch.tensor(x)).numpy()
    ref = np.asarray(jd.ess_autocorr(jnp.asarray(x)))
    c, n = x.shape[:2]
    assert np.all(ref < c * n * math.log10(c * n))
    np.testing.assert_allclose(got, ref, rtol=RTOL)


def test_ess_oracles():
    """iid chains give ESS ≈ c·n, AR(1) ≈ c·n·(1−ρ)/(1+ρ)."""
    c, n = 4, 2000
    iid = td.ess_autocorr(torch.tensor(_iid((c, n), seed=5))).item()
    assert 0.8 * c * n < iid < 1.2 * c * n
    ar = td.ess_autocorr(torch.tensor(_ar1(c, n, 0.8, seed=6))).item()
    want = c * n * 0.2 / 1.8
    assert 0.6 * want < ar < 1.4 * want


def test_ess_cap_binds_on_antithetic_chains():
    """Alternating chains make τ near 0: the JAX package reports up to
    (c·n)², the port Stan's cap."""
    rng = np.random.default_rng(4)
    x = np.tile(np.array([1.0, -1.0], np.float32), (2, 50))
    x += 0.01 * rng.standard_normal(x.shape).astype(np.float32)
    c, n = x.shape
    cap = c * n * math.log10(c * n)
    ref = float(jd.ess_autocorr(jnp.asarray(x)))
    got = float(td.ess_autocorr(torch.tensor(x)))
    assert ref > cap
    assert got == pytest.approx(cap, rel=RTOL)


def test_ess_few_draws_and_chunked_lags():
    """n <= 2 treats draws as independent; more lags than one chunk give
    the same values as the JAX package's chunked loop."""
    x = _iid((3, 2))
    np.testing.assert_allclose(td.ess_autocorr(torch.tensor(x)).numpy(),
                               np.asarray(jd.ess_autocorr(jnp.asarray(x))))
    y = _ar1(2, 300, 0.3, seed=7)
    for lag in (5, 64, 65, 200):
        np.testing.assert_allclose(
            td.ess_autocorr(torch.tensor(y), max_lag=lag).numpy(),
            np.asarray(jd.ess_autocorr(jnp.asarray(y), max_lag=lag)),
            rtol=RTOL)


def test_summarize_matches_jax():
    x = CHAINS["iid_params"]
    got = td.summarize(torch.tensor(x))
    ref = jd.summarize(jnp.asarray(x))
    for k in ("mean", "std", "rhat", "ess"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   rtol=RTOL, atol=1e-6)
