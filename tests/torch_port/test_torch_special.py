"""The port's special functions (``genjax_torch/lang/distributions/
special.py``) and the long-tail distributions built on them
(``beta_quotient``, ``lambert_w_normal``, ``power_spherical``,
``von_mises_fisher``) against the JAX package on the CPU (mirrors
tests/lang/test_distributions_tail.py).

Tolerance: ``lambertw`` within 1e-5 relative of the JAX package's on
the JAX tests' grids, ``log_bessel_iv`` within 1e-4 of the JAX
package's relative to max(1, |value|) (as the log-densities that use it:
near x = 0 the log is itself near 0), ``hyp2f1`` within 1e-4 of
``jax.scipy.special.hyp2f1`` relative to max(1, |value|)
over every branch of its case analysis (NaN and inf where JAX has
them); the densities' normalisation and the samplers' moments as the
JAX tests hold them, with 5 standard errors of 4096 draws (2^14 for the
Lambert W normal's median) where they draw."""

import jax
import jax.numpy as jnp
import jax.scipy.special as jsp
import numpy as np
import pytest
import scipy.special as sps
import torch

import genjax_torch as gt
from genjax_torch.interop import key_from_numpy
from genjax_torch.lang.distributions import special as TS
from genjax_tpu.lang.distributions import special as JS

KEY = jax.random.key(314159)


def _keys(n):
    return key_from_numpy(np.asarray(jax.random.key_data(
        jax.random.split(KEY, n))))


def _trapezoid(y, x):
    return float(np.trapezoid(np.asarray(y, np.float64), np.asarray(x)))


@pytest.mark.parametrize("xs", [
    [0.0, 0.1, 1.0, 5.0, 100.0, 1e4],
    list(np.linspace(0.01, 50.0, 20)),
    [-0.3, -0.1, 1e-6, 2.718281828, 3.0, 1e6],
], ids=["inverts", "scipy-grid", "edges"])
def test_lambertw_matches_jax(xs):
    x = np.asarray(xs, np.float32)
    want = np.asarray(JS.lambertw(jnp.asarray(x)))
    got = TS.lambertw(torch.tensor(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)
    pos = x >= 0
    np.testing.assert_allclose(got[pos], np.real(sps.lambertw(x[pos])),
                               rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("v", [0.0, 0.5, 1.0, 2.5, 10.0])
def test_log_bessel_iv_matches_jax(v):
    x = np.asarray([0.1, 1.0, 5.0, 19.0, 21.0, 30.0, 200.0], np.float32)
    want = np.asarray(JS.log_bessel_iv(v, jnp.asarray(x)), np.float64)
    got = TS.log_bessel_iv(v, torch.tensor(x)).numpy()
    assert (np.abs(got - want) <= 1e-4 * np.maximum(1.0, np.abs(want))).all()
    if v > 0:  # the JAX tests' scipy oracle (their 2e-3)
        np.testing.assert_allclose(got, np.log(sps.ive(v, x)) + x, rtol=2e-3)


def test_log_bessel_iv_per_element_order():
    """A tensor of orders, one an element, as a vmap of the JAX
    function over (v, x) pairs gives it."""
    v = np.asarray([0.5, 1.0, 2.5, 10.0], np.float32)
    x = np.asarray([1.0, 30.0, 5.0, 200.0], np.float32)
    want = np.asarray(jax.vmap(JS.log_bessel_iv)(jnp.asarray(v),
                                                 jnp.asarray(x)))
    got = TS.log_bessel_iv(torch.tensor(v), torch.tensor(x)).numpy()
    assert (np.abs(got - want) <= 1e-4 * np.maximum(1.0, np.abs(want))).all()


#: (a, b, c) of each branch of 2F1's case analysis, at x on both sides
#: of 0.9 and at 1: the series, the terminating series, the digamma
#: transform (c - a - b an integer), the Euler transform (c - a - b <=
#: -1), b = c, a = c, a or b = 0, and c a non-positive integer.
HYP_ABC = [(6.0, -2.0, 9.0), (4.0, -1.0, 6.0), (2.5, 0.3, 4.0),
           (1.5, -0.5, 3.0), (2.0, 3.0, 5.0), (2.0, 1.0, 6.0),
           (3.0, 1.0, 2.0), (1.0, 2.0, 3.5), (0.5, 0.5, 1.5),
           (2.0, 2.0, 3.0), (1.0, 1.0, 2.0), (0.0, 1.0, 2.0),
           (1.0, 1.0, 1.0), (2.0, 3.0, -2.0), (7.0, 1.5, 4.0)]
HYP_X = [0.0, 0.1, 0.5, 0.89, 0.91, 0.95, 0.99, 1.0, 1.2, -0.5]


@pytest.mark.parametrize("abc", HYP_ABC, ids=str)
def test_hyp2f1_matches_jax(abc):
    x = np.asarray(HYP_X, np.float32)
    a, b, c = (np.full_like(x, p) for p in abc)
    want = np.asarray(jsp.hyp2f1(a, b, c, x), np.float64)
    got = TS.hyp2f1(*(torch.tensor(t) for t in (a, b, c, x))).numpy()
    got = got.astype(np.float64)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    err = np.abs(got[fin] - want[fin]) / np.maximum(1.0, np.abs(want[fin]))
    assert err.max(initial=0.0) <= 1e-4, (got, want)


class TestBetaQuotient:
    def test_normalizes(self):
        grid = np.concatenate([np.linspace(1e-4, 5.0, 20001),
                               np.linspace(5.0, 60.0, 2000)[1:]])
        lp = gt.beta_quotient.logpdf(torch.tensor(grid, dtype=torch.float32),
                                     2.0, 3.0, 4.0, 3.0)
        assert abs(_trapezoid(np.exp(lp.numpy()), grid) - 1.0) <= 2e-2

    def test_histogram_matches_density(self):
        xs = gt.beta_quotient.sample(_keys(4096), 2.0, 3.0, 4.0,
                                     3.0).numpy()
        for t in [0.25, 0.5, 1.0, 2.0]:
            grid = np.linspace(1e-4, t, 4001)
            lp = gt.beta_quotient.logpdf(
                torch.tensor(grid, dtype=torch.float32), 2.0, 3.0, 4.0, 3.0)
            cdf = _trapezoid(np.exp(lp.numpy()), grid)
            se = np.sqrt(cdf * (1 - cdf) / len(xs))
            assert abs(cdf - np.mean(xs <= t)) <= 5 * se + 1e-3, t


class TestLambertWNormal:
    def test_reduces_to_normal_at_zero_tail(self):
        lp = float(gt.lambert_w_normal.logpdf(0.7, 0.0, 1.0, 1e-8))
        want = float(jax.scipy.stats.norm.logpdf(0.7))
        assert abs(lp - want) <= 1e-4

    def test_normalizes(self):
        grid = np.linspace(-60.0, 60.0, 200001)
        lp = gt.lambert_w_normal.logpdf(
            torch.tensor(grid, dtype=torch.float32), 0.5, 1.5, 0.2)
        assert abs(_trapezoid(np.exp(lp.numpy()), grid) - 1.0) <= 1e-2

    def test_sample_median(self):
        ys = gt.lambert_w_normal.sample(_keys(1 << 14), 0.0, 1.0,
                                        0.3).numpy()
        # The transform is sign-symmetric: P(y <= 0) = 1/2.
        assert abs(np.mean(ys <= 0.0) - 0.5) <= 5 * np.sqrt(0.25 / len(ys))


class TestPowerSpherical:
    def test_unit_norm_and_mean_direction(self):
        mu = torch.tensor([0.0, 0.0, 1.0])
        xs = gt.power_spherical.sample(_keys(4096), mu, 10.0).numpy()
        np.testing.assert_allclose(np.linalg.norm(xs, axis=1), 1.0,
                                   atol=1e-5)
        mean_dir = xs.mean(0) / np.linalg.norm(xs.mean(0))
        assert mean_dir @ mu.numpy() > 0.99

    def test_normalizes_on_circle(self):
        thetas = np.linspace(-np.pi, np.pi, 20001)
        xs = np.stack([np.cos(thetas), np.sin(thetas)], -1).astype(np.float32)
        lp = gt.power_spherical.logpdf(torch.tensor(xs),
                                       torch.tensor([1.0, 0.0]), 3.0)
        assert abs(_trapezoid(np.exp(lp.numpy()), thetas) - 1.0) <= 1e-3

    def test_marginal_t_matches_beta(self):
        """mu.x ~ 2 Beta(alpha, beta) - 1 by construction."""
        mu = torch.tensor([1.0, 0.0, 0.0])
        xs = gt.power_spherical.sample(_keys(4096), mu, 4.0).numpy()
        alpha, beta_ = 5.0, 1.0
        want = 2 * alpha / (alpha + beta_) - 1
        var = 4 * alpha * beta_ / ((alpha + beta_) ** 2 * (alpha + beta_ + 1))
        assert abs(xs[:, 0].mean() - want) <= 5 * np.sqrt(var / len(xs))


class TestVonMisesFisher:
    def test_unit_norm_and_concentration(self):
        mu = torch.tensor([0.0, 1.0, 0.0])
        xs = gt.von_mises_fisher.sample(_keys(4096), mu, 5.0).numpy()
        np.testing.assert_allclose(np.linalg.norm(xs, axis=1), 1.0,
                                   atol=1e-5)
        k = 5.0  # E[mu.x] = coth(k) - 1/k for d = 3
        t = xs @ mu.numpy()
        want = 1.0 / np.tanh(k) - 1.0 / k
        assert abs(t.mean() - want) <= 5 * t.std() / np.sqrt(len(t))

    def test_logpdf_normalizes_d3(self):
        t = np.linspace(-1.0, 1.0, 20001)
        x = np.stack([np.sqrt(1 - t * t), np.zeros_like(t), t],
                     -1).astype(np.float32)
        lp = gt.von_mises_fisher.logpdf(torch.tensor(x),
                                        torch.tensor([0.0, 0.0, 1.0]), 2.0)
        assert abs(_trapezoid(np.exp(lp.numpy()), t) * 2 * np.pi - 1.0) <= 5e-3

    def test_sampler_matches_density_histogram(self):
        xs = gt.von_mises_fisher.sample(
            _keys(4096), torch.tensor([0.0, 0.0, 1.0]), 3.0).numpy()
        k, t = 3.0, xs[:, 2]
        for thr in [-0.5, 0.0, 0.5]:
            want = (np.exp(k * thr) - np.exp(-k)) / (2 * np.sinh(k))
            se = np.sqrt(want * (1 - want) / len(t))
            assert abs(np.mean(t <= thr) - want) <= 5 * se, thr
