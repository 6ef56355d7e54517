"""The port's SVGD (``genjax_torch/inference/svgd.py``) against the JAX
package's on the same inputs: the matrix-form direction (with the
bandwidth's median of an even count, the mean of the two middle values
as ``jnp.median`` takes it, and the strided subsample's rows), a whole
fit of config 10 at small size from the same key data, and the JAX
package's own checks (moment recovery, transforms, the discrete-site
guard)."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import genjax_torch as gt
import genjax_tpu as gj
from genjax_torch import entry
from genjax_torch.core import random
from genjax_torch.inference import Target, run_svgd
from genjax_torch.inference.svgd import _median, _rbf_phi, svgd_step
from genjax_torch.interop import key_from_numpy, params_from_numpy
from genjax_tpu.inference import Target as JTarget
from genjax_tpu.inference import run_svgd as j_run_svgd
from genjax_tpu.inference.svgd import _rbf_phi as j_rbf_phi

KEY = jax.random.key(2718)


def _tkey(k):
    return key_from_numpy(np.asarray(jax.random.key_data(k)))


def _close(got, want, **kw):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), **kw)


def _inputs(n, d, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, d)).astype(np.float32),
            rng.standard_normal((n, d)).astype(np.float32))


class TestPhi:
    @pytest.mark.parametrize("n,d,h_rows", [(32, 3, None), (33, 3, None),
                                            (1024, 4, 128), (1000, 4, 64)])
    def test_phi_matches_reference(self, n, d, h_rows):
        xs, grads = _inputs(n, d, n)
        want = j_rbf_phi(jnp.asarray(xs), jnp.asarray(grads), h_rows)
        got = _rbf_phi(torch.tensor(xs), torch.tensor(grads), h_rows)
        _close(got, want, rtol=2e-4, atol=2e-5)

    def test_median_of_even_count_averages(self):
        x = np.array([4.0, 1.0, 3.0, 2.0], np.float32)
        assert float(_median(torch.tensor(x))) == float(jnp.median(x)) == 2.5
        y = np.random.default_rng(0).standard_normal((64, 64)).astype(
            np.float32)
        assert float(_median(torch.tensor(y))) == float(jnp.median(y))

    def test_matrix_phi_matches_pairwise_oracle(self):
        xs, grads = _inputs(32, 3, 7)
        x64, g64 = xs.astype(np.float64), grads.astype(np.float64)
        d2 = ((x64[:, None] - x64[None]) ** 2).sum(-1)
        h = max(np.median(d2) / math.log(33.0), 1e-6)
        k = np.exp(-d2 / h)
        oracle = (k @ g64 + (2.0 / h) * (k.sum(0)[:, None] * x64
                                         - k @ x64)) / 32
        got = _rbf_phi(torch.tensor(xs), torch.tensor(grads))
        _close(got, oracle, rtol=2e-4, atol=1e-5)

    def test_gaussian_moment_recovery(self):
        cov = torch.tensor([[1.0, 0.6], [0.6, 2.0]])
        prec = torch.linalg.inv(cov)
        mu = torch.tensor([1.5, -0.5])

        def logp(z):
            d = z - mu
            return -0.5 * ((d @ prec) * d).sum(-1)

        xs = torch.tensor(_inputs(256, 2, 3)[0])
        for _ in range(600):
            xs = svgd_step(logp, xs, 0.2)
        _close(xs.mean(0), mu, atol=0.1)
        _close(torch.cov(xs.T), cov, atol=0.3)

    def test_clustered_ordering_robust(self):
        rng = np.random.default_rng(31)
        xs = np.concatenate([-5.0 + 0.01 * rng.standard_normal((512, 2)),
                             5.0 + 0.01 * rng.standard_normal((512, 2))])
        xs = torch.tensor(xs, dtype=torch.float32)
        grads = torch.zeros_like(xs)
        m_exact = float(_rbf_phi(xs, grads, None).abs().mean())
        m_sub = float(_rbf_phi(xs, grads, 64).abs().mean())
        assert m_sub > 0.5 * m_exact


def _blr_jax(b, d):
    kx = jax.random.key(10)
    x = jax.random.normal(kx, (b, d)) / jnp.sqrt(float(d))
    y = x @ jnp.linspace(-1.0, 1.0, d) + 0.25 * jax.random.normal(
        jax.random.key(11), (b,))

    @gj.gen
    def blr(X):
        w = gj.mv_normal_diag(jnp.zeros(d), jnp.ones(d)) @ "w"
        _ = gj.mv_normal_diag(X @ w, 0.25 * jnp.ones(b)) @ "y"

    return JTarget(blr, (x,), gj.C["y"].set(y)), x, y


class TestConfig10Small:
    B, D, N = 32, 4, 32

    def test_data_matches_reference(self):
        _, xj, yj = _blr_jax(self.B, self.D)
        x, y = entry.blr_data(self.B, self.D, "cpu")
        _close(x, xj, rtol=1e-5, atol=1e-6)
        _close(y, yj, rtol=1e-5, atol=1e-5)

    def test_fit_matches_reference(self):
        jtarget, _, _ = _blr_jax(self.B, self.D)
        want = jax.jit(lambda k: j_run_svgd(
            jtarget, k, n_particles=self.N, n_steps=10, step_size=0.05,
            h_rows=8)["w"])(jax.random.key(12))
        run, target, exact = entry.build_svgd(self.N, 10, self.B, self.D,
                                              h_rows=8, device="cpu")
        got = run(_tkey(jax.random.key(12)))
        _close(got, want, rtol=1e-4, atol=1e-4)

    def test_fit_reaches_conjugate_mean(self):
        run, _, exact = entry.build_svgd(64, 200, self.B, self.D, h_rows=16,
                                         device="cpu")
        w = run(random.key(12))
        assert np.abs(w.mean(0).numpy() - exact["mean"]).max() < 0.05


class TestRunSVGD:
    def test_conjugate_normal_posterior(self):
        @gt.gen
        def model():
            mu = gt.normal(0.0, 1.0) @ "mu"
            _ = gt.normal(mu, 0.5) @ "y"

        target = Target(model, (), gt.C["y"].set(1.0))
        mus = run_svgd(target, _tkey(KEY), n_particles=256, n_steps=400,
                       step_size=0.1)["mu"].numpy()
        assert mus.shape == (256,)
        assert abs(mus.mean() - 0.8) < 0.06
        assert abs(mus.std() - math.sqrt(0.2)) < 0.06

    def test_auto_transforms_positive_support(self):
        @gt.gen
        def model():
            sigma = gt.gamma(3.0, 3.0) @ "sigma"
            _ = gt.normal(0.0, sigma) @ "y"

        target = Target(model, (), gt.C["y"].set(0.5))
        sig = run_svgd(target, _tkey(KEY), n_particles=128, n_steps=300,
                       step_size=0.05, transforms="auto")["sigma"].numpy()
        assert (sig > 0).all() and 0.3 < sig.mean() < 1.0

    def test_unconstrained_discrete_site_raises(self):
        @gt.gen
        def model():
            z = gt.flip(0.3) @ "z"
            _ = gt.normal(torch.where(z, 1.0, -1.0), 0.5) @ "y"

        target = Target(model, (), gt.C["y"].set(0.8))
        with pytest.raises(ValueError, match="discrete|flip"):
            run_svgd(target, _tkey(KEY), n_particles=8, n_steps=1)

    def test_constrained_discrete_site_is_fine(self):
        @gt.gen
        def model():
            z = gt.flip(0.3) @ "z"
            mu = gt.normal(0.0, 1.0) @ "mu"
            _ = gt.normal(mu + torch.where(z, 1.0, 0.0), 0.5) @ "y"

        target = Target(model, (), gt.C["y"].set(0.8) | gt.C["z"].set(True))
        chm = run_svgd(target, _tkey(KEY), n_particles=32, n_steps=50)
        assert torch.isfinite(chm["mu"]).all()

    def test_params_from_numpy_carries_an_ensemble(self):
        ens = {"w": np.ones((4, 3), np.float32), "beta": np.float32(0.5)}
        got = params_from_numpy(ens)
        assert got["w"].dtype == torch.float32 and got["w"].shape == (4, 3)
        assert float(got["beta"]) == 0.5
