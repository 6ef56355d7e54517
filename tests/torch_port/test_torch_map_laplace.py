"""The port's MAP optimization and Laplace approximation
(``genjax_torch/inference/map_laplace.py``) against the JAX package's.

The default optimizer is the port's functional ``adam``, held to
``optax.adam`` update by update; a fit of config 10's regression at
small size from the same key data follows the JAX package's trajectory.
For a Gaussian posterior the Laplace approximation is exact: the mean,
covariance and evidence are held to the closed form."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from scipy import stats as sps
from scipy.special import betaln

import genjax_torch as gt
import genjax_tpu as gj
from genjax_torch import entry
from genjax_torch.core import random
from genjax_torch.inference import Target
from genjax_torch.inference.map_laplace import (
    adam,
    laplace_approximation,
    map_optimize,
)
from genjax_torch.interop import key_from_numpy
from genjax_tpu.inference import Target as JTarget
from genjax_tpu.inference.map_laplace import map_optimize as j_map_optimize

KEY = jax.random.key(314159)


def _tkey(k):
    return key_from_numpy(np.asarray(jax.random.key_data(k)))


def _close(got, want, **kw):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), **kw)


@gt.gen
def conjugate_normal(obs_std):
    mu = gt.normal(0.0, 1.0) @ "mu"
    return gt.normal(mu, obs_std) @ "y"


class TestAgainstReference:
    def test_adam_is_optax_adam(self):
        rng = np.random.default_rng(0)
        grads = rng.standard_normal((20, 5)).astype(np.float32)
        params = np.zeros(5, np.float32)
        jopt, topt = optax.adam(1e-2), adam(1e-2)
        js, ts = jopt.init(jnp.asarray(params)), topt.init(torch.tensor(params))
        jp, tp = jnp.asarray(params), torch.tensor(params)
        for g in grads:
            ju, js = jopt.update(jnp.asarray(g), js, jp)
            tu, ts = topt.update(torch.tensor(g), ts, tp)
            jp, tp = optax.apply_updates(jp, ju), tp + tu
            _close(tu, ju, rtol=1e-5, atol=1e-8)
        _close(tp, jp, rtol=1e-5, atol=1e-7)

    def test_config10_fit_matches_reference(self):
        b, d = 32, 4
        kx = jax.random.key(10)
        x = jax.random.normal(kx, (b, d)) / jnp.sqrt(float(d))
        y = x @ jnp.linspace(-1.0, 1.0, d) + 0.25 * jax.random.normal(
            jax.random.key(11), (b,))

        @gj.gen
        def blr(X):
            w = gj.mv_normal_diag(jnp.zeros(d), jnp.ones(d)) @ "w"
            _ = gj.mv_normal_diag(X @ w, 0.25 * jnp.ones(b)) @ "y"

        jres = jax.jit(lambda k: j_map_optimize(
            k, JTarget(blr, (x,), gj.C["y"].set(y)), n_steps=50,
            include_jacobian=True))(KEY)
        tx, ty = entry.blr_data(b, d, "cpu")
        tres = map_optimize(_tkey(KEY), Target(entry.blr_model(b, d), (tx,),
                                               gt.C["y"].set(ty)),
                            n_steps=50, include_jacobian=True)
        _close(tres.losses, jres.losses, rtol=1e-4, atol=1e-3)
        _close(tres.choices["w"], jres.choices["w"], rtol=1e-4, atol=1e-4)
        _close(tres.score, jres.score, rtol=1e-4, atol=1e-3)


class TestGaussianExact:
    def _target(self, y=1.0, obs_std=0.5):
        return Target(conjugate_normal, (obs_std,), gt.C["y"].set(y))

    def test_map_is_posterior_mean(self):
        res = map_optimize(_tkey(KEY), self._target(), n_steps=800)
        assert abs(float(res.choices["mu"]) - 1.0 / 1.25) < 1e-3
        assert float(res.losses[-1]) <= float(res.losses[0])

    def test_laplace_exact_cov_and_evidence(self):
        tgt = self._target(1.0, 0.5)
        res = map_optimize(_tkey(KEY), tgt, n_steps=800)
        lap = laplace_approximation(tgt, res.choices)
        assert abs(float(lap.cov[0, 0]) - 0.25 / 1.25) < 1e-3
        want = sps.norm.logpdf(1.0, 0.0, math.sqrt(1.25))
        assert abs(float(lap.log_z) - want) < 1e-3

    def test_key_batch_restarts(self):
        res = map_optimize(random.split(_tkey(KEY), 8), self._target(),
                           n_steps=1000)
        assert res.choices["mu"].shape == (8,)
        _close(res.choices["mu"], np.full(8, 0.8), atol=5e-3)
        assert res.losses.shape == (8, 1000)

    def test_config10_builder_exact(self):
        run, exact = entry.build_map_laplace(64, 8, 1000, device="cpu")
        res, lap = run(random.key(0))
        _close(res.choices["w"], exact["mean"], atol=1e-3)
        _close(lap.cov, exact["cov"], atol=1e-5)
        assert abs(float(lap.log_z) - exact["log_z"]) < 1e-2


class TestConstrainedSupports:
    @staticmethod
    def _bb(n, vals):
        @gt.gen
        def bb():
            p = gt.beta(3.0, 2.0) @ "p"
            for i in range(n):
                _ = gt.flip(p) @ f"y{i}"
            return p

        obs = gt.C["y0"].set(vals[0])
        for i in range(1, n):
            obs = obs | gt.C[f"y{i}"].set(vals[i])
        return Target(bb, (), obs)

    def test_beta_bernoulli_auto_transforms(self):
        tgt = self._bb(4, [True, True, False, True])
        res = map_optimize(_tkey(KEY), tgt, n_steps=1200, transforms="auto")
        assert abs(float(res.choices["p"]) - 5.0 / 7.0) < 2e-3

    def test_laplace_evidence_beta_bernoulli(self):
        vals = [True, True, False, True, True, False]
        tgt = self._bb(6, vals)
        res = map_optimize(_tkey(KEY), tgt, n_steps=1500, transforms="auto",
                           include_jacobian=True)
        lap = laplace_approximation(tgt, res.choices,
                                    transforms=res.transforms)
        k = sum(vals)
        want = betaln(3.0 + k, 2.0 + 6 - k) - betaln(3.0, 2.0)
        assert abs(float(lap.log_z) - want) < 5e-2


class TestDiagnostics:
    def test_non_mode_point_poisons_log_z(self):
        @gt.gen
        def bimodal():
            x = gt.normal(0.0, 10.0) @ "x"
            _ = gt.normal(x * x, 0.5) @ "y"

        tgt = Target(bimodal, (), gt.C["y"].set(4.0))
        lap = laplace_approximation(tgt, gt.C["x"].set(torch.tensor(0.0)))
        assert bool(torch.isnan(lap.log_z))

    def test_uncovered_latent_raises(self):
        @gt.gen
        def two_latents():
            a = gt.normal(0.0, 1.0) @ "a"
            b = gt.normal(a, 1.0) @ "b"
            _ = gt.normal(b, 0.5) @ "y"

        tgt = Target(two_latents, (), gt.C["y"].set(1.0))
        with pytest.raises(ValueError, match="does not cover"):
            laplace_approximation(tgt, gt.C["a"].set(torch.tensor(0.5)))
        lap = laplace_approximation(tgt, gt.C["a"].set(torch.tensor(0.5)),
                                    key=random.key(7))
        assert lap.cov.shape == (2, 2)
