"""The port's exact enumeration (``enumerate_posterior``) and posterior
predictive sampling against the JAX package on the same models and keys:
the noisy-OR and categorical mixture posteriors (also against Bayes' rule
by hand), nested addresses, the MAP and marginal helpers, an SIR
cross-check and the guards; the predictive's draws, its layout
independence and its contract.

Tolerance: probabilities and log evidence to 1e-6 relative (one batched
``assess`` over the grid, f32, against the JAX package's vmapped one and
against float64 sums by hand); predictive draws to 1e-5 (normals agree
with JAX's to a few ulp); the SIR estimate within the JAX test's 0.05."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import genjax_torch as gt
import genjax_tpu as gj
from genjax_torch.core import random as R
from genjax_torch.inference import (
    ImportanceK,
    Target,
    enumerate_posterior,
    posterior_predictive,
)
from genjax_torch.interop import key_from_numpy
from genjax_tpu.inference import Target as JTarget
from genjax_tpu.inference import enumerate_posterior as jax_enumerate
from genjax_tpu.inference import posterior_predictive as jax_predictive

KEY = jax.random.key(99)


def _tkey(k):
    return key_from_numpy(np.asarray(jax.random.key_data(k)))


def _noisy_or(lib, xp):
    @lib.gen
    def noisy_or():
        a = lib.flip(0.3) @ "a"
        b = lib.flip(0.4) @ "b"
        p_sym = 0.05 + 0.9 * (a | b).astype(xp.float32) if xp is jnp \
            else 0.05 + 0.9 * (a | b).to(torch.float32)
        _ = lib.flip(p_sym) @ "sym"

    return noisy_or


def test_noisy_or_matches_jax_and_bayes():
    rt = enumerate_posterior(Target(_noisy_or(gt, torch), (),
                                    gt.C["sym"].set(True)))
    rj = jax_enumerate(JTarget(_noisy_or(gj, jnp), (),
                               gj.C["sym"].set(True)))
    joint = {}
    for a in (0, 1):
        for b in (0, 1):
            joint[(a, b)] = ((0.3 if a else 0.7) * (0.4 if b else 0.6)
                             * (0.05 + 0.9 * (1 if (a or b) else 0)))
    z = sum(joint.values())
    np.testing.assert_allclose(float(torch.exp(rt.log_marginal)), z,
                               rtol=1e-6)
    np.testing.assert_allclose(float(rt.log_marginal),
                               float(rj.log_marginal), rtol=1e-6)
    np.testing.assert_allclose(rt.log_probs.numpy(), np.asarray(rj.log_probs),
                               rtol=1e-6, atol=1e-6)
    assert rt.paths == rj.paths == (("a",), ("b",))
    sup, marg = rt.site_marginal("a")
    want_a1 = (joint[(1, 0)] + joint[(1, 1)]) / z
    np.testing.assert_allclose(
        float(marg[sup.tolist().index(True)]), want_a1, rtol=1e-6)


def test_categorical_mixture_assignment_matches_jax():
    mus = np.array([-2.0, 0.0, 3.0], np.float32)
    logits = np.log(np.array([0.5, 0.3, 0.2], np.float32))

    def make(lib, take):
        @lib.gen
        def mix():
            zc = lib.categorical(take(logits)) @ "z"
            _ = lib.normal(take(mus)[zc], 1.0) @ "y"

        return mix

    rj = jax_enumerate(JTarget(make(gj, jnp.asarray), (),
                               gj.C["y"].set(2.0)))
    rt = enumerate_posterior(Target(make(gt, torch.as_tensor), (),
                                    gt.C["y"].set(2.0)))
    sup, probs = rt.site_marginal("z")
    _, probs_j = rj.site_marginal("z")
    np.testing.assert_allclose(probs.numpy(), np.asarray(probs_j), rtol=1e-6)
    w = np.exp(logits) * np.exp(-0.5 * (2.0 - mus) ** 2)
    np.testing.assert_allclose(probs.numpy(), w / w.sum(), rtol=1e-5)
    assert int(rt.map_assignment()[("z",)]) == 2


def test_nested_addresses_and_sir_cross_check():
    @gt.gen
    def inner():
        return gt.flip(0.5) @ "c"

    @gt.gen
    def outer():
        a = inner() @ "in"
        _ = gt.flip(torch.where(a, 0.9, 0.1)) @ "obs"

    res = enumerate_posterior(Target(outer, (), gt.C["obs"].set(True)))
    assert res.paths == (("in", "c"),)
    sup, probs = res.site_marginal("in", "c")
    np.testing.assert_allclose(float(probs[sup.tolist().index(True)]), 0.9,
                               rtol=1e-6)

    bs = torch.tensor([0.1, 0.4, 0.6, 0.9])

    @gt.gen
    def m():
        zc = gt.categorical(torch.zeros(4)) @ "z"
        b = gt.flip(bs[zc]) @ "b"
        _ = gt.flip(torch.where(b, 0.8, 0.2)) @ "y"

    target = Target(m, (), gt.C["y"].set(True))
    exact = float(enumerate_posterior(target).log_marginal)
    col = ImportanceK(target, k_particles=4096).run_smc(R.key(5))
    assert abs(float(col.get_log_marginal_likelihood_estimate())
               - exact) < 0.05


def test_guards():
    @gt.gen
    def continuous():
        x = gt.normal(0.0, 1.0) @ "x"
        _ = gt.flip(torch.sigmoid(x)) @ "y"

    with pytest.raises(ValueError, match="not finite-support"):
        enumerate_posterior(Target(continuous, (), gt.C["y"].set(True)))

    @gt.gen
    def wide():
        for i in range(6):
            _ = gt.categorical(torch.zeros(10)) @ f"z{i}"
        _ = gt.flip(0.5) @ "y"

    with pytest.raises(ValueError, match="max_states"):
        enumerate_posterior(Target(wide, (), gt.C["y"].set(True)),
                            max_states=1000)

    @gt.gen
    def only_observed():
        _ = gt.flip(0.5) @ "y"

    with pytest.raises(ValueError, match="no unconstrained"):
        enumerate_posterior(Target(only_observed, (), gt.C["y"].set(True)))


def _predictive_model(lib):
    @lib.gen
    def model():
        mu = lib.normal(0.0, 1.0) @ "mu"
        _ = lib.normal(mu, 0.5) @ "y"

    return model


def test_posterior_predictive_matches_jax_and_is_layout_independent():
    mus = np.linspace(-1.0, 1.0, 24).astype(np.float32).reshape(4, 6)
    tj = JTarget(_predictive_model(gj), (), gj.C["y"].set(1.0))
    tt_ = Target(_predictive_model(gt), (), gt.C["y"].set(1.0))
    chs_j, _ = jax_predictive(tj, gj.C["mu"].set(jnp.asarray(mus)), KEY)
    chs, _ = posterior_predictive(tt_, gt.C["mu"].set(torch.as_tensor(mus)),
                                  _tkey(KEY))
    assert chs["y"].shape == (4, 6)
    np.testing.assert_allclose(chs["y"].numpy(), np.asarray(chs_j["y"]),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(chs["mu"].numpy(), mus)
    chs2, _ = posterior_predictive(
        tt_, gt.C["mu"].set(torch.as_tensor(mus.reshape(2, 12))), _tkey(KEY))
    np.testing.assert_array_equal(chs["y"].numpy().ravel(),
                                  chs2["y"].numpy().ravel())
    one, _ = posterior_predictive(
        tt_, gt.C["mu"].set(torch.as_tensor(mus.ravel())), _tkey(KEY),
        sample_ndims=1)
    np.testing.assert_array_equal(one["y"].numpy(), chs["y"].numpy().ravel())


def test_posterior_predictive_contract():
    tt_ = Target(_predictive_model(gt), (), gt.C["y"].set(1.0))
    draws = (gt.C["mu"].set(torch.zeros(4, 6))
             | gt.C["z"].set(torch.zeros(3, 6)))
    with pytest.raises(ValueError, match="leading sample axes"):
        posterior_predictive(tt_, draws, R.key(0))
    with pytest.raises(ValueError, match="no choices"):
        posterior_predictive(tt_, gt.ChoiceMap.empty(), R.key(0))
