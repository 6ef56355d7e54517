"""The port's MH, chain runners and tempered SMC samplers against the JAX
package and the conjugate closed form (mirroring
tests/inference/test_smc_sampler.py without its HMC cases), and bench
config 6 at a small size.

MH and AIS make no resampling step, so on the same key data their
acceptances and weights equal the JAX package's: weights and values to
1e-4 (the normals agree to a few ulp, accumulated over the moves), the
acceptances exactly. The resampling samplers may take a neighbouring
ancestor where the two packages' CDFs round a boundary apart, so they
are held to the closed form and to the JAX package within Monte Carlo
error, each bound stated where it is used."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.stats import norm

import genjax_torch as gt
import genjax_tpu as gj
from genjax_torch import entry as E
from genjax_torch.core import random as R
from genjax_torch.inference import (
    Target,
    annealed_importance_sampling,
    chain,
    mh,
    multi_chain,
    tempered_smc,
    waste_free_tempered_smc,
)
from genjax_torch.interop import key_from_numpy
from genjax_tpu.inference import Target as JaxTarget
from genjax_tpu.inference import mcmc as jax_mcmc
from genjax_tpu.inference import smc_sampler as jax_sampler

KEY = jax.random.key(314159)


def _tkey(k):
    return key_from_numpy(np.asarray(jax.random.key_data(k)))


def _conjugate(lib):
    @lib.gen
    def conjugate(obs_std):
        mu = lib.normal(0.0, 1.0) @ "mu"
        _ = lib.normal(mu, obs_std) @ "y"

    return conjugate


def _targets(y=1.0, obs_std=0.5):
    return (JaxTarget(_conjugate(gj), (obs_std,), gj.C["y"].set(y)),
            Target(_conjugate(gt), (obs_std,), gt.C["y"].set(y)))


def exact_logz(y=1.0, obs_std=0.5):
    return norm(0.0, np.sqrt(1 + obs_std ** 2)).logpdf(y)


# -- MH ----------------------------------------------------------------------------


def test_mh_and_chain_match_jax():
    tj, tt = _targets()
    trj, _ = tj.p.generate(KEY, tj.constraint, tj.args)
    trt, _ = tt.p.generate(_tkey(KEY), tt.constraint, tt.args)
    k = jax.random.key(2)
    nj, aj = mh(_tkey(k), trt, gt.Regenerate(gt.S.at["mu"]))
    rj, accj = jax_mcmc.mh(k, trj, gj.Regenerate(gj.S.at["mu"]))
    assert bool(nj is not None) and bool(aj) == bool(accj)
    np.testing.assert_allclose(float(nj.get_choices()["mu"]),
                               float(rj.get_choices()["mu"]), rtol=1e-4,
                               atol=1e-5)

    def kern_t(key, tr):
        return mh(key, tr, gt.Regenerate(gt.S.at["mu"]))

    def kern_j(key, tr):
        return jax_mcmc.mh(key, tr, gj.Regenerate(gj.S.at["mu"]))

    ft, acc_t = chain(kern_t)(_tkey(k), trt, n_steps=30, burn_in=5)
    fj, acc_j = jax.jit(lambda key, tr: jax_mcmc.chain(kern_j)(
        key, tr, n_steps=30, burn_in=5))(k, trj)
    assert acc_t.shape == (25,)
    assert np.array_equal(acc_t.numpy(), np.asarray(acc_j))
    np.testing.assert_allclose(float(ft.get_choices()["mu"]),
                               float(fj.get_choices()["mu"]), rtol=1e-4,
                               atol=1e-5)


def test_multi_chain_matches_jax_and_the_posterior():
    """256 chains of 40 MH steps: each chain's final state equals the JAX
    package's, and the chains' mean is within 5 standard errors of the
    posterior mean 0.8 (posterior sd 0.447)."""
    tj, tt = _targets()

    def kern_t(key, tr):
        return mh(key, tr, gt.Regenerate(gt.S.at["mu"]))

    def kern_j(key, tr):
        return jax_mcmc.mh(key, tr, gj.Regenerate(gj.S.at["mu"]))

    def init_t(keys):
        return tt.p.generate(keys, tt.constraint, tt.args)[0]

    def init_j(key):
        return tj.p.generate(key, tj.constraint, tj.args)[0]

    n = 256
    ft, acc_t = multi_chain(kern_t, n)(_tkey(KEY), init_t, n_steps=40)
    fj, acc_j = jax.jit(lambda key: jax_mcmc.multi_chain(kern_j, n)(
        key, init_j, n_steps=40))(KEY)
    mus_t = ft.get_choices()["mu"].numpy()
    mus_j = np.asarray(fj.get_choices()["mu"])
    assert acc_t.shape == (n, 40)
    # Equal decisions except where alpha sits within 1e-5 of log u.
    assert (acc_t.numpy() == np.asarray(acc_j)).mean() > 0.999
    assert (np.abs(mus_t - mus_j) < 1e-4).mean() > 0.99
    assert abs(mus_t.mean() - 0.8) < 5 * 0.447 / math.sqrt(n)


def test_mh_raises_on_a_structure_change():
    from genjax_torch.inference.mcmc import select_accept

    a = {"x": torch.zeros(3)}
    with pytest.raises(ValueError, match="structure"):
        select_accept(torch.ones(3, dtype=torch.bool), {"y": torch.ones(3)},
                      a)


# -- tempered samplers -------------------------------------------------------------


def test_tempered_logz_and_acceptance():
    tj, tt = _targets()
    rt = tempered_smc(tt, 2048, n_temps=20, n_moves=2)(_tkey(KEY))
    rj = jax.jit(jax_sampler.tempered_smc(tj, 2048, n_temps=20,
                                          n_moves=2))(KEY)
    # The JAX test's bound against the closed form; one run's sd is
    # about 0.02, so the two packages agree within 0.05 as well.
    assert abs(float(rt.log_z) - exact_logz()) < 0.05
    assert abs(float(rt.log_z) - float(rj.log_z)) < 0.05
    assert float(rt.accept_rate[0]) > 0.5
    assert float(rt.accept_rate.mean()) > 0.2
    mus = rt.traces.get_choices()["mu"]
    w = torch.softmax(rt.log_weights, 0)
    assert abs(float((w * mus).sum()) - 0.8) < 0.05
    sd = float(torch.sqrt((w * (mus - (w * mus).sum()) ** 2).sum()))
    assert abs(sd - math.sqrt(0.2)) < 0.05


def test_waste_free_logz_and_posterior():
    tj, tt = _targets()
    rt = waste_free_tempered_smc(tt, 128, 8, n_temps=15)(_tkey(KEY))
    rj = jax.jit(jax_sampler.waste_free_tempered_smc(
        tj, n_resampled=128, n_moves_per_particle=8, n_temps=15))(KEY)
    mus = rt.traces.get_choices()["mu"]
    assert mus.shape == (1024,)
    assert abs(float(rt.log_z) - exact_logz()) < 0.08
    assert abs(float(rt.log_z) - float(rj.log_z)) < 0.08
    w = torch.softmax(rt.log_weights, 0)
    assert abs(float((w * mus).sum()) - 0.8) < 0.05


def test_ais_matches_jax_and_the_evidence():
    """No resampling: weights equal the JAX package's to 1e-4, and log Z
    is within 0.05 of the conjugate evidence (the JAX test's bound)."""
    tj, tt = _targets()
    k = jax.random.key(4)
    rt = annealed_importance_sampling(tt, 512, n_temps=16, n_moves=2)(
        _tkey(k))
    rj = jax.jit(jax_sampler.annealed_importance_sampling(
        tj, 512, n_temps=16, n_moves=2))(k)
    np.testing.assert_allclose(rt.log_weights.numpy(),
                               np.asarray(rj.log_weights), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(float(rt.log_z), float(rj.log_z), atol=1e-4)
    assert np.array_equal(rt.accept_rate.numpy(), np.asarray(rj.accept_rate))
    assert abs(float(rt.log_z) - exact_logz()) < 0.05
    lw = rt.log_weights.double()
    ess = float(torch.exp(2 * torch.logsumexp(lw, 0)
                          - torch.logsumexp(2 * lw, 0)))
    assert ess > 64


def test_zero_threshold_is_ais_and_never_resamples(monkeypatch):
    _, tt = _targets(y=0.3)
    a = annealed_importance_sampling(tt, 64, n_temps=6)(R.key(5))
    b = tempered_smc(tt, 64, n_temps=6, ess_threshold=0.0)(R.key(5))
    assert torch.equal(a.log_z, b.log_z)
    assert torch.equal(a.log_weights, b.log_weights)
    import genjax_torch.inference.smc_sampler as sampler

    def boom(*_, **__):
        raise AssertionError("resampled")

    monkeypatch.setattr(sampler, "resample_tree", boom)
    annealed_importance_sampling(tt, 64, n_temps=6)(R.key(5))
    with pytest.raises(AssertionError, match="resampled"):
        tempered_smc(tt, 64, n_temps=6, ess_threshold=1.0)(R.key(5))


def test_config6_small_matches_jax():
    """Bench config 6 at 4096 particles x 8 rungs x 2 moves: its data
    equals the JAX benchmark's (uniforms bitwise, normals to a few ulp),
    the observations stay one zero-stride view through the run, and log
    Z sits within 0.1 of the closed form and of the JAX package's run on
    the same key (one run's sd is about 0.03 here)."""
    n_obs = 64
    ys_j = 1.5 + 0.7 * jax.random.normal(jax.random.key(0), (n_obs,))
    ys_t = E.tempered_observations(n_obs, device="cpu")
    np.testing.assert_allclose(ys_t.numpy(), np.asarray(ys_j), rtol=1e-6,
                               atol=1e-6)

    @gj.gen
    def model(sigma):
        mu = gj.normal(0.0, 3.0) @ "mu"
        _ = gj.mv_normal_diag(mu * jnp.ones(n_obs),
                              sigma * jnp.ones(n_obs)) @ "ys"

    run_j = jax.jit(jax_sampler.tempered_smc(
        JaxTarget(model, (0.8,), gj.C["ys"].set(ys_j)), 4096, n_temps=8,
        n_moves=2))
    run_t, exact = E.build_tempered_smc(4096, 8, 2, device="cpu")
    k = jax.random.key(1)
    rt, rj = run_t(_tkey(k)), run_j(k)
    ys = rt.traces.get_choices()["ys"]
    assert ys.shape == (4096, n_obs) and ys.stride(0) == 0
    assert abs(float(rt.log_z) - exact) < 0.1
    assert abs(float(rt.log_z) - float(rj.log_z)) < 0.1
    assert 0.0 < float(rt.accept_rate.mean()) < 1.0
