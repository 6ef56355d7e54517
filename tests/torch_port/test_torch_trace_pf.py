"""The trace-level particle filter and data-annealed SMC against the JAX
package on the same key data, and against their exact oracles (the
Kalman log-likelihood, the beta-bernoulli closed form).

Until the first resample every weight is an edit weight of the same
draws, so it agrees with the JAX package's to 1e-5; with resampling off
a whole run does. After a resample the two packages' offspring counts
may part at an f32 tie (the JAX package's CPU path sums its CDF in
XLA's order), so a resampled run is held to the oracle within a bound
derived from the filter's spread, stated where it is used. The coins
model draws ``p`` from a beta, which the port draws by its own rejection
loop, so that model is held to its closed form only."""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import genjax_torch as gt
import genjax_tpu as gj
from genjax_torch import entry as E
from genjax_torch.core import random as R
from genjax_torch.inference import data_annealed_smc, trace_particle_filter
from genjax_torch.interop import key_from_numpy
from genjax_torch.models import kalman_filter, lgssm_model
from genjax_tpu.inference.data_smc import data_annealed_smc as jax_dsmc
from genjax_tpu.inference.trace_pf import trace_particle_filter as jax_tpf
from genjax_tpu.models import lgssm_model as jax_lgssm

A, Q, R_, T = 0.9, 0.5, 0.3, 8
YS = np.asarray([0.2, -0.1, 0.4, 0.0, 0.3, 0.1, -0.2, 0.5], np.float32)


def _tkey(k):
    return key_from_numpy(np.asarray(jax.random.key_data(k)))


def _exact(ys=YS, a=A, q=Q, r=R_):
    ll, _ = kalman_filter(torch.tensor(ys).double(), a, q, r, mu0=0.0,
                          p0=0.0)
    return float(ll)


@pytest.mark.parametrize("refresh", [False, True])
def test_trace_pf_without_resampling_matches_jax(refresh):
    """ESS threshold 0: no resample, so every weight and log Z equal the
    JAX package's to 1e-5 on the same key (the refresh never runs)."""
    k = jax.random.key(3)
    want = jax.jit(jax_tpf(jax_lgssm(A, Q, R_, T), (0.0, None), "y",
                           jnp.asarray(YS), 64, ess_threshold=0.0,
                           refresh_future=refresh))(k)
    got = trace_particle_filter(lgssm_model(A, Q, R_, T), (0.0, None), "y",
                                torch.tensor(YS), 64, ess_threshold=0.0,
                                refresh_future=refresh)(_tkey(k))
    assert got.n_resamples == 0
    np.testing.assert_allclose(got.log_weights.numpy(),
                               np.asarray(want.log_weights),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(got.log_z), float(want.log_z),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.ess_history.numpy(),
                               np.asarray(want.ess_history), rtol=1e-4)
    xs = got.traces.get_choices()[:, "x"]
    assert xs.shape == (64, T)


def test_trace_pf_matches_jax_up_to_the_first_resample():
    """With resampling, the ESS history agrees with the JAX package's
    up to and including the step of the first resample, and the final
    log Z of the two runs (2048 particles, 8 steps) agree within 0.25:
    at this size one run's spread is ~0.08 (refresh on, the JAX package's
    8-key spread scaled), so 0.25 is 3 sd of a difference."""
    k = jax.random.key(4)
    want = jax.jit(jax_tpf(jax_lgssm(A, Q, R_, T), (0.0, None), "y",
                           jnp.asarray(YS), 2048, refresh_future=True))(k)
    got = trace_particle_filter(lgssm_model(A, Q, R_, T), (0.0, None), "y",
                                torch.tensor(YS), 2048,
                                refresh_future=True)(_tkey(k))
    ej, et = np.asarray(want.ess_history), got.ess_history.numpy()
    first = int(np.argmax(ej < 1024))
    np.testing.assert_allclose(et[:first + 1], ej[:first + 1], rtol=1e-4)
    assert got.n_resamples >= 1
    assert abs(float(got.log_z) - float(want.log_z)) < 0.25
    assert abs(float(got.log_z) - _exact()) < 0.25


def test_build_trace_pf_on_the_cpu():
    """``build_trace_pf`` at 2048 particles over config 7's first 12
    steps, futures refreshed: log Z within 0.5 of the Kalman
    log-likelihood (the JAX package's spread over 8 keys at 2048 × 50 is
    0.17, tools/jax_spread.py; shorter runs spread less), and the final
    latents' weighted mean near the filtered mean."""
    run, exact, ys = E.build_trace_pf(2048, n_steps=12, device="cpu")
    res = run(R.key(2))
    assert abs(float(res.log_z) - exact) < 0.5
    assert res.n_resamples == int((res.ess_history < 1024).sum())
    w = torch.softmax(res.log_weights, 0)
    x_last = res.traces.get_choices()[:, "x"][:, -1]
    _, mus = kalman_filter(ys.double(), 0.7, 0.4, 0.4, mu0=0.0, p0=0.0)
    assert abs(float((w * x_last).sum()) - float(mus[-1])) < 0.1


def _gauss(lib, n):
    @lib.gen
    def gauss():
        mu = lib.normal(0.0, 1.0) @ "mu"
        for i in range(n):
            _ = lib.normal(mu, 0.8) @ f"y{i}"

    return gauss


OBS = [0.4, 1.1, 0.7, -0.2, 0.9]


def test_data_smc_without_resampling_matches_jax():
    """A Gaussian model, one observation a step, no resample: the weights,
    log Z and the MH acceptances of a Regenerate move equal the JAX
    package's on the same key."""
    sched_j = [gj.C[f"y{i}"].set(v) for i, v in enumerate(OBS)]
    sched_t = [gt.C[f"y{i}"].set(v) for i, v in enumerate(OBS)]
    k = jax.random.key(8)
    want = jax.jit(jax_dsmc(_gauss(gj, 5), (), sched_j, 128,
                            make_request=lambda: gj.Regenerate(
                                gj.S.at["mu"]), n_moves=2,
                            ess_threshold=0.0))(k)
    got = data_annealed_smc(_gauss(gt, 5), (), sched_t, 128,
                            make_request=lambda: gt.Regenerate(
                                gt.Selection.at["mu"]), n_moves=2,
                            ess_threshold=0.0)(_tkey(k))
    np.testing.assert_allclose(got.log_weights.numpy(),
                               np.asarray(want.log_weights),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(got.log_z), float(want.log_z),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.accept_rate.numpy(),
                               np.asarray(want.accept_rate), atol=1e-6)
    np.testing.assert_allclose(got.traces.get_choices()["mu"].numpy(),
                               np.asarray(want.traces.get_choices()["mu"]),
                               rtol=1e-5, atol=1e-5)


def test_build_data_smc_on_the_cpu():
    """``build_data_smc`` on the coins model at 2048 particles and 5
    flips with two Regenerate moves of p a step (the JAX package's coins
    test): log Z within 0.05 of the beta-bernoulli evidence, the
    posterior mean within 0.03, acceptance above 0.1, and one resample
    for each step whose ESS fell below half."""
    obs = E.coins_observations(5)
    run, exact = E.build_data_smc(2048, 5, n_moves=2, device="cpu")
    res = run(R.key(2))
    assert abs(float(res.log_z) - exact) < 0.05
    w = torch.softmax(res.log_weights, 0)
    want = (2 + sum(obs)) / (4 + len(obs))
    assert abs(float((w * res.traces.get_choices()["p"]).sum()) - want) < 0.03
    assert float(res.accept_rate.mean()) > 0.1
    assert res.n_resamples == int((res.ess_history < 1024).sum())
