"""``DiscreteHMM`` with per-execution observations and configurations
against ``jax.vmap`` of the JAX package's functions on the CPU (its
log-space product takes the plain form there, ``ops/logmatmul.py``):
both filters, the two backward samplers, the distribution's draws and
scores, FFBS against exact smoothing, and ``exact_testbed`` on a key
batch. A batch is also held against its problems one by one.

Tolerances: the filters to 2e-5 relative and absolute (the JAX
package's own bound between its two filters, as in
``test_torch_discrete_hmm.py``); the alphas compared only where the
filtering probability exceeds e^-80 (the parallel filter's floor in both
packages); paths drawn on shared keys exactly; a batch against its
problems exactly (draws) and to 1e-6 (scores); FFBS smoothing marginals
within 5 standard errors of the exact forward-backward ones, in the cells
that expect at least 10 draws either way."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.special import logsumexp

from genjax_torch.core import random as R
from genjax_torch.core.scan import associative_scan, count_combines
from genjax_torch.inference.exact_testbed import sample_problem
from genjax_torch.interop import hmm_config_from_numpy, key_from_numpy
from genjax_torch.lang.distributions import (
    DiscreteHMM,
    DiscreteHMMConfiguration,
    discrete_hmm,
)
from genjax_torch.lang.distributions.discrete_hmm import (
    backward_sample,
    backward_sample_parallel,
    forward_filter,
    forward_filter_parallel,
    joint_logpdf,
)
from genjax_torch.ops import logmatmul

jhmm = importlib.import_module("genjax_tpu.lang.distributions.discrete_hmm")
jtb = importlib.import_module("genjax_tpu.inference.exact_testbed")

TOL = dict(rtol=2e-5, atol=2e-5)
B, S, T = 4, 6, 9


def _tkey(k):
    return key_from_numpy(np.asarray(jax.random.key_data(k)))


def _variances():
    return jnp.asarray([0.4, 0.9, 1.7, 3.0], jnp.float32)


def _jax_problems(per_config: bool):
    """``B`` problems from ``jax.vmap`` of ``sample_problem``: circulant
    structure, each problem its own observations and, with
    ``per_config``, its own transition variance."""
    keys = jax.random.split(jax.random.key(3), B)
    if per_config:
        cfgs = jax.vmap(lambda v: jhmm.DiscreteHMMConfiguration.circulant(
            S, S, transition_variance=v))(_variances())
        probs = jax.vmap(lambda k, c: jtb.sample_problem(k, c, T))(keys, cfgs)
    else:
        cfg = jhmm.DiscreteHMMConfiguration.circulant(S, S)
        cfgs = jax.tree_util.tree_map(
            lambda v: jnp.broadcast_to(v, (B,) + v.shape), cfg)
        probs = jax.vmap(lambda k: jtb.sample_problem(k, cfg, T))(keys)
    return keys, cfgs, probs


def _port(cfgs, probs):
    cfg = hmm_config_from_numpy(cfgs.prior_logits, cfgs.transition_logits,
                                cfgs.observation_logits)
    return cfg, torch.tensor(np.asarray(probs.observations))


def _live(alphas):
    a = np.asarray(alphas, np.float64)
    return (a - logsumexp(a, axis=-1, keepdims=True)) > -80.0


@pytest.mark.parametrize("per_config", [False, True],
                         ids=["obs", "obs_and_config"])
@pytest.mark.parametrize("parallel", [False, True])
def test_filters_match_jax_vmap(per_config, parallel):
    _, cfgs, probs = _jax_problems(per_config)
    cfg, obs = _port(cfgs, probs)
    jfn = jhmm.forward_filter_parallel if parallel else jhmm.forward_filter
    tfn = forward_filter_parallel if parallel else forward_filter
    a_ref, m_ref = jax.jit(jax.vmap(jfn))(cfgs, probs.observations)
    alphas, logm = tfn(cfg, obs)
    assert alphas.shape == (B, T, S) and logm.shape == (B,)
    live = _live(a_ref)
    np.testing.assert_allclose(alphas.numpy()[live], np.asarray(a_ref)[live],
                               **TOL)
    np.testing.assert_allclose(logm.numpy(), np.asarray(m_ref), **TOL)
    # Each problem's filter is its own filter's bits.
    for p in range(B):
        one = DiscreteHMMConfiguration(cfg.prior_logits[p],
                                       cfg.transition_logits[p],
                                       cfg.observation_logits[p])
        a1, m1 = tfn(one, obs[p])
        assert torch.equal(alphas[p], a1) and torch.equal(logm[p], m1)


def test_parallel_filter_is_one_product_per_level():
    """The batched parallel filter calls the log-space product
    ``count_combines(T - 1)`` times, each on every problem's pairs."""
    _, cfgs, probs = _jax_problems(True)
    cfg, obs = _port(cfgs, probs)
    calls = []
    orig = logmatmul.log_matmul_plain

    def spy(x, y):
        calls.append(tuple(x.shape))
        return orig(x, y)

    mod = importlib.import_module(
        "genjax_torch.lang.distributions.discrete_hmm")
    real = mod.log_matmul
    mod.log_matmul = lambda x, y: spy(x, y) if x.numel() else real(x, y)
    try:
        forward_filter_parallel(cfg, obs)
    finally:
        mod.log_matmul = real
    assert len(calls) == count_combines(T - 1)
    assert all(c[0] == B and c[-2:] == (S, S) for c in calls)


def test_batched_associative_scan_is_per_execution():
    x = torch.randn(3, 11, 2, 2)
    got = associative_scan(logmatmul.log_matmul, x, axis=1)
    for p in range(3):
        assert torch.equal(got[p], associative_scan(logmatmul.log_matmul,
                                                    x[p]))


@pytest.mark.parametrize("parallel", [False, True])
def test_backward_samplers_draw_jax_vmap_paths(parallel):
    """One key per problem: each draws the path ``jax.vmap`` of the JAX
    sampler draws with that problem's alphas."""
    _, cfgs, probs = _jax_problems(True)
    cfg, _ = _port(cfgs, probs)
    a_ref, _ = jax.jit(jax.vmap(jhmm.forward_filter))(cfgs,
                                                       probs.observations)
    keys = jax.random.split(jax.random.key(17), B)
    jfn = jhmm.backward_sample_parallel if parallel else jhmm.backward_sample
    tfn = backward_sample_parallel if parallel else backward_sample
    want = np.asarray(jax.jit(jax.vmap(jfn))(keys, cfgs, a_ref))
    got = tfn(_tkey(keys), cfg, torch.tensor(np.asarray(a_ref)))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("hmm", [discrete_hmm,
                                 DiscreteHMM(use_parallel_filter=True)],
                         ids=["sequential", "parallel"])
@pytest.mark.parametrize("per_config", [False, True],
                         ids=["obs", "obs_and_config"])
def test_distribution_matches_jax_vmap(hmm, per_config):
    """``simulate`` / ``assess`` on a key batch, one problem per key,
    against ``jax.vmap`` of the JAX distribution."""
    _, cfgs, probs = _jax_problems(per_config)
    cfg, obs = _port(cfgs, probs)
    jdist = jhmm.DiscreteHMM(use_parallel_filter=hmm.use_parallel_filter)
    keys = jax.random.split(jax.random.key(23), B)
    jtr = jax.jit(jax.vmap(lambda k, c, o: jdist.simulate(k, (c, o))))(
        keys, cfgs, probs.observations)
    tr = hmm.simulate(_tkey(keys), (cfg, obs))
    np.testing.assert_array_equal(tr.get_retval().numpy(),
                                  np.asarray(jtr.get_retval()))
    np.testing.assert_allclose(tr.get_score().numpy(),
                               np.asarray(jtr.get_score()), **TOL)
    score, _ = hmm.assess(tr.get_choices(), (cfg, obs), batch=(B,))
    np.testing.assert_allclose(score.numpy(), tr.get_score().numpy(),
                               rtol=1e-6, atol=1e-6)
    # The score is the exact posterior log-density of the drawn path.
    lp = joint_logpdf(cfg, tr.get_retval(), obs) - forward_filter(cfg, obs)[1]
    np.testing.assert_allclose(tr.get_score().numpy(), lp.numpy(), **TOL)


def test_mixed_sharing_runs_one_filter_per_problem():
    """Keys ``(P, K)`` with each problem's parameters zero-stride along
    ``K``: every key draws what its problem alone draws on it."""
    _, cfgs, probs = _jax_problems(True)
    cfg, obs = _port(cfgs, probs)
    k = 5
    lift = DiscreteHMMConfiguration(
        cfg.prior_logits[:, None].expand(B, k, S),
        cfg.transition_logits[:, None].expand(B, k, S, S),
        cfg.observation_logits[:, None].expand(B, k, S, S))
    keys = R.split(R.key(4), B * k).reshape(B, k, 2)
    for hmm in (discrete_hmm, DiscreteHMM(use_parallel_filter=True)):
        score, z = hmm.random_weighted(keys, lift,
                                       obs[:, None].expand(B, k, T))
        for p in range(B):
            one = DiscreteHMMConfiguration(cfg.prior_logits[p],
                                           cfg.transition_logits[p],
                                           cfg.observation_logits[p])
            s1, z1 = hmm.random_weighted(keys[p], one, obs[p])
            assert torch.equal(z[p], z1)
            np.testing.assert_allclose(score[p].numpy(), s1.numpy(),
                                       rtol=1e-6, atol=1e-6)


def _smoothing(cfg_np, obs):
    """Exact smoothing marginals ``P(z_t = s | x)`` by forward-backward
    in float64."""
    prior, trans, emit = (np.asarray(v, np.float64) for v in cfg_np)
    n = len(obs)
    la = np.zeros((n, prior.size))
    la[0] = prior + emit[:, obs[0]]
    for t in range(1, n):
        la[t] = logsumexp(la[t - 1][:, None] + trans, 0) + emit[:, obs[t]]
    lb = np.zeros_like(la)
    for t in range(n - 2, -1, -1):
        lb[t] = logsumexp(trans + emit[:, obs[t + 1]] + lb[t + 1], 1)
    post = la + lb
    return np.exp(post - logsumexp(post, 1, keepdims=True))


@pytest.mark.parametrize("hmm", [discrete_hmm,
                                 DiscreteHMM(use_parallel_filter=True)],
                         ids=["sequential", "parallel"])
def test_ffbs_smoothing_marginals(hmm):
    """``(P, K)`` keys, each problem's configuration lifted along ``K``:
    the draws' state frequencies match each problem's exact smoothing
    marginals within 5 standard errors."""
    _, cfgs, probs = _jax_problems(True)
    cfg, obs = _port(cfgs, probs)
    k = 1500
    lift = DiscreteHMMConfiguration(
        cfg.prior_logits[:, None].expand(B, k, S),
        cfg.transition_logits[:, None].expand(B, k, S, S),
        cfg.observation_logits[:, None].expand(B, k, S, S))
    keys = R.split(R.key(8), B * k).reshape(B, k, 2)
    _, z = hmm.random_weighted(keys, lift, obs[:, None].expand(B, k, T))
    for p in range(B):
        exact = _smoothing((cfg.prior_logits[p], cfg.transition_logits[p],
                            cfg.observation_logits[p]), obs[p].numpy())
        freq = torch.nn.functional.one_hot(z[p], S).double().mean(0).numpy()
        # Cells that expect 10 draws or more either way (normal regime).
        held = (exact * k >= 10) & ((1 - exact) * k >= 10)
        se = np.sqrt(exact * (1 - exact) / k)
        assert held.sum() >= S * T // 2, p
        assert np.all(np.abs(freq - exact)[held] <= 5 * se[held]), p


@pytest.mark.parametrize("per_config", [False, True],
                         ids=["shared", "per_config"])
def test_sample_problem_on_a_key_batch(per_config):
    keys, cfgs, probs = _jax_problems(per_config)
    if per_config:
        cfg = DiscreteHMMConfiguration.circulant(
            S, S, transition_variance=torch.tensor(np.asarray(_variances())))
        np.testing.assert_allclose(cfg.transition_logits.numpy(),
                                   np.asarray(cfgs.transition_logits),
                                   rtol=1e-6, atol=1e-6)
        assert cfg.prior_logits.shape == (B, S)
    else:
        cfg = DiscreteHMMConfiguration.circulant(S, S)
    got = sample_problem(_tkey(keys), cfg, T)
    np.testing.assert_array_equal(got.observations.numpy(),
                                  np.asarray(probs.observations))
    np.testing.assert_array_equal(got.latents.numpy(),
                                  np.asarray(probs.latents))
    np.testing.assert_allclose(got.log_data_marginal.numpy(),
                               np.asarray(probs.log_data_marginal), **TOL)
    lp = got.exact_posterior_logpdf(got.latents)
    want = jax.vmap(lambda pr: pr.exact_posterior_logpdf(pr.latents))(probs)
    np.testing.assert_allclose(lp.numpy(), np.asarray(want), **TOL)
