"""Sequence parallelism of the port (``parallel/seq.py``): the
time-sharded HMM filter and backward sampler on gloo worlds, against the
JAX package on its CPU mesh of the same size.

- ``time_sharded_filter``: alphas within rtol 2e-5 / atol 1e-4 of the JAX
  package's. The port runs the recursion scaled (a max-0 state and a
  float64 shift), the JAX package in plain f32, whose log marginal drifts
  about 1e-6 relative from the exact one at T = 256 (its sharded filter
  1.13e-6, the port 1.1e-8): so the port's log marginal is held within
  1e-6 relative of the float64 filter, and to the JAX package's within
  that package's own distance from it plus 1e-6. Bitwise equal
  across worlds 1, 2, 4 and 8 (given block and the derived default); at
  one rank and block = T bitwise the port's ``forward_filter``; the only
  gathered tensor is the (T/block, S, S) block summaries.
- ``time_sharded_backward_sample``: the JAX package's draws on the same
  key away from f32 ties in the inverse CDF, bitwise across worlds, and
  smoothing marginals within ``test_seq.py``'s 0.035 of the exact ones.
- The contract errors: a block that does not divide T/D, an oversize
  block, a T that does not divide over the ranks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_bodies as B
from genjax_torch.interop import hmm_config_from_numpy
from genjax_torch.lang.distributions.discrete_hmm import forward_filter
from genjax_tpu.lang.distributions.discrete_hmm import (
    DiscreteHMMConfiguration,
    forward_filter as j_forward_filter,
)
from genjax_tpu.parallel.seq import (
    time_sharded_backward_sample as j_backward,
    time_sharded_filter as j_filter,
)

T, S, BLOCK = 256, 8, 16


def _mesh_of(d):
    return jax.sharding.Mesh(np.asarray(jax.devices()[:d]), ("time",))


def _problem(s=S, t=T, seed=7):
    config = DiscreteHMMConfiguration.circulant(s, s)
    obs = np.asarray(jax.random.randint(jax.random.key(seed), (t,), 0, s))
    arrays = tuple(np.asarray(a) for a in (config.prior_logits,
                                           config.transition_logits,
                                           config.observation_logits))
    return config, obs, arrays


def _exact(arrays, obs):
    """The forward filter in float64: ``(alphas, log marginal)``."""
    prior, trans, obs_logits = (torch.tensor(np.array(a, np.float64))
                                for a in arrays)
    ol = obs_logits[:, obs].T
    a = prior + ol[0]
    out = [a]
    for row in ol[1:]:
        a = torch.logsumexp(a[:, None] + trans, 0) + row
        out.append(a)
    return torch.stack(out).numpy(), float(torch.logsumexp(a, 0))


def _filter(world, arrays, obs, block):
    got = world.run(B.seq_filter, *arrays, obs, block)
    return (np.concatenate([r[0] for r in got]), got[0][1],
            [r[2] for r in got])


@pytest.mark.parametrize("d", (1, 2, 4))
def test_filter_matches_jax(gloo_worlds, d):
    config, obs, arrays = _problem()
    alphas, lz, _ = _filter(gloo_worlds(d), arrays, obs, BLOCK)
    want_a, want_z = jax.jit(lambda o: j_filter(config, o, _mesh_of(d),
                                                block=BLOCK))(obs)
    np.testing.assert_allclose(alphas, np.asarray(want_a), rtol=2e-5,
                               atol=1e-4)
    exact_a, exact_z = _exact(arrays, obs)
    np.testing.assert_allclose(lz, exact_z, rtol=1e-6)
    jax_err = abs(float(want_z) - exact_z)
    assert abs(lz - float(want_z)) <= jax_err + 1e-6 * abs(exact_z)


def test_filter_bitwise_all_worlds_and_comm(gloo_worlds):
    _, obs, arrays = _problem()
    ref = _filter(gloo_worlds(1), arrays, obs, BLOCK)
    for d in (2, 4, 8):
        alphas, lz, comms = _filter(gloo_worlds(d), arrays, obs, BLOCK)
        np.testing.assert_array_equal(alphas, ref[0])
        assert lz == ref[1]
        for c in comms:
            # The block summaries and their shifts, one scalar all-reduce.
            assert set(c["by_op"]) == {"all_gather/block_summaries",
                                       "all_gather/block_shifts",
                                       "all_reduce/log_marginal"}
            assert c["by_op"]["all_gather/block_summaries"]["elements"] \
                == (T // BLOCK) * S * S
            assert c["max_elements"] < T * S


def test_default_block_bitwise_all_worlds(gloo_worlds):
    _, obs, arrays = _problem()
    ref = _filter(gloo_worlds(1), arrays, obs, None)
    for d in (2, 4):
        alphas, lz, _ = _filter(gloo_worlds(d), arrays, obs, None)
        np.testing.assert_array_equal(alphas, ref[0])
        assert lz == ref[1]


def test_one_rank_full_block_is_forward_filter(gloo_worlds):
    _, obs, arrays = _problem()
    alphas, lz, _ = _filter(gloo_worlds(1), arrays, obs, T)
    want_a, want_z = forward_filter(hmm_config_from_numpy(*arrays),
                                    torch.tensor(obs))
    np.testing.assert_array_equal(alphas, want_a.numpy())
    assert lz == float(want_z)


def test_longer_chain_accuracy(gloo_worlds):
    config, obs, arrays = _problem(16, 1024, 9)
    alphas, lz, _ = _filter(gloo_worlds(4), arrays, obs, 32)
    want_a, want_z = _exact(arrays, obs)
    np.testing.assert_allclose(lz, want_z, rtol=1e-5)
    _, jax_z = j_forward_filter(config, obs)
    np.testing.assert_allclose(lz, float(jax_z), rtol=1e-5)

    def norm(a):
        a = np.asarray(a, np.float64)
        mx = a.max(1, keepdims=True)
        return a - (mx + np.log(np.exp(a - mx).sum(1, keepdims=True)))

    np.testing.assert_allclose(norm(alphas), norm(want_a), atol=5e-4)


@pytest.mark.parametrize("d,block,cut,match", [
    (4, 12, 0, "must divide"),
    (4, 128, 0, "must divide"),
    (4, 2, 6, "multiple of the mesh"),
])
def test_contract_errors(gloo_worlds, d, block, cut, match):
    _, obs, arrays = _problem()
    obs = obs[:T - cut] if cut else obs
    if cut:
        # T - 6 does not divide over 4 ranks; each rank gets a slice of
        # the divisible part, so test the check itself.
        from genjax_torch.parallel.seq import _check_block

        with pytest.raises(ValueError, match=match):
            _check_block(T - cut, d, block)
        return
    msg = gloo_worlds(d).run(B.seq_error, *arrays, obs, block)[0]
    assert msg is not None and match in msg


def test_backward_sample_bitwise_all_worlds_and_vs_jax(gloo_worlds):
    config, obs, arrays = _problem(3, 64, 11)
    key = jax.random.key(5)
    kd = np.asarray(jax.random.key_data(key))
    outs = {}
    for d in (1, 2, 4, 8):
        got = gloo_worlds(d).run(B.seq_ffbs, kd, *arrays, obs, 8)
        outs[d] = np.concatenate([r[0] for r in got])
        for r in got:
            assert set(r[1]["by_op"]) == {"all_gather/block_tables"}
    for d in (2, 4, 8):
        np.testing.assert_array_equal(outs[d], outs[1])

    def run(o):
        alphas, _ = j_filter(config, o, _mesh_of(4), block=8)
        return j_backward(key, config, alphas, _mesh_of(4), block=8)

    want = np.asarray(jax.jit(run)(obs))
    # The same uniforms; an inverse-CDF tie in f32 can flip one draw and
    # the path below it.
    assert (outs[4] != want).sum() <= 4, (outs[4] != want).sum()


def test_smoothing_marginals_exact(gloo_worlds):
    """4000 paths (a key batch) on 4 ranks against the exact
    forward-backward smoothing marginals."""
    t, s = 16, 3
    config, obs, arrays = _problem(s, t, 11)
    want_a, _ = j_forward_filter(config, obs)
    obs_ll = np.asarray(config.observation_logits)[:, obs].T
    trans = np.asarray(config.transition_logits, np.float64)
    betas = [np.zeros(s)]
    for i in range(t - 2, -1, -1):
        x = trans + (obs_ll[i + 1] + betas[-1])[None, :]
        mx = x.max(1)
        betas.append(mx + np.log(np.exp(x - mx[:, None]).sum(1)))
    gam = np.asarray(want_a, np.float64) + np.stack(betas[::-1])
    exact = np.exp(gam - gam.max(1, keepdims=True))
    exact /= exact.sum(1, keepdims=True)
    keys = np.asarray(jax.random.key_data(
        jax.random.split(jax.random.key(17), 4000)))
    got = gloo_worlds(4).run(B.seq_ffbs, keys, *arrays, obs, 4)
    zs = np.concatenate([r[0] for r in got], axis=1)       # (4000, t)
    emp = np.stack([(zs == k).mean(0) for k in range(s)], 1)
    np.testing.assert_allclose(emp, exact, atol=0.035)


def test_entry_time_sharded_hmm(gloo_worlds):
    """build_time_sharded_hmm on the CPU: the same bits on 1 and 2
    ranks; the log marginal is forward_filter's."""
    from genjax_torch import entry as E

    kd = np.asarray(jax.random.key_data(jax.random.key(1)))
    one = gloo_worlds(1).run(B.entry_hmm, kd, 8, 128, None)[0]
    two = gloo_worlds(2).run(B.entry_hmm, kd, 8, 128, None)
    np.testing.assert_array_equal(np.concatenate([r[0] for r in two]),
                                  one[0])
    np.testing.assert_array_equal(np.concatenate([r[2] for r in two]),
                                  one[2])
    from genjax_torch.lang.distributions.discrete_hmm import (
        DiscreteHMMConfiguration as TConfig,
    )

    _, lz = forward_filter(TConfig.circulant(8, 8),
                           E.hmm_observations(8, 128, "cpu"))
    np.testing.assert_allclose(one[1], float(lz), rtol=1e-6)
