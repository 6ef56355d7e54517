"""Particle Gibbs with its chain axis sharded over gloo worlds
(``parallel/pgibbs.py``), on the JAX test's LGSSM
(``tests/parallel/test_sharded_pgibbs.py``: a = 0.9, Q = R = 0.5,
T = 12, its data from key 7 carried as numpy, PGAS with 32 particles).

Chains do not interact: 8 chains × 100 sweeps (1200 conditional-SMC
steps a chain) are bit for bit the unsharded run on ``split(key, 8)`` in
worlds of 1, 2, 4 and 8; the JAX test's 400 sweeps are cut to keep the
spawned worlds' host time in the suite's budget (a sweep's host cost is
the same for one chain or eight, so a world of 8 pays it 8 times). Over
500 sweeps in a world of 2 the pooled smoothing means (per-chain means
gathered, the first 100 sweeps dropped) lie within 0.08 of the RTS
smoother's, the JAX test's bound. The JAX test's third case shards only an output and leaves XLA to
lay out the CSMC lanes; it has no per-rank counterpart beyond this
equality (ROADMAP "Not faults")."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_dist_bodies as B
from genjax_tpu.models.ssm import kalman_smoother

KEY = jax.random.key(314159)
A, Q, R, T = 0.9, 0.5, 0.5, 12
N_PARTICLES, N_CHAINS = 32, 8
WORLDS = (1, 2, 4, 8)


def _data(key=jax.random.key(7)):
    ks = jax.random.split(key, 2 * T)
    x, ys = 0.0, []
    for i in range(T):
        x = A * x + float(jnp.sqrt(Q)) * jax.random.normal(ks[2 * i])
        ys.append(x + float(jnp.sqrt(R)) * jax.random.normal(ks[2 * i + 1]))
    return np.asarray(jnp.stack(ys))


YS = _data()


def _kd(k):
    return np.asarray(jax.random.key_data(k))


def _run(world, n_iters, sharded=True, burn_in=0):
    return world.run(B.pgibbs_run, _kd(KEY), YS, A, Q, R, N_PARTICLES,
                     n_iters, N_CHAINS, sharded, burn_in)


@pytest.fixture(scope="module")
def unsharded(gloo_worlds):
    return _run(gloo_worlds(1), 100, False)[0]["paths"]


@pytest.mark.parametrize("d", WORLDS)
def test_sharded_chains_bitwise(gloo_worlds, unsharded, d):
    got = _run(gloo_worlds(d), 100)
    per = N_CHAINS // d
    for rank, r in enumerate(got):
        np.testing.assert_array_equal(
            r["paths"], unsharded[rank * per:(rank + 1) * per])
        np.testing.assert_array_equal(r["means"], got[0]["means"])


def test_sharded_chains_posterior(gloo_worlds):
    got = _run(gloo_worlds(2), 500, burn_in=100)
    means = got[0]["means"]
    assert means.shape == (N_CHAINS, T)
    _, mu_s, _ = kalman_smoother(jnp.asarray(YS), A, Q, R)
    err = np.abs(means.mean(0) - np.asarray(mu_s))
    assert err.max() < 0.08, err
