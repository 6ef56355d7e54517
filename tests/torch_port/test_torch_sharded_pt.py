"""Parallel tempering with its rung axis sharded over gloo worlds
(``parallel/pt.py``), on the JAX test's model and drift move
(``tests/parallel/test_sharded_pt.py``: conjugate normal, y = 1 at
obs_std 0.5, eight rungs from 0 to 1).

No float reduction crosses rungs, so every rank's rungs, the cold chain's
samples and both rates equal the unsharded run's bit for bit in worlds
of 1, 2, 4 and 8 (in a world of 8 every pair straddles two ranks) over
100 steps of 8 ladders, every phase of the swap schedule 50 times. The
cold chains' mean lies within 0.06 of the exact posterior mean 0.8, the
JAX test's bound. The JAX test takes it from one ladder's 2000 steps
after 500 of burn-in; here 8 ladders of 240 steps after 60 give 1920
draws from independent chains, at an eighth of the host time (a step
costs the same for one ladder or eight), in a world of 2."""

import jax
import numpy as np
import pytest

import torch_dist_bodies as B

KEY = jax.random.key(314159)
N_RUNGS, N_LADDERS = 8, 8
WORLDS = (1, 2, 4, 8)


def _kd(k):
    return np.asarray(jax.random.key_data(k))


def _run(world, n_steps=100, burn_in=0, sharded=True):
    return world.run(B.pt_run, _kd(KEY), N_RUNGS, n_steps, N_LADDERS,
                     burn_in, sharded)


@pytest.fixture(scope="module")
def unsharded(gloo_worlds):
    return _run(gloo_worlds(1), sharded=False)[0]


@pytest.mark.parametrize("d", WORLDS)
def test_sharded_replicas_bitwise(gloo_worlds, unsharded, d):
    got = _run(gloo_worlds(d))
    per = N_RUNGS // d
    for rank, r in enumerate(got):
        rungs = slice(rank * per, (rank + 1) * per)
        np.testing.assert_array_equal(r["samples"], unsharded["samples"])
        np.testing.assert_array_equal(r["swap_rate"], unsharded["swap_rate"])
        for f in ("accept_rate", "mu", "score"):
            np.testing.assert_array_equal(r[f], unsharded[f][:, rungs])
        sends = r["comm"]["by_op"].get("send/pt_boundary")
        if d == 1:
            assert sends is None
        else:
            assert sends["calls"] > 0
    assert np.all(unsharded["swap_rate"] > 0.0)


def test_sharded_replicas_posterior(gloo_worlds):
    got = _run(gloo_worlds(2), n_steps=300, burn_in=60)
    mus = got[0]["samples"]
    assert mus.shape == (N_LADDERS, 240)
    np.testing.assert_array_equal(got[1]["samples"], mus)
    assert abs(mus.mean() - 0.8) < 6e-2
