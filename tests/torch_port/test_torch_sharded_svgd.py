"""Sharded SVGD of the port (``parallel/svgd.py``) on gloo worlds, against
the JAX package's ``parallel/svgd.py`` on its mesh of the same size.

- One ``sharded_svgd_step``: within 1e-5 of the JAX package's (the
  JAX side's log-density is per particle, the port's batched);
- ``sharded_svgd_step`` and ``run_sharded_svgd``: bitwise equal across
  worlds 1, 2, 4 (and 8 for the step);
- what moves: two all-gathers of the (N, D) positions and gradients a
  step, never an (N/D, N) kernel block;
- the fit recovers the Gaussian's moments; ``build_sharded_svgd`` reaches
  its sharded path on the CPU with the same bits on 1 and 2 ranks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_dist_bodies as B
from genjax_tpu.parallel.svgd import sharded_svgd_step as j_step

N, D = 512, 4


def _mesh_of(d):
    return jax.sharding.Mesh(np.asarray(jax.devices()[:d]), ("particles",))


def _logp(z):
    return -0.5 * jnp.sum((z / jnp.asarray(B.SCALES)) ** 2)


@pytest.fixture(scope="module")
def xs0():
    return np.asarray(jax.random.normal(jax.random.key(11), (N, D)))


@pytest.mark.parametrize("d", (1, 2, 4))
def test_step_matches_jax(gloo_worlds, xs0, d):
    got = gloo_worlds(d).run(B.svgd_step, xs0, 0.1)
    want = np.asarray(jax.jit(lambda x: j_step(_logp, x, 0.1, _mesh_of(d)))(
        jnp.asarray(xs0)))
    np.testing.assert_allclose(np.concatenate([r[0] for r in got]), want,
                               rtol=1e-5, atol=1e-5)
    for _, comm in got:
        assert set(comm["by_op"]) == {"all_gather/positions",
                                      "all_gather/gradients"}
        assert comm["max_elements"] == N * D


def test_step_bitwise_all_worlds(gloo_worlds, xs0):
    ref = gloo_worlds(1).run(B.svgd_step, xs0, 0.1)[0][0]
    for d in (2, 4, 8):
        got = gloo_worlds(d).run(B.svgd_step, xs0, 0.1)
        np.testing.assert_array_equal(np.concatenate([r[0] for r in got]),
                                      ref)


def test_step_moves_toward_the_mode(gloo_worlds, xs0):
    got = gloo_worlds(4).run(B.svgd_step, xs0 + 5.0, 0.1)
    assert np.concatenate([r[0] for r in got]).mean() < (xs0 + 5.0).mean()


def test_run_bitwise_all_worlds_and_moments(gloo_worlds, xs0):
    ref = np.concatenate(gloo_worlds(1).run(B.svgd_run, xs0, 50, 0.1))
    for d in (2, 4):
        np.testing.assert_array_equal(
            np.concatenate(gloo_worlds(d).run(B.svgd_run, xs0, 50, 0.1)), ref)
    fit = np.concatenate(gloo_worlds(4).run(B.svgd_run, xs0, 400, 0.1))
    np.testing.assert_allclose(fit.mean(0), np.zeros(D), atol=0.15)
    np.testing.assert_allclose(fit.std(0), np.asarray(B.SCALES), atol=0.3)


def test_entry_sharded_svgd(gloo_worlds):
    kd = np.asarray(jax.random.key_data(jax.random.key(12)))
    one = gloo_worlds(1).run(B.entry_svgd, kd, 64, 5, 32, 4)[0]
    two = gloo_worlds(2).run(B.entry_svgd, kd, 64, 5, 32, 4)
    np.testing.assert_array_equal(np.concatenate(two), one)
    assert one.shape == (64, 4) and np.isfinite(one).all()
