"""SMC² with its θ-lanes sharded over gloo worlds
(``parallel/smc2.py``), held bit for bit to the port's unsharded
``smc2`` and, in a world of 2, to the JAX package's ``smc2``.

The JAX test (``tests/parallel/test_sharded_smc2.py``) runs config 7's
model at 64 × 64 over ``simulate_lgssm_data(key(11), 0.7, 0.4, 0.4,
20)`` with a proposal of 0.2; its data is carried here as numpy. Every
rank's θ-rows, the log-weights, log Z, the ESS history, the PMMH
acceptance and the rejuvenation count equal the unsharded run's (a world
of one rank on one thread, as every rank runs) in worlds of 1, 2, 4 and
8. The second case (``ess_threshold=0.9``) makes sure rejuvenations
fire, so the θ-resample's row exchange runs."""

import jax
import numpy as np
import pytest

import torch_dist_bodies as B
from genjax_tpu.inference.smc2 import smc2 as jax_smc2
from genjax_tpu.models.ssm import simulate_lgssm_data

KEY = jax.random.key(314159)
N_THETA, N_X, T = 64, 64, 20
YS = np.asarray(simulate_lgssm_data(jax.random.key(11), 0.7, 0.4, 0.4, T)[1])
WORLDS = (1, 2, 4, 8)
FIELDS = ("log_z", "ess_history", "rejuv_accept")


def _kd(k):
    return np.asarray(jax.random.key_data(k))


@pytest.fixture(scope="module")
def unsharded(gloo_worlds):
    return {thr: gloo_worlds(1).run(B.smc2_run, _kd(KEY), YS, N_THETA, N_X,
                                    0.2, thr, False)[0]
            for thr in (0.5, 0.9)}


@pytest.mark.parametrize("thr", [0.5, 0.9])
@pytest.mark.parametrize("d", WORLDS)
def test_sharded_smc2_bitwise(gloo_worlds, unsharded, d, thr):
    want = unsharded[thr]
    got = gloo_worlds(d).run(B.smc2_run, _kd(KEY), YS, N_THETA, N_X, 0.2,
                             thr)
    per = N_THETA // d
    for rank, r in enumerate(got):
        rows = slice(rank * per, (rank + 1) * per)
        np.testing.assert_array_equal(r["thetas"], want["thetas"][rows])
        np.testing.assert_array_equal(r["log_weights"],
                                      want["log_weights"][rows])
        for f in FIELDS:
            np.testing.assert_array_equal(r[f], want[f])
        assert r["n_rejuvenations"] == want["n_rejuvenations"]
        # One all-gather of the N_θ weights a step and one for log Z.
        gathers = r["comm"]["by_op"]["all_gather/theta_weights"]
        assert gathers["calls"] == T
        assert gathers["elements"] == T * N_THETA
    if thr == 0.9:
        assert want["n_rejuvenations"] >= 1
        moves = got[0]["comm"]["by_op"]["all_to_all/theta_resample"]
        assert moves["calls"] == 4 * want["n_rejuvenations"]
        if d == 1:
            assert moves["bytes"] == 0


def test_sharded_smc2_matches_jax(gloo_worlds):
    """A world of 2 against the JAX package's ``smc2`` on the same key
    data, with ``test_torch_smc2.py``'s tolerances (log Z 1e-4, θs and
    weights 1e-5, the acceptance rate equal)."""
    import jax.numpy as jnp

    from genjax_torch.entry import SMC2_BOUND

    run = jax_smc2(
        lambda key, a, n: jnp.sqrt(0.4) * jax.random.normal(key, (n,)),
        lambda key, a, xs: a * xs
        + jnp.sqrt(0.4) * jax.random.normal(key, xs.shape),
        lambda a, xs, y: jax.scipy.stats.norm.logpdf(y, xs, jnp.sqrt(0.4)),
        lambda key: jax.random.uniform(key, minval=-SMC2_BOUND,
                                       maxval=SMC2_BOUND),
        lambda a: jnp.where(jnp.abs(a) < SMC2_BOUND, -jnp.log(1.9),
                            -jnp.inf),
        n_theta=N_THETA, n_x=N_X, proposal=0.2, inner_impl="sort")
    want = jax.jit(run)(KEY, jnp.asarray(YS))
    got = gloo_worlds(2).run(B.smc2_run, _kd(KEY), YS, N_THETA, N_X, 0.2, 0.5)
    thetas = np.concatenate([r["thetas"] for r in got])
    lw = np.concatenate([r["log_weights"] for r in got])
    np.testing.assert_allclose(float(got[0]["log_z"]), float(want.log_z),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(thetas, np.asarray(want.thetas), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(lw, np.asarray(want.log_weights), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(float(got[0]["rejuv_accept"]),
                               float(want.rejuv_accept))
