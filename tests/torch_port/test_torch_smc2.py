"""SMC² (bench config 7) and PMMH against the JAX package and the exact
Kalman quadrature, on the CPU at small sizes.

The model callables take the θ axis leading (``entry.smc2_model``), so
row ``j`` of a draw is the JAX package's draw for lane ``j``. With the
same key data every weight agrees to the normals' few ulp, through the
θ-resamples and PMMH moves, unless the two packages' f32 sums put a grid
point on different sides of a resampling boundary (none does on the keys
used here). Each bound is stated where it is used."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genjax_torch import entry as E
from genjax_torch.core import random as R
from genjax_torch.inference import gaussian_walk_proposal, pmmh, smc2
from genjax_torch.interop import key_from_numpy
from genjax_torch.models import kalman_filter
from genjax_tpu.inference.pmmh import pmmh as jax_pmmh
from genjax_tpu.inference.smc2 import smc2 as jax_smc2
from genjax_tpu.models.ssm import kalman_filter as jax_kalman

Q, R_, A = 0.4, 0.4, 0.7


def _tkey(k):
    return key_from_numpy(np.asarray(jax.random.key_data(k)))


def _jax_model():
    """The JAX package's config-7 model (benchmarks/run_all.py:454-462)."""
    return (
        lambda key, a, n: jnp.sqrt(Q) * jax.random.normal(key, (n,)),
        lambda key, a, xs: a * xs + jnp.sqrt(Q) * jax.random.normal(
            key, xs.shape),
        lambda a, xs, y: jax.scipy.stats.norm.logpdf(y, xs, jnp.sqrt(R_)),
        lambda key: jax.random.uniform(key, minval=-0.95, maxval=0.95),
        lambda a: jnp.where(jnp.abs(a) < 0.95, -jnp.log(1.9), -jnp.inf),
    )


@pytest.fixture(scope="module")
def ys():
    return E.lgssm_observations(50, device="cpu")


@pytest.fixture(scope="module")
def jax_runs(ys):
    """The JAX package's SMC² at 16 × 16 over the first 2 and 12
    observations, each inner implementation, on one key (jitted once
    per shape)."""
    yj = jnp.asarray(ys.numpy())
    out = {}
    for impl in ("fused", "sort"):
        run = jax_smc2(*_jax_model(), n_theta=16, n_x=16, proposal=0.15,
                       inner_impl=impl)
        for t in (2, 12):
            out[impl, t] = jax.jit(lambda k, y: run(k, y))(
                jax.random.key(4), yj[:t])
    return out


@pytest.mark.parametrize("impl", ["fused", "sort"])
def test_smc2_weights_match_jax_up_to_the_first_resample(ys, jax_runs, impl):
    """At T = 2 (the inner filters' first weights and one advance step:
    the rows' first resample) the θ-weights equal the JAX package's to
    1e-5, each inner implementation held to the same one."""
    run = smc2(*E.smc2_model(), n_theta=16, n_x=16, proposal=0.15,
               inner_impl=impl)
    got = run(_tkey(jax.random.key(4)), ys[:2])
    want = jax_runs[impl, 2]
    np.testing.assert_allclose(got.log_weights.numpy(),
                               np.asarray(want.log_weights),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(got.log_z), float(want.log_z),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.thetas.numpy(), np.asarray(want.thetas),
                               rtol=1e-6)


@pytest.mark.parametrize("impl", ["fused", "sort"])
def test_smc2_follows_jax_through_rejuvenations(ys, jax_runs, impl):
    """Over 12 observations, with rejuvenations firing, the run stays with
    the JAX package's on this key (no f32 boundary tie parts them): log Z
    to 1e-4, the θs and their weights to 1e-5. A tie would part the runs
    after it; none occurs on this key."""
    run = smc2(*E.smc2_model(), n_theta=16, n_x=16, proposal=0.15,
               inner_impl=impl)
    got = run(_tkey(jax.random.key(4)), ys[:12])
    want = jax_runs[impl, 12]
    assert got.ess_history.shape == (11,)
    assert got.n_rejuvenations >= 1
    np.testing.assert_allclose(float(got.log_z), float(want.log_z),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got.thetas.numpy(), np.asarray(want.thetas),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.log_weights.numpy(),
                               np.asarray(want.log_weights),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(got.rejuv_accept),
                               float(want.rejuv_accept))


def test_bad_inner_impl_raises():
    with pytest.raises(ValueError, match="inner_impl"):
        smc2(*E.smc2_model(), n_theta=8, n_x=8, inner_impl="nope")


def test_build_smc2_on_the_cpu_against_the_grid():
    """Config 7 at 128 × 64 × 50 on the CPU (``auto`` is ``sort`` here):
    the θ moments within 0.06 of the grid's (the JAX package's bound,
    tests/inference/test_smc2.py:61-62), log Z within 1.0 of the log
    evidence (its bound too), and rejuvenations fired and moved."""
    run, oracle, _ = E.build_smc2(128, 64, 50, device="cpu")
    res = run(R.key(1))
    w = torch.softmax(res.log_weights, 0)
    mean = float((w * res.thetas).sum())
    sd = math.sqrt(float((w * (res.thetas - mean) ** 2).sum()))
    assert abs(mean - oracle["mean"]) < 0.06
    assert abs(sd - oracle["std"]) < 0.06
    assert abs(float(res.log_z) - oracle["log_ev"]) < 1.0
    assert float(res.rejuv_accept) > 0.05
    assert float(res.ess_history.min()) < 128


def test_smc2_oracle_matches_the_jax_grid(ys):
    from genjax_tpu.models.ssm import lgssm_grid_posterior

    mean, std, log_ev = lgssm_grid_posterior(
        jnp.asarray(ys.numpy()), Q, R_, jnp.linspace(-0.949, 0.949, 191))
    oracle = E.smc2_oracle(ys)
    np.testing.assert_allclose(
        [oracle["mean"], oracle["std"], oracle["log_ev"]],
        [float(mean), float(std), float(log_ev)], rtol=1e-4)


# -- PMMH ------------------------------------------------------------------


def test_gaussian_walk_proposal_matches_jax():
    theta = {"a": jnp.asarray([0.1, 0.2]), "b": jnp.asarray(0.5)}
    k = jax.random.key(3)
    from genjax_tpu.inference.pmmh import gaussian_walk_proposal as jgw

    want = jgw(0.3)(k, theta)
    got = gaussian_walk_proposal(0.3)(
        _tkey(k), {"a": torch.tensor([0.1, 0.2]), "b": torch.tensor(0.5)})
    for name in ("a", "b"):
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]),
                                   rtol=1e-6, atol=1e-7)
    # Two stds for one leaf: neither a scalar nor θ's structure.
    with pytest.raises(TypeError, match="step_std"):
        jgw((0.1, 0.2))(k, {"b": jnp.asarray(0.0)})
    with pytest.raises(TypeError, match="step_std"):
        gaussian_walk_proposal((0.1, 0.2))(_tkey(k), {"b": torch.tensor(0.)})


def test_pmmh_chains_match_jax_with_an_exact_likelihood(ys):
    """PMMH on the LGSSM's coefficient with the exact Kalman likelihood
    (deterministic, so both chains see the same acceptance ratios): 4
    chains as one key batch follow the JAX package's vmapped chains, every
    θ to 1e-5 and the acceptances equal."""
    yd = ys[:30].double()
    yj = jnp.asarray(ys[:30].numpy())

    def est_t(key, a):
        return kalman_filter(yd, a.double(), Q, R_, 0.0, 0.0)[0].float()

    def est_j(key, a):
        return jax_kalman(yj, a, Q, R_, 0.0, 0.0)[0]

    run_t = pmmh(est_t, lambda a: torch.where(a.abs() < 1, 0.0, -math.inf),
                 60, proposal=0.2)
    run_j = jax_pmmh(est_j, lambda a: jnp.where(jnp.abs(a) < 1, 0.0,
                                                -jnp.inf), 60, proposal=0.2)
    keys = jax.random.split(jax.random.key(9), 4)
    theta0 = np.zeros(4, np.float32)
    got = run_t(_tkey(keys), torch.tensor(theta0))
    want = jax.jit(jax.vmap(run_j))(keys, jnp.asarray(theta0))
    assert got.thetas.shape == (4, 60)
    np.testing.assert_allclose(got.thetas.numpy(), np.asarray(want.thetas),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.accept_rate.numpy(),
                               np.asarray(want.accept_rate))
    np.testing.assert_allclose(got.log_zs.numpy(), np.asarray(want.log_zs),
                               rtol=1e-4)
    assert 0.05 < float(got.accept_rate.mean()) < 0.95
