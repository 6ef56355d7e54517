"""Particle Gibbs (array level, with and without ancestor sampling) and
its GFI form over ``Scan`` traces, against the JAX package on the same key
data and against the exact RTS smoother.

Free lanes draw multinomial ancestors from exponential spacings, which
the two packages compute bit for bit (``random.exponential``), so with
the same keys a sweep's path and log Z agree to the normals' few ulp
unless an f32 sum ties at a boundary (none does on the keys used here).
The retained lane is checked to hold the reference exactly at every
step. A key batch runs chains side by side, as the JAX package's vmap
does."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import genjax_torch as gt
from genjax_torch.core import random as R
from genjax_torch.inference import (
    conditional_bootstrap_filter,
    particle_gibbs,
    trace_csmc,
    trace_particle_gibbs,
)
from genjax_torch.interop import key_from_numpy
from genjax_torch.models import kalman_smoother, lgssm_model
from genjax_tpu.inference import pgibbs as jpg
from genjax_tpu.models import lgssm_model as jax_lgssm

A, Q, R_ = 0.9, 0.5, 0.5
T = 15
TOL = dict(rtol=1e-4, atol=1e-5)


def _tkey(k):
    return key_from_numpy(np.asarray(jax.random.key_data(k)))


def _sd(v):
    return float(np.sqrt(np.float32(v)))


def jax_model():
    """tests/inference/test_pgibbs.py's model."""
    return (
        lambda key, n: jnp.sqrt(A * A + Q) * jax.random.normal(key, (n,)),
        lambda key, xs: A * xs + jnp.sqrt(Q) * jax.random.normal(
            key, xs.shape),
        lambda xs, y: jax.scipy.stats.norm.logpdf(y, xs, jnp.sqrt(R_)),
        lambda xp, xn: jax.scipy.stats.norm.logpdf(xn, A * xp, jnp.sqrt(Q)),
    )


def torch_model(record=None):
    """The same model, the chain batch leading: keys ``B + (2,)``."""
    s1, sq, sr = _sd(A * A + Q), _sd(Q), _sd(R_)

    def init_sampler(keys, n):
        return s1 * R.normal(keys, (n,))

    def propagate(keys, xs):
        return A * xs + sq * R.normal(keys, xs.shape[keys.ndim - 1:])

    def loglik(xs, y):
        if record is not None:
            record.append(xs)
        return gt.normal.logpdf(y, xs, sr)

    def trans_logpdf(xp, xn):
        return gt.normal.logpdf(xn, A * xp, sq)

    return init_sampler, propagate, loglik, trans_logpdf


@pytest.fixture(scope="module")
def data():
    ks = jax.random.split(jax.random.key(2), 2 * T)
    x = jnp.sqrt(A * A + Q) * jax.random.normal(ks[0])
    xs, ys = [], []
    for i in range(T):
        if i > 0:
            x = A * x + jnp.sqrt(Q) * jax.random.normal(ks[2 * i])
        xs.append(x)
        ys.append(x + jnp.sqrt(R_) * jax.random.normal(ks[2 * i + 1]))
    return np.asarray(jnp.stack(xs)), np.asarray(jnp.stack(ys))


@pytest.mark.parametrize("pgas", [False, True])
def test_csmc_sweep_matches_jax_and_pins_the_retained_lane(data, pgas):
    xs_true, ys = data
    init, prop, ll, tl = jax_model()
    run_j = jpg.conditional_bootstrap_filter(init, prop, ll, 32,
                                             tl if pgas else None)
    seen = []
    ti, tp, tll, ttl = torch_model(seen)
    run_t = conditional_bootstrap_filter(ti, tp, tll, 32,
                                         ttl if pgas else None)
    for seed in range(3):
        k = jax.random.key(seed)
        pj, zj = jax.jit(run_j)(k, jnp.asarray(ys), jnp.asarray(xs_true))
        seen.clear()
        pt, zt = run_t(_tkey(k), torch.tensor(ys), torch.tensor(xs_true))
        np.testing.assert_allclose(pt.numpy(), np.asarray(pj), **TOL)
        np.testing.assert_allclose(float(zt), float(zj), **TOL)
        # Lane K-1 holds the reference at every step, bit for bit.
        pinned = torch.stack([x[-1] for x in seen])
        assert torch.equal(pinned, torch.tensor(xs_true))


def test_particle_gibbs_chains_match_jax_vmap(data):
    """4 chains × 24 particles × 6 sweeps with ancestor sampling, as one
    key batch, follow the JAX package's vmapped chains."""
    _, ys = data
    run_j = jpg.particle_gibbs(*jax_model()[:3], 24, 6,
                               trans_logpdf=jax_model()[3])
    run_t = particle_gibbs(*torch_model()[:3], 24, 6,
                           trans_logpdf=torch_model()[3])
    keys = jax.random.split(jax.random.key(7), 4)
    want = jax.jit(jax.vmap(lambda k: run_j(k, jnp.asarray(ys))))(keys)
    got = run_t(_tkey(keys), torch.tensor(ys))
    assert got.paths.shape == (4, 6, T)
    np.testing.assert_allclose(got.paths.numpy(), np.asarray(want.paths),
                               **TOL)
    np.testing.assert_allclose(got.log_zs.numpy(), np.asarray(want.log_zs),
                               **TOL)


def test_pgas_smoothing_means_match_the_rts_smoother(data):
    """64 chains × 16 particles × 40 sweeps (the first 10 dropped): every
    smoothed mean within 4 Monte Carlo standard errors of the RTS
    smoother's, the error from the chains' spread (independent chains;
    each chain's sweeps are averaged first, so their autocorrelation
    counts)."""
    _, ys = data
    run = particle_gibbs(*torch_model()[:3], 16, 40,
                         trans_logpdf=torch_model()[3])
    res = run(R.split(R.key(3), 64), torch.tensor(ys))
    per_chain = res.paths[:, 10:].mean(1).double()
    mean = per_chain.mean(0)
    mcse = per_chain.std(0) / math.sqrt(64)
    _, mus, _ = kalman_smoother(torch.tensor(ys).double(), A, Q, R_,
                                mu0=0.0, p0=1.0)
    assert bool(((mean - mus).abs() < 4 * mcse).all()), (
        (mean - mus).abs() / mcse)


@pytest.fixture(scope="module")
def scan_problem(data):
    xs_true, ys = data
    return xs_true[:8], ys[:8]


@pytest.mark.parametrize("pgas", [False, True])
def test_trace_csmc_matches_jax(scan_problem, pgas):
    """One GFI-native CSMC sweep over the LGSSM ``Scan`` model (12 lanes,
    8 steps): the new reference and log Z equal the JAX package's."""
    xs, ys = scan_problem
    run_j = jpg.trace_csmc(jax_lgssm(A, Q, R_, 8), (0.0, None), "y",
                           jnp.asarray(ys), ("x",), 12,
                           ancestor_sampling=pgas)
    run_t = trace_csmc(lgssm_model(A, Q, R_, 8), (0.0, None), "y",
                       torch.tensor(ys), ("x",), 12, ancestor_sampling=pgas)
    k = jax.random.key(5)
    rj, zj = jax.jit(run_j)(k, {"x": jnp.asarray(xs)})
    rt, zt = run_t(_tkey(k), {"x": torch.tensor(xs)})
    assert rt["x"].shape == (8,)
    np.testing.assert_allclose(rt["x"].numpy(), np.asarray(rj["x"]), **TOL)
    np.testing.assert_allclose(float(zt), float(zj), **TOL)


def test_trace_particle_gibbs_matches_jax(scan_problem):
    _, ys = scan_problem
    run_j = jpg.trace_particle_gibbs(jax_lgssm(A, Q, R_, 8), (0.0, None),
                                     "y", jnp.asarray(ys), ("x",), 8, 3)
    run_t = trace_particle_gibbs(lgssm_model(A, Q, R_, 8), (0.0, None), "y",
                                 torch.tensor(ys), ("x",), 8, 3)
    k = jax.random.key(6)
    want = jax.jit(run_j)(k)
    got = run_t(_tkey(k))
    assert got.paths["x"].shape == (3, 8)
    np.testing.assert_allclose(got.paths["x"].numpy(),
                               np.asarray(want.paths["x"]), **TOL)
    np.testing.assert_allclose(got.log_zs.numpy(), np.asarray(want.log_zs),
                               **TOL)
