"""``ChangeTarget``, the proposal ``q`` of ``Importance`` / ``ImportanceK``,
the GenSP / VI methods of SMC algorithms and ``Marginal`` (as a site of a
batched ``@gen`` function and as a proposal), against the JAX package on
the same key data.

The models draw only normals and flips, whose draws the two packages
share (flips bit for bit, normals to a few ulp), so every weight and
estimate is held to the JAX package's to 1e-5. The unbiasedness of
``estimate_logpdf`` is checked exactly on an enumerable model, as the
JAX package's own test does. A key batch ``B`` runs ``B`` executions
where the JAX package vmaps; a nested algorithm's particles sit behind
the batch."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.stats import norm

import genjax_torch as gt
import genjax_tpu as gj
from genjax_torch.inference import (
    ChangeTarget,
    Importance,
    ImportanceK,
    Marginal,
    Target,
    marginal,
)
from genjax_torch.interop import key_from_numpy
from genjax_tpu import inference as ji
from genjax_tpu.inference.smc import resample_tree as resample_tree_j

TOL = dict(rtol=1e-5, atol=1e-5)


def _tkey(k):
    return key_from_numpy(np.asarray(jax.random.key_data(k)))


def _close(got, want, **kw):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), **(kw or TOL))


def _conj(lib):
    @lib.gen
    def conjugate(obs_std):
        mu = lib.normal(0.0, 1.0) @ "mu"
        _ = lib.normal(mu, obs_std) @ "y"

    return conjugate


def _q(lib, inf):
    @inf.marginal()
    @lib.gen
    def q(target):
        _ = lib.normal(0.8, 0.5) @ "mu"

    return q


def _pair(constraint=True):
    """(JAX target, port target) of the conjugate model, y = 1 or free."""
    cj = gj.C["y"].set(1.0) if constraint else gj.ChoiceMap.empty()
    ct = gt.C["y"].set(1.0) if constraint else gt.ChoiceMap.empty()
    return (ji.Target(_conj(gj), (0.5,), cj),
            Target(_conj(gt), (0.5,), ct))


def _algs(kind):
    tj, tt = _pair()
    if kind == "importance":
        return ji.Importance(tj), Importance(tt), tj, tt
    if kind == "importance_q":
        return (ji.Importance(tj, _q(gj, ji)), Importance(tt, _q(gt, gt.inference)),
                tj, tt)
    if kind == "importance_k":
        return (ji.ImportanceK(tj, k_particles=16),
                ImportanceK(tt, k_particles=16), tj, tt)
    if kind == "importance_k_q":
        return (ji.ImportanceK(tj, _q(gj, ji), k_particles=16),
                ImportanceK(tt, _q(gt, gt.inference), k_particles=16), tj, tt)
    # ChangeTarget from the prior (nothing observed) to y = 1.
    pj, pt = _pair(constraint=False)
    return (ji.ChangeTarget(ji.ImportanceK(pj, k_particles=16), tj),
            ChangeTarget(ImportanceK(pt, k_particles=16), tt), tj, tt)


KINDS = ["importance", "importance_q", "importance_k", "importance_k_q",
         "change_target"]


@pytest.mark.parametrize("kind", KINDS)
def test_run_smc_and_csmc_weights_match_jax(kind):
    aj, at, _, _ = _algs(kind)
    k = jax.random.key(3)
    cj, ct = aj.run_smc(k), at.run_smc(_tkey(k))
    _close(ct.get_log_weights(), cj.get_log_weights())
    _close(ct.get_particles().get_choices()["mu"],
           cj.get_particles().get_choices()["mu"])
    cj = aj.run_csmc(k, gj.C["mu"].set(0.3))
    ct = at.run_csmc(_tkey(k), gt.C["mu"].set(0.3))
    _close(ct.get_log_weights(), cj.get_log_weights())
    assert float(ct.get_particle(-1).get_choices()["mu"]) == pytest.approx(
        0.3)


@pytest.mark.parametrize("kind", KINDS)
def test_gensp_and_vi_methods_match_jax(kind):
    """estimate_logpdf (the retained particle's score), the normalizing
    constant and its reciprocal, the marginal density, random_weighted
    and the log marginal likelihood, on one key each."""
    aj, at, tj, tt = _algs(kind)
    k = jax.random.key(5)
    kt = _tkey(k)
    vj, vt = gj.C["mu"].set(0.3), gt.C["mu"].set(0.3)
    _close(at.estimate_logpdf(kt, vt, tt), aj.estimate_logpdf(k, vj, tj))
    _close(at.estimate_normalizing_constant(kt, tt),
           aj.estimate_normalizing_constant(k, tj))
    _close(at.estimate_reciprocal_normalizing_constant(kt, tt, vt, -1.2),
           aj.estimate_reciprocal_normalizing_constant(k, tj, vj, -1.2))
    _close(at.estimate_marginal_density(kt, tt, vt, -1.2),
           aj.estimate_marginal_density(k, tj, vj, -1.2))
    ej, chj = aj.random_weighted(k, tj)
    et, cht = at.random_weighted(kt, tt)
    _close(et, ej)
    _close(cht["mu"], chj["mu"])
    _close(at.log_marginal_likelihood_estimate(kt),
           aj.log_marginal_likelihood_estimate(k))
    _close(at.log_marginal_likelihood_estimate(kt, tt),
           aj.log_marginal_likelihood_estimate(k, tj))


@pytest.mark.parametrize("kind", KINDS)
def test_key_batch_runs_one_algorithm_per_key(kind):
    """A key batch B runs B executions, the particle axis behind B: the
    same weights as the JAX package's vmap over the keys: the keys
    ``B + (K, 2)`` of a batched run lift the target to ``B + (K,)``
    particles, never to ``B[0]``."""
    aj, at, tj, tt = _algs(kind)
    keys = jax.random.split(jax.random.key(8), 3)
    tkeys = _tkey(keys)
    col = at.run_smc(tkeys)
    k = at.get_num_particles()
    assert col.get_log_weights().shape == (3, k)
    _close(col.get_log_weights(),
           jax.jit(jax.vmap(lambda k: aj.run_smc(k).get_log_weights()))(keys))
    _close(at.estimate_logpdf(tkeys, gt.C["mu"].set(0.3), tt),
           jax.jit(jax.vmap(lambda k: aj.estimate_logpdf(
               k, gj.C["mu"].set(0.3), tj)))(keys))
    est, chm = at.random_weighted(tkeys, tt)
    ej, chj = jax.jit(jax.vmap(lambda k: aj.random_weighted(k, tj)))(keys)
    _close(est, ej)
    _close(chm["mu"], chj["mu"])
    res = col.resample(tkeys)
    assert res.get_log_weights().shape == (3, k)
    _close(res.get_log_weights()[:, 0],
           col.get_log_marginal_likelihood_estimate())
    # Every row resampled on its own key in one pass: the particles of
    # the JAX package's systematic resample_tree under vmap.
    mu = col.get_particles().get_choices()["mu"]
    want = jax.vmap(lambda key, lw, v: resample_tree_j(key, lw, v, k))(
        keys, jnp.asarray(col.get_log_weights().numpy()),
        jnp.asarray(mu.numpy()))
    assert res.get_particles().get_choices()["mu"].shape == (3, k)
    _close(res.get_particles().get_choices()["mu"], want)


def _two_flip(lib, where):
    @lib.gen
    def two_flip():
        x = lib.flip(0.3) @ "x"
        return lib.flip(where(x, 0.8, 0.2)) @ "y"

    return two_flip


def test_estimate_logpdf_exactly_unbiased_enumerated():
    """E[exp(W)] equals SIR's output density exactly (the ADH identity):
    q_SIR(x = 1) = 0.426 on the two-flip model at K = 2, averaged over
    40 000 keys as one key batch (the JAX package's test: within 5e-3).
    The first 512 estimates equal the JAX package's on the same keys."""
    tt = Target(_two_flip(gt, torch.where), (), gt.C["y"].set(True))
    tj = ji.Target(_two_flip(gj, jnp.where), (), gj.C["y"].set(True))
    keys = jax.random.split(jax.random.key(314159), 40_000)
    est = ImportanceK(tt, k_particles=2).estimate_logpdf(
        _tkey(keys), gt.C["x"].set(True), tt)
    got = math.exp(float(torch.logsumexp(est, 0)) - math.log(40_000))
    assert abs(got - 0.426) < 5e-3
    want = jax.jit(jax.vmap(lambda k: ji.ImportanceK(tj, k_particles=2)
                    .estimate_logpdf(k, gj.C["x"].set(True), tj)))(keys[:512])
    _close(est[:512], want)


def _mixture(lib, where):
    @lib.gen
    def mixture():
        hot = lib.flip(0.3) @ "hot"
        return lib.normal(where(hot, 4.0, 0.0), 1.0) @ "value"

    value_dist = mixture.marginal(selection=lib.Selection.at["value"])

    @lib.gen
    def outer(shift):
        r = value_dist() @ "reading"
        return r["value"] + shift

    return outer


def test_marginal_as_a_site_of_a_batched_gen_function():
    """The outer generate weights on a key batch equal the JAX package's
    vmap, the nested constraint binds, and their log-mean is the closed
    form within 0.05 (2000 keys, as the JAX package's test)."""
    keys = jax.random.split(jax.random.key(1), 2000)
    obs_t = gt.C["reading"].set(gt.C["value"].set(1.0))
    obs_j = gj.C["reading"].set(gj.C["value"].set(1.0))
    tr, w = _mixture(gt, torch.where).generate(_tkey(keys), obs_t, (1.0,))
    _, wj = jax.jit(jax.vmap(lambda k: _mixture(gj, jnp.where).generate(
        k, obs_j, (1.0,))))(keys)
    _close(w, wj)
    assert torch.allclose(torch.as_tensor(tr.get_retval()), torch.tensor(2.0))
    logz = float(torch.logsumexp(w, 0)) - math.log(len(w))
    closed = math.log(0.7 * norm.pdf(1.0, 0, 1) + 0.3 * norm.pdf(1.0, 4, 1))
    assert abs(logz - closed) < 5e-2
    sim = _mixture(gt, torch.where).simulate(_tkey(keys[:4]), (1.0,))
    assert sim.get_score().shape == (4,)
    assert bool(torch.isfinite(sim.get_score()).all())


def test_marginal_as_the_proposal_of_importance_k():
    """ImportanceK with another model's Marginal as q: log Ẑ on a key
    batch equals the JAX package's vmap, and its log-mean over 200 keys
    is the exact evidence within 0.05 (the JAX package's test)."""
    tj, tt = _pair()
    keys = jax.random.split(jax.random.key(314159), 200)
    alg = ImportanceK(tt, _q(gt, gt.inference), k_particles=100)
    est = alg.log_marginal_likelihood_estimate(_tkey(keys))
    algj = ji.ImportanceK(tj, _q(gj, ji), k_particles=100)
    _close(est, jax.jit(jax.vmap(algj.log_marginal_likelihood_estimate))(keys))
    logz = float(torch.logsumexp(est, 0)) - math.log(200)
    assert abs(logz - norm(0.0, math.sqrt(1.25)).logpdf(1.0)) < 0.05


def test_marginal_with_a_k_particle_algorithm_matches_jax():
    """A Marginal of y marginalizing mu with ImportanceK (its target
    observes y at another value, so ChangeTarget reweights): the density
    and random_weighted equal the JAX package's, and exp of the estimate
    averages to the exact density of y = 1."""
    tj0 = ji.Target(_conj(gj), (0.5,), gj.C["y"].set(0.0))
    tt0 = Target(_conj(gt), (0.5,), gt.C["y"].set(0.0))
    mj = _conj(gj).marginal(selection=gj.Selection.at["y"],
                            algorithm=ji.ImportanceK(tj0, k_particles=8))
    mt = _conj(gt).marginal(selection=gt.Selection.at["y"],
                            algorithm=ImportanceK(tt0, k_particles=8))
    assert isinstance(mt, Marginal)
    keys = jax.random.split(jax.random.key(2), 400)
    est = mt.estimate_logpdf(_tkey(keys), gt.C["y"].set(1.0), 0.5)
    _close(est, jax.jit(jax.vmap(lambda k: mj.estimate_logpdf(
        k, gj.C["y"].set(1.0), 0.5)))(keys))
    mean = float(torch.exp(est).mean())
    sd = float(torch.exp(est).std()) / math.sqrt(400)
    assert abs(mean - norm(0, math.sqrt(1.25)).pdf(1.0)) < 4 * sd
    wt, vt = mt.random_weighted(_tkey(keys[:16]), 0.5)
    wj, vj = jax.jit(jax.vmap(lambda k: mj.random_weighted(k, 0.5)))(keys[:16])
    _close(wt, wj)
    _close(vt["y"], vj["y"])


def test_decorator_and_target_checks():
    tj, tt = _pair()

    @marginal(selection=gt.Selection.at["mu"])
    @gt.gen
    def model():
        mu = gt.normal(0.0, 1.0) @ "mu"
        _ = gt.normal(mu, 1.0) @ "y"

    assert isinstance(model, Marginal)
    with pytest.raises(TypeError, match="Marginal"):
        Target(model, (), gt.C["y"].set(1.0))
    with pytest.raises(TypeError, match="expects a Selection"):
        _conj(gt).marginal(selection=["mu"])
