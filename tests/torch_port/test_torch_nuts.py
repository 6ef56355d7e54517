"""NUTS and its adaptation against the JAX package on the same key data.

- One ``nuts_kernel`` transition of 64 chains, on a correlated 2-D
  Gaussian and on config 2's regression model through ``assess``,
  against ``jax.vmap(nuts_kernel)``: the two packages' normals differ
  by a few ulp, so a u-turn decision at a boundary may flip. The test
  asks for equal ``num_steps`` and ``diverging`` on at least 60 of the
  64 chains and ``z`` within ``1e-4·(1 + |z|)`` where they agree (all
  64 agree on both targets at these keys).
- The dynamic and the fixed-budget strategy of the port: bit for bit.
- ``warmup_chains``: eps and the inverse mass against the JAX package to
  1e-4 relative, and a non-finite start reported as diverging with
  accept 0, as the JAX package reports it.
- The ``NUTS`` edit request against the JAX package's under ``vmap``.
- ``run_nuts`` on config 2 at 4 chains x (50 + 50): the posterior mean
  within 4 Monte Carlo standard errors (sd/sqrt(ESS)) of
  ``regression_exact_posterior()``.
- ``build_nuts_logreg`` at (128, 16) on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import genjax_torch as gt
import genjax_tpu as gj
from genjax_torch import entry as E
from genjax_torch.core import random as R
from genjax_torch.inference import adaptation as ta
from genjax_torch.inference.requests import nuts as tn
from genjax_torch.interop import key_from_numpy
from genjax_tpu.core.compiler.interpreters.incremental import Diff as JDiff
from genjax_tpu.inference import adaptation as ja
from genjax_tpu.inference.requests import nuts as jn

C = 64
PREC = np.array([[2.0, 0.6], [0.6, 1.0]], np.float32)


def _tkey(k):
    return key_from_numpy(np.asarray(jax.random.key_data(k)))


def _gauss_j(z):
    return -0.5 * z @ jnp.asarray(PREC) @ z


def _gauss_t(z):
    return -0.5 * ((z @ torch.tensor(PREC)) * z).sum(-1)


def _regression(lib):
    xs = np.linspace(-1.0, 1.0, 128).astype(np.float32)
    ys = 2.0 * xs - 0.5
    if lib is gj:
        @gj.gen
        def reg(xs):
            slope = gj.normal(0.0, 2.0) @ "slope"
            icept = gj.normal(0.0, 2.0) @ "icept"
            gj.mv_normal_diag(slope * xs + icept,
                              0.2 * jnp.ones_like(xs)) @ "ys"

        obs = gj.C["ys"].set(jnp.asarray(ys))

        def logp(z):
            chm = obs | gj.C["slope"].set(z[0]) | gj.C["icept"].set(z[1])
            return reg.assess(chm, (jnp.asarray(xs),))[0]

        return logp
    reg = E.regression_model()
    xt = torch.tensor(xs).expand(C, 128)
    obs = gt.C["ys"].set(torch.tensor(ys).expand(C, 128))

    def logp(z):
        chm = obs | gt.C["slope"].set(z[..., 0]) | gt.C["icept"].set(z[..., 1])
        return reg.assess(chm, (xt,), batch=(C,))[0]

    return logp


TARGETS = {
    "gauss": (_gauss_j, _gauss_t, 0.7, 6),
    "regression": (lambda: _regression(gj), lambda: _regression(gt), 0.02, 6),
}


def _logps(name):
    lj, lt, eps, depth = TARGETS[name]
    if name == "regression":
        lj, lt = lj(), lt()
    return lj, lt, eps, depth


def _start(name):
    z0 = np.random.default_rng(1).standard_normal((C, 2)).astype(np.float32)
    if name == "regression":
        z0 = np.array([2.0, -0.5], np.float32) + 0.05 * z0
    return z0


@pytest.mark.parametrize("name", sorted(TARGETS))
def test_one_transition_matches_jax(name):
    lj, lt, eps, depth = _logps(name)
    z0 = _start(name)
    keys = jax.random.split(jax.random.key(3), C)
    zj, ij = jax.vmap(lambda z, k: jn.nuts_kernel(lj, z, k, eps,
                                                  max_depth=depth))(
        jnp.asarray(z0), keys)
    zt, it = tn.nuts_kernel(lt, torch.tensor(z0), _tkey(keys), eps,
                            max_depth=depth)
    agree = ((np.asarray(ij.num_steps) == it.num_steps.numpy())
             & (np.asarray(ij.diverging) == it.diverging.numpy()))
    assert agree.sum() >= 60
    zj = np.asarray(zj)
    assert np.all(np.abs(zt.numpy() - zj)[agree]
                  <= 1e-4 * (1 + np.abs(zj[agree])))
    np.testing.assert_allclose(it.accept_prob.numpy()[agree],
                               np.asarray(ij.accept_prob)[agree], atol=1e-4)
    assert it.num_steps.min() >= 1


@pytest.mark.parametrize("name", sorted(TARGETS))
def test_dynamic_and_fixed_budget_are_bitwise_equal(name):
    _, lt, eps, depth = _logps(name)
    z0 = torch.tensor(_start(name))
    keys = R.split(R.key(8), C)
    tn.nuts_kernel.host_syncs = 0
    zd, idn = tn.nuts_kernel(lt, z0, keys, eps, max_depth=depth)
    assert tn.nuts_kernel.host_syncs >= 2
    tn.nuts_kernel.host_syncs = 0
    zf, ifx = tn.nuts_kernel(lt, z0, keys, eps, max_depth=depth,
                             fixed_budget=True)
    assert tn.nuts_kernel.host_syncs == 0
    assert torch.equal(zd, zf)
    for a, b in zip(idn, ifx):
        assert torch.equal(a, b)


def test_warmup_chains_matches_jax():
    z0 = np.random.default_rng(0).standard_normal((16, 2)).astype(
        np.float32)
    key = jax.random.key(1)
    zj, ej, mj = ja.warmup_chains(_gauss_j, jnp.asarray(z0), key,
                                  num_warmup=40, max_depth=5)
    zt, et, mt = ta.warmup_chains(_gauss_t, torch.tensor(z0), _tkey(key),
                                  num_warmup=40, max_depth=5)
    np.testing.assert_allclose(float(et), float(ej), rtol=1e-4)
    np.testing.assert_allclose(mt.numpy(), np.asarray(mj), rtol=1e-4)
    np.testing.assert_allclose(zt.numpy(), np.asarray(zj), rtol=1e-4,
                               atol=1e-4)
    # mesh= runs the chain-sharded path (test_torch_sharded_mcmc.py); it
    # takes a torch DeviceMesh and refuses anything else.
    with pytest.raises(TypeError, match="DeviceMesh"):
        ta.warmup_chains(_gauss_t, torch.tensor(z0), _tkey(key),
                         num_warmup=2, mesh=object())


def test_non_finite_start_is_diverging_with_accept_zero():
    """A start of zero density never moves: accept 0 and diverging, in
    both packages."""
    def lj(z):
        return jnp.where(z[0] > 0, _gauss_j(z), -jnp.inf)

    def lt(z):
        return torch.where(z[..., 0] > 0, _gauss_t(z), -torch.inf)

    z0 = np.array([[1.0, 0.0], [-1.0, 0.5], [0.5, 0.5], [-2.0, 1.0]],
                  np.float32)
    keys = jax.random.split(jax.random.key(6), 4)
    zj, ij = jax.vmap(lambda z, k: jn.nuts_kernel(lj, z, k, 0.3,
                                                  max_depth=4))(
        jnp.asarray(z0), keys)
    zt, it = tn.nuts_kernel(lt, torch.tensor(z0), _tkey(keys), 0.3,
                            max_depth=4)
    dead = z0[:, 0] <= 0
    assert it.diverging.numpy()[dead].all()
    assert (it.accept_prob.numpy()[dead] == 0).all()
    np.testing.assert_array_equal(zt.numpy()[dead], z0[dead])
    np.testing.assert_array_equal(it.diverging.numpy(),
                                  np.asarray(ij.diverging))
    np.testing.assert_allclose(zt.numpy(), np.asarray(zj), atol=1e-4)


def test_nuts_request_matches_jax():
    lib_model = {lib: _request_model(lib) for lib in (gj, gt)}
    keys = jax.random.split(jax.random.key(9), 8)
    trj, _ = jax.vmap(lambda k: lib_model[gj].generate(
        k, gj.C["y"].set(1.0), ()))(keys)
    trt, _ = lib_model[gt].generate(
        _tkey(keys), gt.ChoiceMap.d({"y": torch.ones(8)}), ())
    ekeys = jax.random.split(jax.random.key(10), 8)
    req_j = gj.inference.NUTS(gj.S.at["mu"] | gj.S.at["v"], 0.3, 5)
    new_j, w_j, _, _ = jax.vmap(lambda k, t: req_j.edit(
        k, t, JDiff.no_change(())))(ekeys, trj)
    new_t, w_t, _, _ = trt.edit(_tkey(ekeys), gt.inference.NUTS(
        gt.S.at["mu"] | gt.S.at["v"], 0.3, 5))
    assert torch.equal(w_t, torch.zeros(8))
    for addr in ("mu", "v"):
        np.testing.assert_allclose(new_t.get_choices()[addr].numpy(),
                                   np.asarray(new_j.get_choices()[addr]),
                                   rtol=1e-4, atol=1e-4)


def _request_model(lib):
    ones = torch.ones(2) if lib is gt else jnp.ones(2)

    @lib.gen
    def model():
        mu = lib.normal(0.0, 1.0) @ "mu"
        center = mu[..., None] * ones if lib is gt else mu * ones
        v = lib.mv_normal_diag(center, ones) @ "v"
        lib.normal(v.sum(-1), 0.5) @ "y"

    return model


def test_run_nuts_config2_small_against_the_closed_form():
    run, _ = E.build_nuts_regression(n_chains=4, num_warmup=50,
                                     num_samples=50, device="cpu")
    chms, infos = run(R.key(0))
    assert tuple(infos.num_steps.shape) == (4, 50)
    mean, cov = E.regression_exact_posterior()
    for i, addr in enumerate(("slope", "icept")):
        draws = chms[addr]
        assert tuple(draws.shape) == (4, 50)
        ess = float(gt.inference.ess_autocorr(draws))
        mcse = float(draws.std()) / np.sqrt(ess)
        assert abs(float(draws.mean()) - mean[i]) <= 4 * mcse
        assert abs(float(draws.std()) / np.sqrt(cov[i, i]) - 1) < 0.5


def test_build_nuts_logreg_small_on_the_cpu():
    run, target, beta_true = E.build_nuts_logreg(
        n_chains=4, num_warmup=10, num_samples=10, n=128, d=16,
        device="cpu")
    assert target.args[0].shape == (128, 16)
    chms, infos = run(R.key(2))
    beta = chms["beta"]
    assert tuple(beta.shape) == (4, 10, 16)
    assert torch.isfinite(beta).all()
    assert (infos.num_steps >= 1).all()
    if not torch.cuda.is_available():
        # Both entry points run on the card unless told otherwise.
        with pytest.raises(RuntimeError, match="CUDA"):
            E.build_nuts_logreg(n=8, d=4)
        with pytest.raises(RuntimeError, match="CUDA"):
            E.build_nuts_regression()
