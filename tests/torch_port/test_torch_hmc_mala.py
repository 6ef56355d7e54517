"""Gradient moves against the JAX package on the same key data.

- ``selection_gradient`` against the JAX package's ``jax.grad`` of
  ``assess``, one trace and a batch of 8, to 1e-5 relative (1e-6
  absolute);
- the edit weights of ``HMC``, ``MALA``, ``Rejuvenate`` and
  ``EllipticalSlice`` on a batch of 8 traces against ``jax.vmap`` of the
  same edit, to ``1e-4 + 1e-5·|w|`` (the two packages' normals agree to
  a few ulp, and a leapfrog trajectory carries that difference), with
  the moved values to 1e-4; ``SafeHMC``'s return-value assertion;
- posterior moments of each move under ``mh`` on the conjugate normal
  model (posterior N(0.8, 0.2)), over a batch of chains: mean and
  standard deviation within 0.05, as the JAX package's own tests hold
  them (``tests/inference/test_{mala,requests,ess}.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import genjax_torch as gt
import genjax_tpu as gj
from genjax_torch.core import random as R
from genjax_torch.interop import key_from_numpy
from genjax_tpu.core.compiler.interpreters.incremental import Diff as JDiff

K = 8


def _tkey(k):
    return key_from_numpy(np.asarray(jax.random.key_data(k)))


def _model(lib):
    """``mu``, a 3-vector around it, and two observed sites."""
    ones = torch.ones(3) if lib is gt else jnp.ones(3)

    @lib.gen
    def model(obs_sd):
        mu = lib.normal(0.0, 1.0) @ "mu"
        center = mu[..., None] * ones if lib is gt else mu * ones
        v = lib.mv_normal_diag(center, 0.5 * ones) @ "v"
        lib.normal(mu, obs_sd) @ "y"
        lib.normal(v.sum(-1), 1.0) @ "w"
        return v

    return model


def _obs(lib):
    return lib.C["y"].set(1.0) | lib.C["w"].set(0.5)


def _traces(batched: bool):
    key = jax.random.key(5)
    if batched:
        keys = jax.random.split(key, K)
        trj, _ = jax.vmap(lambda k: _model(gj).generate(k, _obs(gj),
                                                        (0.5,)))(keys)
        sd = torch.full((K,), 0.5)
        obs = gt.ChoiceMap.d({"y": torch.ones(K), "w": torch.full((K,), 0.5)})
        trt, _ = _model(gt).generate(_tkey(keys), obs, (sd,))
    else:
        trj, _ = _model(gj).generate(key, _obs(gj), (0.5,))
        trt, _ = _model(gt).generate(_tkey(key), _obs(gt), (0.5,))
    return trj, trt


def _close(a, b, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(np.asarray(a, np.float64),
                               np.asarray(b, np.float64), rtol=rtol,
                               atol=atol)


SEL = ["mu", "v"]


@pytest.mark.parametrize("batched", [False, True], ids=["one", "batch"])
def test_selection_gradient_matches_jax_grad(batched):
    trj, trt = _traces(batched)
    selj, selt = gj.S.at["mu"] | gj.S.at["v"], gt.S.at["mu"] | gt.S.at["v"]
    if batched:
        vj, gj_ = jax.vmap(lambda t: gj.inference.selection_gradient(
            selj, t, t.get_args()))(trj)
    else:
        vj, gj_ = gj.inference.selection_gradient(selj, trj, trj.get_args())
    vt, gt_ = gt.inference.selection_gradient(selt, trt, trt.get_args())
    for addr in SEL:
        _close(vt[addr], vj[addr])
        _close(gt_[addr], gj_[addr])
        assert not gt_[addr].requires_grad


def test_gradient_of_a_shared_leaf_is_per_chain():
    """A selected value that is the same in every chain (a zero-stride
    leaf) gets each chain's own gradient, not their sum."""
    model = _model(gt)
    keys = R.split(R.key(3), K)
    mu = torch.tensor(0.3).expand(K)
    obs = gt.ChoiceMap.d({"mu": mu, "y": torch.ones(K),
                          "w": torch.full((K,), 0.5)})
    tr, _ = model.generate(keys, obs, (torch.full((K,), 0.5),))
    assert tr.get_choices()["mu"].stride(0) == 0
    _, grads = gt.inference.selection_gradient(gt.S.at["mu"], tr,
                                               tr.get_args())
    for p in range(K):
        one, _ = model.generate(keys[p], gt.ChoiceMap.d({
            "mu": torch.tensor(0.3), "y": 1.0, "w": 0.5}), (0.5,))
        _, g1 = gt.inference.selection_gradient(gt.S.at["mu"], one,
                                                one.get_args())
        _close(grads["mu"][p], g1["mu"])


def _drift(lib):
    @lib.gen
    def drift(old):
        return lib.normal(old["mu"], 0.5) @ "mu"

    return drift


REQUESTS = {
    "hmc": lambda lib, sel: lib.inference.HMC(sel, 0.1, 5),
    "mala": lambda lib, sel: lib.inference.MALA(sel, 0.3),
    "rejuvenate": lambda lib, sel: lib.inference.Rejuvenate(_drift(lib)),
    "ess": lambda lib, sel: lib.inference.EllipticalSlice(sel),
}


@pytest.mark.parametrize("name", sorted(REQUESTS))
def test_edit_weight_matches_jax(name):
    trj, trt = _traces(True)
    selj = gj.S.at["mu"] | gj.S.at["v"]
    selt = gt.S.at["mu"] | gt.S.at["v"]
    if name == "ess":
        selj, selt = gj.S.at["v"], gt.S.at["v"]
    keys = jax.random.split(jax.random.key(17), K)
    req_j, req_t = REQUESTS[name](gj, selj), REQUESTS[name](gt, selt)
    new_j, w_j, _, _ = jax.vmap(lambda k, t: req_j.edit(
        k, t, JDiff.no_change(t.get_args())))(keys, trj)
    new_t, w_t, _, _ = trt.edit(_tkey(keys), req_t)
    assert tuple(w_t.shape) == (K,)
    w_j = np.asarray(w_j, np.float64)
    assert np.all(np.abs(w_t.numpy() - w_j) <= 1e-4 + 1e-5 * np.abs(w_j))
    for addr in SEL:
        _close(new_t.get_choices()[addr], new_j.get_choices()[addr],
               rtol=1e-4, atol=1e-4)
    _close(new_t.get_score(), new_j.get_score(), rtol=1e-4, atol=1e-4)


def test_safe_hmc_asserts_an_unchanged_return_value():
    """``SafeHMC`` refuses a move that changes the return value, in both
    packages, and equals ``HMC`` where the model returns nothing."""
    trj, trt = _traces(False)
    key = jax.random.key(2)
    with pytest.raises(AssertionError):
        gj.inference.SafeHMC(gj.S.at["mu"], 0.05, 3).edit(
            key, trj, JDiff.no_change(trj.get_args()))
    with pytest.raises(AssertionError):
        trt.edit(_tkey(key), gt.inference.SafeHMC(gt.S.at["mu"], 0.05, 3))

    @gt.gen
    def silent():
        gt.normal(0.0, 1.0) @ "mu"

    keys = R.split(R.key(4), K)
    tr = silent.simulate(keys, ())
    _, w_safe, _, _ = tr.edit(keys, gt.inference.SafeHMC(gt.S.at["mu"],
                                                         0.05, 3))
    _, w_hmc, _, _ = tr.edit(keys, gt.inference.HMC(gt.S.at["mu"], 0.05, 3))
    assert torch.equal(w_safe, w_hmc)


def _conjugate():
    @gt.gen
    def conjugate(obs_sd):
        mu = gt.normal(0.0, 1.0) @ "mu"
        return gt.normal(mu, obs_sd) @ "y"

    return conjugate


MOVES = {
    "hmc": (lambda: gt.inference.HMC(gt.S.at["mu"], 0.1, 10), 25),
    "mala": (lambda: gt.inference.MALA(gt.S.at["mu"], 0.45), 60),
    "rejuvenate": (lambda: gt.inference.Rejuvenate(_drift(gt)), 60),
    "ess": (lambda: gt.inference.EllipticalSlice(gt.S.at["mu"]), 40),
}


@pytest.mark.parametrize("name", sorted(MOVES))
def test_mh_posterior_moments(name):
    """2000 chains from the prior under ``mh``; the posterior is
    N(0.8, 0.2)."""
    make, steps = MOVES[name]
    n = 2000
    keys = R.split(R.key(7), n)
    tr, _ = _conjugate().generate(
        keys, gt.ChoiceMap.d({"y": torch.ones(n)}), (torch.full((n,), 0.5),))
    request = make()
    for i in range(steps):
        tr, _ = gt.inference.mh(R.fold_in(keys, 1000 + i), tr, request)
    mus = tr.get_choices()["mu"]
    assert abs(float(mus.mean()) - 0.8) < 0.05
    assert abs(float(mus.std()) - 0.2 ** 0.5) < 0.05
