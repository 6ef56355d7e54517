"""Support transforms against the JAX package on the same numpy inputs:
each bijector's forward, its round trip and its log-Jacobian (the port
gives the terms elementwise; summed, they are the JAX package's
``fldj``) to 1e-5; ``infer_transforms`` and ``resolve_transforms("auto")``
on one model with plain, Scan and Dimap sites; ``constrain_choices``
through a Scan site's ``Indexed`` layer under a chain batch against the
JAX package's ``vmap``; and the Switch parts, served since the
combinators slice (the PerBranch cases are in ``test_torch_switch.py``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import genjax_torch as gt
import genjax_tpu as gj
from genjax_torch.inference import transforms as tt
from genjax_torch.interop import key_from_numpy
from genjax_tpu.inference import transforms as jt

TOL = dict(rtol=1e-5, atol=1e-5)

BIJECTORS = {
    "identity": (tt.identity, jt.identity, 3),
    "positive": (tt.positive, jt.positive, 3),
    "interval": (tt.interval(-1.0, 2.0), jt.interval(-1.0, 2.0), 3),
    "unit_interval": (tt.get_bijector("unit_interval"),
                      jt.get_bijector("unit_interval"), 3),
    "simplex": (tt.simplex, jt.simplex, 4),
}


@pytest.mark.parametrize("name", sorted(BIJECTORS))
def test_bijector_against_jax(name):
    bt, bj, k = BIJECTORS[name]
    u = (2.0 * np.random.default_rng(0).standard_normal((6, k))).astype(
        np.float32)
    x_t = bt.forward(torch.tensor(u))
    x_j = jax.vmap(bj.forward)(jnp.asarray(u))
    np.testing.assert_allclose(x_t.numpy(), np.asarray(x_j), **TOL)
    np.testing.assert_allclose(bt.inverse(x_t).numpy(), u, rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(
        bt.inverse(torch.tensor(np.asarray(x_j))).numpy(),
        np.asarray(jax.vmap(bj.inverse)(x_j)), rtol=1e-4, atol=1e-4)
    terms = bt.fldj(torch.tensor(u))
    assert tuple(terms.shape) == u.shape
    np.testing.assert_allclose(terms.sum(-1).numpy(),
                               np.asarray(jax.vmap(bj.fldj)(jnp.asarray(u))),
                               **TOL)


def _step(lib):
    @lib.gen
    def step(c, _):
        x = lib.normal(c, 1.0) @ "x"
        g = lib.gamma(2.0, 1.0) @ "g"
        return x, g

    return step


def _model(lib):
    chain = _step(lib).scan(n=3)
    scaled = lib.gamma.map(lambda v: 2.0 * v)

    @lib.gen
    def model():
        a = lib.normal(0.0, 1.0) @ "a"
        lib.gamma(2.0, 1.0) @ "s"
        lib.beta(2.0, 3.0) @ "p"
        lib.uniform(-1.0, 2.0) @ "u"
        scaled(3.0, 1.0) @ "d"
        chain(a, None) @ "chain"
        lib.flip(0.3) @ "f"
        lib.normal(a, 1.0) @ "y"

    return model


def _norm(spec):
    if isinstance(spec, tuple):
        return tuple(float(s) for s in spec)
    return spec


def test_infer_transforms_same_model():
    tr_j = _model(gj).simulate(jax.random.key(0), ())
    tr_t = _model(gt).simulate(gt.random.key(0), ())
    ref = {a: _norm(s) for a, s in jt.infer_transforms(tr_j).items()}
    got = {a: _norm(s) for a, s in tt.infer_transforms(tr_t).items()}
    assert got == ref
    assert set(got) == {"s", "p", "u", "d", ("chain", "g")}
    exclude = {"p"}
    assert (set(tt.infer_transforms(tr_t, exclude=exclude.__contains__))
            == set(jt.infer_transforms(tr_j, exclude=exclude.__contains__)))


def test_resolve_transforms_auto_leaves_out_observed_sites():
    tgt_j = gj.inference.Target(_model(gj), (), gj.C["s"].set(1.0))
    tgt_t = gt.inference.Target(_model(gt), (), gt.C["s"].set(1.0))
    got = tt.resolve_transforms(tgt_t, "auto")
    assert set(got) == set(jt.resolve_transforms(tgt_j, "auto"))
    assert "s" not in got
    assert tt.resolve_transforms(tgt_t, None) == {}
    with pytest.raises(ValueError):
        tt.resolve_transforms(tgt_t, "nope")


def _chain_model(lib):
    chain = _step(lib).scan(n=3)

    @lib.gen
    def model():
        a = lib.normal(0.0, 1.0) @ "a"
        chain(a, None) @ "chain"

    return model


def test_constrain_through_scan_site_under_a_batch():
    """The Scan site's values ``(K, 3)`` sit under an ``Indexed`` node of
    batch rank 1: the bijector maps them elementwise and the log-Jacobian
    sums over the steps, one term per chain."""
    k = 5
    keys = jax.random.split(jax.random.key(4), k)
    tf = {("chain", "x"): "positive", "a": (-3.0, 3.0)}
    chm_j = jax.vmap(lambda kk: _chain_model(gj).simulate(kk, ()))(
        keys).get_choices()
    ref_x, ref_f = jax.vmap(lambda c: jt.constrain_choices(c, tf))(chm_j)
    tr_t = _chain_model(gt).simulate(
        key_from_numpy(np.asarray(jax.random.key_data(keys))), ())
    got_x, got_f = tt.constrain_choices(tr_t.get_choices(), tf, batch_rank=1)
    assert tuple(got_f.shape) == (k,)
    np.testing.assert_allclose(got_f.numpy(), np.asarray(ref_f), **TOL)
    np.testing.assert_allclose(got_x["chain", :, "x"].numpy(),
                               np.asarray(ref_x["chain", :, "x"]), **TOL)
    np.testing.assert_allclose(got_x["a"].numpy(), np.asarray(ref_x["a"]),
                               **TOL)
    back = tt.unconstrain_choices(got_x, tf)
    np.testing.assert_allclose(back["chain", :, "x"].numpy(),
                               tr_t.get_choices()["chain", :, "x"].numpy(),
                               rtol=1e-4, atol=1e-4)


def test_masked_leaf_gates_its_jacobian():
    """A ``Mask``-wrapped leaf adds its log-Jacobian only where its flag
    holds, per execution."""
    v = torch.tensor([0.5, -1.0, 2.0])
    flag = torch.tensor([True, False, True])
    chm = gt.ChoiceMap.choice(gt.Mask(v, flag)).extend("x")
    _, fldj = tt.constrain_choices(chm, {"x": "positive"}, batch_rank=1)
    want = torch.where(flag, torch.nn.functional.logsigmoid(v), 0.0)
    np.testing.assert_allclose(fldj.numpy(), want.numpy(), **TOL)


def test_switch_parts_wait_for_the_combinators_slice():
    """The combinators slice has landed: a Switch choice map transforms
    its live branch's leaf (the log-Jacobian gated by the index), and a
    PerBranch spec resolves only under Switch nodes."""
    chm = gt.ChoiceMap.switch(torch.tensor(0), [gt.C["x"].set(1.0),
                                                 gt.C["x"].set(2.0)])
    _, fldj = tt.constrain_choices(chm, {"x": "positive"})
    np.testing.assert_allclose(
        float(fldj), float(torch.nn.functional.logsigmoid(
            torch.tensor(1.0))), **TOL)
    with pytest.raises(ValueError, match="under Switch nodes"):
        tt.get_bijector(tt.PerBranch(("positive", None)))
    with pytest.raises(ValueError, match="not under"):
        tt.constrain_choices(gt.C["x"].set(1.0),
                             {"x": tt.PerBranch(("positive", None))})
    with pytest.raises(ValueError):
        tt.get_bijector("nope")
    with pytest.raises(KeyError):
        tt.constrain_choices(gt.C["x"].set(1.0), {"y": "positive"})
