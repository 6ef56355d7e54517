"""A batched ``@gen`` or distribution call takes the batch rank from its
key, never from an argument's length: the same lifted input gives the
same per-execution layout whether the batch ``K`` equals the event
length ``d`` or not, and an unlifted tensor argument raises. The four
calls are a distribution's ``simulate``, ``mv_normal_diag``, a ``@gen``
body and ``assess`` with ``batch=``.

At ``K = d`` an unlifted length-``d`` vector leads with the batch, so by
the convention of ``gfi/gfn.py`` it is per-execution data: no shape can
tell it from one. ``mv_normal_diag`` refuses it there all the same, as
it leaves no event axis behind the batch; the scalar calls read it as
one parameter per execution, as the JAX package's ``vmap(in_axes=0)``
does (held below).

Each layout is held against the JAX package's ``vmap(in_axes=(0, None))``
on the same key data: draws to 1e-6 (the two packages' normals agree to
a few ulp), scores to 1e-5 relative."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import genjax_torch as gt
import genjax_tpu as gj
from genjax_torch.core import random as R
from genjax_torch.interop import key_from_numpy

K = 4
CASES = [pytest.param(3, id="K!=d"), pytest.param(4, id="K=d")]


def _keys():
    keys = jax.random.split(jax.random.key(11), K)
    return keys, key_from_numpy(np.asarray(jax.random.key_data(keys)))


def _loc(d):
    return np.linspace(-1.0, 1.0, d).astype(np.float32)


def _lift(x):
    t = torch.as_tensor(x)
    return t.expand((K,) + tuple(t.shape))


def _close(a, b, rtol):
    np.testing.assert_allclose(np.asarray(a, np.float64),
                               np.asarray(b, np.float64), rtol=rtol,
                               atol=rtol)


def _refused_or_per_execution(d, port, ref, loc):
    """An unlifted ``loc``: refused at ``K != d``; at ``K = d`` one
    parameter per execution, as ``vmap(in_axes=0)`` reads it."""
    if d != K:
        with pytest.raises(ValueError, match="leads with the batch"):
            port(torch.as_tensor(loc))
        return
    out = port(torch.as_tensor(loc))
    assert tuple(out.shape) == (K,)
    _close(out, ref(jnp.asarray(loc)), 1e-5)


@pytest.mark.parametrize("d", CASES)
def test_normal_simulate(d):
    keys_j, keys_t = _keys()
    loc = _loc(d)
    tr = gt.normal.simulate(keys_t, (_lift(loc), 1.0))
    ref = jax.vmap(lambda k: gj.normal.simulate(k, (jnp.asarray(loc), 1.0)))(
        keys_j)
    assert tuple(tr.get_retval().shape) == (K, d)
    assert tuple(tr.get_score().shape) == (K,)
    _close(tr.get_retval(), ref.get_retval(), 1e-6)
    _close(tr.get_score(), ref.get_score(), 1e-5)
    _refused_or_per_execution(
        d, lambda v: gt.normal.simulate(keys_t, (v, 1.0)).get_retval(),
        lambda v: jax.vmap(lambda k, l: gj.normal.simulate(k, (l, 1.0)))(
            keys_j, v).get_retval(), loc)


@pytest.mark.parametrize("d", CASES)
def test_mv_normal_diag_simulate(d):
    keys_j, keys_t = _keys()
    loc, scale = _loc(d), np.full(d, 0.5, np.float32)
    tr = gt.mv_normal_diag.simulate(keys_t, (_lift(loc), _lift(scale)))
    ref = jax.vmap(lambda k: gj.mv_normal_diag.simulate(
        k, (jnp.asarray(loc), jnp.asarray(scale))))(keys_j)
    assert tuple(tr.get_retval().shape) == (K, d)
    assert tuple(tr.get_score().shape) == (K,)
    _close(tr.get_retval(), ref.get_retval(), 1e-6)
    _close(tr.get_score(), ref.get_score(), 1e-5)
    with pytest.raises(ValueError, match="leads with the batch|no event"):
        gt.mv_normal_diag.simulate(keys_t, (torch.as_tensor(loc),
                                            torch.as_tensor(scale)))


def _site(lib):
    @lib.gen
    def site(loc):
        return lib.normal(loc, 1.0) @ "x"

    return site


@pytest.mark.parametrize("d", CASES)
def test_gen_body(d):
    keys_j, keys_t = _keys()
    loc = _loc(d)
    tr = _site(gt).simulate(keys_t, (_lift(loc),))
    ref = jax.vmap(lambda k: _site(gj).simulate(k, (jnp.asarray(loc),)))(
        keys_j)
    assert tuple(tr.get_choices()["x"].shape) == (K, d)
    _close(tr.get_choices()["x"], ref.get_choices()["x"], 1e-6)
    _close(tr.get_score(), ref.get_score(), 1e-5)
    _refused_or_per_execution(
        d, lambda v: _site(gt).simulate(keys_t, (v,)).get_choices()["x"],
        lambda v: jax.vmap(lambda k, l: _site(gj).simulate(k, (l,)))(
            keys_j, v).get_choices()["x"], loc)


@pytest.mark.parametrize("d", CASES)
def test_normal_assess(d):
    loc = _loc(d)
    v = np.zeros(d, np.float32)
    score, _ = gt.normal.assess(gt.ChoiceMap.choice(_lift(v)),
                                (_lift(loc), 1.0), batch=(K,))
    ref, _ = jax.vmap(lambda _: gj.normal.assess(
        gj.ChoiceMap.choice(jnp.asarray(v)), (jnp.asarray(loc), 1.0)))(
            jnp.arange(K))
    assert tuple(score.shape) == (K,)
    _close(score, ref, 1e-5)
    # Read per execution, ``loc`` gives one scalar site per execution.
    _refused_or_per_execution(
        d, lambda l: gt.normal.assess(gt.ChoiceMap.choice(torch.zeros(K)),
                                      (l, 1.0), batch=(K,))[0],
        lambda l: jax.vmap(lambda li: gj.normal.assess(
            gj.ChoiceMap.choice(0.0), (li, 1.0))[0])(l), loc)


def test_body_constant_and_zero_d_arguments_stay_lenient():
    """Inside a body a constant of length ``K`` is lifted, and a 0-d
    tensor or a Python number is the same in every execution."""
    keys = R.split(R.key(2), K)

    @gt.gen
    def body(scale):
        return gt.normal(torch.arange(float(K)), scale) @ "x"

    tr = body.simulate(keys, (torch.tensor(0.5),))
    assert tuple(tr.get_choices()["x"].shape) == (K, K)
    tr = gt.normal.simulate(keys, (torch.tensor(0.0), 1.0))
    assert tuple(tr.get_retval().shape) == (K,)
