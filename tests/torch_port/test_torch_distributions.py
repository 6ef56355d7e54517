"""The port's distribution library (``genjax_torch/lang/distributions/
stdlib.py``) against the JAX package's, on the CPU, with the same numpy
parameters and key data (mirrors tests/lang/test_distributions.py).

Precision contract:

- log-densities within ``1e-5·max(1, |jax|)`` of the JAX package's (f32),
  ``1e-4`` for those that go through a special function or a series
  (``non_central_chi2``, ``von_mises``, ``von_mises_fisher``,
  ``lambert_w_normal``, ``zipf``, ``beta_quotient``); ``-inf`` equal out
  of support;
- samplers that are closed-form transforms of uniform or normal draws
  equal JAX's within 1e-5 relative at the same key on 2^12 keys; where a
  Cauchy draw sits at a pole (|draw| > 1e3, ``u`` near 1/2 ± 1/2) the
  test compares the uniforms ``atan(x)/π + 1/2`` instead, to 1e-6;
- ``poisson``, ``binomial``, ``multinomial`` and ``skellam`` give JAX's
  integers on at least 0.999 of 2^12 keys (so do ``von_mises`` and
  ``zipf``, whose loops draw uniforms only);
- everything that reaches gamma, beta, t or Dirichlet (the port's own
  rejection loop) agrees in distribution: the mean of 2^14 draws within
  5 standard errors of its closed form (scipy's, or written out);
- dtypes of the draws equal the JAX package's (x64 off), but for
  ``categorical``, whose draws the port has kept as int64 (an index
  torch's ``gather`` takes as it is) where JAX's are int32;
- the JAX package's log-densities are evaluated one value at a time
  (``vmap``), as its own tests do: some of them take one value only.
"""

import functools
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.special as spsp
import scipy.stats as sps
import torch

import genjax_torch as gt
import genjax_tpu as gj
from genjax_torch.interop import key_from_numpy
from genjax_torch.lang.distributions import stdlib as TS
from genjax_tpu.lang.distributions import stdlib as JS

KEY = jax.random.key(314159)
N_KEYS = 1 << 12
N_MOMENTS = 1 << 14

LOG3 = np.log(np.array([0.2, 0.3, 0.5], np.float32))
CAT = np.log(np.array([0.1, 0.2, 0.7], np.float32))

#: name -> (parameters, log-density test values). Values from the JAX
#: tests' CASES table; the vector-valued ones as rows.
TABLE = {
    "normal": ((0.5, 2.0), [0.0, 1.0, -3.0]),
    "cauchy": ((0.0, 1.5), [0.0, 2.0]),
    "laplace": ((1.0, 2.0), [0.0, 3.0]),
    "logistic": ((0.0, 1.0), [0.0, 1.0]),
    "gumbel": ((0.5, 1.2), [0.0, 2.0]),
    "student_t": ((4.0, 0.0, 1.0), [0.0, 1.5]),
    "half_student_t": ((3.0, 0.0, 1.0), [0.5, 2.0, -1.0]),
    "half_cauchy": ((0.0, 1.0), [0.5, 3.0, -1.0]),
    "half_normal": ((2.0,), [0.5, 3.0, -1.0]),
    "log_normal": ((0.0, 1.0), [0.5, 2.0]),
    "logit_normal": ((0.0, 1.0), [0.3, 0.7]),
    "uniform": ((1.0, 3.0), [1.5, 2.5, 0.5]),
    "exponential": ((2.0,), [0.5, 2.0, -1.0]),
    "beta": ((2.0, 3.0), [0.3, 0.7]),
    "gamma": ((2.0, 3.0), [0.5, 1.5, -1.0]),
    "inverse_gamma": ((3.0, 2.0), [0.5, 1.5]),
    "exp_gamma": ((2.0, 1.0), [-0.5, 0.5]),
    "exp_inverse_gamma": ((2.0, 1.0), [-0.5, 0.5]),
    "chi2": ((3.0,), [1.0, 4.0, -1.0]),
    "chi": ((3.0,), [1.0, 2.0]),
    "weibull": ((2.0, 1.5), [0.5, 2.0]),
    "kumaraswamy": ((2.0, 3.0), [0.3, 0.6]),
    "double_sided_maxwell": ((0.0, 1.0), [1.0, -1.5]),
    "moyal": ((0.0, 1.0), [0.0, 2.0]),
    "truncated_normal": ((0.0, 1.0, -1.0, 2.0), [0.0, 1.0, 2.5]),
    "truncated_cauchy": ((0.0, 1.0, -2.0, 2.0), [0.0, 1.0, 3.0]),
    "inverse_gaussian": ((1.0, 2.0), [0.5, 1.5]),
    "von_mises": ((0.0, 2.0), [0.0, 1.0]),
    "bernoulli": ((0.3,), [0.0, 1.0]),
    "flip": ((0.3,), [0.0, 1.0]),
    "categorical": ((CAT,), [0, 1, 2]),
    "poisson": ((3.5,), [0.0, 2.0, 5.0, -1.0, 2.5]),
    "geometric": ((0.3,), [0.0, 1.0, 5.0]),
    "binomial": ((10.0, 0.4), [0.0, 4.0, 10.0, 11.0]),
    "beta_binomial": ((10.0, 2.0, 3.0), [4.0, 0.0, 10.0]),
    "negative_binomial": ((5.0, 0.4), [0.0, 3.0, 8.0]),
    "non_central_chi2": ((3.0, 2.0), [2.0, 5.0]),
    "skellam": ((2.0, 3.0), [-2.0, 0.0, 3.0]),
    "zipf": ((2.5,), [1.0, 2.0, 5.0]),
    "mv_normal_diag": ((np.array([0.0, 1.0], np.float32),
                        np.array([1.0, 2.0], np.float32)), [[0.5, 0.5]]),
    "mv_normal": ((np.array([0.0, 1.0], np.float32),
                   np.array([[2.0, 0.5], [0.5, 1.0]], np.float32)),
                  [[0.5, 0.5]]),
    "dirichlet": ((np.array([2.0, 3.0, 4.0], np.float32),),
                  [[0.2, 0.3, 0.5]]),
    "multinomial": ((10.0, LOG3), [[2.0, 3.0, 5.0], [10.0, 0.0, 0.0]]),
    "dirichlet_multinomial": ((10.0, np.array([1.0, 2.0, 3.0], np.float32)),
                              [[2.0, 3.0, 5.0], [0.0, 0.0, 10.0]]),
    "beta_quotient": ((2.0, 3.0, 4.0, 3.0), [0.25, 0.5, 1.0, 2.0]),
    "lambert_w_normal": ((0.5, 1.5, 0.2), [0.7, -1.0, 3.0]),
    "power_spherical": ((np.array([0.0, 0.0, 1.0], np.float32), 10.0),
                        [[0.0, 0.0, 1.0], [0.6, 0.0, 0.8], [0.0, 1.0, 0.0]]),
    "von_mises_fisher": ((np.array([0.0, 1.0, 0.0], np.float32), 5.0),
                         [[0.0, 1.0, 0.0], [0.6, 0.8, 0.0], [0.0, 0.0, 1.0]]),
}

SPECIAL = {"non_central_chi2", "von_mises", "von_mises_fisher",
           "lambert_w_normal", "zipf", "beta_quotient"}

#: Closed-form transforms of uniform or normal draws: equal to JAX's at
#: the same key.
CLOSED_FORM = ["cauchy", "laplace", "logistic", "gumbel", "exponential",
               "half_normal", "half_cauchy", "log_normal", "logit_normal",
               "weibull", "kumaraswamy", "truncated_normal",
               "truncated_cauchy", "inverse_gaussian", "moyal",
               "lambert_w_normal", "double_sided_maxwell"]
POLES = {"cauchy", "half_cauchy", "truncated_cauchy"}

#: Loop samplers that follow JAX's loops key for key: the integer ones,
#: and von_mises and zipf, whose loops draw uniforms only (von_mises's
#: angles within 1e-3: its arccos near f = 1 magnifies an ulp of f).
LOOPS = {
    "poisson": [(3.5,), (25.0,)],
    "binomial": [(10.0, 0.4), (100.0, 0.3), (30.0, 0.8)],
    "multinomial": [(10.0, LOG3), (200.0, LOG3)],
    "skellam": [(2.0, 3.0), (12.0, 15.0)],
    "von_mises": [(0.0, 2.0), (1.0, 0.5)],
    "zipf": [(2.5,), (1.7,)],
}

def _stats(frozen):
    mean, var = frozen.stats("mv")
    return np.atleast_1d(float(mean)), np.atleast_1d(np.sqrt(float(var)))


def _dm_moments():
    a = np.array([1.0, 2.0, 3.0])
    p, a0 = a / a.sum(), a.sum()
    return 10 * p, np.sqrt(10 * p * (1 - p) * (10 + a0) / (1 + a0))


_HALF_T3 = 2 * np.sqrt(3.0) / np.pi          # E|T|, T ~ t(3)

#: Equal in distribution only (the port's gamma): the mean of 2^14 draws
#: against the closed form, ``(mean, sd)`` per component (sd None: the
#: draws' own).
MOMENTS = {
    "student_t": _stats(sps.t(4.0)),
    "half_student_t": (np.array([_HALF_T3]),
                       np.array([np.sqrt(3.0 - _HALF_T3 ** 2)])),
    "inverse_gamma": _stats(sps.invgamma(3.0, scale=2.0)),
    "exp_gamma": (np.array([spsp.digamma(2.0)]),
                  np.array([np.sqrt(spsp.polygamma(1, 2.0))])),
    "exp_inverse_gamma": (np.array([-spsp.digamma(2.0)]),
                          np.array([np.sqrt(spsp.polygamma(1, 2.0))])),
    "chi2": _stats(sps.chi2(3.0)),
    "chi": _stats(sps.chi(3.0)),
    "negative_binomial": _stats(sps.nbinom(5, 0.6)),
    "beta_binomial": _stats(sps.betabinom(10, 2.0, 3.0)),
    "non_central_chi2": _stats(sps.ncx2(3.0, 2.0)),
    # E[X] E[1/Y], X ~ Beta(2, 3), Y ~ Beta(4, 3): 0.4 · 2; E[T²] = 0.2 · 5.
    "beta_quotient": (np.array([0.8]), np.array([0.6])),
    "dirichlet_multinomial": _dm_moments(),
    # E[mu·x] times mu: 2α/(α+β) − 1 with α = 1 + 10, β = 1 on S²; and
    # coth(5) − 1/5 for the von Mises–Fisher on S².
    "power_spherical": (np.array([0.0, 0.0, 22.0 / 12.0 - 1.0]), None),
    "von_mises_fisher": (np.array([0.0, 1.0 / np.tanh(5.0) - 0.2, 0.0]),
                         None),
}


def _tkey(k):
    return key_from_numpy(np.asarray(jax.random.key_data(k)))


def _t(x):
    return torch.as_tensor(np.array(x))


def _np(x):
    return np.asarray(x.detach().cpu().numpy() if isinstance(x, torch.Tensor)
                      else x)


KEYS = jax.random.split(KEY, N_KEYS)
TKEYS = _tkey(KEYS)
MOMENT_KEYS = _tkey(jax.random.split(jax.random.fold_in(KEY, 1), N_MOMENTS))


@functools.lru_cache(maxsize=None)
def _jax_sample(name, case=None):
    """The JAX package's draws on the 2^12 keys ``KEYS``, once a case
    (``case``: an index into ``LOOPS[name]``, else the table's)."""
    args = TABLE[name][0] if case is None else LOOPS[name][case]
    d = getattr(gj, name)
    return np.asarray(jax.jit(jax.vmap(lambda k: d.sample(k, *args)))(KEYS))


def _targs(args):
    return [_t(a) if isinstance(a, np.ndarray) else a for a in args]


def _lift(args, b: int):
    """Array parameters lifted to the key batch ``b`` (zero strides), as
    the port's batch convention has them."""
    return [_t(a).expand((b,) + a.shape) if isinstance(a, np.ndarray) else a
            for a in args]


@functools.lru_cache(maxsize=None)
def _port_sample(name):
    """The port's draws on ``KEYS``, the parameters lifted to the batch."""
    return _np(getattr(gt, name).sample(TKEYS, *_lift(TABLE[name][0],
                                                      N_KEYS)))


@functools.lru_cache(maxsize=None)
def _jax_logpdfs(name):
    """The JAX package's log-densities one value at a time (``vmap``, as
    its own tests call them: some take one value only), at the table's
    values and at the port's first 16 draws, in one compiled call."""
    args, values = TABLE[name]
    v = np.asarray(values, np.float32)
    vs = np.concatenate([v, _port_sample(name)[:16].astype(np.float32)])
    d = getattr(gj, name)
    lp = np.asarray(jax.jit(jax.vmap(lambda x: d.logpdf(x, *args)))(
        jnp.asarray(vs)), np.float64)
    return lp[:len(v)], lp[len(v):]


def _close_logpdf(name, got, want):
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    fin = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), fin)
    tol = 1e-4 if name in SPECIAL else 1e-5
    err = np.abs(got[fin] - want[fin]) / np.maximum(1.0, np.abs(want[fin]))
    assert err.max(initial=0.0) <= tol, (got, want)


def test_all_names_match():
    assert set(TS.__all__) == set(JS.__all__) and len(TS.__all__) == 48
    assert set(TABLE) == set(JS.__all__)


@pytest.mark.parametrize("name", sorted(JS.__all__))
def test_parameter_names(name):
    """``bind_kwargs`` reads the sampler's signature: the names are API."""
    jp = list(inspect.signature(getattr(JS, name).sampler).parameters)
    tp = list(inspect.signature(getattr(TS, name).sampler).parameters)
    assert tp == jp


@pytest.mark.parametrize("name", sorted(JS.__all__))
def test_support_spec(name):
    args = TABLE[name][0]
    js = getattr(gj, name).get_support(*args)
    ts = getattr(gt, name).get_support(*_targs(args))
    if isinstance(js, tuple):
        assert isinstance(ts, tuple)
        np.testing.assert_array_equal([float(_np(x)) for x in ts],
                                      [float(x) for x in js])
    else:
        assert ts == js


@pytest.mark.parametrize("name", sorted(JS.__all__))
def test_logpdf_matches_jax(name):
    args, values = TABLE[name]
    want = _jax_logpdfs(name)[0]
    got = _np(getattr(gt, name).logpdf(_t(np.asarray(values, np.float32)),
                                       *_targs(args))).astype(np.float64)
    assert got.shape == want.shape
    _close_logpdf(name, got, want)


@pytest.mark.parametrize("name", sorted(JS.__all__))
def test_draw_dtype_shape_and_support(name):
    """Draws carry the JAX package's dtype and per-key shape (its
    sampler's, traced, not run) and lie in the declared support (the
    parameters lifted to the key batch), and the log-density agrees with
    the JAX package's at the first 16."""
    args = TABLE[name][0]
    d = getattr(gj, name)
    want = jax.eval_shape(jax.vmap(lambda k: d.sample(k, *args)), KEYS)
    got = _port_sample(name)
    if name == "categorical":
        assert got.dtype.kind == np.dtype(want.dtype).kind == "i"
    else:
        assert got.dtype == want.dtype
    assert got.shape == tuple(want.shape)
    spec = getattr(gt, name).get_support(*args)
    if spec == "positive":
        assert (got > 0).all()
    elif spec == "unit_interval":
        assert ((got > 0) & (got < 1)).all()
    elif spec == "simplex":
        np.testing.assert_allclose(got.sum(-1), 1.0, atol=1e-5)
    elif isinstance(spec, tuple):
        assert ((got >= spec[0]) & (got <= spec[1])).all()
    lp = _np(getattr(gt, name).logpdf(_t(got[:16]), *_targs(args)))
    _close_logpdf(name, lp.astype(np.float64), _jax_logpdfs(name)[1])


@pytest.mark.parametrize("name", CLOSED_FORM)
def test_closed_form_sampler_matches_jax(name):
    args = TABLE[name][0]
    want = _jax_sample(name).astype(np.float64)
    got = _np(getattr(gt, name).sample(TKEYS, *args)).astype(np.float64)
    pole = (np.abs(want) > 1e3) if name in POLES else np.zeros(want.shape,
                                                               bool)
    err = np.abs(got - want) / np.maximum(1.0, np.abs(want))
    assert err[~pole].max(initial=0.0) <= 1e-5
    # At a pole: the uniforms behind the draws.
    u = lambda x: np.arctan(x) / np.pi + 0.5  # noqa: E731
    assert np.abs(u(got[pole]) - u(want[pole])).max(initial=0.0) <= 1e-6


@pytest.mark.parametrize("name,case", [(n, i) for n, cases in LOOPS.items()
                                       for i in range(len(cases))])
def test_loop_sampler_matches_jax(name, case):
    want = _jax_sample(name, case)
    got = _np(getattr(gt, name).sample(TKEYS, *_targs(LOOPS[name][case])))
    assert got.dtype == want.dtype
    same = (np.abs(got - want) <= 1e-3) if name == "von_mises" else (
        got == want)
    if same.ndim > 1:
        same = same.all(-1)
    assert same.mean() >= 0.999, same.mean()


@pytest.mark.parametrize("name", sorted(MOMENTS))
def test_moments_in_distribution(name):
    args = TABLE[name][0]
    got = _np(getattr(gt, name).sample(MOMENT_KEYS, *_targs(args)))
    got = got.astype(np.float64).reshape(N_MOMENTS, -1)
    mean, sd = MOMENTS[name]
    sd = got.std(0) if sd is None else sd
    se = sd / np.sqrt(N_MOMENTS)
    assert (np.abs(got.mean(0) - mean) <= 5 * se).all(), (got.mean(0), mean,
                                                           se)


def test_batched_parameters():
    """A parameter per key (``B`` leading) draws and scores per key."""
    rates = np.linspace(0.5, 30.0, 64).astype(np.float32)
    ks = jax.random.split(KEY, 64)
    want = np.asarray(jax.jit(jax.vmap(gj.poisson.sample))(
        ks, rates))
    got = _np(gt.poisson.sample(_tkey(ks), _t(rates)))
    assert (got == want).mean() >= 0.99
    mu = np.tile(np.array([[0.0, 0.6, 0.8]], np.float32), (64, 1))
    x = _np(gt.von_mises_fisher.sample(_tkey(ks), _t(mu), _t(rates)))
    assert x.shape == (64, 3)
    np.testing.assert_allclose(np.linalg.norm(x, axis=-1), 1.0, atol=1e-5)
    lp_t = _np(gt.von_mises_fisher.logpdf(_t(x), _t(mu), _t(rates)))
    lp_j = np.asarray(jax.jit(jax.vmap(gj.von_mises_fisher.logpdf))(
        jnp.asarray(x), jnp.asarray(mu), jnp.asarray(rates)))
    np.testing.assert_allclose(lp_t, lp_j, rtol=1e-4, atol=1e-4)


class TestNamedParameters:
    def test_kwargs_equal_positional_bitwise(self):
        @gt.gen
        def m_kw():
            return gt.normal(loc=0.5, scale=2.0) @ "x"

        @gt.gen
        def m_pos():
            return gt.normal(0.5, 2.0) @ "x"

        k = _tkey(jax.random.split(KEY, 8))
        t1, t2 = m_kw.simulate(k, ()), m_pos.simulate(k, ())
        assert torch.equal(t1.get_choices()["x"], t2.get_choices()["x"])
        assert torch.equal(t1.get_score(), t2.get_score())

    @pytest.mark.parametrize("name,probs,value", [
        ("categorical", [0.3, 0.7], 1),
        ("bernoulli", 0.4, True),
    ])
    def test_probs_alias_matches_jax(self, name, probs, value):
        @gj.gen
        def jm():
            return getattr(gj, name)(probs=jnp.asarray(probs)) @ "c"

        @gt.gen
        def tm():
            return getattr(gt, name)(probs=torch.tensor(probs)) @ "c"

        want, _ = jm.assess(gj.C["c"].set(value), ())
        got, _ = tm.assess(gt.C["c"].set(value), ())
        assert abs(float(got) - float(want)) <= 1e-6

    @pytest.mark.parametrize("call,match", [
        (lambda: gt.normal(0.0, loc=1.0, scale=2.0), "positionally and by"),
        (lambda: gt.normal(loc=1.0, scales=2.0), "missing parameter"),
        (lambda: gt.normal(1.0, 2.0, scale_x=2.0), "unknown parameters"),
        (lambda: gt.categorical(probs=torch.tensor([0.5, 0.5]),
                                logits=torch.zeros(2)), "both"),
    ], ids=["duplicate", "typo", "unknown", "alias-and-target"])
    def test_bad_kwargs_raise_type_error(self, call, match):
        with pytest.raises(TypeError, match=match):
            call()

    def test_kwargs_compose_with_sample_shape(self):
        @gt.gen
        def ms():
            return gt.normal(loc=0.0, scale=1.0,
                             sample_shape=gt.Const((4,))) @ "x"

        @gj.gen
        def mj():
            return gj.normal(loc=0.0, scale=1.0,
                             sample_shape=gj.Const((4,))) @ "x"

        ks = jax.random.split(KEY, 3)
        tr = ms.simulate(_tkey(ks), ())
        jtr = jax.vmap(lambda k: mj.simulate(k, ()))(ks)
        assert tuple(tr.get_retval().shape) == (3, 4)
        np.testing.assert_allclose(_np(tr.get_retval()),
                                   np.asarray(jtr.get_retval()),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(_np(tr.get_score()),
                                   np.asarray(jtr.get_score()), rtol=1e-5)

    def test_gen_function_kwargs_keep_their_path(self):
        @gt.gen
        def inner(a, b=1.0):
            return gt.normal(a, b) @ "y"

        @gt.gen
        def outer():
            return inner(0.0, b=2.0) @ "s"

        tr = outer.simulate(_tkey(KEY), ())
        y = tr.get_choices()["s", "y"]
        want = float(gt.normal.logpdf(y, 0.0, 2.0))
        assert abs(float(tr.get_score()) - want) <= 1e-6


@pytest.mark.parametrize("name", ["poisson", "half_normal", "von_mises"])
def test_generate_and_edit_match_jax(name):
    """``Distribution.generate`` with a constraint and ``edit`` by
    ``Update`` score as the JAX package does on a new distribution."""
    args, values = TABLE[name]
    v = float(values[1])
    jtr, jw = gj.__dict__[name].generate(KEY, gj.ChoiceMap.choice(v), args)
    k = _tkey(KEY)
    ttr, tw = getattr(gt, name).generate(k, gt.ChoiceMap.choice(v), args)
    np.testing.assert_allclose(float(tw), float(jw), rtol=1e-5)
    v2 = float(values[0])
    jed = gj.__dict__[name].edit(KEY, jtr, gj.Update(gj.ChoiceMap.choice(v2)),
                                 gj.Diff.no_change(args))
    ted = getattr(gt, name).edit(k, ttr, gt.Update(gt.ChoiceMap.choice(v2)),
                                 gt.Diff.no_change(args))
    np.testing.assert_allclose(float(ted[1]), float(jed[1]), rtol=1e-5,
                               atol=1e-6)
    assert float(_np(ted[3].constraint.get_value())) == v
