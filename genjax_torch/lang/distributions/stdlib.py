"""The distribution standard library (counterpart of
``genjax_tpu/lang/distributions/stdlib.py``), all 48 of its
distributions with its parameter names and parameterizations (the TFP
conventions: ``flip`` takes probs, ``bernoulli`` and ``categorical``
logits, ``gamma`` (concentration, rate), ``inverse_gamma``
(concentration, scale)):

- location-scale and half: ``normal``, ``cauchy``, ``laplace``,
  ``logistic``, ``gumbel``, ``student_t``, ``half_student_t``,
  ``half_cauchy``, ``half_normal``, ``log_normal``, ``logit_normal``;
- positive and unit-interval: ``uniform``, ``exponential``, ``beta``,
  ``gamma``, ``inverse_gamma``, ``exp_gamma``, ``exp_inverse_gamma``,
  ``chi2``, ``chi``, ``weibull``, ``kumaraswamy``,
  ``double_sided_maxwell``, ``moyal``;
- truncated and circular: ``truncated_normal``, ``truncated_cauchy``,
  ``inverse_gaussian``, ``von_mises``;
- discrete: ``bernoulli``, ``flip``, ``categorical``, ``poisson``,
  ``geometric``, ``binomial``, ``beta_binomial``, ``negative_binomial``,
  ``non_central_chi2``, ``skellam``, ``zipf``;
- multivariate: ``mv_normal_diag``, ``mv_normal``, ``dirichlet``,
  ``multinomial``, ``dirichlet_multinomial``;
- the tail: ``beta_quotient``, ``lambert_w_normal``,
  ``power_spherical``, ``von_mises_fisher`` (through ``special.py``).

Every sampler takes a key batch ``B + (2,)`` and draws one value per key
(``core/random.py``); every log-density is elementwise and broadcasts,
a vector-valued one summing over its last axis. A sampler returns the
JAX package's dtype under x64 off (int32 for ``poisson``, ``skellam``,
``zipf``, ``geometric``, ``negative_binomial``; f32 for ``binomial``,
``beta_binomial`` and the multinomials). Samplers that are transforms
of uniforms or normals, and the integer loops of ``poisson``,
``binomial`` and ``multinomial``, follow ``jax.random`` key for key;
those that reach gamma, beta, t or Dirichlet go through the port's own
rejection loop and agree with the JAX package in distribution only.
"""

from __future__ import annotations

import math

import torch

from genjax_torch.core import random
from genjax_torch.lang.distributions.distribution import exact_density
from genjax_torch.lang.distributions.special import (
    hyp2f1,
    lambertw,
    log_bessel_iv,
)

__all__ = [
    "bernoulli", "beta", "beta_binomial", "beta_quotient", "binomial",
    "categorical", "lambert_w_normal", "power_spherical",
    "von_mises_fisher",
    "cauchy", "chi", "chi2", "dirichlet", "dirichlet_multinomial",
    "double_sided_maxwell", "exp_gamma", "exp_inverse_gamma", "exponential",
    "flip", "gamma", "geometric", "gumbel", "half_cauchy", "half_normal",
    "half_student_t", "inverse_gamma", "inverse_gaussian", "kumaraswamy",
    "laplace", "log_normal", "logistic", "logit_normal", "moyal",
    "multinomial",
    "mv_normal", "mv_normal_diag", "negative_binomial", "non_central_chi2",
    "normal", "poisson", "skellam", "student_t", "truncated_cauchy",
    "truncated_normal", "uniform", "von_mises", "weibull", "zipf",
]


def _device(*xs):
    for x in xs:
        if isinstance(x, torch.Tensor):
            return x.device
    return None


def _f(x, device=None) -> torch.Tensor:
    """f32, as JAX's x64-off default."""
    if isinstance(x, torch.Tensor):
        return x.to(dtype=torch.float32, device=device or x.device)
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def _xlogy(x, y):
    return torch.where(x == 0, torch.zeros_like(x * y), x * torch.log(y))


def _xlog1py(x, y):
    return torch.where(x == 0, torch.zeros_like(x * y), x * torch.log1p(y))


def _normal_sample(key, loc, scale):
    loc, scale = _f(loc, key.device), _f(scale, key.device)
    return loc + scale * random.normal(key, random.event_shape(key, loc, scale))


def _normal_logpdf(v, loc, scale):
    dev = _device(v, loc, scale)
    v, loc, scale = _f(v, dev), _f(loc, dev), _f(scale, dev)
    log_normalizer = torch.log(2 * math.pi * (scale * scale))
    quadratic = (v - loc) ** 2 / (scale * scale)
    return (log_normalizer + quadratic) / -2.0


#: Normal(loc, scale).
normal = exact_density(_normal_sample, _normal_logpdf, "normal")


def _uniform_sample(key, low=0.0, high=1.0):
    low, high = _f(low, key.device), _f(high, key.device)
    return random.uniform(key, random.event_shape(key, low, high),
                          minval=low, maxval=high)


def _uniform_logpdf(v, low=0.0, high=1.0):
    dev = _device(v, low, high)
    v, low, high = _f(v, dev), _f(low, dev), _f(high, dev)
    scale = high - low
    lp = -torch.log(scale) + torch.zeros_like(v)
    return torch.where((v > low + scale) | (v < low),
                       torch.full_like(lp, -math.inf), lp)


#: Uniform(low, high).
uniform = exact_density(
    _uniform_sample, _uniform_logpdf, "uniform",
    support=lambda low=0.0, high=1.0: (low, high),
)


def _beta_sample(key, c1, c0):
    c1, c0 = _f(c1, key.device), _f(c0, key.device)
    return random.beta(key, c1, c0, random.event_shape(key, c1, c0))


def _betaln(a, b):
    return torch.lgamma(a) + torch.lgamma(b) - torch.lgamma(a + b)


def _beta_logpdf(v, c1, c0):
    dev = _device(v, c1, c0)
    v, a, b = _f(v, dev), _f(c1, dev), _f(c0, dev)
    lp = -_betaln(a, b) + _xlogy(a - 1.0, v) + _xlog1py(b - 1.0, -v)
    return torch.where((v > 1.0) | (v < 0.0), torch.full_like(lp, -math.inf),
                       lp)


#: Beta(concentration1, concentration0).
beta = exact_density(_beta_sample, _beta_logpdf, "beta",
                     support="unit_interval")


def _gamma_sample(key, conc, rate):
    conc, rate = _f(conc, key.device), _f(rate, key.device)
    return random.gamma(key, conc, random.event_shape(key, conc, rate)) / rate


def _gamma_logpdf(v, conc, rate):
    dev = _device(v, conc, rate)
    v, a, r = _f(v, dev), _f(conc, dev), _f(rate, dev)
    lp = _xlogy(a - 1.0, v) - v * r - torch.lgamma(a) + a * torch.log(r)
    return torch.where(v < 0.0, torch.full_like(lp, -math.inf), lp)


#: Gamma(concentration, rate), the TFP rate convention. Its draws come
#: from the port's rejection loop (``core/random.py::loggamma``), equal in
#: distribution to ``jax.random.gamma``, not bit for bit.
gamma = exact_density(_gamma_sample, _gamma_logpdf, "gamma",
                      support="positive")


def _bernoulli_logits_logpmf(v, logits):
    dev = _device(v, logits)
    v, logits = _f(v, dev), _f(logits, dev)
    return v * logits - torch.logaddexp(torch.zeros_like(logits), logits)


def _bernoulli_sample(key, logits):
    logits = _f(logits, key.device)
    return random.bernoulli(key, torch.sigmoid(logits),
                            random.event_shape(key, logits))


#: Bernoulli(logits).
bernoulli = exact_density(
    _bernoulli_sample, _bernoulli_logits_logpmf, "bernoulli",
    aliases={"probs": ("logits", lambda p: torch.logit(_f(p)))})


def _flip_sample(key, p):
    p = _f(p, key.device)
    return random.bernoulli(key, p, random.event_shape(key, p))


def _flip_logpmf(v, p):
    dev = _device(v, p)
    v, p = _f(v, dev), _f(p, dev)
    return _xlogy(v, p) + _xlog1py(1.0 - v, -p)


#: Flip(prob): probability-parameterized Bernoulli.
flip = exact_density(_flip_sample, _flip_logpmf, "flip")


def _categorical_sample(key, logits):
    return random.categorical(key, logits)


def _categorical_logpmf(v, logits):
    dev = _device(v, logits)
    logits = _f(logits, dev)
    logz = torch.logsumexp(logits, dim=-1)
    idx = torch.as_tensor(v, device=logits.device).to(torch.int64)
    shape = torch.broadcast_shapes(idx.shape, logits.shape[:-1])
    full = logits.expand(shape + logits.shape[-1:])
    picked = torch.gather(full, -1, idx.expand(shape)[..., None])[..., 0]
    return picked - logz


#: Categorical(logits).
categorical = exact_density(
    _categorical_sample, _categorical_logpmf, "categorical",
    aliases={"probs": ("logits", lambda p: torch.log(_f(p)))})


def _mvn_diag_sample(key, loc, scale_diag):
    loc, scale = _f(loc, key.device), _f(scale_diag, key.device)
    return loc + scale * random.normal(key, random.event_shape(key, loc, scale))


def _mvn_diag_logpdf(v, loc, scale_diag):
    return _normal_logpdf(v, loc, scale_diag).sum(dim=-1)


#: MultivariateNormalDiag(loc, scale_diag).
mv_normal_diag = exact_density(_mvn_diag_sample, _mvn_diag_logpdf,
                               "mv_normal_diag", event_rank=1)


def _geometric_sample(key, p):
    p = _f(p, key.device)
    u = random.uniform(key, random.event_shape(key, p))
    return torch.floor(torch.log1p(-u) / torch.log1p(-p)).to(torch.int32)


def _geometric_logpmf(v, p):
    dev = _device(v, p)
    v, p = _f(v, dev), _f(p, dev)
    return _xlog1py(v, -p) + torch.log(p)


#: Geometric(probs): the number of failures before the first success
#: (support 0, 1, ...), the JAX package's TFP convention.
geometric = exact_density(_geometric_sample, _geometric_logpmf, "geometric")


def _dirichlet_sample(key, conc):
    conc = _f(conc, key.device)
    return random.dirichlet(key, conc,
                            random.event_shape(key, conc[..., 0]))


def _dirichlet_logpdf(v, conc):
    dev = _device(v, conc)
    v, a = _f(v, dev), _f(conc, dev)
    norm = torch.lgamma(a).sum(-1) - torch.lgamma(a.sum(-1))
    lp = _xlogy(a - 1.0, v).sum(-1) - norm
    simplex = (v > 0.0).all(-1) & ((v.sum(-1) - 1.0).abs() < 1e-6)
    return torch.where(simplex, lp, torch.full_like(lp, -math.inf))


#: Dirichlet(concentration), drawn as normalized gammas (the softmax of
#: ``loggamma`` draws, as ``jax.random.dirichlet`` draws it).
dirichlet = exact_density(_dirichlet_sample, _dirichlet_logpdf, "dirichlet",
                          support="simplex", event_rank=1)


def _mvn_sample(key, loc, cov):
    loc, cov = _f(loc, key.device), _f(cov, key.device)
    factor = torch.linalg.cholesky(cov)
    eps = random.normal(key, random.event_shape(key, loc[..., 0],
                                                cov[..., 0, 0])
                        + tuple(loc.shape[-1:]))
    return loc + (factor @ eps[..., None])[..., 0]


def _mvn_logpdf(v, loc, cov):
    dev = _device(v, loc, cov)
    v, loc, cov = _f(v, dev), _f(loc, dev), _f(cov, dev)
    factor = torch.linalg.cholesky(cov)
    diff = (v - loc)[..., None]
    z = torch.linalg.solve_triangular(
        factor, diff.expand(torch.broadcast_shapes(
            diff.shape, factor.shape[:-1] + (1,))), upper=False)[..., 0]
    n = loc.shape[-1]
    log_det = torch.log(torch.diagonal(factor, dim1=-2, dim2=-1)).sum(-1)
    return -0.5 * (z * z).sum(-1) - log_det - 0.5 * n * math.log(2 * math.pi)


#: MultivariateNormalFullCovariance(loc, covariance_matrix), through the
#: Cholesky factor of the covariance.
mv_normal = exact_density(_mvn_sample, _mvn_logpdf, "mv_normal",
                          event_rank=1)


# ---------------------------------------------------------------------------
# Shared pieces of the ported distributions
# ---------------------------------------------------------------------------

_LOG2 = math.log(2.0)


def _on(*xs):
    """``xs`` as f32 tensors on one device (the first tensor's)."""
    dev = _device(*xs)
    return [_f(x, dev) for x in xs]


def _params(key, *params):
    """The parameters as f32 tensors on the key's device, and the draw
    shape behind the key batch."""
    ps = [_f(p, key.device) for p in params]
    return ps, random.event_shape(key, *ps)


def _neg_inf_where(cond, lp):
    return torch.where(cond, torch.full_like(lp, -math.inf), lp)


def _t_logpdf(x, df, loc, scale):
    scaled = (x - loc) / scale
    half_df = df / 2.0
    df_plus_one_over_two = half_df + 0.5
    normalize = (torch.lgamma(half_df)
                 + torch.log(scale * scale * math.pi * df) / 2.0
                 - torch.lgamma(df_plus_one_over_two))
    quadratic = scaled * scaled / df
    return -(normalize + df_plus_one_over_two * torch.log1p(quadratic))


def _cauchy_logpdf(x, loc, scale):
    z = (x - loc) / scale
    return -(torch.log(math.pi * scale) + torch.log1p(z * z))


def _poisson_logpmf(k, mu):
    lp = _xlogy(k, mu) - torch.lgamma(k + 1) - mu
    return _neg_inf_where((k < 0) | (torch.round(k) != k), lp)


def _chi2_logpdf(x, df):
    df_on_two = df / 2.0
    kernel = (df_on_two - 1.0) * torch.log(x) - x / 2.0
    norm = -(torch.lgamma(df_on_two) + _LOG2 * df / 2.0)
    return _neg_inf_where(x < 0, norm + kernel)


def _algdiv(a, b):
    """``log(gamma(a)) - log(gamma(a + b))`` for ``b >= 8``, ``a <= b``
    (scipy's cdflib ``algdiv``, as ``jax.scipy.special.betaln`` has it)."""
    c0, c1, c2 = 0.833333333333333e-01, -0.277777777760991e-02, \
        0.793650666825390e-03
    c3, c4, c5 = -0.595202931351870e-03, 0.837308034031215e-03, \
        -0.165322962780713e-02
    h = a / b
    c = h / (1 + h)
    x = h / (1 + h)
    d = b + (a - 0.5)
    x2 = x * x
    s3 = 1.0 + (x + x2)
    s5 = 1.0 + (x + x2 * s3)
    s7 = 1.0 + (x + x2 * s5)
    s9 = 1.0 + (x + x2 * s7)
    s11 = 1.0 + (x + x2 * s9)
    t = (1.0 / b) ** 2
    w = ((((c5 * s11 * t + c4 * s9) * t + c3 * s7) * t + c2 * s5) * t
         + c1 * s3) * t + c0
    w = w * (c / b)
    u = d * torch.log1p(a / b)
    v = a * (torch.log(b) - 1.0)
    return torch.where(u <= v, (w - v) - u, (w - u) - v)


def _betaln_cdflib(a, b):
    """``log B(a, b)`` as ``jax.scipy.special.betaln`` computes it: the
    log-gamma sum below ``max(a, b) = 8``, ``algdiv`` above."""
    a, b = torch.minimum(a, b), torch.maximum(a, b)
    small = torch.lgamma(a) + (torch.lgamma(b) - torch.lgamma(a + b))
    large = torch.lgamma(a) + _algdiv(a, b)
    return torch.where(b < 8, small, large)


def _nan_where(cond, lp):
    return torch.where(cond, torch.full_like(lp, math.nan), lp)


def _last(*xs):
    """Tensors with a trailing axis of length 1, for a series along it."""
    return [x[..., None] for x in xs]


# ---------------------------------------------------------------------------
# Location-scale and half distributions
# ---------------------------------------------------------------------------


def _cauchy_sample(key, loc, scale):
    (loc, scale), shape = _params(key, loc, scale)
    return loc + scale * random.cauchy(key, shape)


#: Cauchy(loc, scale).
cauchy = exact_density(_cauchy_sample, lambda v, loc, scale: _cauchy_logpdf(
    *_on(v, loc, scale)), "cauchy")


def _laplace_sample(key, loc, scale):
    (loc, scale), shape = _params(key, loc, scale)
    return loc + scale * random.laplace(key, shape)


def _laplace_logpdf(v, loc, scale):
    v, loc, scale = _on(v, loc, scale)
    return -((v - loc).abs() / scale + torch.log(2.0 * scale))


#: Laplace(loc, scale).
laplace = exact_density(_laplace_sample, _laplace_logpdf, "laplace")


def _logistic_sample(key, loc, scale):
    (loc, scale), shape = _params(key, loc, scale)
    return loc + scale * random.logistic(key, shape)


def _logistic_logpdf(v, loc, scale):
    v, loc, scale = _on(v, loc, scale)
    half = (v - loc) / scale / 2.0
    return -2.0 * torch.logaddexp(half, -half) - torch.log(scale)


#: Logistic(loc, scale).
logistic = exact_density(_logistic_sample, _logistic_logpdf, "logistic")


def _gumbel_sample(key, loc, scale):
    (loc, scale), shape = _params(key, loc, scale)
    return loc + scale * random.gumbel(key, shape)


def _gumbel_logpdf(v, loc, scale):
    v, loc, scale = _on(v, loc, scale)
    z = (v - loc) / scale
    lp = -torch.log(scale) - (z + torch.exp(-z))
    return _nan_where(~(scale > 0), lp)


#: Gumbel(loc, scale): the max-Gumbel, TFP's convention.
gumbel = exact_density(_gumbel_sample, _gumbel_logpdf, "gumbel")


def _student_t_sample(key, df, loc, scale):
    (df, loc, scale), shape = _params(key, df, loc, scale)
    return loc + scale * random.t(key, df, shape)


#: StudentT(df, loc, scale).
student_t = exact_density(
    _student_t_sample,
    lambda v, df, loc, scale: _t_logpdf(*_on(v, df, loc, scale)),
    "student_t")


def _half_student_t_sample(key, df, loc, scale):
    (df, loc, scale), shape = _params(key, df, loc, scale)
    return loc + scale * random.t(key, df, shape).abs()


def _half_student_t_logpdf(v, df, loc, scale):
    v, df, loc, scale = _on(v, df, loc, scale)
    lp = _LOG2 + _t_logpdf(v, df, loc, scale)
    return _neg_inf_where(~(v >= loc), lp)


#: HalfStudentT(df, loc, scale).
half_student_t = exact_density(_half_student_t_sample, _half_student_t_logpdf,
                               "half_student_t", support="positive")


def _half_cauchy_sample(key, loc, scale):
    (loc, scale), shape = _params(key, loc, scale)
    return loc + scale * random.cauchy(key, shape).abs()


def _half_cauchy_logpdf(v, loc, scale):
    v, loc, scale = _on(v, loc, scale)
    lp = _LOG2 + _cauchy_logpdf(v, loc, scale)
    return _neg_inf_where(~(v >= loc), lp)


#: HalfCauchy(loc, scale).
half_cauchy = exact_density(_half_cauchy_sample, _half_cauchy_logpdf,
                            "half_cauchy", support="positive")


def _half_normal_sample(key, scale):
    (scale,), shape = _params(key, scale)
    return scale * random.normal(key, shape).abs()


def _half_normal_logpdf(v, scale):
    v, scale = _on(v, scale)
    lp = _LOG2 + _normal_logpdf(v, torch.zeros_like(scale), scale)
    return _neg_inf_where(~(v >= 0.0), lp)


#: HalfNormal(scale).
half_normal = exact_density(_half_normal_sample, _half_normal_logpdf,
                            "half_normal", support="positive")


def _log_normal_sample(key, loc, scale):
    return torch.exp(_normal_sample(key, loc, scale))


def _log_normal_logpdf(v, loc, scale):
    v, loc, scale = _on(v, loc, scale)
    return _normal_logpdf(torch.log(v), loc, scale) - torch.log(v)


#: LogNormal(loc, scale): exp of Normal(loc, scale).
log_normal = exact_density(_log_normal_sample, _log_normal_logpdf,
                           "log_normal", support="positive")


def _logit_normal_sample(key, loc, scale):
    return torch.sigmoid(_normal_sample(key, loc, scale))


def _logit_normal_logpdf(v, loc, scale):
    v, loc, scale = _on(v, loc, scale)
    return (_normal_logpdf(torch.log(v / (1 - v)), loc, scale) - torch.log(v)
            - torch.log1p(-v))


#: LogitNormal(loc, scale): sigmoid of Normal(loc, scale).
logit_normal = exact_density(_logit_normal_sample, _logit_normal_logpdf,
                             "logit_normal", support="unit_interval")


# ---------------------------------------------------------------------------
# Positive and unit-interval distributions
# ---------------------------------------------------------------------------


def _exponential_sample(key, rate):
    (rate,), shape = _params(key, rate)
    return random.exponential(key, shape) / rate


def _exponential_logpdf(v, rate):
    v, rate = _on(v, rate)
    scale = 1.0 / rate
    lp = -(v / scale + torch.log(scale))
    return _neg_inf_where(v < 0, lp)


#: Exponential(rate).
exponential = exact_density(_exponential_sample, _exponential_logpdf,
                            "exponential", support="positive")


def _inverse_gamma_sample(key, conc, scale):
    (conc, scale), shape = _params(key, conc, scale)
    return scale / random.gamma(key, conc, shape)


def _inverse_gamma_logpdf(v, conc, scale):
    v, conc, scale = _on(v, conc, scale)
    return (conc * torch.log(scale) - torch.lgamma(conc)
            - (conc + 1.0) * torch.log(v) - scale / v)


#: InverseGamma(concentration, scale): 1/X, X ~ Gamma(conc, rate=scale).
inverse_gamma = exact_density(_inverse_gamma_sample, _inverse_gamma_logpdf,
                              "inverse_gamma", support="positive")


def _exp_gamma_sample(key, conc, rate=1.0):
    (conc, rate), shape = _params(key, conc, rate)
    return random.loggamma(key, conc, shape) - torch.log(rate)


def _exp_gamma_logpdf(y, conc, rate=1.0):
    y, conc, rate = _on(y, conc, rate)
    return (conc * torch.log(rate) - torch.lgamma(conc) + conc * y
            - rate * torch.exp(y))


#: ExpGamma(concentration, rate): the log of a Gamma draw, drawn in log
#: space (``loggamma``) so that it does not underflow.
exp_gamma = exact_density(_exp_gamma_sample, _exp_gamma_logpdf, "exp_gamma")


def _exp_inverse_gamma_sample(key, conc, scale=1.0):
    (conc, scale), shape = _params(key, conc, scale)
    return torch.log(scale) - random.loggamma(key, conc, shape)


def _exp_inverse_gamma_logpdf(y, conc, scale=1.0):
    y, conc, scale = _on(y, conc, scale)
    return (conc * torch.log(scale) - torch.lgamma(conc) - conc * y
            - scale * torch.exp(-y))


#: ExpInverseGamma(concentration, scale).
exp_inverse_gamma = exact_density(_exp_inverse_gamma_sample,
                                  _exp_inverse_gamma_logpdf,
                                  "exp_inverse_gamma")


def _chi2_sample(key, df):
    (df,), shape = _params(key, df)
    return random.chisquare(key, df, shape)


#: Chi2(df).
chi2 = exact_density(_chi2_sample, lambda v, df: _chi2_logpdf(*_on(v, df)),
                     "chi2", support="positive")


def _chi_sample(key, df):
    return torch.sqrt(_chi2_sample(key, df))


def _chi_logpdf(v, df):
    v, df = _on(v, df)
    return ((df - 1.0) * torch.log(v) - v * v / 2.0
            - (df / 2.0 - 1.0) * _LOG2 - torch.lgamma(df / 2.0))


#: Chi(df): the square root of Chi2(df).
chi = exact_density(_chi_sample, _chi_logpdf, "chi", support="positive")


def _weibull_sample(key, conc, scale):
    (conc, scale), shape = _params(key, conc, scale)
    u = random.uniform(key, shape)
    return scale * (torch.pow(-random.log1p_f32(-u), 1.0 / conc) * 1.0)


def _weibull_logpdf(v, conc, scale):
    v, conc, scale = _on(v, conc, scale)
    z = v / scale
    return (torch.log(conc) - torch.log(scale) + (conc - 1.0) * torch.log(z)
            - z ** conc)


#: Weibull(concentration, scale), TFP's convention, by the inverse CDF.
weibull = exact_density(_weibull_sample, _weibull_logpdf, "weibull",
                        support="positive")


def _kumaraswamy_sample(key, a, b):
    (a, b), shape = _params(key, a, b)
    u = random.uniform(key, shape)
    return (1.0 - (1.0 - u) ** (1.0 / b)) ** (1.0 / a)


def _kumaraswamy_logpdf(v, a, b):
    v, a, b = _on(v, a, b)
    return (torch.log(a) + torch.log(b) + (a - 1.0) * torch.log(v)
            + (b - 1.0) * torch.log1p(-(v ** a)))


#: Kumaraswamy(concentration1, concentration0), by the inverse CDF.
kumaraswamy = exact_density(_kumaraswamy_sample, _kumaraswamy_logpdf,
                            "kumaraswamy", support="unit_interval")


def _dsm_sample(key, loc, scale):
    (loc, scale), shape = _params(key, loc, scale)
    maxwell_key, rademacher_key = random.split(key).unbind(-2)
    n = random.normal(maxwell_key, shape + (3,))
    maxwell = torch.sqrt((n * n).sum(-1))
    sign = 2.0 * random.bernoulli(rademacher_key, 0.5, shape).to(
        torch.float32) - 1.0
    return loc + scale * (sign * maxwell * 1.0 + 0.0)


def _dsm_logpdf(v, loc, scale):
    v, loc, scale = _on(v, loc, scale)
    z = (v - loc) / scale
    return (2.0 * torch.log(z.abs()) - z * z / 2.0
            - 0.5 * math.log(2.0 * math.pi) - torch.log(scale))


#: DoubleSidedMaxwell(loc, scale).
double_sided_maxwell = exact_density(_dsm_sample, _dsm_logpdf,
                                     "double_sided_maxwell")


def _moyal_sample(key, loc, scale):
    (loc, scale), shape = _params(key, loc, scale)
    u = random.uniform(key, shape)
    sqrt2 = torch.tensor(math.sqrt(2.0), dtype=torch.float32,
                         device=key.device)
    z = -2.0 * torch.log(random.erfinv_f32(1.0 - u) * sqrt2)
    return loc + scale * z


def _moyal_logpdf(v, loc, scale):
    v, loc, scale = _on(v, loc, scale)
    z = (v - loc) / scale
    return (-0.5 * (z + torch.exp(-z)) - 0.5 * math.log(2.0 * math.pi)
            - torch.log(scale))


#: Moyal(loc, scale), by the inverse CDF
#: ``F(z) = erfc(exp(-z/2)/√2)``.
moyal = exact_density(_moyal_sample, _moyal_logpdf, "moyal")


# ---------------------------------------------------------------------------
# Truncated, inverse Gaussian and von Mises
# ---------------------------------------------------------------------------


def _truncnorm_sample(key, loc, scale, low, high):
    (loc, scale, low, high), shape = _params(key, loc, scale, low, high)
    a = (low - loc) / scale
    b = (high - loc) / scale
    return loc + scale * random.truncated_normal(key, a, b, shape)


def _log_diff(x, y):
    """``log(exp(x) - exp(y))`` as ``logsumexp([x, y], b=[1, -1])``."""
    m = torch.maximum(x, y)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    return torch.log(torch.exp(x - m) - torch.exp(y - m)) + m


def _log_gauss_mass(a, b):
    """log of the standard normal's mass on (a, b), worked in the left
    tail (``jax.scipy.stats.truncnorm``)."""
    a, b = torch.broadcast_tensors(a, b)
    ndtr, log_ndtr = torch.special.ndtr, torch.special.log_ndtr
    left = _log_diff(log_ndtr(b), log_ndtr(a))
    right = _log_diff(log_ndtr(-a), log_ndtr(-b))
    central = torch.log1p(-ndtr(a) - ndtr(-b))
    return torch.where(b <= 0, left, torch.where(a > 0, right, central))


def _truncnorm_logpdf(v, loc, scale, low, high):
    v, loc, scale, low, high = _on(v, loc, scale, low, high)
    a = (low - loc) / scale
    b = (high - loc) / scale
    x = (v - loc) / scale
    one = torch.ones_like(x)
    val = _normal_logpdf(x, torch.zeros_like(x), one) - _log_gauss_mass(a, b)
    val = _neg_inf_where((x < a) | (x > b), val)
    return _nan_where(a >= b, val) - torch.log(scale)


#: TruncatedNormal(loc, scale, low, high).
truncated_normal = exact_density(
    _truncnorm_sample, _truncnorm_logpdf, "truncated_normal",
    support=lambda loc, scale, low, high: (low, high),
)


def _cauchy_cdf(z):
    return torch.arctan(z) / math.pi + 0.5


def _trunc_cauchy_sample(key, loc, scale, low, high):
    (loc, scale, low, high), shape = _params(key, loc, scale, low, high)
    fa = _cauchy_cdf((low - loc) / scale)
    fb = _cauchy_cdf((high - loc) / scale)
    u = random.uniform(key, shape)
    p = fa + u * (fb - fa)
    x = loc + scale * torch.tan(math.pi * (p - 0.5))
    # f32 rounding can carry the inverse CDF a few ulp past a bound, where
    # the log-density is -inf: clip to the open interval, as
    # jax.random.truncated_normal clips its draws (the JAX package's
    # truncated_cauchy does not).
    inf = torch.full_like(x, math.inf)
    return torch.clamp(x, torch.nextafter(low.expand_as(x), inf),
                       torch.nextafter(high.expand_as(x), -inf))


def _trunc_cauchy_logpdf(v, loc, scale, low, high):
    v, loc, scale, low, high = _on(v, loc, scale, low, high)
    fa = _cauchy_cdf((low - loc) / scale)
    fb = _cauchy_cdf((high - loc) / scale)
    lp = _cauchy_logpdf(v, loc, scale) - torch.log(fb - fa)
    return _neg_inf_where(~((v >= low) & (v <= high)), lp)


#: TruncatedCauchy(loc, scale, low, high), by the inverse CDF.
truncated_cauchy = exact_density(
    _trunc_cauchy_sample, _trunc_cauchy_logpdf, "truncated_cauchy",
    support=lambda loc, scale, low, high: (low, high),
)


def _inverse_gaussian_sample(key, loc, conc):
    # Michael–Schucany–Haas: exact, no rejection loop.
    (loc, conc), shape = _params(key, loc, conc)
    k_n, k_u = random.split(key).unbind(-2)
    nu = random.normal(k_n, shape)
    y = nu * nu
    x = (loc + loc * loc * y / (2.0 * conc)
         - loc / (2.0 * conc)
         * torch.sqrt(4.0 * loc * conc * y + loc * loc * y * y))
    u = random.uniform(k_u, shape)
    return torch.where(u <= loc / (loc + x), x, loc * loc / x)


def _inverse_gaussian_logpdf(v, loc, conc):
    v, loc, conc = _on(v, loc, conc)
    return (0.5 * torch.log(conc / (2.0 * math.pi)) - 1.5 * torch.log(v)
            - conc * (v - loc) ** 2 / (2.0 * loc * loc * v))


#: InverseGaussian(loc, concentration), TFP's convention.
inverse_gaussian = exact_density(_inverse_gaussian_sample,
                                 _inverse_gaussian_logpdf,
                                 "inverse_gaussian", support="positive")

#: Trips a rejection loop of this module takes at most before it gives
#: up (the JAX package's loops have no cap; one trip of each accepts
#: with probability above 1/2 at the parameters its tests use).
_MAX_TRIPS = 1000


def _rejection(key, trip, init):
    """A per-lane rejection loop with the JAX package's key schedule:
    ``trip(keys) -> (keys, accept, value)`` splits the key batch as the
    JAX loop's body does and draws one proposal per lane; a lane keeps
    its first accepted value (``init`` until then)."""
    done = torch.zeros(init.shape, dtype=torch.bool, device=init.device)
    out = init
    for _ in range(_MAX_TRIPS):
        key, accept, val = trip(key)
        out = torch.where(done, out, torch.where(accept, val, out))
        done = done | accept
        random.loops.trips += 1
        if not random.any_active(~done):
            return out
    raise RuntimeError("rejection loop did not finish")


def _von_mises_sample(key, loc, conc):
    """Best–Fisher wrapped-Cauchy rejection."""
    (loc, conc), shape = _params(key, loc, conc)
    conc = torch.broadcast_to(conc, tuple(key.shape[:-1]) + shape)
    r = 1.0 + torch.sqrt(1.0 + 4.0 * conc * conc)
    rho = (r - torch.sqrt(2.0 * r)) / (2.0 * conc)
    s = (1.0 + rho * rho) / (2.0 * rho)

    def trip(k):
        k, k1, k2, k3 = random.split(k, 4).unbind(-2)
        u1 = random.uniform(k1, shape)
        u2 = random.uniform(k2, shape)
        u3 = random.uniform(k3, shape)
        z = torch.cos(math.pi * u1)
        f = (1.0 + s * z) / (s + z)
        c = conc * (s - f)
        accept = (c * (2.0 - c) - u2 > 0.0) | (
            torch.log(c / u2) + 1.0 - c >= 0.0)
        val = torch.sign(u3 - 0.5) * torch.arccos(torch.clamp(f, -1.0, 1.0))
        return k, accept, val

    theta = _rejection(key, trip, torch.zeros_like(conc))
    return torch.remainder(theta + loc + math.pi, 2.0 * math.pi) - math.pi


def _von_mises_logpdf(v, loc, conc):
    v, loc, conc = _on(v, loc, conc)
    return (conc * torch.cos(v - loc) - math.log(2.0 * math.pi)
            - torch.log(torch.special.i0e(conc)) - conc)


#: VonMises(loc, concentration).
von_mises = exact_density(_von_mises_sample, _von_mises_logpdf, "von_mises")


# ---------------------------------------------------------------------------
# Discrete distributions
# ---------------------------------------------------------------------------


def _poisson_sample(key, rate):
    (rate,), shape = _params(key, rate)
    return random.poisson(key, rate, shape)


#: Poisson(rate); draws are int32, JAX's key for key.
poisson = exact_density(_poisson_sample,
                        lambda v, rate: _poisson_logpmf(*_on(v, rate)),
                        "poisson")


def _binomial_sample(key, n, p):
    (n, p), shape = _params(key, n, p)
    return random.binomial(key, n, p, shape)


def _binomial_logpmf(v, n, p):
    y, n, p = _on(v, n, p)
    comb = torch.lgamma(n + 1) - (torch.lgamma(y + 1)
                                  + torch.lgamma(n - y + 1))
    log_linear = _xlogy(y, p) + _xlog1py(n - y, -p)
    lp = comb + log_linear
    lp = torch.where(((y == 0) & (n == 0)) | (log_linear == 0),
                     torch.zeros_like(lp), lp)
    return _neg_inf_where(~((y >= 0) & (y < n + 1)), lp)


#: Binomial(total_count, probs); draws are f32 counts, JAX's key for key.
binomial = exact_density(_binomial_sample, _binomial_logpmf, "binomial")


def _beta_binomial_sample(key, n, c1, c0):
    (n, c1, c0), shape = _params(key, n, c1, c0)
    k1, k2 = random.split(key).unbind(-2)
    p = random.beta(k1, c1, c0, shape)
    return random.binomial(k2, n, p, shape)


def _beta_binomial_logpmf(v, n, c1, c0):
    k, n, a, b = _on(v, n, c1, c0)
    y = torch.floor(k)
    comb = -(torch.log1p(n) + _betaln_cdflib(n - y + 1.0, y + 1.0))
    lp = comb + (_betaln_cdflib(y + a, n - y + b) - _betaln_cdflib(a, b))
    lp = torch.where((y == 0) & (n == 0), torch.zeros_like(lp), lp)
    lp = _neg_inf_where((y < 0) | (y > n) | (y + a <= 0), lp)
    return _nan_where((n < 0) | (a <= 0) | (b <= 0), lp)


#: BetaBinomial(total_count, concentration1, concentration0).
beta_binomial = exact_density(_beta_binomial_sample, _beta_binomial_logpmf,
                              "beta_binomial")


def _negative_binomial_sample(key, n, p):
    # Gamma–Poisson mixture; p is the probability of a counted event
    # (TFP's convention: pmf(k) ∝ p^k (1-p)^n).
    (n, p), shape = _params(key, n, p)
    k1, k2 = random.split(key).unbind(-2)
    lam = random.gamma(k1, n, shape) * p / (1.0 - p)
    return random.poisson(k2, lam, shape)


def _negative_binomial_logpmf(v, n, p):
    v, n, p = _on(v, n, p)
    return (torch.lgamma(v + n) - torch.lgamma(n) - torch.lgamma(v + 1.0)
            + _xlogy(v, p) + _xlog1py(n, -p))


#: NegativeBinomial(total_count, probs), TFP's convention.
negative_binomial = exact_density(_negative_binomial_sample,
                                  _negative_binomial_logpmf,
                                  "negative_binomial")


def _nc_chi2_sample(key, df, nc):
    # Poisson mixture: X ~ Chi2(df + 2K), K ~ Poisson(nc/2).
    (df, nc), shape = _params(key, df, nc)
    k1, k2 = random.split(key).unbind(-2)
    kk = random.poisson(k1, nc / 2.0, shape)
    return random.chisquare(k2, df + 2.0 * kk, shape)


def _nc_chi2_logpdf(v, df, nc):
    # The Poisson-weighted chi-square densities, 64 terms.
    v, df, nc = _last(*_on(v, df, nc))
    ks = torch.arange(64.0, device=v.device)
    logw = _poisson_logpmf(ks, nc / 2.0)
    return torch.logsumexp(logw + _chi2_logpdf(v, df + 2.0 * ks), dim=-1)


#: NonCentralChi2(df, noncentrality), the Poisson-mixture representation.
non_central_chi2 = exact_density(_nc_chi2_sample, _nc_chi2_logpdf,
                                 "non_central_chi2")


def _skellam_sample(key, mu1, mu2):
    (mu1, mu2), shape = _params(key, mu1, mu2)
    k1, k2 = random.split(key).unbind(-2)
    return (random.poisson(k1, mu1, shape)
            - random.poisson(k2, mu2, shape)).to(torch.int32)


def _skellam_logpmf(v, mu1, mu2):
    # The Poisson convolution, 128 terms.
    v, mu1, mu2 = _last(*_on(v, mu1, mu2))
    ks = torch.arange(128.0, device=v.device)
    zero = torch.zeros_like(v)
    lp = (_poisson_logpmf(ks + torch.maximum(v, zero), mu1)
          + _poisson_logpmf(ks + torch.maximum(-v, zero), mu2))
    return torch.logsumexp(lp, dim=-1)


#: Skellam(rate1, rate2): the difference of two independent Poissons.
skellam = exact_density(_skellam_sample, _skellam_logpmf, "skellam")


def _zipf_sample(key, power):
    # Devroye's rejection-inversion.
    (power,), shape = _params(key, power)
    b = 2.0 ** (power - 1.0)

    def trip(k):
        k, k1, k2 = random.split(k, 3).unbind(-2)
        u = random.uniform(k1, shape)
        v = random.uniform(k2, shape)
        x = torch.floor(u ** (-1.0 / (power - 1.0)))
        t = (1.0 + 1.0 / x) ** (power - 1.0)
        accept = (x >= 1.0) & (v * x * (t - 1.0) / (b - 1.0) <= t / b)
        return k, accept, x

    init = torch.ones(tuple(key.shape[:-1]) + shape, device=key.device)
    return _rejection(key, trip, init).to(torch.int32)


def _zipf_logpmf(v, power):
    v, power = _on(v, power)
    return -power * torch.log(v) - torch.log(
        torch.special.zeta(power, torch.ones_like(power)))


#: Zipf(power), power > 1, support {1, 2, ...}.
zipf = exact_density(_zipf_sample, _zipf_logpmf, "zipf")


# ---------------------------------------------------------------------------
# Multivariate and tail distributions
# ---------------------------------------------------------------------------


def _multinomial_sample(key, n, logits):
    logits, n = _f(logits, key.device), _f(n, key.device)
    return random.multinomial(key, n, torch.softmax(logits, dim=-1))


def _multinomial_logpmf(v, n, logits):
    v, n, logits = _on(v, n, logits)
    logp = torch.log_softmax(logits, dim=-1)
    return (torch.lgamma(n + 1.0) - torch.lgamma(v + 1.0).sum(-1)
            + (v * logp).sum(-1))


#: Multinomial(total_count, logits); draws are f32 counts.
multinomial = exact_density(_multinomial_sample, _multinomial_logpmf,
                            "multinomial", event_rank=1)


def _dirichlet_multinomial_sample(key, n, conc):
    conc, n = _f(conc, key.device), _f(n, key.device)
    k1, k2 = random.split(key).unbind(-2)
    p = random.dirichlet(k1, conc, random.event_shape(k1, conc[..., 0]))
    return random.multinomial(k2, n, p)


def _dirichlet_multinomial_logpmf(v, n, conc):
    v, n, c = _on(v, n, conc)
    c0 = c.sum(-1)
    return (torch.lgamma(n + 1.0) + torch.lgamma(c0) - torch.lgamma(n + c0)
            + (torch.lgamma(v + c) - torch.lgamma(v + 1.0)
               - torch.lgamma(c)).sum(-1))


#: DirichletMultinomial(total_count, concentration).
dirichlet_multinomial = exact_density(_dirichlet_multinomial_sample,
                                      _dirichlet_multinomial_logpmf,
                                      "dirichlet_multinomial", event_rank=1)


def _beta_quotient_sample(key, a1, b1, a2, b2):
    (a1, b1, a2, b2), shape = _params(key, a1, b1, a2, b2)
    k1, k2 = random.split(key).unbind(-2)
    return random.beta(k1, a1, b1, shape) / random.beta(k2, a2, b2, shape)


def _beta_quotient_logpdf(t, a1, b1, a2, b2):
    # The density of X/Y, X ~ Beta(a1, b1), Y ~ Beta(a2, b2) (Pham-Gia
    # 2000), through 2F1 on each side of t = 1.
    t, a1, b1, a2, b2 = _on(t, a1, b1, a2, b2)

    def log_b(a, b):
        return torch.lgamma(a) + torch.lgamma(b) - torch.lgamma(a + b)

    log_z = log_b(a1, b1) + log_b(a2, b2)
    t_lo = torch.clamp(t, max=1.0)
    lo = (log_b(a1 + a2, b1) + (a1 - 1.0) * torch.log(t_lo)
          + torch.log(hyp2f1(a1 + a2, 1.0 - b2, a1 + a2 + b1, t_lo)) - log_z)
    t_hi = torch.clamp(t, min=1.0)
    s = torch.clamp(1.0 / t_hi, max=1.0)
    hi = (log_b(a2 + a1, b2) + (a2 - 1.0) * torch.log(s)
          + torch.log(hyp2f1(a2 + a1, 1.0 - b1, a2 + a1 + b2, s)) - log_z
          - 2.0 * torch.log(t_hi))
    return torch.where(t <= 1.0, lo, hi)


#: BetaQuotient(a1, b1, a2, b2): the ratio of two independent Betas.
beta_quotient = exact_density(_beta_quotient_sample, _beta_quotient_logpdf,
                              "beta_quotient", support="positive")


def _lambert_w_normal_sample(key, loc, scale, tailweight):
    (loc, scale, tailweight), shape = _params(key, loc, scale, tailweight)
    u = random.normal(key, shape)
    return loc + scale * (u * torch.exp(tailweight * u * u / 2.0))


def _lambert_w_normal_logpdf(y, loc, scale, tailweight):
    y, loc, scale, d = _on(y, loc, scale, tailweight)
    z = (y - loc) / scale
    # The inverse transform u = sign(z) sqrt(W(d z²)/d), and
    # dz/du = e^{d u²/2} (1 + d u²).
    w = lambertw(d * z * z)
    u = torch.sign(z) * torch.sqrt(torch.clamp(
        w / torch.clamp(d, min=1e-12), min=0.0))
    u = torch.where(d == 0.0, z, u)
    jac = torch.exp(d * u * u / 2.0) * (1.0 + d * u * u)
    return (_normal_logpdf(u, torch.zeros_like(u), torch.ones_like(u))
            - torch.log(torch.clamp(jac, min=1e-30)) - torch.log(scale))


#: LambertWNormal(loc, scale, tailweight): a heavy-tailed Gaussian by the
#: Lambert W x Gaussian transform (Goerg 2011).
lambert_w_normal = exact_density(_lambert_w_normal_sample,
                                 _lambert_w_normal_logpdf,
                                 "lambert_w_normal")


def _householder_rotate(y, mu):
    """Map samples about e1 to samples about ``mu`` by the Householder
    reflection that takes e1 to ``mu`` (per execution)."""
    e1 = torch.zeros(mu.shape[-1], dtype=mu.dtype, device=mu.device)
    e1[0] = 1.0
    u = e1 - mu
    norm = torch.sqrt((u * u).sum(-1, keepdim=True))
    far = norm > 1e-9
    u = torch.where(far, u / torch.clamp(norm, min=1e-9), u)
    return torch.where(far, y - 2.0 * (u * y).sum(-1, keepdim=True) * u, y)


def _unit_tangent(key, lead: tuple, d: int, w):
    """``[w, sqrt(1 - w²) v]`` with ``v`` a uniform direction in
    ``d - 1`` dimensions."""
    v = random.normal(key, lead + (d - 1,))
    v = v / torch.clamp(torch.sqrt((v * v).sum(-1, keepdim=True)), min=1e-12)
    return torch.cat([w[..., None], torch.sqrt(1.0 - w * w)[..., None] * v],
                     dim=-1)


def _power_spherical_sample(key, mu, conc):
    # De Cao & Aziz 2020: exact sampling through a transformed Beta.
    mu, conc = _f(mu, key.device), _f(conc, key.device)
    d = mu.shape[-1]
    shape = random.event_shape(key, mu[..., 0], conc)
    alpha = (d - 1.0) / 2.0 + conc
    beta_ = (d - 1.0) / 2.0
    k1, k2 = random.split(key).unbind(-2)
    t = 2.0 * random.beta(k1, alpha, beta_, shape) - 1.0
    return _householder_rotate(_unit_tangent(k2, shape, d, t), mu)


def _power_spherical_logpdf(x, mu, conc):
    x, mu, conc = _on(x, mu, conc)
    d = mu.shape[-1]
    alpha = (d - 1.0) / 2.0 + conc
    beta_ = (d - 1.0) / 2.0
    log_c = -((alpha + beta_) * _LOG2 + torch.lgamma(alpha)
              - torch.lgamma(alpha + beta_) + beta_ * math.log(math.pi))
    return log_c + conc * torch.log1p((mu * x).sum(-1))


#: PowerSpherical(mean_direction, concentration) on S^{d-1}.
power_spherical = exact_density(_power_spherical_sample,
                                _power_spherical_logpdf, "power_spherical",
                                event_rank=1)


def _vmf_sample(key, mu, conc):
    """Wood (1994): rejection on the first coordinate, then the
    Householder rotation."""
    mu, conc = _f(mu, key.device), _f(conc, key.device)
    d = mu.shape[-1]
    shape = random.event_shape(key, mu[..., 0], conc)
    conc = torch.broadcast_to(conc, tuple(key.shape[:-1]) + shape)
    k_w, k_v = random.split(key).unbind(-2)
    b = (-2.0 * conc + torch.sqrt(4.0 * conc * conc + (d - 1.0) ** 2)) / (
        d - 1.0)
    x0 = (1.0 - b) / (1.0 + b)
    c = conc * x0 + (d - 1.0) * torch.log(1.0 - x0 * x0)

    def trip(k):
        k, kz, ku = random.split(k, 3).unbind(-2)
        z = random.beta(kz, (d - 1.0) / 2.0, (d - 1.0) / 2.0, shape)
        u = random.uniform(ku, shape)
        w_prop = (1.0 - (1.0 + b) * z) / (1.0 - (1.0 - b) * z)
        accept = conc * w_prop + (d - 1.0) * torch.log(torch.clamp(
            1.0 - x0 * w_prop, min=1e-30)) - c >= torch.log(u)
        return k, accept, w_prop

    w = _rejection(k_w, trip, torch.zeros_like(conc))
    return _householder_rotate(_unit_tangent(k_v, shape, d, w), mu)


def _vmf_logpdf(x, mu, conc):
    x, mu, conc = _on(x, mu, conc)
    d = mu.shape[-1]
    nu = d / 2.0 - 1.0
    log_c = (nu * torch.log(torch.clamp(conc, min=1e-30))
             - (d / 2.0) * math.log(2.0 * math.pi) - log_bessel_iv(nu, conc))
    return log_c + conc * (mu * x).sum(-1)


#: VonMisesFisher(mean_direction, concentration) on S^{d-1}.
von_mises_fisher = exact_density(_vmf_sample, _vmf_logpdf, "von_mises_fisher",
                                 event_rank=1)
