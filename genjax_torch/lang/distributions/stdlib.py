"""The distributions of the ported paths: normal, beta, gamma, flip /
bernoulli, uniform, categorical, geometric, dirichlet, mv_normal_diag
and mv_normal (counterpart of
``genjax_tpu/lang/distributions/stdlib.py``; the rest of its ~45
distributions are not ported yet). Parameterizations follow the JAX
package: ``flip`` takes probs, ``bernoulli`` and ``categorical`` logits.

Every sampler takes a key batch ``B + (2,)`` and draws one value per key
(``core/random.py``); every log-density is elementwise and broadcasts.
"""

from __future__ import annotations

import math

import torch

from genjax_torch.core import random
from genjax_torch.lang.distributions.distribution import exact_density

__all__ = ["bernoulli", "beta", "categorical", "dirichlet", "flip", "gamma",
           "geometric", "mv_normal", "mv_normal_diag", "normal", "uniform"]


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
bernoulli = exact_density(_bernoulli_sample, _bernoulli_logits_logpmf,
                          "bernoulli")


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
categorical = exact_density(_categorical_sample, _categorical_logpmf,
                            "categorical")


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
