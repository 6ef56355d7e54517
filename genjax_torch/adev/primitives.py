"""ADEV gradient strategies: score function (REINFORCE), exact
enumeration, measure-valued derivatives, reparameterization, implicit
reparameterization and variance reduction (counterpart of
``genjax_tpu/adev/primitives.py``), on the port's functional keys.

Every sampler draws one value per key of a key batch ``B + (2,)``, and
every strategy's ``key`` is the interpreter's batch ``E + (2,)`` of
executions; a log-density in a score-function term is summed over every
axis behind ``E`` (the event, and the lanes of a lifted site).

``GammaIMPLICIT`` and ``DirichletIMPLICIT`` take the implicit derivative
``dz/dα = −(∂F/∂α)/p(z; α)`` of a standard gamma draw ``z`` from
``torch._standard_gamma_grad``: the port's gamma draws come from its own
rejection loop, which carries no derivative, where the JAX package
differentiates ``jax.random.gamma`` through XLA's ``RandomGammaGrad``.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from genjax_torch.adev.core import (
    ADEVPrimitive,
    Dual,
    TailCallADEVPrimitive,
    jvp,
    _tangent_of,
)
from genjax_torch.core import random
from genjax_torch.core.pytree import Pytree, event_sum
from genjax_torch.lang.distributions import stdlib

__all__ = [
    "REINFORCE",
    "reinforce",
    "FlipEnum",
    "FlipEnumParallel",
    "FlipMVD",
    "CategoricalEnumParallel",
    "NormalREPARAM",
    "MvNormalDiagREPARAM",
    "MvNormalREPARAM",
    "UniformREPARAM",
    "BetaIMPLICIT",
    "GammaIMPLICIT",
    "DirichletIMPLICIT",
    "Baseline",
    "baseline",
    "AddCost",
    "add_cost",
    "flip_enum",
    "flip_enum_parallel",
    "flip_mvd",
    "flip_reinforce",
    "categorical_enum_parallel",
    "geometric_reinforce",
    "normal_reinforce",
    "normal_reparam",
    "mv_normal_diag_reparam",
    "mv_normal_reparam",
    "uniform",
    "beta_implicit",
    "gamma_implicit",
    "dirichlet_implicit",
]


def _f(x, device=None) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x if x.is_floating_point() else x.to(torch.float32)
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def _split(key):
    return random.split(key).unbind(-2)


def _tangents(dual_args) -> tuple:
    return tuple(d.tangent for d in dual_args)


def _rank(key) -> int:
    return key.ndim - 1


@Pytree.dataclass
class REINFORCE(ADEVPrimitive):
    """Score-function estimator: ``∇E[f] ≈ ∇f + f·∇log p``."""

    sample_function: Callable = Pytree.static()
    differentiable_logpdf: Callable = Pytree.static()

    def sample(self, key, *args):
        return self.sample_function(key, *args)

    def jvp_estimate(self, key, dual_args, konts):
        _, kdual = konts
        primals = Dual.tree_primal(dual_args)
        key, sub_key = _split(key)
        v = self.sample(sub_key, *primals)
        out = kdual(key, Dual.tree_pure(v))
        # The score term differentiates log p(v; params) in the params
        # only (v held fixed), summed over every axis behind the batch.
        _, lp_tangent = jvp(
            lambda *params: event_sum(
                self.differentiable_logpdf(v, *params), _rank(key)),
            primals, _tangents(dual_args))
        return Dual(out.primal,
                    _tangent_of(out) + out.primal * lp_tangent)


def reinforce(sample_func, logpdf_func) -> REINFORCE:
    return REINFORCE(sample_func, logpdf_func)


_flip_sample = stdlib.flip.sample


def _flip_values(key, p):
    """All-True and all-False values of a flip site's shape."""
    shape = tuple(key.shape[:-1]) + random.event_shape(key, p)
    ones = torch.ones(shape, dtype=torch.bool, device=key.device)
    return ones, ~ones


def _flip_support(p):
    return torch.tensor([True, False])


def _flip_probs(p):
    p = _f(p)
    return torch.stack([p, 1.0 - p], dim=-1)


@Pytree.dataclass
class FlipEnum(ADEVPrimitive):
    """Exact enumeration over {True, False}; both branches' continuations
    run on the same key."""

    def sample(self, key, p):
        return _flip_sample(key, p)

    def enum_support(self, p):
        return _flip_support(p)

    def enum_probs(self, p):
        return _flip_probs(p)

    def jvp_estimate(self, key, dual_args, konts):
        _, kdual = konts
        (p_dual,) = dual_args
        t_val, f_val = _flip_values(key, p_dual.primal)
        true_dual = kdual(key, Dual.tree_pure(t_val))
        false_dual = kdual(key, Dual.tree_pure(f_val))
        out_primal, out_tangent = jvp(
            lambda p, tl, fl: p * tl + (1.0 - p) * fl,
            (_f(p_dual.primal), true_dual.primal, false_dual.primal),
            (p_dual.tangent, true_dual.tangent, false_dual.tangent))
        return Dual(out_primal, out_tangent)


@Pytree.dataclass
class FlipEnumParallel(ADEVPrimitive):
    """Enumeration with each branch's continuation on its own key
    (``split(key, 2)``)."""

    def sample(self, key, p):
        return _flip_sample(key, p)

    def enum_support(self, p):
        return _flip_support(p)

    def enum_probs(self, p):
        return _flip_probs(p)

    def jvp_estimate(self, key, dual_args, konts):
        _, kdual = konts
        (p_dual,) = dual_args
        sub_keys = random.split(key, 2)
        vals = _flip_values(key, p_dual.primal)
        outs = [kdual(sub_keys[..., i, :], Dual.tree_pure(v))
                for i, v in enumerate(vals)]
        out_primal, out_tangent = jvp(
            lambda p, r0, r1: p * r0 + (1.0 - p) * r1,
            (_f(p_dual.primal), outs[0].primal, outs[1].primal),
            (p_dual.tangent, outs[0].tangent, outs[1].tangent))
        return Dual(out_primal, out_tangent)


@Pytree.dataclass
class FlipMVD(ADEVPrimitive):
    """Measure-valued derivative for a flip: the difference of the pure
    continuation at the sampled value and at its negation."""

    def sample(self, key, p):
        return _flip_sample(key, p)

    def jvp_estimate(self, key, dual_args, konts):
        kpure, kdual = konts
        (p_dual,) = dual_args
        p = p_dual.primal
        key, sub_key = _split(key)
        b = _flip_sample(sub_key, p)
        out = kdual(key, Dual.tree_pure(b))
        other = kpure(key, torch.logical_not(b))
        est = torch.where(b, 1.0, -1.0) * (out.primal - other)
        return Dual(out.primal, _tangent_of(out)
                    + est * _tangent_of(p_dual))


@Pytree.dataclass
class CategoricalEnumParallel(ADEVPrimitive):
    """Exact enumeration over a categorical's support (logits), each
    branch's continuation on its own key (``split(key, n)``)."""

    def sample(self, key, logits):
        return random.categorical(key, logits)

    def enum_support(self, logits):
        return torch.arange(logits.shape[-1])

    def enum_probs(self, logits):
        return torch.softmax(_f(logits), dim=-1)

    def jvp_estimate(self, key, dual_args, konts):
        _, kdual = konts
        (logits_dual,) = dual_args
        logits = _f(logits_dual.primal)
        n = logits.shape[-1]
        sub_keys = random.split(key, n)
        shape = tuple(key.shape[:-1]) + random.event_shape(key,
                                                           logits[..., 0])
        outs = [kdual(sub_keys[..., i, :], Dual.tree_pure(
            torch.full(shape, i, dtype=torch.int64, device=key.device)))
            for i in range(n)]
        rp = torch.stack([o.primal for o in outs], dim=-1)
        rt = torch.stack([_tangent_of(o) for o in outs], dim=-1)
        out_primal, out_tangent = jvp(
            lambda lg, r: (torch.softmax(lg, dim=-1) * r).sum(-1),
            (logits, rp), (logits_dual.tangent, rt))
        return Dual(out_primal, out_tangent)


def _shape(key, *params) -> tuple:
    return random.event_shape(key, *(_f(p) for p in params))


@Pytree.dataclass
class NormalREPARAM(TailCallADEVPrimitive):
    """Reparameterized Normal(loc, scale): ``loc + scale·eps``."""

    def sample(self, key, loc, scale):
        loc, scale = _f(loc, key.device), _f(scale, key.device)
        return loc + scale * random.normal(key, _shape(key, loc, scale))

    def before_tail_call(self, key, dual_args):
        loc_dual, scale_dual = dual_args
        key, sub_key = _split(key)
        eps = random.normal(sub_key, _shape(sub_key, loc_dual.primal,
                                            scale_dual.primal))
        primal, tangent = jvp(lambda loc, scale: loc + scale * eps,
                              (_f(loc_dual.primal), _f(scale_dual.primal)),
                              _tangents(dual_args))
        return Dual(primal, tangent)


@Pytree.dataclass
class MvNormalDiagREPARAM(TailCallADEVPrimitive):
    def sample(self, key, loc, scale_diag):
        loc, scale = _f(loc, key.device), _f(scale_diag, key.device)
        return loc + scale * random.normal(key, _shape(key, loc))

    def before_tail_call(self, key, dual_args):
        loc_dual, diag_dual = dual_args
        key, sub_key = _split(key)
        eps = random.normal(sub_key, _shape(sub_key, loc_dual.primal))
        primal, tangent = jvp(lambda loc, diag: loc + diag * eps,
                              (_f(loc_dual.primal), _f(diag_dual.primal)),
                              _tangents(dual_args))
        return Dual(primal, tangent)


def _mvn_transform(eps):
    def transform(loc, cov):
        factor = torch.linalg.cholesky(cov)
        return loc + (factor @ eps[..., None])[..., 0]

    return transform


@Pytree.dataclass
class MvNormalREPARAM(TailCallADEVPrimitive):
    """Full-covariance reparameterization through the Cholesky factor."""

    def sample(self, key, loc, cov):
        loc, cov = _f(loc, key.device), _f(cov, key.device)
        return _mvn_transform(random.normal(key, _shape(key, loc)))(loc, cov)

    def before_tail_call(self, key, dual_args):
        loc_dual, cov_dual = dual_args
        key, sub_key = _split(key)
        eps = random.normal(sub_key, _shape(sub_key, loc_dual.primal))
        primal, tangent = jvp(_mvn_transform(eps),
                              (_f(loc_dual.primal), _f(cov_dual.primal)),
                              _tangents(dual_args))
        return Dual(primal, tangent)


@Pytree.dataclass
class UniformREPARAM(TailCallADEVPrimitive):
    """Uniform(0, 1): no parameters, a zero tangent."""

    def sample(self, key):
        return random.uniform(key, ())

    def before_tail_call(self, key, dual_args):
        key, sub_key = _split(key)
        u = random.uniform(sub_key, ())
        return Dual(u, torch.zeros_like(u))


#: The 64-node Gauss-Legendre rule on (0, 1), as numpy gives it.
_GL64_NODES, _GL64_WEIGHTS = np.polynomial.legendre.leggauss(64)
_GL64_U = (_GL64_NODES + 1.0) / 2.0
_GL64_W = _GL64_WEIGHTS / 2.0


def _beta_cdf_param_partials(x, a, b):
    """``(∂F/∂a, ∂F/∂b)`` of the Beta CDF at ``x`` by Gauss-Legendre
    quadrature of ``∂F/∂a = ∫₀ˣ f(t)[ln t − (ψ(a) − ψ(a+b))] dt`` (and
    its mirror in ``b``)."""
    u = torch.as_tensor(_GL64_U, dtype=torch.float32, device=x.device)
    w = torch.as_tensor(_GL64_W, dtype=torch.float32, device=x.device)
    x, a, b = (torch.broadcast_tensors(x, a, b))
    xe, ae, be = x[..., None], a[..., None], b[..., None]
    t = xe * u
    log_f = ((ae - 1.0) * torch.log(t) + (be - 1.0) * torch.log1p(-t)
             - (torch.lgamma(ae) + torch.lgamma(be) - torch.lgamma(ae + be)))
    f = torch.exp(log_f)
    psi_ab = torch.digamma(ae + be)
    dfda = x * (w * f * (torch.log(t) - (torch.digamma(ae) - psi_ab))).sum(-1)
    dfdb = x * (w * f * (torch.log1p(-t) - (torch.digamma(be) - psi_ab))
                ).sum(-1)
    return dfda, dfdb


@Pytree.dataclass
class BetaIMPLICIT(TailCallADEVPrimitive):
    """Beta(a, b) by implicit reparameterization (Figurnov et al. 2018):
    ``dx/dθ = −(∂F/∂θ)/p(x; θ)``, the CDF's parameter partials by
    quadrature."""

    def sample(self, key, a, b):
        a, b = _f(a, key.device), _f(b, key.device)
        return random.beta(key, a, b, _shape(key, a, b))

    def before_tail_call(self, key, dual_args):
        a_dual, b_dual = dual_args
        key, sub_key = _split(key)
        a, b = _f(a_dual.primal), _f(b_dual.primal)
        x = random.beta(sub_key, a, b, _shape(sub_key, a, b))
        dfda, dfdb = _beta_cdf_param_partials(x, a, b)
        pdf = torch.exp(stdlib.beta.logpdf(x, a, b))
        denom = torch.clamp(pdf, min=1e-30)
        x_tan = -(dfda * _tangent_of(a_dual)
                  + dfdb * _tangent_of(b_dual)) / denom
        return Dual(x, x_tan)


def _standard_gamma_dual(key, alpha_dual, shape):
    """A standard gamma draw ``z`` and its implicit tangent in ``alpha``."""
    alpha = _f(alpha_dual.primal)
    z = random.gamma(key, alpha, shape)
    a = alpha.expand(z.shape)
    dz = torch._standard_gamma_grad(a, z)
    return z, dz * _tangent_of(alpha_dual)


@Pytree.dataclass
class GammaIMPLICIT(TailCallADEVPrimitive):
    """Gamma(shape, rate) by implicit reparameterization in the shape;
    the rate enters pathwise as ``x = z / rate``."""

    def sample(self, key, shape, rate):
        shape, rate = _f(shape, key.device), _f(rate, key.device)
        return random.gamma(key, shape, _shape(key, shape, rate)) / rate

    def before_tail_call(self, key, dual_args):
        shape_dual, rate_dual = dual_args
        key, sub_key = _split(key)
        z, z_tan = _standard_gamma_dual(
            sub_key, shape_dual, _shape(sub_key, shape_dual.primal,
                                        rate_dual.primal))
        primal, tangent = jvp(lambda z, r: z / r,
                              (z, _f(rate_dual.primal)),
                              (z_tan, rate_dual.tangent))
        return Dual(primal, tangent)


@Pytree.dataclass
class DirichletIMPLICIT(TailCallADEVPrimitive):
    """Dirichlet(alpha) as normalized gammas ``z / Σz``, each
    ``z_i ~ Gamma(alpha_i, 1)`` with its implicit shape tangent."""

    def sample(self, key, alpha):
        return random.dirichlet(key, _f(alpha, key.device),
                                _shape(key, _f(alpha)[..., 0]))

    def before_tail_call(self, key, dual_args):
        (alpha_dual,) = dual_args
        key, sub_key = _split(key)
        alpha = _f(alpha_dual.primal)
        z, z_tan = _standard_gamma_dual(
            sub_key, alpha_dual,
            _shape(sub_key, alpha[..., 0]) + tuple(alpha.shape[-1:]))
        primal, tangent = jvp(lambda z: z / z.sum(-1, keepdim=True),
                              (z,), (z_tan,))
        return Dual(primal, tangent)


@Pytree.dataclass
class Baseline(ADEVPrimitive):
    """REINFORCE with a control variate ``b`` subtracted from the
    continuation's value in the score term; takes ``(b, *args)``."""

    prim: REINFORCE

    def sample(self, key, b, *args):
        return self.prim.sample(key, *args)

    def jvp_estimate(self, key, dual_args, konts):
        _, kdual = konts
        b_dual, *rest = dual_args
        primals = Dual.tree_primal(tuple(rest))
        key, sub_key = _split(key)
        v = self.prim.sample(sub_key, *primals)
        out = kdual(key, Dual.tree_pure(v))
        _, lp_tangent = jvp(
            lambda *params: event_sum(
                self.prim.differentiable_logpdf(v, *params), _rank(key)),
            primals, _tangents(rest))
        return Dual(out.primal, _tangent_of(out)
                    + (out.primal - b_dual.primal) * lp_tangent)


def baseline(prim: REINFORCE) -> Baseline:
    return Baseline(prim)


@Pytree.dataclass
class AddCost(ADEVPrimitive):
    """Adds a differentiable cost to the expected loss. The handler adds
    it inline (the continuation is linear in it), which is what
    :meth:`jvp_estimate` computes."""

    #: Marks the site's argument as a loss contribution, which the pure
    #: continuation adds to its value too.
    is_cost = True

    def sample(self, key, w):
        return w

    def jvp_estimate(self, key, dual_args, konts):
        _, kdual = konts
        (w_dual,) = dual_args
        out = kdual(key, w_dual)
        return Dual(w_dual.primal + out.primal,
                    _tangent_of(w_dual) + _tangent_of(out))


def add_cost(w):
    """Inside an ``@expectation`` program: add ``w`` to the expected
    loss."""
    AddCost()(w)


# -- instances ----------------------------------------------------------------

flip_enum = FlipEnum()
flip_enum_parallel = FlipEnumParallel()
flip_mvd = FlipMVD()
categorical_enum_parallel = CategoricalEnumParallel()
normal_reparam = NormalREPARAM()
mv_normal_diag_reparam = MvNormalDiagREPARAM()
mv_normal_reparam = MvNormalREPARAM()
uniform = UniformREPARAM()
beta_implicit = BetaIMPLICIT()
gamma_implicit = GammaIMPLICIT()
dirichlet_implicit = DirichletIMPLICIT()


flip_reinforce = reinforce(stdlib.flip.sample, stdlib.flip.logpdf)
geometric_reinforce = reinforce(stdlib.geometric.sample,
                                stdlib.geometric.logpdf)
# The sampler draws eps over the parameters' shape, so that every
# component is its own draw, as the summed log-density scores it.
normal_reinforce = reinforce(stdlib.normal.sample, stdlib.normal.logpdf)
