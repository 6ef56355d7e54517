"""Variational inference through ADEV (counterpart of
``genjax_tpu/inference/vi.py``): guide-side distributions that carry a
gradient strategy, and the loss-gradient estimators ELBO, IWELBO, PWake
and QWake, each an ``@expectation`` program.

A key batch ``E + (2,)`` runs ``E`` independent estimates at once, every
tensor argument leading with ``E``; IWELBO's particles are lanes inside
the program (``ImportanceK`` puts them behind ``E``).
"""

from __future__ import annotations

from typing import Any, Callable

from genjax_torch.adev import primitives as adev_prims
from genjax_torch.adev.core import ADEVPrimitive, expectation, sample_primitive
from genjax_torch.core import random
from genjax_torch.lang.distributions import stdlib
from genjax_torch.lang.distributions.distribution import (
    ExactDensity,
    exact_density,
)
from genjax_torch.inference.smc import Importance, ImportanceK
from genjax_torch.inference.sp import SampleDistribution, Target

__all__ = [
    "adev_distribution",
    "ELBO",
    "IWELBO",
    "PWake",
    "QWake",
    "flip_enum",
    "flip_mvd",
    "flip_reinforce",
    "categorical_enum",
    "normal_reinforce",
    "normal_reparam",
    "mv_normal_diag_reparam",
    "mv_normal_reparam",
    "geometric_reinforce",
    "beta_implicit",
    "gamma_implicit",
    "dirichlet_implicit",
]


def adev_distribution(adev_primitive: ADEVPrimitive,
                      differentiable_logpdf: Callable,
                      name: str, event_rank: int = 0) -> ExactDensity:
    """An ``ExactDensity`` whose sampler is a sample site of
    ``adev_primitive``, so that a ``@gen`` guide's randomness carries a
    gradient strategy. ``differentiable_logpdf`` is elementwise (or
    summed over one value's ``event_rank`` axes); the event is summed."""

    def sampler(key, *args):
        return sample_primitive(adev_primitive, *args, key=key)

    return exact_density(sampler, differentiable_logpdf, name,
                         event_rank=event_rank)


def _logpdf_of(dist) -> Callable:
    return lambda v, *args: dist.logpdf(v, *args)


flip_enum = adev_distribution(
    adev_prims.flip_enum, _logpdf_of(stdlib.flip), "flip_enum")
flip_mvd = adev_distribution(
    adev_prims.flip_mvd, _logpdf_of(stdlib.flip), "flip_mvd")
flip_reinforce = adev_distribution(
    adev_prims.flip_reinforce, _logpdf_of(stdlib.flip), "flip_reinforce")
categorical_enum = adev_distribution(
    adev_prims.categorical_enum_parallel, _logpdf_of(stdlib.categorical),
    "categorical_enum")
normal_reinforce = adev_distribution(
    adev_prims.normal_reinforce, _logpdf_of(stdlib.normal),
    "normal_reinforce")
normal_reparam = adev_distribution(
    adev_prims.normal_reparam, _logpdf_of(stdlib.normal), "normal_reparam")
mv_normal_diag_reparam = adev_distribution(
    adev_prims.mv_normal_diag_reparam, _logpdf_of(stdlib.mv_normal_diag),
    "mv_normal_diag_reparam", event_rank=1)
mv_normal_reparam = adev_distribution(
    adev_prims.mv_normal_reparam, _logpdf_of(stdlib.mv_normal),
    "mv_normal_reparam", event_rank=1)
geometric_reinforce = adev_distribution(
    adev_prims.geometric_reinforce, _logpdf_of(stdlib.geometric),
    "geometric_reinforce")
beta_implicit = adev_distribution(
    adev_prims.beta_implicit, _logpdf_of(stdlib.beta), "beta_implicit")
gamma_implicit = adev_distribution(
    adev_prims.gamma_implicit, _logpdf_of(stdlib.gamma), "gamma_implicit")
dirichlet_implicit = adev_distribution(
    adev_prims.dirichlet_implicit, _logpdf_of(stdlib.dirichlet),
    "dirichlet_implicit", event_rank=1)


# The four estimators share two shells: each loss is the negative
# expectation of a log-quantity of the target built from the call's
# arguments. _neg_logz_loss: the log normalizing-constant estimate of an
# SMC algorithm over the target (ELBO: 1-particle Importance, IWELBO:
# K particles). _wake_loss: a score of a sample from a posterior
# approximation (PWake under the model, QWake under the guide).


def _neg_logz_loss(make_target: Callable[..., Target],
                   make_alg: Callable[[Target], Any]) -> Callable:
    def grad_estimate(key, args: tuple):
        @expectation
        def _loss(*target_args):
            target = make_target(*target_args)
            return -make_alg(target).estimate_normalizing_constant(
                key, target)

        return _loss.grad_estimate(key, args)

    return grad_estimate


def _wake_loss(posterior_approx: SampleDistribution,
               make_target: Callable[..., Target],
               score: Callable) -> Callable:
    """``score(key, target, sample) -> log-quantity``; the loss is its
    negative expectation over samples of ``posterior_approx``."""

    def grad_estimate(key, args: tuple):
        key, k_prop, k_score = random.split(key, 3).unbind(-2)

        @expectation
        def _loss(*target_args):
            target = make_target(*target_args)
            _, sample = posterior_approx.random_weighted(k_prop, target)
            return -score(k_score, target, sample)

        return _loss.grad_estimate(key, args)

    return grad_estimate


def ELBO(guide: SampleDistribution,
         make_target: Callable[..., Target]) -> Callable:
    """∇ of −E_q[log p̃/q], the negative evidence lower bound."""
    return _neg_logz_loss(make_target,
                          lambda target: Importance(target, guide))


def IWELBO(proposal: SampleDistribution,
           make_target: Callable[..., Target], N: int) -> Callable:
    """The K-particle importance-weighted ELBO's gradient."""
    return _neg_logz_loss(make_target,
                          lambda target: ImportanceK(target, proposal, N))


def PWake(posterior_approx: SampleDistribution,
          make_target: Callable[..., Target]) -> Callable:
    """Wake-phase model update: ∇_θ −E_{z~q*}[log p_θ(z, x)]."""

    def model_score(key, target, sample):
        tr, _ = target.importance(key, sample)
        return tr.get_score()

    return _wake_loss(posterior_approx, make_target, model_score)


def QWake(proposal: SampleDistribution,
          posterior_approx: SampleDistribution,
          make_target: Callable[..., Target]) -> Callable:
    """Sleep-phase guide update: ∇_φ −E_{z~q*}[log q_φ(z | x)]."""

    def guide_score(key, target, sample):
        return proposal.estimate_logpdf(key, sample, target)

    return _wake_loss(posterior_approx, make_target, guide_score)
