"""Stochastic-probability interface for inference (counterpart of
``genjax_tpu/inference/sp.py``): ``Target`` packages an unnormalized
posterior, ``Algorithm`` is a distribution over choice maps, and
``Marginal`` marginalizes a generative function's unselected choices.
"""

from __future__ import annotations

import abc
from typing import Callable

from genjax_torch.core import random
from genjax_torch.core.pytree import Const, Pytree
from genjax_torch.gfi.choice_map import ChoiceMap
from genjax_torch.gfi.gfn import GenerativeFunction
from genjax_torch.gfi.selection import Selection
from genjax_torch.lang.distributions.distribution import Distribution

__all__ = ["Target", "SampleDistribution", "Algorithm", "Marginal", "marginal"]


@Pytree.dataclass
class Target(Pytree):
    """An unnormalized target: generative function + arguments +
    constraint. The posterior is over the unconstrained choices."""

    p: GenerativeFunction
    args: tuple
    constraint: ChoiceMap

    def __post_init__(self):
        if isinstance(self.p, Marginal):
            raise TypeError(
                "Target does not accept Marginal models; target the "
                "underlying generative function and constrain/select "
                "its addresses instead."
            )

    def importance(self, key, chm: ChoiceMap):
        """Generate from ``p`` under the merged constraint."""
        return self.p.generate(key, self.constraint | chm, self.args)

    def filter_to_unconstrained(self, chm: ChoiceMap) -> ChoiceMap:
        return chm.filter(~self.constraint.get_selection())

    def __getitem__(self, addr):
        return self.constraint[addr]


class SampleDistribution(Distribution):
    """A distribution whose values are choice maps."""

    chm_valued = True


class Algorithm(SampleDistribution):
    """An approximate-inference strategy for a :class:`Target`."""

    @abc.abstractmethod
    def random_weighted(self, key, target: Target): ...

    @abc.abstractmethod
    def estimate_logpdf(self, key, chm: ChoiceMap, target: Target): ...

    @abc.abstractmethod
    def estimate_normalizing_constant(self, key, target: Target): ...

    @abc.abstractmethod
    def estimate_reciprocal_normalizing_constant(
        self, key, target: Target, latent_choices: ChoiceMap, w
    ): ...

    def estimate_marginal_density(self, key, target: Target,
                                  latent_choices: ChoiceMap, w):
        return -self.estimate_reciprocal_normalizing_constant(
            key, target, latent_choices, w
        )


@Pytree.dataclass
class Marginal(SampleDistribution):
    """The marginal of a generative function over the addresses picked by
    ``selection``; the rest is marginalized with ``algorithm`` (default:
    importance with the prior)."""

    gen_fn: GenerativeFunction
    selection: Const
    algorithm: "Algorithm | None" = None

    def random_weighted(self, key, *args):
        from genjax_torch.inference.smc import Importance

        key, sub_key, proj_key = random.split(key, 3).unbind(-2)
        tr = self.gen_fn.simulate(key, args)
        choices = tr.get_choices()
        selection = self.selection.value
        latent = choices.filter(selection)
        other = choices.filter(~selection)
        target = Target(self.gen_fn, args, latent)
        alg = self.algorithm or Importance(target)
        w_proper = tr.project(proj_key, selection)
        return alg.estimate_marginal_density(sub_key, target, other,
                                             w_proper), latent

    def estimate_logpdf(self, key, latent: ChoiceMap, *args):
        from genjax_torch.inference.smc import Importance

        target = Target(self.gen_fn, args, latent)
        alg = self.algorithm or Importance(target)
        return alg.estimate_normalizing_constant(key, target)


def marginal(selection: Selection | None = None,
             algorithm: "Algorithm | None" = None) -> Callable:
    """Decorator form: ``@marginal(selection=...)`` on a gen fn."""

    def decorator(gen_fn: GenerativeFunction) -> Marginal:
        sel = selection if selection is not None else Selection.all()
        return Marginal(gen_fn, Pytree.const(sel), algorithm)

    return decorator
