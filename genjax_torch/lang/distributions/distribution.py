"""``Distribution``, generative functions over a single random choice, and
``ExactDensity`` for distributions with tractable log-densities
(counterpart of ``genjax_tpu/lang/distributions/distribution.py``).

A key of shape ``B + (2,)`` draws ``B`` independent choices at once; a
log-density is summed over the event dimensions only, never over ``B``.
Not ported yet: ``edit`` (it raises), named parameters
(``normal(loc=..., scale=...)``) and the ``iid`` block
(``sample_shape=``).
"""

from __future__ import annotations

import abc
from typing import Any, Callable

import torch

from genjax_torch.core import random
from genjax_torch.core.compiler.staging import FlagOp, tree_where
from genjax_torch.core.pytree import Pytree
from genjax_torch.gfi.choice_map import ChoiceMap
from genjax_torch.gfi.concepts import Argdiffs, EditRequest, Score
from genjax_torch.gfi.gfn import GenerativeFunction, Trace
from genjax_torch.gfi.mask import Mask
from genjax_torch.gfi.selection import Selection

__all__ = [
    "Distribution",
    "DistributionTrace",
    "ExactDensity",
    "exact_density",
]


def _batch(key: torch.Tensor) -> tuple:
    return tuple(key.shape[:-1])


def _zeros(key: torch.Tensor) -> torch.Tensor:
    """A zero weight per key of the batch."""
    return torch.zeros(_batch(key), dtype=torch.float32, device=key.device)


@Pytree.dataclass
class DistributionTrace(Trace[Any]):
    """Trace of a single-choice distribution."""

    gen_fn: "Distribution"
    args: tuple
    value: Any
    score: Score

    def get_args(self) -> tuple:
        return self.args

    def get_retval(self):
        return self.value

    def get_score(self) -> Score:
        return self.score

    def get_gen_fn(self):
        return self.gen_fn

    def get_choices(self) -> ChoiceMap:
        return ChoiceMap.choice(self.value)


class Distribution(GenerativeFunction[Any]):
    """A generative function with one anonymous choice, specified by
    ``random_weighted(key, *args) -> (score_estimate, value)`` and
    ``estimate_logpdf(key, v, *args) -> score_estimate``."""

    #: True for distributions whose value space is itself a ChoiceMap.
    chm_valued: bool = False

    @abc.abstractmethod
    def random_weighted(self, key, *args) -> tuple[Score, Any]: ...

    @abc.abstractmethod
    def estimate_logpdf(self, key, v: Any, *args) -> Score: ...

    def _constraint_value(self, constraint: ChoiceMap):
        cv = constraint.get_value()
        if cv is None and self.chm_valued and not constraint.static_is_empty():
            return constraint
        return cv

    def get_support(self, *args):
        return None

    def simulate(self, key, args: tuple) -> DistributionTrace:
        score, v = self.random_weighted(key, *args)
        return DistributionTrace(self, args, v, score)

    def assess(self, chm: ChoiceMap, args: tuple):
        v = self._constraint_value(chm)
        if v is None:
            raise ValueError(
                f"{self}: assess requires a value choice at the root."
            )
        if isinstance(v, Mask):
            v = v.value
        # assess is keyless: exact densities ignore the key entirely.
        score = self.estimate_logpdf(random.key(0), v, *args)
        return score, v

    def generate(self, key, constraint: ChoiceMap, args: tuple):
        cv = self._constraint_value(constraint)
        if cv is None:
            return self.simulate(key, args), _zeros(key)
        if isinstance(cv, Mask):
            flag = cv.primal_flag()
            if FlagOp.concrete_true(flag):
                cv = cv.value
            elif FlagOp.concrete_false(flag):
                return self.simulate(key, args), _zeros(key)
            else:
                key, est_key = random.split(key).unbind(-2)
                _, sampled = self.random_weighted(key, *args)
                v = tree_where(flag, cv.value, sampled)
                score = self.estimate_logpdf(est_key, v, *args)
                w = torch.where(torch.as_tensor(flag, device=score.device),
                                score, torch.zeros_like(score))
                return DistributionTrace(self, args, v, score), w
        score = self.estimate_logpdf(key, cv, *args)
        return DistributionTrace(self, args, cv, score), score

    def project(self, key, trace: DistributionTrace, selection: Selection):
        flag = selection.check()
        score = trace.get_score()
        if FlagOp.concrete_true(flag):
            return score
        if FlagOp.concrete_false(flag):
            return torch.zeros_like(torch.as_tensor(score))
        return torch.where(torch.as_tensor(flag, device=score.device),
                           score, torch.zeros_like(score))

    def edit(self, key, trace: DistributionTrace, request: EditRequest,
             argdiffs: Argdiffs):
        raise NotImplementedError(
            "Distribution.edit is not ported yet: edits come with ROADMAP "
            "queue 1 item 8, 'Combinators and edits'."
        )


class ExactDensity(Distribution):
    """Distribution with an exactly computable log-density: specify
    ``sample(key, *args)`` and ``logpdf(v, *args)``. Residual event
    dimensions of the log-density are summed; the key batch is not."""

    @abc.abstractmethod
    def sample(self, key, *args) -> Any: ...

    @abc.abstractmethod
    def logpdf(self, v: Any, *args) -> Score: ...

    def random_weighted(self, key, *args):
        v = self.sample(key, *args)
        return self._logpdf_sum(v, *args, batch=_batch(key)), v

    def estimate_logpdf(self, key, v, *args):
        return self._logpdf_sum(v, *args, batch=_batch(key))

    def _logpdf_sum(self, v, *args, batch: tuple = ()) -> Score:
        lp = torch.as_tensor(self.logpdf(v, *args))
        if batch and tuple(lp.shape[:len(batch)]) == batch:
            dims = tuple(range(len(batch), lp.ndim))
            return lp.sum(dim=dims) if dims else lp
        return lp.sum() if lp.ndim > 0 else lp


@Pytree.dataclass
class ExactDensityFromCallables(ExactDensity):
    """An :class:`ExactDensity` from a (sampler, logpdf) pair."""

    sampler: Callable = Pytree.static()
    logpdf_fn: Callable = Pytree.static()
    name: str = Pytree.static(default="exact_density")
    support: Any = Pytree.static(default=None)

    def sample(self, key, *args):
        return self.sampler(key, *args)

    def logpdf(self, v, *args):
        return self.logpdf_fn(v, *args)

    def get_support(self, *args):
        if callable(self.support):
            return self.support(*args)
        return self.support

    def __repr__(self):
        return f"genjax_torch.{self.name}"


def exact_density(sample: Callable, logpdf: Callable,
                  name: str = "exact_density",
                  support: Any = None) -> ExactDensityFromCallables:
    """Build an :class:`ExactDensity` from a sampler and a log-density.
    ``sample(key, *params)`` draws one value per key of the key batch;
    ``support`` is the support metadata (a string, a tuple, or a callable
    of the parameters) that gradient samplers read."""
    return ExactDensityFromCallables(sample, logpdf, name, support)
