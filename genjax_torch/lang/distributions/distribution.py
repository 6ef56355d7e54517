"""``Distribution``, generative functions over a single random choice, and
``ExactDensity`` for distributions with tractable log-densities
(counterpart of ``genjax_tpu/lang/distributions/distribution.py``).

A key of shape ``B + (2,)`` draws ``B`` independent choices at once; a
log-density is summed over the event dimensions only, never over ``B``,
and a score or weight has exactly the shape ``B``. ``edit`` serves
``Update`` and ``Regenerate`` with the JAX package's key use: the
concrete paths hand the key to ``random_weighted`` / ``estimate_logpdf``
as it is, a tensor flag splits it into sample and estimate keys. Named
parameters (``normal(loc=..., scale=...)``, ``categorical(probs=...)``)
bind to positions by the sampler's parameter names and the
distribution's aliases (:meth:`ExactDensity.bind_kwargs`).
"""

from __future__ import annotations

import abc
import inspect
from typing import Any, Callable

import torch

from genjax_torch.core import random
from genjax_torch.core.compiler.interpreters.incremental import Diff
from genjax_torch.core.compiler.staging import FlagOp, tree_where
from genjax_torch.core.pytree import Pytree, event_sum
from genjax_torch.gfi.choice_map import ChoiceMap
from genjax_torch.gfi.concepts import Argdiffs, EditRequest, Score
from genjax_torch.gfi.gfn import GenerativeFunction, Trace
from genjax_torch.gfi.mask import Mask
from genjax_torch.gfi.requests import Regenerate, Update
from genjax_torch.gfi.selection import Selection
from genjax_torch.lang.static import check_top_level_args

__all__ = [
    "Distribution",
    "DistributionTrace",
    "ExactDensity",
    "IIDBlock",
    "exact_density",
]


def _batch(key: torch.Tensor) -> tuple:
    return tuple(key.shape[:-1])


def _zeros(key: torch.Tensor) -> torch.Tensor:
    """A zero weight per key of the batch."""
    return torch.zeros(_batch(key), dtype=torch.float32, device=key.device)


def _select(flag, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``where(flag, a, b)`` for a weight: the flag has the batch's shape
    (or broadcasts against it)."""
    return torch.where(torch.as_tensor(flag, device=a.device), a, b)


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
        check_top_level_args(args, _batch(key))
        score, v = self.random_weighted(key, *args)
        return DistributionTrace(self, args, v, score)

    def assess(self, chm: ChoiceMap, args: tuple, batch: tuple = ()):
        v = self._constraint_value(chm)
        if v is None:
            raise ValueError(
                f"{self}: assess requires a value choice at the root."
            )
        if isinstance(v, Mask):
            v = v.value
        check_top_level_args(args, tuple(batch))
        # assess is keyless: exact densities ignore the key entirely, and
        # a fixed key of the batch's shape says which axes are the batch.
        key = random.key(0).expand(tuple(batch) + (2,))
        score = self.estimate_logpdf(key, v, *args)
        return score, v

    def generate(self, key, constraint: ChoiceMap, args: tuple):
        check_top_level_args(args, _batch(key))
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
        args = Diff.tree_primal(argdiffs)
        check_top_level_args(args, _batch(key))
        no_change = Diff.static_check_no_change(argdiffs)
        if isinstance(request, Update):
            return self._edit_update(key, trace, request.constraint, args,
                                     no_change)
        if isinstance(request, Regenerate):
            return self._edit_regenerate(key, trace, request.selection, args,
                                         no_change)
        raise NotImplementedError(
            f"{type(self).__name__} does not support "
            f"{type(request).__name__}"
        )

    def _edit_update(self, key, trace, constraint: ChoiceMap, args,
                     args_unchanged: bool):
        """SMCP3 update arithmetic: a constrained value is rescored and
        the old one discarded; an unconstrained one is kept and rescored
        only when the arguments changed. A tensor ``Mask`` flag selects
        per execution."""
        old_v = trace.get_retval()
        old_score = trace.get_score()
        cv = self._constraint_value(constraint)

        if cv is None:
            if args_unchanged:
                return (trace, _zeros(key), Diff.no_change(old_v),
                        Update(ChoiceMap.empty()))
            new_score = self.estimate_logpdf(key, old_v, *args)
            new_tr = DistributionTrace(self, args, old_v, new_score)
            return (new_tr, new_score - old_score, Diff.no_change(old_v),
                    Update(ChoiceMap.empty()))

        if isinstance(cv, Mask):
            flag = cv.primal_flag()
            if FlagOp.concrete_true(flag):
                cv = cv.value
            elif FlagOp.concrete_false(flag):
                return self._edit_update(key, trace, ChoiceMap.empty(), args,
                                         args_unchanged)
            else:
                v = tree_where(flag, cv.value, old_v)
                new_score = self.estimate_logpdf(key, v, *args)
                new_tr = DistributionTrace(self, args, v, new_score)
                discard = ChoiceMap.choice(Mask.build(old_v, flag))
                return (new_tr, new_score - old_score, Diff.unknown_change(v),
                        Update(discard))

        new_score = self.estimate_logpdf(key, cv, *args)
        new_tr = DistributionTrace(self, args, cv, new_score)
        return (new_tr, new_score - old_score, Diff.unknown_change(cv),
                Update(ChoiceMap.choice(old_v)))

    def _edit_regenerate(self, key, trace, selection: Selection, args,
                         args_unchanged: bool):
        """A selected choice is redrawn from the prior at the new
        arguments (weight exactly 0); an unselected one is kept and
        rescored. A tensor selection flag draws, selects and rescores."""
        old_v = trace.get_retval()
        old_score = trace.get_score()
        flag = selection.check()

        if FlagOp.concrete_false(flag):
            return self._edit_update(key, trace, ChoiceMap.empty(), args,
                                     args_unchanged)
        if FlagOp.concrete_true(flag):
            new_score, v = self.random_weighted(key, *args)
            new_tr = DistributionTrace(self, args, v, new_score)
            return (new_tr, _zeros(key), Diff.unknown_change(v),
                    Regenerate(selection))
        key, est_key = random.split(key).unbind(-2)
        _, sampled = self.random_weighted(key, *args)
        v = tree_where(flag, sampled, old_v)
        new_score = self.estimate_logpdf(est_key, v, *args)
        new_tr = DistributionTrace(self, args, v, new_score)
        w = _select(flag, torch.zeros_like(new_score), new_score - old_score)
        return new_tr, w, Diff.unknown_change(v), Regenerate(selection)


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

    #: The rank of one value (1 for a vector-valued distribution): a
    #: value with fewer axes behind the batch is refused, since a length
    #: cannot tell a per-execution axis from an event axis.
    event_rank: int = 0

    def _logpdf_sum(self, v, *args, batch: tuple = ()) -> Score:
        # The batch rank is the key's: every tensor parameter leads with
        # the batch, so the dimensions behind it are the event's. A
        # log-density without them (a constant value under constant
        # parameters) is one score per key all the same.
        r = len(batch)
        if self.event_rank and torch.as_tensor(v).ndim < r + self.event_rank:
            raise ValueError(
                f"{self!r}: a value of shape {tuple(torch.as_tensor(v).shape)}"
                f" under the batch {tuple(batch)} has no event axis behind "
                "it (lift a shared parameter with v.expand(batch + v.shape))")
        lp = event_sum(torch.as_tensor(self.logpdf(v, *args)), r)
        return lp.expand(batch) if r else lp

    def bind_kwargs(self, args: tuple, kwargs: dict) -> tuple:
        """Named distribution parameters resolved to positional ones
        (``normal(loc=0., scale=1.)``, ``categorical(probs=p)``) by the
        sampler's parameter names and the aliases of
        :meth:`kwarg_aliases`. A name given twice, unknown or missing
        raises ``TypeError``, as in the JAX package."""
        kw = dict(kwargs)
        for name, (target, conv) in self.kwarg_aliases().items():
            if name in kw:
                if target in kw:
                    raise TypeError(
                        f"{self!r}: both '{name}' and '{target}' given")
                kw[target] = conv(kw.pop(name))
        fn = getattr(self, "sampler", None) or self.sample
        try:
            params = [p.name for p in inspect.signature(fn).parameters.values()
                      if p.kind in (p.POSITIONAL_ONLY,
                                    p.POSITIONAL_OR_KEYWORD)][1:]
        except (TypeError, ValueError):
            params = []
        if not params and kw:
            raise TypeError(
                f"{self!r} takes no named parameters, got {list(kw)}")
        bound = []
        for i, p in enumerate(params):
            if i < len(args):
                if p in kw:
                    raise TypeError(
                        f"{self!r}: '{p}' given positionally and by name")
                bound.append(args[i])
            elif p in kw:
                bound.append(kw.pop(p))
            else:
                raise TypeError(f"{self!r}: missing parameter '{p}'")
        if kw:
            raise TypeError(f"{self!r}: unknown parameters {list(kw)}")
        return tuple(bound)

    def kwarg_aliases(self) -> dict:
        """``{alias: (param, converter)}``, e.g. categorical's ``probs``
        to ``logits`` by log."""
        return getattr(self, "aliases", None) or {}

    def iid(self, sample_shape) -> "IIDBlock":
        """``sample_shape`` iid draws of this distribution as one choice,
        scored by the summed log-density."""
        if isinstance(sample_shape, int):
            sample_shape = (sample_shape,)
        return IIDBlock(self, tuple(int(s) for s in sample_shape))


@Pytree.dataclass
class IIDBlock(ExactDensity):
    """``shape`` iid draws of an inner :class:`ExactDensity` as one
    choice: value ``B + shape + event``, score the summed log-density.
    Draw ``j`` uses key ``j`` of ``split(key, prod(shape))``, as the JAX
    package's vmap over split keys does; the draws loop over ``j`` so
    that a per-execution parameter meets its own key batch."""

    inner: ExactDensity
    shape: tuple = Pytree.static()

    def _n(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n

    def sample(self, key, *args):
        keys = random.split(key, self._n())
        draws = torch.stack([self.inner.sample(keys[..., j, :], *args)
                             for j in range(self._n())], dim=key.ndim - 1)
        b = _batch(key)
        return draws.reshape(b + self.shape + tuple(draws.shape[len(b) + 1:]))

    def logpdf(self, v, *args):
        return self._logpdf_sum(v, *args)

    def _logpdf_sum(self, v, *args, batch: tuple = ()) -> Score:
        r = len(batch)
        v = torch.as_tensor(v)
        flat = v.reshape(tuple(v.shape[:r]) + (self._n(),)
                         + tuple(v.shape[r + len(self.shape):]))
        lead = (slice(None),) * r
        total = None
        for j in range(self._n()):
            lp = self.inner._logpdf_sum(flat[lead + (j,)], *args, batch=batch)
            total = lp if total is None else total + lp
        return total

    def get_support(self, *args):
        return self.inner.get_support(*args)

    def __repr__(self):
        return f"{self.inner!r}.iid({self.shape})"


@Pytree.dataclass
class ExactDensityFromCallables(ExactDensity):
    """An :class:`ExactDensity` from a (sampler, logpdf) pair."""

    sampler: Callable = Pytree.static()
    logpdf_fn: Callable = Pytree.static()
    name: str = Pytree.static(default="exact_density")
    support: Any = Pytree.static(default=None)
    event_rank: int = Pytree.static(default=0)
    aliases: Any = Pytree.static(default=None)

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
                  support: Any = None,
                  event_rank: int = 0,
                  aliases: Any = None) -> ExactDensityFromCallables:
    """Build an :class:`ExactDensity` from a sampler and a log-density.
    ``sample(key, *params)`` draws one value per key of the key batch;
    ``support`` is the support metadata (a string, a tuple, or a callable
    of the parameters) that gradient samplers read; ``event_rank`` is the
    rank of one value; ``aliases`` maps other parameter names to
    ``(param, converter)`` pairs for named-parameter calls."""
    return ExactDensityFromCallables(sample, logpdf, name, support,
                                     event_rank, aliases)
