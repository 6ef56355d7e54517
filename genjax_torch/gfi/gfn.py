"""The generative function interface: ``Trace`` and ``GenerativeFunction``
(counterpart of ``genjax_tpu/gfi/gfn.py``). The combinator postfix
methods (``vmap``, ``scan``, ``switch``, ...) and ``marginal`` are not
ported yet.
"""

from __future__ import annotations

import abc
from typing import Any, Generic, TypeVar

import torch

from genjax_torch.core.compiler.interpreters.incremental import Diff
from genjax_torch.core.pytree import Pytree
from genjax_torch.gfi.choice_map import ChoiceMap
from genjax_torch.gfi.concepts import Argdiffs, EditRequest
from genjax_torch.gfi.selection import Selection

R = TypeVar("R")

__all__ = ["Trace", "GenerativeFunction", "GenerativeFunctionClosure"]


class Trace(Pytree, Generic[R]):
    """A recording of one execution of a generative function: arguments,
    return value, choices and score (log density of the choices)."""

    @abc.abstractmethod
    def get_args(self) -> tuple: ...

    @abc.abstractmethod
    def get_retval(self) -> R: ...

    @abc.abstractmethod
    def get_score(self) -> torch.Tensor: ...

    @abc.abstractmethod
    def get_choices(self) -> ChoiceMap: ...

    @abc.abstractmethod
    def get_gen_fn(self) -> "GenerativeFunction[R]": ...

    def get_sample(self) -> ChoiceMap:
        return self.get_choices()

    def edit(self, key, request: EditRequest, argdiffs: Argdiffs | None = None):
        if argdiffs is None:
            argdiffs = Diff.no_change(self.get_args())
        return request.edit(key, self, argdiffs)

    def update(self, key, constraint: ChoiceMap,
               argdiffs: Argdiffs | None = None):
        if argdiffs is None:
            argdiffs = Diff.no_change(self.get_args())
        return self.get_gen_fn().update(key, self, constraint, argdiffs)

    def project(self, key, selection: Selection) -> torch.Tensor:
        """log-density of the selected choices, conditioned on the rest."""
        return self.get_gen_fn().project(key, self, selection)

    def get_subtrace(self, *addresses) -> "Trace[Any]":
        tr: Trace[Any] = self
        for addr in addresses:
            tr = tr.get_inner_trace(addr)
        return tr

    def get_inner_trace(self, address) -> "Trace[Any]":
        raise KeyError(f"{type(self).__name__} has no subtraces")

    def batch_shape(self) -> tuple:
        return tuple(torch.as_tensor(self.get_score()).shape)


class GenerativeFunction(Pytree, Generic[R]):
    """A probability measure over structured sample spaces, accessed
    through ``simulate`` / ``assess`` / ``generate`` / ``project`` /
    ``edit``.

    A key of shape ``B + (2,)`` runs ``B`` independent executions at once
    (the particle axis written out, see ``core/random.py``): every
    tensor of the trace then leads with ``B``."""

    @abc.abstractmethod
    def simulate(self, key, args: tuple) -> Trace[R]:
        """Sample a trace: choices ~ P(·; args)."""

    @abc.abstractmethod
    def assess(self, chm: ChoiceMap, args: tuple):
        """Score a complete choice map: ``(log P(chm; args), retval)``."""

    @abc.abstractmethod
    def generate(self, key, constraint: ChoiceMap, args: tuple):
        """Importance-sample a trace consistent with ``constraint``; the
        weight is ``log P(choices) − log q(unconstrained | constraint)``."""

    def project(self, key, trace: Trace[R], selection: Selection):
        raise NotImplementedError

    def edit(self, key, trace: Trace[R], request: EditRequest,
             argdiffs: Argdiffs):
        raise NotImplementedError(
            f"{type(self).__name__} does not support request "
            f"{type(request).__name__}"
        )

    def update(self, key, trace: Trace[R], constraint: ChoiceMap,
               argdiffs: Argdiffs):
        from genjax_torch.gfi.requests import Update

        tr, w, rd, bwd = Update(constraint).edit(key, trace, argdiffs)
        discard = bwd.constraint if isinstance(bwd, Update) else ChoiceMap.empty()
        return tr, w, rd, discard

    def importance(self, key, constraint: ChoiceMap, args: tuple):
        return self.generate(key, constraint, args)

    def propose(self, key, args: tuple):
        tr = self.simulate(key, args)
        return tr.get_choices(), tr.get_score(), tr.get_retval()

    def get_zero_trace(self, *args) -> Trace[R]:
        from genjax_torch.core.compiler.staging import empty_trace

        return empty_trace(self, args)

    def __call__(self, *args) -> "GenerativeFunctionClosure[R]":
        return GenerativeFunctionClosure(self, args)


@Pytree.dataclass
class GenerativeFunctionClosure(Pytree, Generic[R]):
    """``gf(args)``: a gen fn partially applied to arguments. Inside a
    ``@gen`` body, ``closure @ "addr"`` records a traced call. (Keyword
    arguments are not ported yet.)"""

    gen_fn: GenerativeFunction[R]
    args: tuple

    def __matmul__(self, addr) -> R:
        from genjax_torch.lang.static import trace_here

        return trace_here(addr, self.gen_fn, self.args)

    def simulate(self, key):
        return self.gen_fn.simulate(key, self.args)

    def assess(self, chm):
        return self.gen_fn.assess(chm, self.args)

    def generate(self, key, constraint):
        return self.gen_fn.generate(key, constraint, self.args)
