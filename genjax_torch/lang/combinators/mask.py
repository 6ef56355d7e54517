"""``MaskCombinator``: existence uncertainty for a whole call of a
generative function (counterpart of
``genjax_tpu/lang/combinators/mask.py``). A leading flag argument gates
the score, the choices are masked by it and the return value is a
:class:`Mask`.

Under a key batch ``B`` the flag is one per execution: a Python bool or a
tensor of the batch's shape.
"""

from __future__ import annotations

from typing import Any

import torch

from genjax_torch.core import random
from genjax_torch.core.compiler.interpreters.incremental import Diff
from genjax_torch.core.compiler.staging import FlagOp
from genjax_torch.core.pytree import Pytree, tree_map
from genjax_torch.gfi.choice_map import ChoiceMap
from genjax_torch.gfi.concepts import Argdiffs, EditRequest, Score
from genjax_torch.gfi.gfn import GenerativeFunction, Trace
from genjax_torch.gfi.mask import Mask
from genjax_torch.gfi.requests import Update
from genjax_torch.gfi.selection import Selection

__all__ = ["MaskCombinator", "MaskTrace", "mask"]


def _flag_times(flag, x):
    if flag is True:
        return x
    if flag is False:
        return torch.zeros_like(torch.as_tensor(x))
    x = torch.as_tensor(x)
    return torch.as_tensor(flag, device=x.device).to(x.dtype) * x


def _check_flag(flag, batch: tuple):
    """One flag per execution: a vector flag would give a vector score,
    which the GFI forbids (vmap the masked function instead)."""
    if isinstance(flag, bool):
        return flag
    if tuple(torch.as_tensor(flag).shape) != tuple(batch):
        raise TypeError(
            "mask flag must be a scalar per execution (expected shape "
            f"{tuple(batch)}, got {tuple(torch.as_tensor(flag).shape)}); "
            "vmap the masked function instead")
    return flag


@Pytree.dataclass
class MaskTrace(Trace[Any]):
    """The inner trace and its flag; the score is gated."""

    gen_fn: "MaskCombinator"
    inner: Trace
    check: Any

    def get_args(self) -> tuple:
        return (self.check, *self.inner.get_args())

    def get_retval(self):
        return Mask.build(self.inner.get_retval(), self.check)

    def get_gen_fn(self):
        return self.gen_fn

    def get_score(self) -> Score:
        return _flag_times(self.check, self.inner.get_score())

    def get_choices(self) -> ChoiceMap:
        return self.inner.get_choices().mask(self.check)

    def get_inner_trace(self, address):
        return self.inner.get_inner_trace(address)


@Pytree.dataclass
class MaskCombinator(GenerativeFunction[Any]):
    """Args ``(flag, *inner_args)``; return value ``Mask(inner_ret,
    flag)``."""

    inner: GenerativeFunction[Any]

    def simulate(self, key, args: tuple) -> MaskTrace:
        check = _check_flag(args[0], key.shape[:-1])
        return MaskTrace(self, self.inner.simulate(key, args[1:]), check)

    def assess(self, chm: ChoiceMap, args: tuple, batch: tuple = ()):
        check, inner_args = _check_flag(args[0], batch), args[1:]
        if check is False:
            # Masked off: a simulated trace's choices are empty, so
            # nothing is scored; the return value is zero-filled.
            key = random.key(0).expand(tuple(batch) + (2,))
            ret = tree_map(
                lambda v: torch.zeros_like(v) if isinstance(v, torch.Tensor)
                else v, self.inner.simulate(key, inner_args).get_retval())
            return torch.zeros(tuple(batch)), Mask.build(ret, check)
        score, retval = self.inner.assess(chm, inner_args, batch=batch)
        return _flag_times(check, score), Mask.build(retval, check)

    def generate(self, key, constraint: ChoiceMap, args: tuple):
        check = _check_flag(args[0], key.shape[:-1])
        tr, w = self.inner.generate(key, constraint, args[1:])
        return MaskTrace(self, tr, check), _flag_times(check, w)

    def project(self, key, trace: MaskTrace, selection: Selection):
        return _flag_times(trace.check,
                           self.inner.project(key, trace.inner, selection))

    def edit(self, key, trace: MaskTrace, request: EditRequest,
             argdiffs: Argdiffs):
        """The weight by the flag before and after: T→T the inner edit's
        weight, T→F minus the old score (choices removed), F→T the new
        score (the masked draw is the proposal), F→F 0."""
        post = _check_flag(Diff.tree_primal(argdiffs[0]), key.shape[:-1])
        pre = trace.check
        new_inner, w, _, bwd = request.edit(key, trace.inner, argdiffs[1:])
        weight = (_flag_times(FlagOp.and_(pre, post), w)
                  + _flag_times(FlagOp.and_(pre, FlagOp.not_(post)),
                                -trace.inner.get_score())
                  + _flag_times(FlagOp.and_(FlagOp.not_(pre), post),
                                new_inner.get_score()))
        new_trace = MaskTrace(self, new_inner, post)
        if isinstance(bwd, Update):
            bwd = Update(bwd.constraint.mask(post))
        return (new_trace, weight,
                Diff.unknown_change(new_trace.get_retval()), bwd)


def mask(gen_fn: GenerativeFunction) -> MaskCombinator:
    return MaskCombinator(gen_fn)
