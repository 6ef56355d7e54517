"""Hamiltonian Monte Carlo as an edit request: the gradient of ``assess``
with respect to a selection of choices, Gaussian momenta, leapfrog
integration, and the MH ratio as the edit weight (counterpart of
``genjax_tpu/inference/requests/hmc.py``).

The chains are a batch ``B``: a trace on keys ``B + (2,)`` holds ``B``
executions, whose scores are independent, so the gradient of the summed
score is each execution's own gradient. Every value is differentiated
as a full ``B + event`` copy, never through a zero-stride view, so no
gradient is summed across the chains. ``lax.scan`` becomes a Python
loop.
"""

from __future__ import annotations

import math
from typing import Any

import torch

from genjax_torch.core import random
from genjax_torch.core.compiler.interpreters.incremental import Diff
from genjax_torch.core.pytree import (
    Pytree,
    event_sum,
    tree_flatten,
    tree_map,
    tree_unflatten,
)
from genjax_torch.gfi.choice_map import ChoiceMap
from genjax_torch.gfi.concepts import Argdiffs, EditRequest, Retdiff
from genjax_torch.gfi.gfn import Trace
from genjax_torch.gfi.requests import DiffAnnotate, Update
from genjax_torch.gfi.selection import Selection

__all__ = ["HMC", "SafeHMC", "selection_gradient", "tree_normal"]


def _is_float(v) -> bool:
    return isinstance(v, torch.Tensor) and v.is_floating_point()


def selection_gradient(selection: Selection, trace: Trace[Any],
                       args: tuple) -> tuple[ChoiceMap, ChoiceMap]:
    """``(selected values, d score / d selected values)`` as choice maps
    of one structure; a leaf that is not floating point gets a zero
    gradient."""
    chm = trace.get_choices()
    selected = chm.filter(selection)
    complement = chm.filter(~selection)
    batch = trace.batch_shape()
    leaves, spec = tree_flatten(selected)
    with torch.enable_grad():
        live = [v.detach().clone(memory_format=torch.contiguous_format)
                .requires_grad_() if _is_float(v) else v for v in leaves]
        score, _ = trace.get_gen_fn().assess(
            tree_unflatten(live, spec) | complement, args, batch=batch)
        wrt = [v for v in live if _is_float(v)]
        grads = iter(torch.autograd.grad(torch.as_tensor(score).sum(), wrt,
                                         allow_unused=True) if wrt else ())
    values, gradients = [], []
    for v, orig in zip(live, leaves):
        if _is_float(orig):
            g = next(grads)
            values.append(v.detach())
            gradients.append(torch.zeros_like(orig) if g is None else g)
        else:
            values.append(orig)
            gradients.append(None if orig is None
                             else torch.zeros_like(torch.as_tensor(orig)))
    return tree_unflatten(values, spec), tree_unflatten(gradients, spec)


def _momenta_score(momenta, batch_rank: int) -> torch.Tensor:
    total = torch.zeros(())
    for m in tree_flatten(momenta)[0]:
        if m is not None:
            total = total + event_sum(-0.5 * m * m - 0.5 * math.log(
                2.0 * math.pi), batch_rank)
    return total


def tree_normal(key, template, batch_rank: int):
    """A standard normal per leaf of ``template`` (``B + event``), leaf
    ``i`` drawn on ``fold_in(key, i)`` as the JAX package does."""
    leaves, spec = tree_flatten(template)
    out, i = [], 0
    for v in leaves:
        if v is None:
            out.append(None)
            continue
        shape = tuple(torch.as_tensor(v).shape[batch_rank:])
        out.append(random.normal(random.fold_in(key, i), shape))
        i += 1
    return tree_unflatten(out, spec)


def _axpy(a, x, y):
    """Leafwise ``y + a·x`` on the floating-point leaves of ``y``."""
    return tree_map(lambda yv, xv: yv + a * xv if _is_float(yv) else yv,
                    y, x)


@Pytree.dataclass
class HMC(EditRequest):
    """Leapfrog-integrate Hamilton's equations for the selected choices
    (Neal 2011, eqs 5.18-5.20); the edit weight is the log MH ratio."""

    selection: Selection
    eps: Any
    L: int = Pytree.static(default=10)

    def edit(self, key, tr: Trace[Any], argdiffs: Argdiffs):
        assert Diff.static_check_no_change(argdiffs), (
            "HMC requires unchanged arguments (use SafeHMC semantics).")
        args = Diff.tree_primal(argdiffs)
        r = len(tr.batch_shape())
        original_score = tr.get_score()
        values, gradients = selection_gradient(self.selection, tr, args)
        key, mom_key = random.split(key).unbind(-2)
        momenta = tree_normal(mom_key, values, r)
        original_momenta_score = _momenta_score(momenta, r)
        trace = tr
        for i in range(1, self.L + 1):
            momenta = _axpy(self.eps / 2, gradients, momenta)
            values = _axpy(self.eps, momenta, values)
            trace, _, _, _ = Update(values).edit(random.fold_in(key, i),
                                                 trace, argdiffs)
            values, gradients = selection_gradient(self.selection, trace,
                                                   args)
            momenta = _axpy(self.eps / 2, gradients, momenta)
        final_momenta_score = _momenta_score(
            tree_map(lambda m: -m, momenta), r)
        alpha = (trace.get_score() - original_score
                 + final_momenta_score - original_momenta_score)
        retdiff = Diff.unknown_change(trace.get_retval())
        return trace, alpha, retdiff, HMC(self.selection, self.eps, self.L)


def SafeHMC(selection: Selection, eps, L: int = 10) -> DiffAnnotate:
    """HMC wrapped with a retdiff NoChange assertion."""

    def retdiff_assertion(retdiff: Retdiff):
        assert Diff.static_check_no_change(retdiff)
        return retdiff

    return HMC(selection, eps, L).map(retdiff_assertion)
