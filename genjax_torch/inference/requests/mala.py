"""Metropolis-adjusted Langevin (MALA) as an edit request (counterpart of
``genjax_tpu/inference/requests/mala.py``): one Euler step of the
overdamped Langevin diffusion on the selected choices, ``x' = x +
(eps²/2)·∇log p(x) + eps·ξ``, with the asymmetric-proposal MH correction
as the edit weight, one per chain of the batch.
"""

from __future__ import annotations

from typing import Any

import torch

from genjax_torch.core import random
from genjax_torch.core.compiler.interpreters.incremental import Diff
from genjax_torch.core.pytree import Pytree, event_sum, tree_flatten, tree_map
from genjax_torch.gfi.concepts import Argdiffs, EditRequest
from genjax_torch.gfi.requests import Update
from genjax_torch.gfi.selection import Selection
from genjax_torch.inference.requests.hmc import (
    _is_float,
    selection_gradient,
    tree_normal,
)

__all__ = ["MALA"]


def _log_q(y, mean, eps, batch_rank: int) -> torch.Tensor:
    """log N(y; mean, eps²·I) summed over the leaves, without the
    normalizer (the same forward and backward, it cancels)."""
    total = torch.zeros(())
    for a, b in zip(tree_flatten(y)[0], tree_flatten(mean)[0]):
        if _is_float(a):
            total = total + event_sum(torch.square((a - b) / eps),
                                      batch_rank)
    return -0.5 * total


def _shift(values, steps, scale):
    """``values + scale·steps`` on the floating-point leaves."""
    return tree_map(lambda v, s: v + scale * s if _is_float(v) else v,
                    values, steps)


@Pytree.dataclass
class MALA(EditRequest):
    """Langevin proposal ``N(x + (eps²/2)·∇log p, eps²·I)`` with the exact
    MH correction on ``selection``; the edit weight is ``Δscore + log
    q(x|x') − log q(x'|x)`` and the backward request is the same
    ``MALA``."""

    selection: Selection
    eps: Any

    def edit(self, key, tr, argdiffs: Argdiffs):
        assert Diff.static_check_no_change(argdiffs), (
            "MALA requires unchanged arguments.")
        args = Diff.tree_primal(argdiffs)
        r = len(tr.batch_shape())
        values, grads = selection_gradient(self.selection, tr, args)
        key, noise_key = random.split(key).unbind(-2)
        xi = tree_normal(noise_key, values, r)
        half = 0.5 * self.eps * self.eps
        fwd_mean = _shift(values, grads, half)
        proposed = _shift(fwd_mean, xi, self.eps)
        new_trace, _, retdiff, _ = Update(proposed).edit(key, tr, argdiffs)
        _, new_grads = selection_gradient(self.selection, new_trace, args)
        bwd_mean = _shift(proposed, new_grads, half)
        alpha = (new_trace.get_score() - tr.get_score()
                 + _log_q(values, bwd_mean, self.eps, r)
                 - _log_q(proposed, fwd_mean, self.eps, r))
        return new_trace, alpha, retdiff, MALA(self.selection, self.eps)
