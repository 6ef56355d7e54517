"""GFI concept vocabulary: weights, scores, argdiffs, and the edit-request
base classes (counterpart of ``genjax_tpu/gfi/concepts.py``).

``edit`` implements an SMCP3 move and returns the incremental importance
weight

    w = log [ P(new_choices; new_args) · q_bwd ] − log [ P(old_choices;
        old_args) · q_fwd ]

together with the backward request that would invert the move.
"""

from __future__ import annotations

import abc
from typing import TYPE_CHECKING, Any, TypeAlias

import torch

from genjax_torch.core.pytree import Pytree

if TYPE_CHECKING:
    from genjax_torch.gfi.gfn import Trace

__all__ = [
    "Weight",
    "Score",
    "Retval",
    "Arguments",
    "Argdiffs",
    "Retdiff",
    "EditRequest",
    "PrimitiveEditRequest",
    "IndexRequest",
    "NotSupportedEditRequest",
]

#: Log incremental importance weight of an edit / generate move.
Weight: TypeAlias = torch.Tensor
#: Log density (estimate) of a full trace.
Score: TypeAlias = torch.Tensor
Retval: TypeAlias = Any
Arguments: TypeAlias = tuple
Argdiffs: TypeAlias = tuple
Retdiff: TypeAlias = Any


class NotSupportedEditRequest(Exception):
    """Raised when a generative function cannot serve an edit request."""


class EditRequest(Pytree):
    """A request to transform a trace (the MCMC/SMC move vocabulary)."""

    @abc.abstractmethod
    def edit(self, key: torch.Tensor, tr: "Trace", argdiffs: Argdiffs):
        ...

    def dimap(self, *, pre, post) -> "EditRequest":
        from genjax_torch.gfi.requests import DiffAnnotate

        return DiffAnnotate(self, pre, post)

    def map(self, post) -> "EditRequest":
        return self.dimap(pre=lambda d: d, post=post)

    def contramap(self, pre) -> "EditRequest":
        return self.dimap(pre=pre, post=lambda d: d)


class PrimitiveEditRequest(EditRequest):
    """An edit request served by the trace's own generative function."""

    def edit(self, key, tr, argdiffs):
        return tr.get_gen_fn().edit(key, tr, self, argdiffs)


@Pytree.dataclass
class IndexRequest(PrimitiveEditRequest):
    """Apply a sub-request at one index of a vectorized generative
    function (a Vmap lane or a Scan step). ``idx`` is an int or a 0-d
    tensor (the same lane in every execution of a batch), or a tensor of
    the batch's shape (one lane per execution, as ``jax.vmap`` of the
    edit with the index mapped serves it)."""

    idx: Any
    subrequest: EditRequest
