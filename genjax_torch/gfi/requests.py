"""The core edit requests: ``Update`` (constrain to new values),
``Regenerate`` (resample a selection), ``EmptyRequest`` (replay under new
arguments) and ``DiffAnnotate`` (coerce the diffs around an inner
request) (counterpart of ``genjax_tpu/gfi/requests.py``)."""

from __future__ import annotations

from typing import Callable

from genjax_torch.core.pytree import Pytree
from genjax_torch.gfi.choice_map import ChoiceMap
from genjax_torch.gfi.concepts import EditRequest, PrimitiveEditRequest
from genjax_torch.gfi.selection import Selection

__all__ = ["Update", "Regenerate", "EmptyRequest", "DiffAnnotate"]


@Pytree.dataclass
class Update(PrimitiveEditRequest):
    """Constrain a subset of choices to new values; the backward request
    is the ``Update`` of the discarded old values."""

    constraint: ChoiceMap


@Pytree.dataclass
class Regenerate(PrimitiveEditRequest):
    """Resample the selected choices from their prior conditionals."""

    selection: Selection = Pytree.field()


@Pytree.dataclass
class EmptyRequest(EditRequest):
    """No constraint change: replay the trace under (possibly) new
    arguments."""

    def edit(self, key, tr, argdiffs):
        return tr.get_gen_fn().edit(key, tr, Update(ChoiceMap.empty()),
                                    argdiffs)


@Pytree.dataclass
class DiffAnnotate(EditRequest):
    """Coerce the argdiffs and the retdiff around an inner request. The
    caller asserts that the coercion is sound."""

    request: EditRequest
    argdiff_fn: Callable = Pytree.static(default=lambda d: d)
    retdiff_fn: Callable = Pytree.static(default=lambda d: d)

    def edit(self, key, tr, argdiffs):
        new_tr, w, retdiff, bwd = self.request.edit(
            key, tr, self.argdiff_fn(argdiffs))
        return new_tr, w, self.retdiff_fn(retdiff), bwd
