"""The core edit requests ``Update`` and ``Regenerate`` (counterpart of
``genjax_tpu/gfi/requests.py``). The port's generative functions do not
serve edits yet (ROADMAP queue 1 item 8); ``EmptyRequest`` and
``DiffAnnotate`` come with them."""

from __future__ import annotations

from genjax_torch.core.pytree import Pytree
from genjax_torch.gfi.choice_map import ChoiceMap
from genjax_torch.gfi.concepts import PrimitiveEditRequest
from genjax_torch.gfi.selection import Selection

__all__ = ["Update", "Regenerate"]


@Pytree.dataclass
class Update(PrimitiveEditRequest):
    """Constrain a subset of choices to new values."""

    constraint: ChoiceMap


@Pytree.dataclass
class Regenerate(PrimitiveEditRequest):
    """Resample the selected choices from their prior conditionals."""

    selection: Selection = Pytree.field()
