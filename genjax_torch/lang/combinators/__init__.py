"""The combinators of the port: ``Vmap`` (with ``repeat``), ``Scan`` with
the combinators derived from it, ``Dimap``, ``MaskCombinator``, and
``Switch`` with ``mix`` and ``or_else`` built on it."""

from genjax_torch.lang.combinators.dimap import (
    Dimap,
    DimapTrace,
    contramap,
    dimap,
    map_retval,
)
from genjax_torch.lang.combinators.mask import MaskCombinator, MaskTrace, mask
from genjax_torch.lang.combinators.mixture import mix
from genjax_torch.lang.combinators.or_else import OrElse, or_else
from genjax_torch.lang.combinators.repeat import repeat
from genjax_torch.lang.combinators.scan import (
    Scan,
    ScanTrace,
    accumulate,
    iterate,
    iterate_final,
    masked_iterate,
    masked_iterate_final,
    prepend_initial_acc,
    reduce,
    scan,
)
from genjax_torch.lang.combinators.switch import Switch, SwitchTrace, switch
from genjax_torch.lang.combinators.vmap import Vmap, VmapTrace, vmap

__all__ = [
    "Dimap",
    "DimapTrace",
    "MaskCombinator",
    "MaskTrace",
    "OrElse",
    "Scan",
    "ScanTrace",
    "Switch",
    "SwitchTrace",
    "Vmap",
    "VmapTrace",
    "accumulate",
    "contramap",
    "dimap",
    "iterate",
    "iterate_final",
    "map_retval",
    "mask",
    "masked_iterate",
    "masked_iterate_final",
    "mix",
    "or_else",
    "prepend_initial_acc",
    "reduce",
    "repeat",
    "scan",
    "switch",
    "vmap",
]
