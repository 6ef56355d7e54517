"""The combinators of the port: ``Vmap`` (with ``repeat``), ``Scan`` with
the combinators derived from it, ``Dimap`` and ``MaskCombinator``.
Switch, mix and or_else are not ported yet."""

from genjax_torch.lang.combinators.dimap import (
    Dimap,
    DimapTrace,
    contramap,
    dimap,
    map_retval,
)
from genjax_torch.lang.combinators.mask import MaskCombinator, MaskTrace, mask
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
from genjax_torch.lang.combinators.vmap import Vmap, VmapTrace, vmap

__all__ = [
    "Dimap",
    "DimapTrace",
    "MaskCombinator",
    "MaskTrace",
    "Scan",
    "ScanTrace",
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
    "prepend_initial_acc",
    "reduce",
    "repeat",
    "scan",
    "vmap",
]
