"""The generative function interface: choice maps, selections, masks,
traces and generative functions."""

from genjax_torch.gfi.choice_map import C, ChoiceMap
from genjax_torch.gfi.gfn import GenerativeFunction, Trace
from genjax_torch.gfi.mask import Mask
from genjax_torch.gfi.selection import Selection

__all__ = ["C", "ChoiceMap", "GenerativeFunction", "Mask", "Selection",
           "Trace"]
