"""MCMC moves as edit requests."""

from genjax_torch.inference.requests.ess import (
    EllipticalSlice,
    elliptical_slice_kernel,
)
from genjax_torch.inference.requests.hmc import HMC, SafeHMC, selection_gradient
from genjax_torch.inference.requests.mala import MALA
from genjax_torch.inference.requests.nuts import NUTS, NUTSInfo, nuts_kernel
from genjax_torch.inference.requests.rejuvenate import Rejuvenate

__all__ = ["EllipticalSlice", "HMC", "MALA", "NUTS", "NUTSInfo",
           "Rejuvenate", "SafeHMC", "elliptical_slice_kernel", "nuts_kernel",
           "selection_gradient"]
