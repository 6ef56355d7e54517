"""ADEV: automatic differentiation of expected values (counterpart of
``genjax_tpu/adev``)."""

from genjax_torch.adev.core import (
    ADEVPrimitive,
    ADEVProgram,
    Dual,
    Expectation,
    TailCallADEVPrimitive,
    cond,
    expectation,
    forward_mode,
    sample_primitive,
)
from genjax_torch.adev.primitives import *  # noqa: F401,F403
from genjax_torch.adev.primitives import __all__ as _prims_all

__all__ = [
    "ADEVPrimitive",
    "ADEVProgram",
    "TailCallADEVPrimitive",
    "Dual",
    "Expectation",
    "cond",
    "expectation",
    "forward_mode",
    "sample_primitive",
    *_prims_all,
]
