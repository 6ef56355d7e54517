"""Distributions: the stochastic-probability interface and the main
path's exact-density distributions."""

from genjax_torch.lang.distributions.distribution import (
    Distribution,
    DistributionTrace,
    ExactDensity,
    exact_density,
)
from genjax_torch.lang.distributions.stdlib import *  # noqa: F401,F403
from genjax_torch.lang.distributions.stdlib import __all__ as _stdlib_all

__all__ = [
    "Distribution",
    "DistributionTrace",
    "ExactDensity",
    "exact_density",
    *_stdlib_all,
]
