"""Triton forms of the scalar-state models that ``fused_particle_filter``
runs through the fused-step kernel: ``propagate(x, eps)`` and
``loglik(x, obs)`` as ``@triton.jit`` functions. Their torch forms, and
the constants both forms read, are in ``genjax_torch/entry.py``. This
module imports ``triton``: import it only where a CUDA tensor is about to
be stepped.
"""

from __future__ import annotations

import math

import triton
import triton.language as tl

from genjax_torch import entry

__all__ = [
    "tracking_propagate",
    "tracking_loglik",
    "linear_propagate",
    "linear_loglik",
]

# A @triton.jit function reads a global only as a tl.constexpr.
_TRACKING_SD = tl.constexpr(entry.TRACKING_SD)
_HALF_LOG_2PI = tl.constexpr(entry.HALF_LOG_2PI)
_LINEAR_A = tl.constexpr(entry.LINEAR_A)
_LINEAR_SQRT_Q = tl.constexpr(math.sqrt(entry.LINEAR_Q))
_LINEAR_R = tl.constexpr(entry.LINEAR_R)
_LINEAR_HALF_LOG_2PI_R = tl.constexpr(entry.LINEAR_HALF_LOG_2PI_R)


@triton.jit
def tracking_propagate(x, e):
    """The nonlinear 1-D tracking dynamics of bench config 4."""
    return 0.5 * x + 25.0 * x / (1.0 + x * x) + _TRACKING_SD * e


@triton.jit
def tracking_loglik(x, y):
    """``log N(y; x^2 / 20, 1)``."""
    d = y - x * x / 20.0
    return -0.5 * d * d - _HALF_LOG_2PI


@triton.jit
def linear_propagate(x, e):
    """The linear-Gaussian model: ``x_t = a x_{t-1} + sqrt(q) eps``."""
    return _LINEAR_A * x + _LINEAR_SQRT_Q * e


@triton.jit
def linear_loglik(x, y):
    """``log N(y; x, r)``."""
    d = y - x
    return -0.5 * d * d / _LINEAR_R - _LINEAR_HALF_LOG_2PI_R
