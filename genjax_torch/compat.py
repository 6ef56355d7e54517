"""Migration shims for code written against earlier APIs (counterpart
of ``genjax_tpu/compat.py``).

- ``implicit_logit_warning``: early versions read a bare parameter of
  ``bernoulli`` / ``categorical`` as logits; a bare positional parameter
  now warns, with the JAX package's ``DeprecationWarning`` text, and asks
  for an explicit ``logits=`` / ``probs=`` choice.
- ``genjax_torch.experimental``: the (empty) experimental facade.
"""

from __future__ import annotations

import textwrap
import warnings
from typing import Any, Callable

import torch

__all__ = ["implicit_logit_warning"]


def _default_probs_to_logits(probs):
    p = torch.as_tensor(probs, dtype=torch.float32) if not isinstance(
        probs, torch.Tensor) else probs
    if p.ndim >= 1:
        # Vector parameter (categorical-style): logits = log p.
        return torch.log(p)
    # Scalar success probability (bernoulli-style): log-odds.
    return torch.log(p) - torch.log1p(-p)


def implicit_logit_warning(
    dist: Any,
    probs_to_logits: Callable = _default_probs_to_logits,
) -> Callable:
    """Wrap a logits-parameterized distribution so that a BARE positional
    parameter provokes a :class:`DeprecationWarning` (and is interpreted
    as logits, preserving old program meaning), while explicit
    ``logits=`` / ``probs=`` keywords select the scale unambiguously.

    ``dist`` is any callable distribution object (the
    ``exact_density`` singletons included: the wrapper forwards to it,
    so ``@``-addressing of the returned closure still works)."""

    def wrapper(*args, **kwargs):
        if "probs" in kwargs:
            if args or "logits" in kwargs:
                raise TypeError(
                    "pass exactly one of a bare parameter, logits=, or "
                    "probs="
                )
            return dist(probs_to_logits(kwargs.pop("probs")), **kwargs)
        if "logits" in kwargs:
            if args:
                raise TypeError(
                    "pass exactly one of a bare parameter, logits=, or "
                    "probs="
                )
            return dist(kwargs.pop("logits"), **kwargs)
        if args:
            warnings.warn(
                textwrap.dedent(
                    f"""
                    The use of a bare argument to {getattr(dist, 'name', dist)}
                    is deprecated. Please specify `logits=` or `probs=` for the
                    parameters. The default, which will be used in this case,
                    is logits."""
                ),
                DeprecationWarning,
                stacklevel=2,
            )
        return dist(*args, **kwargs)

    wrapper.inner = dist
    return wrapper
