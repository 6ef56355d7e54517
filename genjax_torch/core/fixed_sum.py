"""Sums whose float association is fixed by the length of the summed
axis alone.

torch's ``sum``, ``cumsum`` and ``logsumexp`` choose how to split a row
from the whole tensor's shape: a CUDA reduction over few rows spreads one
row over several thread blocks, and the CPU splits work across threads by
size. The same row can then come out with other bits when the tensor has
more or fewer rows, which breaks bitwise layout independence (a rank of
a D-rank world holds 1/D of the rows that one rank holds). The functions
here use elementwise passes only, so each output's association depends
on the axis length (and, for a prefix sum, the position) alone, on the
CPU and on the card alike.
"""

from __future__ import annotations

import torch

__all__ = ["prefix_sum", "tree_sum", "tree_logsumexp"]


def prefix_sum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum over the last axis in ceil(log2 L) elementwise
    passes (Hillis–Steele): element ``j``'s association depends on ``j``
    alone."""
    length, s = x.shape[-1], 1
    while s < length:
        x = torch.cat([x[..., :s], x[..., s:] + x[..., :-s]], dim=-1)
        s *= 2
    return x


def tree_sum(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Sum over ``dim`` as a pairwise tree of elementwise adds, the axis
    zero-padded to a power of two."""
    x = x.movedim(dim, -1)
    length = x.shape[-1]
    width = 1 << max(length - 1, 0).bit_length()
    if width != length:
        x = torch.nn.functional.pad(x, (0, width - length))
    while x.shape[-1] > 1:
        half = x.shape[-1] // 2
        x = x[..., :half] + x[..., half:]
    return x[..., 0]


def tree_logsumexp(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``torch.logsumexp(x, dim)`` with the sum of :func:`tree_sum`: the
    max shift (exact in any order; infinite maxima shift by 0), then
    ``log(tree_sum(exp(x - m))) + m``."""
    m = x.amax(dim, keepdim=True)
    m = torch.where(m.abs() == float("inf"), torch.zeros_like(m), m)
    return torch.log(tree_sum(torch.exp(x - m), dim)) + m.squeeze(dim)
