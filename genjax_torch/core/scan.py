"""Parallel-prefix scan: the counterpart of ``jax.lax.associative_scan``
(over axis 0, or over a later axis with a batch in front, as
``jax.vmap`` of the scan runs it).

The recursion is JAX's own (``jax/_src/lax/control_flow/loops.py``, the
inner ``_scan``): combine the pairs ``elems[0:-1:2]`` and ``elems[1::2]``,
scan the reduced sequence, then combine each "even" element with the odd
results before it and interleave. The tree of combines is therefore
JAX's, and a float combine rounds in the same places. Each level calls
``fn`` once on a whole batch of pairs, so ``fn`` must act elementwise
over the leading axes (the batch, then the pairs). Under ``jax.vmap``
the JAX scan keeps its tree for each execution, so scanning along
``axis`` with the batch in front rounds as ``jax.vmap`` does. At an even
length the second combine of the level below 4 elements receives empty
operands: ``fn`` must return an empty batch for them.
"""

from __future__ import annotations

from typing import Callable

import torch

from genjax_torch.core.pytree import tree_flatten, tree_unflatten

__all__ = ["associative_scan", "count_combines"]


def _interleave(a: torch.Tensor, b: torch.Tensor,
                axis: int = 0) -> torch.Tensor:
    """``[a0, b0, a1, b1, ...]`` along ``axis``, with ``a`` as long as
    ``b`` or one longer."""
    nb = b.shape[axis]
    pairs = torch.stack([a.narrow(axis, 0, nb), b], dim=axis + 1).reshape(
        b.shape[:axis] + (2 * nb,) + b.shape[axis + 1:])
    if a.shape[axis] > nb:
        return torch.cat([pairs, a.narrow(axis, nb, a.shape[axis] - nb)],
                         dim=axis)
    return pairs


def associative_scan(fn: Callable, elems, axis: int = 0):
    """Inclusive scan of ``elems`` (one tensor or a pytree of tensors with
    one length along ``axis``) under the associative ``fn``:
    ``[e0, fn(e0, e1), fn(fn(e0, e1), e2), ...]``. The axes in front of
    ``axis`` are a batch: each of its entries is scanned on its own."""
    flat, spec = tree_flatten(elems)
    n = flat[0].shape[axis]
    if any(e.shape[axis] != n for e in flat[1:]):
        raise ValueError("associative_scan: inputs differ in length along "
                         f"axis {axis}: {[tuple(e.shape) for e in flat]}")
    lead = (slice(None),) * axis

    def sl(e, start=None, stop=None, step=None):
        return e[lead + (slice(start, stop, step),)]

    def combine(a, b):
        out, _ = tree_flatten(fn(tree_unflatten(a, spec),
                                 tree_unflatten(b, spec)))
        return out

    def scan(es):
        m = es[0].shape[axis]
        if m < 2:
            return es
        odd = scan(combine([sl(e, 0, -1, 2) for e in es],
                           [sl(e, 1, None, 2) for e in es]))
        if m % 2 == 0:
            even = combine([sl(o, None, -1) for o in odd],
                           [sl(e, 2, None, 2) for e in es])
        else:
            even = combine(odd, [sl(e, 2, None, 2) for e in es])
        even = [torch.cat([sl(e, None, 1), r], dim=axis)
                for e, r in zip(es, even)]
        return [_interleave(a, b, axis) for a, b in zip(even, odd)]

    return tree_unflatten(scan(flat), spec)


def count_combines(n: int) -> int:
    """How many calls of ``fn`` on non-empty operands
    :func:`associative_scan` makes for ``n`` elements."""
    if n < 2:
        return 0
    half = n // 2
    even = half - 1 if n % 2 == 0 else half
    return 1 + count_combines(half) + (1 if even > 0 else 0)
