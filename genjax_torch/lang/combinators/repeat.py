"""``repeat``: ``n`` independent draws of a generative function on the same
arguments (counterpart of ``genjax_tpu/lang/combinators/repeat.py``):
``Vmap`` with no mapped argument, the lane keys its only mapped input."""

from __future__ import annotations

from typing import Callable

from genjax_torch.gfi.gfn import GenerativeFunction
from genjax_torch.lang.combinators.vmap import Vmap

__all__ = ["repeat"]


def repeat(*, n: int) -> Callable:
    """``gf.repeat(n=k)``: choices under lane addresses ``0..n-1``."""
    from genjax_torch.core.argcheck import check_static_int

    check_static_int(n, "repeat(n=...)")

    def decorator(gen_fn: GenerativeFunction) -> Vmap:
        return Vmap(gen_fn, in_axes=None, axis_size=n)

    return decorator
