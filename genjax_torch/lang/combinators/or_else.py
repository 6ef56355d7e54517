"""``or_else``: a two-branch ``Switch`` on a boolean flag, by ``Dimap``
(counterpart of ``genjax_tpu/lang/combinators/or_else.py``). A Python
bool runs one branch; a bool tensor (one flag per execution) runs both
and selects.
"""

from __future__ import annotations

import torch

from genjax_torch.gfi.gfn import GenerativeFunction
from genjax_torch.lang.combinators.dimap import Dimap
from genjax_torch.lang.combinators.switch import Switch

__all__ = ["OrElse", "or_else"]

#: One combinator per ``(if_fn, else_fn)``, for the reason of
#: ``mixture._MIX_CACHE``; entries are never dropped.
_OR_ELSE_CACHE: dict = {}


def _flag_to_index(flag, if_args, else_args):
    """``(idx, if_args, else_args)``: branch 0 where the flag holds."""
    if isinstance(flag, torch.Tensor):
        idx = torch.logical_not(flag.to(torch.bool)).to(torch.int64)
    else:
        idx = 0 if flag else 1
    return (idx, if_args, else_args)


def OrElse(if_fn: GenerativeFunction,
           else_fn: GenerativeFunction) -> GenerativeFunction:
    """Arguments ``(flag, if_args, else_args)``: ``if_fn`` where the flag
    is true, ``else_fn`` where it is false."""
    key = (if_fn, else_fn)
    try:
        cached = _OR_ELSE_CACHE.get(key)
    except TypeError:
        cached = None
    if cached is not None:
        return cached
    out = Dimap(Switch((if_fn, else_fn)), pre=_flag_to_index)
    try:
        _OR_ELSE_CACHE[key] = out
    except TypeError:
        pass
    return out


def or_else(else_fn: GenerativeFunction):
    """Decorator form: ``or_else(else_fn)(if_fn)``."""
    from genjax_torch.core.argcheck import check_gen_fn

    check_gen_fn(else_fn, "or_else")

    def decorator(if_fn: GenerativeFunction):
        return OrElse(if_fn, else_fn)

    return decorator
