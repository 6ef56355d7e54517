"""Concrete-flag boolean ops, pytree selection, shape evaluation and
zero traces (counterpart of ``genjax_tpu/core/compiler/staging.py``,
without its jaxpr staging).

PyTorch runs eagerly, so there is no program to stage: ``FlagOp`` keeps
its Python-bool short cuts and a tensor flag becomes ``torch`` logic; a
switch on a tensor index runs every branch and selects, which is what
JAX's ``switch`` does under ``vmap``. ``jax.eval_shape`` becomes a run on
``meta`` tensors, which carry shapes and dtypes and do no work.
"""

from __future__ import annotations

import functools
from typing import Any, Callable, Sequence

import torch

from genjax_torch.core.pytree import tree_leaves, tree_map
from genjax_torch.core.typing import Flag

__all__ = [
    "FlagOp",
    "tree_choose",
    "tree_where",
    "multi_switch",
    "to_shape_fn",
    "empty_value",
    "empty_trace",
]


def _t(x, like=None) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x
    dev = like.device if isinstance(like, torch.Tensor) else None
    return torch.as_tensor(x, device=dev)


def _pair(a, b) -> tuple:
    """Two flags as tensors on one device: a CPU flag (a lane index's
    comparison, say) joins a card flag on the card."""
    a, b = _t(a, b), _t(b, a)
    if a.device != b.device:
        dev = a.device if a.device.type != "cpu" else b.device
        a, b = a.to(dev), b.to(dev)
    return a, b


class FlagOp:
    """Boolean ops over possibly-concrete flags: Python bools fold away,
    tensors become ``torch`` logical ops."""

    @staticmethod
    def concrete_true(f: Flag) -> bool:
        """True iff the flag is the Python literal ``True``."""
        return f is True

    @staticmethod
    def concrete_false(f: Flag) -> bool:
        return f is False

    @staticmethod
    def and_(a: Flag, b: Flag) -> Flag:
        if isinstance(a, bool) and isinstance(b, bool):
            return a and b
        if a is False or b is False:
            return False
        if a is True:
            return b
        if b is True:
            return a
        return torch.logical_and(*_pair(a, b))

    @staticmethod
    def or_(a: Flag, b: Flag) -> Flag:
        if isinstance(a, bool) and isinstance(b, bool):
            return a or b
        if a is True or b is True:
            return True
        if a is False:
            return b
        if b is False:
            return a
        return torch.logical_or(*_pair(a, b))

    @staticmethod
    def xor_(a: Flag, b: Flag) -> Flag:
        if isinstance(a, bool) and isinstance(b, bool):
            return a != b
        return torch.logical_xor(*_pair(a, b))

    @staticmethod
    def not_(a: Flag) -> Flag:
        if isinstance(a, bool):
            return not a
        return torch.logical_not(_t(a))


def tree_where(flag, a, b):
    """Leafwise ``where(flag, a, b)``; ``flag`` broadcasts against the
    leading (lane) axes of each leaf."""
    if flag is True:
        return a
    if flag is False:
        return b
    flag = _t(flag)

    def sel(x, y):
        x, y = _t(x, flag), _t(y, flag)
        nd = max(x.ndim, y.ndim)
        f = flag.reshape(tuple(flag.shape) + (1,) * (nd - flag.ndim))
        return torch.where(f, x, y)

    return tree_map(sel, a, b)


def tree_choose(idx, pytrees: Sequence[Any]):
    """Select one pytree among ``pytrees`` by index: a Python int indexes,
    a tensor index (clipped to range, as JAX's ``mode="clip"``) selects
    per lane."""
    if isinstance(idx, int):
        return pytrees[idx]
    idx = _t(idx).to(torch.int64).clamp(0, len(pytrees) - 1)

    def chooser(*leaves):
        leaves = [_t(leaf, idx) for leaf in leaves]
        out = leaves[0]
        for j, leaf in enumerate(leaves[1:], start=1):
            nd = max(out.ndim, leaf.ndim)
            f = (idx == j).reshape(tuple(idx.shape) + (1,) * (nd - idx.ndim))
            out = torch.where(f, leaf, out)
        return out.to(leaves[0].dtype)

    return tree_map(chooser, *pytrees)


def multi_switch(idx, branches: Sequence[Callable],
                 arg_tuples: Sequence[tuple]):
    """Switch over branches with heterogeneous outputs: returns every
    branch's output, the taken one real and the others zeroed (per lane
    for a tensor index). Every branch runs: eager PyTorch has no shape-only
    evaluation."""
    outs = []
    for j, (b, args) in enumerate(zip(branches, arg_tuples)):
        out = b(*args)
        taken = j == idx if isinstance(idx, int) else _t(idx) == j
        zeros = tree_map(lambda v: torch.zeros_like(_t(v)), out)
        outs.append(tree_where(taken, out, zeros))
    return outs


def to_shape_fn(fn: Callable, fill: Callable | None = None) -> Callable:
    """Wrap ``fn`` so that it evaluates shapes only: it runs on ``meta``
    copies of its tensor arguments, with ``meta`` the default device of
    the tensors it makes (no data, no work), and returns
    ``meta`` tensors, the counterpart of ``jax.eval_shape``'s
    ``ShapeDtypeStruct``s; with ``fill``, each becomes ``fill(shape,
    dtype)``. A Python number in the output counts as a 0-d tensor of its
    default dtype. ``fn`` must not read a value back (``bool`` of a
    tensor, ``.item()``), which a ``meta`` tensor cannot give."""

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        meta_args, meta_kwargs = tree_map(
            lambda v: torch.empty_like(v, device="meta")
            if isinstance(v, torch.Tensor) else v, (args, kwargs))
        with torch.device("meta"):  # the body's own constants too
            out = fn(*meta_args, **meta_kwargs)
        shapes = tree_map(lambda v: v if isinstance(v, torch.Tensor)
                          else torch.empty_like(torch.as_tensor(v),
                                                device="meta"), out)
        if fill is None:
            return shapes
        return tree_map(lambda v: fill(tuple(v.shape), v.dtype), shapes)

    return wrapped


def empty_value(fn: Callable, *args, **kwargs):
    """A zero-filled pytree of ``fn(*args)``'s output structure, on the
    device of the first tensor argument (the CPU without one)."""
    dev = next((v.device for v in tree_leaves((args, kwargs))
                if isinstance(v, torch.Tensor)), None)
    return to_shape_fn(fn, lambda shape, dtype: torch.zeros(
        shape, dtype=dtype, device=dev))(*args, **kwargs)


def empty_trace(gen_fn, args: tuple):
    """A zero-filled trace for ``gen_fn`` on ``args``: one simulate whose
    tensors are then zeroed. Not :func:`to_shape_fn`: a ``meta`` run
    cannot take the rejection loops of the gamma family, which read a
    flag back on the host each trip."""
    from genjax_torch.core import random

    tr = gen_fn.simulate(random.key(0), args)

    def zero(v):
        if isinstance(v, torch.Tensor):
            return torch.zeros_like(v)
        if isinstance(v, bool):
            return False
        if isinstance(v, (int, float)):
            return type(v)(0)
        return v

    return tree_map(zero, tr)
