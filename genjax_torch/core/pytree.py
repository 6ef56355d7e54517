"""Pytree substrate: frozen dataclasses registered with
``torch.utils._pytree``, with a static / dynamic field split.

Counterpart of ``genjax_tpu/core/pytree.py``. The tree helpers at the
bottom give JAX's semantics on top of torch's pytree registry: ``None``
is an empty subtree (torch treats it as a leaf), so a ``tree_map`` never
calls its function on ``None``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Generic, TypeVar

import torch
import torch.utils._pytree as tpu_tree

R = TypeVar("R")
T = TypeVar("T")

__all__ = [
    "Pytree",
    "Const",
    "Closure",
    "PythonicPytree",
    "tree_map",
    "tree_leaves",
    "tree_flatten",
    "tree_unflatten",
    "ravel_pytree",
    "event_sum",
    "nth",
]


def tree_map(fn: Callable, tree: Any, *rest: Any,
             is_leaf: Callable[[Any], bool] | None = None) -> Any:
    """``jax.tree_util.tree_map`` semantics: ``None`` subtrees pass
    through untouched."""

    def leaf(x):
        return x is None or (is_leaf is not None and is_leaf(x))

    def apply(x, *xs):
        return None if x is None else fn(x, *xs)

    return tpu_tree.tree_map(apply, tree, *rest, is_leaf=leaf)


def tree_leaves(tree: Any, is_leaf: Callable[[Any], bool] | None = None):
    def leaf(x):
        return x is None or (is_leaf is not None and is_leaf(x))

    return [x for x in tpu_tree.tree_leaves(tree, is_leaf=leaf)
            if x is not None]


def tree_flatten(tree: Any):
    return tpu_tree.tree_flatten(tree)


def tree_unflatten(leaves, spec):
    return tpu_tree.tree_unflatten(leaves, spec)


def _register_dataclass(dcls: type, data_names: list, static_names: list):
    def flatten(obj):
        children = [getattr(obj, n) for n in data_names]
        context = tuple(getattr(obj, n) for n in static_names)
        return children, context

    def unflatten(children, context):
        obj = object.__new__(dcls)
        for n, v in zip(data_names, children):
            object.__setattr__(obj, n, v)
        for n, v in zip(static_names, context):
            object.__setattr__(obj, n, v)
        return obj

    def flatten_with_keys(obj):
        children, context = flatten(obj)
        return ([(tpu_tree.GetAttrKey(n), c)
                 for n, c in zip(data_names, children)], context)

    tpu_tree.register_pytree_node(
        dcls, flatten, unflatten,
        serialized_type_name=f"{dcls.__module__}.{dcls.__qualname__}",
        flatten_with_keys_fn=flatten_with_keys,
    )


class Pytree:
    """Base class for pytree-compatible frozen dataclasses.

    Fields declared with :func:`Pytree.static` are metadata (part of the
    tree spec); all other fields are data (tensors or subtrees)."""

    @staticmethod
    def dataclass(incoming: type | None = None, /, **kwargs):
        """Class decorator: frozen dataclass + pytree registration."""

        def wrap(cls: type) -> type:
            kwargs.setdefault("eq", False)
            dcls = dataclasses.dataclass(frozen=True, **kwargs)(cls)
            static_names, data_names = [], []
            for f in dataclasses.fields(dcls):
                if f.metadata.get("pytree_static", False):
                    static_names.append(f.name)
                else:
                    data_names.append(f.name)
            _register_dataclass(dcls, data_names, static_names)
            return dcls

        if incoming is not None:
            return wrap(incoming)
        return wrap

    @staticmethod
    def static(**kwargs) -> Any:
        """Field specifier marking a dataclass field as static metadata."""
        metadata = dict(kwargs.pop("metadata", {}))
        metadata["pytree_static"] = True
        return dataclasses.field(metadata=metadata, **kwargs)

    @staticmethod
    def field(**kwargs) -> Any:
        """Field specifier for a dynamic (tensor) dataclass field."""
        return dataclasses.field(**kwargs)

    @staticmethod
    def const(v: T) -> "Const[T]":
        return Const(v)

    @staticmethod
    def tree_const(v: Any) -> Any:
        """Wrap every leaf of ``v`` in :class:`Const`."""
        return tree_map(Const, v)

    @staticmethod
    def tree_const_unwrap(v: Any) -> Any:
        """Unwrap every :class:`Const` leaf of ``v``."""
        return tree_map(lambda x: x.value if isinstance(x, Const) else x, v,
                        is_leaf=lambda x: isinstance(x, Const))

    @staticmethod
    def partial(*args) -> Callable[[Callable[..., R]], "Closure[R]"]:
        """Decorator building a :class:`Closure` over dynamic ``args``."""

        def wrap(fn: Callable[..., R]) -> Closure[R]:
            return Closure(args, fn)

        return wrap

    def replace(self, **updates):
        return dataclasses.replace(self, **updates)

    def render_html(self) -> str:
        """Collapsible HTML (``utils.pretty.render_html``)."""
        from genjax_torch.utils.pretty import render_html

        return render_html(self)

    def pformat(self) -> str:
        """Text rendering (``utils.pretty.pformat``)."""
        from genjax_torch.utils.pretty import pformat

        return pformat(self)

    def __repr__(self) -> str:
        if dataclasses.is_dataclass(self):
            parts = []
            for f in dataclasses.fields(self):
                v = getattr(self, f.name)
                if isinstance(v, torch.Tensor) and v.ndim:
                    vs = f"Tensor({tuple(v.shape)}, {v.dtype})"
                else:
                    vs = repr(v)
                parts.append(f"{f.name}={vs}")
            return f"{type(self).__name__}({', '.join(parts)})"
        return object.__repr__(self)


@Pytree.dataclass
class Const(Pytree, Generic[T]):
    """A static value embedded in a pytree (no leaves)."""

    value: T = Pytree.static()

    def __call__(self, *args, **kwargs):
        return self.value(*args, **kwargs)  # type: ignore[operator]

    def __hash__(self):
        return hash((Const, self.value))

    def __eq__(self, other):
        return isinstance(other, Const) and self.value == other.value

    @staticmethod
    def unwrap(v: Any) -> Any:
        return v.value if isinstance(v, Const) else v


@Pytree.dataclass
class Closure(Pytree, Generic[R]):
    """A closure as a pytree: static code + dynamic closed-over arguments."""

    dyn_args: tuple = Pytree.field()
    fn: Callable[..., R] = Pytree.static()

    def __call__(self, *args, **kwargs) -> R:
        return self.fn(*self.dyn_args, *args, **kwargs)


class PythonicPytree(Pytree):
    """Pytree base with leafwise sugar: indexing, ``len``, iteration and
    ``+`` as concatenation along the leading axis."""

    def __getitem__(self, idx):
        return tree_map(lambda v: v[idx], self)

    def __len__(self):
        leaves = tree_leaves(self)
        if not leaves:
            return 0
        return len(leaves[0])

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    def __add__(self, other):
        return tree_map(lambda a, b: torch.cat([a, b], dim=0), self, other)


def ravel_pytree(tree: Any, batch_rank: int = 0):
    """The batched counterpart of ``jax.flatten_util.ravel_pytree``: every
    tensor leaf ``B + event`` (``batch_rank`` leading batch axes) is
    flattened behind the batch and the leaves are concatenated, in JAX's
    leaf order, into one ``B + (D,)`` tensor of their promoted dtype.
    Returns ``(flat, unravel)``; ``unravel(z)`` takes any ``B' + (D,)``
    and gives the tree back with leaves ``B' + event`` in their own
    dtypes."""
    leaves, spec = tpu_tree.tree_flatten(tree)
    tensors = [v for v in leaves if v is not None]
    if not all(isinstance(v, torch.Tensor) for v in tensors):
        raise TypeError("ravel_pytree: every leaf must be a tensor")
    if not tensors:
        raise ValueError("ravel_pytree: the tree has no tensor leaves")
    batch = tuple(tensors[0].shape[:batch_rank])
    dtype = tensors[0].dtype
    for v in tensors[1:]:
        dtype = torch.promote_types(dtype, v.dtype)
    events = [tuple(v.shape[batch_rank:]) for v in tensors]
    sizes = [math.prod(e) for e in events]
    flat = torch.cat([v.to(dtype).reshape(batch + (n,))
                      for v, n in zip(tensors, sizes)], dim=-1)
    dtypes = [v.dtype for v in tensors]

    def unravel(z: torch.Tensor):
        lead = tuple(z.shape[:-1])
        parts = iter(zip(torch.split(z, sizes, dim=-1), events, dtypes))
        out = []
        for v in leaves:
            if v is None:
                out.append(None)
                continue
            part, event, dt = next(parts)
            out.append(part.reshape(lead + event).to(dt))
        return tpu_tree.tree_unflatten(out, spec)

    return flat, unravel


def event_sum(x: torch.Tensor, batch_rank: int) -> torch.Tensor:
    """``x`` summed over everything behind its ``batch_rank`` leading
    (batch) axes; ``x`` itself when there is nothing behind them."""
    if x.ndim <= batch_rank:
        return x
    return x.sum(dim=tuple(range(batch_rank, x.ndim)))


def nth(tree: Any, idx) -> Any:
    """Index every leaf of ``tree`` with ``idx``."""
    return tree_map(lambda v: v[idx], tree)
