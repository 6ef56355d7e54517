"""Fine-grained incremental edits of ``@gen`` functions (counterpart of
``genjax_tpu/lang/static_edit.py``).

The coarse rule of ``lang/static.py`` counts every site after the first
change as changed, so an MH sweep over an S-site chain re-scores O(S²)
sites. The JAX package recovers the fine behaviour by staging the body to
a jaxpr and running its Diff interpreter over it. The port has no
staging: the body runs eagerly, as on the coarse path, under a
:class:`ChangeTracker`, a ``TorchFunctionMode`` that tags the tensors
that carry a change:

- the changed leaves of the arguments (by their ``Diff`` tangents);
- the return value of a site whose sub-edit reports a change (a redrawn
  or constrained value, or one re-scored into a new value), and of a
  site the old trace did not have;
- every output of a torch operation of the body with a tagged input.

A site's argdiffs are then leaf by leaf: ``UnknownChange`` on a tagged
tensor, ``NoChange`` on every other leaf. A site whose arguments did not
change and whose request is empty keeps its old subtrace without an edit
(the identity, weight 0), and its key is not derived. The tracker sees
the body's own operations only: it is suspended while a site's edit runs
(the site's own operations are not the body's), as the batch-lifting
mode of ``static.py`` is.

Draws and weights are bit for bit those of the coarse path: the sites are
visited in the same order and draw from the same ``fold_in(key,
counter)`` keys (the counter moves on past a kept site), and an unchanged
site weighs exactly 0 on either path.

``edit_stats`` (``static.edit_stats``) counts the sites re-scored on
either path and the edits each path served.

Where the tracker cannot follow a change, the edit reruns on the coarse
path (the JAX package falls back on a concretization error the same way):

- the body reads a tagged tensor's value into Python (``bool``, ``int``,
  ``float``, ``.item()``, ``.tolist()``, ``torch.equal``, ...), so its
  control flow may depend on a changed value;
- a changed argument leaf, or a changed site's return value, holds a
  Python value rather than a tensor, which no operation can carry a tag
  through.
"""

from __future__ import annotations

import weakref

import torch

from genjax_torch.core.compiler.interpreters.incremental import (
    Diff,
    NoChange,
    UnknownChange,
)
from genjax_torch.core.pytree import tree_leaves, tree_map
from genjax_torch.lang.static import _Provenance, _tensors, edit_stats

__all__ = ["ChangeTracker", "Untracked", "edit_stats", "tracker_for"]


class Untracked(Exception):
    """The body let a change escape the tracker; the caller reruns the
    edit on the coarse path."""


#: Torch functions that read a tensor's values into Python.
_VALUE_READS = frozenset({
    torch.Tensor.__bool__, torch.Tensor.__int__, torch.Tensor.__float__,
    torch.Tensor.__index__, torch.Tensor.__complex__,
    torch.Tensor.__format__, torch.Tensor.__contains__,
    torch.Tensor.__array__, torch.Tensor.item, torch.Tensor.tolist,
    torch.Tensor.numpy, torch.Tensor.equal, torch.Tensor.allclose,
    torch.Tensor.is_nonzero, torch.equal, torch.allclose, torch.is_nonzero,
})


def _in_place(func, kwargs) -> bool:
    name = getattr(func, "__name__", "")
    return (name == "__setitem__" or "out" in kwargs
            or (name.endswith("_") and not name.endswith("__")))


class ChangeTracker(_Provenance):
    """The body's mode on the fine path: it tells the batch's constants
    apart as :class:`~genjax_torch.lang.static._Provenance` does (under
    a batch) and tags the tensors that carry a change."""

    def __init__(self, batch: tuple):
        super().__init__(batch)
        self._changed: dict = {}

    def _tag(self, t: torch.Tensor):
        self._changed[id(t)] = weakref.ref(t)

    def is_changed(self, v) -> bool:
        if not isinstance(v, torch.Tensor):
            return False
        ref = self._changed.get(id(v))
        return ref is not None and ref() is v

    def tag_changed(self, tree):
        """Tag every tensor of a changed value; a Python value in it
        cannot carry a tag, so the edit falls back."""
        for v in tree_leaves(tree):
            if not isinstance(v, torch.Tensor):
                raise Untracked(f"a changed value holds {type(v).__name__}")
            self._tag(v)

    def any_changed(self, tree) -> bool:
        return any(self.is_changed(v) for v in tree_leaves(tree))

    def argdiffs(self, gen_fn, args):
        """A site's argdiffs, leaf by leaf. A generative function that
        closes over a changed tensor changes all of its arguments."""
        if self.any_changed(gen_fn):
            return Diff.unknown_change(args)
        return tree_map(
            lambda v: Diff(v, UnknownChange if self.is_changed(v)
                           else NoChange), args)

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        ins = list(_tensors((args, kwargs)))
        changed = any(self.is_changed(t) for t in ins)
        if changed and func in _VALUE_READS:
            raise Untracked(
                f"the body reads a changed value ({func.__name__})")
        out = func(*args, **kwargs)
        if self.batch and any(self.carries(t) for t in ins):
            for t in _tensors(out):
                self._mark_one(t)
        if changed:
            for t in _tensors(out):
                self._tag(t)
            if _in_place(func, kwargs):
                target = kwargs.get("out", args[0] if args else None)
                for t in _tensors(target):
                    self._tag(t)
        return out


def tracker_for(argdiffs, batch: tuple) -> ChangeTracker | None:
    """A tracker with the changed argument leaves tagged, or ``None``
    when a changed leaf is not a tensor (the coarse path serves such an
    edit)."""
    tracker = ChangeTracker(batch)
    ok = True

    def visit(d):
        nonlocal ok
        if isinstance(d, Diff):
            tangent = d.tangent
            leaves = tree_leaves(Diff.tree_primal(d.primal))
        else:
            tangent, leaves = UnknownChange, [d]
        if tangent.changed:
            for v in leaves:
                if isinstance(v, torch.Tensor):
                    tracker._tag(v)
                else:
                    ok = False
        return d

    tree_map(visit, argdiffs, is_leaf=lambda x: isinstance(x, Diff))
    return tracker if ok else None
