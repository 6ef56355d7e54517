"""The two-point change lattice (``NoChange`` / ``UnknownChange``) and
``Diff``-annotated values (counterpart of
``genjax_tpu/core/compiler/interpreters/incremental.py``, data types only).
An argdiffs tree may carry one ``Diff`` for a whole argument or one per
leaf: the fine-grained ``@gen`` edit path (``lang/static_edit.py``) hands
each site its arguments leaf by leaf, ``UnknownChange`` on the leaves a
change reached. The JAX package's jaxpr change-propagation interpreter
has no counterpart: the port tracks changes through the body's torch
operations at run time.
"""

from __future__ import annotations

from typing import Any

from genjax_torch.core.pytree import Pytree, tree_map

__all__ = ["ChangeTangent", "NoChange", "UnknownChange", "Diff"]


class ChangeTangent:
    """A point on the change lattice."""

    def __init__(self, name: str, changed: bool):
        self._name = name
        self.changed = changed

    def __repr__(self):
        return self._name

    def __or__(self, other: "ChangeTangent") -> "ChangeTangent":
        return UnknownChange if (self.changed or other.changed) else NoChange


NoChange = ChangeTangent("NoChange", False)
UnknownChange = ChangeTangent("UnknownChange", True)


def _is_diff(x) -> bool:
    return isinstance(x, Diff)


@Pytree.dataclass
class Diff(Pytree):
    """A value paired with a change tangent."""

    primal: Any
    tangent: ChangeTangent = Pytree.static()

    @staticmethod
    def no_change(tree: Any) -> Any:
        return Diff.tree_diff(Diff.tree_primal(tree), NoChange)

    @staticmethod
    def unknown_change(tree: Any) -> Any:
        return Diff.tree_diff(Diff.tree_primal(tree), UnknownChange)

    @staticmethod
    def tree_primal(tree: Any) -> Any:
        def strip(v):
            return Diff.tree_primal(v.primal) if _is_diff(v) else v

        return tree_map(strip, tree, is_leaf=_is_diff)

    @staticmethod
    def tree_tangent(tree: Any) -> ChangeTangent:
        """Join all tangents in ``tree``; unannotated leaves count as
        ``UnknownChange``."""
        out = NoChange

        def visit(v):
            nonlocal out
            out = out | (v.tangent if _is_diff(v) else UnknownChange)
            return v

        tree_map(visit, tree, is_leaf=_is_diff)
        return out

    @staticmethod
    def static_check_no_change(tree: Any) -> bool:
        return not Diff.tree_tangent(tree).changed

    @staticmethod
    def tree_diff(tree: Any, tangent: ChangeTangent) -> Any:
        return tree_map(lambda v: Diff(v, tangent), tree, is_leaf=_is_diff)

    def get_primal(self):
        return self.primal

    def get_tangent(self):
        return self.tangent
