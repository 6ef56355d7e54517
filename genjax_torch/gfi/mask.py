"""``Mask``: a value + validity-flag sum type (counterpart of
``genjax_tpu/gfi/mask.py``). Flags are Python bools (statically known,
folded away by ``FlagOp``) or bool tensors broadcastable against the
leading (lane) dimensions of the value.
"""

from __future__ import annotations

from typing import Generic, TypeVar

import torch

from genjax_torch.core.checks import check, optional_check
from genjax_torch.core.compiler.staging import FlagOp, tree_choose
from genjax_torch.core.pytree import (
    Pytree,
    tree_flatten,
    tree_leaves,
    tree_map,
    tree_unflatten,
)
from genjax_torch.core.typing import Flag

T = TypeVar("T")

__all__ = ["Mask"]


def _t(x, like=None) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x
    dev = like.device if isinstance(like, torch.Tensor) else None
    return torch.as_tensor(x, device=dev)


def _to_flag_rank(x: torch.Tensor, flag: Flag) -> torch.Tensor:
    """``x`` as a value under ``flag``: the flag's axes lead the value's,
    so a value with fewer axes than its flag lacks the trailing (lane)
    ones and is the same in every lane; it gains them as singletons."""
    if isinstance(flag, bool) or x.ndim >= _t(flag).ndim:
        return x
    return x.reshape(tuple(x.shape) + (1,) * (_t(flag).ndim - x.ndim))


@Pytree.dataclass
class Mask(Pytree, Generic[T]):
    """A value whose existence is conditioned on ``flag``."""

    value: T
    flag: Flag

    @staticmethod
    def _align(f1: Flag, f2: Flag) -> tuple[Flag, Flag]:
        """Lane-first alignment: the lower-rank flag gains trailing
        singleton axes."""
        if isinstance(f1, bool) or isinstance(f2, bool):
            return f1, f2
        f1, f2 = _t(f1), _t(f2)
        if f1.ndim < f2.ndim:
            f1 = f1.reshape(tuple(f1.shape) + (1,) * (f2.ndim - f1.ndim))
        elif f2.ndim < f1.ndim:
            f2 = f2.reshape(tuple(f2.shape) + (1,) * (f1.ndim - f2.ndim))
        return f1, f2

    @staticmethod
    def build(v, f: Flag = True) -> "Mask[T]":
        """Build a mask, AND-combining with an existing mask's flag."""
        if isinstance(v, Mask):
            f1, f2 = Mask._align(v.flag, f)
            return Mask(v.value, FlagOp.and_(f1, f2))
        return Mask(v, f)

    @staticmethod
    def maybe_mask(v, f: Flag):
        """Like :meth:`build`, but a literal True flag yields the raw value
        and a literal False yields ``None``."""
        if v is None:
            return None
        m = Mask.build(v, f)
        if FlagOp.concrete_true(m.flag):
            return m.value
        if FlagOp.concrete_false(m.flag):
            return None
        return m

    def unmask(self, default=None, checked: bool = False):
        """Extract the value. With no ``default``, validity is checked only
        when ``checked``; with a ``default``, invalid lanes are replaced
        elementwise."""
        if default is None:
            optional_check(
                lambda: check(_t(self.flag),
                              "Attempted to unmask a Mask with flag False."),
                enabled=checked,
            )
            return self.value

        def select(v, d):
            v = _t(v)
            flag = _t(self.flag, v)
            flag = flag.reshape(tuple(flag.shape) + (1,) * (v.ndim - flag.ndim))
            return torch.where(flag, v, _t(d, v))

        return tree_map(select, self.value, default)

    def primal_flag(self) -> Flag:
        return self.flag

    @staticmethod
    def _broadcast_values(a: "Mask", b: "Mask"):
        """The two masks' values, leafwise broadcast, so that per-lane and
        lane-invariant values of the two sides select cleanly: each leaf
        first takes its own flag's rank (:func:`_to_flag_rank`)."""
        la, spec_a = tree_flatten(a.value)
        lb, spec_b = tree_flatten(b.value)
        pairs = [torch.broadcast_tensors(_to_flag_rank(_t(x, y), a.flag),
                                         _to_flag_rank(_t(y, x), b.flag))
                 for x, y in zip(la, lb)]
        return (tree_unflatten([p[0] for p in pairs], spec_a),
                tree_unflatten([p[1] for p in pairs], spec_b))

    @staticmethod
    def _select_by_flag(flag: Flag, va, vb):
        if isinstance(flag, bool):
            return va if flag else vb
        f = _t(flag)
        # The flag joins the values where they live (a flag made from a
        # CPU index can meet card values).
        dev = next((x.device for x in tree_leaves((va, vb))
                    if isinstance(x, torch.Tensor)), f.device)
        f = f.to(dev)
        if f.ndim == 0:
            return tree_choose(torch.where(f, 0, 1), [va, vb])

        def pick(x, y):
            ff = f.reshape(tuple(f.shape) + (1,) * (x.ndim - f.ndim))
            return torch.where(ff, x, y)

        return tree_map(pick, va, vb)

    def __or__(self, other: "Mask[T]") -> "Mask[T]":
        """Valid if either is; prefers ``self``'s value when both are."""
        assert isinstance(other, Mask)
        new_flag = FlagOp.or_(self.flag, other.flag)
        va, vb = Mask._broadcast_values(self, other)
        return Mask(Mask._select_by_flag(self.flag, va, vb), new_flag)

    def __xor__(self, other: "Mask[T]") -> "Mask[T]":
        """Valid iff exactly one is."""
        assert isinstance(other, Mask)
        new_flag = FlagOp.xor_(self.flag, other.flag)
        va, vb = Mask._broadcast_values(self, other)
        return Mask(Mask._select_by_flag(self.flag, va, vb), new_flag)

    @staticmethod
    def or_n(*masks: "Mask[T]") -> "Mask[T]":
        out = masks[0]
        for m in masks[1:]:
            out = out | m
        return out

