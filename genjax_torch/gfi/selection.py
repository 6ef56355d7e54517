"""``Selection``: a boolean algebra over hierarchical address prefixes
(counterpart of ``genjax_tpu/gfi/selection.py``).
"""

from __future__ import annotations

import abc
from typing import Any

import torch

from genjax_torch.core.compiler.staging import FlagOp
from genjax_torch.core.pytree import Pytree
from genjax_torch.core.typing import Flag

__all__ = ["Selection", "addr_tuple"]


def addr_tuple(addr) -> tuple:
    """Normalize an address to a tuple of components."""
    if isinstance(addr, tuple):
        return addr
    return (addr,)


def _is_static_comp(comp) -> bool:
    return isinstance(comp, (str, int)) or comp is Ellipsis


def _t(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(x)


class Selection(Pytree):
    """Abstract selection node: :meth:`check` says whether the value at
    this node is selected, :meth:`get_subselection` descends one address
    component."""

    @abc.abstractmethod
    def check(self) -> Flag: ...

    @abc.abstractmethod
    def get_subselection(self, comp) -> "Selection": ...

    def __call__(self, addr) -> "Selection":
        sel = self
        for comp in addr_tuple(addr):
            sel = sel.get_subselection(comp)
        return sel

    def __getitem__(self, addr) -> Flag:
        return self(addr).check()

    def __contains__(self, addr) -> bool:
        flag = self[addr]
        return bool(_t(flag).all())

    def __and__(self, other: "Selection") -> "Selection":
        if isinstance(self, AllSel):
            return other
        if isinstance(other, AllSel):
            return self
        if isinstance(self, NoneSel) or isinstance(other, NoneSel):
            return Selection.none()
        return AndSel(self, other)

    def __or__(self, other: "Selection") -> "Selection":
        if isinstance(self, NoneSel):
            return other
        if isinstance(other, NoneSel):
            return self
        if isinstance(self, AllSel) or isinstance(other, AllSel):
            return Selection.all()
        return OrSel(self, other)

    def __invert__(self) -> "Selection":
        if isinstance(self, AllSel):
            return Selection.none()
        if isinstance(self, NoneSel):
            return Selection.all()
        if isinstance(self, ComplementSel):
            return self.inner
        return ComplementSel(self)

    def mask(self, flag: Flag) -> "Selection":
        if FlagOp.concrete_true(flag):
            return self
        if FlagOp.concrete_false(flag):
            return Selection.none()
        return MaskedSel(self, flag)

    def extend(self, *addrs) -> "Selection":
        sel = self
        comps: list = []
        for a in addrs:
            comps.extend(addr_tuple(a))
        for comp in reversed(comps):
            if _is_static_comp(comp):
                sel = StaticSel.build({comp: sel})
            else:
                sel = IdxSel(_t(comp), sel)
        return sel

    @staticmethod
    def all() -> "Selection":
        return AllSel()

    @staticmethod
    def none() -> "Selection":
        return NoneSel()

    @staticmethod
    def leaf() -> "Selection":
        return LeafSel()

    @staticmethod
    def idx_above(threshold) -> "Selection":
        """Every subtree at an integer address above ``threshold`` (a
        number, or a tensor with one threshold per execution)."""
        return AboveIdxSel(threshold)

    class _AtBuilder:
        def __getitem__(self, addr) -> "Selection":
            return Selection.all().extend(*addr_tuple(addr))

    at: "Selection._AtBuilder"


Selection.at = Selection._AtBuilder()


@Pytree.dataclass
class AllSel(Selection):
    def check(self) -> Flag:
        return True

    def get_subselection(self, comp) -> Selection:
        return self


@Pytree.dataclass
class NoneSel(Selection):
    def check(self) -> Flag:
        return False

    def get_subselection(self, comp) -> Selection:
        return self


@Pytree.dataclass
class LeafSel(Selection):
    """Selects the value at this node and none of its descendants."""

    def check(self) -> Flag:
        return True

    def get_subselection(self, comp) -> Selection:
        return NoneSel()


@Pytree.dataclass
class StaticSel(Selection):
    """Trie node keyed by static components; ``...`` matches any."""

    subsels: tuple
    keys: tuple = Pytree.static()

    @staticmethod
    def build(mapping: dict) -> "StaticSel":
        keys = tuple(mapping.keys())
        return StaticSel(tuple(mapping[k] for k in keys), keys)

    def check(self) -> Flag:
        return False

    def get_subselection(self, comp) -> Selection:
        out: Selection = NoneSel()
        if _is_static_comp(comp):
            for key, sub in zip(self.keys, self.subsels):
                if key == comp:
                    out = out | sub
        else:
            for key, sub in zip(self.keys, self.subsels):
                if isinstance(key, int):
                    out = out | sub.mask(_t(comp) == key)
        for key, sub in zip(self.keys, self.subsels):
            if key is Ellipsis:
                out = out | sub
        return out


@Pytree.dataclass
class IdxSel(Selection):
    """Selects the subtree at a dynamic index (or tensor of indices).
    ``per_execution=True``: ``idx`` has the batch's shape, one address
    per execution."""

    idx: Any
    inner: Selection
    per_execution: bool = Pytree.static(default=False)

    def check(self) -> Flag:
        return False

    def get_subselection(self, comp) -> Selection:
        if isinstance(comp, str):
            return NoneSel()
        comp_arr = _t(comp)
        idx = _t(self.idx).to(comp_arr.device)
        if idx.ndim == 0 or self.per_execution:
            hit = comp_arr == idx
        else:
            hit = (comp_arr[..., None] == idx).any(dim=-1)
        if hit.ndim == 0:
            return self.inner.mask(bool(hit))
        return self.inner.mask(hit)


@Pytree.dataclass
class AboveIdxSel(Selection):
    """Selects every subtree at an integer component strictly above
    ``threshold`` (the later steps of a Scan trace, say)."""

    threshold: Any

    def check(self) -> Flag:
        return False

    def get_subselection(self, comp) -> Selection:
        if isinstance(comp, str):
            return NoneSel()
        if not isinstance(comp, torch.Tensor) and not isinstance(
                self.threshold, torch.Tensor):
            return AllSel().mask(bool(comp > self.threshold))
        return AllSel().mask(_t(comp) > _t(self.threshold))


@Pytree.dataclass
class ComplementSel(Selection):
    inner: Selection

    def check(self) -> Flag:
        return FlagOp.not_(self.inner.check())

    def get_subselection(self, comp) -> Selection:
        return ~self.inner.get_subselection(comp)


@Pytree.dataclass
class AndSel(Selection):
    left: Selection
    right: Selection

    def check(self) -> Flag:
        return FlagOp.and_(self.left.check(), self.right.check())

    def get_subselection(self, comp) -> Selection:
        return self.left.get_subselection(comp) & self.right.get_subselection(comp)


@Pytree.dataclass
class OrSel(Selection):
    left: Selection
    right: Selection

    def check(self) -> Flag:
        return FlagOp.or_(self.left.check(), self.right.check())

    def get_subselection(self, comp) -> Selection:
        return self.left.get_subselection(comp) | self.right.get_subselection(comp)


@Pytree.dataclass
class MaskedSel(Selection):
    inner: Selection
    flag: Flag

    def check(self) -> Flag:
        return FlagOp.and_(self.inner.check(), self.flag)

    def get_subselection(self, comp) -> Selection:
        return self.inner.get_subselection(comp).mask(self.flag)
