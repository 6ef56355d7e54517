"""``ChoiceMap``: a hierarchical map from addresses to random choices, an
algebra closed under filter / merge / mask / extend / switch
(counterpart of ``genjax_tpu/gfi/choice_map.py``).

Every tensor is concrete in eager PyTorch, so a dynamic-index lookup on
an :class:`Indexed` node with a Python-int address folds to a plain
slice; a tensor address lowers to ``argmax`` + gather + mask as in JAX.
Under a key batch the lane axis of an :class:`Indexed` node sits behind
the batch axes, at the node's ``batch_rank``. ``partition_values``
serves the gradient samplers. The port's own combinators record the
batch in each ``Indexed`` node's ``batch_rank``; ``lanes_leading`` serves
a choice map whose leaves were stacked under batch axes by hand (the
JAX package's layout after ``jax.vmap``) and moves the lanes ahead again.
"""

from __future__ import annotations

import abc
from typing import Any, Iterable, Mapping, Sequence

import torch

from genjax_torch.core.pytree import Pytree, tree_leaves, tree_map
from genjax_torch.core.typing import Flag
from genjax_torch.gfi.mask import Mask
from genjax_torch.gfi.selection import AllSel, NoneSel, Selection, addr_tuple

__all__ = [
    "ChoiceMap",
    "ChoiceMapBuilder",
    "ChoiceMapNoValueAtAddress",
    "ChmSel",
    "C",
    "Indexed",
    "lanes_leading",
    "lift_values",
    "partition_values",
]


class ChoiceMapNoValueAtAddress(Exception):
    """Raised when ``chm[addr]`` finds no value at ``addr``."""


def _is_static_comp(comp) -> bool:
    return isinstance(comp, (str, int))


def _t(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(x)


def _check_flag(flag, where: str):
    """A non-Selection ``filter``/``mask`` argument must be a boolean
    flag: a Python bool or a bool tensor."""
    if isinstance(flag, bool):
        return flag
    if isinstance(flag, torch.Tensor) and flag.dtype == torch.bool:
        return flag
    raise TypeError(
        f"ChoiceMap.{where} expects a Selection or a boolean flag, got "
        f"{type(flag).__name__}: {flag!r}."
    )


class ChoiceMap(Pytree):
    """Abstract choice-map node."""

    @abc.abstractmethod
    def get_value(self) -> Any:
        """The value at this node (possibly a :class:`Mask`), or ``None``."""

    @abc.abstractmethod
    def get_inner_map(self, comp) -> "ChoiceMap":
        """Descend one address component."""

    def filter(self, selection: Selection | Flag) -> "ChoiceMap":
        if not isinstance(selection, Selection):
            selection = AllSel().mask(_check_flag(selection, "filter"))
        if isinstance(selection, AllSel):
            return self
        if isinstance(selection, NoneSel):
            return ChoiceMap.empty()
        if self.static_is_empty():
            return self
        return Filtered(self, selection)

    def get_submap(self, *addresses) -> "ChoiceMap":
        chm = self
        for a in addresses:
            for comp in addr_tuple(a):
                chm = chm.get_inner_map(comp)
        return chm

    def __call__(self, *addresses) -> "ChoiceMap":
        return self.get_submap(*addresses)

    def __getitem__(self, addr):
        v = self.get_submap(addr).get_value()
        if v is None:
            raise ChoiceMapNoValueAtAddress(addr)
        return v

    def __contains__(self, addr) -> bool:
        return self.has_value_at(addr)

    def has_value(self) -> bool:
        return self.get_value() is not None

    def has_value_at(self, addr) -> bool:
        return self.get_submap(addr).has_value()

    def static_is_empty(self) -> bool:
        return False

    def mask(self, flag: Flag) -> "ChoiceMap":
        return self.filter(flag)

    def extend(self, *addrs) -> "ChoiceMap":
        """Nest under an address prefix: static components build trie
        nodes, tensor components :class:`Indexed` nodes, and the full
        slice ``:`` a canonical :class:`Indexed` over all lanes."""
        chm = self
        comps: list = []
        for a in addrs:
            comps.extend(addr_tuple(a))
        for comp in reversed(comps):
            if _is_static_comp(comp):
                chm = Static.build({comp: chm})
            elif isinstance(comp, slice):
                if comp != slice(None):
                    raise ValueError(
                        "only the full slice ':' is a valid address "
                        f"component, got {comp!r}"
                    )
                chm = Indexed(chm, None)
            else:
                chm = Indexed(chm, _t(comp))
        return chm

    def __or__(self, other: "ChoiceMap") -> "ChoiceMap":
        if self.static_is_empty():
            return other
        if other.static_is_empty():
            return self
        return Or(self, other)

    def __and__(self, other: "ChoiceMap") -> "ChoiceMap":
        return other.filter(self.get_selection())

    def get_selection(self) -> Selection:
        return ChmSel(self)

    @staticmethod
    def empty() -> "ChoiceMap":
        return Empty()

    @staticmethod
    def choice(v: Any) -> "ChoiceMap":
        return Choice(v)

    @staticmethod
    def entry(v: Any, *addrs) -> "ChoiceMap":
        if isinstance(v, ChoiceMap):
            chm = v
        elif isinstance(v, Mapping):
            chm = ChoiceMap.d(v)
        else:
            chm = Choice(v)
        return chm.extend(*addrs)

    @staticmethod
    def from_mapping(pairs: Iterable[tuple]) -> "ChoiceMap":
        chm: ChoiceMap = Empty()
        for addr, v in pairs:
            chm = chm | ChoiceMap.entry(v, *addr_tuple(addr))
        return chm

    @staticmethod
    def d(mapping: Mapping) -> "ChoiceMap":
        return ChoiceMap.from_mapping(mapping.items())

    @staticmethod
    def kw(**kwargs) -> "ChoiceMap":
        return ChoiceMap.d(kwargs)

    @staticmethod
    def switch(idx, chms: Sequence["ChoiceMap"]) -> "ChoiceMap":
        """Branch-select: values from ``chms[idx]``, others masked out."""
        if isinstance(idx, int):
            return chms[idx]
        return Switch(_t(idx), tuple(chms))

    def invalid_subset(self, gen_fn, args: tuple) -> "ChoiceMap | None":
        """The part of this map whose addresses ``gen_fn`` does not visit
        on ``args``, or ``None`` when everything matches."""
        from genjax_torch.core.compiler.staging import empty_trace

        shape_chm = empty_trace(gen_fn, args).get_choices()
        invalid = self.filter(~shape_chm.get_selection())

        def has_any_value(chm) -> bool:
            if chm.static_is_empty():
                return False
            v = chm.get_value()
            if isinstance(v, Mask):
                flag = v.flag
                return bool(_t(flag).any())
            if v is not None:
                return True
            if isinstance(chm, Static):
                return any(has_any_value(s) for s in chm.submaps)
            if isinstance(chm, (Indexed, Filtered)):
                return has_any_value(chm.inner)
            if isinstance(chm, Or):
                return has_any_value(chm.left) or has_any_value(chm.right)
            return True

        return invalid if has_any_value(invalid) else None

    @property
    def at(self) -> "ChoiceMapBuilder":
        return ChoiceMapBuilder(self, ())

    def __repr__(self):
        return f"<{type(self).__name__}>"


@Pytree.dataclass
class ChoiceMapBuilder(Pytree):
    """``chm.at["x", "y"].set(v)``: fluent construction / update."""

    base: ChoiceMap | None
    path: tuple

    def __getitem__(self, addr) -> "ChoiceMapBuilder":
        return ChoiceMapBuilder(self.base, self.path + addr_tuple(addr))

    def set(self, v) -> ChoiceMap:
        entry = ChoiceMap.entry(v, *self.path)
        if self.base is None or self.base.static_is_empty():
            return entry
        return entry | self.base


#: Module-level builder: ``C["x"].set(1.0)``.
C = ChoiceMapBuilder(None, ())


@Pytree.dataclass
class Empty(ChoiceMap):
    def get_value(self):
        return None

    def get_inner_map(self, comp) -> ChoiceMap:
        return self

    def filter(self, selection) -> ChoiceMap:
        return self

    def static_is_empty(self) -> bool:
        return True


@Pytree.dataclass
class Choice(ChoiceMap):
    """A single value at this node (possibly Mask-wrapped)."""

    v: Any

    def get_value(self):
        return self.v

    def get_inner_map(self, comp) -> ChoiceMap:
        if isinstance(comp, str):
            return Empty()
        if isinstance(comp, slice):
            if comp == slice(None):
                return self
            raise ValueError(
                "only the full slice ':' is a valid address component"
            )

        def ix(leaf):
            return leaf[comp]

        if isinstance(self.v, Mask):
            flag = self.v.flag
            if not isinstance(flag, bool) and _t(flag).ndim:
                flag = _t(flag)[comp]
            return Choice(Mask(tree_map(ix, self.v.value), flag))
        return Choice(tree_map(ix, self.v))

    def filter(self, selection) -> ChoiceMap:
        if not isinstance(selection, Selection):
            selection = AllSel().mask(_check_flag(selection, "filter"))
        out = Mask.maybe_mask(self.v, selection.check())
        if out is None:
            return Empty()
        return Choice(out)


@Pytree.dataclass
class Static(ChoiceMap):
    """Trie node with static (str/int) keys."""

    submaps: tuple
    keys: tuple = Pytree.static()

    @staticmethod
    def build(mapping: Mapping) -> "Static":
        keys = tuple(mapping.keys())
        return Static(tuple(mapping[k] for k in keys), keys)

    def get_value(self):
        return None

    def get_inner_map(self, comp) -> ChoiceMap:
        if _is_static_comp(comp):
            for k, sub in zip(self.keys, self.submaps):
                if k == comp:
                    return sub
            return Empty()
        out: ChoiceMap = Empty()
        for k, sub in zip(self.keys, self.submaps):
            if isinstance(k, int):
                out = out | sub.mask(_t(comp) == k)
        return out

    def filter(self, selection) -> ChoiceMap:
        """Eager filtering: statically excluded subtrees are pruned."""
        if not isinstance(selection, Selection):
            selection = AllSel().mask(_check_flag(selection, "filter"))
        kept = {}
        for k, sub in zip(self.keys, self.submaps):
            f = sub.filter(selection.get_subselection(k))
            if not f.static_is_empty():
                kept[k] = f
        if not kept:
            return Empty()
        return Static.build(kept)

    def mapping(self) -> dict:
        return dict(zip(self.keys, self.submaps))


def _lane_slice(tree, pos, batch_rank: int):
    """Index the lane axis of every leaf: the axis right after the
    ``batch_rank`` leading batch axes. ``pos`` is an int, a slice, a 0-d
    index (one lane for every execution), a tensor of the batch's shape
    (one lane per execution) or, unbatched, a vector of lanes. A leaf of
    rank ``batch_rank`` or less has no lane axis and passes through."""
    lead = (slice(None),) * batch_rank

    def pick(v):
        if not isinstance(v, torch.Tensor) or v.ndim <= batch_rank:
            return v
        if isinstance(pos, torch.Tensor) and batch_rank and pos.ndim:
            p = pos.to(device=v.device, dtype=torch.int64)
            p = p.reshape(tuple(p.shape) + (1,) * (v.ndim - batch_rank))
            p = p.expand(tuple(v.shape[:batch_rank]) + (1,)
                         + tuple(v.shape[batch_rank + 1:]))
            return torch.take_along_dim(v, p, dim=batch_rank).squeeze(
                batch_rank)
        if isinstance(pos, torch.Tensor):
            return v[lead + (pos.to(v.device),)]
        return v[lead + (pos,)]

    return tree_map(pick, tree)


def _lane_dropped(chm, r: int):
    """``chm`` after :func:`_lane_slice` took one lane of the axis at
    ``r`` away: a nested :class:`Indexed` node counted that axis among its
    batch axes (its ``batch_rank`` exceeds ``r``) and has one fewer."""
    if isinstance(chm, Indexed):
        rank = chm.batch_rank - 1 if chm.batch_rank > r else chm.batch_rank
        return Indexed(_lane_dropped(chm.inner, r), chm.idx, chm.n, rank,
                       chm.per_execution)
    if isinstance(chm, Static):
        return Static(tuple(_lane_dropped(c, r) for c in chm.submaps),
                      chm.keys)
    if isinstance(chm, Or):
        return Or(_lane_dropped(chm.left, r), _lane_dropped(chm.right, r))
    if isinstance(chm, Switch):
        return Switch(chm.idx, tuple(_lane_dropped(b, r)
                                     for b in chm.branches))
    if isinstance(chm, Filtered):
        return Filtered(_lane_dropped(chm.inner, r), chm.selection)
    return chm


def lift_values(chm: "ChoiceMap", batch: tuple, device=None,
                outer: tuple = ()) -> "ChoiceMap":
    """``chm`` with every value given the batch axes ``batch`` as a
    zero-stride view (``expand``, no copy): a caller's constraint made
    the same for every execution of a batched run. A Python value becomes
    a tensor on ``device``. Lane nodes (:class:`Indexed`) record the batch
    rank they gain.

    ``outer``: the batch the values already carry; the new axes go right
    behind it (a nested run's particle axis behind its caller's batch).
    A 0-d value is the same in every execution and is expanded over
    both; any other value must lead with ``outer``."""
    if not batch:
        return chm
    batch, outer = tuple(batch), tuple(outer)
    r = len(outer)

    def lift(v):
        t = v if isinstance(v, torch.Tensor) else torch.as_tensor(
            v, device=device)
        if r and t.ndim == 0:
            return t.expand(outer + batch)
        if tuple(t.shape[:r]) != outer:
            raise ValueError(
                f"a value of shape {tuple(t.shape)} under the batch {outer}: "
                "every tensor of a batched call leads with the batch")
        t = t.reshape(outer + (1,) * len(batch) + tuple(t.shape[r:]))
        return t.expand(outer + batch + tuple(t.shape[r + len(batch):]))

    def lift_flag(f):
        if not isinstance(f, torch.Tensor) or f.ndim < r or not r:
            return f
        return lift(f)

    def go(c):
        if isinstance(c, Choice):
            v = c.v
            if isinstance(v, Mask):
                return Choice(Mask(tree_map(lift, v.value),
                                   lift_flag(v.flag)))
            return Choice(tree_map(lift, v))
        if isinstance(c, Static):
            return Static(tuple(go(sub) for sub in c.submaps), c.keys)
        if isinstance(c, Indexed):
            if c.batch_rank < r:
                raise ValueError(
                    "a lane node without the caller's batch in a nested "
                    "batched run: lift it to the batch first")
            return Indexed(go(c.inner), c.idx, c.n,
                           c.batch_rank + len(batch))
        if isinstance(c, Or):
            return Or(go(c.left), go(c.right))
        if isinstance(c, Filtered):
            return Filtered(go(c.inner), c.selection)
        if isinstance(c, Switch):
            return Switch(c.idx, tuple(go(b) for b in c.branches))
        return c

    return go(chm)


@Pytree.dataclass
class Indexed(ChoiceMap):
    """Dynamic-index node: every leaf of ``inner`` has ``batch_rank``
    leading batch axes and then the lane axis; ``idx`` holds each lane's
    address, and ``idx=None`` means lane ``i`` is addressed by ``i``. The
    lane axis is found by its position, never by its length.

    ``per_execution=True``: one address per execution and no lane axis.
    ``idx`` has the batch's shape, and ``inner`` sits at address
    ``idx[b]`` of execution ``b`` (what ``extend`` of a traced 0-d index
    gives under ``jax.vmap``)."""

    inner: ChoiceMap
    idx: Any = None
    n: Any = Pytree.static(default=None)
    batch_rank: int = Pytree.static(default=0)
    per_execution: bool = Pytree.static(default=False)

    def _lane_leaf(self):
        for leaf in tree_leaves(self.inner):
            if isinstance(leaf, torch.Tensor) and leaf.ndim > self.batch_rank:
                return leaf
        return None

    def _n(self) -> int:
        if self.n is not None:
            return self.n
        leaf = self._lane_leaf()
        return 0 if leaf is None else leaf.shape[self.batch_rank]

    def _get_idx(self) -> torch.Tensor:
        if self.idx is None:
            leaf = self._lane_leaf()
            return torch.arange(self._n(), device=None if leaf is None
                                else leaf.device)
        return _t(self.idx)

    def get_value(self):
        return None

    def static_is_empty(self) -> bool:
        if self.per_execution:
            return self.inner.static_is_empty()
        if self.n == 0:
            return True
        if self.n is None and self.idx is None:
            leaf = self._lane_leaf()
            return leaf is not None and leaf.shape[self.batch_rank] == 0
        if self.idx is not None and _t(self.idx).ndim >= 1:
            return _t(self.idx).shape[0] == 0
        return False

    def get_inner_map(self, comp) -> ChoiceMap:
        if isinstance(comp, str):
            return Empty()
        if self.static_is_empty():
            return Empty()
        idx = self._get_idx()
        if self.per_execution:
            if isinstance(comp, slice):
                return self
            return self.inner.mask(_t(comp).to(idx.device) == idx)
        r = self.batch_rank
        if isinstance(comp, int) and idx.ndim == 1:
            hits = torch.nonzero(idx.cpu() == comp).flatten()
            if len(hits) == 0:
                return Empty()
            return _lane_dropped(_lane_slice(self.inner, int(hits[0]), r), r)
        if isinstance(comp, slice):
            if idx.ndim == 0:
                return self
            if comp == slice(None) and self.idx is None:
                return self.inner
            return Indexed(_lane_slice(self.inner, comp, r), idx[comp],
                           batch_rank=r)
        # The lane lookup runs where the lanes live (a Python or CPU
        # index meets a card trace on the card).
        leaf = self._lane_leaf()
        dev = idx.device if leaf is None else leaf.device
        comp, idx = _t(comp).to(dev), idx.to(dev)
        if idx.ndim == 0:
            extra = comp.ndim - r
            inner = self.inner
            if r and extra > 0:
                # comp's lanes sit behind the batch axes: give the
                # one-address values singleton lane axes there, so that
                # they broadcast against the per-lane flags.
                inner = tree_map(
                    lambda v: v.reshape(tuple(v.shape[:r]) + (1,) * extra
                                        + tuple(v.shape[r:]))
                    if isinstance(v, torch.Tensor) and v.ndim >= r else v,
                    inner)
            return inner.mask(comp == idx)
        if comp.ndim > 0 and r:
            # One lane per execution: comp has the batch's shape.
            eq = comp[..., None] == idx
            pos = torch.argmax(eq.to(torch.int32), dim=-1)
            return _lane_dropped(_lane_slice(self.inner, pos, r), r).mask(
                eq.any(dim=-1))
        if comp.ndim > 0:
            eq = idx[None, :] == comp[:, None]
            pos = torch.argmax(eq.to(torch.int32), dim=1)
            found = eq.any(dim=1)
            return _lane_slice(self.inner, pos, r).mask(found)
        eq = idx == comp
        pos = torch.argmax(eq.to(torch.int32))
        found = eq.any()
        return _lane_dropped(_lane_slice(self.inner, pos, r), r).mask(found)

    def filter(self, selection) -> ChoiceMap:
        if not isinstance(selection, Selection):
            selection = AllSel().mask(_check_flag(selection, "filter"))
        idx = self._get_idx()
        # The lanes' flags sit behind the batch axes, as the lanes do.
        sub = selection.get_subselection(
            idx.reshape((1,) * self.batch_rank + tuple(idx.shape)))
        filtered = self.inner.filter(sub)
        if filtered.static_is_empty():
            return Empty()
        return Indexed(filtered, self.idx, self.n, self.batch_rank,
                       self.per_execution)


@Pytree.dataclass
class Switch(ChoiceMap):
    """Masked branches selected by a tensor index."""

    idx: Any
    branches: tuple

    def get_value(self):
        vals = [
            Mask.maybe_mask(b.get_value(), _t(self.idx) == k)
            for k, b in enumerate(self.branches)
        ]
        present = [v for v in vals if v is not None]
        if not present:
            return None
        out = Mask.or_n(*[Mask.build(v) for v in present])
        return Mask.maybe_mask(out.value, out.flag)

    def get_inner_map(self, comp) -> ChoiceMap:
        return Switch(
            self.idx, tuple(b.get_inner_map(comp) for b in self.branches)
        )


@Pytree.dataclass
class Or(ChoiceMap):
    """Priority union: values in ``left`` win at overlapping addresses."""

    left: ChoiceMap
    right: ChoiceMap

    def get_value(self):
        a = self.left.get_value()
        b = self.right.get_value()
        if a is None and b is None:
            return None
        if a is None:
            return b
        if b is None:
            return a
        out = Mask.build(a) | Mask.build(b)
        return Mask.maybe_mask(out.value, out.flag)

    def get_inner_map(self, comp) -> ChoiceMap:
        return self.left.get_inner_map(comp) | self.right.get_inner_map(comp)

    def filter(self, selection) -> ChoiceMap:
        return self.left.filter(selection) | self.right.filter(selection)


@Pytree.dataclass
class Filtered(ChoiceMap):
    """Lazy filter of ``inner`` by a selection."""

    inner: ChoiceMap
    selection: Selection

    def get_value(self):
        v = self.inner.get_value()
        if v is None:
            return None
        return Mask.maybe_mask(v, self.selection.check())

    def get_inner_map(self, comp) -> ChoiceMap:
        sub = self.inner.get_inner_map(comp)
        return sub.filter(self.selection.get_subselection(comp))


def lanes_leading(chm: ChoiceMap, batch_ndim: int) -> ChoiceMap:
    """Rearrange a choice map whose leaves carry ``batch_ndim`` stacked
    leading axes (per-execution results stacked by hand, or what
    ``jax.vmap`` returns in the JAX package) so that :class:`Indexed` lane
    axes come before the batch axes again: a leaf under ``d`` nested
    Indexed nodes gets the layout ``(lane_1, ..., lane_d, B_1, ..., B_k,
    event...)`` and address indexing works as usual, with the batch axes
    trailing on the returned values. Leaves with fewer than ``batch_ndim +
    depth`` axes are left untouched. An explicit ``idx`` must be the same
    across the batch (one Indexed node holds one address per lane) and
    keeps its first batch entry; otherwise this raises ``ValueError``."""

    def fix_leaf(x, depth):
        if not isinstance(x, torch.Tensor) or x.ndim < batch_ndim + depth:
            return x
        return torch.movedim(x, tuple(range(batch_ndim)),
                             tuple(range(depth, depth + batch_ndim)))

    def walk(node, depth):
        if isinstance(node, Empty):
            return node
        if isinstance(node, Choice):
            return Choice(tree_map(lambda x: fix_leaf(x, depth), node.v))
        if isinstance(node, Static):
            return Static(tuple(walk(s, depth) for s in node.submaps),
                          node.keys)
        if isinstance(node, Or):
            return Or(walk(node.left, depth), walk(node.right, depth))
        if isinstance(node, Indexed):
            idx = node.idx
            if idx is not None:
                idx = _t(idx)
                if idx.ndim >= batch_ndim + 1:
                    flat = idx.reshape((-1,) + tuple(idx.shape[batch_ndim:]))
                    if not bool((flat == flat[0]).all()):
                        raise ValueError(
                            "lanes_leading: explicit Indexed addresses vary "
                            "across the batch axis — per-lane-varying "
                            "dynamic addresses are not representable by one "
                            "Indexed node; build per-lane constraints with "
                            "vmap instead.")
                    idx = idx[(0,) * batch_ndim]
            return Indexed(walk(node.inner, depth + 1), idx, node.n)
        if isinstance(node, Switch):
            idx = node.idx
            if isinstance(idx, torch.Tensor) and idx.ndim:
                idx = fix_leaf(idx, depth)
            return Switch(idx, tuple(walk(b, depth) for b in node.branches))
        if isinstance(node, Filtered):
            sel = tree_map(lambda x: fix_leaf(x, depth), node.selection)
            return Filtered(walk(node.inner, depth), sel)
        raise NotImplementedError(
            f"lanes_leading through {type(node).__name__} nodes.")

    return walk(chm, 0)


def partition_values(chm: ChoiceMap):
    """Split ``chm`` into ``(values, rebuild)``: ``values`` holds only the
    :class:`Choice` payloads (what a gradient sampler may move), and
    ``rebuild(new_values, extra=0)`` puts an identically structured
    choice map around new ones. Structural leaves (``Switch`` indices,
    ``Mask`` flags, ``Filtered`` selections, explicit ``Indexed``
    addresses) stay in the closure, out of a sampler's position vector.
    ``extra`` counts batch axes that the new values carry in front of
    the old ones (a sampler's draws axis): each ``Indexed`` node records
    them in its ``batch_rank``."""
    if isinstance(chm, Choice):
        v = chm.v
        if isinstance(v, Mask):
            flag = v.flag
            return v.value, lambda nv, extra=0: Choice(Mask(nv, flag))
        return v, lambda nv, extra=0: Choice(nv)
    if isinstance(chm, Empty):
        return (), lambda nv, extra=0: chm
    if isinstance(chm, Static):
        parts = [partition_values(sub) for sub in chm.submaps]
        keys = chm.keys
        return tuple(p[0] for p in parts), lambda nvs, extra=0: Static(
            tuple(p[1](nv, extra) for p, nv in zip(parts, nvs)), keys)
    if isinstance(chm, Or):
        lv, lr = partition_values(chm.left)
        rv, rr = partition_values(chm.right)
        return (lv, rv), lambda nvs, extra=0: Or(lr(nvs[0], extra),
                                                 rr(nvs[1], extra))
    if isinstance(chm, Indexed):
        iv, ir = partition_values(chm.inner)
        idx, n, rank = chm.idx, chm.n, chm.batch_rank
        return iv, lambda nv, extra=0: Indexed(ir(nv, extra), idx, n,
                                               rank + extra)
    if isinstance(chm, Switch):
        parts = [partition_values(b) for b in chm.branches]
        idx = chm.idx
        return tuple(p[0] for p in parts), lambda nvs, extra=0: Switch(
            idx, tuple(p[1](nv, extra) for p, nv in zip(parts, nvs)))
    if isinstance(chm, Filtered):
        iv, ir = partition_values(chm.inner)
        sel = chm.selection
        return iv, lambda nv, extra=0: Filtered(ir(nv, extra), sel)
    raise NotImplementedError(
        f"partition_values through {type(chm).__name__} nodes.")


@Pytree.dataclass
class ChmSel(Selection):
    """The selection of all addresses present in a choice map."""

    chm: ChoiceMap

    def check(self) -> Flag:
        v = self.chm.get_value()
        if v is None:
            return False
        if isinstance(v, Mask):
            return v.primal_flag()
        return True

    def get_subselection(self, comp) -> Selection:
        sub = self.chm.get_inner_map(comp)
        if sub.static_is_empty():
            return NoneSel()
        return ChmSel(sub)
