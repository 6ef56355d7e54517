"""``Vmap``: one independent execution of a generative function per lane
(counterpart of ``genjax_tpu/lang/combinators/vmap.py``).

There is no ``vmap`` to lean on: the lanes are a key batch. Under a key
of shape ``B + (2,)`` the inner generative function runs once on keys
``B + (n, 2)`` (lane ``i``'s key is ``fold_in(key, i)``, as in JAX), its
mapped arguments moved so that their lane axis sits right after ``B``,
and every tensor of the inner trace then leads with ``B + (n,)``. Every
tensor argument leads with ``B`` (the convention of ``gfi/gfn.py``), so
a mapped axis counts from ``len(B)``, whatever the lengths. The
lane's choices live under integer addresses (``chm[i, "x"]``), in an
``Indexed`` node whose ``batch_rank`` is ``len(B)``.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from genjax_torch.core import random
from genjax_torch.core.compiler.interpreters.incremental import Diff
from genjax_torch.core.pytree import Pytree, tree_leaves, tree_map
from genjax_torch.gfi.choice_map import (
    Choice,
    ChoiceMap,
    Empty,
    Filtered,
    Indexed,
    Or,
    Static,
)
from genjax_torch.gfi.choice_map import Switch as ChmSwitch
from genjax_torch.gfi.concepts import (
    Argdiffs,
    EditRequest,
    IndexRequest,
    Score,
)
from genjax_torch.gfi.gfn import GenerativeFunction, Trace
from genjax_torch.gfi.requests import Regenerate, Update
from genjax_torch.gfi.selection import Selection

__all__ = ["Vmap", "VmapTrace", "vmap"]


def carries_batch(v: torch.Tensor, batch: tuple) -> torch.Tensor:
    """``v``, a tensor that a call on the batch ``batch`` received,
    checked to lead with the batch. By the convention of ``gfi/gfn.py``
    every such tensor does (a ``@gen`` body lifts its constants before a
    traced call), so its batch rank is ``len(batch)`` whatever its
    length; one that does not is refused, never guessed."""
    if tuple(v.shape[:len(batch)]) != tuple(batch):
        raise ValueError(
            f"a tensor of shape {tuple(v.shape)} under the batch "
            f"{tuple(batch)}: every tensor argument of a batched call leads "
            "with the batch (lift a constant with expand)")
    return v


def shared(v, batch: tuple, device=None, dtype=None) -> torch.Tensor:
    """A Python value, the same in every execution, as a tensor with the
    batch in front (a zero-stride view); a tensor is checked to carry the
    batch already (:func:`carries_batch`)."""
    if isinstance(v, torch.Tensor):
        return carries_batch(v, batch)
    v = torch.as_tensor(v, device=device, dtype=dtype)
    return v.expand(tuple(batch) + tuple(v.shape))


def batch_rank(trace: Trace) -> int:
    """The batch rank of a lane-stacked trace: its inner score has the
    shape ``B + (n,)``."""
    return max(torch.as_tensor(trace.inner.get_score()).ndim - 1, 0)


def take_lane(tree, idx, rank: int):
    """Lane ``idx`` (an int or a 0-d tensor) of every leaf stacked at axis
    ``rank``; a leaf without that axis (a Python scalar) passes."""
    lead = (slice(None),) * rank

    def pick(v):
        if isinstance(v, torch.Tensor) and v.ndim > rank:
            return v[lead + (idx,)]
        return v

    return tree_map(pick, tree)


def lane_positions(idx: torch.Tensor, n: int):
    """A per-execution lane index (shape ``B``) as ``jax.vmap`` of an
    indexed edit reads it: a negative index counts from the end; a read
    clamps into ``[0, n)`` and a write out of range is dropped. Returns
    ``(at, read)``: the normalized index and the clamped one."""
    idx = idx.to(torch.int64)
    at = torch.where(idx < 0, idx + n, idx)
    return at, at.clamp(0, n - 1)


def take_lanes(tree, pos: torch.Tensor, rank: int):
    """Lane ``pos[b]`` of execution ``b`` (``pos`` of the batch's shape,
    in range) of every leaf stacked at axis ``rank``."""

    def pick(v):
        if not isinstance(v, torch.Tensor) or v.ndim <= rank:
            return v
        p = pos.to(v.device).reshape(tuple(pos.shape)
                                     + (1,) * (v.ndim - rank))
        p = p.expand(tuple(v.shape[:rank]) + (1,) + tuple(v.shape[rank + 1:]))
        return torch.take_along_dim(v, p, dim=rank).squeeze(rank)

    return tree_map(pick, tree)


def put_lanes(stacked, writes, n: int, rank: int):
    """Write lanes back into ``stacked``, in order: each of ``writes`` is
    ``(new, old, at)``, lane ``at[b]`` of execution ``b`` taking ``new``'s
    value; an execution whose ``at`` is out of ``[0, n)`` keeps its lane
    (a dropped write). A leaf that no write replaced (``new is old``)
    keeps the stacked tensor; any other is copied once and written in
    place."""
    lead = [(at.clamp(0, n - 1), (at >= 0) & (at < n)) for _, _, at in writes]

    def put(b, *leaves):
        if not isinstance(b, torch.Tensor) or b.ndim <= rank:
            return b
        out = None
        for v, o, (read, inside) in zip(leaves[0::2], leaves[1::2], lead):
            if v is o:
                continue
            shape = tuple(b.shape[:rank]) + (1,) + tuple(b.shape[rank + 1:])
            idx = read.reshape(tuple(read.shape)
                               + (1,) * (b.ndim - rank)).expand(shape)
            if out is None:
                out = b.clone()
            cur = torch.take_along_dim(out, idx, dim=rank)
            v = torch.as_tensor(v, dtype=b.dtype, device=b.device)
            v = v.expand(shape[:rank] + shape[rank + 1:]).unsqueeze(rank)
            keep = inside.reshape(tuple(inside.shape)
                                  + (1,) * (b.ndim - rank))
            out.scatter_(rank, idx, torch.where(keep, v, cur))
        return b if out is None else out

    trees = []
    for new, old, _ in writes:
        trees += [new, old]
    return tree_map(put, stacked, *trees)


def lane_constraint(chm: ChoiceMap, n: int, rank: int,
                    device=None) -> ChoiceMap:
    """The constraint of every lane at once, in the ``B + (n,)`` layout:
    lane ``i`` of the result holds what ``chm.get_submap(i)`` reads in the
    JAX package (there, per lane under ``jax.vmap``). Lane flags have the
    shape ``(1,) * rank + (n,)``, which broadcasts against the leading
    axes as every flag does.

    - a canonical ``Indexed`` node of ``n`` lanes is its stacked inner
      map; one with an index array (or of another length) gathers, for
      each lane, the first entry whose address is the lane's, masked
      where no entry has it; a scalar-address one is its inner map on
      the lane with that address;
    - an integer key ``k`` of a ``Static`` node is its submap masked to
      lane ``k``; string keys address no lane;
    - ``Or``, ``Filtered`` and ``Switch`` nodes map over their children
      (a ``Filtered`` node's selection read at each lane's address);
    - a ``Choice`` holds its values stacked at the lane axis already."""
    lanes = torch.arange(n, device=device)
    flag_shape = (1,) * rank + (n,)

    def spread(tree, r):
        """One lane's values given the lane axis (a zero-stride view)."""
        def go(v):
            if not isinstance(v, torch.Tensor) or v.ndim < r:
                return v
            return v.unsqueeze(r).expand(
                tuple(v.shape[:r]) + (n,) + tuple(v.shape[r:]))
        return tree_map(go, tree)

    if chm.static_is_empty():
        return Empty()
    if isinstance(chm, Choice):
        return chm
    if isinstance(chm, Indexed):
        r = chm.batch_rank
        if chm.idx is None and chm._n() == n:
            return chm.inner
        idx = chm._get_idx().to(device)
        if idx.ndim == 0:
            return spread(chm.inner, r).mask(
                (lanes == idx).reshape(flag_shape))
        eq = idx[None, :] == lanes[:, None]                       # (n, m)
        pos = torch.argmax(eq.to(torch.int32), dim=1)
        found = eq.any(dim=1)

        def gather(v):
            if not isinstance(v, torch.Tensor) or v.ndim <= r:
                return v
            return v.index_select(r, pos.to(v.device))

        return tree_map(gather, chm.inner).mask(found.reshape(flag_shape))
    if isinstance(chm, Or):
        return (lane_constraint(chm.left, n, rank, device)
                | lane_constraint(chm.right, n, rank, device))
    if isinstance(chm, Static):
        out: ChoiceMap = Empty()
        for k, sub in zip(chm.keys, chm.submaps):
            if isinstance(k, int):
                out = out | spread(sub, rank).mask(
                    (lanes == k).reshape(flag_shape))
        return out
    if isinstance(chm, Filtered):
        inner = lane_constraint(chm.inner, n, rank, device)
        return inner.filter(lane_selection(chm.selection, n, rank, device))
    if isinstance(chm, ChmSwitch):
        return ChmSwitch(chm.idx, tuple(
            lane_constraint(b, n, rank, device) for b in chm.branches))
    raise NotImplementedError(
        f"a {type(chm).__name__} choice map as a per-lane constraint")


def lane_selection(selection: Selection, n: int, rank: int,
                   device=None) -> Selection:
    """The selection of every lane at once, its flags in the lane layout."""
    return selection(torch.arange(n, device=device).reshape(
        (1,) * rank + (n,)))


def _device(tree):
    for leaf in tree_leaves(tree):
        if isinstance(leaf, torch.Tensor):
            return leaf.device
    return None


def _axes(in_axes, args) -> tuple:
    if isinstance(in_axes, tuple):
        if len(in_axes) != len(args):
            raise ValueError(f"Vmap in_axes has {len(in_axes)} entries for "
                             f"{len(args)} arguments.")
        return in_axes
    return (in_axes,) * len(args)


def _leaf_axis(leaf, ax: int, batch: tuple) -> int:
    """The position of a mapped leaf's lane axis: ``ax`` counted after the
    batch axes, which the leaf carries."""
    if not isinstance(leaf, torch.Tensor):
        raise ValueError(f"Vmap in_axes={ax} is out of bounds for a Python "
                         "value.")
    carries_batch(leaf, batch)
    r = len(batch)
    nd = leaf.ndim - r
    if not -nd <= ax < nd:
        raise ValueError(f"Vmap in_axes={ax} is out of bounds for a leaf of "
                         f"rank {nd} behind the batch {tuple(batch)}.")
    return r + (ax % nd)


@Pytree.dataclass
class VmapTrace(Trace[Any]):
    """The lanes' inner trace, every tensor stacked at the axis after the
    batch; the score is the sum of the lane scores."""

    gen_fn: "Vmap"
    inner: Trace
    args: tuple
    n: int = Pytree.static()

    def get_args(self) -> tuple:
        return self.args

    def get_retval(self):
        return self.inner.get_retval()

    def get_gen_fn(self):
        return self.gen_fn

    def get_score(self) -> Score:
        return torch.as_tensor(self.inner.get_score()).sum(dim=-1)

    def get_choices(self) -> ChoiceMap:
        return Indexed(self.inner.get_choices(), None, self.n,
                       batch_rank(self))

    def get_inner_trace(self, address):
        if isinstance(address, str):
            return self.inner.get_inner_trace(address)
        return take_lane(self.inner, address, batch_rank(self))


@Pytree.dataclass
class Vmap(GenerativeFunction[Any]):
    """``Vmap(inner, in_axes)``: one independent draw of ``inner`` per
    lane; choices under integer lane addresses."""

    inner: GenerativeFunction[Any]
    in_axes: Any = Pytree.static(default=0)
    axis_size: int | None = Pytree.static(default=None)

    def _n(self, args, batch: tuple) -> int:
        sizes = set()
        if self.in_axes is not None:
            for ax, arg in zip(_axes(self.in_axes, args), args):
                if ax is None:
                    continue
                for leaf in tree_leaves(arg):
                    sizes.add(int(leaf.shape[_leaf_axis(leaf, ax, batch)]))
        if len(sizes) > 1:
            raise ValueError("Vmap mapped arguments disagree on the "
                             f"mapped-axis length: {sorted(sizes)}.")
        if self.axis_size is not None:
            if sizes and sizes != {self.axis_size}:
                raise ValueError(f"Vmap axis_size={self.axis_size} but mapped "
                                 f"arguments have length {sizes.pop()}.")
            return self.axis_size
        if sizes:
            return sizes.pop()
        raise ValueError("Could not infer Vmap axis size; pass axis_size.")

    def _lane_args(self, args, batch: tuple, n: int) -> tuple:
        """Every tensor argument in the ``B + (n,)`` layout: a mapped one
        with its lane axis moved behind the batch, an unmapped one
        expanded over the lanes; Python scalars pass."""
        lanes = tuple(batch) + (n,)
        axes = (_axes(self.in_axes, args) if self.in_axes is not None
                else (None,) * len(args))

        def mapped(ax):
            def move(v):
                return torch.movedim(v, _leaf_axis(v, ax, batch), len(batch))
            return move

        def unmapped(v):
            if not isinstance(v, torch.Tensor):
                return v
            carries_batch(v, batch)
            return v.unsqueeze(len(batch)).expand(
                lanes + tuple(v.shape[len(batch):]))

        return tuple(tree_map(unmapped if ax is None else mapped(ax), a)
                     for ax, a in zip(axes, args))

    def _setup(self, key, args):
        batch = tuple(key.shape[:-1])
        n = self._n(args, batch)
        keys = random.fold_in(key.unsqueeze(-2),
                              torch.arange(n, device=key.device))
        return batch, n, keys, self._lane_args(args, batch, n)

    def simulate(self, key, args: tuple) -> VmapTrace:
        _, n, keys, lane_args = self._setup(key, args)
        return VmapTrace(self, self.inner.simulate(keys, lane_args), args, n)

    def assess(self, chm: ChoiceMap, args: tuple, batch: tuple = ()):
        batch = tuple(batch)
        n = self._n(args, batch)
        score, retval = self.inner.assess(
            lane_constraint(chm, n, len(batch), _device(args)),
            self._lane_args(args, batch, n), batch=batch + (n,))
        return torch.as_tensor(score).sum(dim=-1), retval

    def generate(self, key, constraint: ChoiceMap, args: tuple):
        batch, n, keys, lane_args = self._setup(key, args)
        tr, w = self.inner.generate(
            keys, lane_constraint(constraint, n, len(batch), key.device),
            lane_args)
        return VmapTrace(self, tr, args, n), torch.as_tensor(w).sum(-1)

    def project(self, key, trace: VmapTrace, selection: Selection):
        n, rank = trace.n, batch_rank(trace)
        keys = random.fold_in(key.unsqueeze(-2),
                              torch.arange(n, device=key.device))
        w = self.inner.project(keys, trace.inner,
                               lane_selection(selection, n, rank, key.device))
        return torch.as_tensor(w).sum(dim=-1)

    def edit(self, key, trace: VmapTrace, request: EditRequest,
             argdiffs: Argdiffs):
        args = Diff.tree_primal(argdiffs)
        unchanged = Diff.static_check_no_change(argdiffs)
        batch, n, keys, lane_args = self._setup(key, args)
        rank = len(batch)
        if isinstance(request, IndexRequest):
            return self._edit_index(keys, trace, request, args, lane_args,
                                    unchanged)
        if isinstance(request, Update):
            sub: EditRequest = Update(
                lane_constraint(request.constraint, n, rank, key.device))
        elif isinstance(request, Regenerate):
            sub = Regenerate(lane_selection(request.selection, n, rank,
                                            key.device))
        else:
            raise NotImplementedError(
                f"Vmap does not support {type(request).__name__}")
        lane_diffs = (Diff.no_change(lane_args) if unchanged
                      else Diff.unknown_change(lane_args))
        new_inner, w, _, bwd = sub.edit(keys, trace.inner, lane_diffs)
        new_trace = VmapTrace(self, new_inner, args, n)
        if isinstance(request, Update):
            discard = bwd.constraint if isinstance(bwd, Update) \
                else ChoiceMap.empty()
            bwd = Update(ChoiceMap.empty() if discard.static_is_empty()
                         else Indexed(discard, None, n, rank))
        else:
            bwd = Regenerate(request.selection)
        return (new_trace, torch.as_tensor(w).sum(dim=-1),
                Diff.unknown_change(new_trace.get_retval()), bwd)

    def _edit_index(self, keys, trace: VmapTrace, request: IndexRequest,
                    args, lane_args, unchanged: bool):
        """Edit one lane of each execution: a gather of the lane, the
        sub-request, a scatter back. A 0-d index names the same lane in
        every execution, an index of the batch's shape one lane each; out
        of range, both do what the JAX package's indexing does
        (:func:`lane_positions`)."""
        rank = batch_rank(trace)
        batch = tuple(keys.shape[:rank])
        idx = torch.as_tensor(request.idx, device=keys.device)
        if idx.ndim == 0:
            idx = idx.expand(batch)
        elif tuple(idx.shape) != batch:
            raise ValueError(
                f"IndexRequest: an index of shape {tuple(idx.shape)} under "
                f"the batch {batch}: give one index per execution, or a 0-d "
                "one")
        at, read = lane_positions(idx, trace.n)
        lane = take_lanes(trace.inner, read, rank)
        one_args = take_lanes(lane_args, read, rank)
        lane_diffs = (Diff.no_change(one_args) if unchanged
                      else Diff.unknown_change(one_args))
        new_lane, w, _, bwd = request.subrequest.edit(
            take_lanes(keys, read, rank), lane, lane_diffs)
        new_inner = put_lanes(trace.inner, [(new_lane, lane, at)], trace.n,
                              rank)
        new_trace = VmapTrace(self, new_inner, args, trace.n)
        return (new_trace, w, Diff.unknown_change(new_trace.get_retval()),
                IndexRequest(request.idx, bwd))


def vmap(*, in_axes=0, axis_size=None) -> Callable:
    """Decorator form of ``gf.vmap(...)``."""
    from genjax_torch.core.argcheck import check_in_axes

    check_in_axes(in_axes, "vmap")

    def decorator(gen_fn: GenerativeFunction) -> Vmap:
        return Vmap(gen_fn, in_axes, axis_size)

    return decorator
