"""``Scan``: Markov composition ``(carry, x) -> (carry, out)`` of a
generative function over a sequence, and the combinators derived from it
(counterpart of ``genjax_tpu/lang/combinators/scan.py``).

``lax.scan`` becomes a Python loop over the steps: step ``t`` runs the
inner generative function on the whole key batch with key
``fold_in(key, t)``, as in JAX, and the steps' traces are stacked at the
axis right after the batch ``B``. Every tensor argument leads with ``B``
(the convention of ``gfi/gfn.py``), so the scanned inputs' step axis is
at ``len(B)``, whatever the lengths. Choices live under integer step
addresses. A step reads
its constraint and selection at a 0-d tensor index, as ``lax.scan``'s
traced index does in JAX, so that a masked constraint or selection takes
the same (tensor-flag) path and the same draws as there.

``IndexRequest`` edits take ``_edit_index_fast``, the O(1) repair of one
step that re-scores the next under the changed carry; under changed
arguments they lower to the whole-chain request. The repair runs one step
per execution (a 0-d index is the same step in all): steps ``t_b`` and
``t_b + 1`` are gathered per execution, and both branches of "is there a
next step" are computed and chosen per execution, as ``jax.vmap`` runs the
JAX repair.

A Scan of length 0 has no choices, score 0 and the initial carry as its
final one; its stacked trace and outputs have a step axis of length 0,
their shapes taken from one throwaway run of the inner function (eager
PyTorch has no shape-only evaluation).
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from genjax_torch.core import random
from genjax_torch.core.compiler.interpreters.incremental import (
    Diff,
    NoChange,
    UnknownChange,
)
from genjax_torch.core.pytree import Pytree, tree_leaves, tree_map
from genjax_torch.gfi.choice_map import ChoiceMap, Indexed
from genjax_torch.gfi.concepts import (
    Argdiffs,
    EditRequest,
    IndexRequest,
    Score,
)
from genjax_torch.gfi.gfn import GenerativeFunction, Trace
from genjax_torch.gfi.requests import Regenerate, Update
from genjax_torch.gfi.selection import IdxSel, Selection
from genjax_torch.lang.combinators.dimap import Dimap
from genjax_torch.lang.combinators.mask import MaskCombinator
from genjax_torch.lang.combinators.vmap import (
    batch_rank,
    carries_batch,
    lane_positions,
    put_lanes,
    shared,
    take_lane,
    take_lanes,
)

__all__ = [
    "Scan",
    "ScanTrace",
    "scan",
    "accumulate",
    "reduce",
    "iterate",
    "iterate_final",
    "masked_iterate",
    "masked_iterate_final",
    "prepend_initial_acc",
]


def _stack(items: list, batch: tuple, device):
    """Stack per-step pytrees at the axis after the batch. A leaf that is
    the same Python value in every step stays one value; a Python value
    is the same in every execution, and is expanded to the batch."""
    r = len(batch)

    def stack(*vs):
        if not any(isinstance(v, torch.Tensor) for v in vs) and \
                all(v == vs[0] for v in vs):
            return vs[0]
        return torch.stack([shared(v, batch, device) for v in vs], dim=r)

    return tree_map(stack, *items)


def _empty_steps(tree, batch: tuple, device):
    """``tree`` as a stack of no steps: every tensor with a step axis of
    length 0 after the batch; a Python value stays as it is."""
    r = len(batch)

    def empty(v):
        if not isinstance(v, torch.Tensor):
            return v
        return shared(v, batch, device).unsqueeze(r).narrow(r, 0, 0)

    return tree_map(empty, tree)


def _step_input(xs, t: int, batch: tuple):
    """Step ``t`` of the scanned inputs: their step axis follows the
    batch axes, which every tensor argument carries."""
    lead = (slice(None),) * len(batch)
    return tree_map(lambda v: carries_batch(v, batch)[lead + (t,)], xs)


@Pytree.dataclass
class ScanTrace(Trace[Any]):
    """The steps' traces stacked at the axis after the batch; the score
    is the sum of the step scores."""

    gen_fn: "Scan"
    inner: Trace
    args: tuple
    retval: Any
    n: int = Pytree.static()

    def get_args(self) -> tuple:
        return self.args

    def get_retval(self):
        return self.retval

    def get_gen_fn(self):
        return self.gen_fn

    def get_score(self) -> Score:
        return torch.as_tensor(self.inner.get_score()).sum(dim=-1)

    def get_choices(self) -> ChoiceMap:
        if self.n == 0:
            return ChoiceMap.empty()
        return Indexed(self.inner.get_choices(), None, self.n,
                       batch_rank(self))

    def get_inner_trace(self, address):
        if isinstance(address, str):
            return self.inner.get_inner_trace(address)
        return take_lane(self.inner, address, batch_rank(self))


@Pytree.dataclass
class Scan(GenerativeFunction[Any]):
    """``Scan(inner, length)``: ``inner`` maps ``(carry, x)`` to
    ``(carry, out)``; the scan maps ``(init, xs)`` to ``(final, outs)``."""

    inner: GenerativeFunction[Any]
    length: int | None = Pytree.static(default=None)

    def _n(self, args, batch: tuple) -> int:
        if self.length is not None:
            return self.length
        _, xs = args
        leaves = tree_leaves(xs)
        if not leaves:
            raise ValueError("Scan without length requires scanned inputs.")
        return int(carries_batch(leaves[0], batch).shape[len(batch)])

    def _run(self, key, args, step):
        """The loop shared by simulate, generate and edit: ``step(t,
        sub_key, carry, x) -> (trace, weight)``, ``t`` a 0-d tensor."""
        init, xs = args
        batch = tuple(key.shape[:-1])
        n = self._n(args, batch)
        if n == 0:
            return (self._empty(key, args),
                    torch.zeros(batch, device=key.device))
        carry, trs, ws, outs = init, [], [], []
        for t in range(n):
            x = None if xs is None else _step_input(xs, t, batch)
            tr, w = step(torch.tensor(t, device=key.device),
                         random.fold_in(key, t), carry, x)
            carry, out = tr.get_retval()
            trs.append(tr)
            ws.append(w)
            outs.append(out)
        retval = (carry, _stack(outs, batch, key.device))
        trace = ScanTrace(self, _stack(trs, batch, key.device), args,
                          retval, n)
        return trace, sum(ws[1:], ws[0])

    def _empty(self, key, args) -> ScanTrace:
        """The trace of no steps, shaped by one discarded inner run on a
        zero step input."""
        init, xs = args
        batch = tuple(key.shape[:-1])
        r = len(batch)
        x = None if xs is None else tree_map(
            lambda v: torch.zeros(
                batch + tuple(carries_batch(v, batch).shape[r + 1:]),
                dtype=v.dtype, device=v.device), xs)
        tr = self.inner.simulate(key, (init, x))
        outs = _empty_steps(tr.get_retval()[1], batch, key.device)
        return ScanTrace(self, _empty_steps(tr, batch, key.device), args,
                         (init, outs), 0)

    def simulate(self, key, args: tuple) -> ScanTrace:
        zero = torch.zeros((), device=key.device)
        return self._run(key, args, lambda t, k, c, x: (
            self.inner.simulate(k, (c, x)), zero))[0]

    def assess(self, chm: ChoiceMap, args: tuple, batch: tuple = ()):
        init, xs = args
        batch = tuple(batch)
        if self._n(args, batch) == 0:
            device = next((v.device for v in tree_leaves(args)
                           if isinstance(v, torch.Tensor)), None)
            key = random.key(0, device=device).expand(batch + (2,))
            return (torch.zeros(batch, device=device),
                    self._empty(key, args).get_retval())
        carry, score, outs = init, None, []
        for t in range(self._n(args, batch)):
            x = None if xs is None else _step_input(xs, t, batch)
            s, (carry, out) = self.inner.assess(
                chm.get_submap(torch.tensor(t)), (carry, x), batch=batch)
            score = s if score is None else score + s
            outs.append(out)
        device = score.device if isinstance(score, torch.Tensor) else None
        return score, (carry, _stack(outs, batch, device))

    def generate(self, key, constraint: ChoiceMap, args: tuple):
        return self._run(key, args, lambda t, k, c, x: self.inner.generate(
            k, constraint.get_submap(t), (c, x)))

    def project(self, key, trace: ScanTrace, selection: Selection):
        rank = batch_rank(trace)
        w = None
        for t in range(trace.n):
            wt = self.inner.project(random.fold_in(key, t),
                                    take_lane(trace.inner, t, rank),
                                    selection(torch.tensor(t,
                                                           device=key.device)))
            w = wt if w is None else w + wt
        if w is None:
            return torch.zeros_like(torch.as_tensor(trace.get_score()))
        return w

    def edit(self, key, trace: ScanTrace, request: EditRequest,
             argdiffs: Argdiffs):
        """Full re-scan: every step serves its sub-request under the
        recomputed carry, which counts as changed."""
        args = Diff.tree_primal(argdiffs)
        if isinstance(request, IndexRequest):
            if Diff.static_check_no_change(argdiffs):
                return self._edit_index_fast(key, trace, request)
            # Changed arguments: the O(1) repair would score from the
            # old step arguments, so lower to the whole-chain request. An
            # index per execution addresses each execution's own step, as
            # the JAX edit's traced index does under ``jax.vmap``.
            sub = request.subrequest
            per_exec = (isinstance(request.idx, torch.Tensor)
                        and request.idx.ndim > 0)
            if per_exec:
                batch = tuple(key.shape[:-1])
                if tuple(request.idx.shape) != batch:
                    raise ValueError(
                        f"Scan IndexRequest: an index of shape "
                        f"{tuple(request.idx.shape)} under the batch "
                        f"{batch}: give one index per execution, or a 0-d "
                        "one")
                idx = request.idx.to(key.device, torch.int64)
            if isinstance(sub, Update):
                request = Update(
                    Indexed(sub.constraint, idx, batch_rank=len(batch),
                            per_execution=True) if per_exec
                    else sub.constraint.extend(request.idx))
            elif isinstance(sub, Regenerate):
                request = Regenerate(
                    IdxSel(idx, sub.selection, per_execution=True)
                    if per_exec else sub.selection.extend(request.idx))
            else:
                # Re-score the chain under the new arguments, then serve
                # the index edit at arguments that no longer change.
                k_args, k_idx = random.split(key).unbind(-2)
                mid, w_args, _, _ = self.edit(
                    k_args, trace, Update(ChoiceMap.empty()), argdiffs)
                new_tr, w_idx, _, bwd = self._edit_index_fast(
                    k_idx, mid, request)
                return (new_tr, w_args + w_idx,
                        Diff.unknown_change(new_tr.get_retval()), bwd)
        if not isinstance(request, (Update, Regenerate)):
            raise NotImplementedError(
                f"Scan does not support {type(request).__name__}")
        rank = batch_rank(trace)
        discard = ChoiceMap.empty()

        def step(t, sub_key, carry, x):
            nonlocal discard
            if isinstance(request, Update):
                sub_req: EditRequest = Update(request.constraint.get_submap(t))
            else:
                sub_req = Regenerate(request.selection(t))
            new_tr, w, _, bwd = sub_req.edit(
                sub_key, take_lane(trace.inner, int(t), rank),
                Diff.unknown_change((carry, x)))
            if isinstance(bwd, Update) and \
                    not bwd.constraint.static_is_empty():
                discard = discard | bwd.constraint.extend(int(t))
            return new_tr, w

        new_trace, w = self._run(key, args, step)
        bwd = (Update(discard) if isinstance(request, Update)
               else Regenerate(request.selection))
        return new_trace, w, Diff.unknown_change(new_trace.get_retval()), bwd

    def _edit_index_fast(self, key, trace: ScanTrace, request: IndexRequest):
        """O(1) repair of step ``t_b`` in execution ``b``: edit it, re-score
        step ``t_b + 1`` under the new carry, and require that the carry
        out of ``t_b + 1`` is unchanged, so that no later step is touched.
        A 0-d index names the same step in every execution and must lie in
        range, as the JAX repair's check requires. An index of the batch's
        shape out of range does what ``jax.vmap`` of the JAX repair does:
        a negative one counts from the end, reads clamp into the steps and
        writes out of range are dropped; the carry check runs on the
        executions with ``0 <= t_b < n - 2``."""
        n, rank = trace.n, batch_rank(trace)
        batch = tuple(key.shape[:-1])
        t = request.idx
        if not isinstance(t, torch.Tensor) or t.ndim == 0:
            t = int(t)
            if not 0 <= t < n:
                raise IndexError("Scan IndexRequest: index out of range.")
            t = torch.full(batch, t, dtype=torch.int64, device=key.device)
        elif tuple(t.shape) != batch:
            raise ValueError(
                f"Scan IndexRequest: an index of shape {tuple(t.shape)} under "
                f"the batch {batch}: give one index per execution, or a 0-d "
                "one")
        else:
            t = t.to(key.device, torch.int64)

        def where(cond, a, b):
            """``a`` where ``cond`` (shape ``B``) holds, else ``b``, leaf
            by leaf; a Python value becomes a tensor beside a tensor."""
            def pick(x, y):
                tensors = [v for v in (x, y) if isinstance(v, torch.Tensor)]
                if not tensors:
                    return x if x is y or x == y else pick(torch.as_tensor(x),
                                                           y)
                ref = tensors[0]
                x = torch.as_tensor(x, dtype=ref.dtype, device=ref.device)
                y = torch.as_tensor(y, dtype=ref.dtype, device=ref.device)
                c = cond.reshape(tuple(cond.shape) + (1,) * (
                    max(x.ndim, y.ndim) - cond.ndim))
                return torch.where(c, x, y)
            return tree_map(pick, a, b)

        k_t, k_next = random.split(key).unbind(-2)
        at_t, read_t = lane_positions(t, n)
        sub_t = take_lanes(trace.inner, read_t, rank)
        new_t, w, _, bwd_t = request.subrequest.edit(
            k_t, sub_t, Diff.no_change(sub_t.get_args()))
        carry_t, out_t = new_t.get_retval()

        has_next = t < n - 1
        at_next, read_next = lane_positions(torch.clamp(t + 1, max=n - 1), n)
        sub_next = take_lanes(trace.inner, read_next, rank)
        old_carry, _ = sub_next.get_retval()
        _, x_next = sub_next.get_args()
        new_next, w_next, _, _ = Update(ChoiceMap.empty()).edit(
            k_next, sub_next, (Diff.tree_diff(carry_t, UnknownChange),
                               Diff.tree_diff(x_next, NoChange)))
        carry_next, out_next = new_next.get_retval()
        inside = (t >= 0) & (t < n - 2)
        for a, b in zip(tree_leaves(carry_next), tree_leaves(old_carry)):
            same = torch.isclose(torch.as_tensor(a), torch.as_tensor(b))
            same = same.reshape(tuple(inside.shape) + (-1,)).all(-1)
            if not bool((same | ~inside).all()):
                raise ValueError(
                    "Scan IndexRequest: the carry changed past step idx+1; "
                    "use a full Update/Regenerate edit instead.")

        # Without a next step the second write re-writes the repaired step.
        guarded = tree_map(
            lambda nx, sn, nt, st: sn if nx is sn and nt is st else
            where(has_next, nx, nt), new_next, sub_next, new_t, sub_t)
        new_inner = put_lanes(trace.inner, [(new_t, sub_t, at_t),
                                            (guarded, sub_next, at_next)],
                              n, rank)
        final, outs = trace.retval
        if outs is not None:
            # Step t + 1's output as the first write leaves it.
            first = (at_t == read_next) & (at_t >= 0) & (at_t < n)
            old_out_next = where(first, out_t,
                                 take_lanes(outs, read_next, rank))
            outs = put_lanes(outs, [
                (out_t, None, at_t),
                (where(has_next, out_next, old_out_next), None, at_next)],
                n, rank)
        final = where(t == n - 1, carry_t,
                      where(t == n - 2, carry_next, final))
        w = w + torch.where(has_next, w_next, torch.zeros_like(w_next))
        new_trace = ScanTrace(self, new_inner, trace.args, (final, outs), n)
        return (new_trace, w, Diff.unknown_change(new_trace.get_retval()),
                IndexRequest(request.idx, bwd_t))


def scan(*, n: int | None = None) -> Callable:
    """Decorator: ``@scan(n=10)`` over a ``(carry, x) -> (carry, out)``
    generative function."""

    def decorator(gen_fn: GenerativeFunction) -> Scan:
        return Scan(gen_fn, n)

    return decorator


# -- derived combinators ------------------------------------------------------
#
# Built as the JAX package builds them, from Dimap and MaskCombinator. The
# accumulator is prepended at the step axis, which follows the batch: that
# post-map takes the batch's shape (``post_batch``).


def prepend_initial_acc(args, ret, batch: tuple = ()):
    """The initial accumulator in front of the stacked outputs, at the
    step axis (the axis after the batch ``batch``)."""
    r = len(batch)

    def cat(init, accs):
        init = shared(init, tuple(batch), accs.device, accs.dtype)
        return torch.cat([init.unsqueeze(r), accs], dim=r)

    return tree_map(cat, args[0], ret)


def _prepend(args, ret, batch):
    return prepend_initial_acc(args, ret[1], batch)


def accumulate() -> Callable:
    """``(acc, x) -> acc``  =>  ``(init, xs) -> [init, acc1, ...]``."""

    def decorator(gen_fn: GenerativeFunction):
        return Dimap(gen_fn.map(lambda acc: (acc, acc)).scan(),
                     post=_prepend, post_batch=True)

    return decorator


def reduce() -> Callable:
    """``(acc, x) -> acc``  =>  ``(init, xs) -> final_acc``."""

    def decorator(gen_fn: GenerativeFunction):
        return gen_fn.map(lambda acc: (acc, None)).scan().map(
            lambda ret: ret[0])

    return decorator


def iterate(*, n: int) -> Callable:
    """``x -> x``  =>  ``x -> [x, f(x), f²(x), ...]`` (n + 1 values)."""

    def decorator(gen_fn: GenerativeFunction):
        step = gen_fn.dimap(pre=lambda carry, _: (carry,),
                            post=lambda args, ret: (ret, ret))
        return Dimap(step.scan(n=n), pre=lambda x: (x, None),
                     post=_prepend, post_batch=True)

    return decorator


def iterate_final(*, n: int) -> Callable:
    """``x -> x``  =>  ``x -> fⁿ(x)``."""

    def decorator(gen_fn: GenerativeFunction):
        step = gen_fn.dimap(pre=lambda carry, _: (carry,),
                            post=lambda args, ret: (ret, None))
        return step.scan(n=n).dimap(pre=lambda x: (x, None),
                                    post=lambda args, ret: ret[0])

    return decorator


def _masked_step(gen_fn: GenerativeFunction, keep_outs: bool):
    """``(carry, flag) -> (new, new or None)``: where the flag is False
    the step's choices are masked out, its score is 0 and the carry
    passes through."""

    def post(args, masked_ret):
        carry, _ = args
        new = masked_ret.unmask(default=carry)
        return (new, new if keep_outs else None)

    return MaskCombinator(gen_fn).dimap(
        pre=lambda carry, flag: (flag, carry), post=post)


def masked_iterate() -> Callable:
    """``x -> x``  =>  ``(x, flags) -> [x, ...]``, a step with flag False
    passing the carry through."""

    def decorator(gen_fn: GenerativeFunction):
        return Dimap(_masked_step(gen_fn, True).scan(), post=_prepend,
                     post_batch=True)

    return decorator


def masked_iterate_final() -> Callable:
    """Like :func:`masked_iterate`, returning only the final value."""

    def decorator(gen_fn: GenerativeFunction):
        return _masked_step(gen_fn, False).scan().map(lambda ret: ret[0])

    return decorator
