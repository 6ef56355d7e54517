"""``Switch``: run one of several generative functions, chosen by an index
argument (counterpart of ``genjax_tpu/lang/combinators/switch.py``).

Arguments are ``(idx, branch0_args, branch1_args, ...)``; an index out of
range clamps. A Python-int index runs its one branch, and the trace keeps
``None`` in place of the others. A tensor index is one per execution
(shape ``B``, or 0-d): every branch runs over the whole key batch and each
execution takes its own branch's results with ``torch.where``, which is
what JAX's ``switch`` does under ``vmap``. An untaken branch's trace is
zero in that execution's lanes (a placeholder), and the choices are a
``Switch`` choice map that masks each branch by the index.

Edits follow the JAX package, with one repair. An index-change ``Update``
weighs the new branch's ``generate`` weight against the old trace's score
(the JAX package returns the score difference, which is the same number
for a full constraint and wrong for a partial one); an index-change
``Regenerate`` contributes 0, since the fresh branch's density is the
forward proposal and the old branch's the backward one.
"""

from __future__ import annotations

from typing import Any, Callable, Sequence

import torch

from genjax_torch.core.compiler.interpreters.incremental import Diff
from genjax_torch.core.compiler.staging import multi_switch, tree_choose
from genjax_torch.core.pytree import Pytree
from genjax_torch.gfi.choice_map import ChoiceMap
from genjax_torch.gfi.choice_map import Switch as SwitchChm
from genjax_torch.gfi.concepts import Argdiffs, EditRequest, Score
from genjax_torch.gfi.gfn import GenerativeFunction, Trace
from genjax_torch.gfi.requests import Regenerate, Update
from genjax_torch.gfi.selection import Selection

__all__ = ["Switch", "SwitchTrace", "switch"]


def clamp_index(idx, n: int):
    """The branch index clamped to ``[0, n)``: a Python int stays one, a
    tensor becomes an int64 tensor."""
    if isinstance(idx, torch.Tensor):
        return idx.to(torch.int64).clamp(0, n - 1)
    return min(max(int(idx), 0), n - 1)


def run_branches(idx, fns: Sequence[Callable], arg_tuples: Sequence[tuple]):
    """Every branch's output: for a Python-int index the taken branch's,
    ``None`` for the others; for a tensor index every branch's, zeroed in
    the executions that do not take it."""
    if isinstance(idx, int):
        return [f(*a) if j == idx else None
                for j, (f, a) in enumerate(zip(fns, arg_tuples))]
    return multi_switch(idx, fns, arg_tuples)


@Pytree.dataclass
class SwitchTrace(Trace[Any]):
    """Every branch's subtrace (``None`` for an untaken branch under a
    Python-int index), with the return value and score already
    selected."""

    gen_fn: "Switch"
    args: tuple
    subtraces: tuple
    retval: Any
    score: Score

    def get_idx(self):
        return clamp_index(self.args[0], len(self.subtraces))

    def get_args(self) -> tuple:
        return self.args

    def get_retval(self):
        return self.retval

    def get_score(self) -> Score:
        return self.score

    def get_gen_fn(self):
        return self.gen_fn

    def get_choices(self) -> ChoiceMap:
        idx = self.get_idx()
        if isinstance(idx, int):
            return self.subtraces[idx].get_choices()
        return ChoiceMap.switch(idx, [tr.get_choices()
                                      for tr in self.subtraces])

    def get_inner_trace(self, address):
        idx = self.get_idx()
        if isinstance(idx, int):
            return self.subtraces[idx].get_inner_trace(address)
        # A tensor index: an address every branch has is selected per
        # execution; one that a single branch has is that branch's
        # subtrace (the caller reads which executions take it).
        subs, have = [], []
        for k, tr in enumerate(self.subtraces):
            try:
                subs.append(tr.get_inner_trace(address))
                have.append(k)
            except KeyError:
                pass
        if not subs:
            raise KeyError(f"No subtrace at address {address!r}")
        if len(subs) == 1:
            return subs[0]
        if len(subs) == len(self.subtraces):
            return tree_choose(idx, subs)
        raise NotImplementedError(
            f"address {address!r} exists in branches {have} but not all; "
            "select a branch with a Python-int index first")


@Pytree.dataclass
class Switch(GenerativeFunction[Any]):
    """``Switch(branches)``: arguments ``(idx, branch0_args, ...)``."""

    branches: tuple

    def _split_args(self, args, batch: tuple):
        idx, branch_args = args[0], tuple(args[1:])
        if len(branch_args) != len(self.branches):
            raise ValueError(
                f"Switch has {len(self.branches)} branches but got "
                f"{len(branch_args)} argument tuples")
        if isinstance(idx, torch.Tensor) and idx.ndim and \
                tuple(idx.shape) != tuple(batch):
            raise ValueError(
                f"a Switch index of shape {tuple(idx.shape)} under the batch "
                f"{tuple(batch)}: the index is one per execution")
        return clamp_index(idx, len(self.branches)), branch_args

    def _branch_views(self, chm: ChoiceMap) -> list:
        """Each branch's view of a constraint. A ``Switch`` choice map of
        this arity unzips, so that a branch scores only its own values
        (an untaken branch never sees another branch's value, which under
        a gradient could give a NaN); any other constraint is shared."""
        if isinstance(chm, SwitchChm) and \
                len(chm.branches) == len(self.branches):
            return list(chm.branches)
        return [chm] * len(self.branches)

    def _build(self, idx, args, subtraces) -> SwitchTrace:
        retval = tree_choose(idx, [None if tr is None else tr.get_retval()
                                   for tr in subtraces])
        score = tree_choose(idx, [None if tr is None else tr.get_score()
                                  for tr in subtraces])
        return SwitchTrace(self, args, tuple(subtraces), retval, score)

    def simulate(self, key, args: tuple) -> SwitchTrace:
        idx, branch_args = self._split_args(args, key.shape[:-1])
        subtraces = run_branches(idx, [b.simulate for b in self.branches],
                                 [(key, a) for a in branch_args])
        return self._build(idx, args, subtraces)

    def assess(self, chm: ChoiceMap, args: tuple, batch: tuple = ()):
        idx, branch_args = self._split_args(args, batch)
        fns = [lambda c, a, _b=b: _b.assess(c, a, batch=batch)
               for b in self.branches]
        outs = run_branches(idx, fns, list(zip(self._branch_views(chm),
                                               branch_args)))
        score = tree_choose(idx, [None if o is None else o[0] for o in outs])
        retval = tree_choose(idx, [None if o is None else o[1] for o in outs])
        return score, retval

    def generate(self, key, constraint: ChoiceMap, args: tuple):
        idx, branch_args = self._split_args(args, key.shape[:-1])
        outs = run_branches(
            idx, [b.generate for b in self.branches],
            [(key, c, a) for c, a in zip(self._branch_views(constraint),
                                          branch_args)])
        subtraces = [None if o is None else o[0] for o in outs]
        w = tree_choose(idx, [None if o is None else o[1] for o in outs])
        return self._build(idx, args, subtraces), w

    def project(self, key, trace: SwitchTrace, selection: Selection):
        idx = trace.get_idx()
        fns = [lambda k, tr, _b=b: _b.project(k, tr, selection)
               for b in self.branches]
        outs = run_branches(idx, fns, [(key, tr) for tr in trace.subtraces])
        return tree_choose(idx, outs)

    def edit(self, key, trace: SwitchTrace, request: EditRequest,
             argdiffs: Argdiffs):
        """With an unchanged index each branch serves the request on its
        own subtrace. With a (possibly) changed index the new branch is
        generated afresh under the constraint (:meth:`_edit_index_change`);
        the backward request of an ``Update`` then carries every old
        choice, which restores the old branch when replayed."""
        if not isinstance(request, (Update, Regenerate)):
            raise NotImplementedError(
                f"Switch does not support {type(request).__name__}")
        args = Diff.tree_primal(argdiffs)
        idx, branch_args = self._split_args(args, key.shape[:-1])
        if not Diff.static_check_no_change(argdiffs[0]):
            if isinstance(request, Regenerate):
                # Weight 0: w = [p(new) + q_bwd(old)] − [p(old) + q_fwd(new)]
                # with q_fwd(new) = p(new) and q_bwd(old) = p(old). The
                # enclosing handler adds the downstream likelihood change,
                # which is the MH ratio of this move.
                new_tr, _, retdiff, _ = self._edit_index_change(
                    key, trace, Update(ChoiceMap.empty()), idx, args,
                    branch_args)
                return (new_tr, torch.zeros_like(new_tr.get_score()),
                        retdiff, Regenerate(request.selection))
            return self._edit_index_change(key, trace, request, idx, args,
                                           branch_args)
        tangent = Diff.tree_tangent(argdiffs[1:])
        if isinstance(request, Update):
            reqs: list = [Update(v) for v in
                          self._branch_views(request.constraint)]
        else:
            reqs = [request] * len(self.branches)

        def branch_edit(req):
            def f(k, tr, a):
                new_tr, w, _, bwd = req.edit(k, tr, Diff.tree_diff(a, tangent))
                discard = (bwd.constraint if isinstance(bwd, Update)
                           else ChoiceMap.empty())
                return new_tr, w, discard
            return f

        outs = run_branches(idx, [branch_edit(r) for r in reqs],
                            [(key, tr, a) for tr, a in
                             zip(trace.subtraces, branch_args)])
        subtraces = [None if o is None else o[0] for o in outs]
        w = tree_choose(idx, [None if o is None else o[1] for o in outs])
        new_trace = self._build(idx, args, subtraces)
        if isinstance(request, Update):
            if isinstance(idx, int):
                discard = outs[idx][2]
            else:
                discard = ChoiceMap.switch(idx, [o[2] for o in outs])
            bwd: EditRequest = Update(discard)
        else:
            bwd = Regenerate(request.selection)
        return (new_trace, w, Diff.unknown_change(new_trace.get_retval()),
                bwd)

    def _edit_index_change(self, key, trace: SwitchTrace, request: Update,
                           idx, args, branch_args):
        """The new branch generated under the constraint. Its weight is
        ``generate``'s minus the old score: the new choices replace the
        old branch's entirely, the constrained ones scored and the rest
        proposed from the prior. For a full constraint this is the score
        difference."""
        outs = run_branches(
            idx, [b.generate for b in self.branches],
            [(key, c, a) for c, a in
             zip(self._branch_views(request.constraint), branch_args)])
        subtraces = [None if o is None else o[0] for o in outs]
        w_gen = tree_choose(idx, [None if o is None else o[1] for o in outs])
        new_trace = self._build(idx, args, subtraces)
        weight = w_gen - trace.get_score()
        return (new_trace, weight,
                Diff.unknown_change(new_trace.get_retval()),
                Update(trace.get_choices()))


def switch(*branches: GenerativeFunction) -> Switch:
    """``Switch`` over ``branches``."""
    from genjax_torch.core.argcheck import check_gen_fns

    check_gen_fns(branches, "switch")
    return Switch(tuple(branches))
