"""The ``@gen`` static modeling language (counterpart of
``genjax_tpu/lang/static.py``).

The body runs as plain Python under a dynamic handler stack:
``gf(args) @ "addr"`` dispatches to the innermost active handler, which
simulates, scores or constrains that site. Per-site keys are
``fold_in(key, site_counter)``, as in JAX, so the same key data gives the
same draws. A key batch ``B + (2,)`` runs ``B`` executions at once.

Under a batch the handler knows which tensors of the body are
per-execution, as JAX's batching tracer does: the body's arguments and
its traced calls' return values, and whatever a torch operation computes
from them (:class:`_Provenance`). Every other tensor is a constant of the
body; it is expanded to ``B`` (a zero-stride view) before it reaches a
traced call or leaves in the return value, so that every tensor a
generative function receives or a trace holds leads with ``B``, whatever
its length.

``edit`` serves ``Update``, ``Regenerate`` and ``StaticRequest``: the
body runs again under an edit handler, each visited site edits its old
subtrace (or is generated / simulated when it is new), and dropped sites
leave the weight. By default (``FINE_GRAINED_EDITS``) a site's arguments
count as changed leaf by leaf, as the body's own torch operations carry
a change from the changed arguments and sites (``static_edit.py``), so
a site is re-scored only when a value feeding it changed. The coarse
rule, what the flag selects when off and what a body that reads a
changed tensor's value into Python falls back on, counts every site as
changed once any argument or earlier return value did. The two give the
same draws and weights; :data:`edit_stats` counts the sites re-scored.
"""

from __future__ import annotations

import contextlib
import contextvars
import functools
import weakref
from typing import Any, Callable

import torch
from torch.overrides import TorchFunctionMode

from genjax_torch.core import random
from genjax_torch.core.compiler.interpreters.incremental import Diff
from genjax_torch.core.pytree import Pytree, tree_leaves, tree_map
from genjax_torch.gfi.choice_map import ChoiceMap
from genjax_torch.gfi.concepts import Argdiffs, EditRequest, Score
from genjax_torch.gfi.gfn import GenerativeFunction, Trace, check_batch_args
from genjax_torch.gfi.requests import Regenerate, Update
from genjax_torch.gfi.selection import NoneSel, Selection

__all__ = [
    "gen",
    "Fn",
    "StaticTrace",
    "StaticRequest",
    "trace_here",
    "check_top_level_args",
    "edit_stats",
    "AddressReuse",
    "MissingAddress",
]

#: Fine-grained edits (``static_edit.py``): a site is re-scored only when
#: a value feeding it changed. False selects the coarse rule.
FINE_GRAINED_EDITS = True

#: handle_kwargs wrappers for sources without a ``__dict__`` (see
#: :meth:`Fn.handle_kwargs`).
_KWARGED_FNS: dict = {}


class EditStats:
    """What ``@gen`` edits cost: ``sites_rescored`` counts the visited
    sites whose sub-edit had work to do (an argument changed, the request
    names the site, or the site is new), on both paths;
    ``fine`` / ``coarse`` count the edits each path served (a fallback
    counts once on each)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.sites_rescored = 0
        self.fine = 0
        self.coarse = 0


#: The counts of every ``Fn.edit`` of the process.
edit_stats = EditStats()


class AddressReuse(Exception):
    """Same address traced twice in one ``@gen`` body."""


class MissingAddress(Exception):
    """``assess`` called with a choice map missing a traced address."""


#: The active handlers, innermost last. A context variable, so that
#: threads and tasks each see their own stack.
_HANDLERS: contextvars.ContextVar[tuple] = contextvars.ContextVar(
    "genjax_torch_handlers", default=()
)


def check_top_level_args(args: tuple, batch: tuple) -> None:
    """:func:`~genjax_torch.gfi.gfn.check_batch_args` for a call made
    outside every ``@gen`` body (inside one, the handler has lifted the
    body's constants already)."""
    if batch and not _HANDLERS.get():
        check_batch_args(args, batch)


def trace_here(addr, gen_fn: GenerativeFunction, args: tuple):
    """Record a traced call at ``addr`` under the innermost handler (the
    runtime of ``gf(args) @ "addr"``)."""
    stack = _HANDLERS.get()
    if not stack:
        raise RuntimeError(
            "Traced calls (`gf(args) @ addr`) only make sense inside a "
            "@gen function body being executed by the GFI."
        )
    if isinstance(addr, tuple):
        if not addr or not all(isinstance(c, (str, int)) for c in addr):
            raise TypeError(
                "Tupled trace addresses must be non-empty tuples of "
                f"static str/int components, got {addr!r}."
            )
        if len(addr) == 1:
            addr = addr[0]
    elif not isinstance(addr, (str, int)):
        raise TypeError(
            f"Trace addresses must be static str or int, got {addr!r}."
        )
    return stack[-1].call(addr, gen_fn, args)


def _tensors(obj):
    """The tensors among a torch call's arguments or results (nested in
    lists, tuples and dicts)."""
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, (list, tuple)):
        for o in obj:
            yield from _tensors(o)
    elif isinstance(obj, dict):
        for o in obj.values():
            yield from _tensors(o)


class _Provenance(TorchFunctionMode):
    """Active while a batched body's own code runs: every tensor that a
    torch operation computes from a marked tensor is marked too. The
    body's arguments and its traced calls' return values are marked, so
    an unmarked tensor is a constant of the body (made by a factory,
    closed over, or computed from constants alone). A value made from a
    marked tensor's shape only (``torch.zeros(x.shape)``) is a constant:
    write ``torch.zeros_like(x)`` for a per-execution one."""

    def __init__(self, batch: tuple):
        super().__init__()
        self.batch = batch
        self._marked: dict = {}

    def _mark_one(self, t: torch.Tensor):
        self._marked[id(t)] = weakref.ref(t)

    def mark(self, tree):
        for v in tree_leaves(tree):
            if isinstance(v, torch.Tensor):
                self._mark_one(v)
        return tree

    def carries(self, v: torch.Tensor) -> bool:
        ref = self._marked.get(id(v))
        return ref is not None and ref() is v

    def lift(self, tree):
        """``tree`` with every constant tensor expanded to the batch."""
        if not self.batch:
            return tree
        return tree_map(
            lambda v: v.expand(self.batch + tuple(v.shape))
            if isinstance(v, torch.Tensor) and not self.carries(v) else v,
            tree)

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if any(self.carries(t) for t in _tensors((args, kwargs))):
            for t in _tensors(out):
                self._mark_one(t)
        return out

    @contextlib.contextmanager
    def suspended(self):
        """Off while the handler serves a traced call: the callee's own
        operations are not the body's."""
        self.__exit__(None, None, None)
        try:
            yield
        finally:
            self.__enter__()


def validate_new_address(addresses, addr):
    """Exact reuse and prefix conflicts (``("x", "y")`` after ``"x"``)
    both raise :class:`AddressReuse`."""
    if addr in addresses:
        raise AddressReuse(addr)
    t = addr if isinstance(addr, tuple) else (addr,)
    for seen in addresses:
        s = seen if isinstance(seen, tuple) else (seen,)
        k = min(len(s), len(t))
        if s[:k] == t[:k]:
            raise AddressReuse(addr)


def _zeros(key: torch.Tensor) -> torch.Tensor:
    return torch.zeros(tuple(key.shape[:-1]), dtype=torch.float32,
                       device=key.device)


class StaticHandler:
    """Base: bookkeeping shared by the GFI transforms. ``batch`` is the
    shape of the executions' batch (the key's, or ``assess``'s
    ``batch``)."""

    def __init__(self, batch: tuple = ()):
        self.addresses: list = []
        self.subtraces: list[Trace] = []
        self.batch = tuple(batch)
        self.provenance: _Provenance | None = None
        self._token = None

    def visit(self, addr):
        validate_new_address(self.addresses, addr)
        self.addresses.append(addr)

    def record(self, subtrace: Trace):
        self.subtraces.append(subtrace)

    def body_mode(self) -> "_Provenance | None":
        """The mode the body's own operations run under: under a batch,
        one that tells its constants apart."""
        return _Provenance(self.batch) if self.batch else None

    def run(self, source: Callable, args: tuple):
        """Run the body under this handler; under a batch, with its
        constants told apart (:class:`_Provenance`) and the return
        value's constants lifted."""
        with self:
            mode = self.provenance = self.body_mode()
            if mode is None:
                return source(*args)
            mode.mark(args)
            with mode:
                retval = source(*args)
            return mode.lift(retval)

    def call(self, addr, gen_fn: GenerativeFunction, args: tuple):
        """A traced call from the body: its constant arguments lifted to
        the batch, its return value per-execution."""
        mode = self.provenance
        if mode is None:
            return self.handle(addr, gen_fn, args)
        with mode.suspended():
            retval = self.handle(addr, gen_fn, mode.lift(args))
        return mode.mark(retval)

    def handle(self, addr, gen_fn: GenerativeFunction, args: tuple):
        raise NotImplementedError

    def __enter__(self):
        self._token = _HANDLERS.set(_HANDLERS.get() + (self,))
        return self

    def __exit__(self, *exc):
        _HANDLERS.reset(self._token)
        return False


class SimulateHandler(StaticHandler):
    def __init__(self, key):
        super().__init__(key.shape[:-1])
        self.key = key
        self.counter = 0

    def handle(self, addr, gen_fn, args):
        self.visit(addr)
        sub_key = random.fold_in(self.key, self.counter)
        self.counter += 1
        subtrace = gen_fn.simulate(sub_key, args)
        self.record(subtrace)
        return subtrace.get_retval()


class AssessHandler(StaticHandler):
    def __init__(self, chm: ChoiceMap, batch: tuple = ()):
        super().__init__(batch)
        self.chm = chm
        self.score = torch.zeros(())

    def handle(self, addr, gen_fn, args):
        self.visit(addr)
        submap = self.chm.get_submap(addr)
        if submap.static_is_empty():
            raise MissingAddress(addr)
        score, retval = gen_fn.assess(submap, args, batch=self.batch)
        self.score = self.score + score
        return retval


class GenerateHandler(StaticHandler):
    def __init__(self, key, constraint: ChoiceMap):
        super().__init__(key.shape[:-1])
        self.key = key
        self.constraint = constraint
        self.counter = 0
        self.weight = _zeros(key)

    def handle(self, addr, gen_fn, args):
        self.visit(addr)
        sub_key = random.fold_in(self.key, self.counter)
        self.counter += 1
        subtrace, w = gen_fn.generate(sub_key, self.constraint.get_submap(addr),
                                      args)
        self.weight = self.weight + w
        self.record(subtrace)
        return subtrace.get_retval()


class _EditHandler(StaticHandler):
    """Bookkeeping shared by the three edit handlers: the old trace, the
    per-site key counter, the weight, and whether anything upstream
    changed. Without a ``tracker`` a site's arguments count as changed
    once any argument or earlier return value did (the coarse rule);
    with one (``static_edit.ChangeTracker``), leaf by leaf as the body's
    operations carried a change to them, and a site whose arguments did
    not change and whose request is empty keeps its old subtrace without
    an edit (the identity, weight 0). Its key is not derived, but the key
    counter moves on, so every other site draws from the key it draws
    from on the coarse path."""

    def __init__(self, key, previous: "StaticTrace", args_changed: bool,
                 tracker=None):
        super().__init__(key.shape[:-1])
        self.key = key
        self.previous = previous
        self.counter = 0
        self.weight = _zeros(key)
        self.any_change = args_changed
        self.tracker = tracker

    def body_mode(self):
        return self.tracker if self.tracker is not None \
            else super().body_mode()

    def next_key(self):
        sub_key = random.fold_in(self.key, self.counter)
        self.counter += 1
        return sub_key

    def site_argdiffs(self, gen_fn, args, old_sub, named: bool):
        """The site's argdiffs, or ``None`` when the fine path keeps the
        old subtrace as it is. Counts the site as re-scored when it is
        edited with a changed argument or a request with work to do
        (``named``), or is new."""
        if self.tracker is not None:
            diffs = self.tracker.argdiffs(gen_fn, args)
        else:
            diffs = (Diff.unknown_change(args) if self.any_change
                     else Diff.no_change(args))
        changed = not Diff.static_check_no_change(diffs)
        if (self.tracker is not None and old_sub is not None and not named
                and not changed):
            return None
        if named or changed or old_sub is None:
            edit_stats.sites_rescored += 1
        return diffs

    def keep(self, old_sub):
        """The old subtrace, unedited."""
        self.counter += 1
        self.record(old_sub)
        return old_sub.get_retval()

    def new_site(self, retval):
        """A site the old trace did not have: its value is new."""
        self.any_change = True
        if self.tracker is not None:
            self.tracker.tag_changed(retval)

    def old_subtrace(self, addr):
        try:
            return self.previous.get_inner_trace(addr)
        except KeyError:
            return None

    def note(self, retdiff, retval):
        if not Diff.static_check_no_change(retdiff):
            self.any_change = True
            if self.tracker is not None:
                self.tracker.tag_changed(retval)

    def retval_changed(self, retval) -> bool:
        if self.tracker is None:
            return self.any_change
        return self.dropped_any or self.tracker.any_changed(retval)

    dropped_any = False

    def dropped(self):
        """The old trace's sites that this execution did not visit."""
        visited = set(self.addresses)
        return [(addr, sub) for addr, sub in zip(self.previous.addresses,
                                                 self.previous.subtraces)
                if addr not in visited]


class UpdateHandler(_EditHandler):
    """Serve ``Update(constraint)``: constrained sites take their new
    values, the rest replay (rescored under changed arguments); a newly
    visited site is generated under its constraint."""

    def __init__(self, key, previous, constraint: ChoiceMap,
                 args_changed: bool, tracker=None):
        super().__init__(key, previous, args_changed, tracker)
        self.constraint = constraint
        self.discard: list = []

    def handle(self, addr, gen_fn, args):
        self.visit(addr)
        submap = self.constraint.get_submap(addr)
        old_sub = self.old_subtrace(addr)
        diffs = self.site_argdiffs(gen_fn, args, old_sub,
                                   not submap.static_is_empty())
        if diffs is None:
            return self.keep(old_sub)
        sub_key = self.next_key()
        if old_sub is None:
            new_sub, w = gen_fn.generate(sub_key, submap, args)
            self.new_site(new_sub.get_retval())
        else:
            new_sub, w, retdiff, bwd = gen_fn.edit(
                sub_key, old_sub, Update(submap), diffs)
            self.note(retdiff, new_sub.get_retval())
            if isinstance(bwd, Update) and not bwd.constraint.static_is_empty():
                self.discard.append((addr, bwd.constraint))
        self.weight = self.weight + w
        self.record(new_sub)
        return new_sub.get_retval()

    def settle_dropped(self):
        """A dropped site leaves the weight and its choices go to the
        discard, so that the backward ``Update`` restores them."""
        for addr, sub in self.dropped():
            self.any_change = self.dropped_any = True
            self.weight = self.weight - sub.get_score()
            self.discard.append((addr, sub.get_choices()))


class RegenerateHandler(_EditHandler):
    """Serve ``Regenerate(selection)``: selected sites redraw from their
    prior conditionals; a newly visited site is simulated (weight 0)."""

    def __init__(self, key, previous, selection: Selection,
                 args_changed: bool, tracker=None):
        super().__init__(key, previous, args_changed, tracker)
        self.selection = selection

    def handle(self, addr, gen_fn, args):
        self.visit(addr)
        sel = self.selection(addr)
        old_sub = self.old_subtrace(addr)
        diffs = self.site_argdiffs(gen_fn, args, old_sub,
                                   not isinstance(sel, NoneSel))
        if diffs is None:
            return self.keep(old_sub)
        sub_key = self.next_key()
        if old_sub is None:
            new_sub = gen_fn.simulate(sub_key, args)
            self.new_site(new_sub.get_retval())
        else:
            new_sub, w, retdiff, _ = gen_fn.edit(
                sub_key, old_sub, Regenerate(sel), diffs)
            self.note(retdiff, new_sub.get_retval())
            self.weight = self.weight + w
        self.record(new_sub)
        return new_sub.get_retval()

    def settle_dropped(self):
        for _, sub in self.dropped():
            self.any_change = self.dropped_any = True
            self.weight = self.weight - sub.get_score()


class StaticEditHandler(_EditHandler):
    """Serve :class:`StaticRequest`: each site's own request (default: the
    empty ``Update``)."""

    def __init__(self, key, previous, requests: dict, args_changed: bool,
                 tracker=None):
        super().__init__(key, previous, args_changed, tracker)
        self.requests = requests
        self.bwd: dict = {}

    def handle(self, addr, gen_fn, args):
        self.visit(addr)
        request = self.requests.get(addr, Update(ChoiceMap.empty()))
        old_sub = self.previous.get_inner_trace(addr)
        diffs = self.site_argdiffs(gen_fn, args, old_sub,
                                   addr in self.requests)
        if diffs is None:
            self.bwd[addr] = request
            return self.keep(old_sub)
        sub_key = self.next_key()
        new_sub, w, retdiff, bwd = request.edit(sub_key, old_sub, diffs)
        self.note(retdiff, new_sub.get_retval())
        self.weight = self.weight + w
        self.bwd[addr] = bwd
        self.record(new_sub)
        return new_sub.get_retval()


@Pytree.dataclass
class StaticTrace(Trace[Any]):
    """Trace of a ``@gen`` function: per-address subtraces; the score is
    the sum of the subtrace scores."""

    gen_fn: "Fn"
    args: tuple
    retval: Any
    subtraces: tuple
    addresses: tuple = Pytree.static()

    def get_args(self) -> tuple:
        return self.args

    def get_retval(self):
        return self.retval

    def get_gen_fn(self):
        return self.gen_fn

    def get_score(self) -> Score:
        score = torch.zeros(())
        for sub in self.subtraces:
            score = score + sub.get_score()
        return score

    def get_choices(self) -> ChoiceMap:
        chm = ChoiceMap.empty()
        for addr, sub in zip(self.addresses, self.subtraces):
            chm = chm | sub.get_choices().extend(addr)
        return chm

    def get_inner_trace(self, address) -> Trace:
        for addr, sub in zip(self.addresses, self.subtraces):
            if addr == address:
                return sub
        # A tupled site ("x", "x0") is reachable component by component:
        # the first component gives a view over the matching suffixes.
        matches = tuple(
            (addr[1:] if len(addr) > 2 else addr[1], sub)
            for addr, sub in zip(self.addresses, self.subtraces)
            if isinstance(addr, tuple) and addr[0] == address
        )
        if matches:
            return _PrefixTrace(tuple(a for a, _ in matches),
                                tuple(sub for _, sub in matches))
        raise KeyError(f"No subtrace at address {address!r}")


@Pytree.dataclass
class _PrefixTrace(Trace[Any]):
    """The subtraces under one component of tupled addresses: further
    ``get_inner_trace`` descent, ``get_choices`` and ``get_score`` (the
    group's sum)."""

    addresses: tuple = Pytree.static()
    subtraces: tuple = ()

    def get_args(self) -> tuple:
        return ()

    def get_retval(self):
        return None

    def get_gen_fn(self):
        return None

    get_score = StaticTrace.get_score
    get_choices = StaticTrace.get_choices
    get_inner_trace = StaticTrace.get_inner_trace


@Pytree.dataclass
class StaticRequest(EditRequest):
    """Address-wise edit: ``addressed[addr]`` edits the subtrace at
    ``addr`` (default: the empty ``Update``)."""

    addressed: dict = Pytree.field(default_factory=dict)

    def edit(self, key, tr: StaticTrace, argdiffs: Argdiffs):
        return tr.get_gen_fn().edit(key, tr, self, argdiffs)


@Pytree.dataclass
class Fn(GenerativeFunction[Any]):
    """A ``@gen``-decorated Python function as a generative function."""

    source: Callable = Pytree.static()

    @property
    def __wrapped__(self):
        return self.source

    @property
    def __name__(self):
        return getattr(self.source, "__name__", "gen_fn")

    def simulate(self, key, args: tuple) -> StaticTrace:
        check_top_level_args(args, tuple(key.shape[:-1]))
        h = SimulateHandler(key)
        retval = h.run(self.source, args)
        return StaticTrace(self, args, retval, tuple(h.subtraces),
                           tuple(h.addresses))

    def assess(self, chm: ChoiceMap, args: tuple, batch: tuple = ()):
        check_top_level_args(args, tuple(batch))
        h = AssessHandler(chm, tuple(batch))
        retval = h.run(self.source, args)
        return h.score, retval

    def generate(self, key, constraint: ChoiceMap, args: tuple):
        check_top_level_args(args, tuple(key.shape[:-1]))
        h = GenerateHandler(key, constraint)
        retval = h.run(self.source, args)
        trace = StaticTrace(self, args, retval, tuple(h.subtraces),
                            tuple(h.addresses))
        return trace, h.weight

    def project(self, key, trace: StaticTrace, selection: Selection):
        w = torch.zeros(())
        for i, (addr, sub) in enumerate(zip(trace.addresses, trace.subtraces)):
            sub_key = random.fold_in(key, i)
            w = w + sub.get_gen_fn().project(sub_key, sub, selection(addr))
        return w

    def __get__(self, instance, _owner):
        # Method models: bind ``self`` as a function would.
        if instance is None:
            return self
        return self.partial_apply(instance)

    def edit(self, key, trace: StaticTrace, request: EditRequest,
             argdiffs: Argdiffs):
        args = Diff.tree_primal(argdiffs)
        check_top_level_args(args, tuple(key.shape[:-1]))
        if not isinstance(request, (Update, Regenerate, StaticRequest)):
            raise NotImplementedError(
                f"Fn does not support request {type(request).__name__}")
        if FINE_GRAINED_EDITS:
            from genjax_torch.lang import static_edit

            tracker = static_edit.tracker_for(argdiffs, tuple(key.shape[:-1]))
            if tracker is not None:
                try:
                    out = self._edit_with(key, trace, request, argdiffs,
                                          tracker)
                    edit_stats.fine += 1
                    return out
                except static_edit.Untracked:
                    # The body read a changed value into Python: rerun
                    # on the coarse rule, which needs no tracking.
                    pass
        edit_stats.coarse += 1
        return self._edit_with(key, trace, request, argdiffs, None)

    def _edit_with(self, key, trace: StaticTrace, request: EditRequest,
                   argdiffs: Argdiffs, tracker):
        """One edit under the coarse rule (``tracker`` None) or the fine
        one."""
        args = Diff.tree_primal(argdiffs)
        args_changed = not Diff.static_check_no_change(argdiffs)
        if isinstance(request, Update):
            h: Any = UpdateHandler(key, trace, request.constraint,
                                   args_changed, tracker)
        elif isinstance(request, Regenerate):
            h = RegenerateHandler(key, trace, request.selection, args_changed,
                                  tracker)
        else:
            h = StaticEditHandler(key, trace, request.addressed, args_changed,
                                  tracker)
        retval = h.run(self.source, args)
        if not isinstance(request, StaticRequest):
            h.settle_dropped()
        new_trace = StaticTrace(self, args, retval, tuple(h.subtraces),
                                tuple(h.addresses))
        retdiff = (Diff.unknown_change(retval) if h.retval_changed(retval)
                   else Diff.no_change(retval))
        if isinstance(request, Update):
            discard = ChoiceMap.empty()
            for addr, sub_discard in h.discard:
                discard = discard | sub_discard.extend(addr)
            bwd: EditRequest = Update(discard)
        elif isinstance(request, Regenerate):
            bwd = Regenerate(request.selection)
        else:
            bwd = StaticRequest(h.bwd)
        return new_trace, h.weight, retdiff, bwd

    def inline(self, *args):
        """Run the body under the current handler: its sites join the
        caller's, with no address nesting."""
        return self.source(*args)

    def handle_kwargs(self) -> "Fn":
        """The form taking ``(args, kwargs)``. The wrapper is cached per
        source, so that two traces of one model compare equal in
        structure (the accept select of MH needs it)."""
        source = self.source
        inst_dict = getattr(source, "__dict__", None)
        cache = inst_dict if isinstance(inst_dict, dict) else _KWARGED_FNS
        cache_key = "__genjax_kwarged__" if cache is inst_dict else source
        fn = cache.get(cache_key)
        if fn is None:

            def kwarged_source(args, kwargs):
                return source(*args, **kwargs)

            fn = Fn(kwarged_source)
            try:
                cache[cache_key] = fn
            except TypeError:  # an unhashable callable: no cache
                pass
        return fn

    def partial_apply(self, *pre_args) -> "Fn":
        """Fix leading arguments (static values: the partial lives in the
        trace's structure)."""
        partial = functools.partial(self.source, *pre_args)
        functools.update_wrapper(partial, self.source)
        return Fn(partial)


def gen(fn: Callable) -> Fn:
    """Decorator: Python function -> generative function."""
    return Fn(fn)
