"""The ``@gen`` static modeling language (counterpart of
``genjax_tpu/lang/static.py``).

The body runs as plain Python under a dynamic handler stack:
``gf(args) @ "addr"`` dispatches to the innermost active handler, which
simulates, scores or constrains that site. Per-site keys are
``fold_in(key, site_counter)``, as in JAX, so the same key data gives the
same draws. A key batch ``B + (2,)`` runs ``B`` executions at once.

``edit`` (Update / Regenerate / StaticRequest on a ``@gen`` trace) is not
ported yet: it waits for the combinators and edits slice (ROADMAP queue 1
item 8).
"""

from __future__ import annotations

import contextvars
from typing import Any, Callable

import torch

from genjax_torch.core import random
from genjax_torch.core.pytree import Pytree
from genjax_torch.gfi.choice_map import ChoiceMap
from genjax_torch.gfi.concepts import Argdiffs, EditRequest, Score
from genjax_torch.gfi.gfn import GenerativeFunction, Trace
from genjax_torch.gfi.selection import Selection

__all__ = [
    "gen",
    "Fn",
    "StaticTrace",
    "trace_here",
    "AddressReuse",
    "MissingAddress",
]


class AddressReuse(Exception):
    """Same address traced twice in one ``@gen`` body."""


class MissingAddress(Exception):
    """``assess`` called with a choice map missing a traced address."""


#: The active handlers, innermost last. A context variable, so that
#: threads and tasks each see their own stack.
_HANDLERS: contextvars.ContextVar[tuple] = contextvars.ContextVar(
    "genjax_torch_handlers", default=()
)


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
    return stack[-1].handle(addr, gen_fn, args)


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
    """Base: bookkeeping shared by the GFI transforms."""

    def __init__(self):
        self.addresses: list = []
        self.subtraces: list[Trace] = []
        self._token = None

    def visit(self, addr):
        validate_new_address(self.addresses, addr)
        self.addresses.append(addr)

    def record(self, subtrace: Trace):
        self.subtraces.append(subtrace)

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
        super().__init__()
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
    def __init__(self, chm: ChoiceMap):
        super().__init__()
        self.chm = chm
        self.score = torch.zeros(())

    def handle(self, addr, gen_fn, args):
        self.visit(addr)
        submap = self.chm.get_submap(addr)
        if submap.static_is_empty():
            raise MissingAddress(addr)
        score, retval = gen_fn.assess(submap, args)
        self.score = self.score + score
        return retval


class GenerateHandler(StaticHandler):
    def __init__(self, key, constraint: ChoiceMap):
        super().__init__()
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
        raise KeyError(f"No subtrace at address {address!r}")


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
        with SimulateHandler(key) as h:
            retval = self.source(*args)
        return StaticTrace(self, args, retval, tuple(h.subtraces),
                           tuple(h.addresses))

    def assess(self, chm: ChoiceMap, args: tuple):
        with AssessHandler(chm) as h:
            retval = self.source(*args)
        return h.score, retval

    def generate(self, key, constraint: ChoiceMap, args: tuple):
        with GenerateHandler(key, constraint) as h:
            retval = self.source(*args)
        trace = StaticTrace(self, args, retval, tuple(h.subtraces),
                            tuple(h.addresses))
        return trace, h.weight

    def project(self, key, trace: StaticTrace, selection: Selection):
        w = torch.zeros(())
        for i, (addr, sub) in enumerate(zip(trace.addresses, trace.subtraces)):
            sub_key = random.fold_in(key, i)
            w = w + sub.get_gen_fn().project(sub_key, sub, selection(addr))
        return w

    def edit(self, key, trace: StaticTrace, request: EditRequest,
             argdiffs: Argdiffs):
        raise NotImplementedError(
            "Fn.edit is not ported yet: @gen edits (Update, Regenerate, "
            "StaticRequest) come with ROADMAP queue 1 item 8, "
            "'Combinators and edits'."
        )


def gen(fn: Callable) -> Fn:
    """Decorator: Python function -> generative function."""
    return Fn(fn)
