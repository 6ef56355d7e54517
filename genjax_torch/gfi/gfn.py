"""The generative function interface: ``Trace`` and ``GenerativeFunction``
(counterpart of ``genjax_tpu/gfi/gfn.py``), with the postfix methods of
the combinators (``vmap``, ``repeat``, ``scan``, ``accumulate``,
``reduce``, ``iterate``, ``iterate_final``, ``masked_iterate``, ``mask``,
``dimap``, ``map``, ``contramap``, ``switch``, ``mix``, ``or_else``,
``marginal``). Every concrete GFI method validates its arguments
(``core/validate.py``), and the postfix methods and the combinator
constructors they call check theirs (``core/argcheck.py``), as in the
JAX package."""

from __future__ import annotations

import abc
from typing import Any, Generic, TypeVar

import torch

from genjax_torch.core.compiler.interpreters.incremental import Diff
from genjax_torch.core.pytree import Pytree, tree_leaves
from genjax_torch.gfi.choice_map import ChoiceMap
from genjax_torch.gfi.concepts import Argdiffs, EditRequest
from genjax_torch.gfi.selection import Selection

R = TypeVar("R")

__all__ = ["Trace", "GenerativeFunction", "GenerativeFunctionClosure",
           "IgnoreKwargs", "check_batch_args"]


def check_batch_args(args: tuple, batch: tuple) -> None:
    """Refuse a tensor argument of a call on the batch ``batch`` that
    does not lead with it. A 0-d tensor and a Python number are the same
    in every execution; a choice map passed as an argument (a proposal's
    view of the old choices) is checked by the calls it reaches."""
    batch = tuple(batch)
    if not batch:
        return
    for v in tree_leaves(args, is_leaf=lambda x: isinstance(x, ChoiceMap)):
        if (isinstance(v, torch.Tensor) and v.ndim
                and tuple(v.shape[:len(batch)]) != batch):
            raise ValueError(
                f"a tensor argument of shape {tuple(v.shape)} under the "
                f"batch {batch}: every tensor argument of a batched call "
                "leads with the batch (lift a shared one with "
                "v.expand(batch + v.shape))")


class Trace(Pytree, Generic[R]):
    """A recording of one execution of a generative function: arguments,
    return value, choices and score (log density of the choices)."""

    @abc.abstractmethod
    def get_args(self) -> tuple: ...

    @abc.abstractmethod
    def get_retval(self) -> R: ...

    @abc.abstractmethod
    def get_score(self) -> torch.Tensor: ...

    @abc.abstractmethod
    def get_choices(self) -> ChoiceMap: ...

    @abc.abstractmethod
    def get_gen_fn(self) -> "GenerativeFunction[R]": ...

    def get_sample(self) -> ChoiceMap:
        return self.get_choices()

    def edit(self, key, request: EditRequest, argdiffs: Argdiffs | None = None):
        if argdiffs is None:
            argdiffs = Diff.no_change(self.get_args())
        return request.edit(key, self, argdiffs)

    def update(self, key, constraint: ChoiceMap,
               argdiffs: Argdiffs | None = None):
        if argdiffs is None:
            argdiffs = Diff.no_change(self.get_args())
        return self.get_gen_fn().update(key, self, constraint, argdiffs)

    def project(self, key, selection: Selection) -> torch.Tensor:
        """log-density of the selected choices, conditioned on the rest."""
        return self.get_gen_fn().project(key, self, selection)

    def get_subtrace(self, *addresses) -> "Trace[Any]":
        tr: Trace[Any] = self
        for addr in addresses:
            tr = tr.get_inner_trace(addr)
        return tr

    def get_inner_trace(self, address) -> "Trace[Any]":
        raise KeyError(f"{type(self).__name__} has no subtraces")

    def batch_shape(self) -> tuple:
        return tuple(torch.as_tensor(self.get_score()).shape)


class GenerativeFunction(Pytree, Generic[R]):
    """A probability measure over structured sample spaces, accessed
    through ``simulate`` / ``assess`` / ``generate`` / ``project`` /
    ``edit``.

    A key of shape ``B + (2,)`` runs ``B`` independent executions at once
    (the particle axis written out, see ``core/random.py``). The batch
    rank is always the key's, ``key.ndim - 1`` (``assess``, which takes
    no key, is told ``batch``); no code reads it from a length that
    happens to match. The convention:

    - every draw, score and weight has the batch ``B`` as its leading
      axes (a score or weight has exactly the shape ``B``);
    - every tensor argument of a batched call leads with ``B``: it is
      per-execution data, whatever its length. A Python number is the
      same in every execution. The inference entry points
      (``ImportanceK``, ``tempered_smc``, ...) lift the target's
      arguments and constraint values to the batch with ``expand``, a
      zero-stride view with no copy; a direct caller lifts its own.
      Combinators (``Vmap``, ``Scan``) refuse a tensor argument that
      does not lead with ``B``;
    - inside a ``@gen`` body the handler tells per-execution tensors
      (derived by torch operations from the arguments and the traced
      calls' return values) from the body's constants, and expands each
      constant to ``B`` before it reaches a traced call or the return
      value (``lang/static.py``). So every tensor a trace holds leads
      with ``B``, and a leaf that is the same in every execution is
      recognisable by its zero stride (the invariant leaves that
      resampling and the MH select skip);
    - a combinator puts its lane or step axis right after ``B``: keys
      ``B + (n, 2)``, traces ``B + (n,) + ...``, and the ``Indexed``
      choice maps it builds record ``batch_rank = len(B)``;
    - an inference algorithm nested in a batched execution (a
      ``Marginal`` at a site of a batched ``@gen`` function, or the
      proposal of ``ImportanceK``) runs once per execution: its
      particles carry their axis ``K`` right after ``B`` (traces
      ``B + (K,) + ...``, weights ``B + (K,)``), as a combinator's lanes
      do, and the target's per-execution values are lifted to
      ``B + (K,)`` behind the batch they carry (``inference/smc.py``).

    A batched ``@gen`` or distribution call at top level (no ``@gen``
    body running) refuses a tensor argument that does not lead with
    ``B`` (:func:`check_batch_args`), so that no argument is taken as
    shared or per-execution by its length. Inside a body the handler
    has lifted the constants already, and a distribution's draw and
    log-density take the batch rank from the key."""

    def __init_subclass__(cls, **kwargs):
        # Argument validation on every concrete GFI method a subclass
        # defines (``core/validate.py``).
        super().__init_subclass__(**kwargs)
        from genjax_torch.core.validate import install_gfi_checks

        install_gfi_checks(cls)

    @abc.abstractmethod
    def simulate(self, key, args: tuple) -> Trace[R]:
        """Sample a trace: choices ~ P(·; args)."""

    @abc.abstractmethod
    def assess(self, chm: ChoiceMap, args: tuple, batch: tuple = ()):
        """Score a complete choice map: ``(log P(chm; args), retval)``.
        ``assess`` takes no key, so a batched call names its batch shape
        ``batch``: the score then has that shape."""

    @abc.abstractmethod
    def generate(self, key, constraint: ChoiceMap, args: tuple):
        """Importance-sample a trace consistent with ``constraint``; the
        weight is ``log P(choices) − log q(unconstrained | constraint)``."""

    def project(self, key, trace: Trace[R], selection: Selection):
        raise NotImplementedError

    def edit(self, key, trace: Trace[R], request: EditRequest,
             argdiffs: Argdiffs):
        raise NotImplementedError(
            f"{type(self).__name__} does not support request "
            f"{type(request).__name__}"
        )

    def update(self, key, trace: Trace[R], constraint: ChoiceMap,
               argdiffs: Argdiffs):
        from genjax_torch.gfi.requests import Update

        tr, w, rd, bwd = Update(constraint).edit(key, trace, argdiffs)
        discard = bwd.constraint if isinstance(bwd, Update) else ChoiceMap.empty()
        return tr, w, rd, discard

    def importance(self, key, constraint: ChoiceMap, args: tuple):
        return self.generate(key, constraint, args)

    def propose(self, key, args: tuple):
        tr = self.simulate(key, args)
        return tr.get_choices(), tr.get_score(), tr.get_retval()

    def get_zero_trace(self, *args) -> Trace[R]:
        from genjax_torch.core.compiler.staging import empty_trace

        return empty_trace(self, args)

    def __call__(self, *args, **kwargs) -> "GenerativeFunctionClosure[R]":
        """``gf(args)``; a distribution's named parameters bind to
        positions (``normal(loc=0., scale=1.)``, its ``bind_kwargs``),
        ``sample_shape=`` makes an iid block of a distribution
        (``normal(0., 1., sample_shape=(2, 3))``), and other keyword
        arguments go to the ``handle_kwargs`` form: a ``@gen`` function
        applies them, any other generative function ignores them."""
        from genjax_torch.core.pytree import Const

        shape = Const.unwrap(kwargs.pop("sample_shape", None))
        gf = self
        if kwargs and hasattr(self, "bind_kwargs"):
            args, kwargs = self.bind_kwargs(args, kwargs), {}
        if shape is not None:
            if hasattr(self, "iid"):
                gf = self.iid(shape)
            else:
                kwargs["sample_shape"] = shape
        if kwargs:
            return GenerativeFunctionClosure(gf.handle_kwargs(),
                                             (args, kwargs))
        return GenerativeFunctionClosure(gf, args)

    def handle_kwargs(self) -> "GenerativeFunction[R]":
        """The form taking ``(args, kwargs)`` as its arguments. By
        default the named arguments are ignored (distributions and
        combinators take positional arguments only); ``Fn`` applies
        them."""
        return IgnoreKwargs(self)

    # -- combinator postfix methods ---------------------------------------

    def vmap(self, *, in_axes=0, axis_size=None):
        from genjax_torch.core.argcheck import check_in_axes
        from genjax_torch.lang.combinators.vmap import Vmap

        check_in_axes(in_axes, "GenerativeFunction.vmap")
        return Vmap(self, in_axes=in_axes, axis_size=axis_size)

    def repeat(self, *, n: int):
        from genjax_torch.lang.combinators.repeat import repeat

        return repeat(n=n)(self)

    def scan(self, *, n: int | None = None):
        from genjax_torch.lang.combinators.scan import Scan

        return Scan(self, length=n)

    def accumulate(self):
        from genjax_torch.lang.combinators.scan import accumulate

        return accumulate()(self)

    def reduce(self):
        from genjax_torch.lang.combinators.scan import reduce

        return reduce()(self)

    def iterate(self, *, n: int):
        from genjax_torch.core.argcheck import check_static_int
        from genjax_torch.lang.combinators.scan import iterate

        check_static_int(n, "iterate(n=...)")
        return iterate(n=n)(self)

    def iterate_final(self, *, n: int):
        from genjax_torch.core.argcheck import check_static_int
        from genjax_torch.lang.combinators.scan import iterate_final

        check_static_int(n, "iterate_final(n=...)")
        return iterate_final(n=n)(self)

    def masked_iterate(self):
        from genjax_torch.lang.combinators.scan import masked_iterate

        return masked_iterate()(self)

    def masked_iterate_final(self):
        from genjax_torch.lang.combinators.scan import masked_iterate_final

        return masked_iterate_final()(self)

    def mask(self):
        from genjax_torch.lang.combinators.mask import MaskCombinator

        return MaskCombinator(self)

    def dimap(self, *, pre=None, post=None):
        from genjax_torch.core.argcheck import check_callable
        from genjax_torch.lang.combinators.dimap import dimap

        if pre is not None:
            check_callable(pre, "dimap(pre=...)")
        if post is not None:
            check_callable(post, "dimap(post=...)")
        return dimap(pre=pre, post=post)(self)

    def map(self, post):
        from genjax_torch.lang.combinators.dimap import map_retval

        return map_retval(post)(self)

    def contramap(self, pre):
        from genjax_torch.core.argcheck import check_callable
        from genjax_torch.lang.combinators.dimap import contramap

        check_callable(pre, "dimap(pre=...)")
        return contramap(pre)(self)

    def switch(self, *branches):
        from genjax_torch.lang.combinators.switch import switch

        return switch(self, *branches)

    def mix(self, *fns):
        from genjax_torch.lang.combinators.mixture import mix

        return mix(self, *fns)

    def or_else(self, gen_fn):
        from genjax_torch.lang.combinators.or_else import or_else

        return or_else(gen_fn)(self)

    def marginal(self, *, selection=None, algorithm=None):
        from genjax_torch.inference.sp import Marginal

        if selection is not None and not isinstance(selection, Selection):
            raise TypeError(
                "marginal(selection=...) expects a Selection, got "
                f"{type(selection).__name__}: {selection!r}.")
        sel = selection if selection is not None else Selection.all()
        return Marginal(self, Pytree.const(sel), algorithm)


@Pytree.dataclass
class IgnoreKwargs(GenerativeFunction[Any]):
    """The ``(args, kwargs)`` calling convention over a generative
    function that takes positional arguments only: the named arguments
    are dropped."""

    wrapped: GenerativeFunction[Any]

    def simulate(self, key, args):
        (a, _kwargs) = args
        return self.wrapped.simulate(key, a)

    def assess(self, chm, args, batch: tuple = ()):
        (a, _kwargs) = args
        return self.wrapped.assess(chm, a, batch=batch)

    def generate(self, key, constraint, args):
        (a, _kwargs) = args
        return self.wrapped.generate(key, constraint, a)

    def project(self, key, trace, selection):
        return self.wrapped.project(key, trace, selection)

    def edit(self, key, trace, request, argdiffs):
        (a_diffs, _kwargs) = argdiffs
        return self.wrapped.edit(key, trace, request, a_diffs)


@Pytree.dataclass
class GenerativeFunctionClosure(Pytree, Generic[R]):
    """``gf(args)``: a gen fn partially applied to arguments. Inside a
    ``@gen`` body, ``closure @ "addr"`` records a traced call."""

    gen_fn: GenerativeFunction[R]
    args: tuple

    def __matmul__(self, addr) -> R:
        from genjax_torch.lang.static import trace_here

        return trace_here(addr, self.gen_fn, self.args)

    def simulate(self, key):
        return self.gen_fn.simulate(key, self.args)

    def assess(self, chm, batch: tuple = ()):
        return self.gen_fn.assess(chm, self.args, batch=batch)

    def generate(self, key, constraint):
        return self.gen_fn.generate(key, constraint, self.args)
