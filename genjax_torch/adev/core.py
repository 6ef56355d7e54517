"""ADEV: automatic differentiation of expected values (Lew et al. 2023),
the counterpart of ``genjax_tpu/adev/core.py``.

The JAX package stages a loss program to a jaxpr and walks it with a
CPS interpreter. Eager PyTorch has no jaxpr, so here the program is plain
Python run under a handler (:class:`_Run`), with forward-mode dual
tensors (``torch.autograd.forward_ad``) carrying the tangents through
every operation that is not a sample site: the ``@gen`` machinery, the
log-densities, the model's arithmetic. No per-operation rule table.

At a sample site (:func:`sample_primitive`) the handler asks the site's
gradient strategy for its estimate:

- a tail-call strategy (reparameterization, implicit gradients) returns
  its local dual and the run goes on, so a pathwise program runs once;
- any other strategy (enumeration, REINFORCE, MVD, a baseline) is handed
  continuations over "the rest of the program". The rest is the program
  run again from its start under a replay handler: the sites before the
  current one return their recorded values, the current one returns the
  value handed to the continuation, later ones run under ADEV. This
  needs the program to be deterministic given its keys, which the
  functional keys make it. The dual continuation runs with tangents, the
  pure one on the primals alone.

Key discipline is the JAX package's, with one change: a tail-call site
hands its continuation ``split(key)[0]``, the half that
``before_tail_call`` leaves unused, where the JAX package
(``core.py:87-89``) hands on ``key`` itself, so that two reparameterized
sites in a row draw the same noise there. Enumeration keeps one key for
every branch's continuation (common random numbers); REINFORCE splits as
the JAX package does. So a program with one keyed site gives the JAX
package's numbers at the same key, and later sites get fresh noise.

Batches. The key given to ``estimate`` / ``grad_estimate`` is a batch
``E + (2,)`` of independent executions, every tensor argument leading
with ``E``; an enumerated value is set in all of them at once, which is
exact because they do not interact. Lanes that a ``Vmap`` or an
``ImportanceK`` adds inside the program are different: they meet in the
program's output. A site's lanes are the axes of its bound key beyond
``E`` (a nested batch puts them there); such a site runs under the lifted
rules of the JAX package: tail-call strategies lane by lane,
enumeration Rao-Blackwellized per lane (``n·K`` pure continuations), and
REINFORCE as the multi-sample score-function estimator. Under ADEV a
site's randomness always comes from the interpreter's key; its bound key
gives only its lane shape.

Control flow. A Python loop's sites are sequential sites, each with a
fresh key. :func:`cond` is the counterpart of ``lax.cond`` with sample
sites: a Python predicate picks a branch; a tensor predicate runs both
branches, each on its own key, and selects per element. When a branch
holds a non-tail-call site (enumeration, REINFORCE, MVD), whose
continuation is the rest of its branch and then the program after the
cond, the program runs on once through each branch from there and each
execution takes its own branch's estimate, as ``jax.vmap`` of the JAX
package's ``lax.switch`` of CPS branches does.

``Expectation.grad_estimate`` takes the gradient in one forward and one
backward pass: the tangent inputs are zero tensors that require grad,
and ``torch.autograd.grad`` of the output tangent transposes the tangent
map, as ``jax.grad`` through the JAX package's ``custom_jvp`` does.
"""

from __future__ import annotations

import contextlib
import contextvars
import math
from typing import Any, Callable

import torch
import torch.autograd.forward_ad as fwAD

from genjax_torch.core import random
from genjax_torch.core.pytree import (
    Pytree,
    tree_flatten,
    tree_leaves,
    tree_map,
    tree_unflatten,
)
from genjax_torch.lang import static as _static

__all__ = [
    "ADEVPrimitive",
    "TailCallADEVPrimitive",
    "BatchedTailCallPrimitive",
    "BatchedEnumPrimitive",
    "Dual",
    "ADEVProgram",
    "Expectation",
    "expectation",
    "forward_mode",
    "sample_primitive",
    "cond",
    "jvp",
    "lane_keys",
    "program_runs",
]

#: The active ADEV run, if any (a context variable, as the ``@gen``
#: handler stack is).
_ACTIVE: contextvars.ContextVar["_Run | None"] = contextvars.ContextVar(
    "genjax_torch_adev", default=None)

_RUNS = [0]


def program_runs() -> int:
    """How many times an ADEV handler has run a program (whole or up to
    a site) since the process started: a pathwise ``grad_estimate`` runs
    it once, an enumerated flip three times."""
    return _RUNS[0]


# -- duals -------------------------------------------------------------------


def _is_float(x) -> bool:
    return isinstance(x, torch.Tensor) and x.is_floating_point()


@contextlib.contextmanager
def _level():
    """A forward-mode level, unless one is active already (torch runs
    one at a time)."""
    if fwAD._current_level >= 0:
        yield
        return
    with fwAD.dual_level():
        yield


def _make(primal, tangent):
    """A dual tensor of ``primal`` (a plain tensor when ``tangent`` is
    ``None`` or the primal is not a float)."""
    if tangent is None or not _is_float(primal):
        return primal
    if not primal.is_contiguous():
        primal = primal.contiguous()
    tangent = torch.as_tensor(tangent, dtype=primal.dtype,
                              device=primal.device)
    return fwAD.make_dual(primal, tangent.expand(primal.shape))


def _unpack(x):
    """``(primal, tangent or None)`` of a tensor."""
    if not _is_float(x):
        return x, None
    p, t = fwAD.unpack_dual(x)
    return p, t


def _primal(x):
    return _unpack(x)[0] if isinstance(x, torch.Tensor) else x


def _as_tensor(x, device=None):
    if isinstance(x, torch.Tensor):
        return x
    if isinstance(x, bool):
        return torch.tensor(x, device=device)
    if isinstance(x, (int, float)):
        return torch.tensor(x, dtype=torch.float32, device=device)
    return x


@Pytree.dataclass
class Dual(Pytree):
    """A forward-mode dual number (pytree node): a primal and its tangent
    (``None`` for a zero tangent). Strategies receive their arguments and
    hand values to their continuations as ``Dual`` trees; the handler
    turns them into dual tensors for the program."""

    primal: Any
    tangent: Any

    @staticmethod
    def _is(x) -> bool:
        return isinstance(x, Dual)

    @staticmethod
    def tree_pure(v):
        return tree_map(lambda x: x if isinstance(x, Dual) else Dual(x, None),
                        v, is_leaf=Dual._is)

    @staticmethod
    def dual_tree(primals, tangents):
        return tree_map(Dual, primals, tangents)

    @staticmethod
    def tree_primal(v):
        return tree_map(lambda x: x.primal if isinstance(x, Dual) else x, v,
                        is_leaf=Dual._is)

    @staticmethod
    def tree_tangent(v):
        """The tangents, a zero tensor where a tangent is ``None``."""
        return tree_map(lambda x: _tangent_of(x) if isinstance(x, Dual)
                        else x, v, is_leaf=Dual._is)

    @staticmethod
    def tree_leaves(v):
        return tree_leaves(Dual.tree_pure(v), is_leaf=Dual._is)

    @staticmethod
    def tree_unzip(v):
        leaves = Dual.tree_leaves(v)
        return (tuple(d.primal for d in leaves),
                tuple(_tangent_of(d) for d in leaves))


def _tangent_of(d: Dual):
    if d.tangent is not None:
        return d.tangent
    p = torch.as_tensor(d.primal)
    return torch.zeros_like(p, dtype=p.dtype if p.is_floating_point()
                            else torch.float32)


def _to_dual(x) -> Dual:
    """A program value (a dual or plain tensor) as a :class:`Dual`."""
    p, t = _unpack(x) if isinstance(x, torch.Tensor) else (x, None)
    return Dual(p, t)


def _from_dual(d):
    """A :class:`Dual` tree as program values (dual tensors)."""
    return tree_map(lambda x: _make(_as_tensor(x.primal), x.tangent)
                    if isinstance(x, Dual) else _as_tensor(x), d,
                    is_leaf=Dual._is)


def jvp(fn: Callable, primals: tuple, tangents: tuple):
    """``jax.jvp`` on dual tensors: ``(fn(*primals), its tangent)``, a
    zero tangent where none flows. ``None`` tangents are zero."""
    with _level():
        out = fn(*(_make(_as_tensor(p), t) for p, t in zip(primals,
                                                           tangents)))
        p, t = _unpack(out)
        if t is None:
            t = torch.zeros_like(p, dtype=torch.float32) if not _is_float(
                p) else torch.zeros_like(p)
        return p, t


def lane_keys(key: torch.Tensor, lanes: tuple) -> torch.Tensor:
    """``prod(lanes)`` fresh keys behind every key of ``key``'s batch,
    shaped ``batch + lanes + (2,)`` (the JAX package's
    ``split(key, n)`` of a lifted site)."""
    n = math.prod(lanes)
    return random.split(key, n).reshape(tuple(key.shape[:-1]) + tuple(lanes)
                                        + (2,))


# -- primitives --------------------------------------------------------------


class ADEVPrimitive(Pytree):
    """A sampler and its gradient-estimation strategy.

    ``sample(key, *args)`` draws one value per key of a key batch
    ``B + (2,)`` (every tensor argument leads with ``B``);
    ``jvp_estimate(key, dual_args, (kpure, kdual))`` returns the
    :class:`Dual` of the whole program's value, given the continuations
    ``kpure(key, value) -> primal`` and ``kdual(key, value) -> Dual``
    over the rest of the program. ``key`` there is the interpreter's key
    batch ``E + (2,)``, one key an execution."""

    def sample(self, key, *args) -> Any:
        raise NotImplementedError

    def jvp_estimate(self, key, dual_args: tuple, konts: tuple) -> Dual:
        raise NotImplementedError

    def __call__(self, *args):
        return sample_primitive(self, *args)


class TailCallADEVPrimitive(ADEVPrimitive):
    """A strategy whose estimate tail-calls the dual continuation with a
    locally computed dual (reparameterized and implicit samplers).
    Subclasses implement ``before_tail_call(key, dual_args) -> Dual``.
    The continuation gets ``split(key)[0]``; ``before_tail_call`` draws
    from ``split(key)[1]``."""

    is_tail_call = True

    def before_tail_call(self, key, dual_args) -> Dual:
        raise NotImplementedError

    def jvp_estimate(self, key, dual_args, konts):
        _, kdual = konts
        kont_key, _ = random.split(key).unbind(-2)
        return kdual(kont_key, self.before_tail_call(key, dual_args))


def _is_tail_call(prim) -> bool:
    return bool(getattr(prim, "is_tail_call", False)) or hasattr(
        prim, "before_tail_call")


@Pytree.dataclass
class BatchedTailCallPrimitive(ADEVPrimitive):
    """A tail-call strategy lifted over in-program lanes: each lane draws
    from its own key of ``lane_keys(split(key)[1], lanes)``; the
    continuation gets ``split(key)[0]``."""

    original: ADEVPrimitive
    lanes: tuple = Pytree.static()

    is_tail_call = True

    def sample(self, key, *args):
        return self.original.sample(lane_keys(key, self.lanes), *args)

    def before_tail_call(self, key, dual_args):
        _, sub_key = random.split(key).unbind(-2)
        return self.original.before_tail_call(
            lane_keys(sub_key, self.lanes), dual_args)

    def jvp_estimate(self, key, dual_args, konts):
        _, kdual = konts
        kont_key, _ = random.split(key).unbind(-2)
        return kdual(kont_key, self.before_tail_call(key, dual_args))


@Pytree.dataclass
class BatchedEnumPrimitive(ADEVPrimitive):
    """An enumeration strategy (``FlipEnum`` / ``CategoricalEnum*``) over
    in-program lanes, Rao-Blackwellized per lane: the derivative for lane
    ``i`` enumerates lane ``i`` exactly with the other lanes at their
    sampled values (common random numbers downstream),

        dE[f]/dθ_i = E_{B_-i}[ Σ_k dp_k(θ_i) · f(v_k, B_-i) ],

    so it costs ``n·K`` pure continuations, each a run of the program.
    The primal is the sampled ``f(B)``."""

    original: ADEVPrimitive
    lanes: tuple = Pytree.static()

    def sample(self, key, *args):
        return self.original.sample(lane_keys(key, self.lanes), *args)

    def jvp_estimate(self, key, dual_args, konts):
        kpure, kdual = konts
        primals = Dual.tree_primal(dual_args)
        tangents = tuple(d.tangent for d in dual_args)
        batch = tuple(key.shape[:-1])
        r, n = len(batch), math.prod(self.lanes)
        k_s, k_cont = random.split(key).unbind(-2)
        b = self.original.sample(lane_keys(k_s, self.lanes), *primals)
        out = kdual(k_cont, Dual.tree_pure(b))
        support = self.original.enum_support(*primals)
        f = []
        for i in range(n):
            row = []
            for k in range(support.shape[0]):
                b_ik = b.clone()
                flat = b_ik.reshape(batch + (n,) + tuple(b.shape[r + len(
                    self.lanes):]))
                flat.select(r, i).fill_(support[k])
                row.append(kpure(k_cont, b_ik))
            f.append(torch.stack(row, dim=-1))
        f = torch.stack(f, dim=-2)                            # E + (n, K)
        _, dprobs = jvp(self.original.enum_probs, primals, tangents)
        # A parameter shared by the lanes (no lane axes) counts once a lane.
        dprobs = torch.broadcast_to(
            dprobs, batch + tuple(self.lanes) + (support.shape[0],))
        enum_tangent = (dprobs.reshape(batch + (n, -1)) * f).sum((-2, -1))
        return Dual(out.primal, _tangent_of(out) + enum_tangent)


def _lift_reinforce(prim, lanes: tuple):
    """A score-function strategy over in-program lanes: another instance
    of the same class whose sampler draws every lane on its own key. Its
    ``jvp_estimate`` sums the log-density over every axis behind the
    executions' batch, so the estimate is ``loss · Σ_i dlog p_i``."""

    def batched_sample(key, *args):
        return prim.sample(lane_keys(key, lanes), *args)

    return type(prim)(batched_sample, prim.differentiable_logpdf)


def _lift(prim, lanes: tuple):
    """The strategy of a site with in-program ``lanes``."""
    if not lanes:
        return prim
    if _is_tail_call(prim):
        return BatchedTailCallPrimitive(prim, lanes)
    if hasattr(prim, "enum_support"):
        return BatchedEnumPrimitive(prim, lanes)
    if hasattr(prim, "differentiable_logpdf"):
        return _lift_reinforce(prim, lanes)
    raise NotImplementedError(
        f"ADEV primitive {type(prim).__name__} over in-program lanes would "
        "drop its gradient strategy; use a tail-call (reparameterized) "
        "primitive, an enumeration or REINFORCE strategy, or move the "
        "lanes outside the expectation.")


# -- the handler -------------------------------------------------------------


class _Finished(BaseException):
    """Unwinds a run at the site whose strategy computed the value of the
    whole program (a ``BaseException``, so that no ``except Exception``
    of the program catches it)."""

    def __init__(self, run, value):
        super().__init__()
        self.run = run
        self.value = value


class _SplitCond(BaseException):
    """Unwinds a run from a non-tail-call site inside the branches of a
    per-element :func:`cond` to that cond, which then runs the program
    on once through each branch (a ``BaseException``, so that no
    ``except Exception`` of the program catches it)."""


class _Run:
    """One run of an ADEV program. ``replay`` holds the values of its
    first sites; the site after them is the first live one, and ``key``
    is the interpreter's key from there on. ``dual`` runs with tangents
    (the dual continuation and the top-level run), otherwise on the
    primals (the pure continuation). ``forced`` maps a cond's ordinal in
    the run to the branch every execution takes there (see
    :meth:`cond`)."""

    def __init__(self, program: Callable, args: tuple, key, replay: list,
                 dual: bool, batch: tuple, forced: dict | None = None):
        self.program = program
        self.args = args
        self.key = key
        self.replay = replay
        self.dual = dual
        self.batch = batch
        self.forced = {} if forced is None else forced
        self.values: list = []
        self.cost = None
        self.in_cond = 0
        self.n_conds = 0

    def __call__(self):
        _RUNS[0] += 1
        token = _ACTIVE.set(self)
        # A continuation starts the program afresh: no @gen handler of the
        # run that reached the site encloses it.
        handlers = _static._HANDLERS.set(())
        try:
            out = self.program(*self.args)
        except _Finished as done:
            if done.run is not self:
                raise
            out = done.value
        finally:
            _static._HANDLERS.reset(handlers)
            _ACTIVE.reset(token)
        return out if self.cost is None else out + self.cost

    def _live(self) -> bool:
        return len(self.values) >= len(self.replay)

    def _record(self, v):
        self.values.append(v)
        return v

    def _add_cost(self, w):
        w = _as_tensor(w)
        self.cost = w if self.cost is None else self.cost + w

    def site(self, prim, args: tuple, bound_key):
        i = len(self.values)
        if i < len(self.replay):
            return self._record(self.replay[i])
        lanes = () if bound_key is None else tuple(
            bound_key.shape[len(self.batch):-1])
        if getattr(prim, "is_cost", False):
            if lanes:
                raise NotImplementedError(
                    "add_cost over in-program lanes: sum the lanes first")
            if not self.dual:
                self.key, _ = random.split(self.key).unbind(-2)
            self._add_cost(args[0])
            return self._record(args[0])
        prim = _lift(prim, lanes)
        if not self.dual:
            self.key, sub_key = random.split(self.key).unbind(-2)
            return self._record(prim.sample(sub_key, *args))
        dual_args = tuple(Dual.tree_pure(tree_map(_to_dual, a))
                          if isinstance(a, torch.Tensor) else
                          Dual(_as_tensor(a), None) for a in args)
        if _is_tail_call(prim):
            d = prim.before_tail_call(self.key, dual_args)
            self.key, _ = random.split(self.key).unbind(-2)
            return self._record(_from_dual(d))
        if self.in_cond:
            # Both branches of a per-element cond are running: this
            # site's continuation must be the rest of ITS branch, so the
            # cond takes each branch in its own run.
            raise _SplitCond()
        prefix = list(self.values)
        primal_args = tree_map(_primal, self.args)

        def kdual(key, value) -> Dual:
            v = _from_dual(Dual.tree_pure(value))
            out = _Run(self.program, self.args, key, prefix + [v], True,
                       self.batch, self.forced)()
            return _to_dual(out)

        def kpure(key, value):
            v = _primal(_from_dual(Dual.tree_pure(value)))
            return _Run(self.program, primal_args, key,
                        [_primal(x) for x in prefix] + [v], False,
                        self.batch, self.forced)()

        d = prim.jvp_estimate(self.key, dual_args, (kpure, kdual))
        raise _Finished(self, _from_dual(d))

    def cond(self, pred, true_fun, false_fun, operands):
        ordinal = self.n_conds
        self.n_conds += 1
        live = self._live()
        if ordinal in self.forced:
            # Every execution takes this branch in this run (a run that
            # a split below started, or one of its continuations).
            taken = self.forced[ordinal]
            if not live:
                return (true_fun if taken else false_fun)(*operands)
            branch_key, kont_key = random.split(self.key).unbind(-2)
            self.key = random.fold_in(branch_key, 0 if taken else 1)
            out = (true_fun if taken else false_fun)(*operands)
            self.key = kont_key
            return out
        if not live:
            return _select(pred, true_fun(*operands), false_fun(*operands))
        entry = (len(self.values), self.key, self.cost)
        branch_key, kont_key = random.split(self.key).unbind(-2)
        outermost, split = self.in_cond == 0, False
        self.in_cond += 1
        try:
            self.key = random.fold_in(branch_key, 0)
            a = true_fun(*operands)
            self.key = random.fold_in(branch_key, 1)
            b = false_fun(*operands)
        except _SplitCond:
            if not outermost:
                raise
            split = True
        finally:
            self.in_cond -= 1
        if split:
            self._split(ordinal, pred, entry)
        self.key = kont_key
        return _select(pred, a, b)

    def _split(self, ordinal: int, pred, entry):
        """A branch of the live cond ``ordinal`` holds a non-tail-call
        site. What ``jax.vmap`` of the JAX package's ``lax.switch`` of CPS
        branches computes: each execution's estimate of the whole program
        through its own branch. So the program runs on twice from this
        cond, every execution through the true branch and then through
        the false one (the sites before the cond replayed, its branch
        keys as above), and each execution takes its own branch's
        value; the run ends here with it."""
        n, key, cost = entry
        del self.values[n:]
        self.key, self.cost = key, cost
        if pred.ndim > len(self.batch):
            raise NotImplementedError(
                "ADEV: a cond whose branches hold a non-tail-call site "
                f"takes one predicate per execution (batch {self.batch}), "
                f"not one of shape {tuple(pred.shape)}")
        outs = [_Run(self.program, self.args, key, list(self.values),
                     self.dual, self.batch,
                     {**self.forced, ordinal: taken})()
                for taken in (True, False)]
        raise _Finished(self, _select(pred, *outs))


def _select(pred, a, b):
    def one(x, y):
        x, y = _as_tensor(x, pred.device), _as_tensor(y, pred.device)
        shape = torch.broadcast_shapes(pred.shape, x.shape, y.shape)
        p = pred.reshape(tuple(pred.shape) + (1,) * (len(shape) - pred.ndim))
        return torch.where(p, x, y)

    return tree_map(one, a, b)


def sample_primitive(adev_prim: ADEVPrimitive, *args, key=None):
    """A sample site. Outside an ADEV run it draws
    ``adev_prim.sample(key, *args)`` (``key(0)`` when no key is given),
    as plain execution of a guide does; under ADEV the site's strategy
    estimates the program's derivative, with the interpreter's keys."""
    run = _ACTIVE.get()
    if run is None:
        if key is None:
            dev = next((a.device for a in tree_leaves(args)
                        if isinstance(a, torch.Tensor)), None)
            key = random.key(0, device=dev)
        return adev_prim.sample(key, *args)
    return run.site(adev_prim, args, key)


def cond(pred, true_fun: Callable, false_fun: Callable, *operands):
    """``lax.cond`` for programs with sample sites. A Python predicate
    runs one branch. A tensor predicate (one per execution, or per
    element) runs both branches, each on its own key under ADEV, and
    selects elementwise. Where a branch holds a non-tail-call site the
    predicate is one per execution, and the program after the cond runs
    on through each branch (``_Run._split``)."""
    if isinstance(pred, (bool, int)):
        return (true_fun if pred else false_fun)(*operands)
    pred = torch.as_tensor(pred).to(torch.bool)
    run = _ACTIVE.get()
    if run is None:
        return _select(pred, true_fun(*operands), false_fun(*operands))
    return run.cond(pred, true_fun, false_fun, operands)


# -- programs and expectations ----------------------------------------------


def _batch_of(key) -> tuple:
    return tuple(key.shape[:-1])


def forward_mode(f: Callable, kont: Callable = lambda v: v):
    """The ADEV forward-mode transform of ``f``:
    ``(key, dual_args) -> kont(Dual of f's value)``."""

    def run(key, dual_args: tuple):
        with _level():
            args = tuple(_from_dual(Dual.tree_pure(a)) for a in dual_args)
            out = _Run(f, args, key, [], True, _batch_of(key))()
            return kont(_to_dual(out))

    return run


@Pytree.dataclass
class ADEVProgram(Pytree):
    source: Callable = Pytree.static()

    def jvp_estimate(self, key, dual_args: tuple, dual_kont: Callable
                     ) -> Dual:
        return forward_mode(self.source, dual_kont)(key, dual_args)


def _lift_arg(x, batch: tuple, device):
    """A primal argument as a tensor leading with the executions' batch:
    a Python number or a 0-d tensor is per execution."""
    x = _as_tensor(x, device)
    if not isinstance(x, torch.Tensor):
        return x
    if batch and x.ndim == 0:
        return x.expand(batch).clone()
    if tuple(x.shape[:len(batch)]) != batch:
        raise ValueError(
            f"an argument of shape {tuple(x.shape)} under the key batch "
            f"{batch}: every tensor argument of a batched expectation leads "
            "with the batch (lift a shared one with v.expand(batch + "
            "v.shape))")
    return x


@Pytree.dataclass
class Expectation(Pytree):
    """A program denoting an expected value. ``estimate`` gives an
    unbiased estimate of it, ``jvp_estimate`` of its directional
    derivative, ``grad_estimate`` of its gradient. A key batch
    ``E + (2,)`` gives one estimate per execution."""

    prog: ADEVProgram

    def jvp_estimate(self, key, dual_args) -> Dual:
        if isinstance(dual_args, Dual):
            dual_args = (dual_args,)
        return self.prog.jvp_estimate(key, tuple(dual_args), lambda v: v)

    def estimate(self, key, args: tuple):
        batch = _batch_of(key)
        duals = tuple(Dual.tree_pure(tree_map(
            lambda x: _lift_arg(x, batch, key.device), a)) for a in args)
        return _primal(self.jvp_estimate(key, duals).primal)

    def value_and_grad_estimate(self, key, primals: tuple):
        batch = _batch_of(key)
        leaves, spec = tree_flatten(tuple(primals))
        leaves = [_lift_arg(x, batch, key.device) for x in leaves]
        tangents = [torch.zeros_like(x, requires_grad=True) if _is_float(x)
                    else None for x in leaves]
        with _level():
            duals = [_make(x.detach() if _is_float(x) else x, t)
                     for x, t in zip(leaves, tangents)]
            args = tree_unflatten(duals, spec)
            out = _Run(self.prog.source, tuple(args), key, [], True, batch)()
            value, t_out = _unpack(_as_tensor(out))
            wrt = [t for t in tangents if t is not None]
            if t_out is not None and t_out.requires_grad and wrt:
                got = iter(torch.autograd.grad(t_out.sum(), wrt,
                                               allow_unused=True))
            else:
                got = iter([None] * len(wrt))
            grads = []
            for x, t in zip(leaves, tangents):
                if t is None:
                    grads.append(torch.zeros_like(_as_tensor(x),
                                                  dtype=torch.float32))
                    continue
                g = next(got)
                grads.append(torch.zeros_like(t.detach()) if g is None
                             else _primal(g).detach())
        return value.detach(), tree_unflatten(grads, spec)

    def grad_estimate(self, key, primals: tuple):
        return self.value_and_grad_estimate(key, primals)[1]


def expectation(source: Callable) -> Expectation:
    """Decorator: a loss program (plain Python over tensors, with sample
    sites) as a differentiable expectation."""
    return Expectation(ADEVProgram(source))
