"""``Dimap``: a pre-map of the arguments and a post-map of the return
value around a generative function, its choices unnested (counterpart of
``genjax_tpu/lang/combinators/dimap.py``).

The JAX package pushes argdiffs through ``pre`` with its incremental
interpreter; the port has none, so ``edit`` takes the coarse rule of the
``@gen`` edit handlers: the inner arguments count as changed when any
argument did. A ``post`` that needs the key batch's shape (the Scan
helpers' ``prepend_initial_acc``: the step axis follows the batch) is
declared with ``post_batch=True`` and called ``post(args, ret, batch)``.
"""

from __future__ import annotations

from typing import Any, Callable

from genjax_torch.core.compiler.interpreters.incremental import Diff
from genjax_torch.core.pytree import Pytree
from genjax_torch.gfi.choice_map import ChoiceMap
from genjax_torch.gfi.concepts import Argdiffs, EditRequest, Score
from genjax_torch.gfi.gfn import GenerativeFunction, Trace
from genjax_torch.gfi.selection import Selection

__all__ = ["Dimap", "DimapTrace", "dimap", "map_retval", "contramap"]


@Pytree.dataclass
class DimapTrace(Trace[Any]):
    gen_fn: "Dimap"
    inner: Trace
    args: tuple
    retval: Any

    def get_args(self) -> tuple:
        return self.args

    def get_retval(self):
        return self.retval

    def get_gen_fn(self):
        return self.gen_fn

    def get_score(self) -> Score:
        return self.inner.get_score()

    def get_choices(self) -> ChoiceMap:
        return self.inner.get_choices()

    def get_inner_trace(self, address):
        return self.inner.get_inner_trace(address)


def _identity_pre(*args):
    return args


def _identity_post(args, ret):
    return ret


@Pytree.dataclass
class Dimap(GenerativeFunction[Any]):
    """``pre: *args -> inner_args`` (a tuple), ``post: (args, inner_ret)
    -> ret`` (``(args, inner_ret, batch)`` with ``post_batch``)."""

    inner: GenerativeFunction[Any]
    pre: Callable = Pytree.static(default=_identity_pre)
    post: Callable = Pytree.static(default=_identity_post)
    post_batch: bool = Pytree.static(default=False)

    def _pre(self, args) -> tuple:
        inner_args = self.pre(*args)
        if not isinstance(inner_args, tuple):
            raise TypeError("Dimap pre must return an argument tuple")
        return inner_args

    def _post(self, args, ret, batch: tuple):
        if self.post_batch:
            return self.post(args, ret, tuple(batch))
        return self.post(args, ret)

    def simulate(self, key, args: tuple) -> DimapTrace:
        tr = self.inner.simulate(key, self._pre(args))
        return DimapTrace(self, tr, args,
                          self._post(args, tr.get_retval(), key.shape[:-1]))

    def assess(self, chm: ChoiceMap, args: tuple, batch: tuple = ()):
        score, ret = self.inner.assess(chm, self._pre(args), batch=batch)
        return score, self._post(args, ret, batch)

    def generate(self, key, constraint: ChoiceMap, args: tuple):
        tr, w = self.inner.generate(key, constraint, self._pre(args))
        return DimapTrace(self, tr, args, self._post(
            args, tr.get_retval(), key.shape[:-1])), w

    def project(self, key, trace: DimapTrace, selection: Selection):
        return self.inner.project(key, trace.inner, selection)

    def edit(self, key, trace: DimapTrace, request: EditRequest,
             argdiffs: Argdiffs):
        args = Diff.tree_primal(argdiffs)
        unchanged = Diff.static_check_no_change(argdiffs)
        inner_args = self._pre(args)
        new_inner, w, inner_retdiff, bwd = request.edit(
            key, trace.inner, Diff.no_change(inner_args) if unchanged
            else Diff.unknown_change(inner_args))
        retval = self._post(args, new_inner.get_retval(), key.shape[:-1])
        retdiff = (Diff.no_change(retval) if unchanged
                   and Diff.static_check_no_change(inner_retdiff)
                   else Diff.unknown_change(retval))
        return DimapTrace(self, new_inner, args, retval), w, retdiff, bwd


def dimap(*, pre=None, post=None) -> Callable:
    def decorator(gen_fn: GenerativeFunction) -> Dimap:
        return Dimap(gen_fn, pre or _identity_pre, post or _identity_post)

    return decorator


def map_retval(post: Callable) -> Callable:
    def decorator(gen_fn: GenerativeFunction) -> Dimap:
        return Dimap(gen_fn, post=lambda args, ret: post(ret))

    return decorator


def contramap(pre: Callable) -> Callable:
    def decorator(gen_fn: GenerativeFunction) -> Dimap:
        return Dimap(gen_fn, pre=pre)

    return decorator
