"""Argument validation of the public GFI surface (counterpart of
``genjax_tpu/core/validate.py``).

``GenerativeFunction.__init_subclass__`` installs these checks on every
concrete ``simulate`` / ``assess`` / ``generate`` / ``edit`` that a class
defines, so that a seed in the key position, a list of arguments or a
dict in place of a choice map fails at the call with a ``TypeError``
that names the method, with the JAX package's messages.

The JAX package runs its checks once per trace (inside ``jax.jit`` they
never reach the compiled program). PyTorch runs eagerly, so here they
run on every call: a few ``isinstance`` tests each, no tensor read.
:func:`no_validation` turns them off.
"""

from __future__ import annotations

import contextlib
import functools

import torch

__all__ = [
    "check_key",
    "check_args",
    "check_choice_map",
    "no_validation",
    "install_gfi_checks",
]

_enabled = True


@contextlib.contextmanager
def no_validation():
    """Turn the argument checks off for the duration of the block."""
    global _enabled
    prev, _enabled = _enabled, False
    try:
        yield
    finally:
        _enabled = prev


def _is_key(x) -> bool:
    """The port's key layout: an int64 tensor ``B + (2,)`` of words
    (``core/random.py``)."""
    return (isinstance(x, torch.Tensor) and x.dtype == torch.int64
            and x.ndim >= 1 and x.shape[-1] == 2)


def check_key(key, where: str):
    if _enabled and not _is_key(key):
        raise TypeError(
            f"{where}: expected a PRNG key (genjax_torch.core.random."
            f"key(seed)), got {type(key).__name__}"
            + (f" of dtype {key.dtype}" if hasattr(key, "dtype") else "")
            + ". Did you pass args or a seed int in the key position?"
        )


def check_args(args, where: str):
    if _enabled and not isinstance(args, tuple):
        hint = (
            " For a single argument write (x,), for none write ()."
            if not isinstance(args, (list, dict))
            else ""
        )
        raise TypeError(
            f"{where}: args must be a tuple, got "
            f"{type(args).__name__}.{hint}"
        )


def check_choice_map(chm, where: str):
    from genjax_torch.gfi.choice_map import ChoiceMap

    if _enabled and not isinstance(chm, ChoiceMap):
        hint = (
            " Build one with C['addr'].set(v), ChoiceMap.d({...}), or "
            "ChoiceMap.kw(...)."
        )
        raise TypeError(
            f"{where}: expected a ChoiceMap, got "
            f"{type(chm).__name__}.{hint}"
        )


def _wrap_simulate(fn, cls_name):
    @functools.wraps(fn)
    def simulate(self, key, args):
        check_key(key, f"{cls_name}.simulate")
        check_args(args, f"{cls_name}.simulate")
        return fn(self, key, args)

    simulate.__gfi_checked__ = True
    return simulate


def _wrap_assess(fn, cls_name):
    @functools.wraps(fn)
    def assess(self, chm, args, batch=()):
        check_choice_map(chm, f"{cls_name}.assess")
        check_args(args, f"{cls_name}.assess")
        return fn(self, chm, args, batch=batch)

    assess.__gfi_checked__ = True
    return assess


def _wrap_generate(fn, cls_name):
    @functools.wraps(fn)
    def generate(self, key, constraint, args):
        check_key(key, f"{cls_name}.generate")
        check_choice_map(constraint, f"{cls_name}.generate")
        check_args(args, f"{cls_name}.generate")
        return fn(self, key, constraint, args)

    generate.__gfi_checked__ = True
    return generate


def _wrap_edit(fn, cls_name):
    @functools.wraps(fn)
    def edit(self, key, trace, request, argdiffs):
        check_key(key, f"{cls_name}.edit")
        check_args(argdiffs, f"{cls_name}.edit (argdiffs)")
        return fn(self, key, trace, request, argdiffs)

    edit.__gfi_checked__ = True
    return edit


_WRAPPERS = {
    "simulate": _wrap_simulate,
    "assess": _wrap_assess,
    "generate": _wrap_generate,
    "edit": _wrap_edit,
}


def install_gfi_checks(cls) -> None:
    """Wrap the GFI methods ``cls`` itself defines (not inherited ones)
    with argument validation. Idempotent."""
    for name, wrapper in _WRAPPERS.items():
        fn = cls.__dict__.get(name)
        if fn is None or getattr(fn, "__gfi_checked__", False):
            continue
        if getattr(fn, "__isabstractmethod__", False):
            continue
        setattr(cls, name, wrapper(fn, cls.__name__))
