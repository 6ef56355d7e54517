"""Argument checks of the combinator constructors (counterpart of
``genjax_tpu/core/argcheck.py``): a malformed ``in_axes``, a plain
function where a generative function belongs, or a non-integer count
fails at construction with a ``TypeError`` / ``ValueError`` that names
the offending value, with the JAX package's messages."""

from __future__ import annotations

from typing import Any

__all__ = [
    "check_in_axes",
    "check_gen_fn",
    "check_gen_fns",
    "check_callable",
    "check_static_int",
]


def _is_axis(a) -> bool:
    return a is None or (isinstance(a, int) and not isinstance(a, bool))


def _valid_in_axes(ax) -> bool:
    if _is_axis(ax):
        return True
    if isinstance(ax, (tuple, list)):
        return all(_valid_in_axes(a) for a in ax)
    if isinstance(ax, dict):
        return all(_valid_in_axes(a) for a in ax.values())
    return False


def check_in_axes(in_axes: Any, name: str = "vmap") -> None:
    """``in_axes`` must be None, an int, or a (possibly nested)
    tuple/list/dict of those."""
    if not _valid_in_axes(in_axes):
        raise TypeError(
            f"{name}: in_axes must be None, an int, or a nested "
            f"tuple/list/dict of those; got {in_axes!r} "
            f"({type(in_axes).__name__})."
        )


def check_gen_fn(gen_fn: Any, name: str) -> None:
    from genjax_torch.gfi.gfn import GenerativeFunction

    if not isinstance(gen_fn, GenerativeFunction):
        raise TypeError(
            f"{name} expects a GenerativeFunction, got "
            f"{type(gen_fn).__name__}: {gen_fn!r}. (Decorate model "
            "functions with @gen.)"
        )


def check_gen_fns(fns, name: str) -> None:
    if not fns:
        raise ValueError(f"{name} requires at least one branch.")
    for i, f in enumerate(fns):
        check_gen_fn(f, f"{name} branch {i}")


def check_callable(f: Any, name: str) -> None:
    if not callable(f):
        raise TypeError(
            f"{name} expects a callable, got {type(f).__name__}: {f!r}."
        )


def check_static_int(n: Any, name: str, minimum: int = 1) -> None:
    if not isinstance(n, int) or isinstance(n, bool) or n < minimum:
        raise ValueError(
            f"{name} must be a static int >= {minimum}, got {n!r} "
            f"({type(n).__name__})."
        )
