"""Opt-in runtime checks (counterpart of ``genjax_tpu/core/checks.py``).

JAX stages its checks with ``checkify`` and turns them on inside a
``do_checkify()`` context. PyTorch runs eagerly, so a check here is a
plain Python call that raises at once; it runs inside ``do_checkify()``
(contexts nest), or where its caller passes ``enabled=True``. A check on a CUDA tensor reads it back to the host.
"""

from __future__ import annotations

import contextlib
from typing import Callable

__all__ = ["do_checkify", "checks_enabled", "optional_check", "check"]

_CHECKIFY_ENABLED: list[bool] = [False]


@contextlib.contextmanager
def do_checkify():
    """A context in which :func:`optional_check` runs its check."""
    _CHECKIFY_ENABLED.append(True)
    try:
        yield
    finally:
        _CHECKIFY_ENABLED.pop()


def checks_enabled() -> bool:
    return _CHECKIFY_ENABLED[-1]


def check(pred, message: str) -> None:
    """Raise ``ValueError(message)`` unless ``pred`` holds everywhere."""
    if not bool(pred.all() if hasattr(pred, "all") else pred):
        raise ValueError(message)


def optional_check(fn: Callable[[], None], enabled: bool = False) -> None:
    """Run ``fn`` (which should call :func:`check`) inside
    :func:`do_checkify`, or when ``enabled``."""
    if enabled or checks_enabled():
        fn()
