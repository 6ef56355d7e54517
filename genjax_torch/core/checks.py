"""Opt-in runtime checks (counterpart of ``genjax_tpu/core/checks.py``).

JAX stages its checks with ``checkify`` and turns them on with a global
context. PyTorch runs eagerly, so a check here is a plain Python call;
the caller says whether it runs with ``enabled`` instead of a global
switch. A check that runs on a CUDA tensor reads it back to the host.
"""

from __future__ import annotations

from typing import Callable

__all__ = ["optional_check", "check"]


def check(pred, message: str) -> None:
    """Raise ``ValueError(message)`` unless ``pred`` holds everywhere."""
    if not bool(pred.all() if hasattr(pred, "all") else pred):
        raise ValueError(message)


def optional_check(fn: Callable[[], None], enabled: bool = False) -> None:
    """Run ``fn`` (which should call :func:`check`) iff ``enabled``."""
    if enabled:
        fn()
