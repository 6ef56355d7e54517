"""Profiling hooks: Chrome traces of inference programs through
``torch.profiler``, and timing that waits for the device (counterpart of
``genjax_tpu/utils/profiling.py``)."""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator

import torch

__all__ = ["profile_trace", "Timed"]


@contextlib.contextmanager
def profile_trace(logdir: str) -> Iterator[torch.profiler.profile]:
    """Record the host's operators and, with a card, its kernels, and
    write a Chrome trace (``chrome://tracing``, Perfetto) to
    ``logdir/trace.json``::

        with profile_trace("traces/pf") as prof:
            run(key)   # the trace waits for the device before it ends

    The profile object is yielded for ``key_averages()``."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        try:
            yield prof
        finally:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


class Timed:
    """Wall-clock timing of a callable that waits for the device::

        t = Timed(fn); out = t(args); t.last_s

    The clock stops after the card has finished the work the call
    queued (PyTorch returns before the device does)."""

    def __init__(self, fn):
        self.fn = fn
        self.last_s: float | None = None

    def __call__(self, *args, **kwargs):
        t0 = time.perf_counter()
        out = self.fn(*args, **kwargs)
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.last_s = time.perf_counter() - t0
        return out
