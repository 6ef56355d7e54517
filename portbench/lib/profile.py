"""The traced part of a run: the device's events under ``torch.profiler``,
and the PyTorch ops a call dispatches by the port's module that issued
them. Frozen copies of ``chip_smoke.py``'s ``profiled`` / ``_event_totals``
(raw profiler events, summed without ``key_averages``, a profile that saw
no device event taken again) and ``ops_by_module``, so that a later
change to the smoke script cannot move the yardstick.
"""

from __future__ import annotations

import collections
import os
import sys
import time
from dataclasses import dataclass, field


@dataclass
class DeviceProfile:
    """Device events of a profiled stretch of calls: ``events`` as
    ``(name, start_ns, duration_ns)`` sorted by start, ``host`` the host
    ops as the same triples (both on the profiler's clock), ``wall_s``
    the stretch's host-clock span from its first call's start to its last
    synchronize. ``events`` is empty when no try saw the device (not
    measured)."""

    events: list = field(default_factory=list)
    host: list = field(default_factory=list)
    wall_s: float = 0.0

    def span_ns(self) -> tuple:
        """The profiled stretch on the profiler's clock: from the first
        host op to the last end of any event."""
        both = self.events + self.host
        if not both:
            return 0, 0
        start = self.host[0][1] if self.host else self.events[0][1]
        return start, max(s + d for _, s, d in both)


def _raw_events(prof):
    """``(device events, host events)`` straight from
    the raw events. As ``chip_smoke._event_totals``: an event the profiler
    hides is left out, and an async one (ending on another thread) has no
    length."""
    from torch.autograd import DeviceType

    dev, host = [], []
    for evt in prof.profiler.kineto_results.events():
        if getattr(evt, "is_hidden_event", lambda: False)():
            continue
        ns = 0 if (evt.is_async() or evt.start_thread_id()
                   != evt.end_thread_id()) else evt.duration_ns()
        item = (evt.name(), evt.start_ns(), ns)
        if evt.device_type() == DeviceType.CUDA:
            dev.append(item)
        else:
            host.append(item)
    dev.sort(key=lambda e: e[1])
    host.sort(key=lambda e: e[1])
    return dev, host


def profile_calls(call, calls: int, sync, tries: int = 3) -> DeviceProfile:
    """``calls`` calls of ``call()`` under ``torch.profiler`` (host and
    device activity), each ending in ``sync()``. A profile that holds no
    device event at all (the card's profiler now and then stops its
    device collection early) is taken again, up to ``tries`` times; if
    none saw the device the result has no events."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    out = DeviceProfile()
    for attempt in range(1, tries + 1):
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            for _ in range(calls):
                call()
                sync()
            wall = time.perf_counter() - t0
        dev, host = _raw_events(prof)
        out.wall_s = wall
        out.host = host
        if dev:
            out.events = dev
            return out
        print(f"[profiler] profile {attempt} of {tries} saw no device time",
              file=sys.stderr, flush=True)
    return out


def busy_ns(events) -> int:
    """The union of the events' intervals, in ns."""
    total, end = 0, None
    for _, s, d in events:
        e = s + d
        if end is None or s > end:
            total += d
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def idle_gaps(events, start_ns: int, stop_ns: int):
    """The stretches in ``[start_ns, stop_ns]`` in which no device event
    ran, as ``(start, length, next event's name)``, longest first."""
    gaps, cur = [], start_ns
    for name, s, d in events:
        if s > cur:
            gaps.append((cur, s - cur, name))
        cur = max(cur, s + d)
    if stop_ns > cur:
        gaps.append((cur, stop_ns - cur, "(end of window)"))
    gaps.sort(key=lambda g: -g[1])
    return gaps


def host_op_at(host, t_ns: int) -> str:
    """The innermost host op running at ``t_ns`` (the latest started one
    that has not ended), or the host's idle."""
    best = None
    for name, s, d in host:
        if s > t_ns:
            break
        if s + d >= t_ns:
            best = name
    return best or "(host outside any op)"


def kernel_base(name: str) -> str:
    """A device op's bare function name: ``void ns::step<...>(args)`` ->
    ``step``."""
    head = name.replace("(anonymous namespace)::", "").split("(")[0].strip()
    depth, out = 0, []
    for ch in head:        # drop template arguments
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif depth == 0:
            out.append(ch)
    head = "".join(out).split("::")[-1].strip()
    return head.split()[-1] if head.split() else head


def ops_by_module(fn) -> dict:
    """The PyTorch ops that one call of ``fn()`` dispatches, by the
    innermost ``genjax_torch`` module on the Python stack of each (the
    layer that issued it): ``{module: count}``, most first."""
    from torch.utils._python_dispatch import TorchDispatchMode

    by = collections.Counter()
    mark = "genjax_torch" + os.sep

    class Count(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            f = sys._getframe(1)
            while f is not None and mark not in f.f_code.co_filename:
                f = f.f_back
            by["(outside)" if f is None else
               f.f_code.co_filename.split(mark)[-1]] += 1
            return func(*args, **(kwargs or {}))

    with Count():
        fn()
    return dict(by.most_common())
