"""Time-travel debugger: run a function while recording a frame at every
``rec`` / ``tag`` point, then step forward and backward through the
frames, jump to a tag, resume from any frame (with the recorded value or
a new one in its place) and re-run on new arguments (``remix``).
Counterpart of ``genjax_tpu/core/compiler/interpreters/time_travel.py``.

The JAX package stages the function to a jaxpr, snapshots its
environment at each frame and resumes by evaluating the rest of the
jaxpr. Eager PyTorch has no jaxpr, so resumption works by re-execution,
as ADEV's continuations do (``adev/core.py``): the function runs again
from its start, every frame before the cursor returns its recorded
value, the cursor's frame returns the recorded or substituted value, and
the rest runs live. The function must be deterministic given its
arguments (keys included), which functional keys make it.
"""

from __future__ import annotations

import contextvars
import dataclasses
from typing import Any, Callable

__all__ = ["rec", "tag", "time_machine", "TimeTravelingDebugger", "Frame"]


class _Recorder:
    """The active run: the frames it records, and the values it replays
    for the first ``len(replay)`` frames."""

    def __init__(self, replay: list):
        self.replay = replay
        self.frames: list[Frame] = []

    def record(self, v, name):
        i = len(self.frames)
        if i < len(self.replay):
            v = self.replay[i]
        self.frames.append(Frame(name, v, i))
        return v


_ACTIVE: contextvars.ContextVar[_Recorder | None] = contextvars.ContextVar(
    "genjax_torch_time_travel", default=None)


def rec(v, *, name: str | None = None):
    """Record a debugger frame holding ``v`` (the identity outside a
    :func:`time_machine` run)."""
    run = _ACTIVE.get()
    return v if run is None else run.record(v, name)


def tag(name: str):
    """Curried form: ``x = tag("x")(x)``."""

    def bind(v):
        return rec(v, name=name)

    return bind


@dataclasses.dataclass
class Frame:
    """One recorded instant: the tagged value and its position among the
    run's frames."""

    tag: str | None
    value: Any
    index: int


def _run(fn: Callable, args: tuple, replay: list):
    recorder = _Recorder(replay)
    token = _ACTIVE.set(recorder)
    try:
        out = fn(*args)
    finally:
        _ACTIVE.reset(token)
    return out, recorder.frames


class TimeTravelingDebugger:
    """Navigate the recorded frames of one execution.

    ``fwd`` / ``bwd`` move the cursor; ``jump(tag)`` moves to the first
    frame with that tag; ``frame.value`` is the recorded value;
    ``resume()`` re-runs the program from the cursor and returns its
    output; ``remix(*args)`` runs it afresh on new arguments (a new
    debugger)."""

    def __init__(self, fn: Callable, args: tuple, frames: list[Frame],
                 final: Any):
        self._fn = fn
        self._args = args
        self.frames = frames
        self.final = final
        self.cursor = 0

    # -- navigation -------------------------------------------------------

    @property
    def frame(self) -> Frame:
        return self.frames[self.cursor]

    def fwd(self) -> "TimeTravelingDebugger":
        self.cursor = min(self.cursor + 1, len(self.frames) - 1)
        return self

    def bwd(self) -> "TimeTravelingDebugger":
        self.cursor = max(self.cursor - 1, 0)
        return self

    def jump(self, tag: str) -> "TimeTravelingDebugger":
        for i, f in enumerate(self.frames):
            if f.tag == tag:
                self.cursor = i
                return self
        raise KeyError(f"No frame tagged {tag!r}")

    # -- execution --------------------------------------------------------

    def resume(self, value: Any | None = None):
        """Run the program on from the cursor's frame, with ``value`` in
        place of the recorded one if given; returns its output."""
        replay = [f.value for f in self.frames[:self.cursor]]
        replay.append(self.frame.value if value is None else value)
        out, _ = _run(self._fn, self._args, replay)
        return out

    def remix(self, *new_args) -> "TimeTravelingDebugger":
        """Re-execute from the beginning with new arguments."""
        return time_machine(self._fn)(*new_args)

    def __repr__(self):
        marks = [("*" if i == self.cursor else " ")
                 + (f.tag or f"frame{i}") for i, f in enumerate(self.frames)]
        return f"<TimeTravelingDebugger [{', '.join(marks)}]>"


def time_machine(fn: Callable):
    """``time_machine(fn)(*args)``: run ``fn`` recording frames at every
    :func:`rec` / :func:`tag` point; returns a
    :class:`TimeTravelingDebugger`."""

    def run(*args) -> TimeTravelingDebugger:
        final, frames = _run(fn, args, [])
        return TimeTravelingDebugger(fn, args, frames, final)

    return run
