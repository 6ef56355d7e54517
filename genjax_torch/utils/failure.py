"""Failure detection and elastic recovery for long-running inference
(counterpart of ``genjax_tpu/utils/failure.py``).

- **Detection.** A run is cut into chunks of ``chunk`` steps, each a
  Python loop of ``step(i, state)`` calls ending in one
  :func:`all_finite` reduction over the state, read on the host once a
  chunk. A failed card or collective surfaces as an exception at a call,
  and a hung one as a wall-clock deadline (:class:`Watchdog`).
- **Recovery** restores the last checkpoint and goes on from its step.
  Steps are keyed by the GLOBAL step index, so randomness comes from
  ``fold_in(key, i)`` and a resumed run replays the same draws: recovery
  is bitwise reproducible. A directory checkpoint (DCP) restores onto
  the restoring world's template, so a run saved by a world of 2 goes on
  in a world of 1 (``utils/checkpoint.py``).

JAX folds a chunk into one ``lax.scan`` in one ``jit``; eager PyTorch
runs the chunk's steps one after another, with the same single host read
at its end.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass, field
from typing import Any, Callable

import torch
import torch.distributed as dist

from genjax_torch.core.pytree import tree_leaves, tree_map
from genjax_torch.utils.checkpoint import restore_checkpoint, save_checkpoint

__all__ = [
    "all_finite",
    "Watchdog",
    "FailureEvent",
    "ElasticResult",
    "mesh_place",
    "run_elastic",
]


def _world_devices() -> list:
    """The current world's ranks (one device each), or this process's
    device when no process group is up."""
    if dist.is_initialized():
        return list(range(dist.get_world_size()))
    return [torch.device("cuda") if torch.cuda.is_available()
            else torch.device("cpu")]


def mesh_place(axis_name: str = "particles",
               min_devices: int = 1) -> Callable[[Any, list], Any]:
    """Build a ``place(state, devs)`` that lays a WHOLE state (every rank
    holding the whole arrays, as after ``gather_leading_axis`` or a
    ``.npz`` restore) onto the current world: each leaf whose leading
    axis divides over the world's 1-D mesh (on the leaves' device)
    becomes this rank's rows, other leaves pass whole; without a process
    group the state passes whole. Raises when fewer than ``min_devices``
    are left. (A directory checkpoint restores onto this rank's rows by
    itself: :func:`run_elastic` needs no ``place`` for that.)"""

    def place(state: Any, devs: list) -> Any:
        if len(devs) < min_devices:
            raise RuntimeError(
                f"mesh_place: only {len(devs)} healthy devices left "
                f"(< min_devices={min_devices})")
        if not dist.is_initialized():
            return state
        from genjax_torch.parallel.mesh import mesh_axis, particle_mesh

        dev = next((v.device for v in tree_leaves(state)
                    if isinstance(v, torch.Tensor)), torch.device("cpu"))
        ax = mesh_axis(particle_mesh(dev.type, axis_name), axis_name)

        def put(x):
            if (isinstance(x, torch.Tensor) and x.ndim >= 1
                    and x.shape[0] % ax.size == 0 and x.shape[0] > 0):
                per = x.shape[0] // ax.size
                return x[ax.rank * per:(ax.rank + 1) * per]
            return x

        return tree_map(put, state)

    return place


def all_finite(tree: Any) -> torch.Tensor:
    """One boolean 0-d tensor: every floating leaf of ``tree`` is finite
    (integer and boolean leaves are skipped). Read it once a chunk."""
    flags = [torch.isfinite(x).all() for x in tree_leaves(tree)
             if isinstance(x, torch.Tensor) and (x.is_floating_point()
                                                 or x.is_complex())]
    flags += [torch.tensor(bool(x == x and abs(x) != float("inf")))
              for x in tree_leaves(tree) if isinstance(x, float)]
    if not flags:
        return torch.tensor(True)
    dev = flags[0].device
    return torch.stack([f.to(dev) for f in flags]).all()


class Watchdog:
    """Wall-clock deadline around a (possibly hanging) call. It kills
    nothing: it records that the deadline passed, so the driver loop can
    treat the call as a failure once it returns::

        with Watchdog(60.0) as dog:
            ok = bool(all_finite(state))   # the sync point
        if dog.expired: ...
    """

    def __init__(self, seconds: float):
        self.seconds = seconds
        self._t0 = 0.0
        self.expired = False

    def __enter__(self) -> "Watchdog":
        self._t0 = time.monotonic()
        return self

    def __exit__(self, *exc) -> None:
        self.expired = (time.monotonic() - self._t0) > self.seconds
        return None


@dataclass
class FailureEvent:
    """One detected failure and what recovery did about it."""

    step: int                 # global step index at which the chunk began
    kind: str                 # "nonfinite" | "exception" | "hang" |
                              # "recovery_failed"
    detail: str
    resumed_from: int         # global step of the restored checkpoint
                              # (-1: recovery itself failed)
    n_devices: int            # healthy device count after recovery


@dataclass
class ElasticResult:
    state: Any
    events: list[FailureEvent] = field(default_factory=list)
    steps_run: int = 0        # includes replayed steps


def _write_step(path: str, at: int) -> None:
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "w") as f:
        f.write(str(at))
    os.replace(tmp, path)


def run_elastic(
    step: Callable[[int, Any], Any],
    state: Any,
    n_steps: int,
    *,
    ckpt_path: str,
    chunk: int = 64,
    checkpoint_every: int = 1,
    max_retries: int = 3,
    devices: Callable[[], list] | None = None,
    place: Callable[[Any, list], Any] | None = None,
    deadline: float | None = None,
) -> ElasticResult:
    """Run ``state = step(i, state)`` for ``i in range(n_steps)`` with
    detection and checkpointed recovery.

    - ``step(i, state)``: one inference step; ``i`` is the GLOBAL step
      index (a Python int): derive randomness as ``fold_in(key, i)``.
    - ``ckpt_path``: a ``.npz`` file or a DCP directory (its step beside
      it in ``ckpt_path + ".step"``); in a world of several ranks, a
      directory (each rank saves its rows over the world's 1-D mesh).
    - ``chunk``: steps between two finiteness checks (one host read);
      ``checkpoint_every``: the checkpoint cadence in chunks.
    - ``devices()``: the current healthy devices, polled after each
      failure (default: the world's ranks, or this process's device).
    - ``place(state, devs)``: a hook run on the restore template and on
      the restored state (clearing a transient fault flag, say); default
      the state as it is.
    - ``deadline``: wall-clock seconds a chunk may take; a slower chunk
      counts as a ``"hang"`` failure when it returns.

    Returns :class:`ElasticResult`; raises after ``max_retries``
    consecutive failed recoveries.
    """
    if devices is None:
        devices = _world_devices
    if place is None:
        def place(s, devs):
            return s
    if n_steps % chunk != 0:
        raise ValueError(
            f"n_steps={n_steps} must be a multiple of chunk={chunk}.")

    def run_chunk(st, start: int):
        for i in range(start, start + chunk):
            st = step(i, st)
        return st, all_finite(st)

    def _save(at: int, st: Any) -> None:
        save_checkpoint(ckpt_path, st)
        _write_step(ckpt_path + ".step", at)

    def _restore(template: Any) -> tuple[int, Any]:
        with open(ckpt_path + ".step") as f:
            at = int(f.read())
        return at, restore_checkpoint(ckpt_path, template)

    result = ElasticResult(state=state)
    _save(0, state)
    i = 0
    retries = 0
    template = state
    while i < n_steps:
        failed = None
        try:
            limit = float("inf") if deadline is None else deadline
            with Watchdog(limit) as dog:
                new_state, ok = run_chunk(state, i)
                ok = bool(ok)  # the one host read a chunk
            if dog.expired:
                failed = ("hang", f"chunk at step {i} exceeded "
                                  f"{deadline}s deadline")
            elif not ok:
                failed = ("nonfinite", f"non-finite state after chunk "
                                       f"starting at step {i}")
        except Exception as e:  # a failed call, card or collective
            failed = ("exception", f"{type(e).__name__}: {e}")

        if failed is None:
            state = new_state
            i += chunk
            result.steps_run += chunk
            retries = 0
            if (i // chunk) % checkpoint_every == 0:
                _save(i, state)
            continue

        retries += 1
        kind, detail = failed
        if retries > max_retries:
            raise RuntimeError(
                f"run_elastic: giving up after {max_retries} retries "
                f"({kind} at step {i}: {detail})")
        # Restore into the current world: a zero stand-in for the template
        # (shapes, dtypes and devices only) through ``place``, the
        # checkpoint read into it, then ``place`` on the restored values.
        # A failure here counts against ``max_retries`` instead of
        # escaping.
        try:
            devs = devices()
            meta = tree_map(lambda v: torch.zeros_like(v)
                            if isinstance(v, torch.Tensor) else v, template)
            at, restored = _restore(place(meta, devs))
            state = place(restored, devs)
        except Exception as e:
            result.events.append(FailureEvent(
                step=i, kind="recovery_failed",
                detail=f"{type(e).__name__}: {e}",
                resumed_from=-1, n_devices=-1))
            continue
        result.events.append(FailureEvent(
            step=i, kind=kind, detail=detail,
            resumed_from=at, n_devices=len(devs)))
        i = at

    result.state = state
    return result
