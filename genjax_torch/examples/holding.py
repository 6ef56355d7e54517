"""How a ported program's results are held to another run of the same
program: its JAX program's printed numbers (the CPU tests), its CPU
reference (``chip_smoke.py`` phase 32 on the card), a live run against a
recorded one.

A :class:`Check` (in :mod:`genjax_torch.examples.specs`) names a JAX
result line by its label, which numbers of it to read, the port's result
key, and the tolerance with its reason:

- ``exact(rel)``: the f32 path matches and the keys are threefry-matched,
  so the two agree to ``rel`` relative (plus 1e-6 absolute for values
  near 0);
- ``mc(k, key)``: a Not-fault of ROADMAP §3 (the CDF kernel's plain
  summation order, the ADEV tail-call key, a sampler whose rejection loop
  draws other variates from the same keys) or a Monte Carlo difference
  lies on the path, so the two agree within ``k`` standard deviations of
  their difference, ``sqrt(2)`` times the port's sd over other seeds as
  ``tools/examples_spread.py`` records it in ``spread.json``;
- ``absolute(x, why)``: a bound given by the program's own model.

``cpu_reference.json`` (``tools/examples_reference.py``) holds each
program's ``main(device="cpu")`` results, recorded with the list of the
port's source files the program loaded and a hash of them:
:func:`check_current` refuses an entry once any of those files changed.
"""

from __future__ import annotations

import dataclasses
import hashlib
import importlib
import json
import math
import pathlib

HERE = pathlib.Path(__file__).resolve().parent
#: The root the recorded source paths are relative to (the checkout).
ROOT = HERE.parents[1]

__all__ = ["Tol", "Check", "Program", "exact", "mc", "absolute", "text",
           "contains", "printed", "spread", "reference", "sources_sha",
           "loaded_sources", "check_current", "bound", "flat",
           "finite_tree", "hold_to_port", "rehearsal_sizes"]


@dataclasses.dataclass(frozen=True)
class Tol:
    kind: str
    value: float
    why: str
    spread_key: str | None = None
    floor: float = 0.0


def exact(rel: float = 1e-5) -> Tol:
    return Tol("exact", rel, "f32 path and threefry keys matched")


def mc(k: float, spread_key: str, why: str, floor: float = 0.0) -> Tol:
    """``floor``: the JAX program prints the value rounded, to within
    ``floor``, so the bound is never below it."""
    return Tol("mc", k, why, spread_key, floor)


def absolute(x: float, why: str) -> Tol:
    return Tol("abs", x, why)


def printed(decimals: int) -> Tol:
    """A value the JAX program prints to ``decimals`` decimals: within
    0.6 of its last digit."""
    return absolute(0.6 * 10.0 ** -decimals,
                    f"the JAX program prints {decimals} decimals")


def text(why: str = "the same message") -> Tol:
    """The JAX line's text after its label equals the port's string."""
    return Tol("text", 0.0, why)


def contains(why: str) -> Tol:
    """The port's string is part of the JAX line's text."""
    return Tol("contains", 0.0, why)


@dataclasses.dataclass(frozen=True)
class Check:
    label: str            # the JAX line starts with this text
    numbers: slice | int  # which numbers after the label
    port_key: str         # the port's result key (a number or a list)
    tol: Tol


@dataclasses.dataclass(frozen=True)
class Program:
    name: str             # the port module, e.g. "ex01_beta_bernoulli_sir"
    jax_path: str         # the JAX program, relative to docs/
    checks: tuple
    not_compared: dict = dataclasses.field(default_factory=dict)


def spread() -> dict:
    return json.loads((HERE / "spread.json").read_text())


def reference() -> dict:
    return json.loads((HERE / "cpu_reference.json").read_text())


def loaded_sources() -> list:
    """The port's source files loaded in this process, relative to the
    checkout: call it in a process that ran one program and nothing
    else."""
    import sys

    pkg = HERE.parent
    files = set()
    for mod in list(sys.modules.values()):
        f = getattr(mod, "__file__", None)
        if f and pathlib.Path(f).resolve().is_relative_to(pkg):
            files.add(str(pathlib.Path(f).resolve().relative_to(ROOT)))
    return sorted(files)


def sources_sha(files) -> str:
    """SHA-256 of the named source files, their paths and contents."""
    h = hashlib.sha256()
    for rel in sorted(files):
        h.update(rel.encode() + b"\0")
        h.update((ROOT / rel).read_bytes())
        h.update(b"\0")
    return h.hexdigest()


def check_current(name: str, entry: dict) -> None:
    """Raise unless ``entry``, a program's reference, was recorded from
    the port's sources as they are now (every file the program loaded).
    A program that comes to load another file changes one it loaded."""
    if sources_sha(entry["sources"]) != entry["source_sha256"]:
        raise AssertionError(
            f"{name}: a source file it loads changed since its reference "
            f"was recorded: rerun tools/examples_reference.py --only {name}")


def bound(tol: Tol, name: str, want: float) -> float:
    if tol.kind == "exact":
        return tol.value * abs(want) + 1e-6
    if tol.kind == "abs":
        return tol.value
    sd = spread()[name][tol.spread_key]["sd"]
    return max(tol.floor, tol.value * math.sqrt(2.0) * sd)


def flat(v) -> list:
    if isinstance(v, (list, tuple)):
        return [float(x) for x in v]
    return [float(v)]


def finite_tree(v) -> bool:
    if isinstance(v, (bool, str)):
        return True
    if isinstance(v, (int, float)):
        return math.isfinite(v)
    if isinstance(v, dict):
        return all(finite_tree(x) for x in v.values())
    if isinstance(v, (list, tuple)):
        return all(finite_tree(x) for x in v)
    return True


def rehearsal_sizes(name: str) -> dict | None:
    """The program's ``REHEARSAL`` sizes (a smaller run of it, for a
    program whose documented size takes minutes), or None."""
    from genjax_torch.examples import module_name

    return getattr(importlib.import_module(module_name(name)), "REHEARSAL",
                   None)


def hold_to_port(prog: Program, got: dict, want: dict,
                 spread_name: str | None = None, widen=()) -> float:
    """One port run against another (a live run against the recorded
    one, the card against the CPU): every checked value within its
    check's bound, the Monte Carlo spreads read under ``spread_name`` (a
    rehearsal's own); a key in ``widen`` gets at least the Monte Carlo
    bound. Returns the largest share of a bound used."""
    sname = spread_name or prog.name
    worst = 0.0
    for c in prog.checks:
        if c.tol.kind in ("text", "contains"):
            assert str(got[c.port_key]) == str(want[c.port_key]), (
                c.port_key, got[c.port_key], want[c.port_key])
            continue
        gs, ws = flat(got[c.port_key]), flat(want[c.port_key])
        assert len(gs) == len(ws), (c.port_key, gs, ws)
        for i, (g, w) in enumerate(zip(gs, ws)):
            key = c.port_key + (f"[{i}]" if len(ws) > 1 else "")
            b = bound(dataclasses.replace(c.tol, spread_key=key), sname, w)
            if key in widen:
                b = max(b, 4 * math.sqrt(2.0) * spread()[sname][key]["sd"])
            assert math.isfinite(g) and abs(g - w) <= b, (
                f"{prog.name}: {key} {g} vs {w}, bound {b} ({c.tol.why})")
            worst = max(worst, abs(g - w) / b if b else 0.0)
    return worst
