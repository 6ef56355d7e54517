"""What the ``test_torch_examples_*.py`` files share: run a documented JAX
program as ``tests/docs/test_examples.py`` runs it (``runpy`` as
``__main__``, stdout captured), read the numbers on its labelled result
lines, and hold the port's program (``genjax_torch.examples``) to them
under the checks of ``genjax_torch.examples.specs`` (the tolerances and
their reasons: ``genjax_torch.examples.holding``).

Every case also holds the port's live CPU run to its entry in
``examples/cpu_reference.json``, which ``chip_smoke.py`` phase 32 holds
the card to, and refuses an entry recorded from other sources than the
port's current ones. A program whose documented size takes minutes (it
defines ``REHEARSAL``, smaller ``SIZES``) is held to the JAX program at
that size through the reference, and runs live at its ``REHEARSAL``
sizes against the reference's rehearsal; ``test_torch_examples_documented``
(marked slow) runs those programs live at their documented size.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import math
import pathlib
import re
import runpy

from genjax_torch.examples import holding as H
from genjax_torch.examples.specs import PROGRAMS

REPO = pathlib.Path(__file__).resolve().parents[2]
DOCS = REPO / "docs"
NUMBER = re.compile(r"[-+]?(?:\d+\.\d*|\.\d+|\d+)(?:[eE][-+]?\d+)?|nan|inf")


def run_jax_program(rel: str) -> str:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        runpy.run_path(str(DOCS / rel), run_name="__main__")
    return buf.getvalue()


def text_after(out: str, label: str) -> str:
    """The rest of the line that starts with ``label``; a numpy array
    that the JAX program printed over several lines is read to its
    closing bracket."""
    lines = out.splitlines()
    for i, line in enumerate(lines):
        if line.strip().startswith(label):
            rest = line.strip()[len(label):]
            j = i + 1
            while rest.count("[") > rest.count("]") and j < len(lines):
                rest += " " + lines[j].strip()
                j += 1
            return rest.strip()
    raise AssertionError(f"no line starting {label!r} in:\n{out}")


def numbers_on(out: str, label: str) -> list:
    return [float(x) for x in NUMBER.findall(text_after(out, label))]


def compare(prog: H.Program, jax_out: str, port: dict) -> list:
    """Every check of ``prog``: ``(label, jax value, port value, bound)``
    of each compared number; raises on the first that fails."""
    rows = []
    for c in prog.checks:
        if c.tol.kind in ("text", "contains"):
            want_text, got_text = text_after(jax_out, c.label), str(
                port[c.port_key])
            ok = (want_text == got_text if c.tol.kind == "text"
                  else got_text in want_text)
            assert ok, (prog.name, c.label, want_text, got_text)
            rows.append((c.label, want_text, got_text, c.tol.kind))
            continue
        nums = numbers_on(jax_out, c.label)
        want = nums[c.numbers] if isinstance(c.numbers, slice) \
            else [nums[c.numbers]]
        got = H.flat(port[c.port_key])
        assert len(got) == len(want), (c.label, got, want)
        for i, (g, w) in enumerate(zip(got, want)):
            key = c.tol.spread_key
            if key is not None and len(want) > 1:
                key = f"{key}[{i}]"
            b = H.bound(dataclasses.replace(c.tol, spread_key=key),
                        prog.name, w)
            assert math.isfinite(g), (c.label, g)
            assert abs(g - w) <= b, (
                f"{prog.name}: {c.label} port {g} vs JAX {w}, bound {b} "
                f"({c.tol.why})")
            rows.append((c.label, w, g, b))
    return rows


def _port_run(name: str, sizes=None) -> dict:
    """The port's program on the CPU. Two intra-op threads, as the
    reference was recorded with: the suite's workers share the host's
    cores, and a program's tensors of 2^16 elements slow down tenfold
    when every worker takes them all."""
    import torch

    from genjax_torch.examples import run_program

    before = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        out = run_program(name, "cpu", sizes)["result"]
    finally:
        torch.set_num_threads(before)
    assert H.finite_tree(out), out
    return out


def hold_program(name: str, documented: bool = False) -> list:
    """Run the JAX program and hold the port's results to it: the live
    port run at the documented size (or, for a program with ``REHEARSAL``
    sizes unless ``documented``, the recorded reference at that size,
    with a live run at the ``REHEARSAL`` sizes held to the recorded one).
    The live run at the documented size is held to the reference too."""
    import json

    prog = PROGRAMS[name]
    jax_out = run_jax_program(prog.jax_path)
    assert "nan" not in jax_out.lower()
    ref = H.reference()[name]
    H.check_current(name, ref)
    sizes = H.rehearsal_sizes(name)
    if sizes is None or documented:
        port = _port_run(name)
        H.hold_to_port(prog, port, ref["result"])
    else:
        port = ref["result"]
        assert ref["rehearsal"]["sizes"] == json.loads(json.dumps(sizes))
        H.hold_to_port(prog, _port_run(name, sizes),
                       ref["rehearsal"]["result"],
                       spread_name=name + "@rehearsal")
    assert H.finite_tree(port), port
    return compare(prog, jax_out, port)
