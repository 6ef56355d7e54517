"""Cookbook 3 — Debugging probabilistic programs.

Four layers of tooling, from cheapest to deepest:

1. **Static sanitizers** — address mistakes caught when the body runs.
2. **Runtime checks** — ``do_checkify`` validity checks (NaN scores,
   invalid constraints, unmasking a dead value). PyTorch runs eagerly,
   so a check inside ``do_checkify()`` raises at once where the JAX
   package stages it into the compiled program and reports it on
   request; outside the context it costs nothing.
3. **Rich rendering** — ``pformat``/``render_html`` for traces and
   choice maps (lane counts, active switch branches, mask occupancy).
4. **Time-travel debugging** — record intermediate values of a
   computation, jump between frames, substitute values, and replay the
   tail (``core/compiler/interpreters/time_travel.py``; the port replays
   by re-running the function with the frames before the cursor fixed).
"""

import torch

import genjax_torch as g
from genjax_torch.core import random
from genjax_torch.core.compiler.interpreters.time_travel import (
    rec,
    time_machine,
)
from genjax_torch.examples import resolve_device
from genjax_torch.utils import pformat, render_html


# -- 1. sanitizers -------------------------------------------------------
# Using the same address twice is a bug (the second choice would
# silently shadow the first). The DSL raises immediately:
@g.gen
def reused():
    g.normal(0.0, 1.0) @ "x"
    return g.normal(0.0, 1.0) @ "x"


# Assessing with an incomplete choice map (a missing site) is also an
# immediate error — assess scores COMPLETE maps only:
@g.gen
def pair():
    x = g.normal(0.0, 1.0) @ "x"
    return g.normal(x, 1.0) @ "y"


# -- 3. rendering --------------------------------------------------------
@g.gen
def branchy(p):
    which = g.flip(p) @ "which"
    return (
        g.switch(
            g.gen(lambda: g.normal(0.0, 1.0) @ "small"),
            g.gen(lambda: g.normal(10.0, 1.0) @ "big"),
        )(which.to(torch.int32), (), ())
        @ "value"
    )


# -- 4. time travel ------------------------------------------------------
# `rec` marks intermediate values worth recording; `time_machine` runs
# the function once, capturing a frame at each mark. You can then jump
# around and counterfactually replay.
def pipeline(x):
    a = rec(x * 2.0, name="doubled")
    b = rec(a + 10.0, name="shifted")
    return b * b


def main(device=None) -> dict:
    device = resolve_device(device)
    key = random.key(0, device=device)
    out = {}
    try:
        reused.simulate(key, ())
    except g.AddressReuse as e:
        out["address_reuse"] = str(e)
    try:
        pair.assess(g.C["x"].set(torch.tensor(1.0, device=device)), ())
    except g.MissingAddress as e:
        out["missing_address"] = str(e)

    # -- 2. runtime checks ---------------------------------------------------
    # The classic mistake: unmasking a Mask whose flag is False — e.g.
    # reading a switch branch that wasn't taken, or a lane past a scan's
    # masked horizon.
    dead_value = g.Mask(torch.tensor(1.0, device=device),
                        torch.tensor(False, device=device))
    out["silent_unmask"] = float(dead_value.unmask())
    with g.do_checkify():
        try:
            dead_value.unmask()
            out["checkify"] = None
        except ValueError as e:
            out["checkify"] = str(e)
    # "Attempted to unmask a Mask with flag False."
    assert out["checkify"] is not None

    tr = branchy.simulate(key, (0.3,))
    out["trace"] = pformat(tr)  # switch branches annotated active/inactive
    html = render_html(tr)  # collapsible HTML; save or _repr_html_ in Jupyter
    assert "<details" in html
    out["score"] = float(tr.get_score())
    out["retval"] = float(tr.get_retval())
    # `genjax_torch.utils.pretty()` installs _repr_html_ on every Pytree,
    # so notebooks render traces richly with no further setup.

    dbg = time_machine(pipeline)(torch.tensor(3.0, device=device))
    out["frames"] = [f.tag for f in dbg.frames]
    out["final"] = float(dbg.final)
    dbg.jump("doubled")
    out["at_doubled"] = float(dbg.frame.value)
    # Counterfactual: what if `doubled` had been 100? Replay the tail:
    alt = dbg.resume(torch.tensor(100.0, device=device))
    assert float(alt) == (100.0 + 10.0) ** 2
    out["counterfactual"] = float(alt)
    # And `remix` re-runs from scratch with new inputs, keeping your marks:
    dbg2 = dbg.remix(torch.tensor(5.0, device=device))
    assert float(dbg2.final) == (5.0 * 2 + 10.0) ** 2
    return out


if __name__ == "__main__":
    r = main()
    print("AddressReuse caught:", r["address_reuse"])
    print("MissingAddress caught:", r["missing_address"])
    print("silent unmask (checks off):", r["silent_unmask"])
    print("checkify says:", r["checkify"])
    print(r["trace"])
    print("frames:", r["frames"], " final:", r["final"])
    print("at 'doubled':", r["at_doubled"])
    print("counterfactual final:", r["counterfactual"])
    print("ok")
