"""Cookbook 5 — Conditionals and masking: stochastic structure with
fixed shapes.

A batch of executions shares one set of shapes, so a program cannot add
or remove random choices per execution. The framework's answer:

- ``switch``: all branches exist; the index picks which one is *live*;
  dead branches score 0 and their choices are masked out. A Python-int
  index runs its one branch; a tensor index (one per execution) runs
  every branch over the batch and selects with ``torch.where``.
- ``mask`` / ``Mask``: a value plus a boolean flag. Flag-False choices
  contribute 0 to the score — "not there" without changing shapes.
- ``or_else``: boolean sugar over ``switch``.
- ``masked_iterate``: scan with a per-step validity flag —
  variable-length sequences at a static maximum length.

On the card this keeps a batch in lockstep: a switch lowers to
``torch.where`` (no host round-trip per execution), masks to selects,
and no kernel sees a shape that depends on the data.
"""

import math

import torch

import genjax_torch as g
from genjax_torch.core import random
from genjax_torch.examples import resolve_device


# -- switch: branch-structured models ------------------------------------
@g.gen
def null_model():
    return g.normal(0.0, 1.0) @ "effect"


@g.gen
def alt_model():
    return g.normal(3.0, 1.0) @ "effect"


sw = g.switch(null_model, alt_model)


# Model selection: put a prior ON the index and infer it.
@g.gen
def selector():
    use_alt = g.flip(0.5) @ "use_alt"
    return sw(use_alt.to(torch.int32), (), ()) @ "m"


# -- mask: optional observations -----------------------------------------
# A sensor that sometimes drops readings: the model always HAS the
# site, the flag says whether it counts.
@g.gen
def reading(x):
    return g.normal(x, 0.1) @ "y"


# -- masked_iterate: ragged sequences, static shapes ---------------------
@g.gen
def walk_step(x):
    return g.normal(x + 1.0, 1e-3) @ "x"


def main(device=None) -> dict:
    device = resolve_device(device)
    key = random.key(0, device=device)
    out = {}

    # Args: (branch index, branch-0 args, branch-1 args).
    tr = sw.simulate(key, (torch.tensor(1, device=device), (), ()))
    out["live_score"] = float(tr.get_score())
    # The choices of the dead branch exist but are masked; reading
    # through the trace gives you a Mask — check the flag before
    # trusting the value:
    v = tr.get_choices()["effect"]
    v = v.unmask() if isinstance(v, g.Mask) else v
    out["effect"] = float(v)

    obs = g.C["m", "effect"].set(torch.tensor(2.9, device=device))
    keys = random.split(key, 2048)
    trs, ws = selector.generate(keys, obs, ())
    post = torch.exp(ws - torch.logsumexp(ws, 0))
    p_alt = torch.sum(post * trs.get_choices()["use_alt"])
    out["p_alt"] = float(p_alt)
    assert p_alt > 0.9  # 2.9 is 2.9σ from branch 0's mean, 0.1σ from 1's

    # -- or_else ----------------------------------------------------------
    oe = alt_model.or_else(null_model)
    tr_t = oe.simulate(key, (True, (), ()))   # takes alt_model
    tr_f = oe.simulate(key, (False, (), ()))  # takes null_model
    out["or_else"] = [float(tr_t.get_retval()), float(tr_f.get_retval())]

    masked_reading = reading.mask()
    tr_on = masked_reading.simulate(key, (True, 1.0))
    tr_off = masked_reading.simulate(key, (False, 1.0))
    assert float(tr_off.get_score()) == 0.0  # dropped reading: no evidence
    assert float(tr_on.get_score()) != 0.0
    out["masked_scores"] = [float(tr_on.get_score()),
                            float(tr_off.get_score())]

    # Five time steps allocated, but only the flagged ones execute — the
    # standard trick for batching sequences of different lengths.
    mit = walk_step.masked_iterate_final()
    flags = torch.tensor([True, True, True, False, False], device=device)
    tr_seq = mit.simulate(key, (0.0, flags))   # a length-3 sequence
    out["live_steps_final"] = float(tr_seq.get_retval())
    assert math.isclose(out["live_steps_final"], 3.0, abs_tol=0.1)
    return out


if __name__ == "__main__":
    r = main()
    print("live branch score:", r["live_score"])
    print("effect:", r["effect"])
    print("P(alt | effect=2.9) ≈", r["p_alt"])
    print("or_else retvals:", *r["or_else"])
    print("masked scores:", *r["masked_scores"])
    print("3 live steps from 0.0 →", r["live_steps_final"])
    print("ok")
