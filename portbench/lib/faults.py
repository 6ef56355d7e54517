"""Faults planted underneath the timed path, to show that the judge
finds them (``control.py --faults``, on the card at a cell's own size,
and ``tests/test_portbench_run.py`` on the CPU). Never used by a run of
the benchmark. Each plants itself in the port's modules and returns its
undo; the same fault is planted on each path the cells drive:

- ``state``: a step that returns its ensemble unchanged (the fused step
  gives back the states and weights it took; the general driver's step
  the states);
- ``half``: half of the ensemble left out, the mean taken over the
  rest (every log-sum-exp of the weights over the first half, plus
  log 2);
- ``altered``: an answer altered where it is produced (each step's
  log-sum-exp of the weights, and so log Z, 0.05 too high).

The single chip of every cell leaves no exchange between chips to leave
out. The faults reach the port's private names, as a fault inside it
would; the benchmark's runs read none of them.
"""

from __future__ import annotations

import importlib
import math

import torch

from portbench.lib import plugins

FAULTS = ("state", "half", "altered")


def plant(fault: str):
    pf = importlib.import_module("genjax_torch.inference.pf")
    hmm = importlib.import_module("genjax_torch.models.hmm")
    undo = []
    fused_step, pfilter = pf.fused_step, pf.particle_filter
    lse, lse_ess = pf._lse, pf._lse_ess

    if fault == "state":
        def fused_same(key, xs, lw, *a, **k):
            _, _, _, ess = fused_step(key, xs, lw, *a, **k)
            return xs, lw, torch.logsumexp(lw, 0), ess

        def filter_same(init, step, *a, **k):
            def same(key, xs, obs):
                _, incr = step(key, xs, obs)
                return xs, incr
            return pfilter(init, same, *a, **k)

        undo += [plugins.patch(pf, "fused_step", fused_same),
                 plugins.patch(pf, "particle_filter", filter_same),
                 plugins.patch(hmm, "particle_filter", filter_same)]
    elif fault == "half":
        def half(lw):
            return (torch.logsumexp(lw[: lw.shape[0] // 2], 0)
                    + math.log(2.0))

        def fused_half(*a, **k):
            xs, lw, _, ess = fused_step(*a, **k)
            return xs, lw, half(lw), ess

        undo += [plugins.patch(pf, "fused_step", fused_half),
                 plugins.patch(pf, "_lse", half),
                 plugins.patch(pf, "_lse_ess",
                               lambda lw: (half(lw), lse_ess(lw)[1]))]
    elif fault == "altered":
        def fused_altered(*a, **k):
            xs, lw, s, ess = fused_step(*a, **k)
            return xs, lw, s + 0.05, ess

        undo += [plugins.patch(pf, "fused_step", fused_altered),
                 plugins.patch(pf, "_lse", lambda lw: lse(lw) + 0.05),
                 plugins.patch(pf, "_lse_ess",
                               lambda lw: (lse_ess(lw)[0] + 0.05,
                                           lse_ess(lw)[1]))]
    else:
        raise ValueError(f"no fault {fault!r}; there are {FAULTS}")

    def undo_all():
        for u in reversed(undo):
            u()
    return undo_all
