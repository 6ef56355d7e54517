"""Cookbook 4 — Speed gains: assess → generate → edit → incremental edit.

Iterative algorithms (MH sweeps, SMC rejuvenation, annealing) revisit
the same model thousands of times with *small* changes. The GFI gives
you four tools, each asymptotically cheaper than the last on a model
with S sites:

| tool                      | work per one-site change |
|---------------------------|--------------------------|
| re-assess the whole map   | O(S) always              |
| generate from constraints | O(S) always              |
| edit, coarse handler      | O(changed site + everything after it) |
| edit, fine-grained (Diff) | O(changed site + true dependents)     |

The fine-grained path (``lang/static_edit.py``) tracks which values a
change reaches while the body runs, so a site is re-scored only if a
value actually feeding it changed. The JAX walkthrough counts the
equations of each traced program; eager PyTorch has no program to
count, so the port counts the sites each path re-scores
(``lang.static.edit_stats``): assess scores all S.
"""

import torch

import genjax_torch as g
from genjax_torch.core import random
from genjax_torch.examples import resolve_device
from genjax_torch.lang import static as static_mod

S = 30


@g.gen
def chain():
    x = g.normal(0.0, 1.0) @ "x0"
    for i in range(1, S):
        x = g.normal(x, 1.0) @ f"x{i}"
    return x


def rescored(fn) -> int:
    """The sites ``fn``'s edits re-score."""
    static_mod.edit_stats.reset()
    fn()
    return static_mod.edit_stats.sites_rescored


def main(device=None) -> dict:
    device = resolve_device(device)
    key = random.key(0, device=device)
    tr = chain.simulate(key, ())
    zero = torch.tensor(0.0, device=device)

    # One MH move = change ONE site. The naive way rebuilds everything:
    proposed = g.C[f"x{S // 2}"].set(zero) | tr.get_choices()
    naive_score, _ = chain.assess(proposed, ())       # O(S): re-scores all S

    # The edit way asks the trace to move — and returns the MH log-ratio
    # directly as the weight (no by-hand score subtraction):
    new_tr, w, _rd, _bwd = tr.edit(random.key(1, device=device),
                                   g.Update(g.C[f"x{S // 2}"].set(zero)))
    assert torch.allclose(new_tr.get_score(), naive_score, atol=1e-5)
    assert torch.allclose(w, new_tr.get_score() - tr.get_score(), atol=1e-5)

    # How much WORK did each approach do? Count the re-scored sites:
    def edit():
        tr.edit(random.key(1, device=device),
                g.Update(g.C[f"x{S // 2}"].set(zero)))

    static_mod.FINE_GRAINED_EDITS = False
    try:
        n_coarse = rescored(edit)
    finally:
        static_mod.FINE_GRAINED_EDITS = True
    n_fine = rescored(edit)
    # The coarse handler re-scores every site after the edit (~S/2
    # here); the fine path re-scores exactly two sites (the edited one
    # and its single dependent) no matter where in the chain it lands:
    assert n_fine < n_coarse < S

    # The same machinery powers Regenerate (MH-within-Gibbs); a whole
    # sweep is S edits:
    def mh_sweep(key, trace):
        total = 0.0
        for i in range(S):
            key, sub = random.split(key).unbind(-2)
            trace, w, _rd, _bwd = trace.edit(sub,
                                             g.Regenerate(g.S.at[f"x{i}"]))
            total = total + w
        return trace, total

    _, tot = mh_sweep(random.key(2, device=device), tr)
    # Where it really pays: wide sites. Each re-score is then real FLOPs,
    # and O(S) vs O(1) per move is the difference between a sweep that
    # scales quadratically and one that scales linearly with model size.
    return {"edit_weight": float(w), "assess_sites": S,
            "coarse_sites": n_coarse, "fine_sites": n_fine,
            "sweep_total": float(tot)}


if __name__ == "__main__":
    r = main()
    print("edit weight == Δscore:", r["edit_weight"])
    print(f"re-scored sites: assess={r['assess_sites']} "
          f"coarse_edit={r['coarse_sites']} fine_edit={r['fine_sites']}")
    print("one sweep, total log-ratio:", r["sweep_total"])
    print("ok")
