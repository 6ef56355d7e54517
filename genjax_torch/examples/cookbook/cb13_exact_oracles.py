"""Cookbook 13 — Testing approximate inference against exact oracles.

When a model is small enough to solve exactly, solve it exactly and use
the result as the ORACLE for whatever approximate algorithm you care
about. Three oracles ship in the library:

1. ``enumerate_posterior`` — ANY finite discrete model: one batched
   ``assess`` over the full support grid (``inference/enumerative.py``).
2. ``DiscreteHMM`` forward-filter backward-sample — exact state-space
   posteriors and data marginals (``lang/distributions/discrete_hmm.py``).
3. Conjugate closed forms — Gaussian/beta families by hand.

Here: a burglary-style boolean network, solved exactly, then attacked
with self-normalized importance sampling AND Metropolis–Hastings, each
validated against the enumerated truth. The 32 MH chains are one key
batch.
"""

import torch

import genjax_torch as g
from genjax_torch.core import random
from genjax_torch.examples import resolve_device
from genjax_torch.gfi.requests import Regenerate
from genjax_torch.inference import (
    ImportanceK,
    Target,
    enumerate_posterior,
    mh,
)

#: The documented sizes: SIR particles; MH chains, steps and burn-in.
SIZES = {"particles": 4096, "chains": 32, "steps": 3000, "burn": 500}


# --- The model: a tiny diagnostic network. ---------------------------------
@g.gen
def alarm_net():
    burglary = g.flip(0.01) @ "burglary"
    quake = g.flip(0.02) @ "quake"
    p_alarm = torch.where(
        burglary & quake, 0.95,
        torch.where(burglary, 0.94, torch.where(quake, 0.29, 0.001)))
    alarm = g.flip(p_alarm) @ "alarm"
    _ = g.flip(torch.where(alarm, 0.9, 0.05)) @ "john_calls"
    _ = g.flip(torch.where(alarm, 0.7, 0.01)) @ "mary_calls"


def main(device=None) -> dict:
    device = resolve_device(device)
    key = random.key(13, device=device)
    yes = torch.tensor(True, device=device)
    observed = g.C["john_calls"].set(yes) | g.C["mary_calls"].set(yes)
    target = Target(alarm_net, (), observed)

    # --- 1. The exact answer: 8 latent states, one batched assess. ------
    exact = enumerate_posterior(target)
    sup_b, marg_b = exact.site_marginal("burglary")
    p_burglary = float(marg_b[sup_b.cpu().tolist().index(True)])
    # (The 10x priors here keep the prior-proposal MH below well-mixed.)
    assert 0.5 < p_burglary < 0.6

    # --- 2. Importance sampling, validated against the oracle. ----------
    alg = ImportanceK(target, k_particles=SIZES["particles"])
    lz_est = float(alg.run_smc(key).get_log_marginal_likelihood_estimate())
    assert abs(lz_est - float(exact.log_marginal)) < 0.1

    # --- 3. MH over the latents, validated against the oracle. ----------
    # Prior-proposal Regenerate flips 'burglary' only ~1% of proposals,
    # so one chain mixes slowly — run 32 chains as one key batch.
    latents = (g.Selection.at["burglary"] | g.Selection.at["quake"]
               | g.Selection.at["alarm"])
    req = Regenerate(latents)
    cks = random.fold_in(random.fold_in(key, 1),
                         torch.arange(SIZES["chains"], device=device))
    tr, _ = target.importance(cks, g.ChoiceMap.empty())
    step_keys = random.split(cks, SIZES["steps"])
    draws = []
    for t in range(SIZES["steps"]):
        tr, _ = mh(step_keys[:, t], tr, req)
        draws.append(tr.get_choices()["burglary"])
    mh_est = float(torch.stack(draws[SIZES["burn"]:], 1).float().mean())
    assert abs(mh_est - p_burglary) < 0.05
    return {"p_burglary": p_burglary,
            "log_marginal": float(exact.log_marginal),
            "sir_log_z": lz_est, "mh_p_burglary": mh_est}


if __name__ == "__main__":
    r = main()
    print(f"exact   P(burglary | both call) = {r['p_burglary']:.4f}")
    print(f"exact   log P(both call)        = {r['log_marginal']:.4f}")
    print(f"SIR     log-evidence estimate   = {r['sir_log_z']:.4f}")
    print(f"MH      P(burglary | both call) = {r['mh_p_burglary']:.4f}")
    print("both approximations agree with the enumerated exact posterior")
