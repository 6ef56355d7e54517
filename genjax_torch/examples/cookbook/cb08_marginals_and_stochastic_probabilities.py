"""Cookbook 8 — Marginals and stochastic probabilities.

Most PPLs can only score what they can write in closed form. The GFI's
``Distribution`` contract is weaker — and more powerful: a distribution
must provide an *unbiased estimate* of its density, not the density
itself (Lew et al. 2023's "stochastic probabilities"; implementation
``inference/sp.py``). That means the MARGINAL of any generative function
— auxiliary randomness integrated out — is itself a first-class
distribution, usable at ``@ "addr"`` sites inside other models, with all
weight identities still exact *in expectation*.

This page marginalizes a mixture's component indicator and checks the
estimated density against the closed form. The 3000 estimates are one
call on a batch of 3000 keys.
"""

import math

import torch

import genjax_torch as g
from genjax_torch.core import random
from genjax_torch.examples import resolve_device
from genjax_torch.inference import ImportanceK, Target


# -- a two-component mixture, written generatively -----------------------
@g.gen
def mixture():
    hot = g.flip(0.3) @ "hot"
    mu = 4.0 * hot.to(torch.float32)
    return g.normal(mu, 1.0) @ "value"


# Marginalize the indicator: `value` alone, `hot` integrated out.
value_dist = mixture.marginal(selection=g.S.at["value"])


# -- use the marginal as a site in ANOTHER model -------------------------
# A sensor whose reading follows the mixture, indicator unobservable.
# The outer model never sees "hot" — scores of `reading` are stochastic
# density estimates, and importance weights remain unbiased. A
# marginal's *value* is a choice map over the selected addresses, so the
# site yields (and is constrained by) a nested map:
@g.gen
def outer(shift):
    r = value_dist() @ "reading"   # r is a ChoiceMap: {"value": ...}
    return r["value"] + shift


def main(device=None) -> dict:
    device = resolve_device(device)
    key = random.key(0, device=device)
    # estimate_logpdf returns an UNBIASED estimate of log p(value): each
    # call uses fresh auxiliary randomness. Averaging exp(·) converges to
    # the true density.
    v = torch.tensor(1.0, device=device)  # (v=2: zero-variance weights)
    keys = random.split(key, 3000)
    est = value_dist.estimate_logpdf(keys, g.C["value"].set(v))
    closed_form = math.log(
        0.7 * math.exp(float(g.normal.logpdf(torch.tensor(1.0), 0.0, 1.0)))
        + 0.3 * math.exp(float(g.normal.logpdf(torch.tensor(1.0), 4.0, 1.0))))
    avg = float(torch.logsumexp(est, 0) - math.log(len(est)))
    assert abs(avg - closed_form) < 5e-2

    # Sharper estimates: back the marginal with a K-particle algorithm
    # instead of single-draw importance (variance shrinks ~1/K):
    value_dist_k = mixture.marginal(
        selection=g.S.at["value"],
        algorithm=ImportanceK(Target(mixture, (), g.ChoiceMap.empty()),
                              k_particles=16))
    est_k = value_dist_k.estimate_logpdf(keys, g.C["value"].set(v))
    std1, std16 = float(torch.std(est, correction=0)), float(
        torch.std(est_k, correction=0))
    assert std16 < std1

    tr = outer.simulate(key, (1.0,))

    # Observe the reading (nested constraint — the marginal's value
    # space); the weight marginalizes `hot` automatically:
    obs = g.C["reading"].set(g.C["value"].set(v))
    _, ws = outer.generate(keys, obs, (1.0,))
    logz = float(torch.logsumexp(ws, 0) - math.log(len(ws)))
    # With only `reading` in the model, logZ IS the marginal density of v:
    assert abs(logz - closed_form) < 5e-2
    return {"estimated": avg, "closed_form": closed_form,
            "std_single": std1, "std_k16": std16,
            "outer_draw": float(tr.get_retval()),
            "outer_score": float(tr.get_score()), "outer_log_z": logz}


if __name__ == "__main__":
    r = main()
    print(f"log p(value=1): estimated {r['estimated']:.4f}, "
          f"closed form {r['closed_form']:.4f}")
    print(f"single-draw estimator std {r['std_single']:.3f} → "
          f"K=16 std {r['std_k16']:.3f}")
    print("outer draw:", r["outer_draw"],
          " score (density estimate):", r["outer_score"])
    print("logZ through the outer model:", r["outer_log_z"])
    print("ok")
