"""Cookbook 10 — Nested approximate marginalization (RAVI stacks).

How to be *recursively wrong everywhere yet correct at the end*: every
density in this file is only ever ESTIMATED — the model marginalizes an
auxiliary variable, the proposal marginalizes its own auxiliary
variable, and importance sampling runs with estimates on both sides of
the weight. Proper weighting (Lew et al. 2023) guarantees the final
log-Z estimate is still unbiased, and we check that against a closed
form.

The stack, bottom to top:

1. ``mixture_xy`` — 3-component 2-D Gaussian mixture; the component
   index is marginalized out (``.marginal()``), giving a chm-valued
   distribution over {"x","y"} whose density is only estimable.
2. ``model`` — uses that marginal AS A SITE ("pt") and observes a
   function of it. The target's latent is the nested choice map at
   "pt".
3. ``guess`` — a data-driven proposal that picks its own auxiliary
   cluster guess from the observation, proposes near that cluster, and
   marginalizes the guess out so its traces match the model's address
   space.

The 1500 estimates of each proposal are one ``run_smc`` on a batch of
1500 keys.
"""

import math

import torch

import genjax_torch as g
from genjax_torch.core import random
from genjax_torch.examples import resolve_device
from genjax_torch.inference import ImportanceK, Target

# Cluster 1 far away; clusters 2a/2b close together.
PROBS = (0.4, 0.3, 0.3)
MUX = (-6.0, 3.0, 4.0)
MUY = (-6.0, 3.5, 4.5)
OBS = 6.9  # near cluster 2's x+y ≈ 7..9


@g.gen
def mixture_xy():
    logits = torch.log(torch.tensor(PROBS))
    idx = g.categorical(logits) @ "idx"
    x = g.normal(torch.tensor(MUX, device=idx.device)[idx], 1.0) @ "x"
    y = g.normal(torch.tensor(MUY, device=idx.device)[idx], 1.0) @ "y"
    return x + y


# Level 1: marginalize the component index. `point` is a chm-valued
# SampleDistribution over {"x","y"} — its density can only be estimated
# (here by the default 1-particle importance).
point = mixture_xy.marginal(selection=g.S.at["x"] | g.S.at["y"])


# Level 2: the marginal as a site, with a downstream observation.
@g.gen
def model():
    pt = point() @ "pt"
    _ = g.normal(pt["x"] + pt["y"], 0.5) @ "obs"


# Level 3: a data-driven proposal with ITS OWN auxiliary variable — a
# hard cluster guess from the observation — marginalized out so the
# proposed trace only contains the model's latent address "pt".
@g.gen
def guess_pt(cx, cy):
    # The nested shape of the model's marginal site: a chm {"x","y"}.
    x = g.normal(cx, 1.2) @ "x"
    y = g.normal(cy, 1.2) @ "y"
    return x + y


@g.gen
def guess_aux(target: Target):
    obs = target["obs"]
    # Data-driven logic: far-away cluster 1 has x+y ≈ -12.
    p_far = torch.sigmoid(-(obs + 2.0))
    far = g.flip(p_far) @ "cluster_idx"
    cx = torch.where(far, MUX[0], 0.5 * (MUX[1] + MUX[2]))
    cy = torch.where(far, MUY[0], 0.5 * (MUY[1] + MUY[2]))
    return guess_pt(cx, cy) @ "pt"


# Marginalize the guess: traces now match the model's address space.
guess = guess_aux.marginal(selection=g.S.at["pt"])


def main(device=None) -> dict:
    device = resolve_device(device)
    key = random.key(0, device=device)
    target = Target(model, (), g.C["obs"].set(torch.tensor(OBS,
                                                           device=device)))
    # Closed-form oracle: x+y | idx=k ~ N(MUX_k + MUY_k, sqrt(2)), so
    # obs ~ Σ_k w_k · N(MUX_k + MUY_k, sqrt(2 + 0.25)).
    w = torch.softmax(torch.log(torch.tensor(PROBS, dtype=torch.float64)), 0)
    means = torch.tensor(MUX, dtype=torch.float64) + torch.tensor(
        MUY, dtype=torch.float64)
    exact_logz = float(torch.logsumexp(torch.log(w) + g.normal.logpdf(
        torch.tensor(OBS, dtype=torch.float64), means, math.sqrt(2.25)), 0))

    def logz_samples(q, n=1500, k_particles=4):
        alg = ImportanceK(target, q=q, k_particles=k_particles)
        return alg.run_smc(random.split(key, n))\
            .get_log_marginal_likelihood_estimate()

    lz = {"prior": logz_samples(None), "ravi": logz_samples(guess)}
    # Unbiasedness at the top of the stack, despite estimated densities
    # at every level below: E[exp(logẐ)] = Z for both proposals.
    out = {"exact": exact_logz}
    for name, v in lz.items():
        log_mean = float(torch.logsumexp(v, 0) - math.log(v.shape[0]))
        out[f"{name}_log_mean"] = log_mean
        assert abs(log_mean - exact_logz) < 0.12, (name, log_mean, exact_logz)
    # The data-driven stack concentrates its weights: lower variance of
    # the log-Z samples than the prior proposal.
    out["var_prior"] = float(torch.var(lz["prior"], correction=0))
    out["var_ravi"] = float(torch.var(lz["ravi"], correction=0))
    assert out["var_ravi"] < out["var_prior"]
    return out


if __name__ == "__main__":
    r = main()
    print("cookbook 10 ok:", f"exact={r['exact']:.3f}",
          f"var prior={r['var_prior']:.3f} ravi={r['var_ravi']:.3f}")
