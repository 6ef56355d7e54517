"""Constrained-support NUTS with automatic transforms.

``run_nuts(transforms="auto")`` reads the support metadata of each
distribution in the model (``"positive"``, ``(low, high)``,
``"simplex"``) and runs NUTS in unconstrained space with the
change-of-variables correction — no manual log-/logit-reparameterization
needed. Works for latents nested in sub-``@gen`` functions and inside
``Scan`` (the step index stays transparent in the transform path).

The one-site count likelihood is an ``exact_density`` of a vector value
(``event_rank=1``): its log-density sums over the simplex's last axis,
behind the chain batch."""

import numpy as np
import torch

import genjax_torch as g
from genjax_torch.core import random
from genjax_torch.examples import resolve_device
from genjax_torch.inference import Target, run_nuts
from genjax_torch.inference.transforms import infer_transforms

ALPHA = (1.0, 2.0, 3.0)
COUNTS = (10.0, 5.0, 5.0)
T = 4
#: The documented sizes: (chains, warmup, samples) of the two runs.
SIZES = {"dirichlet": (2, 300, 400), "scan": (2, 200, 200)}
#: A smaller run of the same program (the CPU tests' live run and the
#: card's smoke run, where the documented size takes minutes).
REHEARSAL = {"dirichlet": (2, 20, 20), "scan": (2, 10, 10)}


def _counts_logpdf(v, p):
    return (torch.tensor(COUNTS, device=p.device) * torch.log(p)).sum(-1)


# The categorical count likelihood as a one-site exact density.
counts_lik = g.exact_density(lambda key, p: p, _counts_logpdf,
                             "counts_lik", event_rank=1)


@g.gen
def dirichlet_model():
    alpha = torch.tensor(ALPHA)
    p = g.dirichlet(alpha) @ "p"          # support: "simplex"
    _ = counts_lik(p) @ "obs"


@g.gen
def step(carry, _):
    s = g.half_normal(1.0) @ "s"          # support: "positive", per step
    _ = g.normal(0.0, s + 0.1) @ "y"
    return carry, None


@g.gen
def vol_model():
    _ = step.scan(n=T)(0.0, None) @ "chain"


def main(device=None) -> dict:
    device = resolve_device(device)
    probe = dirichlet_model.simulate(random.key(0, device=device), ())
    out = {"transforms": {k: str(v) for k, v in
                          infer_transforms(probe).items()}}

    target = Target(dirichlet_model, (),
                    g.C["obs"].set(torch.zeros(3, device=device)))
    chains, warmup, samples = SIZES["dirichlet"]
    chms, _ = run_nuts(target, random.key(1, device=device), n_chains=chains,
                       num_warmup=warmup, num_samples=samples, max_depth=6,
                       transforms="auto")
    ps = chms["p"].cpu().numpy()            # (chains, samples, 3) on Δ²
    post = np.asarray(ALPHA) + np.asarray(COUNTS)
    post = post / post.sum()
    out["posterior_mean"] = ps.mean(axis=(0, 1)).tolist()
    out["exact"] = post.tolist()
    assert np.allclose(ps.sum(axis=-1), 1.0, atol=1e-5)
    assert np.max(np.abs(ps.mean(axis=(0, 1)) - post)) < 0.05

    # -- positive scale inside a Scan --------------------------------------
    obs = g.ChoiceMap.empty()
    for t in range(T):
        obs = obs | g.C["chain", t, "y"].set(torch.tensor(1.0, device=device))
    chains, warmup, samples = SIZES["scan"]
    chms2, _ = run_nuts(Target(vol_model, (), obs),
                        random.key(2, device=device), n_chains=chains,
                        num_warmup=warmup, num_samples=samples, max_depth=6,
                        transforms="auto")
    scales = torch.stack([chms2["chain", t, "s"] for t in range(T)])
    out["scan_scales_min"] = float(scales.min())
    assert bool((scales > 0.0).all())
    return out


if __name__ == "__main__":
    r = main()
    print("inferred transforms:", r["transforms"])
    print("posterior mean:", np.asarray(r["posterior_mean"]))
    print("exact (conjugate):", np.asarray(r["exact"]))
    print("scan scales min:", r["scan_scales_min"], "(all positive)")
