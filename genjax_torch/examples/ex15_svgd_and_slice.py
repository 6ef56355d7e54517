"""Example 15 — SVGD ensembles and elliptical slice sampling.

Two inference families beyond the reference (``inference/svgd.py``,
``inference/requests/ess.py``), on the same hierarchical model,
cross-checked against each other and NUTS:

- **SVGD** fits a deterministic particle ensemble by kernelized Stein
  descent — every update is a dense (N, N) product, no accept/reject,
  no step-size adaptation.
- **Elliptical slice sampling** moves Gaussian-prior latents with zero
  tuning — the ellipse is drawn from the model's own prior via the GFI
  (``generate`` on the complement), and the likelihood factor is
  ``score − trace.project(selection)``.

The model's design matrix is an argument, lifted by the inference entry
points to a zero-stride batch view; ``X @ w`` is a batched
matrix-vector product.
"""

import numpy as np
import torch

import genjax_torch as g
from genjax_torch.core import random
from genjax_torch.examples import resolve_device
from genjax_torch.inference import (
    EllipticalSlice,
    Target,
    mh,
    run_nuts,
    run_svgd,
)

D = 8
#: The documented sizes: SVGD particles and steps; elliptical-slice
#: moves and the burn-in dropped; NUTS chains, warmup and samples.
SIZES = {"svgd_particles": 256, "svgd_steps": 400, "ess_moves": 2000,
         "ess_burn": 500, "nuts_chains": 8, "nuts_warmup": 100,
         "nuts_samples": 150}
#: A smaller run of the same program (the CPU tests' live run and the
#: card's smoke run, where the documented size takes minutes).
REHEARSAL = {"svgd_steps": 100, "ess_moves": 150, "ess_burn": 50,
             "nuts_warmup": 20, "nuts_samples": 20}


@g.gen
def blr(X):
    w = g.mv_normal_diag(torch.zeros(D, device=X.device),
                         torch.ones(D, device=X.device)) @ "w"
    _ = g.mv_normal_diag((X @ w[..., None])[..., 0],
                         0.1 * torch.ones(X.shape[-2], device=X.device)) @ "y"


def problem(device):
    """A small Gaussian-prior regression: weights w ~ N(0, I)
    (conditionally Gaussian, so ESS applies exactly), observed through a
    linear map; its exact posterior mean (precision I + XᵀX / 0.01)."""
    key = random.key(15, device=device)
    X = random.normal(random.fold_in(key, 0), (40, D)) / np.sqrt(
        np.float32(D))
    w_true = torch.linspace(-1.0, 1.0, D, device=device)
    y_obs = X @ w_true + 0.1 * random.normal(random.fold_in(key, 1), (40,))
    target = Target(blr, (X,), g.C["y"].set(y_obs))
    Xd, yd = X.double(), y_obs.double()
    prec = torch.eye(D, dtype=torch.float64, device=device) + Xd.T @ Xd / 0.01
    post_mean = torch.linalg.solve(prec, Xd.T @ yd / 0.01)
    return key, target, post_mean.cpu().numpy()


def main(device=None) -> dict:
    device = resolve_device(device)
    key, target, post_mean = problem(device)

    # --- SVGD: one fit, the ensemble approximates the posterior. --------
    ens = run_svgd(target, random.fold_in(key, 2),
                   n_particles=SIZES["svgd_particles"],
                   n_steps=SIZES["svgd_steps"], step_size=0.05)
    svgd_mean = ens["w"].double().mean(0).cpu().numpy()

    # --- Elliptical slice: tuning-free MCMC on the same latents. --------
    req = EllipticalSlice(g.Selection.at["w"])
    tr, _ = target.importance(random.fold_in(key, 3), g.ChoiceMap.empty())
    ws = []
    for k in random.split(random.fold_in(key, 4), SIZES["ess_moves"]):
        tr, _ = mh(k, tr, req)
        ws.append(tr.get_choices()["w"])
    ess_mean = torch.stack(ws[SIZES["ess_burn"]:]).double().mean(0)\
        .cpu().numpy()

    # --- NUTS reference on the same target. -----------------------------
    chms, _ = run_nuts(target, random.fold_in(key, 5),
                       n_chains=SIZES["nuts_chains"],
                       num_warmup=SIZES["nuts_warmup"],
                       num_samples=SIZES["nuts_samples"], max_depth=6)
    nuts_mean = chms["w"].double().mean((0, 1)).cpu().numpy()

    out = {"svgd_err": float(np.abs(svgd_mean - post_mean).max()),
           "ess_err": float(np.abs(ess_mean - post_mean).max()),
           "nuts_err": float(np.abs(nuts_mean - post_mean).max())}
    for name in ("svgd", "ess", "nuts"):
        assert out[f"{name}_err"] < 0.15, name
    return out


if __name__ == "__main__":
    r = main()
    print("SVGD  mean err:", r["svgd_err"])
    print("ESS   mean err:", r["ess_err"])
    print("NUTS  mean err:", r["nuts_err"])
    print("all three agree with the exact conjugate posterior")
