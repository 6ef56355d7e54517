"""Cookbook 14 — SMC²: sequential joint parameter + state inference.

When a state-space model has unknown PARAMETERS as well as latent
STATES, neither a particle filter (states only) nor MCMC on the
marginal (needs the likelihood, which is itself intractable) suffices
alone. SMC² (``inference/smc2.py``) runs an ensemble of θ-particles,
each carrying its own inner bootstrap filter: the filters' incremental
evidence estimates are exact pseudo-marginal θ-weights, and θ-ensemble
degeneracy triggers a PMMH rejuvenation (a fresh O(t) inner-filter
re-run per proposal, so the move is an exact MH kernel).

Details worth knowing in the port:

- the (N_θ, N_x) state grid resamples every row at once
  (``smc.resample_values_rows``: the rows' f32 cumulative counts, a
  ``searchsorted`` and a gather); ``inner_impl="auto"`` keeps the sort
  path on the CPU.
- the PMMH re-run runs only when the θ-ESS falls under the threshold
  (one host read of the ESS a step): a rejuvenation at time t costs t
  inner steps, not T.
- replicate whole SMC² runs with separate calls, or shard the θ-axis
  over ranks (``parallel.sharded_smc2``).

Here: a 1-D linear-Gaussian SSM with unknown transition coefficient a,
where the Kalman filter gives p(y | a) exactly — so both the parameter
posterior and the evidence have grid-quadrature oracles to check
against. The model functions take the θ axis leading every call.
"""

import math

import numpy as np
import torch

from genjax_torch.core import random
from genjax_torch.examples import resolve_device
from genjax_torch.inference.smc2 import smc2
from genjax_torch.models.ssm import lgssm_grid_posterior, simulate_lgssm_data

A_TRUE, Q, R, T = 0.7, 0.4, 0.4, 40
SQ = float(np.sqrt(np.float32(Q)))
SR = float(np.sqrt(np.float32(R)))
LOG_SQRT_2PI = 0.5 * math.log(2 * math.pi)


def main(device=None) -> dict:
    device = resolve_device(device)
    key = random.key(7, device=device)
    _, ys = simulate_lgssm_data(random.key(11, device=device), A_TRUE, Q, R,
                                T)
    run = smc2(
        init_sampler=lambda keys, a, n: SQ * random.normal(keys, (n,)),
        propagate=lambda keys, a, xs: a[:, None] * xs
        + SQ * random.normal(keys, xs.shape[1:]),
        loglik=lambda a, xs, y: -0.5 * ((y - xs) / SR) ** 2 - math.log(SR)
        - LOG_SQRT_2PI,
        prior_sample=lambda keys: random.uniform(keys, (), minval=-0.95,
                                                 maxval=0.95),
        log_prior=lambda a: torch.where(a.abs() < 0.95,
                                        torch.full_like(a, -math.log(1.9)),
                                        torch.full_like(a, -math.inf)),
        n_theta=256,
        n_x=128,
        proposal=0.15,  # gaussian-walk PMMH proposal std
    )
    res = run(key, ys)

    # --- Check against the exact Kalman-grid quadrature ------------------
    mean, std, log_ev = lgssm_grid_posterior(
        ys, Q, R, torch.linspace(-0.949, 0.949, 191, device=device))
    lw = res.log_weights.double().cpu().numpy()
    w = np.exp(lw - lw.max())
    w /= w.sum()
    th = res.thetas.double().cpu().numpy()
    got_mean = float((th * w).sum())
    got_std = float(np.sqrt(((th - got_mean) ** 2 * w).sum()))
    assert abs(got_mean - float(mean)) < 0.08
    assert abs(float(res.log_z) - float(log_ev)) < 1.0
    # The theta-ESS history shows the degeneracy/rejuvenation cycle: ESS
    # decays as observations sharpen the posterior, and each
    # rejuvenation (resample to uniform weights) resets it to N_theta.
    ess = res.ess_history.cpu().numpy()
    assert ess.min() < 256  # degeneracy really happened (and was handled)
    return {"mean": got_mean, "exact_mean": float(mean), "std": got_std,
            "exact_std": float(std), "log_z": float(res.log_z),
            "exact_log_ev": float(log_ev),
            "rejuv_accept": float(res.rejuv_accept),
            "ess_start": float(ess[0]), "ess_min": float(ess.min()),
            "ess_final": float(ess[-1])}


if __name__ == "__main__":
    r = main()
    print(f"posterior  E[a | y]  = {r['mean']:.3f}   "
          f"(exact {r['exact_mean']:.3f})")
    print(f"posterior sd[a | y]  = {r['std']:.3f}   "
          f"(exact {r['exact_std']:.3f})")
    print(f"evidence   log p(y)  = {r['log_z']:.2f}  "
          f"(exact {r['exact_log_ev']:.2f})")
    print(f"PMMH acceptance over fired rejuvenations: "
          f"{r['rejuv_accept']:.2f}")
    print(f"theta-ESS: start {r['ess_start']:.0f}, min {r['ess_min']:.0f}, "
          f"final {r['ess_final']:.0f} of {256}")
