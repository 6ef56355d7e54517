"""Parameter inference for state-space models: PMMH (pseudo-marginal
MCMC) and SMC² (sequential), both checked against exact Kalman-grid
quadrature.

PMMH runs one chain on one key: the marginal-likelihood estimate is a
512-particle bootstrap filter with ``batched=True`` (one key a step, the
whole ensemble drawn at once). SMC²'s model functions take the θ axis
leading every call: ``init_sampler(keys (N, 2), a (N,), n) -> (N, n)``
and so on."""

import math

import numpy as np
import torch

from genjax_torch.core import random
from genjax_torch.examples import resolve_device
from genjax_torch.inference import particle_filter, pmmh, smc2
from genjax_torch.models import lgssm_grid_posterior, simulate_lgssm_data

A_TRUE, Q, R, T = 0.7, 0.4, 0.4, 50
#: The documented sizes: PMMH iterations and filter particles; SMC²'s
#: θ-particles and state particles.
SIZES = {"pmmh_iters": 2000, "pmmh_particles": 512, "n_theta": 256,
         "n_x": 128}
#: A smaller run of the same program (the CPU tests' live run and the
#: card's smoke run, where the documented size takes minutes).
REHEARSAL = {"pmmh_iters": 20}
SQ = float(np.sqrt(np.float32(Q)))
SR = float(np.sqrt(np.float32(R)))
LOG_SQRT_2PI = 0.5 * math.log(2 * math.pi)


def _loglik(y, xs):
    return -0.5 * ((y - xs) / SR) ** 2 - math.log(SR) - LOG_SQRT_2PI


def main(device=None) -> dict:
    device = resolve_device(device)
    _, ys = simulate_lgssm_data(random.key(11, device=device), A_TRUE, Q, R,
                                T)
    mean, std, log_ev = lgssm_grid_posterior(
        ys, Q, R, torch.linspace(-0.949, 0.949, 191, device=device))
    out = {"exact_mean": float(mean), "exact_std": float(std),
           "exact_log_ev": float(log_ev)}

    # --- PMMH: random-walk MH over a, PF logZ as the likelihood -------
    n_pf = SIZES["pmmh_particles"]

    def log_marginal(key, a):
        def init(k):
            x = SQ * random.normal(k, (n_pf,))
            return x, _loglik(ys[0], x)

        def step(k, xs, y):
            xs = a * xs + SQ * random.normal(k, xs.shape)
            return xs, _loglik(y, xs)

        final, _ = particle_filter(init, step, n_pf, batched=True)(key,
                                                                  ys[1:])
        return final.log_z

    def log_prior(a):
        return torch.where(a.abs() < 0.95, torch.zeros_like(a),
                           torch.full_like(a, -math.inf))

    run = pmmh(log_marginal, log_prior, n_iters=SIZES["pmmh_iters"],
               proposal=0.08)
    res = run(random.key(0, device=device), torch.tensor(0.0, device=device))
    chain = res.thetas.cpu().numpy()[SIZES["pmmh_iters"] // 5:]
    out.update(pmmh_mean=float(chain.mean()), pmmh_std=float(chain.std()),
               pmmh_accept=float(res.accept_rate))

    # --- SMC²: sequential joint parameter+state inference --------------
    run2 = smc2(
        lambda keys, a, n: SQ * random.normal(keys, (n,)),
        lambda keys, a, xs: a[:, None] * xs
        + SQ * random.normal(keys, xs.shape[1:]),
        lambda a, xs, y: _loglik(y, xs),
        lambda keys: random.uniform(keys, (), minval=-0.95, maxval=0.95),
        lambda a: torch.where(a.abs() < 0.95,
                              torch.full_like(a, -math.log(1.9)),
                              torch.full_like(a, -math.inf)),
        n_theta=SIZES["n_theta"], n_x=SIZES["n_x"], proposal=0.15,
    )
    r2 = run2(random.key(1, device=device), ys)
    lw = r2.log_weights.double().cpu().numpy()
    w = np.exp(lw - lw.max())
    w /= w.sum()
    th = r2.thetas.double().cpu().numpy()
    out.update(smc2_mean=float((th * w).sum()), smc2_log_z=float(r2.log_z),
               smc2_accept=float(r2.rejuv_accept))
    return out


if __name__ == "__main__":
    r = main()
    print(f"exact posterior over a: mean {r['exact_mean']:.3f} "
          f"std {r['exact_std']:.3f}; log evidence {r['exact_log_ev']:.2f}")
    print(f"PMMH: mean {r['pmmh_mean']:.3f} std {r['pmmh_std']:.3f} "
          f"(accept {r['pmmh_accept']:.2f})")
    print(f"SMC2: mean {r['smc2_mean']:.3f}; log evidence "
          f"{r['smc2_log_z']:.2f} (rejuvenation accept "
          f"{r['smc2_accept']:.2f})")
