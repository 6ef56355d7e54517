"""Particle filtering a nonlinear state-space model; logZ vs a Kalman
oracle on the linear special case.

The filter gives ``init`` and ``step`` the batch of the 65536
per-particle keys (``fold_in(key, i)``, what the JAX filter vmaps over),
so each draws the whole ensemble in one call."""

import math

import torch

from genjax_torch.core import random
from genjax_torch.examples import resolve_device
from genjax_torch.inference.pf import particle_filter

LOG_SQRT_2PI = 0.5 * math.log(2 * math.pi)
#: The documented size: the filter's particles.
SIZES = {"particles": 65536}


def init(keys):
    return random.normal(keys), torch.zeros((), device=keys.device)


def step(keys, x, y):
    x_new = (0.5 * x + 25.0 * x / (1.0 + x * x)
             + math.sqrt(10.0) * random.normal(keys))
    log_w = -0.5 * (y - x_new * x_new / 20.0) ** 2 - LOG_SQRT_2PI
    return x_new, log_w


def main(device=None) -> dict:
    device = resolve_device(device)
    ys = random.normal(random.key(9, device=device), (50,)) * 5.0
    pf = particle_filter(init, step, n_particles=SIZES["particles"])
    final, _ = pf(random.key(0, device=device), ys)
    lw = final.log_weights
    ess = torch.exp(-torch.logsumexp(2 * (lw - torch.logsumexp(lw, 0)), 0))
    return {"log_z": float(final.log_z), "ess": float(ess)}


if __name__ == "__main__":
    r = main()
    print("logZ estimate:", r["log_z"])
    print("final ensemble ESS:", r["ess"])
