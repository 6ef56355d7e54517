"""The port's main path, through the entry points a user would call:

- :func:`entry`: the ``@gen`` beta-bernoulli model -> ``Target`` ->
  ``ImportanceK`` SIR, returning the posterior mean and log Ẑ
  (counterpart of ``__graft_entry__.entry``);
- :func:`build_pf` / :func:`build_pf_fused`: the bootstrap particle
  filter of bench config 4, the nonlinear 1-D tracking model, through the
  general batched driver and the fused-kernel driver (counterpart of
  ``bench.build_pf`` / ``bench.build_pf_fused``);
- :func:`build_linear_fused`: the linear-Gaussian model of the fused
  filter's tests, whose exact log Z is the Kalman recurrence
  :func:`kalman_loglik`.

On a CUDA device the fused drivers take the models' Triton forms from
``genjax_torch/triton_models.py``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

import genjax_torch as g
from genjax_torch.core import random
from genjax_torch.inference import ImportanceK, Target
from genjax_torch.inference.pf import fused_particle_filter, particle_filter

__all__ = [
    "quickstart_model",
    "entry",
    "tracking_propagate",
    "tracking_loglik",
    "tracking_observations",
    "build_pf",
    "build_pf_fused",
    "linear_propagate",
    "linear_loglik",
    "linear_observations",
    "kalman_loglik",
    "build_linear_fused",
]


def quickstart_model():
    @g.gen
    def beta_bernoulli(a, b):
        p = g.beta(a, b) @ "p"
        v = g.flip(p) @ "v"
        return v

    return beta_bernoulli


def entry(k_particles: int = 64, device=None):
    """K-particle SIR on the quickstart model with ``v = True``: returns
    ``(sir_step, (key,))``; ``sir_step(key) -> (posterior mean of p,
    log Ẑ)``. Exact answers: 0.6 (Beta(3, 2)) and log 0.5."""
    beta_bernoulli = quickstart_model()

    def sir_step(key):
        target = Target(beta_bernoulli, (2.0, 2.0), g.C["v"].set(True))
        collection = ImportanceK(target, k_particles=k_particles).run_smc(key)
        weights = torch.softmax(collection.get_log_weights(), dim=0)
        ps = collection.get_particles().get_choices()["p"]
        post_mean = torch.sum(weights * ps)
        return post_mean, collection.get_log_marginal_likelihood_estimate()

    return sir_step, (random.key(0, device=device),)


#: The models' constants, shared with their Triton forms
#: (``triton_models.py``): the tracking model's process-noise sd and the
#: log-normalizer of its unit-variance likelihood.
TRACKING_SD = math.sqrt(10.0)
HALF_LOG_2PI = 0.5 * math.log(2 * math.pi)


def tracking_propagate(x, e):
    """Config-4 dynamics: ``0.5 x + 25 x / (1 + x^2) + sqrt(10) eps``."""
    return 0.5 * x + 25.0 * x / (1.0 + x * x) + TRACKING_SD * e


def tracking_loglik(x, y):
    """``log N(y; x^2 / 20, 1)``."""
    return -0.5 * (y - x * x / 20.0) ** 2 - HALF_LOG_2PI


def tracking_observations(n_steps: int, device=None) -> torch.Tensor:
    """The config-4 observations: ``5 · normal(key(9), (T,))``."""
    return random.normal(random.key(9, device=device), (n_steps,)) * 5.0


def _triton_forms(device, name: str):
    if torch.device(device).type != "cuda":
        return None, None
    from genjax_torch import triton_models

    return (getattr(triton_models, f"{name}_propagate"),
            getattr(triton_models, f"{name}_loglik"))


def build_pf(n_particles: int, n_steps: int, state_dtype=torch.float32,
             device=None):
    """Config 4 through the general batched filter: one key per step,
    whole-ensemble ops. Returns ``(run, work)``: ``run(key) -> log Z``,
    ``work`` the particle-steps of one run."""

    def init(key):
        return (random.normal(key, (n_particles,)).to(state_dtype),
                torch.zeros(n_particles, device=key.device))

    def step(key, xs, y):
        xf = xs.to(torch.float32)
        xs_new = tracking_propagate(xf, random.normal(key, (n_particles,)))
        mu = xs_new * xs_new / 20.0
        lw = (math.log(2 * math.pi) + (y - mu) ** 2) / -2.0
        return xs_new.to(state_dtype), lw

    pf = particle_filter(init, step, n_particles, batched=True)
    ys = tracking_observations(n_steps, device)

    def run(key):
        final, _ = pf(key, ys)
        return final.log_z

    return run, n_particles * n_steps


def build_pf_fused(n_particles: int, n_steps: int,
                   state_dtype=torch.float32, device=None):
    """Config 4 through the fused-kernel filter. Returns ``(run, work)``
    as :func:`build_pf`."""
    prop_t, ll_t = _triton_forms(device or "cpu", "tracking")
    pf = fused_particle_filter(
        lambda k: random.normal(k, (n_particles,)),
        tracking_propagate, tracking_loglik, n_particles,
        state_dtype=state_dtype, propagate_triton=prop_t, loglik_triton=ll_t,
    )
    ys = tracking_observations(n_steps, device)

    def run(key):
        final, _ = pf(key, ys)
        return final.log_z

    return run, n_particles * n_steps


LINEAR_A, LINEAR_Q, LINEAR_R = 0.9, 1.0, 0.3
LINEAR_HALF_LOG_2PI_R = 0.5 * math.log(2 * math.pi * LINEAR_R)


def linear_propagate(x, e):
    return LINEAR_A * x + math.sqrt(LINEAR_Q) * e


def linear_loglik(x, y):
    return -0.5 * (y - x) ** 2 / LINEAR_R - LINEAR_HALF_LOG_2PI_R


def linear_observations(n_steps: int = 15, seed: int = 0) -> np.ndarray:
    """Observations simulated from the linear-Gaussian model with numpy."""
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1)
    ys = []
    for _ in range(n_steps):
        ys.append(x + rng.normal(0, np.sqrt(LINEAR_R)))
        x = LINEAR_A * x + rng.normal(0, np.sqrt(LINEAR_Q))
    return np.asarray(ys, np.float32)


def kalman_loglik(ys, a=LINEAR_A, q=LINEAR_Q, r=LINEAR_R, mu0=0.0, p0=1.0):
    """Exact log-likelihood of the linear-Gaussian model (Kalman filter)."""
    ll, mu, p = 0.0, mu0, p0
    for y in np.asarray(ys, np.float64):
        s = p + r
        ll += -0.5 * (np.log(2 * np.pi * s) + (y - mu) ** 2 / s)
        k_gain = p / s
        mu = mu + k_gain * (y - mu)
        p = (1 - k_gain) * p
        mu, p = a * mu, a * a * p + q
    return float(ll)


def build_linear_fused(n_particles: int, ys, device=None):
    """The linear-Gaussian model through the fused filter, initialized at
    zero (so that ``x_0 ~ N(0, 1)`` after one step, the Kalman prior).
    Returns ``run(key) -> log Z``."""
    prop_t, ll_t = _triton_forms(device or "cpu", "linear")
    pf = fused_particle_filter(
        lambda k: torch.zeros(n_particles, device=k.device),
        linear_propagate, linear_loglik, n_particles,
        propagate_triton=prop_t, loglik_triton=ll_t,
    )
    obs = torch.as_tensor(np.asarray(ys, np.float32), device=device)

    def run(key):
        final, _ = pf(key, obs)
        return final.log_z

    return run
