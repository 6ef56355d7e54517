"""State-space model families: the 1-D linear-Gaussian model with its
exact Kalman oracles, and the nonlinear tracking benchmark (counterpart
of ``genjax_tpu/models/ssm.py``).

``lax.scan`` becomes a Python loop; the oracles compute in the dtype of
their observations, so a float64 ``ys`` gives a float64 answer.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from genjax_torch.core import random
from genjax_torch.lang.distributions import normal
from genjax_torch.lang.static import gen

__all__ = ["lgssm_model", "kalman_filter", "kalman_smoother",
           "simulate_lgssm_data", "lgssm_grid_posterior",
           "nonlinear_tracking_model"]


def _f32_sqrt(v) -> float:
    """``sqrt`` of a Python number in f32, as ``jnp.sqrt`` gives it."""
    return float(np.sqrt(np.float32(v)))


def simulate_lgssm_data(key, a, q, r, n_steps, mu0=0.0):
    """``(xs, ys)`` from the 1-D LGSSM ``x_t = a·x_{t-1} + N(0, q)``,
    ``y_t = x_t + N(0, r)`` with ``x_0 = mu0``; its exact marginal
    likelihood is :func:`kalman_filter` with ``p0=0``."""
    kx, ky = random.split(key).unbind(-2)
    ex = _f32_sqrt(q) * random.normal(kx, (n_steps,))
    ey = _f32_sqrt(r) * random.normal(ky, (n_steps,))
    x = torch.as_tensor(mu0, dtype=torch.float32, device=key.device)
    xs = []
    for t in range(n_steps):
        x = a * x + ex[t]
        xs.append(x)
    xs = torch.stack(xs) if xs else ex
    return xs, xs + ey


def lgssm_grid_posterior(ys, q, r, grid, log_prior_density=None):
    """The exact quadrature posterior over the transition coefficient of
    the LGSSM above: ``(mean, std, log_evidence)``. Each grid point's
    marginal likelihood is :func:`kalman_filter` (``mu0=0, p0=0``);
    ``log_prior_density``, a function of ``a``, defaults to uniform over
    the grid's span."""
    grid = torch.as_tensor(grid, dtype=torch.as_tensor(ys).dtype)
    lls, _ = kalman_filter(ys, grid, q, r, mu0=0.0, p0=0.0)
    span = grid[-1] - grid[0]
    lp = (-torch.log(span) * torch.ones_like(grid)
          if log_prior_density is None
          else torch.stack([torch.as_tensor(log_prior_density(a))
                            for a in grid]).to(grid))
    post = lls + lp
    w = torch.exp(post - post.max())
    w = w / w.sum()
    mean = (grid * w).sum()
    std = torch.sqrt(((grid - mean) ** 2 * w).sum())
    log_ev = torch.logsumexp(post, dim=0) + torch.log(grid[1] - grid[0])
    return mean, std, log_ev


def lgssm_model(a: float, q: float, r: float, n_steps: int):
    """The 1-D linear-Gaussian SSM as a scanned generative function:
    ``x_t = a·x_{t-1} + N(0, q)``, ``y_t = x_t + N(0, r)``; latents at
    ``(t, "x")``, observations at ``(t, "y")``."""
    sq, sr = _f32_sqrt(q), _f32_sqrt(r)

    @gen
    def step(carry, _):
        x = normal(a * carry, sq) @ "x"
        _ = normal(x, sr) @ "y"
        return x, x

    return step.scan(n=n_steps)


def _as(v, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(v, dtype=like.dtype, device=like.device)


def kalman_filter(ys, a, q, r, mu0=0.0, p0=1.0):
    """The exact log-likelihood and filtered means of the 1-D LGSSM whose
    first latent is ``x_1 ~ N(a·mu0, a²·p0 + q)``. ``a`` may be a tensor
    of coefficients: the filter runs for each."""
    ys = torch.as_tensor(ys)
    a = _as(a, ys)
    mu, p = _as(mu0, ys) * torch.ones_like(a), _as(p0, ys) * torch.ones_like(a)
    ll = torch.zeros_like(a)
    mus = []
    two_pi = 2 * math.pi
    for y in ys:
        mu, p = a * mu, a * a * p + q
        s = p + r
        ll = ll - 0.5 * (torch.log(two_pi * s) + (y - mu) ** 2 / s)
        gain = p / s
        mu = mu + gain * (y - mu)
        p = (1 - gain) * p
        mus.append(mu)
    return ll, torch.stack(mus)


def kalman_smoother(ys, a, q, r, mu0=0.0, p0=1.0):
    """The exact RTS smoother of the LGSSM of :func:`kalman_filter`:
    ``(log_lik, smoothed_means, smoothed_vars)``."""
    ys = torch.as_tensor(ys)
    a = _as(a, ys)
    mu, p, ll = _as(mu0, ys), _as(p0, ys), torch.zeros((), dtype=ys.dtype)
    mu_f, p_f, mu_pred, p_pred = [], [], [], []
    two_pi = 2 * math.pi
    for y in ys:
        mp, pp = a * mu, a * a * p + q
        s = pp + r
        ll = ll - 0.5 * (torch.log(two_pi * s) + (y - mp) ** 2 / s)
        gain = pp / s
        mu, p = mp + gain * (y - mp), (1 - gain) * pp
        mu_f.append(mu)
        p_f.append(p)
        mu_pred.append(mp)
        p_pred.append(pp)
    # Backward over t = T-2 .. 0, from the last filtered state.
    mu_s, p_s = [mu_f[-1]], [p_f[-1]]
    for t in range(len(mu_f) - 2, -1, -1):
        c = p_f[t] * a / p_pred[t + 1]
        mu_s.append(mu_f[t] + c * (mu_s[-1] - mu_pred[t + 1]))
        p_s.append(p_f[t] + c * c * (p_s[-1] - p_pred[t + 1]))
    return ll, torch.stack(mu_s[::-1]), torch.stack(p_s[::-1])


def nonlinear_tracking_model():
    """The classic nonlinear benchmark (Gordon et al. 1993):
    ``x_t = x/2 + 25x/(1+x²) + N(0, 10)``, ``y_t = x²/20 + N(0, 1)``.
    Returns ``(init, step)`` for ``particle_filter``: on a batch of keys
    each works on the ensemble, one particle a key."""
    sd = _f32_sqrt(10.0)
    half_log_2pi = 0.5 * math.log(2 * math.pi)

    def init(key):
        x = random.normal(key)
        return x, torch.zeros_like(x)

    def step(key, x, y):
        x_new = (0.5 * x + 25.0 * x / (1.0 + x * x)
                 + sd * random.normal(key))
        lw = -0.5 * (y - x_new * x_new / 20.0) ** 2 - half_log_2pi
        return x_new, lw

    return init, step
