"""Switching linear dynamical systems (SLDS) and their Rao-Blackwellized
particle filter (counterpart of ``genjax_tpu/models/slds.py``).

A discrete Markov regime ``z_t ∈ {0..S-1}`` drives a scalar linear
Gaussian state: ``x_t = A[z_t]·x_{t-1} + N(0, Q[z_t])``, ``y_t = x_t +
N(0, R[z_t])``. Given a regime path the model is a Kalman filter, so the
filter samples only the regimes and carries each particle's exact
``(mean, variance)``: its incremental weight is the exact one-step
predictive density, and at S = 1 it is the Kalman filter.

The JAX package selects each particle's parameters and transition-CDF
row with one-hot contractions (``ops/onehot.py``), because a gather is
slow on the TPU; here they are indexing (``a[z]``, ``trans_cdf[zs]``).
The regime draw keeps the inverse-CDF compare-count, so on the same keys
the draws are the JAX package's. Adaptive resampling is
``resample_tree``, whose systematic scheme runs the CDF->counts kernel on
the card, behind one host read of the ESS a step (the filter drivers'
``if``). :func:`slds_exact_log_marginal` enumerates all ``S^T`` regime
paths, the oracle for small ``T``.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from genjax_torch.core import random

__all__ = [
    "SLDSParams",
    "RBPFResult",
    "simulate_slds_data",
    "slds_rbpf",
    "slds_exact_log_marginal",
]


class SLDSParams(NamedTuple):
    """A scalar-state SLDS: per-regime dynamics and noise, and the regime
    chain."""

    trans_logits: torch.Tensor  # (S, S) regime transition log-probs rows
    prior_logits: torch.Tensor  # (S,) initial regime log-probs
    a: torch.Tensor             # (S,) dynamics coefficient per regime
    q: torch.Tensor             # (S,) process noise variance per regime
    r: torch.Tensor             # (S,) observation noise variance per regime
    mu0: float = 0.0            # x_0 prior mean
    p0: float = 1.0             # x_0 prior variance


class RBPFResult(NamedTuple):
    log_z: torch.Tensor         # evidence estimate log p(y_{1:T})
    regimes: torch.Tensor       # (n,) final regime per particle
    means: torch.Tensor         # (n,) final Kalman means per particle
    variances: torch.Tensor     # (n,) final Kalman variances per particle
    log_weights: torch.Tensor   # (n,) final log-weights
    ess_history: torch.Tensor   # (T,) ESS after assimilating y_t


def simulate_slds_data(key, params: SLDSParams, n_steps: int):
    """``(zs, xs, ys)`` drawn from the model by the convention that
    :func:`slds_rbpf` and :func:`slds_exact_log_marginal` score: ``y_0``
    comes from the prior regime ``z_0`` and ``x_0 ~ N(mu0, p0)``, and
    transitions apply from ``t = 1``. The keys are the JAX package's."""
    kz, kx, ky = random.split(key, 3).unbind(-2)
    z = random.categorical(kz, params.prior_logits)
    sd0 = torch.sqrt(torch.as_tensor(params.p0, dtype=params.a.dtype,
                                     device=params.a.device))
    x = params.mu0 + sd0 * random.normal(kx)
    y = x + torch.sqrt(params.r[z]) * random.normal(ky)
    zs, xs, ys = [z], [x], [y]
    kzs = random.split(random.fold_in(kz, 1), n_steps - 1)
    kxs = random.split(random.fold_in(kx, 1), n_steps - 1)
    kys = random.split(random.fold_in(ky, 1), n_steps - 1)
    for t in range(n_steps - 1):
        z = random.categorical(kzs[t], params.trans_logits[z])
        x = params.a[z] * x + torch.sqrt(params.q[z]) * random.normal(kxs[t])
        y = x + torch.sqrt(params.r[z]) * random.normal(kys[t])
        zs.append(z)
        xs.append(x)
        ys.append(y)
    return torch.stack(zs), torch.stack(xs), torch.stack(ys)


def _kalman_init(mu0, p0, y, r_z):
    """The ``x_0 ~ N(mu0, p0)`` prior conditioned on ``y = x_0 + noise``:
    the posterior ``(mu, p)`` and the predictive log-likelihood of ``y``
    (shared by the filter and the oracle)."""
    s0 = p0 + r_z
    ll = -0.5 * (torch.log(2.0 * math.pi * s0) + (y - mu0) ** 2 / s0)
    k0 = p0 / s0
    return mu0 + k0 * (y - mu0), (1.0 - k0) * p0, ll


def _kalman_step(mu, p, y, a_z, q_z, r_z):
    """One conditional Kalman predict and update: the posterior ``(mu,
    p)`` and the predictive log-likelihood of ``y``."""
    mu_pred = a_z * mu
    p_pred = a_z * a_z * p + q_z
    s = p_pred + r_z                       # innovation variance
    ll = -0.5 * (torch.log(2.0 * math.pi * s) + (y - mu_pred) ** 2 / s)
    k = p_pred / s                         # Kalman gain
    return mu_pred + k * (y - mu_pred), (1.0 - k) * p_pred, ll


def slds_rbpf(params: SLDSParams, n_particles: int,
              ess_threshold: float = 0.5, resampling: str = "systematic"):
    """``run(key, ys) -> RBPFResult``: the Rao-Blackwellized particle
    filter over the regime path, with exact Kalman statistics per
    particle. ``ys[0]`` conditions the initial regime draw."""
    from genjax_torch.inference.smc import (
        effective_sample_size,
        resample_tree,
    )

    s_states = params.trans_logits.shape[0]
    trans_cdf = torch.cumsum(torch.softmax(params.trans_logits, dim=-1),
                             dim=-1)
    log_n = torch.log(torch.tensor(float(n_particles),
                                   device=params.a.device))

    def run(key, ys) -> RBPFResult:
        k_init, k_scan = random.split(key).unbind(-2)
        n_steps = ys.shape[0]
        # Every step's keys at once: fold_in(k_scan, t), then split.
        steps = torch.arange(1, n_steps, device=key.device)
        k_res, k_trans = random.split(random.fold_in(k_scan, steps)).unbind(-2)

        # t = 0: prior regimes, the x_0 prior conditioned on ys[0].
        zs = random.categorical(k_init, params.prior_logits,
                                shape=(n_particles,))
        mus, ps, lw = _kalman_init(params.mu0, params.p0, ys[0],
                                   params.r[zs])
        ps = ps * torch.ones_like(mus)
        lse = torch.logsumexp(lw, dim=0)
        log_z = lse - log_n
        lw = lw - lse
        ess_hist = []
        for t in range(1, n_steps):
            # Adaptive resampling of the whole sufficient statistics.
            ess = effective_sample_size(lw)
            ess_hist.append(ess)
            slds_rbpf.host_syncs += 1
            if bool(ess < ess_threshold * n_particles):
                zs, mus, ps = resample_tree(k_res[t - 1], lw, (zs, mus, ps),
                                            n_particles, resampling)
                lw = torch.zeros_like(lw)
            # Regime transition by inverse CDF, one uniform a particle.
            u = random.uniform(k_trans[t - 1], (n_particles, 1))
            zs = torch.clamp_max(torch.sum(trans_cdf[zs] < u, dim=-1),
                                 s_states - 1)
            # The exact conditional Kalman update; its predictive
            # likelihood is the incremental weight.
            mus, ps, ll = _kalman_step(mus, ps, ys[t], params.a[zs],
                                       params.q[zs], params.r[zs])
            lw_new = lw + ll
            log_z = (log_z + torch.logsumexp(lw_new, dim=0)
                     - torch.logsumexp(lw, dim=0))
            lw = lw_new
        # The ESS before assimilating y_t is the ESS after y_{t-1}; with
        # the final weights' that is every t = 0..T-1.
        ess_hist.append(effective_sample_size(lw))
        return RBPFResult(log_z, zs, mus, ps, lw, torch.stack(ess_hist))

    return run


#: Host reads of the ESS so far, one a step after the first (the
#: filter's only syncs).
slds_rbpf.host_syncs = 0


def slds_exact_log_marginal(params: SLDSParams, ys):
    """The exact ``log p(y_{1:T})``: every one of the ``S^T`` regime
    paths scored with its conditional Kalman evidence, all paths at once
    (the oracle for small ``T``), in the dtype of ``params``."""
    s_states = params.trans_logits.shape[0]
    n_steps = ys.shape[0]
    ys = ys.to(params.a.dtype)
    dev = params.a.device
    idx = torch.arange(s_states ** n_steps, device=dev)
    powers = s_states ** torch.arange(n_steps, device=dev)
    digits = (idx[:, None] // powers[None, :]) % s_states   # (P, T)
    log_trans = torch.log_softmax(params.trans_logits, dim=-1)
    log_prior = torch.log_softmax(params.prior_logits, dim=-1)
    lp = log_prior[digits[:, 0]] + log_trans[digits[:, :-1],
                                             digits[:, 1:]].sum(dim=-1)
    mu, p, acc = _kalman_init(params.mu0, params.p0, ys[0],
                              params.r[digits[:, 0]])
    for t in range(1, n_steps):
        z = digits[:, t]
        mu, p, ll = _kalman_step(mu, p, ys[t], params.a[z], params.q[z],
                                 params.r[z])
        acc = acc + ll
    return torch.logsumexp(lp + acc, dim=0)
