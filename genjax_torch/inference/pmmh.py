"""Particle marginal Metropolis–Hastings (PMMH): exact-approximation
parameter inference for state-space models (counterpart of
``genjax_tpu/inference/pmmh.py``).

An unbiased likelihood estimator — a particle filter's ẑ(θ) — plugged
into a Metropolis–Hastings chain leaves the exact posterior p(θ | y)
invariant whatever the particle count (Andrieu, Doucet & Holenstein
2010). ``lax.scan`` over sweeps becomes a Python loop. A key batch
``B + (2,)`` runs ``B`` chains side by side: θ's leaves lead with ``B``,
and the estimator and prior map a batch of keys and θs to one value a
chain (the θ-leading convention of ``smc2``).
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from genjax_torch.core import random
from genjax_torch.core.pytree import tree_flatten, tree_map, tree_unflatten

__all__ = ["PMMHResult", "pmmh", "gaussian_walk_proposal"]


class PMMHResult(NamedTuple):
    thetas: Any              # B + (n_iters, ...) parameter chain
    log_zs: torch.Tensor     # B + (n_iters,) retained logZ estimates
    accept_rate: torch.Tensor  # B
    final_theta: Any


def gaussian_walk_proposal(step_std):
    """Symmetric Gaussian random-walk proposal over a θ pytree.
    ``step_std`` is a scalar (broadcast to every leaf) or a pytree exactly
    matching θ's structure (per-leaf stds); any other structure raises at
    proposal time. On a key batch ``B + (2,)`` every θ leaf leads with
    ``B``, and each row moves on its own key, as the JAX function does
    under ``vmap``."""

    def propose(key, theta):
        leaves, spec = tree_flatten(theta)
        std_leaves, std_spec = tree_flatten(step_std)
        if std_spec == spec:
            stds = std_leaves
        elif len(std_leaves) == 1 and torch.as_tensor(std_leaves[0]).ndim == 0:
            stds = [std_leaves[0]] * len(leaves)
        else:
            raise TypeError(
                "gaussian_walk_proposal: step_std must be a scalar or a "
                f"pytree matching theta (theta structure {spec}, step_std "
                f"structure {std_spec})")
        r = key.ndim - 1
        keys = random.split(key, len(leaves))
        new = []
        for i, (l, s) in enumerate(zip(leaves, stds)):
            l = torch.as_tensor(l, device=key.device)
            eps = random.normal(keys[..., i, :], tuple(l.shape[r:]))
            new.append(l + torch.as_tensor(s, device=key.device) * eps)
        return tree_unflatten(new, spec)

    return propose


def _where(flag: torch.Tensor, a, b):
    """``where(flag, a, b)`` leafwise, the flag (shape ``B``) broadcast
    over each leaf's trailing axes."""
    def pick(x, y):
        x = torch.as_tensor(x)
        f = flag.reshape(tuple(flag.shape) + (1,) * (x.ndim - flag.ndim))
        return torch.where(f, x, torch.as_tensor(y, device=x.device))

    return tree_map(pick, a, b)


def pmmh(
    log_marginal_est: Callable,
    log_prior: Callable,
    n_iters: int,
    proposal: Callable | float = 0.1,
):
    """Build ``run(key, theta0) -> PMMHResult``.

    - ``log_marginal_est(key, theta) -> logẐ``: any unbiased marginal-
      likelihood estimator (a particle filter's ``log_z``);
    - ``log_prior(theta)``: the log prior density of θ;
    - ``proposal``: a float (Gaussian random-walk std) or a callable
      ``(key, theta) -> theta'`` implementing a SYMMETRIC proposal.

    A key batch ``B + (2,)`` runs ``B`` chains; ``theta0``'s leaves then
    lead with ``B`` and every callable works on the batch."""
    if not callable(proposal):
        proposal = gaussian_walk_proposal(proposal)

    def run(key, theta0):
        k_init, k_scan = random.split(key).unbind(-2)
        theta = theta0
        lz = log_marginal_est(k_init, theta)
        lp = log_prior(theta)
        thetas, lzs, accepts = [], [], []
        for i in range(n_iters):
            k_prop, k_est, k_acc = random.split(
                random.fold_in(k_scan, i), 3).unbind(-2)
            prop = proposal(k_prop, theta)
            lzp = log_marginal_est(k_est, prop)
            lpp = log_prior(prop)
            accept = torch.log(random.uniform(k_acc, ())) < lzp + lpp - lz - lp
            theta = _where(accept, prop, theta)
            lz = torch.where(accept, lzp, lz)
            lp = torch.where(accept, lpp, lp)
            thetas.append(theta)
            lzs.append(lz)
            accepts.append(accept)
        r = key.ndim - 1
        stacked = tree_map(lambda *vs: torch.stack(vs, dim=r), *thetas)
        acc = torch.stack(accepts, dim=-1).float().mean(-1)
        return PMMHResult(stacked, torch.stack(lzs, dim=-1), acc, theta)

    return run
