"""Warmup adaptation for NUTS: a dual-averaging step size and a diagonal
mass matrix, each estimated across all chains (counterpart of
``genjax_tpu/inference/adaptation.py``), and ``run_nuts``, NUTS on a
``Target`` from the prior to the draws.

The chains are a key batch. The cross-chain statistics are a plain
reduction over the chain axis, grouped in blocks of up to 8 chains as
the JAX package groups them. The JAX package's ``mesh`` path (chains
sharded over devices, reductions as collectives) is not ported: passing
``mesh`` raises until the ``parallel/`` slice (ROADMAP queue 1 item 9).
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

from genjax_torch.core import random
from genjax_torch.core.pytree import ravel_pytree, tree_map
from genjax_torch.gfi.choice_map import ChoiceMap, partition_values
from genjax_torch.inference.requests.nuts import (
    NUTSInfo,
    check_float_latents,
    nuts_kernel,
)
from genjax_torch.inference.smc import lift_target
from genjax_torch.inference.sp import Target
from genjax_torch.inference.transforms import (
    constrain_choices,
    resolve_transforms,
    tree_device,
    unconstrain_choices,
)

__all__ = ["DualAveragingState", "warmup_chains", "run_nuts"]


def _no_mesh(mesh):
    if mesh is not None:
        raise NotImplementedError(
            "NUTS over a device mesh is not ported yet: it comes with the "
            "parallel/ slice (ROADMAP queue 1 item 9)")


class DualAveragingState(NamedTuple):
    log_eps: torch.Tensor
    log_eps_avg: torch.Tensor
    grad_avg: torch.Tensor
    t: torch.Tensor
    mu: torch.Tensor


def _da_restart(log_eps: torch.Tensor) -> DualAveragingState:
    # log_eps_avg starts at log_eps: the first update overwrites it
    # whole (t = 1 gives w = 1), and a zero-length warmup returns eps0.
    zero = torch.zeros_like(log_eps)
    return DualAveragingState(log_eps, log_eps, zero, zero,
                              math.log(10.0) + log_eps)


def da_init(eps0: float, device=None) -> DualAveragingState:
    return _da_restart(torch.log(torch.tensor(eps0, dtype=torch.float32,
                                              device=device)))


def da_update(state: DualAveragingState, accept_prob: torch.Tensor,
              target: float = 0.8, gamma: float = 0.05, t0: float = 10.0,
              kappa: float = 0.75) -> DualAveragingState:
    t = state.t + 1.0
    g = target - accept_prob
    grad_avg = (1.0 - 1.0 / (t + t0)) * state.grad_avg + g / (t + t0)
    log_eps = state.mu - torch.sqrt(t) / gamma * grad_avg
    w = t ** (-kappa)
    log_eps_avg = w * log_eps + (1.0 - w) * state.log_eps_avg
    return DualAveragingState(log_eps, log_eps_avg, grad_avg, t, state.mu)


class WelfordState(NamedTuple):
    mean: torch.Tensor
    m2: torch.Tensor
    count: torch.Tensor


def welford_init(d: int, device=None) -> WelfordState:
    return WelfordState(torch.zeros(d, device=device),
                        torch.zeros(d, device=device),
                        torch.zeros((), device=device))


def welford_update_moments(state: WelfordState, mean_b: torch.Tensor,
                           m2_b: torch.Tensor, n_b) -> WelfordState:
    """Fold pre-reduced batch moments in (Chan's parallel combine)."""
    n = state.count
    total = n + n_b
    delta = mean_b - state.mean
    mean = state.mean + delta * n_b / total
    m2 = state.m2 + m2_b + delta ** 2 * n * n_b / total
    return WelfordState(mean, m2, total)


def welford_variance(state: WelfordState) -> torch.Tensor:
    return state.m2 / torch.clamp(state.count - 1.0, min=1.0)


def _chain_block(n: int, cap: int = 8, reserve_pow2: int = 6) -> int:
    """The JAX package's chain group for ``n`` chains: the largest divisor
    of ``n`` up to ``cap`` whose power of two leaves ``reserve_pow2``
    powers of ``n``'s free."""
    v = (n & -n).bit_length() - 1
    max_v_b = max(0, v - reserve_pow2)
    for cand in range(min(cap, n), 0, -1):
        if n % cand == 0 and (cand & -cand).bit_length() - 1 <= max_v_b:
            return cand
    return 1


def _cross_chain_stats(zs: torch.Tensor, accept: torch.Tensor):
    """``(mean_b, m2_b, accept_mean)`` over the chains of ``zs`` (chains,
    D) and ``accept`` (chains,): sums over groups of chains, then over
    the groups."""
    n = accept.shape[0]
    b = _chain_block(n)
    nb = n // b
    mean_b = zs.reshape(nb, b, -1).sum(1).sum(0) / n
    accept_mean = accept.reshape(nb, b).sum(1).sum() / n
    sq = (zs - mean_b[None, :]) ** 2
    m2_b = sq.reshape(nb, b, -1).sum(1).sum(0)
    return mean_b, m2_b, accept_mean


def warmup_chains(
    logdensity_fn: Callable[[torch.Tensor], torch.Tensor],
    z0s: torch.Tensor,
    key: torch.Tensor,
    num_warmup: int = 500,
    max_depth: int = 8,
    target_accept: float = 0.8,
    eps0: float = 0.1,
    mesh=None,
    axis_name: str = "chains",
    fixed_budget: bool = False,
):
    """Adapt (eps, diagonal inverse mass) across the chains ``z0s``
    (chains, D). Returns ``(z_warm, eps, inv_mass)``. The mass comes
    from the second half of warmup, set once three quarters in, where
    dual averaging restarts under the new metric; eps adapts every step
    from the chains' mean acceptance."""
    _no_mesh(mesh)
    n_chains, d = z0s.shape
    dev = z0s.device
    chains = torch.arange(n_chains, device=dev)
    keys = random.split(key, num_warmup)
    zs, da = z0s, da_init(eps0, dev)
    wf, inv_mass = welford_init(d, dev), torch.ones(d, device=dev)
    for i in range(num_warmup):
        step_keys = random.fold_in(keys[i].unsqueeze(0), chains)
        zs, info = nuts_kernel(logdensity_fn, zs, step_keys,
                               torch.exp(da.log_eps), inv_mass, max_depth,
                               fixed_budget=fixed_budget)
        mean_b, m2_b, accept = _cross_chain_stats(zs, info.accept_prob)
        da = da_update(da, accept, target_accept)
        if i >= num_warmup // 2:
            wf = welford_update_moments(wf, mean_b, m2_b, n_chains)
        if i == (3 * num_warmup) // 4:
            # Refresh the metric once (inv_mass ≈ posterior variance) and
            # restart dual averaging from the current step size.
            use_var = wf.count > 10
            inv_mass = torch.where(
                use_var, torch.clamp(welford_variance(wf), min=1e-6),
                inv_mass)
            da = DualAveragingState(*tree_map(
                lambda a, b: torch.where(use_var, a, b),
                tuple(_da_restart(da.log_eps)), tuple(da)))
    return zs, torch.exp(da.log_eps_avg), inv_mass


def run_nuts(
    target: Target,
    key: torch.Tensor,
    n_chains: int = 4,
    num_warmup: int = 500,
    num_samples: int = 1000,
    max_depth: int = 8,
    target_accept: float = 0.8,
    mesh=None,
    axis_name: str = "chains",
    transforms: "dict | str | None" = None,
    fixed_budget: bool = False,
):
    """NUTS on a :class:`Target`: chains start from the prior, warm up
    with cross-chain adaptation, and draw. Returns ``(choices, infos)``:
    choice maps whose leaves lead with ``(chains, samples)`` (an
    ``Indexed`` node of a Scan or Vmap site records the two axes in its
    ``batch_rank``), and :class:`NUTSInfo` of that shape.

    ``transforms``: a dict from latent addresses to support bijectors
    (``"positive"``, ``(low, high)``, a ``Bijector``), or ``"auto"`` to
    read them from the distributions' support metadata; NUTS then runs
    in unconstrained space and the choices come back constrained.
    ``fixed_budget`` picks the strategy of
    :func:`~genjax_torch.inference.requests.nuts.nuts_kernel`.

    The log-density of a position is the target's joint score, taken by
    ``assess`` of the whole choice map (the JAX package reads the same
    number from ``importance``, whose keys nothing here consumes)."""
    _no_mesh(mesh)
    dev = key.device
    k_init, k_warm, k_sample = random.split(key, 3).unbind(-2)
    transforms = resolve_transforms(target, transforms)
    chains = torch.arange(n_chains, device=dev)
    lifted = lift_target(
        target, n_chains, tree_device((target.args, target.constraint)) or dev)
    trs, _ = lifted.importance(random.fold_in(k_init.unsqueeze(0), chains),
                               ChoiceMap.empty())
    latents0 = unconstrain_choices(
        lifted.filter_to_unconstrained(trs.get_choices()), transforms)
    vals0, rebuild = partition_values(latents0)
    check_float_latents(vals0)
    z0s, unravel_vals = ravel_pytree(vals0, 1)
    batch = (n_chains,)

    def logdensity(z_vec):
        chm_x, fldj = constrain_choices(rebuild(unravel_vals(z_vec)),
                                        transforms, 1)
        score, _ = lifted.p.assess(lifted.constraint | chm_x, lifted.args,
                                   batch=batch)
        return score + fldj

    z, eps, inv_mass = warmup_chains(
        logdensity, z0s, k_warm, num_warmup, max_depth, target_accept,
        fixed_budget=fixed_budget)
    step_keys = random.split(random.fold_in(k_sample.unsqueeze(0), chains),
                             num_samples)                    # (C, S, 2)
    zs, infos = [], []
    for s in range(num_samples):
        z, info = nuts_kernel(logdensity, z, step_keys[:, s], eps, inv_mass,
                              max_depth, fixed_budget=fixed_budget)
        zs.append(z)
        infos.append(info)
    zs = torch.stack(zs, dim=1)
    infos = NUTSInfo(*(torch.stack(f, dim=1) for f in zip(*infos)))
    chms, _ = constrain_choices(rebuild(unravel_vals(zs), 1), transforms, 2)
    return chms, infos
