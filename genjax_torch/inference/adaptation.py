"""Warmup adaptation for NUTS: a dual-averaging step size and a diagonal
mass matrix, each estimated across all chains (counterpart of
``genjax_tpu/inference/adaptation.py``), and ``run_nuts``, NUTS on a
``Target`` from the prior to the draws.

The chains are a key batch. With ``mesh``, each rank runs its slice of
the chains (keys of their global indices) and the cross-chain statistics
become all-gathers of group partials; ``mesh=None`` runs the same
reduction with no gather, so both give the same bits
(:func:`_cross_chain_stats`).
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

from genjax_torch.core import random
from genjax_torch.core.fixed_sum import tree_sum
from genjax_torch.core.pytree import ravel_pytree, tree_map
from genjax_torch.gfi.choice_map import ChoiceMap, partition_values
from genjax_torch.inference.requests.nuts import (
    NUTSInfo,
    check_float_latents,
    nuts_kernel,
)
from genjax_torch.inference.smc import lift_target
from genjax_torch.inference.sp import Target
from genjax_torch.parallel.collectives import _layout_free_block, all_gather
from genjax_torch.parallel.mesh import mesh_axis, rank_range
from genjax_torch.inference.transforms import (
    constrain_choices,
    resolve_transforms,
    tree_device,
    unconstrain_choices,
)

__all__ = ["DualAveragingState", "warmup_chains", "run_nuts"]


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


def welford_update_batch(state: WelfordState,
                         zs: torch.Tensor) -> WelfordState:
    """Fold a whole (chains, D) batch in: the cross-chain reduction."""
    n_b = zs.shape[0]
    mean_b = zs.mean(dim=0)
    m2_b = ((zs - mean_b) ** 2).sum(dim=0)
    return welford_update_moments(state, mean_b, m2_b, n_b)


def welford_variance(state: WelfordState) -> torch.Tensor:
    return state.m2 / torch.clamp(state.count - 1.0, min=1.0)


def group_sums(x: torch.Tensor, b: int) -> torch.Tensor:
    """The rank-local part of the cross-chain statistics: the sums of
    each consecutive group of ``b`` chains of ``x`` (chains, D), a fixed
    tree each, ``(chains / b, D)``."""
    return tree_sum(x.reshape(-1, b, x.shape[-1]), 1)


def _cross_chain_stats(zs: torch.Tensor, accept: torch.Tensor, mesh=None,
                       axis_name="chains", block: int = 8):
    """``(mean_b, m2_b, accept_mean)`` over all chains, from this rank's
    ``zs`` (chains/D, D) and ``accept`` (chains/D,). Every float sum runs
    in fixed units: chain groups of a size derived from the GLOBAL chain
    count alone (``collectives._layout_free_block`` with cap ``block``),
    each summed by a fixed tree, then the groups' partials, gathered in
    chain order, by another. So the adapted (eps, mass), and every draw
    after them, are bitwise equal for ``mesh=None`` and any power-of-two
    chain-sharded world up to 64 ranks (NUTS turns an ulp of eps into
    visibly different chains). The only collectives are two all-gathers
    of group partials, never the (chains, D) positions; with
    ``mesh=None`` the partials are already whole."""
    ax = None if mesh is None else mesh_axis(mesh, axis_name)
    c_loc = accept.shape[0]
    n_chains = c_loc * (1 if ax is None else ax.size)
    b = _layout_free_block(n_chains, block)
    if c_loc % b:
        raise ValueError(
            f"cross-chain adaptation: the layout-independent chain "
            f"group {b} (derived from n_chains={n_chains}) does not "
            f"divide the per-device chain count chains/D={c_loc}. "
            f"Use a power-of-two mesh axis (up to 64 devices).")

    def gather(x):
        return x if ax is None else all_gather(x, ax, "chain_partials")

    first = gather(group_sums(torch.cat([zs, accept[:, None]], 1), b))
    mean_b = tree_sum(first[:, :-1], 0) / n_chains
    accept_mean = tree_sum(first[:, -1], 0) / n_chains
    sq = (zs - mean_b[None, :]) ** 2
    m2_b = tree_sum(gather(group_sums(sq, b)), 0)
    return mean_b, m2_b, accept_mean


def _chain_range(n_chains: int, mesh, axis_name) -> tuple[int, int]:
    """This rank's ``[lo, hi)`` of the chains (all of them without a
    mesh)."""
    return (0, n_chains) if mesh is None else rank_range(n_chains, mesh,
                                                         axis_name)


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
    from the chains' mean acceptance. With ``mesh``, ``z0s`` is this
    rank's slice of the chains (their keys those of their global
    indices), ``z_warm`` too, and eps and the mass are replicated:
    bitwise those of ``mesh=None``."""
    c_loc, d = z0s.shape
    dev = z0s.device
    n_chains = c_loc if mesh is None else (
        c_loc * mesh_axis(mesh, axis_name).size)
    lo, hi = _chain_range(n_chains, mesh, axis_name)
    chains = torch.arange(lo, hi, device=dev)
    keys = random.split(key, num_warmup)
    zs, da = z0s, da_init(eps0, dev)
    wf, inv_mass = welford_init(d, dev), torch.ones(d, device=dev)
    for i in range(num_warmup):
        step_keys = random.fold_in(keys[i].unsqueeze(0), chains)
        zs, info = nuts_kernel(logdensity_fn, zs, step_keys,
                               torch.exp(da.log_eps), inv_mass, max_depth,
                               fixed_budget=fixed_budget)
        mean_b, m2_b, accept = _cross_chain_stats(zs, info.accept_prob,
                                                  mesh, axis_name)
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
    init_draws: int = 1,
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
    ``init_draws``: each chain starts from the best (highest joint
    log-density) of this many prior draws; 1, the default, is the JAX
    package's start, one prior draw. A chain started where the density's
    gradient is huge (a tiny noise scale under a half-normal prior)
    diverges at every step of the step size the other chains set, and
    never moves; the best of a few draws starts every chain in reach.

    The log-density of a position is the target's joint score, taken by
    ``assess`` of the whole choice map (the JAX package reads the same
    number from ``importance``, whose keys nothing here consumes).

    With ``mesh``, this rank runs its slice of the ``n_chains`` (each
    chain on the keys of its global index) and returns its slice of the
    draws; the warmup's cross-chain statistics are gathered over
    ``mesh[axis_name]``, so every draw is bitwise that of ``mesh=None``."""
    dev = key.device
    k_init, k_warm, k_sample = random.split(key, 3).unbind(-2)
    transforms = resolve_transforms(target, transforms)
    lo, hi = _chain_range(n_chains, mesh, axis_name)
    chains = torch.arange(lo, hi, device=dev)
    lifted = lift_target(
        target, hi - lo, tree_device((target.args, target.constraint)) or dev)
    init_keys = random.fold_in(k_init.unsqueeze(0), chains)

    def prior_draw(keys):
        trs, _ = lifted.importance(keys, ChoiceMap.empty())
        latents = unconstrain_choices(
            lifted.filter_to_unconstrained(trs.get_choices()), transforms)
        return partition_values(latents)

    vals0, rebuild = prior_draw(init_keys)
    check_float_latents(vals0)
    z0s, unravel_vals = ravel_pytree(vals0, 1)
    batch = (hi - lo,)

    def logdensity(z_vec):
        chm_x, fldj = constrain_choices(rebuild(unravel_vals(z_vec)),
                                        transforms, 1)
        score, _ = lifted.p.assess(lifted.constraint | chm_x, lifted.args,
                                   batch=batch)
        return score + fldj

    if init_draws > 1:
        best = logdensity(z0s)
        for d in range(1, init_draws):
            z_d, _ = ravel_pytree(prior_draw(random.fold_in(init_keys, d))[0],
                                  1)
            lp = logdensity(z_d)
            better = lp > best
            z0s = torch.where(better[:, None], z_d, z0s)
            best = torch.where(better, lp, best)

    z, eps, inv_mass = warmup_chains(
        logdensity, z0s, k_warm, num_warmup, max_depth, target_accept,
        mesh=mesh, axis_name=axis_name, fixed_budget=fixed_budget)
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
