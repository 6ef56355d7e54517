"""Sharded SMC: importance sampling, resampling and one SMC step with the
particle axis spread over a mesh axis (counterpart of
``genjax_tpu/parallel/smc.py``).

Each rank holds its slice of the particles: a :class:`ParticleCollection`
here is the rank's slice, so its own ``get_log_marginal_likelihood_estimate``
and ``effective_sample_size`` are the slice's; the ensemble's come from
``parallel.collectives.blocked_stats`` (or the step's returned log Z̄).
``impl="collective"`` (the product path) resamples through
``ring_resample_step``: O(N/D) memory a rank, a deterministic blocked
CDF, known traffic, bitwise equal on every power-of-two layout.
``impl="gspmd"`` is the replicated baseline the JAX package's GSPMD path
computes in effect (gather, resample on every rank, keep the slice).
"""

from __future__ import annotations

import math
from typing import Callable

import torch
import torch.distributed as dist

from genjax_torch.core import random
from genjax_torch.core.fixed_sum import tree_sum
from genjax_torch.gfi.choice_map import ChoiceMap
from genjax_torch.inference.smc import ParticleCollection, batched_importance
from genjax_torch.inference.sp import Target
from genjax_torch.parallel.collectives import (
    _pick_block,
    all_gather,
    all_reduce,
    ring_resample_step,
)
from genjax_torch.parallel.mesh import DeviceMesh, mesh_axis, rank_range
from genjax_torch.parallel.pf import gathered_resample, gathered_stats

__all__ = [
    "sharded_importance",
    "sharded_smc_step",
    "sharded_resample",
    "weighted_mean",
]


def sharded_importance(
    target: Target,
    k_particles: int,
    mesh: DeviceMesh,
    axis_name="particles",
) -> Callable:
    """``run(key) -> ParticleCollection``: K-particle importance sampling,
    this rank's slice ``[lo, hi)``, each particle ``i`` on the key
    ``fold_in(key, i)`` of its global index, so the weights are bitwise
    those of the unsharded run in any layout."""
    lo, hi = rank_range(k_particles, mesh, axis_name)

    def run(key) -> ParticleCollection:
        keys = random.fold_in(key[None], torch.arange(lo, hi,
                                                      device=key.device))
        trs, ws = batched_importance(target, keys, ChoiceMap.empty())
        return ParticleCollection(trs, ws, torch.tensor(True))

    return run


def weighted_mean(log_weights: torch.Tensor, values: torch.Tensor,
                  mesh: DeviceMesh, axis_name="particles",
                  block: int = 256) -> torch.Tensor:
    """``Σ softmax(lw)·v`` over the whole ensemble (replicated), summed in
    the layout-free blocks of the collectives: one max all-reduce and one
    all-gather of two partials a block."""
    ax = mesh_axis(mesh, axis_name)
    local_n = log_weights.shape[0]
    b = _pick_block(local_n * ax.size, local_n, block)
    m = all_reduce(log_weights.max(), dist.ReduceOp.MAX, ax, "max")
    e = torch.exp(log_weights - m).reshape(-1, b)
    parts = torch.stack([tree_sum(e * values.reshape(-1, b)), tree_sum(e)])
    num, den = tree_sum(all_gather(parts.T, ax, "mean_partials").T)
    return num / den


def sharded_resample(
    collection: ParticleCollection,
    key,
    mesh: DeviceMesh,
    axis_name="particles",
    method: str = "systematic",
    impl: str = "collective",
) -> ParticleCollection:
    """Resample this rank's slice of a sharded collection. The equalized
    weights carry the ensemble's log Z̄ (replicated).
    ``impl="collective"``: ``ring_resample_step`` (systematic only).
    ``impl="gspmd"``: the replicated baseline, any method."""
    lw = collection.get_log_weights()
    if impl == "collective":
        if method != "systematic":
            raise ValueError(
                "collective sharded_resample implements systematic "
                f"resampling only (got {method!r}); use impl='gspmd' "
                "for other methods"
            )
        new_particles, logz, _ess = ring_resample_step(
            key, lw, collection.particles, mesh, axis_name)
        return ParticleCollection(new_particles, torch.zeros_like(lw) + logz,
                                  collection.is_valid)
    if impl != "gspmd":
        raise ValueError(f"sharded_resample: impl {impl!r} is neither "
                         "'collective' nor 'gspmd'")
    new_particles = gathered_resample(key, lw, collection.particles, mesh,
                                      axis_name, method)
    lse, _ = gathered_stats(lw, mesh, axis_name)
    n = lw.shape[0] * mesh_axis(mesh, axis_name).size
    logz = lse - math.log(n)
    return ParticleCollection(new_particles, torch.zeros_like(lw) + logz,
                              collection.is_valid)


def sharded_smc_step(
    target: Target,
    k_particles: int,
    mesh: DeviceMesh,
    axis_name="particles",
    ess_threshold: float = 0.5,
    impl: str = "collective",
) -> Callable:
    """One sharded SMC step, ``step(key) -> (collection, logZ̄)``:
    importance-sample K particles, reduce log Z̄ and ESS over the
    ensemble, and resample when ESS falls below ``ess_threshold * K``
    (the decision is replicated, so every rank takes the same branch).
    ``axis_name`` may be a tuple of a 2-D mesh's axes."""
    importance = sharded_importance(target, k_particles, mesh, axis_name)

    def step(key):
        key, res_key = random.split(key).unbind(-2)
        collection = importance(key)
        lw = collection.get_log_weights()
        if impl == "collective":
            new_particles, logz, ess = ring_resample_step(
                res_key, lw, collection.particles, mesh, axis_name)
            resampled = ParticleCollection(new_particles,
                                           torch.zeros_like(lw) + logz,
                                           collection.is_valid)
        else:
            lse, ess = gathered_stats(lw, mesh, axis_name)
            logz = lse - math.log(k_particles)
            resampled = sharded_resample(collection, res_key, mesh,
                                         axis_name, impl="gspmd")
        if bool(ess < ess_threshold * k_particles):
            return resampled, logz
        return collection, logz

    return step
