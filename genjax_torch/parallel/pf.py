"""Particle filtering with the particle axis spread over a mesh axis
(counterpart of ``genjax_tpu/parallel/pf.py``; bench config 4: 1M
particles across hosts).

Each rank runs :func:`~genjax_torch.inference.pf.particle_filter` on its
slice of the particles, on the per-particle keys of their global
indices. ``use_collectives=True`` (the product path) takes the weight
reductions and the systematic resampling from ``parallel/collectives.py``:
blocked, bitwise layout-independent summation, O(N/D) memory a rank and
communication of known volume. ``use_collectives=False`` is the
replicated baseline that the JAX package's GSPMD path computes in
effect: the log weights and the particle leaves are all-gathered, every
rank resamples the whole ensemble with ``resample_tree`` (the CDF kernel
on a card) and keeps its slice. torch has no sharding propagation, so
this is its form here; it moves the whole state and is kept for
comparison only."""

from __future__ import annotations

import math
from typing import Callable

import torch

from genjax_torch.inference.pf import particle_filter
from genjax_torch.inference.smc import resample_tree
from genjax_torch.core.pytree import tree_map
from genjax_torch.parallel.collectives import (
    all_gather,
    blocked_stats,
    ring_systematic_resample,
)
from genjax_torch.parallel.mesh import (
    DeviceMesh,
    mesh_axis,
    rank_range,
    shard_leading_axis,
)

__all__ = ["sharded_particle_filter"]


def gathered_stats(lw, mesh: DeviceMesh, axis_name="particles"):
    """``(lse, ess)`` of the whole ensemble from its all-gathered log
    weights (the replicated baseline)."""
    full = all_gather(lw, mesh_axis(mesh, axis_name), "stats")
    lse = torch.logsumexp(full, dim=0)
    return lse, torch.exp(2.0 * lse - torch.logsumexp(2.0 * full, dim=0))


def gathered_resample(key, lw, particles, mesh: DeviceMesh,
                      axis_name="particles", method: str = "systematic"):
    """The replicated baseline's resample: gather the weights and the
    particle leaves, resample the whole ensemble on every rank, keep this
    rank's slice."""
    ax = mesh_axis(mesh, axis_name)
    full_lw = all_gather(lw, ax, "resample_weights")
    full = tree_map(lambda x: all_gather(x, ax, "resample_state")
                    if isinstance(x, torch.Tensor) and x.ndim else x,
                    particles)
    out = resample_tree(key.to(lw.device), full_lw, full, full_lw.shape[0],
                        method)
    return shard_leading_axis(out, mesh, axis_name)


def sharded_particle_filter(
    init: Callable,
    step: Callable,
    n_particles: int,
    mesh: DeviceMesh,
    axis_name="particles",
    ess_threshold: float = 0.5,
    resampling: str = "systematic",
    batched: bool = False,
    use_collectives: bool = True,
):
    """:func:`~genjax_torch.inference.pf.particle_filter` with this rank
    running its slice of ``n_particles`` (per-particle keys ``fold_in(k,
    i)`` of the global ``i``), so the draws, and with
    ``use_collectives=True`` the reductions and the resampled ensemble
    too, are bitwise equal on every power-of-two layout. ``run(key,
    observations)`` returns the rank's slice of the final state and the
    replicated log Z. ``batched=True`` raises: its one-key draws cannot
    be split over ranks."""
    if batched:
        raise ValueError(
            "sharded_particle_filter: batched=True draws the ensemble from "
            "one key, which no rank's slice can reproduce; the layout-"
            "independent path is the per-particle one (batched=False)")
    particle_range = rank_range(n_particles, mesh, axis_name)
    if use_collectives:
        if resampling != "systematic":
            raise ValueError(
                "use_collectives=True implements systematic resampling "
                f"only (got {resampling!r}); pass use_collectives=False"
            )
        log_n = math.log(n_particles)

        def stats_fn(lw):
            logz, ess = blocked_stats(lw, mesh, axis_name)
            return logz + log_n, ess

        def resample_fn(key, lw, particles):
            return ring_systematic_resample(key, lw, particles, mesh,
                                            axis_name)
    else:
        def stats_fn(lw):
            return gathered_stats(lw, mesh, axis_name)

        def resample_fn(key, lw, particles):
            return gathered_resample(key, lw, particles, mesh, axis_name,
                                     resampling)

    return particle_filter(init, step, n_particles, ess_threshold, resampling,
                           particle_range=particle_range, stats_fn=stats_fn,
                           resample_fn=resample_fn)
