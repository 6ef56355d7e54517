"""Particle Gibbs with its chain axis sharded over a mesh axis (the
counterpart of ``genjax_tpu/inference/pgibbs.py::particle_gibbs`` vmapped
over chains under a sharding constraint,
``tests/parallel/test_sharded_pgibbs.py``).

Chains do not interact, so a rank runs its chains as a key batch on
``fold_in(key, global chain index)`` (the rows of ``split(key, n)``) and
gets bit for bit those chains of the unsharded run on the whole key
batch. The pooled smoothing means gather the per-chain means, so every
rank pools the same numbers in the same order.
"""

from __future__ import annotations

from typing import Callable

import torch

from genjax_torch.core import random
from genjax_torch.inference.pgibbs import ParticleGibbsResult, particle_gibbs
from genjax_torch.parallel.collectives import all_gather
from genjax_torch.parallel.mesh import DeviceMesh, mesh_axis, rank_range

__all__ = ["sharded_particle_gibbs", "pooled_chain_means"]


def sharded_particle_gibbs(
    init_sampler: Callable,
    propagate: Callable,
    loglik: Callable,
    n_particles: int,
    n_iters: int,
    n_chains: int,
    mesh: DeviceMesh,
    axis_name="particles",
    trans_logpdf: Callable | None = None,
):
    """Build ``run(key, ys, init_path=None) -> ParticleGibbsResult`` for
    this rank's chains of ``n_chains`` over ``mesh[axis_name]``: chain
    ``i`` runs on ``fold_in(key, i)``, and every field leads with the
    rank's chains. The model is
    :func:`~genjax_torch.inference.pgibbs.particle_gibbs`'s (chain batch
    leading every call); ``init_path``, when given, is the rank's
    chains' starting paths."""
    run = particle_gibbs(init_sampler, propagate, loglik, n_particles,
                         n_iters, trans_logpdf)

    def sharded(key, ys, init_path=None) -> ParticleGibbsResult:
        lo, hi = rank_range(n_chains, mesh, axis_name)
        keys = random.split(key, hi - lo, offset=lo)
        return run(keys, ys, init_path)

    return sharded


def pooled_chain_means(paths: torch.Tensor, mesh: DeviceMesh,
                       axis_name="particles", burn_in: int = 0
                       ) -> torch.Tensor:
    """Every chain's mean path after ``burn_in`` sweeps, in float64,
    ``(n_chains, T, ...)`` on every rank: this rank's chains' means
    (``paths``: ``(chains, n_iters, T, ...)``), all-gathered in rank
    order. Pool them (mean, spread) on any rank."""
    ax = mesh_axis(mesh, axis_name)
    return all_gather(paths[:, burn_in:].double().mean(1), ax, "chain_means")
