"""SMC² with its θ-lane axis sharded over a mesh axis (the counterpart
of ``genjax_tpu/inference/smc2.py`` run under a sharding constraint on
the θ-lanes, ``tests/parallel/test_sharded_smc2.py``).

JAX lays the θ-lanes over the devices and leaves GSPMD to move what the
program reads across lanes. Here each rank holds its θ-rows whole:
``thetas``, the ``(n, N_x)`` state grid, ``lw_x``, ``logz_th`` and
``w_th``, and runs :func:`~genjax_torch.inference.smc2.smc2_core` on
them. What crosses rows crosses ranks:

- the θ-level decisions: each step all-gathers the ``N_θ`` θ-log-weights,
  and every rank computes the θ-ESS, the log Z increment and the
  multinomial θ-ancestors from the whole vector with the very calls of
  the unsharded run, so these numbers and the host's ESS test are the
  same on every rank;
- the θ-resample: only the rows a rank needs from other ranks move
  (``collectives.take_rows``, one ``all_to_all_single`` a leaf);
- the PMMH acceptances, counted as integers and summed once at the end.

Keys use global row indices (``fold_in(k, rows)``; the propagation keys
are the rank's rows of ``split(k, N_θ)``), and the one-key grid draw of
the row resample takes its rows by a counter offset
(``core.random.bits``), so every rank's rows are bit for bit those rows
of the unsharded run, in every world size.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from genjax_torch.inference.pmmh import gaussian_walk_proposal
from genjax_torch.inference.smc2 import SMC2Result, smc2_core
from genjax_torch.parallel.collectives import all_gather, all_reduce, take_rows
from genjax_torch.parallel.mesh import DeviceMesh, mesh_axis, rank_range

__all__ = ["sharded_smc2"]


class _RankRows:
    """This rank's θ-rows, for :func:`smc2_core`."""

    def __init__(self, n_theta: int, mesh: DeviceMesh, axis_name):
        self.ax = mesh_axis(mesh, axis_name)
        self.lo, self.hi = rank_range(n_theta, mesh, axis_name)

    def all_weights(self, w: torch.Tensor) -> torch.Tensor:
        return all_gather(w, self.ax, "theta_weights")

    def take(self, tree, anc: torch.Tensor):
        return take_rows(tree, anc, self.ax, "theta_resample")

    def total(self, count: torch.Tensor) -> torch.Tensor:
        return all_reduce(count, dist.ReduceOp.SUM, self.ax, "accepted")


def sharded_smc2(
    init_sampler: Callable,
    propagate: Callable,
    loglik: Callable,
    prior_sample: Callable,
    log_prior: Callable,
    n_theta: int,
    n_x: int,
    mesh: DeviceMesh,
    axis_name="particles",
    proposal: Callable | float = 0.1,
    ess_threshold: float = 0.5,
    inner_resampling: str = "systematic",
    inner_impl: str = "auto",
):
    """Build ``run(key, ys) -> SMC2Result`` over this rank's θ-rows of
    ``mesh[axis_name]``: ``thetas`` and ``log_weights`` are the rank's
    slice of the θ axis; ``log_z``, ``ess_history``, ``rejuv_accept`` and
    ``n_rejuvenations`` are replicated. The model and options are
    :func:`~genjax_torch.inference.smc2.smc2`'s, and the result is bit for
    bit the unsharded run's, sliced by rank. ``n_theta`` must divide over
    the ranks."""
    if not callable(proposal):
        proposal = gaussian_walk_proposal(proposal)
    if inner_impl not in ("auto", "fused", "sort"):
        raise ValueError(f"unknown inner_impl {inner_impl!r}")
    model = (init_sampler, propagate, loglik, prior_sample, log_prior)

    def run(key, ys) -> SMC2Result:
        return smc2_core(key, ys, model, n_theta, n_x, proposal,
                         ess_threshold, inner_resampling, inner_impl,
                         _RankRows(n_theta, mesh, axis_name))

    return run
