"""SVGD with the particle axis of the Stein ensemble spread over a mesh
axis (counterpart of ``genjax_tpu/parallel/svgd.py``).

Every particle's update reads every other particle, but what moves
between ranks is only the (N, D) positions and score gradients, never
the (N, N) kernel matrix. Each rank computes the gradients of its rows,
all-gathers positions and gradients (two all-gathers of N·D floats a
step), and contracts its local (n/D, N) kernel rows against the gathered
arrays. The bandwidth is the median heuristic over a fixed strided
subsample of about ``h_rows``² pairs of the gathered positions, by the
port's ``inference/svgd._rbf_phi(h_rows=...)``'s own Gram-form distances,
replicated on every rank.

Layout independence: the local rows are processed in chunks of a
layout-free row count (``collectives._layout_free_block`` of N), one
batch entry each of two batched products, so each distance and each
kernel sum is a product of one shape, and so of the same bits, whatever
the rank count; every other reduction runs on replicated data of a
layout-free shape. The update is bitwise equal on
every power-of-two layout, given a log-density whose per-particle
gradient does not depend on how many particles share the call.
"""

from __future__ import annotations

import math
from typing import Callable

import torch

from genjax_torch.core.fixed_sum import tree_sum
from genjax_torch.inference.requests.nuts import value_and_grad
from genjax_torch.inference.svgd import _median, _sq_dists
from genjax_torch.parallel.collectives import _layout_free_block, all_gather
from genjax_torch.parallel.mesh import DeviceMesh, mesh_axis

__all__ = ["sharded_svgd_step", "run_sharded_svgd"]

#: The cap of the layout-free row chunk of the local kernel block.
ROW_CHUNK_CAP = 256


def _phi_block(xs_loc, xs_all, grads_all, h_rows: int):
    """This rank's rows of the SVGD direction, given the gathered (N, D)
    positions and gradients. Positions are first centred on the
    ensemble's mean (a fixed tree over the gathered rows, the same on
    every rank): distances and ``Σ_j k_ij (x_i − x_j)`` are unchanged, but
    the repulsion's ``k_sums·x_i − Σ_j k_ij x_j`` and the Gram form's
    ``|x|²`` no longer cancel digits of the ensemble's offset from 0. The
    rows go in chunks of a layout-free count R, each chunk one entry of
    two batched products, (R, D) x (D, N) for the distances and
    (R, N) x (N, 2D + 1) for the kernel sums: every product has the same
    shape in every layout."""
    n, dim = xs_all.shape
    centre = tree_sum(xs_all.T) / n
    xs_all, xs_loc = xs_all - centre, xs_loc - centre
    stride = max(1, n // min(h_rows, n))
    med2 = _median(_sq_dists(xs_all[::stride]))
    h = torch.clamp(med2 / math.log(n + 1.0), min=1e-6)
    rhs = torch.cat([xs_all, grads_all,
                     torch.ones_like(xs_all[:, :1])], 1)   # (N, 2D + 1)
    chunk = _layout_free_block(n, ROW_CHUNK_CAP)
    xc = xs_loc.reshape(-1, chunk, dim)                    # (nc, R, D)
    nc = xc.shape[0]
    gram = torch.bmm(xc, xs_all.T.expand(nc, dim, n))
    sq = (xs_all * xs_all).sum(-1)
    d2 = torch.clamp((xc * xc).sum(-1)[..., None] - 2.0 * gram + sq,
                     min=0.0)
    kr = torch.bmm(torch.exp(-d2 / h), rhs.expand(nc, n, 2 * dim + 1))
    kr = kr.reshape(-1, 2 * dim + 1)
    repulse = (2.0 / h) * (kr[:, -1:] * xs_loc - kr[:, :dim])
    return (kr[:, dim:2 * dim] + repulse) / n


def _local_phi(logdensity_fn, xs_loc, ax, h_rows: int):
    """The rank's SVGD direction: local gradients, one all-gather each of
    positions and gradients, the local kernel rows."""
    _, grads_loc = value_and_grad(logdensity_fn)(xs_loc)
    xs_all = all_gather(xs_loc, ax, "positions")
    grads_all = all_gather(grads_loc, ax, "gradients")
    return _phi_block(xs_loc, xs_all, grads_all, h_rows)


def sharded_svgd_step(
    logdensity_fn: Callable[[torch.Tensor], torch.Tensor],
    xs: torch.Tensor,
    step_size: float,
    mesh: DeviceMesh,
    axis_name="particles",
    h_rows: int = 256,
) -> torch.Tensor:
    """One SVGD update of this rank's rows ``xs`` (N/D, D) of an (N, D)
    ensemble. ``logdensity_fn`` maps ``(n, D)`` positions to their
    ``(n,)`` log-densities; ``h_rows`` rows feed the bandwidth (clamped to
    N)."""
    ax = mesh_axis(mesh, axis_name)
    return xs + step_size * _local_phi(logdensity_fn, xs, ax, h_rows)


def run_sharded_svgd(
    logdensity_fn: Callable[[torch.Tensor], torch.Tensor],
    xs0: torch.Tensor,
    n_steps: int,
    step_size: float,
    mesh: DeviceMesh,
    axis_name="particles",
    h_rows: int = 256,
) -> torch.Tensor:
    """Fit a sharded ensemble: ``n_steps`` AdaGrad-normalized sharded SVGD
    updates of this rank's rows ``xs0`` (the normalizer of
    ``inference.run_svgd``; its accumulator is sharded with the rows)."""
    ax = mesh_axis(mesh, axis_name)
    xs, acc = xs0, torch.zeros_like(xs0)
    for _ in range(n_steps):
        phi = _local_phi(logdensity_fn, xs, ax, h_rows)
        acc = 0.9 * acc + 0.1 * phi * phi
        xs = xs + step_size * phi / (1e-6 + torch.sqrt(acc))
    return xs
