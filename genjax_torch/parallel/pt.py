"""Parallel tempering with its rung axis sharded over a mesh axis (the
counterpart of ``genjax_tpu/inference/pt.py`` run under a sharding
constraint on the replicas, ``tests/parallel/test_sharded_pt.py``).

JAX lays the rungs over the devices and lowers the swap phase's roll and
select to neighbour collectives. Here each rank holds its rungs of every
ladder (the ladders stay a batch on every rank) and runs
:func:`~genjax_torch.inference.pt.pt_core` on them:

- rung keys are ``fold_in`` of the global rung index, so the MH moves are
  rank-local and bit for bit the unsharded run's;
- the swap phase extends the rank's rungs by one ghost rung on each side,
  the neighbours' boundary rungs (log-likelihood and whole trace) brought
  by ``collectives.shift`` both ways. Both ranks of a pair that straddles
  a boundary compute the same decision from the same values and the
  global swap uniforms; ``_pair_swap`` on the extended rungs serves the
  pairs inside a rank and the boundary pairs alike. Only phases in which
  a boundary pair can swap exchange anything;
- the cold chain lives on the last rank, which broadcasts its samples;
  the swap counts are integers, gathered whole.

No float reduction crosses rungs, so every rank's rungs, the samples and
both rates are bit for bit the unsharded run's in every world size.
"""

from __future__ import annotations

from typing import Any, Callable

import torch
import torch.distributed as dist

from genjax_torch.core.pytree import tree_flatten, tree_map, tree_unflatten
from genjax_torch.gfi.concepts import EditRequest
from genjax_torch.inference.pt import (
    ParallelTemperingResult,
    _lift,
    _pair_swap,
    _setup,
    pt_core,
)
from genjax_torch.inference.sp import Target
from genjax_torch.inference.transforms import tree_device
from genjax_torch.parallel.collectives import _wire, all_gather, comm, shift
from genjax_torch.parallel.mesh import DeviceMesh, mesh_axis, rank_range

__all__ = ["sharded_parallel_tempering"]


class _RankRungs:
    """This rank's rungs, for :func:`pt_core`."""

    def __init__(self, n_rungs: int, mesh: DeviceMesh, axis_name):
        self.ax = mesh_axis(mesh, axis_name)
        self.lo, self.hi = rank_range(n_rungs, mesh, axis_name)
        self.n_rungs = n_rungs

    def _boundary_active(self, t: int) -> bool:
        """Whether some boundary pair ``(d·per − 1, d·per)`` leads in this
        phase: the same answer on every rank."""
        per = self.hi - self.lo
        return self.ax.size > 1 and (per % 2 == 1 or t % 2 == 1)

    def swap(self, t: int, leader, us, dbeta_up, logliks, trs, axis: int):
        lo, hi = self.lo, self.hi

        # The extended rungs [lo − 1, hi + 1) along the last axis: the
        # whole ladder's leader mask, uniforms (one row a ladder) and β
        # steps there, no rung outside [0, R) and no pair led by the
        # right ghost.
        def window(x, fill):
            pad = torch.full_like(x[..., :1], fill)
            left = x[..., lo - 1:lo] if lo > 0 else pad
            return torch.cat([left, x[..., lo:hi], pad], dim=-1)

        leader_e = window(leader, False)
        us_e = window(us, 1.0)
        dbeta_e = window(dbeta_up, 0.0)
        leaves, spec = tree_flatten(trs)
        moving = [i for i, v in enumerate(leaves)
                  if isinstance(v, torch.Tensor)]
        edges = [logliks] + [leaves[i] for i in moving]
        first = [v.narrow(axis, 0, 1) for v in edges]
        last = [v.narrow(axis, v.shape[axis] - 1, 1) for v in edges]
        if self._boundary_active(t):
            # Left ghost: the left neighbour's last rung; right ghost: the
            # right neighbour's first. Rank 0's left and the last rank's
            # right come round the ring and are never read.
            left = shift(last, self.ax, 1, "pt_boundary")
            right = shift(first, self.ax, -1, "pt_boundary")
        else:
            # No boundary pair leads in this phase: the ghosts are never
            # read, and the rank's own edge rungs stand in for them.
            left, right = last, first
        ext = [torch.cat([a, v, b], dim=axis)
               for a, v, b in zip(left, edges, right)]
        ll_e = ext[0]
        log_alpha = dbeta_e * (ll_e - torch.roll(ll_e, -1, dims=axis))
        acc_e = leader_e & (torch.log(us_e) < log_alpha)
        inner = [v.narrow(axis, 1, v.shape[axis] - 2)
                 for v in _pair_swap(ext, acc_e)]
        out = list(leaves)
        for i, v in zip(moving, inner[1:]):
            out[i] = v
        return (tree_unflatten(out, spec), inner[0],
                acc_e.narrow(acc_e.ndim - 1, 1, acc_e.shape[-1] - 2))

    def swap_totals(self, swap_sum, n_att, axis: int):
        def whole(x):
            # The rung axis to the front, gathered in rank order, and back.
            g = all_gather(x.movedim(axis, 0).contiguous(), self.ax,
                           "pt_swaps")
            return g.movedim(0, axis)[..., :-1]

        return whole(swap_sum), whole(n_att)

    def cold(self, samples):
        src = self.ax.global_rank(self.ax.size - 1)

        def bcast(v):
            if not isinstance(v, torch.Tensor):
                return v
            w = _wire(v).clone()
            comm.add("broadcast", "pt_cold", w)
            dist.broadcast(w, src=src, group=self.ax.group)
            return w.to(v.dtype)

        return tree_map(bcast, samples)


def sharded_parallel_tempering(target: Target, betas, mesh: DeviceMesh,
                               axis_name="particles",
                               make_request: Callable[[], EditRequest]
                               | None = None,
                               n_moves: int = 1):
    """Build ``run(key, n_steps, collect=None, burn_in=0) ->
    ParallelTemperingResult`` over this rank's rungs of
    ``mesh[axis_name]``: ``traces`` and ``accept_rate`` hold the rank's
    rungs (``L + (R / D,)``); ``samples`` (the cold chain's) and
    ``swap_rate`` (``L + (R − 1,)``) are whole on every rank. Arguments
    as :func:`~genjax_torch.inference.pt.parallel_tempering`'s; the
    result is bit for bit its run's, sliced by rank. The rung count must
    divide over the ranks."""
    betas, make_request, loglik_of = _setup(target, betas, make_request)
    n_rungs = betas.shape[0]

    def run(key, n_steps: int, *, collect: Callable[[Any], Any] | None = None,
            burn_in: int = 0) -> ParallelTemperingResult:
        rungs = _RankRungs(n_rungs, mesh, axis_name)
        batch = tuple(key.shape[:-1]) + (rungs.hi - rungs.lo,)
        lifted = _lift(target, batch,
                       tree_device((target.args, target.constraint))
                       or key.device)
        return pt_core(lifted, betas, make_request, n_moves, loglik_of,
                       key, n_steps, collect, burn_in, rungs)

    return run
