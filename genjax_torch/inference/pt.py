"""Parallel tempering (replica exchange) over a temperature ladder, on
the GFI edit machinery (counterpart of ``genjax_tpu/inference/pt.py``).

Replica ``r`` targets ``π_β ∝ p(z)·L(z)^β`` for an ascending ladder
ending at ``β = 1`` (the posterior). Each step runs a within-temperature
MH move per replica, by the tempered acceptance
``α_β = w + (β − 1)·Δloglik`` of a reversible edit whose weight is the
full posterior's log-ratio, then exchanges adjacent replicas with
``log α = (β_{r+1} − β_r)·(loglik_r − loglik_{r+1})``, even pairs on even
steps and odd pairs on odd steps.

The replicas are written out as a batch: a key ``L + (2,)`` runs ``L``
independent ladders, and every leaf of the replica traces leads with
``L + (R,)``. The swap is a roll and a select along the rung axis; the
steps are a Python loop.
"""

from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple

import torch

from genjax_torch.core import random
from genjax_torch.core.pytree import tree_map
from genjax_torch.gfi.choice_map import ChoiceMap, lift_values
from genjax_torch.gfi.concepts import EditRequest
from genjax_torch.inference.mcmc import select_accept
from genjax_torch.inference.smc import _particle_leaves
from genjax_torch.inference.sp import Target
from genjax_torch.inference.transforms import tree_device

__all__ = ["ParallelTemperingResult", "parallel_tempering"]


class ParallelTemperingResult(NamedTuple):
    traces: Any                # final replica traces (batch L + (R,))
    samples: Any               # collected cold-chain values, L + (n_keep,)
    accept_rate: torch.Tensor  # L + (R,) within-temperature acceptance
    swap_rate: torch.Tensor    # L + (R - 1,) adjacent-pair swap acceptance


def _bcast(mask: torch.Tensor, leaf: torch.Tensor) -> torch.Tensor:
    return mask.reshape(tuple(mask.shape) + (1,) * (leaf.ndim - mask.ndim))


def _pair_swap(tree, leader_acc: torch.Tensor):
    """Swap rungs ``r <-> r+1`` of every leaf wherever
    ``leader_acc[..., r]`` holds (leaders never overlap: one phase at a
    time). The rung axis is ``leader_acc``'s last."""
    axis = leader_acc.ndim - 1
    follower = torch.roll(leader_acc, 1, dims=axis)

    def leafwise(v):
        if not isinstance(v, torch.Tensor):
            return v
        down = torch.roll(v, -1, dims=axis)      # value of replica r+1
        up = torch.roll(v, 1, dims=axis)         # value of replica r-1
        out = torch.where(_bcast(leader_acc, v), down, v)
        return torch.where(_bcast(follower, v), up, out)

    return tree_map(leafwise, tree)


def _lift(target: Target, batch: tuple, device) -> Target:
    """``target`` with its tensor arguments and constraint values given
    the batch ``batch`` in front, as zero-stride views."""
    args = tree_map(lambda v: v.expand(batch + tuple(v.shape))
                    if isinstance(v, torch.Tensor) else v, target.args)
    return Target(target.p, args,
                  lift_values(target.constraint, batch, device))


class WholeLadder:
    """Every rung of the ladder is here. A sharded run
    (``parallel/pt.py``) gives :func:`pt_core` its rank's rungs in an
    object with the same members, and nothing else changes."""

    def __init__(self, n_rungs: int):
        self.lo, self.hi = 0, n_rungs

    def swap(self, t: int, leader, us, dbeta_up, logliks, trs, axis: int):
        """One swap phase over the local rungs: ``(trs, logliks,
        leader_acc)`` after it. ``leader``, ``us`` and ``dbeta_up`` are
        the whole ladder's."""
        ll_next = torch.roll(logliks, -1, dims=axis)
        log_alpha = dbeta_up * (logliks - ll_next)
        leader_acc = leader & (torch.log(us) < log_alpha)
        return (_pair_swap(trs, leader_acc), _pair_swap(logliks, leader_acc),
                leader_acc)

    def swap_totals(self, swap_sum, n_att, axis: int):
        """The pairs' swap counts over the whole ladder, ``L + (R - 1,)``,
        from the local rungs' counts (rung ``r`` counts pair ``(r,
        r + 1)``)."""
        return swap_sum[..., :-1], n_att[..., :-1]

    def cold(self, samples):
        """The cold chain's collected values, on every rank."""
        return samples


def pt_core(lifted: Target, betas: torch.Tensor, make_request: Callable,
            n_moves: int, loglik_of: Callable, key, n_steps: int,
            collect, burn_in: int, rungs) -> ParallelTemperingResult:
    """One parallel-tempering run over the rungs ``[rungs.lo, rungs.hi)``
    (see :class:`WholeLadder`): :func:`parallel_tempering`'s run, and each
    rank's part of ``parallel.sharded_parallel_tempering``. Keys, swap
    uniforms and swap decisions are the whole ladder's, so a rank's rungs
    are bit for bit those rungs of the unsharded run."""
    dev = key.device
    n_rungs = betas.shape[0]
    lo, hi = rungs.lo, rungs.hi
    ladders = tuple(key.shape[:-1])
    axis = len(ladders)
    batch = ladders + (hi - lo,)
    bs = betas.to(dev)
    r_iota = torch.arange(n_rungs, device=dev)
    # Pair leaders of the two phases: even (0,1),(2,3),... and odd
    # (1,2),(3,4),...; the top rung never leads.
    leader_masks = torch.stack([
        (r_iota % 2 == p) & (r_iota < n_rungs - 1) for p in (0, 1)])
    dbeta_up = torch.cat([bs[1:] - bs[:-1], bs.new_zeros(1)])
    local = r_iota[lo:hi]

    def per_rung(k):
        return random.fold_in(k.unsqueeze(-2), local)

    k_init, k_steps = random.split(key).unbind(-2)
    init_keys = per_rung(k_init)
    trs, _ = lifted.importance(init_keys, ChoiceMap.empty())
    trs = _particle_leaves(trs, batch, dev)
    logliks = loglik_of(init_keys, trs)
    outs, accs, swaps = [], [], []
    for t in range(n_steps):
        k_move, k_swap = random.split(random.fold_in(k_steps, t)
                                      ).unbind(-2)
        acc = torch.zeros(batch, device=dev)
        for m in range(n_moves):
            pk_e, pk_l, pk_a = random.split(
                per_rung(random.fold_in(k_move, m)), 3).unbind(-2)
            new_tr, w, _, _ = trs.edit(pk_e, make_request())
            new_tr = _particle_leaves(new_tr, batch, dev)
            new_ll = loglik_of(pk_l, new_tr)
            alpha = w + (bs[lo:hi] - 1.0) * (new_ll - logliks)
            accept = torch.log(random.uniform(pk_a, ())) < alpha
            trs = select_accept(accept, new_tr, trs)
            logliks = torch.where(accept, new_ll, logliks)
            acc = acc + accept.to(torch.float32)
        leader = leader_masks[t % 2]
        us = random.uniform(k_swap, (n_rungs,))
        trs, logliks, leader_acc = rungs.swap(t, leader, us, dbeta_up,
                                              logliks, trs, axis)
        if t >= burn_in and collect is not None:
            cold = tree_map(lambda v: v.select(axis, hi - lo - 1)
                            if isinstance(v, torch.Tensor) else v, trs)
            outs.append(collect(cold))
        accs.append(acc / n_moves)
        swaps.append(torch.where(leader[lo:hi], leader_acc
                                 .to(torch.float32), math.nan))
    samples = (rungs.cold(tree_map(lambda *vs: torch.stack(vs, dim=axis),
                                   *outs))
               if outs else None)
    swaps = torch.stack(swaps)
    attempted = torch.isfinite(swaps)
    swap_sum, n_att = rungs.swap_totals(
        torch.where(attempted, swaps, 0.0).sum(0), attempted.sum(0), axis)
    swap_rate = torch.where(n_att > 0,
                            swap_sum / torch.clamp(n_att, min=1),
                            math.nan)
    return ParallelTemperingResult(trs, samples,
                                   torch.stack(accs).mean(0), swap_rate)


def _setup(target: Target, betas, make_request):
    """The ladder as a tensor, the move request and the likelihood
    projection, checked as :func:`parallel_tempering` takes them."""
    if isinstance(betas, int):
        betas = torch.linspace(0.0, 1.0, betas)
    betas = torch.as_tensor(betas, dtype=torch.float32)
    if betas.shape[0] < 2:
        raise ValueError("parallel tempering needs at least 2 rungs")
    lik_sel = target.constraint.get_selection()

    if make_request is None:
        from genjax_torch.gfi.requests import Regenerate

        unconstrained = ~lik_sel

        def make_request():
            return Regenerate(unconstrained)

    def loglik_of(key, tr):
        return tr.get_gen_fn().project(key, tr, lik_sel)

    return betas, make_request, loglik_of


def parallel_tempering(target: Target, betas,
                       make_request: Callable[[], EditRequest] | None = None,
                       n_moves: int = 1):
    """Build ``run(key, n_steps, collect=None, burn_in=0) ->
    ParallelTemperingResult``.

    ``betas``: the ascending ladder, its last entry 1.0 (the cold chain,
    whose samples are collected); an int gives a linear ladder of that
    many rungs from 0 to 1. ``make_request``: the within-temperature
    move (default ``Regenerate`` of every unconstrained address);
    ``n_moves`` MH moves a replica a step."""
    betas, make_request, loglik_of = _setup(target, betas, make_request)
    n_rungs = betas.shape[0]

    def run(key, n_steps: int, *, collect: Callable[[Any], Any] | None = None,
            burn_in: int = 0) -> ParallelTemperingResult:
        batch = tuple(key.shape[:-1]) + (n_rungs,)
        lifted = _lift(target, batch,
                       tree_device((target.args, target.constraint))
                       or key.device)
        return pt_core(lifted, betas, make_request, n_moves, loglik_of,
                       key, n_steps, collect, burn_in, WholeLadder(n_rungs))

    return run
