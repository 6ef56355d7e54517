"""Trace-level particle filtering: condition a scanned generative model on
its observations one time step at a time, entirely through the GFI
(counterpart of ``genjax_tpu/inference/trace_pf.py``). Each assimilation
is an ``IndexRequest`` repair of one step on the Scan fast path, so the
filter is O(T) like a hand-written one, and the particles are the
model's traces.

The particles are one key batch of ``K`` (the model's arguments and each
step's observation lifted to it). ``lax.scan`` over time becomes a
Python loop with a Python ``t``, and the resampling ``lax.cond`` a
Python ``if`` on the ESS (one host sync a step). Resampling goes through
``resample_tree``, so through the CDF kernel on the card; the
ensemble-invariant leaves (the lifted arguments, zero-stride views) are
not moved (the JAX package finds them by taint analysis).
"""

from __future__ import annotations

import math
from typing import Any, NamedTuple

import torch

from genjax_torch.core import random
from genjax_torch.core.pytree import tree_leaves, tree_map
from genjax_torch.gfi.choice_map import ChoiceMap
from genjax_torch.gfi.concepts import IndexRequest
from genjax_torch.gfi.requests import Regenerate, Update
from genjax_torch.gfi.selection import Selection
from genjax_torch.inference.smc import (
    _step_keys,
    _lift,
    effective_sample_size,
    invariant_leaf_mask,
    resample_tree,
)

__all__ = ["trace_particle_filter", "TracePFResult"]


class TracePFResult(NamedTuple):
    traces: Any            # particle traces (leading axis K), conditioned
    log_weights: torch.Tensor
    log_z: torch.Tensor
    ess_history: torch.Tensor
    n_resamples: int       # resampling steps taken (host count)


def _lift_args(args, k: int, device):
    """The model's arguments for ``k`` particles: every value a
    zero-stride view with the particle axis in front."""
    return tree_map(lambda v: _lift(v, (), k, device), args)


def trace_particle_filter(
    scan_model,
    model_args: tuple,
    obs_address: str,
    observations: torch.Tensor,
    n_particles: int,
    ess_threshold: float = 0.5,
    resampling: str = "systematic",
    refresh_future: bool = False,
):
    """Build ``run(key) -> TracePFResult`` for a ``Scan`` model whose step
    records an observation at ``(t, obs_address)``.

    Each step ``t``: resample adaptively, then constrain step ``t``'s
    observation with ``IndexRequest(t, Update(...))`` on every particle
    (the increment is the edit weight plus the discarded prior draw's
    site score). ``refresh_future=True``: after each resampling,
    ``Regenerate`` every step after ``t − 1`` (a weight-0 prior refresh
    of the cloned futures), which makes the filter exactly the bootstrap
    filter, at O(T) extra work a step."""
    k = n_particles
    n_steps = tree_leaves(observations)[0].shape[0]
    log_k = math.log(k)

    def run(key) -> TracePFResult:
        dev = key.device
        lanes = torch.arange(k, device=dev)
        k_init, k_scan = random.split(key).unbind(-2)
        trs = scan_model.simulate(random.fold_in(k_init, lanes),
                                  _lift_args(model_args, k, dev))
        invariant = invariant_leaf_mask(trs)
        lw = torch.zeros(k, device=dev)
        log_z = torch.zeros((), device=dev)
        ess_hist, n_resamples = [], 0
        step_keys = _step_keys(k_scan, n_steps, 3)
        for t in range(n_steps):
            k_res, k_refresh, k_edit = step_keys[t].unbind(-2)
            ess = effective_sample_size(lw)
            ess_hist.append(ess)
            if bool(ess < ess_threshold * k):
                trs = resample_tree(k_res, lw, trs, k, resampling,
                                    invariant=invariant)
                n_resamples += 1
                if refresh_future:
                    trs, _, _, _ = trs.edit(
                        random.fold_in(k_refresh, lanes),
                        Regenerate(Selection.idx_above(t - 1)))
                log_z = log_z + torch.logsumexp(lw, 0) - log_k
                lw = torch.zeros_like(lw)
            old_y = (trs.get_inner_trace(t).get_inner_trace(obs_address)
                     .get_score())
            obs_t = _lift(torch.as_tensor(observations[t], device=dev), (),
                          k, dev)
            trs, w, _, _ = trs.edit(
                random.fold_in(k_edit, lanes),
                IndexRequest(t, Update(ChoiceMap.entry(obs_t, obs_address))))
            lw = lw + (w + old_y)
        log_z = log_z + torch.logsumexp(lw, 0) - log_k
        return TracePFResult(trs, lw, log_z, torch.stack(ess_hist),
                             n_resamples)

    return run
