"""Data-annealed SMC: condition a model on its observations one
constraint group at a time, with adaptive resampling and optional MCMC
rejuvenation between the steps, for any model, through the GFI
(counterpart of ``genjax_tpu/inference/data_smc.py``).

The incremental weight of assimilating the group C_t on a particle is
``log p(C_t | rest)``: the ``Update`` edit weight plus the prior draws'
site scores at the newly constrained addresses.

The particles are one key batch of ``K`` (the model's arguments lifted
to it). The JAX package resamples on every step and selects with
``where``; here the ESS test is a Python ``if`` (one host sync a step),
so resampling, and the CDF kernel on the card, runs only when it is
taken. The ensemble-invariant leaves (zero-stride views) are not moved.
"""

from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple, Sequence

import torch

from genjax_torch.core import random
from genjax_torch.gfi.choice_map import ChoiceMap, lift_values
from genjax_torch.gfi.concepts import EditRequest
from genjax_torch.gfi.gfn import GenerativeFunction
from genjax_torch.gfi.requests import Update
from genjax_torch.inference.mcmc import select_accept
from genjax_torch.inference.smc import (
    _step_keys,
    effective_sample_size,
    invariant_leaf_mask,
    resample_tree,
)
from genjax_torch.inference.trace_pf import _lift_args

__all__ = ["data_annealed_smc", "DataSMCResult"]


class DataSMCResult(NamedTuple):
    traces: Any
    log_weights: torch.Tensor
    log_z: torch.Tensor
    ess_history: torch.Tensor
    accept_rate: torch.Tensor
    n_resamples: int       # resampling steps taken (host count)


def data_annealed_smc(
    model: GenerativeFunction,
    model_args: tuple,
    schedule: Sequence[ChoiceMap],
    n_particles: int,
    make_request: Callable[[], EditRequest] | None = None,
    n_moves: int = 0,
    ess_threshold: float = 0.5,
    resampling: str = "systematic",
):
    """Build ``run(key) -> DataSMCResult``.

    ``schedule``: the observation constraints, one group per step (each
    may constrain different addresses). ``make_request`` / ``n_moves``:
    optional rejuvenation moves, MH-corrected (the request's weight is
    the log acceptance ratio at the current partial posterior)."""
    k = n_particles
    log_k = math.log(k)

    def run(key) -> DataSMCResult:
        dev = key.device
        lanes = torch.arange(k, device=dev)
        k_init, k_anneal = random.split(key).unbind(-2)
        trs = model.simulate(random.fold_in(k_init, lanes),
                             _lift_args(model_args, k, dev))
        invariant = invariant_leaf_mask(trs)
        lw = torch.zeros(k, device=dev)
        log_z = torch.zeros((), device=dev)
        ess_hist, accepts, n_resamples = [], [], 0
        step_keys = _step_keys(k_anneal, len(schedule), 3)
        for t, constraint in enumerate(schedule):
            k_res, k_edit, k_move = step_keys[t].unbind(-2)
            sel = constraint.get_selection()
            ess = effective_sample_size(lw)
            ess_hist.append(ess)
            if bool(ess < ess_threshold * k):
                trs = resample_tree(k_res, lw, trs, k, resampling,
                                    invariant=invariant)
                n_resamples += 1
                log_z = log_z + torch.logsumexp(lw, 0) - log_k
                lw = torch.zeros_like(lw)
            # Assimilate: constrain the group; the increment is the edit
            # weight plus the discarded prior draws' site scores.
            pk_e, pk_p = random.split(random.fold_in(k_edit, lanes)).unbind(-2)
            old_site = trs.project(pk_p, sel)
            trs, w, _, _ = trs.edit(pk_e,
                                    Update(lift_values(constraint, (k,), dev)))
            lw = lw + (w + old_site)
            acc_tot = torch.zeros((), device=dev)
            if make_request is not None and n_moves > 0:
                for m in range(n_moves):
                    pk_e, pk_a = random.split(random.fold_in(
                        random.fold_in(k_move, m), lanes)).unbind(-2)
                    new_tr, w, _, _ = trs.edit(pk_e, make_request())
                    accept = torch.log(random.uniform(pk_a, ())) < w
                    trs = select_accept(accept, new_tr, trs, invariant)
                    acc_tot = acc_tot + accept.float().mean()
                acc_tot = acc_tot / n_moves
            accepts.append(acc_tot)
        log_z = log_z + torch.logsumexp(lw, 0) - log_k
        return DataSMCResult(trs, lw, log_z, torch.stack(ess_hist),
                             torch.stack(accepts), n_resamples)

    return run
