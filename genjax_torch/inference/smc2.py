"""SMC²: sequential joint inference over the parameters AND states of a
state-space model (Chopin, Jacob & Papaspiliopoulos 2013; counterpart of
``genjax_tpu/inference/smc2.py``).

N_θ parameter particles each carry an N_x-particle bootstrap filter; at
each observation the θ-weights take the filters' incremental likelihood
estimates, and when the θ-ensemble degenerates it is resampled and every
lane is rejuvenated by a PMMH move: a fresh inner filter re-run over the
prefix, so the move is an exact MH kernel.

The state ensemble is an ``(N_θ, N_x)`` grid, and the θ axis leads every
call of the model (the batched mode of ``pf.particle_filter``):

- ``init_sampler(keys (N_θ, 2), θ, n) -> (N_θ, n, ...)`` states;
- ``propagate(keys (N_θ, 2), θ, xs) -> xs_next``;
- ``loglik(θ, xs, y) -> (N_θ, n)``;
- ``prior_sample(keys (N_θ, 2)) -> θ``; ``log_prior(θ) -> (N_θ,)``;

θ is any pytree whose leaves lead with N_θ. Row ``j`` gets the key JAX's
vmapped call gives lane ``j``, so ``random.normal(keys, (n,))`` is row for
row the JAX package's draw.

``lax.scan`` over time becomes a Python loop; the rejuvenation
``lax.cond`` becomes a Python ``if`` on the θ-ESS (one host sync a step,
as in ``pf.py``), and the PMMH re-run (``fori_loop(1, t)``) a loop of
``t − 1`` steps over all θ rows at once. Each loop's keys are derived
for all its steps at once before it (the same key data as a
``fold_in`` and a ``split`` a step).
"""

from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple

import torch

from genjax_torch.core import random
from genjax_torch.core.pytree import tree_leaves, tree_map
from genjax_torch.inference.pmmh import _where, gaussian_walk_proposal
from genjax_torch.inference.smc import (
    _step_keys,
    _take,
    effective_sample_size,
    resample_indices,
    resample_indices_rows,
    resample_indices_sorted,
    resample_values,
    resample_values_rows,
)

__all__ = ["SMC2Result", "smc2"]


class SMC2Result(NamedTuple):
    thetas: Any                # (N_theta, ...) final parameter particles
    log_weights: torch.Tensor  # (N_theta,) final theta log-weights
    log_z: torch.Tensor        # model evidence estimate log p(y_{1:T})
    ess_history: torch.Tensor  # (T-1,) theta-ESS before assimilating y_t
    rejuv_accept: torch.Tensor  # mean PMMH acceptance over fired moves
    n_rejuvenations: int       # rejuvenations fired (host count)


def _gather_rows(tree, idx: torch.Tensor):
    """Row ``idx[j]`` of every leaf (the θ axis leads)."""
    return tree_map(lambda v: v[idx], tree)


def _lse_mean(lw: torch.Tensor) -> torch.Tensor:
    return torch.logsumexp(lw, dim=-1) - math.log(lw.shape[-1])


class WholeRows:
    """The θ-rows of an unsharded run: every row is here. A sharded run
    (``parallel/smc2.py``) gives :func:`smc2_core` its rank's rows in an
    object with the same four members, and nothing else changes."""

    def __init__(self, n_theta: int):
        self.lo, self.hi = 0, n_theta

    def all_weights(self, w: torch.Tensor) -> torch.Tensor:
        """The whole θ-weight vector from this rank's rows."""
        return w

    def take(self, tree, anc: torch.Tensor):
        """This rank's rows of ``tree[anc]`` (``anc``: every row's
        ancestor, the same on every rank)."""
        return _gather_rows(tree, anc)

    def total(self, count: torch.Tensor) -> torch.Tensor:
        """An integer count summed over the ranks."""
        return count


def smc2_core(key, ys, model: tuple, n_theta: int, n_x: int,
              proposal: Callable, ess_threshold: float,
              inner_resampling: str, inner_impl: str, rows) -> SMC2Result:
    """One SMC² run over the θ-rows ``[rows.lo, rows.hi)`` (see
    :class:`WholeRows`): :func:`smc2`'s run, and each rank's part of
    ``parallel.sharded_smc2``. Keys, grid draws and the θ-level decisions
    are the whole run's, so a rank's rows are bit for bit those rows of
    the unsharded run."""
    init_sampler, propagate, loglik, prior_sample, log_prior = model
    impl = inner_impl
    if impl == "auto":
        impl = "sort" if key.device.type == "cpu" else "fused"
    use_fused = impl == "fused" and inner_resampling == "systematic"

    def inner_resample(k_res, lw, xs):
        """Each θ row resampled on its own key."""
        if use_fused:
            return resample_values(k_res, lw, xs, n_x)
        anc = resample_indices_sorted(k_res, lw, n_x,
                                      method=inner_resampling)
        return tree_map(lambda v: _take(v, anc, 1), xs)

    def inner_filter(keys, theta, n_steps: int):
        """Bootstrap filters for every θ row over ``ys[0..n_steps-1]``:
        ``(xs, lw, logZ)``."""
        k0, ks = random.split(keys).unbind(-2)
        xs = init_sampler(k0, theta, n_x)
        lw = loglik(theta, xs, tree_map(lambda v: v[0], ys))
        logz = _lse_mean(lw)
        step_keys = _step_keys(ks, n_steps, 2)
        for s in range(1, n_steps):
            k_res, k_prop = step_keys[:, s].unbind(-2)
            xs = propagate(k_prop, theta, inner_resample(k_res, lw, xs))
            lw = loglik(theta, xs, tree_map(lambda v: v[s], ys))
            logz = logz + _lse_mean(lw)
        return xs, lw, logz

    dev = key.device
    n_steps = tree_leaves(ys)[0].shape[0]
    lo, hi = rows.lo, rows.hi
    local = torch.arange(lo, hi, device=dev)
    k_prior, k_init, k_scan = random.split(key, 3).unbind(-2)
    thetas = prior_sample(random.fold_in(k_prior, local))
    xs = init_sampler(random.fold_in(k_init, local), thetas, n_x)
    lw_x = loglik(thetas, xs, tree_map(lambda v: v[0], ys))
    logz_th = _lse_mean(lw_x)
    w_th = logz_th
    log_z = torch.zeros((), device=dev)
    acc = torch.zeros((), dtype=torch.int64, device=dev)
    acc_n = 0
    ess_hist = []
    step_keys = _step_keys(k_scan, n_steps, 4)
    for t in range(1, n_steps):
        y = tree_map(lambda v: v[t], ys)
        k_resx, k_prop, k_resth, k_rej = step_keys[t].unbind(-2)
        w_all = rows.all_weights(w_th)
        ess = effective_sample_size(w_all)
        ess_hist.append(ess)
        smc2.host_syncs += 1
        if bool(ess < ess_threshold * n_theta):
            # This epoch's normalizer folds into log_z before the
            # weights reset to uniform.
            log_z = log_z + _lse_mean(w_all)
            anc = resample_indices(k_resth, w_all, n_theta,
                                   method="multinomial")
            thetas_r, xs_r, lw_r, logz_r = rows.take(
                (thetas, xs, lw_x, logz_th), anc)
            kp, kf, ka = random.split(
                random.fold_in(k_rej, local), 3).unbind(-2)
            prop_th = proposal(kp, thetas_r)
            xs_p, lw_p, lz_p = inner_filter(kf, prop_th, t)
            log_alpha = (lz_p + log_prior(prop_th) - logz_r
                         - log_prior(thetas_r))
            ok = torch.log(random.uniform(ka, ())) < log_alpha
            thetas = _where(ok, prop_th, thetas_r)
            xs = _where(ok, xs_p, xs_r)
            lw_x = torch.where(ok[:, None], lw_p, lw_r)
            logz_th = torch.where(ok, lz_p, logz_r)
            w_th = torch.zeros_like(w_th)
            acc = acc + ok.sum()
            acc_n += n_theta
        # Advance every inner filter one observation: one batched grid
        # draw for the row resample, one key a row to propagate.
        if use_fused:
            xs_r = resample_values_rows(k_resx, lw_x, xs, n_x, row_offset=lo)
        else:
            anc = resample_indices_rows(k_resx, lw_x, n_x,
                                        method=inner_resampling,
                                        row_offset=lo)
            xs_r = tree_map(lambda v: _take(v, anc, 1), xs)
        xs = propagate(random.split(k_prop, hi - lo, offset=lo), thetas,
                       xs_r)
        lw_x = loglik(thetas, xs, y)
        incr = _lse_mean(lw_x)
        logz_th = logz_th + incr
        w_th = w_th + incr
    log_z = log_z + _lse_mean(rows.all_weights(w_th))
    ess_hist = (torch.stack(ess_hist) if ess_hist
                else torch.zeros(0, device=dev))
    # Acceptances are counted as integers, so their sum over ranks is
    # exact and the rate is the same float everywhere.
    rejuv = (rows.total(acc).to(torch.float32) / acc_n if acc_n
             else torch.zeros((), device=dev))
    return SMC2Result(thetas, w_th, log_z, ess_hist, rejuv, acc_n // n_theta)


def smc2(
    init_sampler: Callable,
    propagate: Callable,
    loglik: Callable,
    prior_sample: Callable,
    log_prior: Callable,
    n_theta: int,
    n_x: int,
    proposal: Callable | float = 0.1,
    ess_threshold: float = 0.5,
    inner_resampling: str = "systematic",
    inner_impl: str = "auto",
):
    """Build ``run(key, ys) -> SMC2Result``.

    ``inner_resampling``: ancestor scheme of the per-θ inner filters
    (``"systematic"`` by default); the θ-resample is multinomial.
    ``inner_impl``: how systematic inner resampling runs — ``"fused"``
    (the values form, :func:`~genjax_torch.inference.smc.resample_values`),
    ``"sort"`` (sorted ancestors and a gather), or ``"auto"``: ``fused``
    on a card and ``sort`` on the CPU, the JAX package's backend rule,
    decided by the device of the run's key. Non-systematic methods always
    take the sort path."""
    if not callable(proposal):
        proposal = gaussian_walk_proposal(proposal)
    if inner_impl not in ("auto", "fused", "sort"):
        raise ValueError(f"unknown inner_impl {inner_impl!r}")
    model = (init_sampler, propagate, loglik, prior_sample, log_prior)

    def run(key, ys) -> SMC2Result:
        return smc2_core(key, ys, model, n_theta, n_x, proposal,
                         ess_threshold, inner_resampling, inner_impl,
                         WholeRows(n_theta))

    return run


#: Host reads of the θ-ESS so far (one a step), the rejuvenation test.
smc2.host_syncs = 0
