"""SMC samplers: tempered SMC with MCMC rejuvenation, its waste-free form,
and annealed importance sampling (counterpart of
``genjax_tpu/inference/smc_sampler.py``).

The sampler anneals from the prior (β = 0) to the posterior (β = 1) on a
linear ladder; at each rung it reweights, resamples adaptively and moves
every particle with an edit request. For a request whose weight is the
full-posterior log-ratio (``Regenerate``), the acceptance for the
tempered target π_β ∝ p(z)·L(z)^β is

    α_β = w_request + (β − 1)·Δ loglik,

``loglik`` the projection of the trace on the constrained addresses.

The particles are one key batch: ``lax.scan`` over rungs and moves
becomes a Python loop, and the ESS test is a Python ``if`` (one host sync
a rung). The ensemble-invariant leaves (the lifted observations) are the
zero-stride ones, skipped by the resample and the accept select. The key
derivations are the JAX package's: ``split(key)`` into init and anneal
keys, ``fold_in(k_init, i)`` per particle, ``fold_in(k_anneal, t)`` split
into resample and move keys, ``fold_in(fold_in(move_key, m), i)`` split
in three per particle.
"""

from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple

import torch

from genjax_torch.core import random
from genjax_torch.core.pytree import tree_flatten, tree_unflatten
from genjax_torch.gfi.choice_map import ChoiceMap
from genjax_torch.gfi.concepts import EditRequest
from genjax_torch.inference.mcmc import select_accept
from genjax_torch.inference.smc import (
    _rows,
    batched_importance,
    effective_sample_size,
    invariant_leaf_mask,
    resample_tree,
)
from genjax_torch.inference.sp import Target

__all__ = ["annealed_importance_sampling", "tempered_smc",
           "waste_free_tempered_smc", "TemperedSMCResult"]


class TemperedSMCResult(NamedTuple):
    traces: Any             # the particles' traces (leading axis K)
    log_weights: torch.Tensor
    log_z: torch.Tensor     # the estimate of log Z = log p(observations)
    accept_rate: torch.Tensor  # mean rejuvenation acceptance per rung


def _default_request(lik_sel, make_request):
    if make_request is not None:
        return make_request
    from genjax_torch.gfi.requests import Regenerate

    unconstrained = ~lik_sel
    return lambda: Regenerate(unconstrained)


def _init(target, n_particles, k_init, loglik_of):
    """The particles from the prior (importance under the target's
    constraints), their logliks and the invariant-leaf mask."""
    dev = k_init.device
    keys = random.fold_in(k_init, torch.arange(n_particles, device=dev))
    trs, _ = batched_importance(target, keys, ChoiceMap.empty())
    logliks = loglik_of(keys, trs)
    return trs, logliks, invariant_leaf_mask((trs, logliks))


def _mh_move(tr, loglik, pk, beta, make_request, loglik_of, invariant):
    """One tempered MH move of every particle, ``pk`` one key each."""
    pk_edit, pk_lik, pk_acc = random.split(pk, 3).unbind(-2)
    new_tr, w, _, _ = tr.edit(pk_edit, make_request())
    new_loglik = loglik_of(pk_lik, new_tr)
    alpha = w + (beta - 1.0) * (new_loglik - loglik)
    accept = torch.log(random.uniform(pk_acc, ())) < alpha
    # The invariant leaves (the observations, which edits keep) are
    # taken from the old trace without a select.
    out_tr = select_accept(accept, new_tr, tr, invariant)
    return out_tr, torch.where(accept, new_loglik, loglik), accept


def tempered_smc(
    target: Target,
    n_particles: int,
    n_temps: int = 20,
    make_request: Callable[[], EditRequest] | None = None,
    n_moves: int = 1,
    ess_threshold: float = 0.5,
    resampling: str = "systematic",
):
    """Build ``run(key) -> TemperedSMCResult`` annealing π_β from β = 0
    to β = 1 over ``n_temps`` rungs. ``make_request``: a thunk returning
    the move (default: ``Regenerate`` of the unconstrained addresses).
    ``ess_threshold`` is a Python number; at 0.0 the resample branch is
    never built (the AIS case)."""
    ess_threshold = float(ess_threshold)
    lik_sel = target.constraint.get_selection()
    make_request = _default_request(lik_sel, make_request)

    def loglik_of(key, tr):
        return tr.get_gen_fn().project(key, tr, lik_sel)

    def run(key) -> TemperedSMCResult:
        dev = key.device
        betas = torch.linspace(0.0, 1.0, n_temps + 1, device=dev)
        k_init, k_anneal = random.split(key).unbind(-2)
        trs, logliks, invariant = _init(target, n_particles, k_init,
                                        loglik_of)
        lw = torch.zeros(n_particles, device=dev)
        log_z = torch.zeros((), device=dev)
        idx = torch.arange(n_particles, device=dev)
        accs = []
        for t in range(n_temps):
            beta_prev, beta = betas[t], betas[t + 1]
            k_res, k_move = random.split(random.fold_in(k_anneal, t)).unbind(-2)
            lw = lw + (beta - beta_prev) * logliks
            if ess_threshold > 0.0 and bool(
                    effective_sample_size(lw) < ess_threshold * n_particles):
                # Traces and their cached logliks are resampled jointly,
                # so that every trace keeps its own loglik.
                trs, logliks = resample_tree(
                    k_res, lw, (trs, logliks), n_particles, resampling,
                    invariant=invariant)
                log_z = (log_z + torch.logsumexp(lw, 0)
                         - math.log(n_particles))
                lw = torch.zeros_like(lw)
            acc = torch.zeros((), device=dev)
            for m in range(n_moves):
                pk = random.fold_in(random.fold_in(k_move, m), idx)
                trs, logliks, accept = _mh_move(
                    trs, logliks, pk, beta, make_request, loglik_of,
                    invariant[0])
                acc = acc + accept.float().mean()
            accs.append(acc / n_moves)
        log_z = log_z + torch.logsumexp(lw, 0) - math.log(n_particles)
        return TemperedSMCResult(trs, lw, log_z, torch.stack(accs))

    return run


def waste_free_tempered_smc(
    target: Target,
    n_resampled: int,
    n_moves_per_particle: int,
    n_temps: int = 20,
    make_request: Callable[[], EditRequest] | None = None,
    resampling: str = "systematic",
):
    """Waste-free SMC (Dau & Chopin 2022) on the temperature ladder: each
    rung resamples M = ``n_resampled`` starters, runs each through P − 1
    = ``n_moves_per_particle`` − 1 MH steps, and keeps all M·P visited
    states as the next, equally weighted, ensemble. Returns
    ``run(key) -> TemperedSMCResult`` over N = M·P particles."""
    m, p = n_resampled, n_moves_per_particle
    n_particles = m * p
    lik_sel = target.constraint.get_selection()
    make_request = _default_request(lik_sel, make_request)

    def loglik_of(key, tr):
        return tr.get_gen_fn().project(key, tr, lik_sel)

    def run(key) -> TemperedSMCResult:
        dev = key.device
        betas = torch.linspace(0.0, 1.0, n_temps + 1, device=dev)
        k_init, k_anneal = random.split(key).unbind(-2)
        trs, logliks, invariant = _init(target, n_particles, k_init,
                                        loglik_of)
        lw = torch.zeros(n_particles, device=dev)
        log_z = torch.zeros((), device=dev)
        idx = torch.arange(m, device=dev)
        accs = []
        for t in range(n_temps):
            beta_prev, beta = betas[t], betas[t + 1]
            k_res, k_move = random.split(random.fold_in(k_anneal, t)).unbind(-2)
            lw = lw + (beta - beta_prev) * logliks
            log_z = log_z + torch.logsumexp(lw, 0) - math.log(n_particles)
            tr, lik = resample_tree(k_res, lw, (trs, logliks), m, resampling,
                                    invariant=invariant)
            # Chain i runs on fold_in(k_move, i); its step j on
            # fold_in(chain key, j).
            ck = random.fold_in(k_move, idx)
            states, liks = [tr], [lik]
            acc = torch.zeros(m, device=dev)
            for j in range(p - 1):
                tr, lik, accept = _mh_move(
                    tr, lik, random.fold_in(ck, j), beta, make_request,
                    loglik_of, invariant[0])
                states.append(tr)
                liks.append(lik)
                acc = acc + accept.float()
            # (M, P) in chain-major order -> the N particles.
            trs = _interleave(states, invariant[0], n_particles)
            logliks = torch.stack(liks, dim=1).reshape(n_particles)
            lw = torch.zeros(n_particles, device=dev)
            accs.append((acc / max(p - 1, 1)).mean())
        log_z = log_z + torch.logsumexp(lw, 0) - math.log(n_particles)
        return TemperedSMCResult(trs, lw, log_z, torch.stack(accs))

    return run


def _interleave(states: list, invariant, n: int):
    """Stack the chains' states as ``(M, P, ...)`` and flatten to ``N``
    particles, chain by chain; an invariant leaf is one view of ``N``
    rows."""
    flat = [tree_flatten(s)[0] for s in states]
    spec = tree_flatten(states[0])[1]
    inv = tree_flatten(invariant)[0]
    out = []
    for j, iv in enumerate(inv):
        first = flat[0][j]
        if first is None:
            out.append(None)
        elif iv:
            out.append(_rows(first, n))
        else:
            st = torch.stack([f[j] for f in flat], dim=1)
            out.append(st.reshape((n,) + tuple(st.shape[2:])))
    return tree_unflatten(out, spec)


def annealed_importance_sampling(
    target: Target,
    n_particles: int,
    n_temps: int = 20,
    make_request: "Callable[[], EditRequest] | None" = None,
    n_moves: int = 1,
):
    """Annealed importance sampling (Neal 2001): ``tempered_smc`` with
    resampling off, so every particle is an independent AIS run and
    ``exp(log Z)`` is unbiased. The resample branch is never built."""
    return tempered_smc(
        target, n_particles, n_temps=n_temps, make_request=make_request,
        n_moves=n_moves, ess_threshold=0.0,
    )
