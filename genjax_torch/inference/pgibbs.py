"""Particle Gibbs (conditional SMC) with optional ancestor sampling, at
the array level and over traces of a ``Scan`` model (counterpart of
``genjax_tpu/inference/pgibbs.py``).

Particle Gibbs (Andrieu, Doucet & Holenstein 2010) targets the exact
joint smoothing posterior p(x_{1:T} | y_{1:T}) by iterating a
conditional bootstrap filter — one lane pinned to the current reference
trajectory — and drawing the next reference by ancestral tracing from
the final weights. Ancestor sampling (Lindsten, Jordan & Schön 2014,
PGAS) also resamples the retained lane's ancestor every step with the
transition density. Free lanes draw MULTINOMIAL ancestors, as in the JAX
package.

The ``lax.scan``s over time and sweeps become Python loops. A key batch
``B + (2,)`` runs ``B`` chains side by side (one chain: ``B = ()``); the
chain batch leads every call of the array-level model, and the particle
axis follows it:

- ``init_sampler(keys B + (2,), n) -> B + (n, ...)`` states;
- ``propagate(keys B + (2,), xs) -> xs_next``;
- ``loglik(xs, y_t) -> B + (n,)``;
- ``trans_logpdf(x_prev, x_next) -> B + (n,)`` (optional): the
  reference's next state ``x_next`` comes with a particle axis of 1
  (``B + (1, ...)``), so the JAX package's form broadcasts as it is.
"""

from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple

import torch

from genjax_torch.core import random
from genjax_torch.core.pytree import tree_leaves, tree_map
from genjax_torch.inference.smc import (
    _owners,
    _softmax,
    _spacings,
    _step_keys,
    _take,
    _tensor_map,
    resample_indices,
)

__all__ = ["ParticleGibbsResult", "conditional_bootstrap_filter",
           "particle_gibbs", "TraceParticleGibbsResult",
           "trace_csmc", "trace_particle_gibbs"]


class ParticleGibbsResult(NamedTuple):
    paths: Any              # B + (n_iters, T, ...) reference trajectories
    log_zs: torch.Tensor    # B + (n_iters,) per-sweep CSMC logZ estimates
    final_path: Any         # B + (T, ...) last reference trajectory


def _lane(tree, idx, axis: int):
    """Lane ``idx`` at ``axis``: an int, or a tensor with one lane per
    chain (the batch's shape)."""
    if isinstance(idx, torch.Tensor) and idx.ndim:
        return tree_map(lambda v: _take(v, idx[..., None], axis)
                        .squeeze(axis), tree)
    lead = (slice(None),) * axis
    return tree_map(lambda v: v[lead + (idx,)], tree)


def _set_last(tree, value, axis: int):
    """``tree`` with its last lane along ``axis`` replaced by ``value``
    (which lacks that axis)."""
    return tree_map(
        lambda xs, v: torch.cat([xs.narrow(axis, 0, xs.shape[axis] - 1),
                                 torch.as_tensor(v, device=xs.device)
                                 .to(xs.dtype).unsqueeze(axis)], dim=axis),
        tree, value)


def _lse_mean(lw: torch.Tensor) -> torch.Tensor:
    return torch.logsumexp(lw, dim=-1) - math.log(lw.shape[-1])


def conditional_bootstrap_filter(
    init_sampler: Callable,
    propagate: Callable,
    loglik: Callable,
    n_particles: int,
    trans_logpdf: Callable | None = None,
):
    """Build ``run(key, ys, ref_path) -> (new_path, log_z)``: one
    conditional-SMC sweep with lane ``K-1`` pinned to ``ref_path``
    (``B + (T, ...)``), returning a freshly drawn reference trajectory.
    With ``trans_logpdf`` the retained lane's ancestor is resampled each
    step (PGAS)."""
    k = n_particles

    def run(key, ys, ref_path):
        r = key.ndim - 1
        k_init, k_scan, k_pick = random.split(key, 3).unbind(-2)
        xs0 = _set_last(init_sampler(k_init, k), _lane(ref_path, 0, r), r)
        lw = loglik(xs0, tree_map(lambda v: v[0], ys))
        log_z = _lse_mean(lw)
        n_steps = tree_leaves(ys)[0].shape[0]
        xs = xs0
        states, ancs = [], []
        last = torch.full(tuple(key.shape[:-1]) + (1,), k - 1,
                          dtype=torch.int64, device=key.device)
        # Every step's keys at once (the same key data as a fold_in and a
        # split a step), and the draws that do not depend on the state:
        # the multinomial's exponential spacings and the ancestor draw's
        # Gumbel noise, each one batched call for the sweep.
        k_anc, k_as, k_prop = _step_keys(k_scan, n_steps, 3).unbind(-2)
        us = _spacings(random.exponential(k_anc, (k,)))
        gumbels = (None if trans_logpdf is None
                   else random.gumbel(k_as, (k,)))
        for t in range(1, n_steps):
            # Free lanes: multinomial ancestors from the current weights;
            # the retained lane: its own history, or an ancestor drawn
            # with the transition density (PGAS).
            cum = torch.cumsum(_softmax(lw), dim=-1)
            anc_free = _owners(cum, us[..., t, :])
            ref_t = _lane(ref_path, t, r)
            if trans_logpdf is None:
                anc_ref = last
            else:
                x_next = tree_map(lambda v: v.unsqueeze(r), ref_t)
                anc_ref = torch.argmax(
                    gumbels[..., t, :] + lw + trans_logpdf(xs, x_next),
                    dim=-1)[..., None]
            anc = torch.cat([anc_free, anc_ref], dim=-1)
            moved = propagate(k_prop[..., t, :],
                              tree_map(lambda v: _take(v, anc, r), xs))
            xs = _set_last(moved, ref_t, r)
            lw = loglik(xs, tree_map(lambda v: v[t], ys))
            log_z = log_z + _lse_mean(lw)
            states.append(xs)
            ancs.append(anc)
        # Backward ancestral trace from a final draw.
        b = random.categorical(k_pick, lw)
        path_rev = []
        for xs_t, anc_t in zip(reversed(states), reversed(ancs)):
            path_rev.append(_lane(xs_t, b, r))
            b = _take(anc_t, b[..., None], r).squeeze(r)
        path_rev.append(_lane(xs0, b, r))
        path = tree_map(lambda *vs: torch.stack(vs, dim=r),
                        *path_rev[::-1])
        return path, log_z

    return run


def particle_gibbs(
    init_sampler: Callable,
    propagate: Callable,
    loglik: Callable,
    n_particles: int,
    n_iters: int,
    trans_logpdf: Callable | None = None,
):
    """Build ``run(key, ys, init_path=None) -> ParticleGibbsResult``:
    ``n_iters`` conditional-SMC sweeps, each refreshing the reference
    trajectory (an MCMC kernel whose invariant distribution is the exact
    joint smoothing posterior). ``init_path``: an optional starting
    trajectory (default: an unconditional bootstrap path from lane 0)."""
    csmc = conditional_bootstrap_filter(
        init_sampler, propagate, loglik, n_particles, trans_logpdf)

    def run(key, ys, init_path=None):
        r = key.ndim - 1
        k_boot, k_sweeps = random.split(key).unbind(-2)
        if init_path is None:
            # Unconditioned warm start: prior rollouts, lane 0.
            n_steps = tree_leaves(ys)[0].shape[0]
            xs = init_sampler(random.fold_in(k_boot, 0), n_particles)
            lanes = [_lane(xs, 0, r)]
            for t in range(1, n_steps):
                xs = propagate(random.fold_in(k_boot, t), xs)
                lanes.append(_lane(xs, 0, r))
            init_path = tree_map(lambda *vs: torch.stack(vs, dim=r), *lanes)
        path, paths, log_zs = init_path, [], []
        sweep_keys = random.fold_in(
            k_sweeps[..., None, :],
            torch.arange(n_iters, device=key.device))
        for i in range(n_iters):
            path, log_z = csmc(sweep_keys[..., i, :], ys, path)
            paths.append(path)
            log_zs.append(log_z)
        return ParticleGibbsResult(
            tree_map(lambda *vs: torch.stack(vs, dim=r), *paths),
            torch.stack(log_zs, dim=-1), path)

    return run


# ---------------------------------------------------------------------------
# GFI-native particle Gibbs: conditional SMC over TRACES of a Scan model.
# ---------------------------------------------------------------------------


class TraceParticleGibbsResult(NamedTuple):
    paths: Any              # {addr: (n_iters, T, ...)} reference latents
    log_zs: torch.Tensor    # (n_iters,) per-sweep CSMC logZ estimates
    final_path: Any         # {addr: (T, ...)} last reference latents


def trace_csmc(
    scan_model,
    model_args: tuple,
    obs_address: str,
    observations: torch.Tensor,
    latent_addresses: tuple,
    n_particles: int,
    ancestor_sampling: bool = False,
):
    """Build ``run(key, ref) -> (new_ref, log_z)``: one conditional-SMC
    sweep over TRACES of a ``Scan`` model, lane ``K-1`` pinned to the
    reference latents ``ref = {addr: (T, ...)}``, drawing a fresh
    reference by a categorical pick from the final weights.

    Each step: multinomial conditional resampling (the retained lane
    keeps itself), a prior refresh of the cloned futures (``Regenerate``
    of the steps after ``t − 1``, weight 0), then observation ``t``
    assimilated by an ``IndexRequest`` repair on the Scan fast path.
    ``ancestor_sampling=True`` (PGAS) draws the retained lane's ancestor
    from the weights plus each lane's transition score to the
    reference's step ``t`` (one batched ``assess`` of the step function)
    and splices the reference's future onto it with an ``Update``.

    The particles are one key batch of ``K``; the model's arguments are
    lifted to it, and so is each step's observation."""
    from genjax_torch.gfi.choice_map import ChoiceMap, lift_values
    from genjax_torch.gfi.concepts import IndexRequest
    from genjax_torch.gfi.requests import Regenerate, Update
    from genjax_torch.gfi.selection import Selection
    from genjax_torch.inference.smc import _lift

    k = n_particles
    n_steps = tree_leaves(observations)[0].shape[0]
    inner_gf = scan_model.inner
    init_carry, scan_xs = model_args[0], model_args[1]

    def pin_constraint(ref, device):
        """The reference latents as a constraint of a one-lane batch."""
        chm = ChoiceMap.empty()
        steps = torch.arange(n_steps, device=device)
        for addr in latent_addresses:
            chm = chm | ChoiceMap.entry(
                torch.as_tensor(ref[addr], device=device), steps, addr)
        return lift_values(chm, (1,), device)

    def extract(tr):
        chm = tr.get_choices()
        return {addr: chm[:, addr][0] for addr in latent_addresses}

    def run(key, ref):
        dev = key.device
        lanes = torch.arange(k, device=dev)
        k_init, k_pin, k_scan, k_pick = random.split(key, 4).unbind(-2)

        def lift(v):
            return _lift(v, (), k, dev)

        trs = scan_model.simulate(random.fold_in(k_init, lanes),
                                  tree_map(lift, model_args))
        pin = pin_constraint(ref, dev)
        # Pin lane K-1's latents to the reference (a one-lane batch on
        # the key data of the JAX package's single-trace update).
        tr_ref, _, _, _ = _lane_slice(trs, k - 1, k).update(k_pin[None], pin)
        trs = _cat(_lane_slice(trs, 0, k - 1), tr_ref)
        lw = torch.zeros(k, device=dev)
        log_z = torch.zeros((), device=dev)
        step_keys = _step_keys(k_scan, n_steps, 5)
        for t in range(n_steps):
            obs_t = observations[t]
            k_anc, k_refresh, k_edit, k_as, k_splice = step_keys[t].unbind(-2)
            if ancestor_sampling:
                chm_t = ChoiceMap.entry(obs_t, obs_address)
                for addr in latent_addresses:
                    chm_t = chm_t | ChoiceMap.entry(
                        torch.as_tensor(ref[addr])[t], addr)
                chm_t = lift_values(chm_t, (k,), dev)
                x_t = (None if scan_xs is None
                       else tree_map(lambda v: lift(v[t]), scan_xs))
                if t == 0:
                    carry_in = tree_map(lift, init_carry)
                else:
                    carry_in = trs.get_inner_trace(t - 1).get_retval()[0]
                trans, _ = inner_gf.assess(chm_t, (carry_in, x_t), batch=(k,))
                b_as = int(random.categorical(k_as, lw + trans))
                cstr = pin.filter(Selection.idx_above(t - 1))
                retained, _, _, _ = _lane_slice(trs, b_as, b_as + 1).update(
                    k_splice[None], cstr)
            else:
                retained = _lane_slice(trs, k - 1, k)
            anc = resample_indices(k_anc, lw, k - 1, method="multinomial")
            free = _tensor_map(lambda v: v[anc], trs)
            # Prior refresh of the cloned futures (steps > t-1): the
            # Regenerate weight is exactly 0.
            free, _, _, _ = free.edit(random.fold_in(k_refresh, lanes[:-1]),
                                      Regenerate(Selection.idx_above(t - 1)))
            trs = _cat(free, retained)
            log_z = log_z + _lse_mean(lw)
            # Assimilate observation t on every lane; the increment is
            # log p(obs_t | x_t): the edit weight plus the discarded
            # prior draw's site score.
            old_y = (trs.get_inner_trace(t).get_inner_trace(obs_address)
                     .get_score())
            obs_k = torch.as_tensor(obs_t, device=dev)
            obs_k = obs_k.expand((k,) + tuple(obs_k.shape))
            trs, w, _, _ = trs.edit(
                random.fold_in(k_edit, lanes),
                IndexRequest(t, Update(ChoiceMap.entry(obs_k, obs_address))))
            lw = w + old_y
        log_z = log_z + _lse_mean(lw)
        b = int(random.categorical(k_pick, lw))
        return extract(_lane_slice(trs, b, b + 1)), log_z

    return run


def _lane_slice(trs, lo: int, hi: int):
    """Lanes ``lo:hi`` of a one-axis-batched trace, as a batch."""
    return _tensor_map(lambda v: v[lo:hi], trs)


def _cat(a, b):
    """Two batched traces of one structure, one after the other (a
    Python value is the same in both)."""
    return tree_map(lambda x, y: torch.cat([x, y.to(x.dtype)], dim=0)
                    if isinstance(x, torch.Tensor) else x, a, b)


def trace_particle_gibbs(
    scan_model,
    model_args: tuple,
    obs_address: str,
    observations: torch.Tensor,
    latent_addresses: tuple,
    n_particles: int,
    n_iters: int,
    ancestor_sampling: bool = False,
):
    """Build ``run(key, init_ref=None) -> TraceParticleGibbsResult``:
    ``n_iters`` GFI-native conditional-SMC sweeps over a ``Scan`` model.
    ``init_ref``: optional ``{addr: (T, ...)}`` starting latents (default:
    one unconditional prior rollout)."""
    csmc = trace_csmc(scan_model, model_args, obs_address, observations,
                      latent_addresses, n_particles,
                      ancestor_sampling=ancestor_sampling)

    def run(key, init_ref=None):
        k_boot, k_sweeps = random.split(key).unbind(-2)
        if init_ref is None:
            chm0 = scan_model.simulate(k_boot, model_args).get_choices()
            init_ref = {addr: chm0[:, addr] for addr in latent_addresses}
        ref, paths, log_zs = init_ref, [], []
        sweep_keys = random.fold_in(k_sweeps,
                                    torch.arange(n_iters, device=key.device))
        for i in range(n_iters):
            ref, log_z = csmc(sweep_keys[i], ref)
            paths.append(ref)
            log_zs.append(log_z)
        stacked = {addr: torch.stack([p[addr] for p in paths])
                   for addr in latent_addresses}
        return TraceParticleGibbsResult(stacked, torch.stack(log_zs), ref)

    return run
