"""Particle filtering: initialize an ensemble, then alternate adaptive
resampling, propagation and reweighting (counterpart of
``genjax_tpu/inference/pf.py``).

JAX runs the steps in one ``lax.scan`` behind a ``lax.cond`` on the ESS.
Here the steps are a Python loop and the ESS test is a Python ``if``:
one host sync per step, the known idle source of this slice. The step
keys are derived for all steps at once before the loop (the same key
data as JAX's per-step ``fold_in`` + ``split``), so the loop issues no
key arithmetic of its own. The sharding hooks of the JAX driver are
``stats_fn`` and ``resample_fn`` as there, and ``particle_range`` in place
of ``shard_constraint``: the rank's slice of the global particle axis
(``parallel.sharded_particle_filter`` builds all three).
"""

from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple

import torch

from genjax_torch.core import random
from genjax_torch.core.pytree import tree_leaves, tree_map
from genjax_torch.gfi.gfn import GenerativeFunction
from genjax_torch.inference.smc import _step_keys, resample_tree
from genjax_torch.ops import fused_model
from genjax_torch.ops.fused_step import CudaModel, fused_step

__all__ = [
    "FilterState",
    "ParticleFilter",
    "particle_filter",
    "bootstrap_filter",
    "fused_particle_filter",
]


class FilterState(NamedTuple):
    particles: Any  # per-particle latent state pytree (leading axis = K)
    log_weights: torch.Tensor
    log_z: torch.Tensor


def _filter_keys(key, n_steps: int):
    """``(k_init, k_res[t], k_prop[t])`` for ``t < n_steps``: JAX's
    ``split(key)`` then ``split(fold_in(k_scan, t))`` per step."""
    k_init, k_scan = random.split(key).unbind(-2)
    k_res, k_prop = _step_keys(k_scan, n_steps, 2).unbind(-2)
    return k_init, k_res, k_prop


def _lse(lw: torch.Tensor) -> torch.Tensor:
    return torch.logsumexp(lw, dim=0)


def _lse_ess(lw: torch.Tensor):
    lse = torch.logsumexp(lw, dim=0)
    return lse, torch.exp(2.0 * lse - torch.logsumexp(2.0 * lw, dim=0))


def particle_filter(
    init: Callable,
    step: Callable,
    n_particles: int,
    ess_threshold: float = 0.5,
    resampling: str = "systematic",
    batched: bool = False,
    particle_range: tuple[int, int] | None = None,
    stats_fn: Callable | None = None,
    resample_fn: Callable | None = None,
):
    """Generic particle filter.

    - ``init(key) -> (state, log_w)``: the initial ensemble and weights;
    - ``step(key, state, obs_t) -> (state, log_incr_w)``: propagate and
      weight against ``obs_t``.

    With ``batched=True`` each call gets ONE key and works on the whole
    ``(n_particles, ...)`` ensemble. Otherwise each call gets the batch of
    per-particle keys ``fold_in(k, i)``, ``i < n_particles`` (the particle
    axis written out where JAX vmaps), and works on the same ensemble.

    Returns ``run(key, observations) -> (FilterState, log_z_per_step)``.

    Sharding hooks (the counterparts of the JAX driver's):

    - ``particle_range=(lo, hi)``: this rank runs the particles ``lo <= i
      < hi`` of the ``n_particles``, on the keys ``fold_in(k, i)`` of
      their global ``i``, so that it draws exactly what they draw in the
      unsharded run. Only the per-particle path shards (``batched=True``
      raises): its draws do not depend on the layout.
    - ``stats_fn(log_weights) -> (lse, ess)`` and ``resample_fn(key,
      log_weights, particles) -> particles`` replace the ensemble
      reductions and the resampling (``parallel.collectives`` gives the
      collective forms). With ``stats_fn``, the per-step log Z reads its
      ``lse``. The defaults reproduce the single-device computation.
    """
    log_n = math.log(n_particles)
    lo, hi = (0, n_particles) if particle_range is None else particle_range
    if particle_range is not None and batched:
        raise ValueError(
            "particle_filter: a particle_range shards the per-particle path "
            "only; batched=True draws the whole ensemble from one key, "
            "which no rank's slice can reproduce")
    if stats_fn is None:
        stats_fn = _lse_ess
        lse_fn = _lse
    else:
        def lse_fn(lw):
            return stats_fn(lw)[0]
    if resample_fn is None:
        def resample_fn(key, lw, particles):
            return resample_tree(key, lw, particles, n_particles, resampling)

    def per_particle(k):
        return random.fold_in(k, torch.arange(lo, hi, device=k.device))

    def run(key, observations):
        n_steps = tree_leaves(observations)[0].shape[0]
        k_init, k_res, k_prop = _filter_keys(key, n_steps)
        states, log_ws = init(k_init if batched else per_particle(k_init))
        log_ws = torch.as_tensor(log_ws, device=key.device).to(
            torch.float32).expand(hi - lo).clone()
        log_z = torch.zeros((), device=key.device)
        log_zs = []
        for t in range(n_steps):
            obs_t = tree_map(lambda o: o[t], observations)
            lse, ess = stats_fn(log_ws)
            if bool(ess < ess_threshold * n_particles):
                states = resample_fn(k_res[t], log_ws, states)
                log_z = log_z + lse - log_n
                log_ws = torch.zeros_like(log_ws)
            kp = k_prop[t] if batched else per_particle(k_prop[t])
            states, incr = step(kp, states, obs_t)
            log_ws = log_ws + incr
            log_zs.append(log_z + lse_fn(log_ws) - log_n)
        final = FilterState(states, log_ws, log_z + lse_fn(log_ws) - log_n)
        return final, torch.stack(log_zs)

    return run


def fused_particle_filter(
    init: Callable,
    propagate: Callable,
    loglik: Callable,
    n_particles: int,
    ess_threshold: float = 0.5,
    resampling: str = "systematic",
    state_dtype=torch.float32,
    cuda_model: CudaModel | None = None,
):
    """Particle filter whose per-step hot path (RNG + propagate + loglik +
    weight accumulate + logsumexp/ESS) is one fused kernel
    (``ops/fused_step.py``). Scalar-state models with one N(0, 1) draw
    per particle per step and scalar observations.

    - ``init(key) -> xs``: the initial ``(n_particles,)`` ensemble;
    - ``propagate(x, eps)`` / ``loglik(x_new, obs_t)``: the model's torch
      form, elementwise;
    - ``cuda_model``: the same model's CUDA form (the header the kernel
      compiles in and its constants), for an ensemble on the card. None
      generates it from ``propagate`` / ``loglik``
      (:mod:`~genjax_torch.ops.fused_model`) at the start of each run on
      the card, so constants the callables read are those of that run
      (a trace of milliseconds; the library is built once a structure);
      a model it cannot take raises there. A generated or hand-written
      model (``csrc/models/``) passed here is fixed for every run.

    Semantics match :func:`particle_filter`; the normal stream is the
    kernel's threefry-on-counter + Box–Muller, so the two agree
    statistically, not bitwise.
    """
    log_n = math.log(n_particles)

    def run(key, observations):
        n_steps = observations.shape[0]
        k_init, k_res, k_prop = _filter_keys(key, n_steps)
        xs = init(k_init).to(state_dtype)
        dev = xs.device
        if dev.type not in ("cpu", "cuda"):
            raise ValueError(f"fused_particle_filter: no kernel for {dev}")
        model = cuda_model
        if dev.type == "cuda" and model is None:
            model = fused_model.cuda_model(propagate, loglik, dev)
        obs = torch.as_tensor(observations, dtype=torch.float32, device=dev)
        k_res, k_prop = k_res.to(dev), k_prop.to(dev)
        lw = torch.zeros(n_particles, device=dev)
        # (log_z, lse(lw), ess(lw)) ride along: the fused step emits the
        # next step's lse/ess. lse starts at logsumexp(zeros(K)) = log K.
        log_z = torch.zeros((), device=dev)
        lse = torch.full((), log_n, device=dev)
        ess = torch.full((), float(n_particles), device=dev)
        log_zs = []
        for t in range(n_steps):
            if bool(ess < ess_threshold * n_particles):
                xs = resample_tree(k_res[t], lw, xs, n_particles, resampling)
                log_z = log_z + lse - log_n
                lw = torch.zeros_like(lw)
            xs, lw, lse, ess = fused_step(
                k_prop[t], xs, lw, obs[t], propagate, loglik,
                cuda_model=model, state_dtype=state_dtype,
            )
            log_zs.append(log_z + lse - log_n)
        return FilterState(xs, lw, log_z + lse - log_n), torch.stack(log_zs)

    return run


def bootstrap_filter(
    transition: GenerativeFunction,
    observation_logpdf: Callable,
    n_particles: int,
    init_prior: GenerativeFunction | None = None,
    init_args: tuple = (),
    ess_threshold: float = 0.5,
    resampling: str = "systematic",
):
    """Bootstrap particle filter from generative functions: ``init_prior``
    samples the initial latent, ``transition`` (args ``(state,)``) the
    next, and ``observation_logpdf(state, obs_t)`` scores an observation.
    Each runs once per step on the batch of per-particle keys."""
    if init_prior is None:
        raise ValueError("bootstrap_filter requires init_prior")

    def init(keys):
        tr = init_prior.simulate(keys, init_args)
        return tr.get_retval(), torch.zeros(())

    def step(keys, state, obs_t):
        new_state = transition.simulate(keys, (state,)).get_retval()
        return new_state, observation_logpdf(new_state, obs_t)

    return particle_filter(init, step, n_particles, ess_threshold, resampling)


class ParticleFilter:
    """Object façade over :func:`particle_filter` for repeated runs: the
    filter is built once and ``run`` / ``__call__`` apply it to
    ``(key, observations)``."""

    def __init__(self, init, step, n_particles, **kwargs):
        self._run = particle_filter(init, step, n_particles, **kwargs)
        self.n_particles = n_particles

    def run(self, key, observations):
        return self._run(key, observations)

    def __call__(self, key, observations):
        return self._run(key, observations)
