"""MAP estimation and the Laplace approximation over a ``Target``
(counterpart of ``genjax_tpu/inference/map_laplace.py``).

- :func:`map_optimize` maximizes the joint density of the target's model
  at its constraint over the unconstrained latents, optionally through
  the support bijectors of ``inference.transforms``. The optimizer is
  any object with optax's ``init(params) -> state`` /
  ``update(grads, state, params) -> (updates, state)`` shape; the default
  :func:`adam` computes ``optax.adam``'s update. A key batch
  ``B + (2,)`` runs ``B`` independent optimizations.
- :func:`laplace_approximation` expands the transformed-space log
  density (Jacobian included) to second order at a point
  (``torch.func.hessian``): the Gaussian covariance over the flattened
  unconstrained latents and ``log Ẑ = log p(x*) + d/2·log 2π −
  ½·log|H|``, exact for a Gaussian posterior.
"""

from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple

import torch

from genjax_torch.core import random
from genjax_torch.core.pytree import Const, ravel_pytree, tree_map
from genjax_torch.gfi.choice_map import (
    ChoiceMap,
    lift_values,
    partition_values,
)
from genjax_torch.inference.smc import lift_target
from genjax_torch.inference.sp import Target
from genjax_torch.inference.transforms import (
    constrain_choices,
    resolve_transforms,
    tree_device,
    unconstrain_choices,
)

__all__ = ["MAPResult", "LaplaceResult", "map_optimize",
           "laplace_approximation", "adam"]


class MAPResult(NamedTuple):
    choices: ChoiceMap        # latents at the optimum (constrained space)
    score: torch.Tensor       # joint log density at (choices | constraint)
    losses: torch.Tensor      # the objective a step, B + (n_steps,)
    transforms: Const         # the resolved transforms dict


class LaplaceResult(NamedTuple):
    mean: ChoiceMap           # the expansion point, constrained space
    mean_flat: torch.Tensor   # its flattened unconstrained coordinates (d,)
    cov: torch.Tensor         # (d, d) covariance, unconstrained coordinates
    log_z: torch.Tensor       # the Laplace evidence estimate
    unravel: Callable[[torch.Tensor], Any]  # flat -> unconstrained values


class _AdamState(NamedTuple):
    count: int
    mu: Any
    nu: Any


class _Adam(NamedTuple):
    lr: float
    b1: float
    b2: float
    eps: float

    def init(self, params):
        zeros = tree_map(torch.zeros_like, params)
        return _AdamState(0, zeros, tree_map(torch.zeros_like, params))

    def update(self, grads, state: _AdamState, params=None):
        count = state.count + 1
        mu = tree_map(lambda m, g: self.b1 * m + (1.0 - self.b1) * g,
                      state.mu, grads)
        nu = tree_map(lambda v, g: self.b2 * v + (1.0 - self.b2) * g * g,
                      state.nu, grads)
        c1 = 1.0 - self.b1 ** count
        c2 = 1.0 - self.b2 ** count
        updates = tree_map(
            lambda m, v: -self.lr * (m / c1) / (torch.sqrt(v / c2)
                                                + self.eps), mu, nu)
        return updates, _AdamState(count, mu, nu)


def adam(learning_rate: float, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8) -> _Adam:
    """``optax.adam``: bias-corrected moments, update
    ``−lr·m̂/(√v̂ + eps)``. Functional: its state is a value."""
    return _Adam(learning_rate, b1, b2, eps)


def _apply_updates(params, updates):
    return tree_map(lambda p, u: p + u, params, updates)


def _latent_space(target: Target, trace, transforms: dict, batch: tuple):
    """``(flat, unravel, rebuild, logpost)``: the unconstrained latents
    raveled behind ``batch``, and the score and forward log-det-Jacobian
    of a flat point."""
    latents = target.filter_to_unconstrained(trace.get_choices())
    u_chm = unconstrain_choices(latents, transforms) if transforms else \
        latents
    vals, rebuild = partition_values(u_chm)
    flat, unravel = ravel_pytree(vals, len(batch))

    def logpost(z):
        x = rebuild(unravel(z))
        if transforms:
            x, fldj = constrain_choices(x, transforms, len(batch))
        else:
            fldj = torch.zeros((), device=z.device)
        score, _ = target.p.assess(x | target.constraint, target.args,
                                   batch=batch)
        return score, fldj

    return flat, unravel, rebuild, logpost


def _to_constrained(u_chm: ChoiceMap, transforms: dict, rank: int):
    if transforms:
        x, _ = constrain_choices(u_chm, transforms, rank)
        return x
    return u_chm


def map_optimize(key, target: Target, *, n_steps: int = 500,
                 optimizer=None, transforms=None,
                 include_jacobian: bool = False,
                 init: ChoiceMap | None = None) -> MAPResult:
    """Gradient-ascent MAP of ``target``'s latents, started from
    ``init`` (constrained-space latents) or from ``target.importance``.
    ``include_jacobian=True`` maximizes the transformed-space density
    (score + forward log-det-Jacobian), the right expansion point for
    :func:`laplace_approximation`; the default is the constrained-space
    MAP."""
    if isinstance(transforms, Const):
        transforms = transforms.value
    optimizer = optimizer if optimizer is not None else adam(1e-2)
    batch = tuple(key.shape[:-1])
    tf = resolve_transforms(target, transforms)
    if batch:
        dev = tree_device((target.args, target.constraint)) or key.device
        target = lift_target(target, math.prod(batch), dev)
        if len(batch) > 1:
            raise NotImplementedError("map_optimize: a key batch of rank 1")
    init = init if init is not None else ChoiceMap.empty()
    if batch:
        init = lift_values(init, batch, key.device)
    tr, _ = target.importance(key, init)
    flat, unravel, rebuild, logpost = _latent_space(target, tr, tf, batch)

    def loss_fn(z):
        score, fldj = logpost(z)
        return -(score + fldj) if include_jacobian else -score

    z = flat.detach()
    state = optimizer.init(z)
    losses = []
    for _ in range(n_steps):
        with torch.enable_grad():
            zz = z.requires_grad_()
            loss = loss_fn(zz)
            (grads,) = torch.autograd.grad(loss.sum(), zz)
        losses.append(loss.detach())
        updates, state = optimizer.update(grads, state, z.detach())
        z = _apply_updates(z.detach(), updates)
    x_chm = _to_constrained(rebuild(unravel(z)), tf, len(batch))
    score, _ = target.p.assess(x_chm | target.constraint, target.args,
                               batch=batch)
    losses = (torch.stack(losses, dim=-1) if losses
              else torch.zeros(batch + (0,)))
    return MAPResult(x_chm, score, losses, Const(tf))


def laplace_approximation(target: Target, latents: ChoiceMap, *,
                          transforms=None, key=None) -> LaplaceResult:
    """Second-order expansion of the transformed-space log density at
    ``latents`` (constrained-space, e.g. ``map_optimize(...,
    include_jacobian=True).choices``). ``latents`` must cover every
    unconstrained address: an uncovered site would be drawn, which is
    refused unless the caller passes the ``key`` of those draws."""
    if isinstance(transforms, Const):
        transforms = transforms.value
    dev = tree_device((target.args, target.constraint, latents))
    gen_key = random.key(0, device=dev) if key is None else key
    tr, _ = target.importance(gen_key, latents)
    if key is None:
        uncon = target.filter_to_unconstrained(tr.get_choices())
        hidden = uncon.filter(~latents.get_selection())
        if not hidden.static_is_empty():
            raise ValueError(
                "laplace_approximation: `latents` does not cover all "
                "unconstrained addresses of the target; the uncovered "
                "sites would be silently sampled with a fixed key. Pass "
                "a full latent choice map, or an explicit `key` to own "
                "the fill-in draws.")
    tf = resolve_transforms(target, transforms)
    flat, unravel, rebuild, logpost = _latent_space(target, tr, tf, ())
    flat = flat.detach()
    d = flat.shape[0]

    def logdens(z):
        score, fldj = logpost(z)
        return score + fldj

    h = -torch.func.hessian(logdens)(flat)
    sign, logdet = torch.linalg.slogdet(h)
    cov = torch.linalg.inv(h)
    log_z = logdens(flat) + 0.5 * d * math.log(2.0 * math.pi) - 0.5 * logdet
    # A Hessian that is not positive definite means no mode: no log Z.
    log_z = torch.where(sign > 0, log_z, torch.full_like(log_z, math.nan))
    x_chm = _to_constrained(rebuild(unravel(flat)), tf, 0)
    return LaplaceResult(x_chm, flat, cov, log_z.detach(),
                         lambda z: rebuild(unravel(z)))
