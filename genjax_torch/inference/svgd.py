"""Stein variational gradient descent over a ``Target``'s posterior
(counterpart of ``genjax_tpu/inference/svgd.py``).

SVGD (Liu & Wang 2016) moves an N-particle ensemble along

    phi(x_i) = (1/N) sum_j [ k(x_j, x_i) grad log p(x_j)
                             + grad_{x_j} k(x_j, x_i) ]

with an RBF kernel, in matrix form: the pairwise squared distances from
one Gram product, then ``K @ grads`` and ``(sum_j K_ij) x_i - K @ X``.
The bandwidth is the median heuristic, recomputed each step. The
particles are a key batch, as ``run_nuts``'s chains are: latents are
raveled to one position vector a particle, scored by ``assess`` of the
whole choice map, and differentiated by one ``torch.autograd.grad`` of
the summed scores (each particle's gradient its own). The products run
in the precision torch's matmul settings give them (full f32 by
default).
"""

from __future__ import annotations

import math
from typing import Callable

import torch

from genjax_torch.core import random
from genjax_torch.core.pytree import ravel_pytree, tree_leaves
from genjax_torch.gfi.choice_map import ChoiceMap, partition_values
from genjax_torch.inference.requests.nuts import value_and_grad
from genjax_torch.inference.smc import lift_target
from genjax_torch.inference.sp import Target
from genjax_torch.inference.transforms import (
    constrain_choices,
    path_present,
    resolve_transforms,
    tree_device,
    unconstrain_choices,
)

__all__ = ["svgd_step", "run_svgd"]


def _check_continuous_sites(tr, constrained, path=()):
    """SVGD moves a continuous position vector: an unconstrained
    distribution site with bool or integer values cannot ride it. Walks
    plain ``@gen`` nesting; the dtype check of the raveled leaves in
    :func:`run_svgd` backstops the structures this walk skips."""
    from genjax_torch.lang.distributions.distribution import (
        DistributionTrace,
    )
    from genjax_torch.lang.static import StaticTrace

    if isinstance(tr, DistributionTrace):
        if constrained(path):
            return
        v = torch.as_tensor(tr.value)
        if not v.is_floating_point():
            name = getattr(tr.gen_fn, "name", None)
            raise ValueError(
                f"run_svgd: unconstrained site {path} is a '{name}' "
                f"distribution with {v.dtype} values; SVGD transports a "
                "continuous position vector and cannot move discrete "
                "sites. Constrain or marginalize this site, or use "
                "PGibbs / Regenerate moves.")
        return
    if isinstance(tr, StaticTrace):
        for addr, sub in zip(tr.addresses, tr.subtraces):
            _check_continuous_sites(sub, constrained, path + (addr,))


def _median(x: torch.Tensor) -> torch.Tensor:
    """``jnp.median`` of all entries: the mean of the two middle values
    of an even count (``torch.median`` returns the lower one)."""
    s = torch.sort(x.reshape(-1)).values
    n = s.shape[0]
    if n % 2:
        return s[n // 2]
    return 0.5 * (s[n // 2 - 1] + s[n // 2])


def _sq_dists(a: torch.Tensor) -> torch.Tensor:
    sq = (a * a).sum(-1)
    return torch.clamp(sq[:, None] - 2.0 * (a @ a.T) + sq[None, :], min=0.0)


def _rbf_phi(xs: torch.Tensor, grads: torch.Tensor,
             h_rows: int | None = None) -> torch.Tensor:
    """The SVGD direction for an RBF kernel. ``xs``, ``grads``: (N, D).
    ``h_rows``: take the bandwidth's median over the distances of every
    ``N // h_rows``-th particle (an ``~h_rows`` square), recomputed from
    those positions; ``None`` takes the exact median of all ``N²``."""
    n = xs.shape[0]
    d2 = _sq_dists(xs)
    if h_rows is None:
        med2 = _median(d2)
    else:
        stride = max(1, n // min(h_rows, n))
        med2 = _median(_sq_dists(xs[::stride]))
    h = torch.clamp(med2 / math.log(n + 1.0), min=1e-6)
    k = torch.exp(-d2 / h)                                  # (N, N)
    # grad_{x_j} k(x_j, x_i) = (2/h) k_ji (x_i - x_j), summed over j;
    # K is symmetric.
    k_sums = k.sum(0)
    repulse = (2.0 / h) * (k_sums[:, None] * xs - k @ xs)
    return (k @ grads + repulse) / n


def svgd_step(logdensity_fn: Callable[[torch.Tensor], torch.Tensor],
              xs: torch.Tensor, step_size: float) -> torch.Tensor:
    """One raw SVGD update of an (N, D) ensemble; ``logdensity_fn`` maps
    ``(N, D)`` to the ``(N,)`` log-densities."""
    _, grads = value_and_grad(logdensity_fn)(xs)
    return xs + step_size * _rbf_phi(xs, grads)


def svgd_problem(target: Target, key, n_particles: int,
                 transforms: "dict | str | None" = None,
                 particle_range: tuple[int, int] | None = None):
    """The particles ``lo <= i < hi`` of an ``n_particles`` SVGD ensemble
    on ``target`` (all of them by default), drawn from the prior by
    ``importance`` on ``fold_in(split(key)[0], i)`` of their global
    ``i``. Returns ``(xs, logdensity, finish)``: the raveled
    unconstrained positions ``(hi - lo, D)``, the batched log-density
    ``(hi - lo, D) -> (hi - lo,)``, and ``finish(xs)``, the constrained
    choice map of positions."""
    lo, hi = (0, n_particles) if particle_range is None else particle_range
    transforms = resolve_transforms(target, transforms)
    dev = key.device
    k_init, _ = random.split(key).unbind(-2)
    lifted = lift_target(
        target, hi - lo,
        tree_device((target.args, target.constraint)) or dev)
    trs, _ = lifted.importance(
        random.fold_in(k_init.unsqueeze(0),
                       torch.arange(lo, hi, device=dev)),
        ChoiceMap.empty())
    latents = lifted.filter_to_unconstrained(trs.get_choices())
    _check_continuous_sites(trs, lambda p: not path_present(latents, p))
    vals0, rebuild = partition_values(unconstrain_choices(latents,
                                                          transforms))
    for leaf in tree_leaves(vals0):
        if not torch.as_tensor(leaf).is_floating_point():
            raise ValueError(
                f"run_svgd: a latent leaf has dtype "
                f"{torch.as_tensor(leaf).dtype}; discrete sites cannot "
                "ride the SVGD position vector")
    xs, unravel = ravel_pytree(vals0, 1)
    batch = (hi - lo,)

    def logdensity(z):
        chm_x, fldj = constrain_choices(rebuild(unravel(z)), transforms, 1)
        score, _ = lifted.p.assess(lifted.constraint | chm_x, lifted.args,
                                   batch=batch)
        return score + fldj

    def finish(z):
        return constrain_choices(rebuild(unravel(z)), transforms, 1)[0]

    return xs, logdensity, finish


def run_svgd(target: Target, key, n_particles: int = 256,
             n_steps: int = 500, step_size: float = 0.05,
             transforms: "dict | str | None" = None,
             h_rows: int | None = None) -> ChoiceMap:
    """Fit an SVGD ensemble to ``target``'s posterior. Particles start
    from the prior (``importance`` on ``fold_in(split(key)[0], i)``);
    returns a choice map whose latent leaves lead with
    ``(n_particles,)``. Updates are AdaGrad-normalized, as in the SVGD
    paper, so ``step_size`` is free of the posterior's scale.
    ``transforms``: as in ``run_nuts`` (a dict of support bijectors or
    ``"auto"``); the particles then move in unconstrained space and the
    choices come back constrained."""
    xs, logdensity, finish = svgd_problem(target, key, n_particles,
                                          transforms)
    score_grad = value_and_grad(logdensity)
    acc = torch.zeros_like(xs)
    for _ in range(n_steps):
        _, grads = score_grad(xs)
        phi = _rbf_phi(xs, grads, h_rows)
        acc = 0.9 * acc + 0.1 * phi * phi
        xs = xs + step_size * phi / (1e-6 + torch.sqrt(acc))
    return finish(xs)
