"""Exact-inference testbed: HMM inference problems with exact
log-posteriors and log-marginals, to validate approximate algorithms
(counterpart of ``genjax_tpu/inference/exact_testbed.py``).
"""

from __future__ import annotations

from typing import Callable

import torch

from genjax_torch.core import random
from genjax_torch.core.pytree import Pytree
from genjax_torch.lang.distributions.discrete_hmm import (
    DiscreteHMMConfiguration,
    forward_filter,
    joint_logpdf,
)

__all__ = [
    "DiscreteHMMInferenceProblem",
    "sample_problem",
    "build_test_against_exact_inference",
]


@Pytree.dataclass
class DiscreteHMMInferenceProblem(Pytree):
    """An HMM posterior-inference problem with its exact answers."""

    config: DiscreteHMMConfiguration
    observations: torch.Tensor
    latents: torch.Tensor
    log_data_marginal: torch.Tensor

    def exact_posterior_logpdf(self, z: torch.Tensor) -> torch.Tensor:
        return (joint_logpdf(self.config, z, self.observations)
                - self.log_data_marginal)


def sample_problem(key: torch.Tensor, config: DiscreteHMMConfiguration,
                   num_steps: int) -> DiscreteHMMInferenceProblem:
    """Forward-sample latents and observations, then compute the exact
    answers. The key schedule is JAX's: ``split(key)`` into ``(k_z0,
    k_scan)``, then at step ``i`` ``fold_in(k_scan, 2i)`` for the
    transition and ``fold_in(k_scan, 2i + 1)`` for the observation. The
    step keys and their Gumbel noise are drawn for all steps at once, so
    the loop is a few small ops a step and never syncs the host; each
    draw is ``random.categorical``'s ``argmax(gumbel + logits)``.

    A key batch ``B + (2,)`` samples ``B`` problems, each from its own
    key as ``jax.vmap`` of the JAX function does: observations and
    latents ``B + (T,)``, log marginals ``B``. The configuration is
    shared or leads with ``B`` (one per problem)."""
    dev = config.prior_logits.device
    key = key.to(dev)
    if key.ndim > 1:
        return _sample_problems(key, config, num_steps)
    k_z0, k_scan = random.split(key).unbind(-2)
    z = random.categorical(k_z0, config.prior_logits).reshape(1)
    ks = random.fold_in(k_scan, torch.arange(2 * num_steps, device=dev))
    g_z = random.gumbel(ks[0::2], config.transition_logits.shape[-1:])
    g_x = random.gumbel(ks[1::2], config.observation_logits.shape[-1:])
    zs, xs = [], []
    for i in range(num_steps):
        zs.append(z)
        xs.append(torch.argmax(g_x[i] + config.observation_logits[z], -1))
        z = torch.argmax(g_z[i] + config.transition_logits[z], -1)
    zs, xs = torch.cat(zs), torch.cat(xs)
    _, logm = forward_filter(config, xs)
    return DiscreteHMMInferenceProblem(config, xs, zs, logm)


def _row(mat: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """Row ``z`` (shape ``B``) of a shared matrix, or of each problem's
    own ``B + (S, S')``."""
    if mat.ndim == 2:
        return mat[z]
    idx = z[..., None, None].expand(tuple(z.shape) + (1, mat.shape[-1]))
    return torch.take_along_dim(mat, idx, dim=-2)[..., 0, :]


def _sample_problems(key, config, num_steps: int):
    dev = key.device
    batch = tuple(key.shape[:-1])
    k_z0, k_scan = random.split(key).unbind(-2)
    prior = config.prior_logits
    z = random.categorical(k_z0, prior.expand(batch + prior.shape[-1:]))
    ks = random.fold_in(k_scan[..., None, :],
                        torch.arange(2 * num_steps, device=dev))
    g_z = random.gumbel(ks[..., 0::2, :], config.transition_logits.shape[-1:])
    g_x = random.gumbel(ks[..., 1::2, :],
                        config.observation_logits.shape[-1:])
    zs, xs = [], []
    for i in range(num_steps):
        zs.append(z)
        xs.append(torch.argmax(g_x[..., i, :]
                               + _row(config.observation_logits, z), -1))
        z = torch.argmax(g_z[..., i, :] + _row(config.transition_logits, z),
                         -1)
    zs, xs = torch.stack(zs, -1), torch.stack(xs, -1)
    _, logm = forward_filter(config, xs)
    return DiscreteHMMInferenceProblem(config, xs, zs, logm)


def build_test_against_exact_inference(
    num_states: int = 5,
    num_obs: int = 5,
    num_steps: int = 10,
) -> Callable[[torch.Tensor], DiscreteHMMInferenceProblem]:
    """Returns ``key -> DiscreteHMMInferenceProblem`` with the circulant
    structure of the testbed."""
    config = DiscreteHMMConfiguration.circulant(num_states, num_obs)

    def build(key: torch.Tensor) -> DiscreteHMMInferenceProblem:
        return sample_problem(key, config, num_steps)

    return build
