"""The discrete-HMM generative model on the ``Scan`` combinator and its
bootstrap particle filter, the sampled counterparts of the exact
``DiscreteHMM`` posterior (counterpart of ``genjax_tpu/models/hmm.py``).

The JAX package advances the filter's ensemble with one-hot contractions
(``ops/onehot.py``) because a row gather is slow on the TPU; here a row
select is plain indexing (``trans_cdf[zs]``).
"""

from __future__ import annotations

import torch

from genjax_torch.core import random
from genjax_torch.inference.pf import particle_filter
from genjax_torch.lang.distributions.discrete_hmm import (
    DiscreteHMMConfiguration,
)
from genjax_torch.lang.distributions.stdlib import categorical
from genjax_torch.lang.static import gen

__all__ = ["hmm_model", "hmm_bootstrap_filter"]


def hmm_model(config: DiscreteHMMConfiguration, n_steps: int):
    """The scanned HMM: latents at ``"z0"`` and ``("chain", t, "z")``,
    observations at ``"x0"`` and ``("chain", t, "x")``. Under a key batch
    ``B`` every state is a ``B``-shaped index, so a row of the logits
    tables is a gather with the batch in front."""

    @gen
    def step(z, _):
        z_next = categorical(config.transition_logits[z]) @ "z"
        _ = categorical(config.observation_logits[z_next]) @ "x"
        return z_next, z_next

    @gen
    def hmm():
        z0 = categorical(config.prior_logits) @ "z0"
        _ = categorical(config.observation_logits[z0]) @ "x0"
        _ = step.scan(n=n_steps - 1)(z0, None) @ "chain"

    return hmm


def hmm_bootstrap_filter(config: DiscreteHMMConfiguration,
                         n_particles: int, sampling: str = "invcdf",
                         **pf_kwargs):
    """Bootstrap particle filter for a discrete HMM:
    ``run(key, observations) -> (FilterState, log_z_per_step)``, one key
    per step on the whole ensemble (``particle_filter(batched=True)``).
    ``sampling``:

    - ``"invcdf"`` (default): the new state is a compare-count of the
      current state's transition CDF against one uniform per particle,
      clipped to ``S - 1`` (f32 roundoff can leave the CDF's last entry
      below 1);
    - ``"gumbel"``: ``random.categorical`` on the transition logits
      (another random stream, the same law).

    ``observations`` is the full ``(T,)`` int sequence; the first entry
    conditions the init."""
    if sampling not in ("invcdf", "gumbel"):
        raise ValueError(f"unknown sampling scheme {sampling!r}")
    s_states = config.transition_logits.shape[0]
    trans_cdf = torch.cumsum(torch.softmax(config.transition_logits, dim=-1),
                             dim=-1)

    # Each step's observation enters as its emission column
    # obs_logits[:, x_t], so that no step indexes with a device scalar.
    def init(key, col0):
        z = random.categorical(key, config.prior_logits, shape=(n_particles,))
        return z, col0[z]

    def step_gumbel(key, zs, col):
        z_new = random.categorical(key, config.transition_logits[zs])
        return z_new, col[z_new]

    def step_invcdf(key, zs, col):
        u = random.uniform(key, (n_particles, 1))
        z_new = torch.clamp_max(torch.sum(trans_cdf[zs] < u, dim=-1),
                                s_states - 1)
        return z_new, col[z_new]

    step = step_invcdf if sampling == "invcdf" else step_gumbel

    def run(key, observations):
        obs = torch.as_tensor(observations,
                              device=config.observation_logits.device)
        cols = config.observation_logits[:, obs].T         # (T, S)
        pf = particle_filter(lambda k: init(k, cols[0]), step, n_particles,
                             batched=True, **pf_kwargs)
        return pf(key, cols[1:])

    return run
