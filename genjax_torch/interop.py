"""Carrying state from the JAX package into the port through numpy, so
that both packages compute on identical inputs without this package
importing JAX:

    key = key_from_numpy(np.asarray(jax.random.key_data(k)))
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from genjax_torch.core.pytree import tree_map
from genjax_torch.gfi.choice_map import ChoiceMap, Indexed
from genjax_torch.lang.distributions.discrete_hmm import (
    DiscreteHMMConfiguration,
)

__all__ = ["key_from_numpy", "choice_map_from_numpy", "ensemble_from_numpy",
           "hmm_config_from_numpy", "lanes_from_numpy", "params_from_numpy"]


def key_from_numpy(data, device=None) -> torch.Tensor:
    """A port key from ``uint32[..., 2]`` key data, as
    ``np.asarray(jax.random.key_data(k))`` gives it."""
    a = np.asarray(data)
    if a.shape[-1:] != (2,):
        raise ValueError(f"key data has shape {a.shape}, want (..., 2)")
    return torch.as_tensor(a.astype(np.int64) & 0xFFFFFFFF, device=device)


def choice_map_from_numpy(mapping: Mapping, device=None) -> ChoiceMap:
    """``{address: value}`` (addresses as in ``ChoiceMap.d``) to a port
    choice map; numpy arrays become tensors, Python scalars stay as
    they are."""
    return ChoiceMap.d({
        addr: torch.tensor(v, device=device)
        if isinstance(v, (np.ndarray, np.generic)) else v
        for addr, v in mapping.items()
    })


def ensemble_from_numpy(xs, lw, device=None):
    """A particle ensemble ``(xs, log_weights)`` as tensors on
    ``device``; log-weights are f32."""
    return (torch.tensor(np.asarray(xs), device=device),
            torch.tensor(np.asarray(lw, np.float32), device=device))


def hmm_config_from_numpy(prior, trans, obs, device=None
                          ) -> DiscreteHMMConfiguration:
    """A port ``DiscreteHMMConfiguration`` from the three logit arrays of
    a JAX one (``prior_logits``, ``transition_logits``,
    ``observation_logits``, each through ``np.asarray``), as f32. Arrays
    with a batch of problems in front (``jax.vmap`` of a constructor)
    give a batched configuration."""
    def f32(a):
        return torch.tensor(np.asarray(a, np.float32), device=device)

    return DiscreteHMMConfiguration(f32(prior), f32(trans), f32(obs))


def lanes_from_numpy(mapping: Mapping, batch_rank: int = 0,
                     device=None) -> ChoiceMap:
    """The stacked choices of a JAX ``Vmap`` or ``Scan`` trace, ``{addr:
    values}`` with the lane axis after ``batch_rank`` batch axes (as
    ``np.asarray(tr.get_choices()[:, addr])`` gives them, under
    ``jax.vmap`` with the batch in front), as the port's lane choice map:
    lane ``i`` at ``chm[i, addr]``."""
    inner = ChoiceMap.d({addr: torch.tensor(np.asarray(v), device=device)
                         for addr, v in mapping.items()})
    return Indexed(inner, None, None, batch_rank)


def params_from_numpy(tree, device=None):
    """A pytree of numpy arrays (variational parameters, an ensemble, a
    temperature ladder) as the port's tensors on ``device``, each in its
    own dtype; Python scalars stay as they are."""
    return tree_map(
        lambda v: torch.tensor(np.asarray(v), device=device)
        if isinstance(v, (np.ndarray, np.generic)) else v, tree)
