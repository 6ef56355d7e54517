"""Posterior predictive sampling: the model run again under each
posterior draw of its latents (counterpart of
``genjax_tpu/inference/predictive.py``).

The draws are the executions of one batched ``generate``: a draw's
latents are constrained and its observed addresses drawn from their
conditional, which is the posterior predictive. Draw ``i`` (in the
flattened order of the sample axes) takes the key ``fold_in(key, i)``, as
in the JAX package, so results do not depend on how the sample axes are
blocked.
"""

from __future__ import annotations

import math

import torch

from genjax_torch.core import random
from genjax_torch.core.pytree import tree_leaves, tree_map
from genjax_torch.gfi.choice_map import ChoiceMap, partition_values
from genjax_torch.inference.smc import lift_target
from genjax_torch.inference.sp import Target

__all__ = ["posterior_predictive"]


def posterior_predictive(target: Target, draws: ChoiceMap, key,
                         sample_ndims: int = 2):
    """Sample the observed addresses given posterior latent ``draws``,
    a choice map whose values all lead with ``sample_ndims`` sample axes
    (2 for ``run_nuts``'s ``(chains, samples)``, 1 for a particle
    ensemble). Returns ``(choices, retvals)`` of every draw's model run,
    with the same leading sample axes."""
    values, _ = partition_values(draws)
    leaves = tree_leaves(values)
    if not leaves:
        raise ValueError("posterior_predictive: draws has no choices.")
    lead = tuple(leaves[0].shape[:sample_ndims])
    for lf in leaves:
        if tuple(lf.shape[:sample_ndims]) != lead:
            raise ValueError(
                "posterior_predictive: every draws leaf must share the "
                f"leading sample axes {lead}; got a leaf of shape "
                f"{tuple(lf.shape)}. For Scan/Vmap latents rebuild the "
                "draws sample-leading.")
    n_total = math.prod(lead)
    keys = random.fold_in(key.unsqueeze(-2),
                          torch.arange(n_total, device=key.device))
    flat = _reshape_draws(draws, lead, (n_total,))
    lifted = lift_target(Target(target.p, target.args, ChoiceMap.empty()),
                         n_total, key.device)
    tr, _ = target.p.generate(keys.reshape(n_total, 2), flat, lifted.args)

    def unflat(v):
        if isinstance(v, torch.Tensor) and v.ndim and v.shape[0] == n_total:
            return v.reshape(lead + tuple(v.shape[1:]))
        return v

    return (_reshape_draws(tr.get_choices(), (n_total,), lead),
            tree_map(unflat, tr.get_retval()))


def _reshape_draws(chm: ChoiceMap, old: tuple, new: tuple) -> ChoiceMap:
    """``chm`` with the leading axes ``old`` of its values reshaped to
    ``new``; ``Indexed`` nodes record the change of batch rank."""
    values, rebuild = partition_values(chm)
    shaped = tree_map(lambda v: v.reshape(new + tuple(v.shape[len(old):])),
                      values)
    return rebuild(shaped, len(new) - len(old))
