"""Exact posteriors of finite discrete models (counterpart of
``genjax_tpu/inference/enumerative.py``).

For a :class:`Target` whose every unconstrained site is a scalar
``flip``, ``bernoulli`` or ``categorical``, the posterior is exact: score
the model on the product grid of the sites' supports and normalize. The
grid is one batched ``assess``: its ``K`` combinations are ``K``
executions, the target's arguments and constraint lifted to them as
zero-stride views (the key-batch convention of ``gfi/gfn.py``).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from genjax_torch.core import random
from genjax_torch.gfi.choice_map import ChoiceMap
from genjax_torch.inference.smc import lift_target
from genjax_torch.inference.sp import Target
from genjax_torch.inference.transforms import path_present, tree_device

__all__ = ["EnumerationResult", "enumerate_posterior"]

#: distribution name -> (args, value) -> 1-D support. Only scalar sites
#: enumerate (a vector flip would grow the grid without saying so).
_FINITE_SUPPORTS: dict[str, Callable] = {
    "flip": lambda args, v: torch.tensor([0, 1], device=v.device).to(v.dtype),
    "bernoulli": lambda args, v: torch.tensor(
        [0, 1], device=v.device).to(v.dtype),
    "categorical": lambda args, v: torch.arange(
        torch.as_tensor(args[0]).shape[-1], device=v.device).to(v.dtype),
}


class EnumerationResult(NamedTuple):
    """The exact posterior over the discrete grid: ``paths`` one address
    path (a tuple) per site, ``values`` one ``(K,)`` tensor per site (row
    ``k`` is one combination), ``log_probs`` the ``(K,)`` normalized
    posterior log-probabilities and ``log_marginal`` the log evidence."""

    paths: tuple
    values: tuple
    log_probs: torch.Tensor
    log_marginal: torch.Tensor

    def site_marginal(self, *path):
        """``(support, probs)``: the exact marginal of one site."""
        vals = self.values[self.paths.index(tuple(path))]
        support = torch.unique(vals)
        p = torch.exp(self.log_probs)
        probs = torch.stack([torch.where(vals == s, p, 0.0).sum()
                             for s in support])
        return support, probs

    def map_assignment(self) -> dict:
        """The MAP combination, as ``{path: value}``."""
        k = int(torch.argmax(self.log_probs))
        return {p: v[k] for p, v in zip(self.paths, self.values)}


def _discrete_sites(tr, constrained, path=()):
    """``(path, support)`` for every unconstrained scalar finite-support
    site of a trace; anything the grid cannot hold raises."""
    from genjax_torch.lang.distributions.distribution import (
        DistributionTrace,
    )
    from genjax_torch.lang.static import StaticTrace

    if isinstance(tr, DistributionTrace):
        if constrained(path):
            return
        name = getattr(tr.gen_fn, "name", None)
        fn = _FINITE_SUPPORTS.get(name)
        if fn is None:
            raise ValueError(
                f"enumerate_posterior: site {path} is a '{name}' "
                "distribution, not finite-support-enumerable. Exact "
                "enumeration needs every latent to be a scalar "
                f"flip/bernoulli/categorical; constrain or marginalize "
                f"{path} instead.")
        value = torch.as_tensor(tr.value)
        if value.ndim != 0:
            raise ValueError(
                f"enumerate_posterior: site {path} is vector-valued (shape "
                f"{tuple(value.shape)}); only scalar discrete sites "
                "enumerate. Rewrite it as scalar sites under distinct "
                "addresses.")
        yield path, fn(tr.args, value)
        return
    if isinstance(tr, StaticTrace):
        for addr, sub in zip(tr.addresses, tr.subtraces):
            yield from _discrete_sites(sub, constrained, path + (addr,))
        return
    raise ValueError(
        f"enumerate_posterior: unsupported trace node {type(tr).__name__} "
        f"at {path}; enumeration walks plain @gen nesting. Unroll "
        "combinators or enumerate by hand.")


def enumerate_posterior(target: Target,
                        max_states: int = 100_000) -> EnumerationResult:
    """The exact posterior and evidence of a finite discrete target: one
    probe run finds the unconstrained discrete sites, and one batched
    ``assess`` scores their product grid (at most ``max_states``
    combinations)."""
    device = tree_device((target.args, target.constraint))
    probe_tr, _ = target.importance(random.key(0, device=device),
                                    ChoiceMap.empty())
    latents = target.filter_to_unconstrained(probe_tr.get_choices())
    sites = list(_discrete_sites(
        probe_tr, lambda path: not path_present(latents, path)))
    if not sites:
        raise ValueError(
            "enumerate_posterior: no unconstrained discrete sites found.")
    paths = tuple(p for p, _ in sites)
    supports = [s for _, s in sites]
    k_total = 1
    for s in supports:
        k_total *= int(s.shape[0])
    if k_total > max_states:
        raise ValueError(
            f"enumerate_posterior: {k_total} support combinations exceed "
            f"max_states={max_states}; raise the cap explicitly if the grid "
            "is intended.")
    # Row k of the grid: site i takes digit i of k (the last site fastest).
    idx = torch.arange(k_total, device=supports[0].device)
    values, stride = [], k_total
    for s in supports:
        n = s.shape[0]
        stride //= n
        values.append(s[(idx // stride) % n])
    lifted = lift_target(target, k_total, device)
    chm = lifted.constraint
    for path, v in zip(paths, values):
        chm = chm | ChoiceMap.entry(v, *path)
    lps, _ = target.p.assess(chm, lifted.args, batch=(k_total,))
    log_z = torch.logsumexp(lps, dim=0)
    return EnumerationResult(paths, tuple(values), lps - log_z, log_z)
