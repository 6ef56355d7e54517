"""Elliptical slice sampling (Murray, Adams & MacKay 2010) as an edit
request (counterpart of ``genjax_tpu/inference/requests/ess.py``): a
tuning-free move for latents with (conditionally) Gaussian priors.

For the selected addresses ``p(z | rest) ∝ N(z; m, Σ)·L(z)``: the
log-likelihood is the trace's score less ``project(selection)``, and the
ellipse's auxiliary draw is ``generate`` with only the complement
constrained. The chains are a key batch; the shrinkage loop is a Python
``while`` over "any chain still shrinking", each chain's state kept by
its own predicate, as JAX's batched ``while_loop`` keeps it, so a
chain's result is its unbatched run.
"""

from __future__ import annotations

import math
from typing import Any

import torch

from genjax_torch.core import random
from genjax_torch.core.compiler.interpreters.incremental import Diff
from genjax_torch.core.compiler.staging import tree_where
from genjax_torch.core.pytree import Pytree, ravel_pytree
from genjax_torch.gfi.choice_map import partition_values
from genjax_torch.gfi.concepts import Argdiffs, EditRequest
from genjax_torch.gfi.gfn import Trace
from genjax_torch.gfi.requests import Update
from genjax_torch.gfi.selection import Selection

__all__ = ["EllipticalSlice", "elliptical_slice_kernel"]


def elliptical_slice_kernel(loglik_fn, z: torch.Tensor, nu: torch.Tensor,
                            key: torch.Tensor, mean=0.0, max_iters: int = 64):
    """One ESS transition of the raveled positions ``z`` (``B + (D,)``,
    keys ``B + (2,)``) with auxiliary prior draws ``nu``. Returns
    ``(z_new, n_lik_evals)``. ``loglik_fn`` maps ``B + (D,)`` to ``B``
    and is the non-Gaussian factor only; ``max_iters`` bounds the
    shrinkage, and a chain that exhausts it keeps its current point."""
    k_u, k_theta, k_loop = random.split(key, 3).unbind(-2)
    ll0 = loglik_fn(z)
    log_u = ll0 + torch.log(random.uniform(k_u, ()))
    theta = random.uniform(k_theta, (), minval=0.0, maxval=2.0 * math.pi)
    zc, nuc = z - mean, nu - mean

    def proposal(theta):
        return mean + zc * torch.cos(theta)[..., None] \
            + nuc * torch.sin(theta)[..., None]

    batch = tuple(key.shape[:-1])
    state = (k_loop, theta - 2.0 * math.pi, theta, theta, z,
             torch.zeros(batch, dtype=torch.bool, device=z.device),
             torch.zeros(batch, dtype=torch.int32, device=z.device))
    while True:
        k, tmin, tmax, theta, _, accepted, i = state
        active = ~accepted & (i < max_iters)
        if not bool(active.any()):
            break
        zp = proposal(theta)
        accepted = loglik_fn(zp) > log_u
        # Shrink the bracket toward 0 on rejection and redraw.
        tmin = torch.where(theta < 0.0, theta, tmin)
        tmax = torch.where(theta >= 0.0, theta, tmax)
        k, k_next = random.split(k).unbind(-2)
        theta_next = random.uniform(k_next, (), minval=tmin, maxval=tmax)
        theta = torch.where(accepted, theta, theta_next)
        state = tree_where(active, (k, tmin, tmax, theta, zp, accepted,
                                    i + 1), state)
    _, _, _, _, zp, accepted, iters = state
    return torch.where(accepted[..., None], zp, z), iters + 1


#: Distributions whose prior an ellipse is exact for.
_GAUSSIAN_SITES = frozenset({"normal", "mv_normal_diag", "mv_normal"})


def _check_gaussian_sites(tr, sel, path=()):
    """Raise if a statically selected distribution site of ``tr`` is not
    Gaussian. Combinator trace nodes and tensor selection flags are
    skipped; plain ``@gen`` nesting is checked whole."""
    from genjax_torch.lang.distributions.distribution import (
        DistributionTrace,
    )
    from genjax_torch.lang.static import StaticTrace

    if isinstance(tr, DistributionTrace):
        flag = sel.check()
        if not isinstance(flag, (bool, int)) or not flag:
            return
        name = getattr(tr.gen_fn, "name", None)
        if name not in _GAUSSIAN_SITES:
            raise ValueError(
                f"EllipticalSlice: selected site {path} is a '{name}' "
                "distribution — the elliptical slice transition is only "
                "valid for (conditionally) Gaussian priors "
                f"({', '.join(sorted(_GAUSSIAN_SITES))}). Select only "
                "Gaussian sites, use Regenerate/HMC for this one, or — "
                "if the site IS a custom Gaussian density the name "
                "check cannot recognize — pass "
                "EllipticalSlice(..., check_gaussian=False).")
        return
    if isinstance(tr, StaticTrace):
        for addr, sub in zip(tr.addresses, tr.subtraces):
            _check_gaussian_sites(sub, sel(addr), path + (addr,))


@Pytree.dataclass
class EllipticalSlice(EditRequest):
    """ESS over the selected choices, whose prior given everything
    unselected must be Gaussian (checked at edit time for plain
    ``@gen`` nesting; ``check_gaussian=False`` skips the check for a
    custom Gaussian density). The edit weight is 0."""

    selection: Selection
    prior_mean: Any = 0.0
    max_iters: int = Pytree.static(default=64)
    check_gaussian: bool = Pytree.static(default=True)

    def edit(self, key, tr: Trace[Any], argdiffs: Argdiffs):
        assert Diff.static_check_no_change(argdiffs)
        if self.check_gaussian:
            _check_gaussian_sites(tr, self.selection)
        args = Diff.tree_primal(argdiffs)
        batch = tr.batch_shape()
        chm = tr.get_choices()
        complement = chm.filter(~self.selection)
        vals, rebuild = partition_values(chm.filter(self.selection))
        flat, unravel_vals = ravel_pytree(vals, len(batch))
        gen_fn = tr.get_gen_fn()
        # The per-site key of project is consumed only by
        # stochastic-density sites; Gaussian priors are exact.
        proj_key = random.key(0, device=key.device).expand(batch + (2,))

        def loglik(z_vec):
            new_tr, _ = gen_fn.generate(
                proj_key, rebuild(unravel_vals(z_vec)) | complement, args)
            return new_tr.get_score() - new_tr.project(proj_key,
                                                       self.selection)

        key, nu_key, kern_key, up_key = random.split(key, 4).unbind(-2)
        nu_tr, _ = gen_fn.generate(nu_key, complement, args)
        nu_vals, _ = partition_values(
            nu_tr.get_choices().filter(self.selection))
        nu, _ = ravel_pytree(nu_vals, len(batch))
        mean = self.prior_mean
        if not isinstance(mean, (int, float)):
            mean, _ = ravel_pytree(mean)
        z_next, _ = elliptical_slice_kernel(loglik, flat, nu, kern_key, mean,
                                            self.max_iters)
        new_tr, _, retdiff, _ = Update(rebuild(unravel_vals(z_next))).edit(
            up_key, tr, argdiffs)
        return (new_tr, torch.zeros(batch, device=key.device), retdiff,
                EllipticalSlice(self.selection, self.prior_mean,
                                self.max_iters, self.check_gaussian))
