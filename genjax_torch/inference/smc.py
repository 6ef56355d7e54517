"""Sequential Monte Carlo: weighted particle collections, importance
sampling (SIR) and systematic resampling (counterpart of
``genjax_tpu/inference/smc.py``).

The particle axis is written out: ``ImportanceK`` runs the target's
``importance`` once on a batch of ``K`` keys (``core/random.py``) rather
than under ``vmap``, the target's arguments and constraint values lifted
to the batch first (``batched_importance``). Systematic resampling goes
through the CDF->counts kernel (``ops/cdf_counts.py``) for a CUDA tensor
and expands with ``repeat_interleave``, the JAX package's own CPU path;
a leaf marked invariant (the same in every particle) is not moved.

Not ported yet: ``ChangeTarget``, so the GenSP / VI methods of
``SMCAlgorithm``, and ``resample_values(_rows)``.
"""

from __future__ import annotations

import abc
import math

import torch

from genjax_torch.core import random
from genjax_torch.core.pytree import (
    Pytree,
    tree_flatten,
    tree_map,
    tree_unflatten,
)
from genjax_torch.gfi.choice_map import ChoiceMap, lift_values
from genjax_torch.gfi.gfn import Trace
from genjax_torch.inference.sp import Algorithm, Target
from genjax_torch.ops.cdf_counts import systematic_cumulative

__all__ = [
    "ParticleCollection",
    "resample_tree",
    "systematic_offspring_cumulative",
    "systematic_offspring_counts",
    "SMCAlgorithm",
    "Importance",
    "ImportanceK",
    "effective_sample_size",
    "resample_indices",
    "batched_importance",
    "invariant_leaf_mask",
]


def effective_sample_size(log_weights: torch.Tensor) -> torch.Tensor:
    """ESS = (Σw)² / Σw² of the normalized weights, in [1, K]."""
    lw = log_weights - torch.logsumexp(log_weights, dim=0)
    return torch.exp(-torch.logsumexp(2.0 * lw, dim=0))


def systematic_offspring_cumulative(key, log_weights: torch.Tensor,
                                    n: int) -> torch.Tensor:
    """Inclusive cumulative offspring counts of systematic resampling
    (``counts_cum[i]`` = dests assigned to particles ``0..i``), with the
    ``cummax`` monotone repair and the last entry pinned to ``n``: the
    CDF->counts kernel on a CUDA tensor, its plain version on the CPU."""
    return systematic_cumulative(key, log_weights, n)


def systematic_offspring_counts(key, log_weights: torch.Tensor,
                                n: int) -> torch.Tensor:
    """Per-particle offspring counts of systematic resampling."""
    cc = systematic_offspring_cumulative(key, log_weights, n)
    return torch.diff(cc, prepend=torch.zeros(1, dtype=cc.dtype,
                                              device=cc.device))


def _ancestors_from_counts(counts_cum: torch.Tensor, n: int) -> torch.Tensor:
    """Sorted ancestor indices from cumulative counts by scatter-add +
    cumsum; a particle whose start lands at ``n`` marks nothing."""
    k = counts_cum.shape[0]
    starts = torch.cat([torch.zeros(1, dtype=torch.int64,
                                    device=counts_cum.device),
                        counts_cum[:-1].to(torch.int64)])
    marks = torch.zeros(n + 1, dtype=torch.int64, device=counts_cum.device)
    marks.index_add_(0, starts, torch.ones_like(starts))
    return torch.clamp(torch.cumsum(marks[:n], 0) - 1, 0, k - 1)


def resample_indices(key, log_weights: torch.Tensor, n: int,
                     method: str = "systematic") -> torch.Tensor:
    """``n`` sorted ancestor indices drawn proportionally to
    ``exp(log_weights)``."""
    k = log_weights.shape[0]
    if method == "systematic":
        cc = systematic_offspring_cumulative(key, log_weights, n)
        return _ancestors_from_counts(cc, n)
    cum = torch.cumsum(torch.softmax(log_weights, dim=0), dim=0)
    dev = log_weights.device
    if method == "stratified":
        us = (random.uniform(key.to(dev), (n,))
              + torch.arange(n, device=dev)) / n
    elif method == "multinomial":
        es = -torch.log1p(-random.uniform(key.to(dev), (n + 1,)))
        us = torch.cumsum(es, 0)[:-1] / es.sum()
    else:
        raise ValueError(f"Unknown resampling method: {method!r}")
    # side='right': a grid point on a shared boundary skips a
    # zero-weight particle, the owner convention of the JAX package.
    return torch.clamp(torch.searchsorted(cum, us, right=True), 0, k - 1)


def resample_tree(key, log_weights: torch.Tensor, tree, n: int,
                  method: str = "systematic", invariant=None):
    """Resample every leaf of ``tree`` (leading axis = particles).

    Systematic: offspring counts, then ``repeat_interleave`` with a fixed
    ``output_size`` (no host sync). Others: ancestor indices and a
    gather. ``invariant``: a pytree of bools matching ``tree``'s leaves,
    True for a leaf that is the same in every particle
    (:func:`invariant_leaf_mask`); such a leaf is returned untouched, cut
    or broadcast to ``n`` rows as a view, so the mask changes only the
    cost, never the result."""
    if invariant is not None:
        leaves, spec = tree_flatten(tree)
        inv = tree_flatten(invariant)[0]
        if len(inv) != len(leaves):
            raise ValueError("invariant mask and tree differ in their leaves")
        moved = iter(resample_tree(
            key, log_weights, [v for v, i in zip(leaves, inv) if not i], n,
            method))
        return tree_unflatten(
            [_rows(v, n) if i else next(moved) for v, i in zip(leaves, inv)],
            spec)
    if method == "systematic":
        counts = systematic_offspring_counts(key, log_weights, n)
        return tree_map(
            lambda v: torch.repeat_interleave(v, counts, dim=0,
                                              output_size=n),
            tree,
        )
    idx = resample_indices(key, log_weights, n, method)
    return tree_map(lambda v: v[idx], tree)


def _rows(v: torch.Tensor, n: int) -> torch.Tensor:
    """``n`` rows of a leaf whose rows are all equal, as a view."""
    if v.shape[0] >= n:
        return v[:n]
    return v[:1].expand((n,) + tuple(v.shape[1:]))


def invariant_leaf_mask(tree):
    """True for each leaf that is the same in every particle by
    construction: a zero-stride expansion along the particle axis, as the
    lifted arguments and constraint values of a batched run are (the
    counterpart of the JAX package's ``variant_leaf_mask``, which finds
    them by taint analysis)."""
    return tree_map(
        lambda v: isinstance(v, torch.Tensor) and v.ndim >= 1
        and v.shape[0] > 1 and v.stride(0) == 0, tree)


def _lift_to(v, k: int, device):
    t = v if isinstance(v, torch.Tensor) else torch.as_tensor(v,
                                                              device=device)
    return t.expand((k,) + tuple(t.shape))


def _particle_leaves(tree, k: int, device):
    """Every leaf of a ``k``-particle trace with the leading particle
    axis. A tensor carries it already (every tensor of a batched trace
    leads with the batch, ``gfi/gfn.py``); a Python number, the same in
    every particle, is expanded to a zero-stride view. No leaf is judged
    by its length."""

    def lift(v):
        if isinstance(v, torch.Tensor):
            if v.ndim == 0 or v.shape[0] != k:
                raise ValueError(
                    f"a tensor of shape {tuple(v.shape)} in a {k}-particle "
                    "trace: every tensor of a batched trace leads with the "
                    "batch")
            return v
        return _lift_to(v, k, device)

    return tree_map(lift, tree)


def lift_target(target: Target, k: int, device) -> Target:
    """``target`` with its tensor arguments and constraint values lifted
    to ``k`` executions as zero-stride views."""
    args = tree_map(lambda v: _lift_to(v, k, device)
                    if isinstance(v, torch.Tensor) else v, target.args)
    return Target(target.p, args,
                  lift_values(target.constraint, (k,), device))


def batched_importance(target: Target, keys, chm: ChoiceMap):
    """``target.importance`` on a batch of ``K`` keys ``(K, 2)``: the
    target's arguments and constraint values (and ``chm``'s) are lifted
    to the ``K`` particles as zero-stride views, and every leaf of the
    traces has the particle axis (:func:`_particle_leaves`). Returns
    ``(traces, weights)``."""
    k = keys.shape[0]
    lifted = lift_target(target, k, keys.device)
    trs, ws = lifted.importance(keys, lift_values(chm, (k,), keys.device))
    return (_particle_leaves(trs, k, keys.device),
            torch.as_tensor(ws, device=keys.device).expand(k))


def _one_particle(tree, device):
    """A one-particle batch: every leaf gains a leading axis of 1."""
    return tree_map(lambda v: torch.as_tensor(v, device=device)[None], tree)


def _stack_end(xs, x):
    """Append ``x`` as the last lane of batched ``xs`` (leafwise)."""
    return tree_map(
        lambda a, b: torch.cat([a, torch.as_tensor(b, device=a.device)
                                .to(a.dtype)[None]], dim=0),
        xs, x,
    )


@Pytree.dataclass
class ParticleCollection(Pytree):
    """Weighted particles: batched traces (axis 0 = particle axis), log
    importance weights and a validity flag."""

    particles: Trace
    log_weights: torch.Tensor
    is_valid: torch.Tensor

    def get_particles(self) -> Trace:
        return self.particles

    def get_particle(self, idx) -> Trace:
        return tree_map(lambda v: v[idx], self.particles)

    def get_log_weights(self) -> torch.Tensor:
        return self.log_weights

    def num_particles(self) -> int:
        return self.log_weights.shape[0]

    def get_log_marginal_likelihood_estimate(self) -> torch.Tensor:
        return (torch.logsumexp(self.log_weights, dim=0)
                - math.log(self.num_particles()))

    def effective_sample_size(self) -> torch.Tensor:
        return effective_sample_size(self.log_weights)

    def __getitem__(self, idx):
        return tree_map(lambda v: v[idx], (self.particles, self.log_weights))

    def sample_particle(self, key) -> Trace:
        idx = random.categorical(key.to(self.log_weights.device),
                                 self.log_weights)
        return self.get_particle(idx)

    def resample(self, key, method: str = "systematic") -> "ParticleCollection":
        """Equal-weight collection; the log-Z contribution moves into the
        uniform weights so that the estimate telescopes across steps."""
        n = self.num_particles()
        new_particles = resample_tree(key, self.log_weights, self.particles,
                                      n, method)
        logz = self.get_log_marginal_likelihood_estimate()
        return ParticleCollection(new_particles, logz.expand(n).clone(),
                                  self.is_valid)


class SMCAlgorithm(Algorithm):
    """Abstract SMC algorithm, defined by ``run_smc`` and ``run_csmc``.

    The GenSP and VI methods compose with ``ChangeTarget``, which is not
    ported yet; they raise."""

    @abc.abstractmethod
    def get_num_particles(self) -> int: ...

    @abc.abstractmethod
    def get_final_target(self) -> Target: ...

    @abc.abstractmethod
    def run_smc(self, key) -> ParticleCollection: ...

    @abc.abstractmethod
    def run_csmc(self, key, retained: ChoiceMap) -> ParticleCollection: ...

    def log_marginal_likelihood_estimate(self, key, target: Target | None = None):
        if target is not None:
            self._needs_change_target()
        _, sub_key = random.split(key).unbind(-2)
        return self.run_smc(sub_key).get_log_marginal_likelihood_estimate()

    @staticmethod
    def _needs_change_target():
        raise NotImplementedError(
            "ChangeTarget is not ported yet (ROADMAP queue 1): the GenSP "
            "and VI methods of SMC algorithms need it."
        )

    def random_weighted(self, key, *args):
        self._needs_change_target()

    def estimate_logpdf(self, key, v, *args):
        self._needs_change_target()

    def estimate_normalizing_constant(self, key, target):
        self._needs_change_target()

    def estimate_reciprocal_normalizing_constant(self, key, target,
                                                 latent_choices, w):
        self._needs_change_target()


@Pytree.dataclass
class Importance(SMCAlgorithm):
    """1-particle importance sampling from ``target``'s own prior (the
    proposal ``q`` of the JAX package comes with ``ChangeTarget``)."""

    target: Target | None = None

    def get_num_particles(self) -> int:
        return 1

    def get_final_target(self) -> Target:
        assert self.target is not None
        return self.target

    def run_smc(self, key) -> ParticleCollection:
        key, _ = random.split(key).unbind(-2)
        tr, w = self.get_final_target().importance(key, ChoiceMap.empty())
        return ParticleCollection(_one_particle(tr, key.device),
                                  torch.atleast_1d(w), torch.tensor(True))

    def run_csmc(self, key, retained: ChoiceMap):
        key, sub_key = random.split(key).unbind(-2)
        tr, w = self.get_final_target().importance(key, retained)
        # The retained particle is weighted as a free one would be:
        # w = log p(v) - log r(v), r the ancestral prior of the retained
        # addresses (the JAX package's deliberate deviation from its
        # reference, smc.py:661-670).
        w = w - tr.project(sub_key, retained.get_selection())
        return ParticleCollection(_one_particle(tr, key.device),
                                  torch.atleast_1d(w), torch.tensor(True))


@Pytree.dataclass
class ImportanceK(SMCAlgorithm):
    """K-particle sampling-importance-resampling from ``target``'s prior,
    the particle axis a key batch of ``K`` (the proposal ``q`` of the JAX
    package comes with ``ChangeTarget``)."""

    target: Target | None = None
    k_particles: int = Pytree.static(default=2)

    def get_num_particles(self) -> int:
        return self.k_particles

    def get_final_target(self) -> Target:
        assert self.target is not None
        return self.target

    def _batched_importance(self, keys, choices):
        return batched_importance(self.get_final_target(), keys, choices)

    def run_smc(self, key) -> ParticleCollection:
        _, sub_key = random.split(key).unbind(-2)
        trs, ws = self._batched_importance(
            random.split(sub_key, self.k_particles), ChoiceMap.empty())
        return ParticleCollection(trs, ws, torch.tensor(True))

    def run_csmc(self, key, retained: ChoiceMap):
        """K − 1 free particles and, last, the retained one, weighted as in
        :meth:`Importance.run_csmc`."""
        key, sub_key = random.split(key).unbind(-2)
        free_trs, free_ws = self._batched_importance(
            random.split(sub_key, self.k_particles - 1), ChoiceMap.empty())
        key, proj_key = random.split(key).unbind(-2)
        ret_tr, ret_w = self.get_final_target().importance(key, retained)
        ret_w = ret_w - ret_tr.project(proj_key, retained.get_selection())
        return ParticleCollection(_stack_end(free_trs, ret_tr),
                                  _stack_end(free_ws, ret_w),
                                  torch.tensor(True))
