"""Sequential Monte Carlo: weighted particle collections, importance
sampling (SIR), conditional SMC, target-change reweighting and the
resampling primitives (counterpart of ``genjax_tpu/inference/smc.py``).

The particle axis is written out: ``ImportanceK`` runs the target's
``importance`` once on a batch of ``K`` keys (``core/random.py``) rather
than under ``vmap``, the target's arguments and constraint values lifted
to the batch first (``batched_importance``). Systematic resampling goes
through the CDF->counts kernel (``ops/cdf_counts.py``) for a CUDA tensor
and expands with ``repeat_interleave``, the JAX package's own CPU path;
a leaf marked invariant (the same in every particle) is not moved.

Nested batches: every algorithm takes a key ``B + (2,)`` and runs ``B``
executions; its particles carry the axis ``K`` right behind ``B``
(traces ``B + (K,) + ...``, weights ``B + (K,)``), as a combinator puts
its lane axis (``gfi/gfn.py``). So a ``Marginal`` used as a site of a
batched ``@gen`` function, or as the proposal of ``ImportanceK``, runs
one inner algorithm per execution. ``B`` is ``()`` at top level.

The row resamplers (``resample_values(_rows)``) keep the JAX package's
contract, not its O(n·K) interval-compare formulation (a TPU cost-model
workaround): the owner of destination ``i`` is found by
``searchsorted`` in the cumulative counts, then gathered.
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
from genjax_torch.inference.sp import Algorithm, SampleDistribution, Target
from genjax_torch.ops.cdf_counts import systematic_cumulative

__all__ = [
    "ParticleCollection",
    "resample_tree",
    "systematic_offspring_cumulative",
    "systematic_offspring_counts",
    "SMCAlgorithm",
    "Importance",
    "ImportanceK",
    "ChangeTarget",
    "effective_sample_size",
    "resample_indices",
    "resample_indices_rows",
    "resample_indices_sorted",
    "resample_values",
    "resample_values_rows",
    "batched_importance",
    "invariant_leaf_mask",
]


def effective_sample_size(log_weights: torch.Tensor) -> torch.Tensor:
    """ESS = (Σw)² / Σw² of the normalized weights over the last axis,
    in [1, K]."""
    lw = log_weights - torch.logsumexp(log_weights, dim=-1, keepdim=True)
    return torch.exp(-torch.logsumexp(2.0 * lw, dim=-1))


def _step_keys(key, n_steps: int, n_split: int):
    """``split(fold_in(key, t), n_split)`` for every ``t < n_steps`` at
    once, ``B + (n_steps, n_split, 2)`` for a key batch ``B + (2,)``: a
    sampler's step keys derived before its loop, so that the loop issues
    no key arithmetic."""
    steps = torch.arange(n_steps, device=key.device)
    return random.split(random.fold_in(key[..., None, :], steps), n_split)


def _softmax(lw: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softmax`` over the last axis: ``e / sum(e)``."""
    e = torch.exp(lw - lw.max(dim=-1, keepdim=True).values)
    return e / e.sum(dim=-1, keepdim=True)


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


def _grid(key, lead: tuple, n: int, method: str,
          row_offset: int = 0) -> torch.Tensor:
    """The sorted uniforms ``lead + (n,)`` of a grid-based draw: one
    offset a row (systematic), one a cell (stratified), or normalized
    exponential spacings (multinomial). ``lead`` is the per-key shape in
    front of the grid axis; ``row_offset``: these are rows
    ``[row_offset, ...)`` of a larger draw of the same key (``lead`` one
    axis), bit for bit."""
    dev = key.device
    if method == "systematic":
        u = random.uniform(key, lead + (1,), offset=row_offset)
    elif method == "stratified":
        u = random.uniform(key, lead + (n,), offset=row_offset * n)
    elif method == "multinomial":
        return _spacings(random.exponential(key, lead + (n + 1,),
                                            offset=row_offset * (n + 1)))
    else:
        raise ValueError(f"Unknown resampling method: {method!r}")
    return (u + torch.arange(n, dtype=torch.float32, device=dev)) / n


def _spacings(es: torch.Tensor) -> torch.Tensor:
    """Sorted uniforms from ``n + 1`` exponential draws (the last axis):
    their normalized partial sums."""
    return torch.cumsum(es[..., :-1], -1) / es.sum(-1, keepdim=True)


def _owners(cum: torch.Tensor, us: torch.Tensor) -> torch.Tensor:
    """``#{cum <= u}`` per query, clipped to a source: side 'right', so a
    grid point on a shared boundary skips a zero-weight particle (the
    JAX package's owner convention, ``_sorted_searchsorted``)."""
    k = cum.shape[-1]
    return torch.clamp(torch.searchsorted(cum.contiguous(), us.contiguous(),
                                          right=True), 0, k - 1)


def resample_indices(key, log_weights: torch.Tensor, n: int,
                     method: str = "systematic") -> torch.Tensor:
    """``n`` sorted ancestor indices drawn proportionally to
    ``exp(log_weights)``. A key batch ``B + (2,)`` with weights
    ``B + (K,)`` draws each row on its own key, as the JAX function does
    under ``vmap``: systematic rows take the plain f32 counts of
    :func:`_counts_cum_rows` (the CDF kernel is one row a launch)."""
    key = key.to(log_weights.device)
    if method == "systematic":
        if log_weights.ndim > 1:
            return _owners_of_counts(_counts_cum_rows(
                random.uniform(key, ()), log_weights, n), n)
        cc = systematic_offspring_cumulative(key, log_weights, n)
        return _ancestors_from_counts(cc, n)
    if method not in ("stratified", "multinomial"):
        raise ValueError(f"Unknown resampling method: {method!r}")
    cum = torch.cumsum(_softmax(log_weights), dim=-1)
    return _owners(cum, _grid(key, (), n, method))


def resample_indices_sorted(key, log_weights: torch.Tensor, n: int,
                            method: str = "systematic") -> torch.Tensor:
    """Sorted ancestors by inverting the softmax CDF at a sorted grid
    (the JAX package's per-row primitive of the SMC² inner filters). A
    key batch ``B + (2,)`` with weights ``B + (K,)`` draws each row from
    its own key, as the JAX function does under ``vmap``."""
    key = key.to(log_weights.device)
    cum = torch.cumsum(_softmax(log_weights), dim=-1)
    return _owners(cum, _grid(key, (), n, method))


def resample_indices_rows(key, log_weights: torch.Tensor, n: int,
                          method: str = "multinomial",
                          row_offset: int = 0) -> torch.Tensor:
    """Row-batched :func:`resample_indices`: ``(R, K)`` log-weights ->
    ``(R, n)`` sorted ancestors from ONE key, all randomness in single
    batched draws (``systematic``: one grid offset a row).
    ``row_offset``: the rows are ``[row_offset, row_offset + R)`` of a
    larger row batch on the same key (a rank's θ-rows), whose grid draw
    they take bit for bit."""
    key = key.to(log_weights.device)
    r = log_weights.shape[0]
    cum = torch.cumsum(_softmax(log_weights), dim=-1)
    return _owners(cum, _grid(key, (r,), n, method, row_offset))


#: The JAX package's row-scale line: its interval form of
#: ``resample_values`` compares every source with every destination,
#: and refuses more than 2^28 pairs. The guard is its API and is kept,
#: though the port's searchsorted form is O(n log K).
_ROW_SCALE_MAX_PAIRS = 1 << 28


def _check_row_scale(k: int, n: int) -> None:
    if k * n > _ROW_SCALE_MAX_PAIRS:
        raise ValueError(
            f"resample_values: {k} sources x {n} dests = {k * n:,} "
            "interval-compare pairs — this fused form is for ROW-scale "
            "ensembles (inner filters, ~1024 lanes); use resample_tree "
            "(blocked O(n) expansion) for flat ensembles."
        )


def _counts_cum_rows(u0: torch.Tensor, log_weights: torch.Tensor,
                     n: int) -> torch.Tensor:
    """f32 cumulative systematic offspring counts of each row of
    ``log_weights`` (``B + (K,)``) at grid offsets ``u0`` (``B``): the JAX
    package's pipeline, ``exp(lw − max)``, cumsum, cummax,
    ``ceil(cum·(n/cum[-1]) − u0)`` clipped to ``[0, n]``, last entry
    ``n``."""
    m = log_weights.max(dim=-1, keepdim=True).values
    cum = torch.cummax(torch.cumsum(torch.exp(log_weights - m), dim=-1),
                       dim=-1).values
    cc = torch.clamp(torch.ceil(cum * (n / cum[..., -1:]) - u0[..., None]),
                     0.0, float(n))
    cc[..., -1] = float(n)
    return cc


def _take(v: torch.Tensor, idx: torch.Tensor, axis: int) -> torch.Tensor:
    """``v`` gathered at ``idx`` (``v.shape[:axis] + (n,)``) along
    ``axis``, the index broadcast over ``v``'s trailing event axes."""
    idx = idx.reshape(tuple(idx.shape) + (1,) * (v.ndim - idx.ndim))
    return torch.take_along_dim(v, idx, dim=axis)


def _owners_of_counts(cc: torch.Tensor, n: int) -> torch.Tensor:
    """The source ``k`` with ``cc[k-1] <= i < cc[k]`` of every
    destination ``i`` in every row: ``#{cc <= i}``, a searchsorted of the
    destinations in the row's counts."""
    ii = torch.arange(n, dtype=cc.dtype, device=cc.device)
    return _owners(cc, ii.expand(tuple(cc.shape[:-1]) + (n,)))


def _expand_by_counts(cc: torch.Tensor, values, n: int):
    """``out[i] = values[k]`` for the ``k`` with ``cc[k-1] <= i < cc[k]``
    in every row: the owners, then a gather."""
    own = _owners_of_counts(cc, n)
    axis = cc.ndim - 1
    return tree_map(lambda v: _take(v, own, axis), values)


def resample_values(key, log_weights: torch.Tensor, values, n: int):
    """Systematic resample of a ``(K,)``-rowed ``values`` pytree,
    returning the resampled VALUES. A key batch ``B + (2,)`` with weights
    ``B + (K,)`` and values ``B + (K,) + ...`` resamples each row on its
    own key (one grid offset ``uniform(key, ())`` a row), as the JAX
    function does under ``vmap``. Same owner convention as
    :func:`resample_indices_sorted` up to f32 boundary ties. Row scale
    only (the JAX package's guard, kept)."""
    _check_row_scale(log_weights.shape[-1], n)
    u0 = random.uniform(key.to(log_weights.device), ())
    return _expand_by_counts(_counts_cum_rows(u0, log_weights, n), values, n)


def resample_values_rows(key, log_weights: torch.Tensor, values, n: int,
                         row_offset: int = 0):
    """Row-batched :func:`resample_values`: ``(R, K)`` log-weights and
    value leaves -> ``(R, n)`` resampled values, one grid offset a row
    from a single batched draw of ONE key (the SMC² advance step).
    ``row_offset`` as in :func:`resample_indices_rows`."""
    _check_row_scale(log_weights.shape[-1], n)
    r = log_weights.shape[0]
    u0 = random.uniform(key.to(log_weights.device), (r, 1),
                        offset=row_offset)[:, 0]
    return _expand_by_counts(_counts_cum_rows(u0, log_weights, n), values, n)


def resample_tree(key, log_weights: torch.Tensor, tree, n: int,
                  method: str = "systematic", invariant=None):
    """Resample every leaf of ``tree`` (leading axis = particles).

    Systematic: offspring counts, then ``repeat_interleave`` with a fixed
    ``output_size`` (no host sync). Others: ancestor indices and a
    gather. A key batch ``B + (2,)`` with weights ``B + (K,)`` and leaves
    ``B + (K,) + ...`` resamples every row on its own key in one pass:
    the row ancestors of :func:`resample_indices` and a gather along the
    particle axis. ``invariant`` (unbatched weights only): a pytree of bools matching ``tree``'s leaves,
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
    axis = log_weights.ndim - 1
    if method == "systematic" and axis == 0:
        counts = systematic_offspring_counts(key, log_weights, n)
        return _tensor_map(
            lambda v: torch.repeat_interleave(v, counts, dim=0,
                                              output_size=n),
            tree,
        )
    idx = resample_indices(key, log_weights, n, method)
    return _tensor_map(lambda v: _take(v, idx, axis), tree)


def _tensor_map(fn, tree):
    """``fn`` on every tensor leaf; a Python value in a batched trace (a
    distribution's constant parameter) is the same in every particle and
    passes as it is."""
    return tree_map(lambda v: fn(v) if isinstance(v, torch.Tensor) else v,
                    tree)


def _rows(v: torch.Tensor, n: int) -> torch.Tensor:
    """``n`` rows of a leaf whose rows are all equal, as a view."""
    if not isinstance(v, torch.Tensor):
        return v
    if v.shape[0] >= n:
        return v[:n]
    return v[:1].expand((n,) + tuple(v.shape[1:]))


def invariant_leaf_mask(tree):
    """True for each leaf that is the same in every particle by
    construction: a zero-stride expansion along the particle axis, as the
    lifted arguments and constraint values of a batched run are (the
    counterpart of the JAX package's ``variant_leaf_mask``, which finds
    them by taint analysis), and a Python value."""
    return tree_map(
        lambda v: not isinstance(v, torch.Tensor) or (
            v.ndim >= 1 and v.shape[0] > 1 and v.stride(0) == 0), tree)


def _lift(v, outer: tuple, k: int, device) -> torch.Tensor:
    """``v`` given a particle axis of ``k`` behind the batch ``outer`` it
    carries, as a zero-stride view; a 0-d value or a Python number is the
    same in every execution. Any other tensor must lead with ``outer``."""
    t = v if isinstance(v, torch.Tensor) else torch.as_tensor(v,
                                                              device=device)
    r = len(outer)
    if r and t.ndim == 0:
        return t.expand(outer + (k,))
    if tuple(t.shape[:r]) != outer:
        raise ValueError(
            f"a tensor of shape {tuple(t.shape)} under the batch {outer}: "
            "every tensor argument of a batched call leads with the batch")
    return t.unsqueeze(r).expand(outer + (k,) + tuple(t.shape[r:]))


def _particle_leaves(tree, batch: tuple, device):
    """Every leaf of a batched trace with the batch ``batch`` (the
    caller's ``B`` and the particle axis). A tensor carries it already
    (every tensor of a batched trace leads with the batch,
    ``gfi/gfn.py``); a Python number, the same in every particle, is
    expanded to a zero-stride view. No leaf is judged by its length."""

    def lift(v):
        if isinstance(v, torch.Tensor):
            if tuple(v.shape[:len(batch)]) != batch:
                raise ValueError(
                    f"a tensor of shape {tuple(v.shape)} in a trace of the "
                    f"batch {batch}: every tensor of a batched trace leads "
                    "with the batch")
            return v
        return torch.as_tensor(v, device=device).expand(batch)

    return tree_map(lift, tree)


def lift_target(target: Target, k: int, device, outer: tuple = ()) -> Target:
    """``target`` with its tensor arguments and constraint values lifted
    to ``k`` particles behind the batch ``outer``, as zero-stride views."""
    outer = tuple(outer)
    args = tree_map(lambda v: _lift(v, outer, k, device)
                    if isinstance(v, torch.Tensor) else v, target.args)
    return Target(target.p, args,
                  lift_values(target.constraint, (k,), device, outer))


def batched_importance(target: Target, keys, chm: ChoiceMap,
                       per_particle: bool = False):
    """``target.importance`` on a batch of keys ``B + (K, 2)``: ``B``
    executions of ``K`` particles each. The target's arguments and
    constraint values are lifted to the particles as zero-stride views;
    ``chm`` is lifted too unless ``per_particle`` says that its values
    carry ``B + (K,)`` already (each particle's own choices). Every leaf
    of the traces has the batch ``B + (K,)``. Returns ``(traces,
    weights)``."""
    outer, k = tuple(keys.shape[:-2]), keys.shape[-2]
    dev = keys.device
    lifted = lift_target(target, k, dev, outer)
    if not per_particle:
        chm = lift_values(chm, (k,), dev, outer)
    trs, ws = lifted.importance(keys, chm)
    batch = outer + (k,)
    return (_particle_leaves(trs, batch, dev),
            torch.as_tensor(ws, device=dev).expand(batch))


def _index_particles(tree, idx, axis: int):
    """Particle ``idx`` of every leaf: an int or a 0-d index for every
    execution, or a tensor of the batch's shape (one per execution)."""
    if isinstance(idx, torch.Tensor) and idx.ndim:
        return tree_map(
            lambda v: _take(v, idx.to(v.device)[..., None], axis)
            .squeeze(axis), tree)
    lead = (slice(None),) * axis
    return tree_map(lambda v: v[lead + (idx,)], tree)


def _stack_end(xs, x, axis: int):
    """Append the one-particle batch ``x`` as the last particle of
    ``xs`` (leafwise, along the particle axis ``axis``)."""
    return tree_map(
        lambda a, b: torch.cat([a, torch.as_tensor(b, device=a.device)
                                .to(a.dtype).expand(
                                    a.shape[:axis] + (1,)
                                    + a.shape[axis + 1:])], dim=axis),
        xs, x,
    )


def _one(key):
    """A key batch ``B + (2,)`` as ``B + (1, 2)``: one particle an
    execution, on the same key data."""
    return key[..., None, :]


@Pytree.dataclass
class ParticleCollection(Pytree):
    """Weighted particles: batched traces, log importance weights and a
    validity flag. The particle axis is the last axis of the weights
    (``B + (K,)``), and every leaf of the traces has it at the same
    place."""

    particles: Trace
    log_weights: torch.Tensor
    is_valid: torch.Tensor

    def _axis(self) -> int:
        return self.log_weights.ndim - 1

    def get_particles(self) -> Trace:
        return self.particles

    def get_particle(self, idx) -> Trace:
        return _index_particles(self.particles, idx, self._axis())

    def get_log_weights(self) -> torch.Tensor:
        return self.log_weights

    def num_particles(self) -> int:
        return self.log_weights.shape[-1]

    def get_log_marginal_likelihood_estimate(self) -> torch.Tensor:
        return (torch.logsumexp(self.log_weights, dim=-1)
                - math.log(self.num_particles()))

    def effective_sample_size(self) -> torch.Tensor:
        return effective_sample_size(self.log_weights)

    def __getitem__(self, idx):
        return _index_particles((self.particles, self.log_weights), idx,
                                self._axis())

    def sample_particle(self, key) -> Trace:
        """One particle an execution, drawn with probability ∝ weight."""
        idx = random.categorical(key.to(self.log_weights.device),
                                 self.log_weights)
        return self.get_particle(idx)

    def resample(self, key, method: str = "systematic") -> "ParticleCollection":
        """Equal-weight collection; the log-Z contribution moves into the
        uniform weights so that the estimate telescopes across steps.
        Each execution of a batch resamples its own row on its own key."""
        new_particles = resample_tree(key.to(self.log_weights.device),
                                      self.log_weights, self.particles,
                                      self.num_particles(), method)
        logz = self.get_log_marginal_likelihood_estimate()
        return ParticleCollection(new_particles,
                                  logz[..., None].expand(
                                      self.log_weights.shape).clone(),
                                  self.is_valid)


def _split(key):
    return random.split(key).unbind(-2)


class SMCAlgorithm(Algorithm):
    """Abstract SMC algorithm, defined by ``run_smc`` and ``run_csmc``;
    the GenSP and VI methods compose with :class:`ChangeTarget`."""

    @abc.abstractmethod
    def get_num_particles(self) -> int: ...

    @abc.abstractmethod
    def get_final_target(self) -> Target: ...

    @abc.abstractmethod
    def run_smc(self, key) -> ParticleCollection: ...

    @abc.abstractmethod
    def run_csmc(self, key, retained: ChoiceMap) -> ParticleCollection: ...

    # -- convenience -------------------------------------------------------

    def log_marginal_likelihood_estimate(self, key,
                                         target: Target | None = None):
        alg = ChangeTarget(self, target) if target is not None else self
        _, sub_key = _split(key)
        return alg.run_smc(sub_key).get_log_marginal_likelihood_estimate()

    # -- GenSP -------------------------------------------------------------

    def random_weighted(self, key, *args):
        target: Target = args[0]
        alg = ChangeTarget(self, target)
        key, sub_key = _split(key)
        collection = alg.run_smc(key)
        particle = collection.sample_particle(sub_key)
        log_density_estimate = (
            particle.get_score()
            - collection.get_log_marginal_likelihood_estimate())
        chm = target.filter_to_unconstrained(particle.get_choices())
        return log_density_estimate, chm

    def estimate_logpdf(self, key, v: ChoiceMap, *args):
        """Density estimate at ``v``: log p̃(v) − log Ẑ_csmc(v), from the
        *retained* particle's score (the JAX package's choice: exactly
        unbiased for the algorithm's output density)."""
        target: Target = args[0]
        collection = ChangeTarget(self, target).run_csmc(key, v)
        return (collection.get_particle(-1).get_score()
                - collection.get_log_marginal_likelihood_estimate())

    # -- VI hooks ----------------------------------------------------------

    def estimate_normalizing_constant(self, key, target: Target):
        _, sub_key = _split(key)
        return (ChangeTarget(self, target).run_smc(sub_key)
                .get_log_marginal_likelihood_estimate())

    def estimate_reciprocal_normalizing_constant(self, key, target: Target,
                                                 latent_choices: ChoiceMap,
                                                 w):
        """−logẐ from the retained-pair CSMC ensemble."""
        return -ChangeTarget(self, target).run_csmc_for_normalizing_constant(
            key, latent_choices, w)

    def estimate_marginal_density(self, key, target: Target,
                                  latent_choices: ChoiceMap, w):
        """+logẐ of the target's constraint, reusing the properly
        weighted retained pair."""
        return ChangeTarget(self, target).run_csmc_for_normalizing_constant(
            key, latent_choices, w)


def _proposal_target(target: Target, key, k: int) -> Target:
    """The target as an argument of a proposal run on the key batch
    ``B + (k, 2)``: lifted to the particles, as every tensor argument of
    a batched call leads with its batch."""
    return lift_target(target, k, key.device, tuple(key.shape[:-2]))


@Pytree.dataclass
class Importance(SMCAlgorithm):
    """1-particle importance sampling from ``target`` with optional proposal
    ``q`` (a :class:`SampleDistribution` over a subset of the unconstrained
    addresses)."""

    target: Target | None = None
    q: SampleDistribution | None = None

    def get_num_particles(self) -> int:
        return 1

    def get_final_target(self) -> Target:
        assert self.target is not None
        return self.target

    def _one_particle(self, key, chm: ChoiceMap, q_w):
        target = self.get_final_target()
        outer = tuple(key.shape[:-1])
        chm = lift_values(chm, (1,), key.device, outer)
        tr, w = batched_importance(target, _one(key), chm, per_particle=True)
        return tr, w - torch.as_tensor(q_w, device=key.device)[..., None]

    def run_smc(self, key) -> ParticleCollection:
        key, sub_key = _split(key)
        if self.q is not None:
            q_w, choice = self.q.random_weighted(sub_key,
                                                 self.get_final_target())
        else:
            q_w, choice = 0.0, ChoiceMap.empty()
        tr, w = self._one_particle(key, choice, q_w)
        return ParticleCollection(tr, w, torch.tensor(True))

    def run_csmc(self, key, retained: ChoiceMap):
        key, sub_key = _split(key)
        tr, w = self._one_particle(key, retained, 0.0)
        if self.q is not None:
            q_w = self.q.estimate_logpdf(sub_key, retained,
                                         self.get_final_target())[..., None]
        else:
            # The retained particle is weighted as a free one would be:
            # w = log p(v) - log r(v), r the ancestral prior of the
            # retained addresses (the JAX package's deliberate deviation
            # from its reference, smc.py:661-670).
            q_w = tr.project(_one(sub_key), retained.get_selection())
        return ParticleCollection(tr, w - q_w, torch.tensor(True))


@Pytree.dataclass
class ImportanceK(SMCAlgorithm):
    """K-particle sampling-importance-resampling, the particle axis a key
    batch of ``K`` behind the caller's batch; optional proposal ``q``."""

    target: Target | None = None
    q: SampleDistribution | None = None
    k_particles: int = Pytree.static(default=2)

    def get_num_particles(self) -> int:
        return self.k_particles

    def get_final_target(self) -> Target:
        assert self.target is not None
        return self.target

    def _propose(self, keys):
        """``q``'s draws and weights on the key batch ``B + (k, 2)``."""
        target = self.get_final_target()
        return self.q.random_weighted(
            keys, _proposal_target(target, keys, keys.shape[-2]))

    def run_smc(self, key) -> ParticleCollection:
        target = self.get_final_target()
        key, sub_key = _split(key)
        sub_keys = random.split(sub_key, self.k_particles)
        if self.q is not None:
            q_ws, choices = self._propose(sub_keys)
            # Fresh keys for the model's fill-in of unconstrained
            # addresses (reusing sub_keys would correlate it with the
            # proposal draws).
            trs, ws = batched_importance(
                target, random.split(key, self.k_particles), choices,
                per_particle=True)
            return ParticleCollection(trs, ws - q_ws, torch.tensor(True))
        trs, ws = batched_importance(target, sub_keys, ChoiceMap.empty())
        return ParticleCollection(trs, ws, torch.tensor(True))

    def run_csmc(self, key, retained: ChoiceMap):
        """K − 1 free particles and, last, the retained one, weighted as in
        :meth:`Importance.run_csmc`."""
        target = self.get_final_target()
        outer = tuple(key.shape[:-1])
        axis = len(outer)
        key, sub_key = _split(key)
        sub_keys = random.split(sub_key, self.k_particles - 1)
        if self.q is not None:
            key, ret_key, imp_key = random.split(key, 3).unbind(-2)
            q_ws, choices = self._propose(sub_keys)
            ret_q_w = self.q.estimate_logpdf(ret_key, retained, target)
            all_choices = _stack_end(
                choices, lift_values(retained, (1,), key.device, outer),
                axis)
            all_q_ws = torch.cat([q_ws, ret_q_w[..., None]], dim=-1)
            trs, ws = batched_importance(
                target, random.split(imp_key, self.k_particles),
                all_choices, per_particle=True)
            return ParticleCollection(trs, ws - all_q_ws, torch.tensor(True))
        free_trs, free_ws = batched_importance(target, sub_keys,
                                               ChoiceMap.empty())
        key, proj_key = _split(key)
        ret_tr, ret_w = batched_importance(
            target, _one(key), lift_values(retained, (1,), key.device, outer),
            per_particle=True)
        ret_w = ret_w - ret_tr.project(_one(proj_key),
                                       retained.get_selection())
        return ParticleCollection(_stack_end(free_trs, ret_tr, axis),
                                  torch.cat([free_ws, ret_w], dim=-1),
                                  torch.tensor(True))


@Pytree.dataclass
class ChangeTarget(SMCAlgorithm):
    """Reweight every particle of ``prev`` to a new target: fresh importance
    of each particle's latents into ``target``; the weight picks up the
    density ratio."""

    prev: SMCAlgorithm
    target: Target

    def get_num_particles(self) -> int:
        return self.prev.get_num_particles()

    def get_final_target(self) -> Target:
        return self.target

    def _reweight(self, keys, particles, weights):
        """Particles ``B + (n,)`` (keys ``B + (n, 2)``) into the new
        target: ``(new traces, new_w − old score + weight)``."""
        latents = self.prev.get_final_target().filter_to_unconstrained(
            particles.get_choices())
        new_trs, new_ws = batched_importance(self.target, keys, latents,
                                             per_particle=True)
        return new_trs, new_ws - particles.get_score() + weights

    def _reweight_collection(self, key, collection) -> ParticleCollection:
        sub_keys = random.split(key, self.get_num_particles())
        new_trs, new_ws = self._reweight(sub_keys, collection.get_particles(),
                                         collection.get_log_weights())
        return ParticleCollection(new_trs, new_ws, torch.tensor(True))

    def run_smc(self, key) -> ParticleCollection:
        key, rw_key = _split(key)
        return self._reweight_collection(rw_key, self.prev.run_smc(key))

    def run_csmc(self, key, retained: ChoiceMap):
        key, rw_key = _split(key)
        return self._reweight_collection(rw_key,
                                         self.prev.run_csmc(key, retained))

    def run_csmc_for_normalizing_constant(self, key, latent_choices: ChoiceMap,
                                          w):
        """logẐ from a CSMC ensemble that retains the already properly
        weighted pair ``(latent_choices, w)``. The JAX package's deliberate
        deviation from its reference is kept: the result is logẐ itself,
        not ``retained_score − (logẐ − log K)``, which vanishes when
        nothing is marginalized."""
        key, sub_key = _split(key)
        collection = self.prev.run_csmc(sub_key, latent_choices)
        n = self.get_num_particles()
        lw = collection.get_log_weights()
        axis = lw.ndim - 1
        retained = collection.get_particle(-1)
        last = (torch.as_tensor(w, device=lw.device)
                - retained.get_score() + lw[..., -1])[..., None]
        if n > 1:
            sub_keys = random.split(key, n - 1)
            lead = (slice(None),) * axis
            rest = tree_map(lambda v: v[lead + (slice(0, n - 1),)],
                            collection.get_particles())
            _, rejected = self._reweight(sub_keys, rest, lw[..., :-1])
            last = torch.cat([rejected, last], dim=-1)
        return torch.logsumexp(last, dim=-1) - math.log(n)
