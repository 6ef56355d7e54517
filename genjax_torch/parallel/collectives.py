"""Explicit-collective inference reductions over a process group
(counterpart of ``genjax_tpu/parallel/collectives.py``): log Ẑ / ESS as
ensemble-wide reductions, and distributed systematic resampling whose
communication is known by construction.

Every function here runs on each rank of the mesh axis with the rank's
own slice of the particle axis (rank ``d`` of ``D`` holds particles
``[d·n/D, (d+1)·n/D)``) and returns the rank's slice of the result;
replicated results (log Ẑ, ESS) are equal on every rank. Each collective
function is a rank-local part, a plain function of the shard and the
gathered partials, and its communication:

- ``lax.psum`` / ``lax.pmax`` → ``all_reduce(SUM / MAX)``;
- ``lax.all_gather(tiled=True)`` → ``all_gather_into_tensor``;
- ``lax.ppermute`` → ``batch_isend_irecv`` of ``P2POp`` pairs;
- the ring's ``lax.while_loop`` on a psum'd "unfilled" count → a Python
  loop that reads the all-reduced count, one host sync a trip;
- the scatter-mark + cumsum run lookup (a TPU cost-model workaround) →
  ``torch.searchsorted`` over the run starts: the same owner.

Two resampling paths, as in the JAX package:

- the psum-offset path (``shardmap_*``): the global CDF from a gathered
  offset and a shard-local cumsum; its bits depend on the layout;
- the product path (``ring_resample_step`` and friends): every float sum
  runs in fixed-size units. The block ``B`` is derived from the global
  ``n`` and the cap alone (:func:`_layout_free_block`), and each block's
  prefix sum, sum of squares and maximum is computed by elementwise
  passes whose association is fixed by ``B`` (``core/fixed_sum.py``),
  never by the shard's shape: torch's own ``cumsum`` and ``sum`` pick
  their split of a row from the whole tensor's shape.
  The n/B block partials are all-gathered and combined identically on
  every rank. Offspring counts, and so the resampled ensemble, are
  bitwise equal on 1, 2, 4, ... 64 ranks. Per resample a rank moves
  one all-gather of 3·(n/B) floats, one max all-reduce, the 2·H halo
  slots of its neighbours (runs and state), and, only where the halo does
  not cover its outputs, whole (n/D)-slot blocks around the ring.

:data:`comm` counts every collective this layer issues (op, elements,
bytes) and its host syncs, as ``nuts_kernel.host_syncs`` counts the NUTS
driver's; the tests read it where the JAX tests read the HLO.
"""

from __future__ import annotations

import collections
import math

import torch
import torch.distributed as dist

from genjax_torch.core import random
from genjax_torch.core.fixed_sum import prefix_sum, tree_sum
from genjax_torch.core.pytree import tree_flatten, tree_unflatten
from genjax_torch.parallel.mesh import Axis, DeviceMesh, mesh_axis

__all__ = [
    "comm",
    "shardmap_logz",
    "shardmap_ess",
    "shardmap_systematic_resample",
    "blocked_logz",
    "blocked_ess",
    "blocked_stats",
    "ring_systematic_resample",
    "ring_resample_step",
    "take_rows",
]


class CommLog:
    """The collectives issued since :meth:`reset`: one ``(op, tag,
    elements, bytes)`` record each (an all-gather's elements are its
    gathered output, a send's what the rank sends), ``host_syncs`` (the
    counts read back to steer the ring) and ``ring_trips``."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.records: list[tuple[str, str, int, int]] = []
        self.host_syncs = 0
        self.ring_trips = 0

    def add(self, op: str, tag: str, t: torch.Tensor):
        self.records.append((op, tag, t.numel(),
                             t.numel() * t.element_size()))

    def add_sized(self, op: str, tag: str, elements: int, n_bytes: int):
        """A record whose elements and bytes are given (what crosses
        ranks, where a collective also copies a rank's own rows)."""
        self.records.append((op, tag, int(elements), int(n_bytes)))

    def by_op(self) -> dict:
        """``{"op/tag": {"calls", "elements", "bytes"}}``."""
        out = collections.defaultdict(lambda: {"calls": 0, "elements": 0,
                                               "bytes": 0})
        for op, tag, el, by in self.records:
            row = out[f"{op}/{tag}"]
            row["calls"] += 1
            row["elements"] += el
            row["bytes"] += by
        return dict(out)

    def max_elements(self) -> int:
        return max((r[2] for r in self.records), default=0)


comm = CommLog()


# ---------------------------------------------------------------------------
# Communication: each call counted in ``comm``.
# ---------------------------------------------------------------------------


def _wire(t: torch.Tensor) -> torch.Tensor:
    """``t`` as it travels: contiguous, bools as bytes (gloo has no bool)."""
    t = t.contiguous()
    return t.to(torch.uint8) if t.dtype == torch.bool else t


def all_reduce(x: torch.Tensor, op, ax: Axis, tag: str) -> torch.Tensor:
    out = _wire(x).clone()
    comm.add("all_reduce", tag, out)
    dist.all_reduce(out, op=op, group=ax.group)
    return out.to(x.dtype)


def all_gather(x: torch.Tensor, ax: Axis, tag: str) -> torch.Tensor:
    """The ranks' ``x`` stacked along the leading axis in rank order
    (``lax.all_gather(..., tiled=True)``)."""
    w = _wire(x)
    out = w.new_empty((ax.size * w.shape[0],) + tuple(w.shape[1:]))
    comm.add("all_gather", tag, out)
    _gather_into(out, w, group=ax.group)
    return out.to(x.dtype)


def shift(tensors, ax: Axis, offset: int, tag: str) -> list:
    """``lax.ppermute`` by ``offset`` along the axis: each rank sends every
    tensor to rank ``d + offset`` and receives rank ``d - offset``'s, in
    one batch of point-to-point ops (a rank of a world of one keeps its
    own). The all-reduces and all-gathers above run even in a world of
    one, so the backend's collectives are exercised there too."""
    tensors = list(tensors)
    if ax.size == 1:
        return tensors
    dst, src = ax.global_rank(ax.rank + offset), ax.global_rank(ax.rank - offset)
    ops, outs = [], []
    for t in tensors:
        w = _wire(t)
        buf = torch.empty_like(w)
        comm.add("send", tag, w)
        ops += [dist.P2POp(dist.isend, w, dst, ax.group),
                dist.P2POp(dist.irecv, buf, src, ax.group)]
        outs.append(buf)
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return [o.to(t.dtype) for o, t in zip(outs, tensors)]


def take_rows(tree, rows: torch.Tensor, ax: Axis, tag: str):
    """This rank's slice of ``leaf[rows]`` for every leaf of ``tree``,
    each leaf held as this rank's slice of its leading axis and ``rows``
    the whole axis's source rows, the same on every rank (a resample's
    ancestors). Only rows that other ranks hold move, by one
    ``all_to_all_single`` a leaf with per-rank counts; the counts are
    read on the host once (one host sync). ``comm`` counts the elements
    and bytes that cross ranks."""
    leaves, spec = tree_flatten(tree)
    n = rows.shape[0]
    d, size = ax.rank, ax.size
    per = n // size
    rows = rows.to(torch.int64)
    owner = torch.div(rows, per, rounding_mode="floor")
    mine = owner[d * per:(d + 1) * per]
    # Rank q's rows that this rank owns, in q's destination order.
    send_mask = owner.reshape(size, per) == d
    counts = torch.stack([send_mask.sum(1),
                          torch.bincount(mine, minlength=size)]).cpu()
    comm.host_syncs += 1
    send_counts, recv_counts = counts.tolist()
    src = rows.reshape(size, per)[send_mask] - d * per
    # Received rows arrive grouped by owner rank, in destination order
    # within a group: a stable sort by owner puts them back in place.
    place = torch.argsort(mine, stable=True)
    crossing = per - recv_counts[d]
    outs = []
    for leaf in leaves:
        w = _wire(leaf)
        send = w[src].contiguous()
        recv = w.new_empty((per,) + tuple(w.shape[1:]))
        row_bytes = w[:1].numel() * w.element_size()
        comm.add_sized("all_to_all", tag, crossing * (row_bytes
                                                      // w.element_size()),
                       crossing * row_bytes)
        dist.all_to_all_single(recv, send, output_split_sizes=recv_counts,
                               input_split_sizes=send_counts,
                               group=ax.group)
        out = torch.empty_like(recv)
        out[place] = recv
        outs.append(out.to(leaf.dtype))
    return tree_unflatten(outs, spec)


#: ``all_gather_into_tensor`` under its newer name where torch has it.
_gather_into = getattr(dist, "all_gather_single", None) or \
    dist.all_gather_into_tensor


def _read_count(x: torch.Tensor) -> int:
    comm.host_syncs += 1
    return int(x)


# ---------------------------------------------------------------------------
# The psum-offset path.
# ---------------------------------------------------------------------------


def shardmap_logz(log_weights: torch.Tensor, mesh: DeviceMesh,
                  axis_name="particles") -> torch.Tensor:
    """log Z̄ = logsumexp(lw) − log K by a max and a sum all-reduce."""
    ax = mesh_axis(mesh, axis_name)
    n = log_weights.shape[0] * ax.size
    m = all_reduce(log_weights.max(), dist.ReduceOp.MAX, ax, "max")
    s = all_reduce(torch.exp(log_weights - m).sum(), dist.ReduceOp.SUM, ax,
                   "sum")
    return m + torch.log(s) - math.log(n)


def shardmap_ess(log_weights: torch.Tensor, mesh: DeviceMesh,
                 axis_name="particles") -> torch.Tensor:
    """ESS = (Σw)²/Σw² by a max and two sum all-reduces."""
    ax = mesh_axis(mesh, axis_name)
    m = all_reduce(log_weights.max(), dist.ReduceOp.MAX, ax, "max")
    e = torch.exp(log_weights - m)
    s1 = all_reduce(e.sum(), dist.ReduceOp.SUM, ax, "sum")
    s2 = all_reduce((e * e).sum(), dist.ReduceOp.SUM, ax, "sum")
    return s1 * s1 / s2


def _particle_leaves(tree, local_n: int):
    """``(leaves, spec, positions)``: the tensor leaves leading with the
    rank's ``local_n`` particles are the ones resampling moves."""
    leaves, spec = tree_flatten(tree)
    pos = [i for i, v in enumerate(leaves)
           if isinstance(v, torch.Tensor) and v.ndim >= 1
           and v.shape[0] == local_n]
    return leaves, spec, pos


def _put(leaves, spec, pos, moved):
    leaves = list(leaves)
    for i, v in zip(pos, moved):
        leaves[i] = v
    return tree_unflatten(leaves, spec)


def _match_runs(base: int, local_n: int, starts_cat, ends_cat, leaves_cat):
    """Assign output slots ``[base, base + local_n)`` from candidate
    offspring runs ``[starts_cat, ends_cat)`` (globally sorted): each slot
    takes the last run starting at or before it, if that run covers it.
    Returns ``(out_leaves, hit)``, zeros where nothing hit."""
    m = starts_cat.shape[0]
    j = torch.arange(base, base + local_n, dtype=starts_cat.dtype,
                     device=starts_cat.device)
    idx = torch.clamp(torch.searchsorted(starts_cat, j, right=True) - 1,
                      0, m - 1)
    hit = (j >= starts_cat[idx]) & (j < ends_cat[idx])
    outs = []
    for x in leaves_cat:
        h = hit.reshape((-1,) + (1,) * (x.ndim - 1))
        outs.append(torch.where(h, x[idx], torch.zeros((), dtype=x.dtype,
                                                       device=x.device)))
    return outs, hit


def _merge(outs, got, hit):
    """``got`` where ``hit``, ``outs`` elsewhere, leaf by leaf."""
    return [torch.where(hit.reshape((-1,) + (1,) * (o.ndim - 1)), g, o)
            for o, g in zip(outs, got)]


def shardmap_systematic_resample(key, log_weights: torch.Tensor, tree,
                                 mesh: DeviceMesh, axis_name="particles"):
    """Distributed systematic resampling, the same grid ``(j + u0)/N``
    inverted against the same weight CDF as
    ``inference.smc.resample_tree(..., "systematic")``; only the float
    summation order of the CDF differs (shard-local cumsum + a gathered
    offset). Every block travels the whole ring (D steps)."""
    ax = mesh_axis(mesh, axis_name)
    local_n = log_weights.shape[0]
    n, d = local_n * ax.size, ax.rank
    dev = log_weights.device
    m = all_reduce(log_weights.max(), dist.ReduceOp.MAX, ax, "max")
    e = torch.exp(log_weights - m)
    total = all_reduce(e.sum(), dist.ReduceOp.SUM, ax, "sum")
    p = e / total
    block_sum = p.sum()
    block_sums = all_gather(block_sum[None], ax, "block_sums")
    offset = torch.cumsum(block_sums, 0)[d] - block_sum
    cum = offset + torch.cumsum(p, 0)
    u0 = random.uniform(key.to(dev), ())
    counts_cum = torch.clamp(torch.ceil(n * cum - u0), 0, n).to(torch.int32)
    first = torch.clamp(torch.ceil(n * offset - u0), 0, n).to(torch.int32)
    starts = torch.cat([first[None], counts_cum[:-1]])
    ends = counts_cum
    leaves, spec, pos = _particle_leaves(tree, local_n)
    out = [torch.zeros_like(leaves[i]) for i in pos]
    blk = [starts, ends] + [leaves[i] for i in pos]
    for step in range(ax.size):
        got, hit = _match_runs(d * local_n, local_n, blk[0], blk[1], blk[2:])
        out = _merge(out, got, hit)
        if step + 1 < ax.size:
            blk = shift(blk, ax, 1, "ring")
    return _put(leaves, spec, pos, out)


# ---------------------------------------------------------------------------
# The deterministic (layout-independent) blocked-CDF product path.
# ---------------------------------------------------------------------------


def _layout_free_block(n: int, cap: int, reserve_pow2: int = 6) -> int:
    """Effective summation block derived from the GLOBAL size ``n`` and
    the cap only, never from ``n/D``: the largest divisor of ``n`` that is
    at most ``cap`` and whose power of two leaves ``reserve_pow2`` powers
    of ``n``'s free, ``v2(b) <= max(0, v2(n) - reserve_pow2)``. It divides
    ``n / 2**k`` for every ``k <= min(v2(n), reserve_pow2)``: any
    power-of-two world up to 64 ranks."""
    v = (n & -n).bit_length() - 1
    max_v_b = max(0, v - reserve_pow2)
    for cand in range(min(cap, n), 0, -1):
        if n % cand:
            continue
        if (cand & -cand).bit_length() - 1 <= max_v_b:
            return cand
    return 1


def _pick_block(n: int, local_n: int, cap: int) -> int:
    """The layout-free block for ``n``, checked against this layout's
    ``local_n``."""
    b = _layout_free_block(n, cap)
    if local_n % b:
        raise ValueError(
            f"blocked collectives: the layout-independent block "
            f"{b} (derived from n={n}, cap={cap}) does not divide the "
            f"per-device count n/D={local_n}. Use a power-of-two mesh "
            f"axis (up to 64 devices), or a particle count whose "
            f"factors match the mesh."
        )
    return b


def block_partials(log_weights: torch.Tensor, m: torch.Tensor, block: int):
    """The rank-local half of the blocked statistics, with no
    communication: ``(within, stats)``, ``within`` the ``(nb, B)``
    within-block prefix sums of ``exp(lw − m)`` and ``stats`` the
    ``(3, nb)`` block sums, block maxima of ``within`` and block sums of
    squares. Each is fixed by ``B`` and the block's values alone."""
    e = torch.exp(log_weights - m)
    eb = e.reshape(-1, block)
    within = prefix_sum(eb)
    stats = torch.stack([within[:, -1], within.amax(1), tree_sum(eb * eb)])
    return within, stats


def combine_partials(all_stats: torch.Tensor):
    """The replicated half: from the gathered ``(3, n/B)`` partials,
    ``(seeds, bcum_excl, total_raw, total_rep, sum_sq)``: each block's
    repaired predecessor (the prefix max of the raw CDF over every element
    before it), each block's exclusive offset, the raw Σexp, the repaired
    CDF total and Σexp². The same ops on the same values on every rank."""
    bsums, bmaxs, s2 = all_stats
    bcum = prefix_sum(bsums)
    zero = bcum.new_zeros(1)
    bcum_excl = torch.cat([zero, bcum[:-1]])
    seam = torch.cummax(bcum_excl + bmaxs, 0).values
    seeds = torch.cat([zero, seam[:-1]])
    return seeds, bcum_excl, bcum[-1], seam[-1], tree_sum(s2)


def _blocked_cdf_stats(lw, ax: Axis, n: int, block: int):
    """``(within, seeds, bcum_excl, total_raw, total_rep, sum_sq, m)``: one
    max all-reduce and one all-gather of the ``3·(n/B)`` block partials."""
    b = _pick_block(n, lw.shape[0], block)
    m = all_reduce(lw.max(), dist.ReduceOp.MAX, ax, "max")
    within, stats = block_partials(lw, m, b)
    all_stats = all_gather(stats.T, ax, "block_stats").T
    return (within, *combine_partials(all_stats), m)


def _blocked_counts(key, within, seeds, bcum_excl, total_rep,
                    n: int, n_dev: int, d: int):
    """This rank's offspring intervals ``[starts, ends)`` (int32, global
    destinations): the blocked analogue of
    ``smc.systematic_offspring_cumulative``, with the cummax monotone
    repair and the last element of the last rank owning destination
    ``n``. ``u0`` comes from ``key``, the same on every rank."""
    nb_local, _ = within.shape
    my_seeds = seeds[d * nb_local:(d + 1) * nb_local]
    my_off = bcum_excl[d * nb_local:(d + 1) * nb_local]
    raw = my_off[:, None] + within
    cum = torch.maximum(torch.cummax(raw, 1).values, my_seeds[:, None])
    u0 = random.uniform(key.to(within.device), ())
    scale = n / total_rep
    ends = torch.clamp(torch.ceil(cum.reshape(-1) * scale - u0), 0, n
                       ).to(torch.int32)
    if d == n_dev - 1:
        # Exact tail: f32 rounding otherwise drops destination n for about
        # a quarter of the seeds.
        ends[-1] = n
    if d == 0:
        first = torch.zeros(1, dtype=torch.int32, device=ends.device)
    else:
        first = torch.clamp(torch.ceil(my_seeds[:1] * scale - u0), 0, n
                            ).to(torch.int32)
    return torch.cat([first, ends[:-1]]), ends


def _halo_exchange(ax: Axis, halo: int, starts, ends, leaves):
    """The left neighbour's last ``halo`` runs and state and the right
    neighbour's first ``halo``: 2·H slots a rank. Rank 0 and rank D−1 put
    empty runs at ∓2^30 where they have no neighbour, so the candidates
    stay sorted and match nothing there. Returns the candidates in global
    source order."""
    blk = [starts, ends] + list(leaves)
    left = shift([x[-halo:] for x in blk], ax, 1, "halo")
    right = shift([x[:halo] for x in blk], ax, -1, "halo")
    lo, hi = -(2 ** 30), 2 ** 30
    if ax.rank == 0:
        left[0] = torch.full_like(left[0], lo)
        left[1] = torch.full_like(left[1], lo)
    if ax.rank == ax.size - 1:
        right[0] = torch.full_like(right[0], hi)
        right[1] = torch.full_like(right[1], hi)
    return [torch.cat([a, b, c]) for a, b, c in zip(left, blk, right)]


def _ring_redistribute(ax: Axis, local_n: int, starts, ends, leaves,
                       init=None):
    """Stream the ranks' ``(starts, ends, state)`` blocks around the ring
    until every rank's slots are filled: one all-reduced count of the
    unfilled slots a trip, read on the host. Systematic runs are
    contiguous in destination order, so a balanced resample is covered by
    a rank's own and adjacent blocks. ``init``: ``(outs, filled, done)``
    from the halo; when ``done`` the ring makes zero trips. The values
    are those of the full D-step ring: a slot is covered by one run."""
    base = ax.rank * local_n
    if ax.size == 1 and init is None:
        # One rank holds every run: one match fills every slot.
        return _match_runs(base, local_n, starts, ends, leaves)[0]
    if init is None:
        outs = [torch.zeros_like(x) for x in leaves]
        filled = torch.zeros(local_n, dtype=torch.bool,
                             device=starts.device)
        done = False
    else:
        outs, filled, done = init
    blk = [starts, ends] + list(leaves)
    trips = 0
    while not done and trips < ax.size:
        got, hit = _match_runs(base, local_n, blk[0], blk[1], blk[2:])
        outs = _merge(outs, got, hit)
        filled = filled | hit
        trips += 1
        comm.ring_trips += 1
        unfilled = all_reduce((~filled).sum(), dist.ReduceOp.SUM, ax,
                              "unfilled")
        done = _read_count(unfilled) == 0
        if not done and trips < ax.size:
            blk = shift(blk, ax, 1, "ring")
    return outs


def ring_resample_step(key, log_weights: torch.Tensor, tree,
                       mesh: DeviceMesh, axis_name="particles",
                       block: int = 256, halo: int | None = None):
    """The product distributed-resampling step: blocked log Z̄ / ESS,
    systematic offspring counts, and redistribution of the particle state
    by the halo exchange, with the ring as the exact fallback for skewed
    offspring. ``log_weights`` and ``tree``'s leaves are this rank's
    slice; returns ``(resampled slice, logz, ess)``, ``logz`` and ``ess``
    replicated.

    ``halo`` defaults to ``min(local_n, max(256, local_n // 16))``; 0
    forces the ring. Bitwise layout-independent for power-of-two worlds
    up to 64 ranks (the halo/ring choice changes only the traffic); a
    world whose size the derived block cannot divide raises."""
    ax = mesh_axis(mesh, axis_name)
    local_n = log_weights.shape[0]
    n = local_n * ax.size
    if halo is None:
        halo = min(local_n, max(256, local_n // 16))
    (within, seeds, bcum_excl, total_raw, total_rep, sum_sq,
     m) = _blocked_cdf_stats(log_weights, ax, n, block)
    logz = m + torch.log(total_raw) - math.log(n)
    ess = total_raw * total_raw / sum_sq
    starts, ends = _blocked_counts(key, within, seeds, bcum_excl, total_rep,
                                   n, ax.size, ax.rank)
    leaves, spec, pos = _particle_leaves(tree, local_n)
    moving = [leaves[i] for i in pos]
    init = None
    if ax.size > 1 and halo > 0:
        cand = _halo_exchange(ax, halo, starts, ends, moving)
        outs, hit = _match_runs(ax.rank * local_n, local_n, cand[0], cand[1],
                                cand[2:])
        unfilled = all_reduce((~hit).sum(), dist.ReduceOp.SUM, ax,
                              "unfilled")
        init = (outs, hit, _read_count(unfilled) == 0)
    out = _ring_redistribute(ax, local_n, starts, ends, moving, init)
    return _put(leaves, spec, pos, out), logz, ess


def ring_systematic_resample(key, log_weights: torch.Tensor, tree,
                             mesh: DeviceMesh, axis_name="particles",
                             block: int = 256, halo: int | None = None):
    """:func:`ring_resample_step`'s resampled slice alone."""
    out, _, _ = ring_resample_step(key, log_weights, tree, mesh, axis_name,
                                   block, halo)
    return out


def blocked_stats(log_weights: torch.Tensor, mesh: DeviceMesh,
                  axis_name="particles", block: int = 256):
    """``(logZ̄, ESS)`` from one max all-reduce and one all-gather of the
    block partials, with the layout-independent summation order (the
    same partials :func:`ring_resample_step` reads)."""
    ax = mesh_axis(mesh, axis_name)
    n = log_weights.shape[0] * ax.size
    (_, _, _, total_raw, _, sum_sq, m) = _blocked_cdf_stats(
        log_weights, ax, n, block)
    return (m + torch.log(total_raw) - math.log(n),
            total_raw * total_raw / sum_sq)


def blocked_logz(log_weights: torch.Tensor, mesh: DeviceMesh,
                 axis_name="particles", block: int = 256) -> torch.Tensor:
    """log Z̄ with the layout-independent summation order."""
    return blocked_stats(log_weights, mesh, axis_name, block)[0]


def blocked_ess(log_weights: torch.Tensor, mesh: DeviceMesh,
                axis_name="particles", block: int = 256) -> torch.Tensor:
    """ESS with the layout-independent summation order."""
    return blocked_stats(log_weights, mesh, axis_name, block)[1]
