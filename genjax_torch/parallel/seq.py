"""Sequence parallelism: forward filtering and backward sampling of a
discrete HMM with the TIME axis spread over a mesh axis (counterpart of
``genjax_tpu/parallel/seq.py``).

Each rank holds ``T/D`` consecutive steps. The filter:

1. writes the chain as log-space step matrices, ``M_0 = log-diag(prior +
   obs_0)`` and ``M_t = transition_logits + obs_ll[t][None, :]``, so that
   ``alpha_t = 0_S ∘ M_0 ∘ … ∘ M_t``;
2. folds each of its blocks of ``block`` steps into one product, all of
   its blocks at once in one loop over the position within the block;
3. all-gathers the ``(T/block, S, S)`` block summaries and their shifts
   (the only traffic besides the log marginal's scalar) and folds them, the same ops in the
   same order on every rank, into each block's incoming prefix;
4. runs the forward recursion inside each block from that prefix, again
   all blocks at once.

The fold and the recursion run scaled (a max-0 state and a float64
shift, ``discrete_hmm.filter_recursion``), so no f32 sum adds a small
step to the large log joint of a long chain.

Every float sum is one of ``core/fixed_sum.py``'s, whose association
depends on ``S`` alone, and every block boundary depends on ``(T,
block)`` alone, so the result is bitwise equal on every power-of-two
layout. The default ``block=None`` derives the block from ``T`` alone
(``collectives._layout_free_block``); an explicit block must divide
``T/D`` (a clamp would make the association depend on D). With ``D = 1``
and ``block = T`` the recursion is the sequential one, bitwise
``discrete_hmm.forward_filter``. The log-space product stays inline
(a max-shifted elementwise form), as the JAX package keeps it in
``jnp``: no kernel is on this path.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from genjax_torch.core import random
from genjax_torch.core.fixed_sum import prefix_sum, tree_logsumexp, tree_sum
from genjax_torch.lang.distributions.discrete_hmm import (
    _obs_ll,
    filter_recursion,
    unscale,
)
from genjax_torch.parallel.collectives import (
    _layout_free_block,
    all_gather,
    all_reduce,
    comm,
)
from genjax_torch.parallel.mesh import DeviceMesh, mesh_axis

__all__ = ["time_sharded_filter", "time_sharded_backward_sample"]


def _check_block(T: int, n_dev: int, block: int | None) -> int:
    local_T = T // n_dev
    if T % n_dev:
        raise ValueError(
            f"time_sharded_filter: sequence length T={T} must be a "
            f"multiple of the mesh axis size D={n_dev}."
        )
    if block is None:
        block = _layout_free_block(T, 256)
    if local_T % block:
        raise ValueError(
            f"time_sharded_filter: block={block} must divide the "
            f"per-device step count T/D={local_T} (bitwise "
            f"layout-independence contract; see parallel/collectives). "
            f"Pass block=None to derive a layout-free block from T."
        )
    return block


def _log_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``C[..., i, j] = logsumexp_k a[..., i, k] + b[..., k, j]``, the sum
    over ``k`` a fixed tree: the bits of each product depend on ``S``
    alone, not on how many products the batch holds."""
    return tree_logsumexp(a[..., :, None, :] + b.transpose(-1, -2)
                          [..., None, :, :], -1)


def _softmax(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softmax`` over the last axis with a fixed-tree sum."""
    e = torch.exp(x - x.amax(-1, keepdim=True))
    return e / tree_sum(e)[..., None]


def block_summaries(config, obs_ll: torch.Tensor, block: int,
                    first: bool):
    """The rank-local pass, with no communication: the log-space product
    of each block of ``block`` step matrices of ``obs_ll`` (``(n, S)``,
    this rank's steps), scaled: ``(n / block, S, S)`` matrices with max 0
    and their ``(n / block,)`` float64 shifts. ``first``: these steps
    start at the global ``t = 0``, whose matrix is ``log-diag(prior +
    obs_0)``."""
    S = obs_ll.shape[-1]
    ob = obs_ll.reshape(-1, block, S)
    trans = config.transition_logits
    P = trans[None] + ob[:, 0, None, :]
    if first:
        P = P.clone()
        P[0] = _diag0(config, obs_ll[0])
    shift = P.amax((-2, -1))
    P, shift = P - shift[:, None, None], shift.double()
    for i in range(1, block):
        P = _log_matmul(P, trans[None] + ob[:, i, None, :])
        r = P.amax((-2, -1))
        P, shift = P - r[:, None, None], shift + r.double()
    return P, shift


def _diag0(config, obs_row: torch.Tensor) -> torch.Tensor:
    """``M_0``: ``prior + obs_0`` on the diagonal, the float minimum off
    it."""
    alpha0 = config.prior_logits + obs_row
    S = alpha0.shape[0]
    eye = torch.eye(S, dtype=torch.bool, device=alpha0.device)
    return torch.where(eye, alpha0[None, :],
                       torch.finfo(alpha0.dtype).min)


def time_sharded_filter(
    config,
    observations: torch.Tensor,
    mesh: DeviceMesh,
    axis_name="time",
    block: int | None = None,
):
    """Forward filtering with the time axis sharded: ``observations`` is
    this rank's ``(T/D,)`` slice. Returns ``(alphas, log_marginal)`` as
    ``discrete_hmm.forward_filter`` does: this rank's ``(T/D, S)`` rows of
    ``alphas[t, s] = log P(z_t = s, x_{1:t})`` and the replicated data
    log marginal."""
    ax = mesh_axis(mesh, axis_name)
    n_dev, d = ax.size, ax.rank
    local_T = observations.shape[0]
    T = local_T * n_dev
    b = _check_block(T, n_dev, block)
    nb_local = local_T // b
    obs_ll = _obs_ll(config, observations)                 # (local_T, S)
    S = obs_ll.shape[-1]
    trans = config.transition_logits

    summaries, shifts = block_summaries(config, obs_ll, b, d == 0)
    all_sums = all_gather(summaries, ax, "block_summaries")
    all_shifts = all_gather(shifts, ax, "block_shifts")

    # Each block's incoming prefix, scaled: the replicated fold of the
    # summaries before it, in one order on every rank, as a max-0 matrix
    # and its float64 shift.
    first_block = d * nb_local
    u0, c0 = [], []
    G, g = all_sums[0], all_shifts[0]
    for k in range(1, first_block + nb_local):
        if k >= first_block:
            v = tree_logsumexp(G, 0)
            m = v.amax()
            u0.append(v - m)
            c0.append(g + m.double())
        R = _log_matmul(G, all_sums[k])
        r = R.amax()
        G, g = R - r, g + all_shifts[k] + r.double()
    zero = obs_ll.new_zeros(S)
    if first_block == 0:
        # Block 0 starts from the raw 0_S vector (M_0 is inside it).
        u0.insert(0, zero)
        c0.insert(0, torch.zeros((), dtype=torch.float64,
                                 device=obs_ll.device))
    u, c0 = torch.stack(u0), torch.stack(c0)               # (nb_local, S)

    ob = obs_ll.reshape(nb_local, b, S).transpose(0, 1)    # (b, nb, S)
    us, ms = filter_recursion(u, trans, ob[:1])            # first steps
    if d == 0:
        # The global t = 0 goes through M_0 = log-diag(prior + obs_0);
        # from 0_S that is prior + obs_0 itself, its shift its max.
        head = tree_logsumexp(u[0, :, None] + _diag0(config, obs_ll[0]), 0)
        us[0, 0], ms[0, 0] = head - head.amax(), head.amax()
    rest_u, rest_m = filter_recursion(us[0], trans, ob[1:])
    us, ms = torch.cat([us, rest_u]), torch.cat([ms, rest_m])  # (b, nb, S)
    offsets = c0[:, None] + prefix_sum(ms.T.double())      # (nb, b)
    alphas = unscale(offsets, us.transpose(0, 1)).reshape(local_T, S)
    lz = unscale(offsets[-1, -1], tree_logsumexp(us[-1, -1], 0)[None])[0]
    if d != n_dev - 1:
        lz = torch.zeros_like(lz)
    return alphas, all_reduce(lz, dist.ReduceOp.SUM, ax, "log_marginal")


def step_tables(keys, config, alphas: torch.Tensor, t0: int, T: int):
    """The backward sampler's per-step tables for this rank's steps
    ``t0 .. t0 + n - 1`` (``alphas`` their ``(n, S)`` rows), one set a
    key of ``keys`` ``(K, 2)``: ``(K, n, S)``, ``f_t[j]`` the inverse-CDF
    draw of ``z_t | z_{t+1} = j`` on the uniform of ``fold_in(key, t)``;
    the last global step's table is the constant draw from
    ``alphas[T - 1]``."""
    n, S = alphas.shape
    t_idx = torch.arange(t0, t0 + n, device=alphas.device)
    us = random.uniform(random.fold_in(keys[:, None, :], t_idx))   # (K, n)
    cond = alphas[:, None, :] + config.transition_logits.T[None]
    cdf = prefix_sum(_softmax(cond))                               # (n, S, S)
    tab = torch.argmax((cdf[None] >= us[:, :, None, None]).to(torch.int8),
                       -1)
    if t0 + n == T:
        lcdf = prefix_sum(_softmax(alphas[-1]))
        last = torch.argmax((lcdf[None] >= us[:, -1, None]).to(torch.int8),
                            -1)
        tab[:, -1] = last[:, None]
    return tab


def time_sharded_backward_sample(
    key,
    config,
    alphas: torch.Tensor,
    mesh: DeviceMesh,
    axis_name="time",
    block: int | None = None,
) -> torch.Tensor:
    """Exact posterior path sampling with the time axis sharded, the
    backward half of FFBS: ``alphas`` is this rank's ``(T/D, S)`` slice
    from :func:`time_sharded_filter`; returns this rank's ``(T/D,)`` slice
    of the path (``B + (T/D,)`` for a key batch ``B + (2,)``, one path a
    key). Tables compose by integer gather (``(f ∘ g)[j] = f[g[j]]``),
    exact, so the blocked form (within-block compositions, one all-gather
    of ``T/block`` length-S tables a key, a replicated boundary fold) is
    bitwise layout-independent."""
    ax = mesh_axis(mesh, axis_name)
    n_dev, d = ax.size, ax.rank
    local_T, S = alphas.shape
    T = local_T * n_dev
    b = _check_block(T, n_dev, block)
    nb_local = local_T // b
    batch = tuple(key.shape[:-1])
    keys = key.to(alphas.device).reshape(-1, 2)
    tab = step_tables(keys, config, alphas, d * local_T, T).reshape(
        keys.shape[0], nb_local, b, S)
    acc = tab[:, :, 0]
    for i in range(1, b):
        acc = torch.gather(acc, 2, tab[:, :, i])
    all_sums = all_gather(acc.transpose(0, 1), ax, "block_tables")
    # The state entering each block from the right, folded on the host
    # (exact integers): one read of the gathered tables.
    comm.host_syncs += 1
    sums = all_sums.cpu()                                # (nb, K, S)
    nb, n_keys = sums.shape[:2]
    bounds = torch.zeros((nb, n_keys), dtype=torch.int64)
    rows = torch.arange(n_keys)
    for k in range(nb - 2, -1, -1):
        bounds[k] = sums[k + 1, rows, bounds[k + 1]]
    z = bounds[d * nb_local:(d + 1) * nb_local].T.to(alphas.device)
    zs = []
    for i in range(b - 1, -1, -1):
        z = torch.gather(tab[:, :, i], 2, z[..., None])[..., 0]
        zs.append(z)
    path = torch.stack(zs[::-1], 2).reshape(batch + (local_T,))
    return path.to(torch.int32)
