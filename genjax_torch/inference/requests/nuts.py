"""The No-U-Turn sampler: iterative multinomial NUTS with bounded tree
depth, u-turn checks by the power-of-two checkpoint trick (Phan, Pradhan
& Jankowiak 2019) (counterpart of
``genjax_tpu/inference/requests/nuts.py``).

The chains are a batch ``B``: positions ``B + (D,)``, keys ``B + (2,)``,
and a log-density that maps ``B + (D,)`` to ``B``. Its gradient is
``torch.autograd.grad(logp.sum(), z)``, each chain's own, since the
chains are independent. Only the log-density call builds a graph: the
integrator carries ``z``, ``r``, ``logp`` and ``grad`` detached.

Two strategies over the same transition math (one subtree step and one
doubling merge, shared), which give the same draws bit for bit:

- ``fixed_budget=False`` (default): the JAX package's nested
  ``while_loop`` under ``vmap`` becomes a Python ``while`` over "any
  chain active", every state field kept by each chain's own predicate
  (``tree_where``), so a chain's result is its unbatched run. Each
  iteration asks the card once whether a chain is still active
  (``nuts_kernel.host_syncs`` counts these).
- ``fixed_budget=True``: one loop over the worst case, ``2**max_depth -
  1`` leapfrog slots, each chain running its own masked tree state
  machine; no host sync, every slot computed.

A chain's key advances only while the chain is active, in both.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from genjax_torch.core import random
from genjax_torch.core.compiler.interpreters.incremental import Diff
from genjax_torch.core.compiler.staging import tree_where
from genjax_torch.core.pytree import Pytree, ravel_pytree, tree_leaves
from genjax_torch.gfi.choice_map import partition_values
from genjax_torch.gfi.concepts import Argdiffs, EditRequest
from genjax_torch.gfi.gfn import Trace
from genjax_torch.gfi.requests import Update
from genjax_torch.gfi.selection import Selection

__all__ = ["NUTS", "nuts_kernel", "NUTSInfo", "check_float_latents"]


def jtu_select(pred, a, b):
    """Leafwise ``where(pred, a, b)`` over two pytrees of one structure;
    ``pred`` (one flag per chain) broadcasts against the leading chain
    axes of each leaf."""
    return tree_where(pred, a, b)


def _any(flags: torch.Tensor) -> bool:
    """Whether a chain is still active: one read of a device flag by the
    host, counted in ``nuts_kernel.host_syncs``."""
    nuts_kernel.host_syncs += 1
    return bool(flags.any())


class _IntegratorState(NamedTuple):
    z: torch.Tensor
    r: torch.Tensor
    logp: torch.Tensor
    grad: torch.Tensor


class NUTSInfo(NamedTuple):
    accept_prob: torch.Tensor
    num_steps: torch.Tensor
    diverging: torch.Tensor
    energy: torch.Tensor


class _TrajState(NamedTuple):
    """The whole trajectory: left and right frontiers, the multinomial
    proposal, the log-sum of subtree weights, the momentum sum, the
    u-turn and divergence flags."""

    key: torch.Tensor
    left: _IntegratorState
    right: _IntegratorState
    proposal_z: torch.Tensor
    log_sum_w: torch.Tensor
    r_sum: torch.Tensor
    depth: torch.Tensor
    turning: torch.Tensor
    diverging: torch.Tensor
    num_steps: torch.Tensor
    sum_accept: torch.Tensor


class _SubState(NamedTuple):
    """One doubling's subtree of ``2**depth`` leapfrogs."""

    i: torch.Tensor
    state: _IntegratorState
    proposal_z: torch.Tensor
    log_sum_w: torch.Tensor
    r_sum: torch.Tensor
    r_ckpts: torch.Tensor
    r_sum_ckpts: torch.Tensor
    turning: torch.Tensor
    diverging: torch.Tensor
    key: torch.Tensor
    sum_accept: torch.Tensor


def value_and_grad(logdensity_fn: Callable):
    """``z -> (logp, d logp / dz)``, both detached: the graph lives only
    inside the call."""

    def f(z: torch.Tensor):
        with torch.enable_grad():
            zz = z.detach().requires_grad_()
            logp = logdensity_fn(zz)
            (grad,) = torch.autograd.grad(logp.sum(), zz, allow_unused=True)
        if grad is None:
            grad = torch.zeros_like(z)
        return logp.detach(), grad.detach()

    return f


def _leapfrog(logp_and_grad: Callable, eps, inv_mass):
    """``eps``: the signed step, ``B + (1,)``."""

    def step(state: _IntegratorState) -> _IntegratorState:
        r_half = state.r + 0.5 * eps * state.grad
        z_new = state.z + eps * inv_mass * r_half
        logp_new, grad_new = logp_and_grad(z_new)
        r_new = r_half + 0.5 * eps * grad_new
        return _IntegratorState(z_new, r_new, logp_new, grad_new)

    return step


def _kinetic(r, inv_mass):
    return 0.5 * (inv_mass * r * r).sum(-1)


def _is_turning(inv_mass, r_left, r_right, r_sum):
    """The generalized u-turn criterion (Betancourt) at both ends."""
    turning_left = ((inv_mass * r_left) * (r_sum - r_left)).sum(-1) <= 0.0
    turning_right = ((inv_mass * r_right) * (r_sum - r_right)).sum(-1) <= 0.0
    return turning_left | turning_right


def _popcount(i: torch.Tensor, bits: int) -> torch.Tensor:
    """Set bits of ``i`` (``0 <= i < 2**bits``)."""
    out = torch.zeros_like(i)
    for b in range(bits):
        out = out + ((i >> b) & 1)
    return out


def _fresh_substate(frontier: _IntegratorState, sub_key, max_depth: int
                    ) -> _SubState:
    z = frontier.z
    batch, d = tuple(z.shape[:-1]), z.shape[-1]
    ckpts = torch.zeros(batch + (max_depth, d), dtype=z.dtype,
                        device=z.device)
    false = torch.zeros(batch, dtype=torch.bool, device=z.device)
    return _SubState(
        torch.zeros(batch, dtype=torch.int32, device=z.device), frontier, z,
        torch.full(batch, -torch.inf, dtype=z.dtype, device=z.device),
        torch.zeros_like(frontier.r), ckpts, ckpts, false, false, sub_key,
        torch.zeros(batch, dtype=z.dtype, device=z.device))


def _make_subtree_body(logp_and_grad, eps_signed, inv_mass, energy0,
                       max_delta_energy, max_depth):
    """One leapfrog and its subtree bookkeeping, ``_SubState ->
    _SubState``, shared by both strategies."""
    step_fn = _leapfrog(logp_and_grad, eps_signed, inv_mass)
    slots = torch.arange(max_depth, device=energy0.device)

    def body(s: _SubState) -> _SubState:
        state = step_fn(s.state)
        energy = -state.logp + _kinetic(state.r, inv_mass)
        delta = energy - energy0
        diverging = (delta > max_delta_energy) | torch.isnan(delta)
        delta = torch.where(torch.isnan(delta), torch.inf, delta)
        log_w = -delta
        accept = torch.clamp(torch.exp(-delta), max=1.0)
        # Multinomial progressive sampling within the subtree.
        key, sub_key = random.split(s.key).unbind(-2)
        new_log_sum = torch.logaddexp(s.log_sum_w, log_w)
        take = torch.log(random.uniform(sub_key, ())) < log_w - new_log_sum
        proposal_z = torch.where(take[..., None], state.z, s.proposal_z)
        r_sum = s.r_sum + state.r

        # U-turn checkpoints: at even i store (r, r_sum) at stack height
        # popcount(i); at odd i check the trailing_ones(i) completed
        # power-of-two subtrees that end here, all slots at once.
        is_even = (s.i % 2) == 0
        store_idx = _popcount(s.i, max_depth + 1)
        write = (is_even[..., None] & (slots == store_idx[..., None]))[
            ..., None]
        r_ckpts = torch.where(write, state.r[..., None, :], s.r_ckpts)
        r_sum_ckpts = torch.where(write, r_sum[..., None, :], s.r_sum_ckpts)
        n_checks = _popcount(s.i ^ (s.i + 1), max_depth + 2) - 1
        valid = ~is_even[..., None] & (slots < n_checks[..., None])
        ck_idx = torch.clamp(store_idx[..., None] - slots - 1, 0,
                             max_depth - 1)[..., None].expand(
                                 r_ckpts.shape)
        r_l = torch.take_along_dim(r_ckpts, ck_idx, dim=-2)
        rs = (r_sum[..., None, :]
              - torch.take_along_dim(r_sum_ckpts, ck_idx, dim=-2) + r_l)
        v_l = inv_mass * r_l
        v_r = inv_mass * state.r
        turn_l = (v_l * (rs - r_l)).sum(-1) <= 0.0
        turn_r = torch.matmul(rs - state.r[..., None, :],
                              v_r[..., None])[..., 0] <= 0.0
        turning = (valid & (turn_l | turn_r)).any(-1)
        return _SubState(
            s.i + 1, state, proposal_z, new_log_sum, r_sum, r_ckpts,
            r_sum_ckpts, s.turning | turning, s.diverging | diverging, key,
            s.sum_accept + accept)

    return body


def _merge_doubling(t: _TrajState, sub: _SubState, direction, merge_key,
                    inv_mass, new_key) -> _TrajState:
    """Fold one finished subtree into the trajectory: biased progressive
    sampling between the old trajectory and the subtree, and the
    whole-tree u-turn check."""
    forward = direction > 0
    left = tree_where(forward, t.left, sub.state)
    right = tree_where(forward, sub.state, t.right)
    log_sum_w = torch.logaddexp(t.log_sum_w, sub.log_sum_w)
    accept_new = (torch.log(random.uniform(merge_key, ()))
                  < sub.log_sum_w - t.log_sum_w)
    subtree_ok = ~sub.turning & ~sub.diverging
    proposal_z = torch.where((accept_new & subtree_ok)[..., None],
                             sub.proposal_z, t.proposal_z)
    r_sum = t.r_sum + sub.r_sum
    whole_turning = _is_turning(inv_mass, left.r, right.r, r_sum)
    return _TrajState(
        new_key, left, right, proposal_z,
        torch.where(subtree_ok, log_sum_w, t.log_sum_w), r_sum, t.depth + 1,
        sub.turning | whole_turning, sub.diverging, t.num_steps + sub.i,
        t.sum_accept + sub.sum_accept)


def _doubling_start(t: _TrajState, max_depth: int):
    """The 4-way key split, the direction draw and the frontier that one
    doubling starts from."""
    key, dir_key, merge_key, sub_key = random.split(t.key, 4).unbind(-2)
    direction = torch.where(random.bernoulli(dir_key, 0.5), 1.0, -1.0)
    frontier = tree_where(direction > 0, t.right, t.left)
    return key, direction, merge_key, _fresh_substate(frontier, sub_key,
                                                      max_depth)


def _run_dynamic(logp_and_grad, traj: _TrajState, eps, inv_mass, max_depth,
                 max_delta_energy) -> _TrajState:
    """Doubling in a ``while`` over the active chains; within a doubling,
    up to ``2**depth`` leapfrogs in a ``while`` of their own."""
    energy0 = -traj.left.logp + _kinetic(traj.left.r, inv_mass)
    t = traj

    def traj_active(t):
        return (t.depth < max_depth) & ~t.turning & ~t.diverging

    active = traj_active(t)
    while _any(active):
        key, direction, merge_key, sub = _doubling_start(t, max_depth)
        body = _make_subtree_body(
            logp_and_grad, (direction * eps)[..., None], inv_mass, energy0,
            max_delta_energy, max_depth)
        num_steps = torch.pow(2, t.depth)
        sub_active = active
        while True:
            sub_active = (sub_active & (sub.i < num_steps) & ~sub.turning
                          & ~sub.diverging)
            if not _any(sub_active):
                break
            sub = tree_where(sub_active, body(sub), sub)
        merged = _merge_doubling(t, sub, direction, merge_key, inv_mass, key)
        t = tree_where(active, merged, t)
        active = traj_active(t)
    return t


def _run_fixed(logp_and_grad, traj: _TrajState, eps, inv_mass, max_depth,
               max_delta_energy) -> _TrajState:
    """One loop over the worst-case ``2**max_depth - 1`` leapfrog slots.
    Each slot advances each chain's tree state machine: at a doubling
    boundary it draws the direction and seats the subtree at the chosen
    frontier, then takes one masked leapfrog, then folds a finished
    subtree into the trajectory. Keys advance on active slots only, so
    the draws are those of the dynamic strategy."""
    energy0 = -traj.left.logp + _kinetic(traj.left.r, inv_mass)
    t = traj
    sub = _fresh_substate(traj.left, traj.key, max_depth)
    direction = torch.ones_like(energy0)
    merge_key = traj.key
    done = torch.zeros_like(traj.turning)
    for _ in range(2 ** max_depth - 1):
        active = ~done
        start = active & (sub.i == 0)
        key, new_dir, new_merge_key, fresh = _doubling_start(t, max_depth)
        sub = tree_where(start, fresh, sub)
        direction = torch.where(start, new_dir, direction)
        merge_key = tree_where(start, new_merge_key, merge_key)
        t = t._replace(key=tree_where(start, key, t.key))
        body = _make_subtree_body(
            logp_and_grad, (direction * eps)[..., None], inv_mass, energy0,
            max_delta_energy, max_depth)
        sub = tree_where(active, body(sub), sub)
        num_steps = torch.pow(2, t.depth)
        sub_done = active & ((sub.i >= num_steps) | sub.turning
                             | sub.diverging)
        merged = _merge_doubling(t, sub, direction, merge_key, inv_mass,
                                 t.key)
        t = tree_where(sub_done, merged, t)
        done = done | (sub_done & ((t.depth >= max_depth) | t.turning
                                   | t.diverging))
        sub = sub._replace(i=torch.where(sub_done, torch.zeros_like(sub.i),
                                         sub.i))
    return t


def nuts_kernel(
    logdensity_fn: Callable[[torch.Tensor], torch.Tensor],
    z0: torch.Tensor,
    key: torch.Tensor,
    eps,
    inv_mass: torch.Tensor | None = None,
    max_depth: int = 10,
    max_delta_energy: float = 1000.0,
    fixed_budget: bool = False,
) -> tuple[torch.Tensor, NUTSInfo]:
    """One NUTS transition of every chain from ``z0`` (``B + (D,)``, keys
    ``B + (2,)``). Returns ``(z_next, info)``, each field of ``info`` of
    the shape ``B``. ``eps`` is a number or a tensor that broadcasts
    against ``B``; ``inv_mass`` the diagonal inverse mass, ``(D,)``."""
    d = z0.shape[-1]
    if inv_mass is None:
        inv_mass = torch.ones(d, dtype=z0.dtype, device=z0.device)
    inv_mass = torch.as_tensor(inv_mass, dtype=z0.dtype, device=z0.device)
    if inv_mass.ndim == 0:
        inv_mass = inv_mass.expand(d)
    eps = torch.as_tensor(eps, dtype=z0.dtype, device=z0.device)
    logp_and_grad = value_and_grad(logdensity_fn)

    key, r_key = random.split(key).unbind(-2)
    r0 = random.normal(r_key, (d,)) / torch.sqrt(inv_mass)
    logp0, grad0 = logp_and_grad(z0)
    # A non-finite start would read delta = -inf as perfect acceptance
    # while the chain never moves: it is reported as accept 0, diverging.
    finite0 = torch.isfinite(logp0)
    energy0 = -logp0 + _kinetic(r0, inv_mass)
    init = _IntegratorState(z0.detach(), r0, logp0, grad0)
    batch = tuple(logp0.shape)
    zero_i = torch.zeros(batch, dtype=torch.int32, device=z0.device)
    false = torch.zeros(batch, dtype=torch.bool, device=z0.device)
    traj = _TrajState(key, init, init, z0.detach(), torch.zeros_like(logp0),
                      r0, zero_i, false, false, zero_i,
                      torch.zeros_like(logp0))
    run = _run_fixed if fixed_budget else _run_dynamic
    out = run(logp_and_grad, traj, eps, inv_mass, max_depth,
              max_delta_energy)
    accept_prob = out.sum_accept / torch.clamp(out.num_steps, min=1)
    accept_prob = torch.where(finite0, accept_prob,
                              torch.zeros_like(accept_prob))
    info = NUTSInfo(accept_prob, out.num_steps, out.diverging | ~finite0,
                    energy0)
    return torch.where(finite0[..., None], out.proposal_z, z0.detach()), info


#: Host reads of a device flag by the dynamic strategy, since the caller
#: last set it to 0.
nuts_kernel.host_syncs = 0


def check_float_latents(vals):
    """A gradient kernel moves continuous latents only: an integer leaf in
    the position vector would drift with a zero gradient and truncate
    back with no MH correction."""
    for leaf in tree_leaves(vals):
        if not torch.as_tensor(leaf).is_floating_point():
            raise TypeError(
                "NUTS position includes a non-float latent (dtype "
                f"{torch.as_tensor(leaf).dtype}). Exclude discrete sites "
                "from the selection and move them with a separate "
                "Regenerate/enumeration kernel.")


@Pytree.dataclass
class NUTS(EditRequest):
    """NUTS over the selected choices of a trace, one transition per
    chain of its batch. The edit weight is 0 (the transition leaves the
    posterior invariant; under ``mh`` it always accepts)."""

    selection: Selection
    eps: Any
    max_depth: int = Pytree.static(default=8)
    inv_mass: Any = None
    fixed_budget: bool = Pytree.static(default=False)

    def edit(self, key, tr: Trace[Any], argdiffs: Argdiffs):
        assert Diff.static_check_no_change(argdiffs)
        args = Diff.tree_primal(argdiffs)
        batch = tr.batch_shape()
        chm = tr.get_choices()
        complement = chm.filter(~self.selection)
        # Only the Choice payloads are raveled: structural leaves (Mask
        # flags, Indexed addresses) stay out of the position vector.
        vals, rebuild = partition_values(chm.filter(self.selection))
        check_float_latents(vals)
        flat, unravel_vals = ravel_pytree(vals, len(batch))
        gen_fn = tr.get_gen_fn()

        def logdensity(z_vec):
            score, _ = gen_fn.assess(rebuild(unravel_vals(z_vec))
                                     | complement, args, batch=batch)
            return score

        key, up_key = random.split(key).unbind(-2)
        z_next, _ = nuts_kernel(
            logdensity, flat, key, self.eps, inv_mass=self.inv_mass,
            max_depth=self.max_depth, fixed_budget=self.fixed_budget)
        new_tr, _, retdiff, _ = Update(rebuild(unravel_vals(z_next))).edit(
            up_key, tr, argdiffs)
        return new_tr, torch.zeros(batch, device=key.device), retdiff, NUTS(
            self.selection, self.eps, self.max_depth, self.inv_mass,
            self.fixed_budget)
