"""Exact discrete HMM posterior as a distribution: forward-filter
backward-sample (FFBS), exact data marginals, and a parallel-prefix
forward filter for long sequences (counterpart of
``genjax_tpu/lang/distributions/discrete_hmm.py``).

``lax.scan`` becomes a Python loop; ``lax.associative_scan`` becomes
``core/scan.py::associative_scan``, whose combine here is the
log-space matrix product of ``ops/logmatmul.py`` (the Hopper kernel on a
CUDA tensor). As everywhere in the port, the samplers take a key batch
``B + (2,)`` as ``B`` executions. The parameters and observations may
carry a batch of problems in front (what ``jax.vmap`` of the JAX
functions maps over): the filter then runs once per problem, its
parallel form one batched log-space product per scan level over every
problem's pairs. Parameters shared by the whole key batch run one filter,
and the backward pass runs once per key.
"""

from __future__ import annotations

import torch

from genjax_torch.core import random
from genjax_torch.core.fixed_sum import prefix_sum, tree_logsumexp
from genjax_torch.core.pytree import Pytree
from genjax_torch.core.scan import associative_scan
from genjax_torch.lang.distributions.distribution import Distribution
from genjax_torch.ops.logmatmul import log_matmul

__all__ = [
    "DiscreteHMMConfiguration",
    "DiscreteHMM",
    "discrete_hmm",
    "forward_filter",
    "forward_filter_parallel",
    "backward_sample",
    "backward_sample_parallel",
    "posterior_logpdf",
    "joint_logpdf",
    "log_data_marginal",
]


@Pytree.dataclass
class DiscreteHMMConfiguration(Pytree):
    """HMM parameters in log space: ``prior_logits`` (S,), row-normalized
    ``transition_logits`` (S, S) with ``[i, j] = log P(z'=j | z=i)``, and
    ``observation_logits`` (S, O) with ``[i, k] = log P(x=k | z=i)``."""

    prior_logits: torch.Tensor
    transition_logits: torch.Tensor
    observation_logits: torch.Tensor

    @staticmethod
    def from_probs(prior, transition, observation):
        def log(p):
            return torch.log(torch.as_tensor(p, dtype=torch.float32))

        return DiscreteHMMConfiguration(log(prior), log(transition),
                                        log(observation))

    @staticmethod
    def circulant(
        num_states: int,
        num_obs: int,
        transition_distance: float = 1.0,
        observation_distance: float = 1.0,
        transition_variance: float = 1.0,
        observation_variance: float = 1.0,
        device=None,
    ) -> "DiscreteHMMConfiguration":
        """Circulant transition/observation structure: probability decays
        with (wrap-around) distance from the current state. A distance or
        variance given as a tensor of shape ``B`` makes a batch of
        configurations, every parameter leading with ``B`` (a zero-stride
        view where it does not depend on them), as ``jax.vmap`` of the
        JAX constructor returns them."""

        def per(v):
            if isinstance(v, torch.Tensor):
                return v.to(device=device)[..., None, None]
            return v

        def circ_logits(n_row, n_col, distance, variance):
            i = torch.arange(n_row, device=device)[:, None]
            j = torch.arange(n_col, device=device)[None, :]
            d = torch.minimum((i - j).abs(), n_row - (i - j).abs())
            logits = -torch.square(d.to(torch.float32) * per(distance)) / (
                2.0 * per(variance))
            return torch.log_softmax(logits, dim=-1)

        prior = torch.log_softmax(torch.zeros(num_states, device=device),
                                  dim=-1)
        trans = circ_logits(num_states, num_states, transition_distance,
                            transition_variance)
        obs = circ_logits(num_states, num_obs, observation_distance,
                          observation_variance)
        batch = torch.broadcast_shapes(trans.shape[:-2], obs.shape[:-2])
        if batch:
            prior = prior.expand(batch + prior.shape)
            trans = trans.expand(batch + trans.shape[-2:])
            obs = obs.expand(batch + obs.shape[-2:])
        return DiscreteHMMConfiguration(prior, trans, obs)

    @property
    def num_states(self) -> int:
        return self.prior_logits.shape[-1]


def _param_batch(config: DiscreteHMMConfiguration, observations) -> tuple:
    """The batch of problems the parameters carry in front of their own
    axes (``()`` for one problem)."""
    obs = torch.as_tensor(observations)
    return tuple(torch.broadcast_shapes(
        config.prior_logits.shape[:-1], config.transition_logits.shape[:-2],
        config.observation_logits.shape[:-2], obs.shape[:-1]))


def _flat_problems(config: DiscreteHMMConfiguration, observations,
                   batch: tuple):
    """The parameters broadcast to ``batch`` and flattened to ``(P, ...)``
    (a zero-stride view where a parameter is shared)."""
    p = 1
    for d in batch:
        p *= d

    def flat(v, rank):
        v = torch.as_tensor(v)
        return v.expand(batch + tuple(v.shape[v.ndim - rank:])).reshape(
            (p,) + tuple(v.shape[v.ndim - rank:]))

    obs = torch.as_tensor(observations,
                          device=config.observation_logits.device)
    return (DiscreteHMMConfiguration(flat(config.prior_logits, 1),
                                     flat(config.transition_logits, 2),
                                     flat(config.observation_logits, 2)),
            flat(obs, 1))


def _obs_ll_batched(config: DiscreteHMMConfiguration,
                    observations: torch.Tensor) -> torch.Tensor:
    """``(P, T, S)``: ``log P(x_t | z_t = s)`` of every problem, from
    flattened parameters (:func:`_flat_problems`)."""
    p, s, _ = config.observation_logits.shape
    idx = observations[:, None, :].expand(p, s, observations.shape[-1])
    return torch.gather(config.observation_logits, 2,
                        idx).transpose(1, 2).contiguous()


def _obs_ll(config: DiscreteHMMConfiguration, observations) -> torch.Tensor:
    """``(T, S)``: ``log P(x_t | z_t = s)``, row-major. (A transposed
    view here would give the operators built from it a permuted layout,
    which the log-matmul wrapper would copy at every scan level.)"""
    obs = torch.as_tensor(observations,
                          device=config.observation_logits.device)
    return config.observation_logits[:, obs].T.contiguous()


def filter_recursion(u: torch.Tensor, trans: torch.Tensor,
                     obs_rows: torch.Tensor):
    """The forward recursion ``y_t = logsumexp_k(u_{t-1}[k] + trans[k, :])
    + obs_t`` in scaled form: each step's state is kept as ``u_t = y_t -
    m_t`` (max 0) and its shift ``m_t = max y_t``. ``u``: ``(..., S)``
    with max 0; ``obs_rows``: ``(n, ..., S)``. Returns ``(us, ms)``,
    ``(n, ..., S)`` and ``(n, ...)``. The log joint is the running sum of
    the shifts plus ``u``; kept apart, no step adds a small number to a
    large one, so f32 rounding does not drift with the length of the
    chain. Every logsumexp is a fixed tree (``core/fixed_sum.py``)."""
    us, ms = [], []
    for row in obs_rows:
        y = tree_logsumexp(u[..., :, None] + trans, -2) + row
        m = y.amax(-1, keepdim=True)
        u = y - m
        us.append(u)
        ms.append(m[..., 0])
    if not us:
        return u.new_empty((0,) + u.shape), u.new_empty((0,) + u.shape[:-1])
    return torch.stack(us), torch.stack(ms)


def unscale(offsets: torch.Tensor, us: torch.Tensor) -> torch.Tensor:
    """``alphas = offsets + us`` added in float64 and rounded once to
    ``us``'s dtype (``offsets``: float64, ``us``'s shape but the last
    axis)."""
    return (offsets[..., None] + us.double()).to(us.dtype)


def forward_filter(config: DiscreteHMMConfiguration, observations
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Sequential forward filtering. Returns ``(alphas, log_marginal)``
    where ``alphas[t, s] = log P(z_t = s, x_{1:t})``. The recursion runs
    scaled (:func:`filter_recursion`): the shifts are summed in float64
    by a fixed-association prefix sum and each alpha is rounded once, so
    the log marginal of a long chain stays within f32 rounding of the
    exact one. ``parallel.time_sharded_filter`` runs the same steps, and
    at one rank and one block gives these bits.

    Parameters with a batch of problems ``P`` in front give ``alphas``
    ``P + (T, S)`` and ``P`` log marginals, each problem's bits those of
    its own filter."""
    batch = _param_batch(config, observations)
    if batch:
        return _forward_filter_batched(config, observations, batch)
    obs_ll = _obs_ll(config, observations)
    alpha0 = config.prior_logits + obs_ll[0]
    m0 = alpha0.amax(-1)
    us, ms = filter_recursion(alpha0 - m0, config.transition_logits,
                              obs_ll[1:])
    us = torch.cat([(alpha0 - m0)[None], us])
    offsets = prefix_sum(torch.cat([m0[None], ms]).double())
    return unscale(offsets, us), unscale(offsets[-1],
                                         tree_logsumexp(us[-1], 0)[None])[0]


def _forward_filter_batched(config, observations, batch: tuple):
    """:func:`forward_filter` over a batch of problems, the recursion
    run on all of them at once."""
    config, obs = _flat_problems(config, observations, batch)
    obs_ll = _obs_ll_batched(config, obs)                       # (P, T, S)
    alpha0 = config.prior_logits + obs_ll[:, 0]
    m0 = alpha0.amax(-1)
    u0 = alpha0 - m0[:, None]
    us, ms = filter_recursion(u0, config.transition_logits,
                              obs_ll[:, 1:].transpose(0, 1))
    us = torch.cat([u0[None], us])                              # (T, P, S)
    offsets = prefix_sum(torch.cat([m0[None], ms]).double().T)  # (P, T)
    alphas = unscale(offsets, us.transpose(0, 1))
    logm = unscale(offsets[:, -1],
                   tree_logsumexp(us[-1], -1)[:, None])[:, 0]
    t, s = alphas.shape[-2:]
    return alphas.reshape(batch + (t, s)), logm.reshape(batch)


def forward_filter_parallel(config: DiscreteHMMConfiguration, observations
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Parallel-prefix forward filtering: O(log T) depth through an
    associative scan over the log-space transition·observation operators,
    each level one batched :func:`~genjax_torch.ops.logmatmul.log_matmul`.
    A batch of problems ``P`` scans their ``(P, T - 1, S, S)`` operators
    along the step axis, each level one launch over every problem's
    pairs."""
    batch = _param_batch(config, observations)
    if batch:
        return _forward_filter_parallel_batched(config, observations, batch)
    obs_ll = _obs_ll(config, observations)
    # M_t[i, j] = log P(z_t = j, x_t | z_{t-1} = i) for t >= 1.
    ms = config.transition_logits[None, :, :] + obs_ll[1:, None, :]
    prefix = associative_scan(log_matmul, ms)  # (T-1, S, S)
    alpha0 = config.prior_logits + obs_ll[0]
    rest = torch.logsumexp(alpha0[None, :, None] + prefix, dim=1)
    alphas = torch.cat([alpha0[None], rest], dim=0)
    return alphas, torch.logsumexp(alphas[-1], dim=0)


def _forward_filter_parallel_batched(config, observations, batch: tuple):
    config, obs = _flat_problems(config, observations, batch)
    obs_ll = _obs_ll_batched(config, obs)                       # (P, T, S)
    # (P, T-1, S, S)
    ms = config.transition_logits[:, None, :, :] + obs_ll[:, 1:, None, :]
    prefix = associative_scan(log_matmul, ms, axis=1)
    del ms
    alpha0 = config.prior_logits + obs_ll[:, 0]
    rest = torch.logsumexp(alpha0[:, None, :, None] + prefix, dim=2)
    alphas = torch.cat([alpha0[:, None], rest], dim=1)
    t, s = alphas.shape[-2:]
    return (alphas.reshape(batch + (t, s)),
            torch.logsumexp(alphas[:, -1], dim=-1).reshape(batch))


def _rows(mat: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """Row ``z`` of each execution's matrix: ``mat`` ``P + (S, S')``
    broadcast against ``z`` of shape ``B``; ``B + (S',)``."""
    batch = tuple(z.shape)
    mat = mat.expand(batch + tuple(mat.shape[-2:]))
    idx = z[..., None, None].expand(batch + (1, mat.shape[-1]))
    return torch.take_along_dim(mat, idx, dim=-2)[..., 0, :]


def backward_sample_parallel(key: torch.Tensor,
                             config: DiscreteHMMConfiguration,
                             alphas: torch.Tensor) -> torch.Tensor:
    """O(log T)-depth exact posterior path sampling: for every step the
    inverse-CDF sampling table ``f_t : z_{t+1} -> z_t`` (one uniform per
    step, shared by all conditioning states), composed backward by an
    associative scan whose combine is gather composition. Returns
    ``z`` of shape ``B + (T,)``. ``config`` and ``alphas`` may lead with
    a batch of problems that broadcasts against ``B``: the conditional
    tables are built once per problem and compared with each key's
    uniforms."""
    batch = tuple(key.shape[:-1])
    n_steps = alphas.shape[-2]
    k_last, k_steps = random.split(key).unbind(-2)
    z_last = random.categorical(
        k_last, alphas[..., -1, :].expand(batch + alphas.shape[-1:]))
    # L_t[j, s] = log P(z_t = s | z_{t+1} = j), t < T-1: P + (T-1, S, S).
    cond_logits = (alphas[..., :-1, None, :]
                   + config.transition_logits.transpose(-1, -2)[..., None,
                                                                :, :])
    # One uniform per step and key: fold_in(k_steps, t), B + (T-1,).
    steps = torch.arange(n_steps - 1, device=key.device)
    us = random.uniform(random.fold_in(k_steps[..., None, :], steps))
    cdf = torch.cumsum(torch.softmax(cond_logits, dim=-1), dim=-1)
    del cond_logits
    # f_t[j] = first s with cdf >= u_t (0 when none, as argmax gives).
    hit = (cdf >= us[..., None, None]).to(torch.uint8)
    tables = torch.argmax(hit, dim=-1)                         # B + (T-1, S)
    del hit
    # acc[k] = f_{T-2-k} o ... o f_{T-2}: scan over the reversed tables
    # with combine(b, a) = a o b, the step axis leading.
    n = z_last.numel()
    rev = tables.reshape(n, n_steps - 1, -1).flip(1).transpose(0, 1)
    acc = associative_scan(lambda b, a: torch.gather(a, -1, b), rev)
    idx = z_last.reshape(1, n, 1).expand(acc.shape[0], -1, 1)
    zs = torch.gather(acc, -1, idx)[..., 0].flip(0).T          # (N, T-1)
    z = torch.cat([zs, z_last.reshape(n, 1)], dim=1)
    return z.reshape(batch + (n_steps,))


def backward_sample(key: torch.Tensor, config: DiscreteHMMConfiguration,
                    alphas: torch.Tensor) -> torch.Tensor:
    """Sample a latent path from the exact posterior given filtered
    ``alphas``; returns ``z`` of shape ``B + (T,)``. ``config`` and
    ``alphas`` may lead with a batch of problems that broadcasts against
    ``B``."""
    batch = tuple(key.shape[:-1])
    alphas = alphas.expand(batch + tuple(alphas.shape[-2:]))
    n_steps = alphas.shape[-2]
    z_next = random.categorical(key, alphas[..., -1, :])
    zs = [z_next]
    ts = torch.arange(n_steps - 2, -1, -1, device=key.device)
    # The step keys fold_in(key, t) for t = T-2, ..., 0 at once: B + (T-1, 2).
    step_keys = random.fold_in(key[..., None, :], ts)
    trans_cols = config.transition_logits.transpose(-1, -2)    # [z', z]
    for i, t in enumerate(range(n_steps - 2, -1, -1)):
        logits = alphas[..., t, :] + _rows(trans_cols, z_next)
        z_next = random.categorical(step_keys[..., i, :], logits)
        zs.append(z_next)
    return torch.stack(zs[::-1], dim=-1)


def joint_logpdf(config: DiscreteHMMConfiguration, z: torch.Tensor,
                 observations) -> torch.Tensor:
    """``log P(z, x)`` of paths ``z`` of shape ``B + (T,)``: one value
    per path. Parameters and observations with a batch of problems in
    front broadcast against ``B``."""
    obs = torch.as_tensor(observations, device=z.device)
    batch = tuple(z.shape[:-1])
    s = config.prior_logits.shape[-1]
    o = config.observation_logits.shape[-1]

    def flat_gather(mat, idx):
        mat = mat.reshape(tuple(mat.shape[:-2]) + (-1,))
        return torch.take_along_dim(
            mat.expand(batch + mat.shape[-1:]), idx, dim=-1)

    prior = torch.take_along_dim(
        config.prior_logits.expand(batch + (s,)), z[..., :1], dim=-1)[..., 0]
    trans = flat_gather(config.transition_logits,
                        z[..., :-1] * s + z[..., 1:]).sum(-1)
    emit = flat_gather(config.observation_logits,
                       z * o + obs.expand(z.shape)).sum(-1)
    return prior + trans + emit


def posterior_logpdf(config: DiscreteHMMConfiguration, z: torch.Tensor,
                     observations) -> torch.Tensor:
    """Exact ``log P(z | x)`` = joint − marginal."""
    _, logm = forward_filter(config, observations)
    return joint_logpdf(config, z, observations) - logm


def log_data_marginal(config: DiscreteHMMConfiguration,
                      observations) -> torch.Tensor:
    """Exact ``log P(x_{1:T})``."""
    _, logm = forward_filter(config, observations)
    return logm


def _problem_params(config: DiscreteHMMConfiguration, observations,
                    rank: int):
    """The parameters as the ``rank`` batch axes of an execution see
    them. Each leads with the batch (a ``@gen`` body hands shared ones
    over lifted, as zero-stride views) or has no batch. A batch axis on
    which every parameter is zero-stride is shared: it is cut to length
    1, so that the filter runs once for all its executions; when every
    axis is shared the parameters drop the batch (one filter for the
    whole batch, as for unbatched parameters)."""
    own = {"prior_logits": 1, "transition_logits": 2,
           "observation_logits": 2}
    vals = {k: torch.as_tensor(getattr(config, k)) for k in own}
    vals["observations"] = torch.as_tensor(observations)
    own["observations"] = 1
    batched = [k for k, v in vals.items() if v.ndim - own[k] > 0]
    shared = [i for i in range(rank)
              if all(vals[k].stride(i) == 0 or vals[k].shape[i] == 1
                     for k in batched)]
    out = {}
    for k, v in vals.items():
        if v.ndim - own[k] <= 0:
            out[k] = v
        elif len(shared) == rank:
            out[k] = v[(0,) * (v.ndim - own[k])]
        else:
            out[k] = v[tuple(slice(0, 1) if i in shared else slice(None)
                             for i in range(rank))]
    return (DiscreteHMMConfiguration(out["prior_logits"],
                                     out["transition_logits"],
                                     out["observation_logits"]),
            out["observations"])


@Pytree.dataclass
class DiscreteHMM(Distribution):
    """The exact latent-sequence posterior of a discrete HMM as a
    Distribution over paths: args = (config, observations), shared by
    every execution of a key batch or each execution's own."""

    use_parallel_filter: bool = Pytree.static(default=False)

    def _filter(self, config, observations):
        if self.use_parallel_filter:
            return forward_filter_parallel(config, observations)
        return forward_filter(config, observations)

    def random_weighted(self, key, config, observations):
        config, observations = _problem_params(config, observations,
                                               key.ndim - 1)
        alphas, logm = self._filter(config, observations)
        if self.use_parallel_filter:
            z = backward_sample_parallel(key, config, alphas)
        else:
            z = backward_sample(key, config, alphas)
        score = joint_logpdf(config, z, observations) - logm
        return score, z

    def estimate_logpdf(self, key, z, config, observations):
        config, observations = _problem_params(config, observations,
                                               torch.as_tensor(z).ndim - 1)
        _, logm = self._filter(config, observations)
        return joint_logpdf(config, z, observations) - logm


#: Singleton (sequential filter).
discrete_hmm = DiscreteHMM()
