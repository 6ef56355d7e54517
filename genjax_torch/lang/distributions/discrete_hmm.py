"""Exact discrete HMM posterior as a distribution: forward-filter
backward-sample (FFBS), exact data marginals, and a parallel-prefix
forward filter for long sequences (counterpart of
``genjax_tpu/lang/distributions/discrete_hmm.py``).

``lax.scan`` becomes a Python loop; ``lax.associative_scan`` becomes
``core/scan.py::associative_scan``, whose combine here is the
log-space matrix product of ``ops/logmatmul.py`` (the Hopper kernel on a
CUDA tensor). As everywhere in the port, the samplers take a key batch
``B + (2,)`` as ``B`` executions: the filter runs once, the backward pass
once per key.
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
        with (wrap-around) distance from the current state."""

        def circ_logits(n_row, n_col, distance, variance):
            i = torch.arange(n_row, device=device)[:, None]
            j = torch.arange(n_col, device=device)[None, :]
            d = torch.minimum((i - j).abs(), n_row - (i - j).abs())
            logits = -torch.square(d.to(torch.float32) * distance) / (
                2.0 * variance)
            return torch.log_softmax(logits, dim=-1)

        prior = torch.log_softmax(torch.zeros(num_states, device=device),
                                  dim=-1)
        trans = circ_logits(num_states, num_states, transition_distance,
                            transition_variance)
        obs = circ_logits(num_states, num_obs, observation_distance,
                          observation_variance)
        return DiscreteHMMConfiguration(prior, trans, obs)

    @property
    def num_states(self) -> int:
        return self.prior_logits.shape[-1]


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
    at one rank and one block gives these bits."""
    obs_ll = _obs_ll(config, observations)
    alpha0 = config.prior_logits + obs_ll[0]
    m0 = alpha0.amax(-1)
    us, ms = filter_recursion(alpha0 - m0, config.transition_logits,
                              obs_ll[1:])
    us = torch.cat([(alpha0 - m0)[None], us])
    offsets = prefix_sum(torch.cat([m0[None], ms]).double())
    return unscale(offsets, us), unscale(offsets[-1],
                                         tree_logsumexp(us[-1], 0)[None])[0]


def forward_filter_parallel(config: DiscreteHMMConfiguration, observations
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Parallel-prefix forward filtering: O(log T) depth through an
    associative scan over the log-space transition·observation operators,
    each level one batched :func:`~genjax_torch.ops.logmatmul.log_matmul`."""
    obs_ll = _obs_ll(config, observations)
    # M_t[i, j] = log P(z_t = j, x_t | z_{t-1} = i) for t >= 1.
    ms = config.transition_logits[None, :, :] + obs_ll[1:, None, :]
    prefix = associative_scan(log_matmul, ms)  # (T-1, S, S)
    alpha0 = config.prior_logits + obs_ll[0]
    rest = torch.logsumexp(alpha0[None, :, None] + prefix, dim=1)
    alphas = torch.cat([alpha0[None], rest], dim=0)
    return alphas, torch.logsumexp(alphas[-1], dim=0)


def _flat_keys(key: torch.Tensor) -> tuple[torch.Tensor, tuple]:
    """The key batch as ``(N, 2)`` and its shape ``B``."""
    batch = tuple(key.shape[:-1])
    return random.key_data(key).reshape(-1, 2), batch


def backward_sample_parallel(key: torch.Tensor,
                             config: DiscreteHMMConfiguration,
                             alphas: torch.Tensor) -> torch.Tensor:
    """O(log T)-depth exact posterior path sampling: for every step the
    inverse-CDF sampling table ``f_t : z_{t+1} -> z_t`` (one uniform per
    step, shared by all conditioning states), composed backward by an
    associative scan whose combine is gather composition. Returns
    ``z`` of shape ``B + (T,)``."""
    keys, batch = _flat_keys(key)
    n_steps = alphas.shape[0]
    k_last, k_steps = random.split(keys).unbind(-2)
    z_last = random.categorical(k_last, alphas[-1])            # (N,)
    # L_t[j, s] = log P(z_t = s | z_{t+1} = j), t < T-1.
    cond_logits = (alphas[:-1][:, None, :]
                   + config.transition_logits.T[None])       # (T-1, S, S)
    # One uniform per step and key: fold_in(k_steps, t), (N, T-1).
    steps = torch.arange(n_steps - 1, device=keys.device)
    us = random.uniform(random.fold_in(k_steps[:, None, :], steps))
    cdf = torch.cumsum(torch.softmax(cond_logits, dim=-1), dim=-1)
    # f_t[j] = first s with cdf >= u_t (0 when none, as argmax gives).
    hit = (cdf[None] >= us[:, :, None, None]).to(torch.uint8)
    tables = torch.argmax(hit, dim=-1)                         # (N, T-1, S)
    # acc[k] = f_{T-2-k} o ... o f_{T-2}: scan over the reversed tables
    # with combine(b, a) = a o b, the step axis leading.
    rev = tables.flip(1).transpose(0, 1)                       # (T-1, N, S)
    acc = associative_scan(lambda b, a: torch.gather(a, -1, b), rev)
    idx = z_last[None, :, None].expand(acc.shape[0], -1, 1)
    zs = torch.gather(acc, -1, idx)[..., 0].flip(0).T          # (N, T-1)
    z = torch.cat([zs, z_last[:, None]], dim=1)
    return z.reshape(batch + (n_steps,))


def backward_sample(key: torch.Tensor, config: DiscreteHMMConfiguration,
                    alphas: torch.Tensor) -> torch.Tensor:
    """Sample a latent path from the exact posterior given filtered
    ``alphas``; returns ``z`` of shape ``B + (T,)``."""
    keys, batch = _flat_keys(key)
    n_steps = alphas.shape[0]
    z_next = random.categorical(keys, alphas[-1])              # (N,)
    zs = [z_next]
    ts = torch.arange(n_steps - 2, -1, -1, device=keys.device)
    # The step keys fold_in(key, t) for t = T-2, ..., 0 at once: (N, T-1, 2).
    step_keys = random.fold_in(keys[:, None, :], ts)
    trans_cols = config.transition_logits.T                    # [z', z]
    for i, t in enumerate(range(n_steps - 2, -1, -1)):
        logits = alphas[t][None, :] + trans_cols[z_next]
        z_next = random.categorical(step_keys[:, i], logits)
        zs.append(z_next)
    z = torch.stack(zs[::-1], dim=1)
    return z.reshape(batch + (n_steps,))


def joint_logpdf(config: DiscreteHMMConfiguration, z: torch.Tensor,
                 observations) -> torch.Tensor:
    """``log P(z, x)`` of paths ``z`` of shape ``B + (T,)``: one value
    per path."""
    obs = torch.as_tensor(observations, device=z.device)
    prior = config.prior_logits[z[..., 0]]
    trans = torch.sum(config.transition_logits[z[..., :-1], z[..., 1:]],
                      dim=-1)
    emit = torch.sum(config.observation_logits[z, obs], dim=-1)
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


def _one_copy(v, rank: int) -> torch.Tensor:
    """``v`` at its per-execution rank ``rank``: leading batch axes must
    be zero-stride (the same in every execution) and are dropped."""
    v = torch.as_tensor(v)
    extra = v.ndim - rank
    if extra <= 0:
        return v
    if any(v.stride(i) != 0 and v.shape[i] != 1 for i in range(extra)):
        raise NotImplementedError(
            "DiscreteHMM with per-execution parameters is not ported: its "
            "filter runs once for the whole batch")
    return v[(0,) * extra]


def _shared_params(config: DiscreteHMMConfiguration, observations):
    """The parameters as one execution sees them. They are shared by the
    batch; a ``@gen`` body hands them over lifted to it as zero-stride
    views, which their known ranks take back to one copy."""
    return (DiscreteHMMConfiguration(
        _one_copy(config.prior_logits, 1),
        _one_copy(config.transition_logits, 2),
        _one_copy(config.observation_logits, 2)),
        _one_copy(observations, 1))


@Pytree.dataclass
class DiscreteHMM(Distribution):
    """The exact latent-sequence posterior of a discrete HMM as a
    Distribution over paths: args = (config, observations), shared by
    every execution of a key batch."""

    use_parallel_filter: bool = Pytree.static(default=False)

    def _filter(self, config, observations):
        if self.use_parallel_filter:
            return forward_filter_parallel(config, observations)
        return forward_filter(config, observations)

    def random_weighted(self, key, config, observations):
        config, observations = _shared_params(config, observations)
        alphas, logm = self._filter(config, observations)
        if self.use_parallel_filter:
            z = backward_sample_parallel(key, config, alphas)
        else:
            z = backward_sample(key, config, alphas)
        score = joint_logpdf(config, z, observations) - logm
        return score, z

    def estimate_logpdf(self, key, z, config, observations):
        config, observations = _shared_params(config, observations)
        _, logm = self._filter(config, observations)
        return joint_logpdf(config, z, observations) - logm


#: Singleton (sequential filter).
discrete_hmm = DiscreteHMM()
