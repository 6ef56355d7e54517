"""Plain reference of ``hmm-circulant-64``: a discrete HMM whose
transition and emission probabilities fall off as ``exp(-d² / (2 v))``
with the wrap-around distance ``d`` between states (and observations),
a uniform prior (``DiscreteHMMConfiguration.circulant`` of the JAX
benchmark's config 3).

- :func:`inputs`: one observation sequence drawn from the model, made
  by the benchmark and handed to the port and to the reference alike;
- the bootstrap filter's model (``reference/filters.py``): the initial
  state by the Gumbel-max trick on the prior, each next state by the
  inverse CDF of its transition row against one uniform a particle, each
  weight the emission's log-probability of the observation.

Everything is computed in float64, or in the dtype asked for.
"""

from __future__ import annotations

import torch

from portbench.reference import threefry


def circulant_logits(n_row: int, n_col: int, variance: float, dtype,
                     device) -> torch.Tensor:
    i = torch.arange(n_row, device=device)[:, None]
    j = torch.arange(n_col, device=device)[None, :]
    d = torch.minimum((i - j).abs(), n_row - (i - j).abs()).to(dtype)
    return torch.log_softmax(-d * d / (2.0 * variance), dim=-1)


class Tables:
    def __init__(self, cfg: dict, dtype, device):
        s = cfg["num_states"]
        self.prior = torch.log_softmax(
            torch.zeros(s, dtype=dtype, device=device), -1)
        self.trans = circulant_logits(s, s, cfg["transition_variance"],
                                      dtype, device)
        self.emit = circulant_logits(s, cfg["num_obs"],
                                     cfg["observation_variance"], dtype,
                                     device)


def circulant_probs(n_row: int, n_col: int, variance: float, device):
    """Row-normalised ``exp(-d² / (2 variance))`` with ``d`` the
    wrap-around distance of row and column (distance scale 1), in
    float64."""
    i = torch.arange(n_row, device=device)[:, None]
    j = torch.arange(n_col, device=device)[None, :]
    d = torch.minimum((i - j).abs(), n_row - (i - j).abs()).double()
    w = torch.exp(-d * d / (2.0 * variance))
    return w / w.sum(-1, keepdim=True)


def observations(cfg: dict, n_seq: int, n_steps: int, seed: int,
                 device) -> torch.Tensor:
    """``n_seq`` observation sequences of the configuration's circulant
    HMM, each drawn along its own latent path by inverse CDFs against
    uniforms of the frozen key layer under ``key(seed)``: int64
    ``(n_seq, n_steps)``."""
    s = cfg["num_states"]
    trans = torch.cumsum(circulant_probs(s, s, cfg["transition_variance"],
                                         device), -1)
    emit = torch.cumsum(circulant_probs(s, cfg["num_obs"],
                                        cfg["observation_variance"],
                                        device), -1)
    u = threefry.uniform(threefry.seed_key(seed, device), (n_seq, n_steps, 2))
    z = torch.clamp_max((u[:, 0, 0] * s).long(), s - 1)
    xs = []
    for t in range(n_steps):
        if t:
            z = _inverse_cdf(trans[z], u[:, t, 0])
        xs.append(_inverse_cdf(emit[z], u[:, t, 1]))
    return torch.stack(xs, dim=1)


def _inverse_cdf(cdf: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """The first index whose row of ``cdf`` exceeds ``u``, clipped."""
    return torch.clamp_max((cdf <= u[:, None]).sum(-1), cdf.shape[-1] - 1)


def inputs(cfg: dict, mix: dict, device) -> dict:
    """One observation sequence of ``cfg["steps"]`` drawn with the
    traffic's ``data_seed``, the same in every run, so that every run
    does the same work."""
    return {"observations": observations(cfg, 1, cfg["steps"],
                                         mix["data_seed"], device)[0]}


class FilterModel:
    """The bootstrap filter's model on one observation sequence: the
    first observation weights the initial draw, so ``T`` observations
    take ``T − 1`` propagation steps."""

    discrete = True

    def __init__(self, cfg: dict, obs: torch.Tensor, device):
        self.cfg, self.obs, self.device = cfg, obs.to(device), device
        self.steps = obs.shape[0] - 1
        self._tables = {}

    def tables(self, dtype) -> Tables:
        if dtype not in self._tables:
            self._tables[dtype] = Tables(self.cfg, dtype, self.device)
        return self._tables[dtype]

    def init(self, key, n: int, dtype):
        tb = self.tables(dtype)
        s = tb.prior.shape[0]
        g = threefry.gumbel(key, (n, s)).to(dtype)
        z = torch.argmax(g + tb.prior, -1)
        return z, tb.emit[z, self.obs[0]]

    def step(self, key, t: int, zs, dtype):
        tb = self.tables(dtype)
        s = tb.prior.shape[0]
        cdf = torch.cumsum(torch.softmax(tb.trans, -1), -1)
        u = threefry.uniform(key, (zs.shape[0], 1)).to(dtype)
        z = torch.clamp_max(torch.sum(cdf[zs] < u, -1), s - 1)
        return z, tb.emit[z, self.obs[t + 1]]


def filter_model(cfg: dict, inputs: dict, noise: str, device):
    """The model (one noise stream: uniforms of each step's key)."""
    return FilterModel(cfg, inputs["observations"], device)
