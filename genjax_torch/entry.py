"""The port's main path, through the entry points a user would call:

- :func:`entry`: the ``@gen`` beta-bernoulli model -> ``Target`` ->
  ``ImportanceK`` SIR, returning the posterior mean and log Ẑ
  (counterpart of ``__graft_entry__.entry``);
- :func:`build_pf` / :func:`build_pf_fused`: the bootstrap particle
  filter of bench config 4, the nonlinear 1-D tracking model, through the
  general batched driver and the fused-kernel driver (counterpart of
  ``bench.build_pf`` / ``bench.build_pf_fused``);
- :func:`build_linear_fused`: the linear-Gaussian model of the fused
  filter's tests (:func:`linear_model`, any constants), whose exact
  log Z is the Kalman recurrence :func:`kalman_loglik`;
- :func:`build_sv`: the stochastic-volatility model of Kim, Shephard and
  Chib (1998) (:func:`sv_model`) through the fused-kernel driver or the
  general one;
- :func:`build_hmm_smc`: bench config 3, the discrete-HMM bootstrap
  filter scored against the exact forward filter (counterpart of
  ``benchmarks/run_all.py::config3_hmm_smc``);
- :func:`build_hmm_parallel`: the exact posterior of a discrete HMM
  through the parallel-prefix filter and the parallel backward sampler
  (``DiscreteHMM(use_parallel_filter=True)``);
- :func:`build_tempered_smc`: bench config 6, tempered SMC with MH
  rejuvenation through ``Regenerate`` edits on a conjugate Gaussian
  model, with the closed-form log Z (counterpart of
  ``benchmarks/run_all.py::config6_tempered``);
- :func:`build_hmm_model`: the ``Scan``-combinator HMM ``hmm_model`` on
  config 3's circulant configuration, its observations constrained;
- :func:`build_nuts_regression`: bench config 2, NUTS with cross-chain
  adaptation on a conjugate linear regression, whose posterior is the
  closed form :func:`regression_exact_posterior` (counterpart of
  ``benchmarks/run_all.py::config2_nuts``);
- :func:`build_nuts_logreg`: bench config 8, NUTS on a Bayesian logistic
  regression over an 8192 x 512 design matrix (counterpart of
  ``benchmarks/run_all.py::config8_mxu_logreg``);
- :func:`build_slds_rbpf`: the Rao-Blackwellized particle filter of a
  switching linear dynamical system (``models/slds.py``), with the exact
  oracles ``slds_exact_log_marginal`` and, at one regime, the Kalman
  filter;
- :func:`build_switch_mixture`: a three-component ``mix`` of branches
  with different addresses, observed once, through ``ImportanceK`` SIR
  and through MH by ``Regenerate`` of the mixture; its posterior is the
  closed form :func:`switch_mixture_exact`;
- :func:`build_smc2`: bench config 7, SMC² on the LGSSM with an unknown
  transition coefficient, against the exact grid posterior
  :func:`smc2_oracle` (counterpart of
  ``benchmarks/run_all.py::config7_smc2``);
- :func:`build_trace_pf`: the trace-level particle filter on the same
  LGSSM as a ``Scan`` model, against the Kalman log-likelihood;
- :func:`build_data_smc`: data-annealed SMC on the beta-bernoulli coins
  model, one flip a step, against its closed-form evidence;
- :func:`build_adev_vi`, :func:`build_bnn_vi`, :func:`build_svgd`: bench
  configs 5, 9 and 10 (ADEV VI with an enumerated guide, ADEV VI of a
  tanh network, SVGD on a Bayesian linear regression), against the
  closed-form trajectory, a hand-written gradient and
  :func:`blr_exact`; :func:`build_pt` and :func:`build_map_laplace`:
  parallel tempering on config 6's model and MAP / Laplace on config
  10's regression;
- :func:`build_gamma_poisson_sir`: ``ImportanceK`` SIR on the conjugate
  gamma-Poisson model with its systematic resample (the CDF kernel on
  the card), against the closed-form posterior mean and evidence;
- :func:`build_scale_nuts`: config 2's regression with its noise scale
  free under ``half_normal(1)``, by NUTS with ``transforms="auto"``,
  against the grid posterior :func:`scale_nuts_exact`;
- :func:`build_hmm_batch`: a batch of exact-HMM problems from
  ``sample_problem`` on a key batch, each with its own observations (and,
  optionally, its own transition variance), through ``DiscreteHMM``'s
  parallel-prefix filter, one log-matmul launch per scan level over every
  problem's pairs;
- :func:`build_chain_mh_sweep`: single-site MH sweeps (``Regenerate`` of
  each site in turn) over a normal chain, the fine-grained ``@gen`` edit
  path against the coarse one (``lang/static.py::FINE_GRAINED_EDITS``);
- :func:`build_sharded_pf`, :func:`build_sharded_sir`,
  :func:`build_time_sharded_hmm`, :func:`build_sharded_svgd` and
  ``build_nuts_regression(mesh=...)``: config 4's filter (and the
  linear-Gaussian model), config 1's SIR, the time-sharded HMM filter
  and sampler, config 10's SVGD and config 2's NUTS with each rank of
  the initialized process group running its slice
  (``genjax_torch.parallel``). They take the mesh over the whole world
  unless given one, and raise without a process group.

Every entry point runs on the CUDA card unless the caller passes
``device="cpu"`` (or another device); without a card it raises rather
than run on the CPU. :func:`build_pf_fused` and :func:`build_linear_fused`
hand the kernel a hand-written CUDA form of their model
(:data:`TRACKING_CUDA`, :func:`linear_cuda`): its header under
``genjax_torch/csrc/models/`` and the constants below, which the torch
form reads too. :func:`build_sv` and ``build_linear_fused(...,
header=False)`` hand it none: the fused filter generates the CUDA form
from the torch callables (``genjax_torch/ops/fused_model.py``), as do
:func:`build_dynamic_logit` and :func:`build_quantised`, whose
likelihoods need bool values, rounding and ``logaddexp`` there.
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch

import genjax_torch as g
from genjax_torch.core import random
from genjax_torch.inference import (
    ImportanceK,
    Target,
    marginal,
    mh,
    run_nuts,
    vi,
)
from genjax_torch.inference.map_laplace import (
    laplace_approximation,
    map_optimize,
)
from genjax_torch.inference.pt import parallel_tempering
from genjax_torch.inference.svgd import run_svgd
from genjax_torch.inference.smc import batched_importance
from genjax_torch.inference.exact_testbed import sample_problem
from genjax_torch.inference.pf import fused_particle_filter, particle_filter
from genjax_torch.inference.data_smc import data_annealed_smc
from genjax_torch.inference.smc2 import smc2
from genjax_torch.inference.smc_sampler import tempered_smc
from genjax_torch.inference.trace_pf import trace_particle_filter
from genjax_torch.lang.distributions.discrete_hmm import (
    DiscreteHMM,
    DiscreteHMMConfiguration,
)
from genjax_torch.models.hmm import hmm_bootstrap_filter, hmm_model
from genjax_torch.models.ssm import (
    kalman_filter,
    lgssm_grid_posterior,
    lgssm_model,
    simulate_lgssm_data,
)
from genjax_torch.models.slds import (
    SLDSParams,
    simulate_slds_data,
    slds_rbpf,
)
from genjax_torch.ops.fused_step import CudaModel

__all__ = [
    "quickstart_model",
    "entry",
    "tracking_propagate",
    "tracking_loglik",
    "tracking_observations",
    "TRACKING_CUDA",
    "build_pf",
    "build_pf_fused",
    "linear_propagate",
    "linear_loglik",
    "linear_observations",
    "LINEAR_CUDA",
    "kalman_loglik",
    "build_linear_fused",
    "linear_model",
    "linear_cuda",
    "SV_PHI",
    "SV_SIGMA",
    "SV_MU",
    "sv_model",
    "sv_observations",
    "build_sv",
    "build_dynamic_logit",
    "build_quantised",
    "build_hmm_smc",
    "build_hmm_parallel",
    "tempered_model",
    "tempered_observations",
    "tempered_exact_log_z",
    "build_tempered_smc",
    "build_hmm_model",
    "build_hmm_batch",
    "chain_model",
    "build_chain_mh_sweep",
    "regression_model",
    "regression_data",
    "regression_exact_posterior",
    "build_nuts_regression",
    "logreg_model",
    "logreg_data",
    "build_nuts_logreg",
    "slds_params",
    "build_slds_rbpf",
    "switch_mixture_model",
    "switch_mixture_exact",
    "build_switch_mixture",
    "lgssm_observations",
    "smc2_model",
    "smc2_oracle",
    "build_smc2",
    "build_trace_pf",
    "coins_model",
    "coins_observations",
    "coins_exact_log_z",
    "build_data_smc",
    "adev_vi_problem",
    "adev_vi_exact",
    "build_adev_vi",
    "bnn_data",
    "bnn_vi_problem",
    "bnn_params0",
    "bnn_noise",
    "bnn_neg_elbo",
    "bnn_neg_elbo_estimate",
    "full_f32_matmul",
    "build_bnn_vi",
    "blr_model",
    "blr_data",
    "blr_exact",
    "build_svgd",
    "tempered_exact_posterior",
    "build_pt",
    "build_map_laplace",
    "gamma_poisson_model",
    "build_gamma_poisson_sir",
    "scale_regression_model",
    "scale_regression_data",
    "scale_nuts_exact",
    "build_scale_nuts",
    "build_sharded_pf",
    "build_sharded_sir",
    "hmm_observations",
    "build_time_sharded_hmm",
    "build_sharded_svgd",
]


def _device(device=None) -> torch.device:
    """The device an entry point (or a documented program) runs on: the
    card unless the caller names another. Asking for a card where there
    is none raises; nothing falls back to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "genjax_torch entry points and programs run on the CUDA card by "
            "default and none is available; pass device='cpu' to run on the "
            "CPU")
    return dev


def quickstart_model():
    @g.gen
    def beta_bernoulli(a, b):
        p = g.beta(a, b) @ "p"
        v = g.flip(p) @ "v"
        return v

    return beta_bernoulli


def entry(k_particles: int = 64, device=None):
    """K-particle SIR on the quickstart model with ``v = True``: returns
    ``(sir_step, (key,))``; ``sir_step(key) -> (posterior mean of p,
    log Ẑ)``. Exact answers: 0.6 (Beta(3, 2)) and log 0.5."""
    device = _device(device)
    beta_bernoulli = quickstart_model()

    def sir_step(key):
        target = Target(beta_bernoulli, (2.0, 2.0), g.C["v"].set(True))
        collection = ImportanceK(target, k_particles=k_particles).run_smc(key)
        weights = torch.softmax(collection.get_log_weights(), dim=0)
        ps = collection.get_particles().get_choices()["p"]
        post_mean = torch.sum(weights * ps)
        return post_mean, collection.get_log_marginal_likelihood_estimate()

    return sir_step, (random.key(0, device=device),)


#: The models' constants, shared with their CUDA forms
#: (``csrc/models/*.cuh``): the tracking model's process-noise sd and the
#: log-normalizer of its unit-variance likelihood.
TRACKING_SD = math.sqrt(10.0)
HALF_LOG_2PI = 0.5 * math.log(2 * math.pi)
#: The tracking model for the fused-step kernel (``csrc/models/tracking.cuh``).
TRACKING_CUDA = CudaModel("tracking", (TRACKING_SD, HALF_LOG_2PI))


def tracking_propagate(x, e):
    """Config-4 dynamics: ``0.5 x + 25 x / (1 + x^2) + sqrt(10) eps``."""
    return 0.5 * x + 25.0 * x / (1.0 + x * x) + TRACKING_SD * e


def tracking_loglik(x, y):
    """``log N(y; x^2 / 20, 1)``."""
    return -0.5 * (y - x * x / 20.0) ** 2 - HALF_LOG_2PI


def tracking_observations(n_steps: int, device=None) -> torch.Tensor:
    """The config-4 observations: ``5 · normal(key(9), (T,))``."""
    return random.normal(random.key(9, device=_device(device)),
                         (n_steps,)) * 5.0


def build_pf(n_particles: int, n_steps: int, state_dtype=torch.float32,
             device=None):
    """Config 4 through the general batched filter: one key per step,
    whole-ensemble ops. Returns ``(run, work)``: ``run(key) -> log Z``,
    ``work`` the particle-steps of one run."""
    device = _device(device)

    def init(key):
        return (random.normal(key, (n_particles,)).to(state_dtype),
                torch.zeros(n_particles, device=key.device))

    def step(key, xs, y):
        xf = xs.to(torch.float32)
        xs_new = tracking_propagate(xf, random.normal(key, (n_particles,)))
        mu = xs_new * xs_new / 20.0
        lw = (math.log(2 * math.pi) + (y - mu) ** 2) / -2.0
        return xs_new.to(state_dtype), lw

    pf = particle_filter(init, step, n_particles, batched=True)
    ys = tracking_observations(n_steps, device)

    def run(key):
        final, _ = pf(key, ys)
        return final.log_z

    return run, n_particles * n_steps


def build_pf_fused(n_particles: int, n_steps: int,
                   state_dtype=torch.float32, device=None):
    """Config 4 through the fused-kernel filter. Returns ``(run, work)``
    as :func:`build_pf`."""
    device = _device(device)
    pf = fused_particle_filter(
        lambda k: random.normal(k, (n_particles,)),
        tracking_propagate, tracking_loglik, n_particles,
        state_dtype=state_dtype, cuda_model=TRACKING_CUDA,
    )
    ys = tracking_observations(n_steps, device)

    def run(key):
        final, _ = pf(key, ys)
        return final.log_z

    return run, n_particles * n_steps


LINEAR_A, LINEAR_Q, LINEAR_R = 0.9, 1.0, 0.3
LINEAR_HALF_LOG_2PI_R = 0.5 * math.log(2 * math.pi * LINEAR_R)


def linear_model(a: float, q: float, r: float):
    """The linear-Gaussian model's torch form with the constants ``a``,
    ``q``, ``r`` (the JAX package's test lambdas,
    ``tests/ops/test_fused_step.py:111-140``): ``(propagate, loglik)``."""
    sd, half_log = math.sqrt(q), 0.5 * math.log(2 * math.pi * r)

    def propagate(x, e):
        return a * x + sd * e

    def loglik(x, y):
        return -0.5 * (y - x) ** 2 / r - half_log

    return propagate, loglik


def linear_cuda(a: float, q: float, r: float) -> CudaModel:
    """The same model's hand-written CUDA form (``csrc/models/linear.cuh``)
    with the constants ``a``, ``q``, ``r``."""
    return CudaModel("linear", (a, math.sqrt(q), r,
                                0.5 * math.log(2 * math.pi * r)))


linear_propagate, linear_loglik = linear_model(LINEAR_A, LINEAR_Q, LINEAR_R)
#: The linear-Gaussian model for the fused-step kernel
#: (``csrc/models/linear.cuh``).
LINEAR_CUDA = linear_cuda(LINEAR_A, LINEAR_Q, LINEAR_R)


def linear_observations(n_steps: int = 15, seed: int = 0, a=LINEAR_A,
                        q=LINEAR_Q, r=LINEAR_R) -> np.ndarray:
    """Observations simulated from the linear-Gaussian model with numpy,
    from ``x_1 ~ N(0, q)`` (one step from a start at zero)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(0, np.sqrt(q))
    ys = []
    for _ in range(n_steps):
        ys.append(x + rng.normal(0, np.sqrt(r)))
        x = a * x + rng.normal(0, np.sqrt(q))
    return np.asarray(ys, np.float32)


def kalman_loglik(ys, a=LINEAR_A, q=LINEAR_Q, r=LINEAR_R, mu0=0.0, p0=1.0):
    """Exact log-likelihood of the linear-Gaussian model (Kalman filter)."""
    ll, mu, p = 0.0, mu0, p0
    for y in np.asarray(ys, np.float64):
        s = p + r
        ll += -0.5 * (np.log(2 * np.pi * s) + (y - mu) ** 2 / s)
        k_gain = p / s
        mu = mu + k_gain * (y - mu)
        p = (1 - k_gain) * p
        mu, p = a * mu, a * a * p + q
    return float(ll)


def build_linear_fused(n_particles: int, ys, a: float = LINEAR_A,
                       q: float = LINEAR_Q, r: float = LINEAR_R, device=None,
                       header: bool = True):
    """:func:`linear_model` with ``a, q, r`` through the fused filter,
    started at zero, so that ``x_1 ~ N(0, q)``: its exact log Z is
    ``kalman_loglik(ys, a, q, r, p0=q)``. On the card the kernel takes
    ``linear.cuh`` (``header``), or else the CUDA form generated from the
    lambdas. Returns ``run(key) -> log Z``."""
    device = _device(device)
    propagate, loglik = linear_model(a, q, r)
    pf = fused_particle_filter(
        lambda k: torch.zeros(n_particles, device=k.device),
        propagate, loglik, n_particles,
        cuda_model=linear_cuda(a, q, r) if header else None,
    )
    obs = torch.as_tensor(np.asarray(ys, np.float32), device=device)

    def run(key):
        final, _ = pf(key, obs)
        return final.log_z

    return run


#: The stochastic-volatility model of Kim, Shephard and Chib (1998),
#: "Stochastic volatility: likelihood inference and comparison with ARCH
#: models", with parameters near their fit: log-volatility
#: ``x' = mu + phi (x - mu) + sigma eps``, returns ``y ~ N(0, e^x)``.
SV_PHI, SV_SIGMA, SV_MU = 0.98, 0.15, -0.9
LOG_2PI = math.log(2 * math.pi)


def sv_model(phi: float = SV_PHI, sigma: float = SV_SIGMA,
             mu: float = SV_MU):
    """The stochastic-volatility model's torch form: ``(propagate,
    loglik)``, ``loglik = -(log 2 pi + x + y^2 e^-x) / 2``. It has no
    hand-written CUDA header."""

    def propagate(x, e):
        return mu + phi * (x - mu) + sigma * e

    def loglik(x, y):
        return -0.5 * (LOG_2PI + x + y * y * torch.exp(-x))

    return propagate, loglik


def _sv_stationary_sd(phi: float, sigma: float) -> float:
    return sigma / math.sqrt(1.0 - phi * phi)


def sv_observations(n_steps: int = 32, seed: int = 0, phi=SV_PHI,
                    sigma=SV_SIGMA, mu=SV_MU) -> np.ndarray:
    """Returns simulated from the model with numpy, its log-volatility
    started from the stationary law."""
    rng = np.random.default_rng(seed)
    x = mu + _sv_stationary_sd(phi, sigma) * rng.normal()
    ys = []
    for _ in range(n_steps):
        x = mu + phi * (x - mu) + sigma * rng.normal()
        ys.append(np.exp(0.5 * x) * rng.normal())
    return np.asarray(ys, np.float32)


def build_sv(n_particles: int, n_steps: int, fused: bool = True,
             device=None, seed: int = 0):
    """The stochastic-volatility model on :func:`sv_observations`, the
    ensemble started from the stationary law, through the fused filter
    (on the card, the CUDA form generated from :func:`sv_model`) or the
    general batched driver (``fused=False``). Returns ``(run, work)`` as
    :func:`build_pf`."""
    return _build_scalar_filter(
        sv_model(), SV_MU, _sv_stationary_sd(SV_PHI, SV_SIGMA),
        sv_observations(n_steps, seed), n_particles, fused, device)


def _build_scalar_filter(model, loc: float, sd: float, ys, n_particles: int,
                         fused: bool, device):
    """A scalar-state model ``(propagate, loglik)`` on the returns ``ys``,
    the ensemble started from N(loc, sd²), through the fused filter (on
    the card, the CUDA form generated from the torch form) or the general
    batched driver: ``(run, work)`` as :func:`build_pf`."""
    device = _device(device)
    propagate, loglik = model

    def init_xs(key):
        return loc + sd * random.normal(key, (n_particles,))

    if fused:
        pf = fused_particle_filter(init_xs, propagate, loglik, n_particles)
    else:
        def step(key, xs, y):
            xs_new = propagate(xs, random.normal(key, (n_particles,)))
            return xs_new, loglik(xs_new, y)

        pf = particle_filter(
            lambda k: (init_xs(k), torch.zeros(n_particles, device=k.device)),
            step, n_particles, batched=True)
    ys = torch.as_tensor(ys, device=device)

    def run(key):
        final, _ = pf(key, ys)
        return final.log_z

    return run, n_particles * len(ys)


#: A latent AR(1) ``x' = AR_PHI x + AR_SIGMA eps``, started from its
#: stationary law, under two likelihoods whose generated CUDA forms need
#: more than f32 arithmetic: binary observations of a dynamic logit model
#: (bool values and ``zeros_like``, :func:`dynamic_logit_model`) and a
#: sensor that reads the state on a grid of ``QUANT_STEP`` with logistic
#: noise of scale ``QUANT_SCALE`` (``round`` and ``logaddexp``,
#: :func:`quantised_model`).
AR_PHI, AR_SIGMA = 0.95, 0.3
QUANT_STEP, QUANT_SCALE = 0.5, 0.3


def _ar_propagate(x, e):
    return AR_PHI * x + AR_SIGMA * e


def _ar_path(n_steps: int, rng) -> np.ndarray:
    x = _sv_stationary_sd(AR_PHI, AR_SIGMA) * rng.normal()
    xs = []
    for _ in range(n_steps):
        x = AR_PHI * x + AR_SIGMA * rng.normal()
        xs.append(x)
    return np.asarray(xs)


def dynamic_logit_model():
    """The dynamic logit model's torch form: ``(propagate, loglik)``, the
    observation a 0 / 1 float read as ``y > 0.5``, ``loglik =
    bernoulli.logpdf(y > 0.5, x)`` (``x`` the logit)."""

    def loglik(x, y):
        return g.bernoulli.logpdf(y > 0.5, x)

    return _ar_propagate, loglik


def dynamic_logit_observations(n_steps: int = 32) -> np.ndarray:
    """0 / 1 observations simulated from :func:`dynamic_logit_model` with
    numpy."""
    rng = np.random.default_rng(0)
    x = _ar_path(n_steps, rng)
    return (rng.uniform(size=n_steps) < 1 / (1 + np.exp(-x))).astype(
        np.float32)


def quantised_model():
    """The quantised-sensor model's torch form: ``(propagate, loglik)``,
    ``loglik = logistic.logpdf(y, QUANT_STEP round(x / QUANT_STEP),
    QUANT_SCALE)``."""

    def loglik(x, y):
        return g.logistic.logpdf(y, QUANT_STEP * torch.round(x / QUANT_STEP),
                                 QUANT_SCALE)

    return _ar_propagate, loglik


def quantised_observations(n_steps: int = 32, seed: int = 0) -> np.ndarray:
    """Readings simulated from :func:`quantised_model` with numpy (whose
    ``round`` is half to even, as torch's)."""
    rng = np.random.default_rng(seed)
    x = _ar_path(n_steps, rng)
    grid = QUANT_STEP * np.round(x / QUANT_STEP)
    return (grid + rng.logistic(0.0, QUANT_SCALE, n_steps)).astype(
        np.float32)


def build_dynamic_logit(n_particles: int, n_steps: int, fused: bool = True,
                        device=None):
    """:func:`dynamic_logit_model` on :func:`dynamic_logit_observations`
    through the fused filter or the general driver, as :func:`build_sv`."""
    return _build_scalar_filter(
        dynamic_logit_model(), 0.0, _sv_stationary_sd(AR_PHI, AR_SIGMA),
        dynamic_logit_observations(n_steps), n_particles, fused, device)


def build_quantised(n_particles: int, n_steps: int, fused: bool = True,
                    device=None):
    """:func:`quantised_model` on :func:`quantised_observations` through
    the fused filter or the general driver, as :func:`build_sv`."""
    return _build_scalar_filter(
        quantised_model(), 0.0, _sv_stationary_sd(AR_PHI, AR_SIGMA),
        quantised_observations(n_steps), n_particles, fused, device)


#: The AR(1) state read by a heavy-tailed sensor: Lambert W x Gaussian
#: noise (Goerg 2011) of scale ``LW_SCALE`` and tail weight ``LW_TAIL``,
#: whose density inverts the reading through the Lambert W function
#: (:func:`lambert_w_model`).
LW_SCALE, LW_TAIL = 0.5, 0.2


def lambert_w_model():
    """The heavy-tailed sensor's torch form: ``(propagate, loglik)``,
    ``loglik = lambert_w_normal.logpdf(y, x, LW_SCALE, LW_TAIL)``."""

    def loglik(x, y):
        return g.lambert_w_normal.logpdf(y, x, LW_SCALE, LW_TAIL)

    return _ar_propagate, loglik


def lambert_w_observations(n_steps: int = 32) -> np.ndarray:
    """Readings simulated from :func:`lambert_w_model` with numpy, as
    ``lambert_w_normal``'s sampler transforms a standard normal."""
    rng = np.random.default_rng(2)
    x = _ar_path(n_steps, rng)
    u = rng.normal(size=n_steps)
    return (x + LW_SCALE * u * np.exp(LW_TAIL * u * u / 2.0)).astype(
        np.float32)


def build_lambert_w(n_particles: int, n_steps: int, fused: bool = True,
                    device=None):
    """:func:`lambert_w_model` on :func:`lambert_w_observations` through
    the fused filter or the general driver, as :func:`build_sv`."""
    return _build_scalar_filter(
        lambert_w_model(), 0.0, _sv_stationary_sd(AR_PHI, AR_SIGMA),
        lambert_w_observations(n_steps), n_particles, fused, device)


def _hmm_problem(n_states: int, n_steps: int, device: torch.device):
    """Bench config 3's problem: ``circulant(S, S)`` and a path drawn by
    ``sample_problem(key(3), ...)``, with its exact log marginal."""
    config = DiscreteHMMConfiguration.circulant(n_states, n_states,
                                                device=device)
    return sample_problem(random.key(3, device=device), config, n_steps)


def build_hmm_smc(n_states: int = 64, n_steps: int = 64,
                  n_particles: int = 2**19, device=None):
    """Bench config 3: the discrete-HMM bootstrap filter (inverse-CDF
    transitions, systematic resampling) on ``circulant(S, S)`` with
    observations from ``sample_problem(key(3), ...)``. Returns ``(run,
    work, exact_log_z)``: ``run(key) -> log Z``, ``work`` the
    particle-steps of one run (``n_particles * n_steps``, as the JAX
    benchmark counts them) and the exact log marginal of the forward
    filter."""
    problem = _hmm_problem(n_states, n_steps, _device(device))
    pf = hmm_bootstrap_filter(problem.config, n_particles)
    obs = problem.observations

    def run(key):
        final, _ = pf(key, obs)
        return final.log_z

    return run, n_particles * n_steps, float(problem.log_data_marginal)


def build_hmm_parallel(n_states: int, n_steps: int, device=None):
    """The exact posterior of a discrete HMM on ``circulant(S, S)`` with
    observations from ``sample_problem(key(3), ...)``, through the
    parallel-prefix filter (the log-matmul kernel) and the parallel
    backward sampler. Returns ``(run, problem)``: ``run(key) -> (z, score,
    log_marginal)``, a sampled path, its score ``log P(z | x)`` and the
    sequential filter's log marginal; ``problem`` holds the configuration
    and the observations."""
    problem = _hmm_problem(n_states, n_steps, _device(device))
    hmm = DiscreteHMM(use_parallel_filter=True)

    def run(key):
        score, z = hmm.random_weighted(key, problem.config,
                                       problem.observations)
        return z, score, problem.log_data_marginal

    return run, problem


#: Config 6's observation noise sd and prior sd of the mean.
TEMPERED_SIGMA, TEMPERED_PRIOR_SD = 0.8, 3.0


def tempered_model(n_obs: int):
    """Config 6's model: ``mu ~ normal(0, 3)``, ``ys ~ mv_normal_diag(mu,
    sigma)`` over ``n_obs`` points. Under a key batch ``mu`` and a lifted
    ``sigma`` have the batch's shape, so each gains the event axis
    behind it."""

    @g.gen
    def model(sigma):
        mu = g.normal(0.0, TEMPERED_PRIOR_SD) @ "mu"
        ones = torch.ones(n_obs, device=mu.device)
        sigma = torch.as_tensor(sigma, device=mu.device)
        _ = g.mv_normal_diag(mu[..., None] * ones,
                             sigma[..., None] * ones) @ "ys"

    return model


def tempered_observations(n_obs: int = 64, device=None) -> torch.Tensor:
    """Config 6's data: ``1.5 + 0.7 · normal(key(0), (n_obs,))``."""
    return 1.5 + 0.7 * random.normal(random.key(0, device=_device(device)),
                                     (n_obs,))


def tempered_exact_log_z(ys, sigma: float = TEMPERED_SIGMA) -> float:
    """The conjugate closed form of config 6's log Z: ``ys | mu ~ N(mu,
    sigma² I)``, ``mu ~ N(0, 9)``."""
    y = np.asarray(torch.as_tensor(ys).cpu(), np.float64)
    s2, t2, n = sigma ** 2, TEMPERED_PRIOR_SD ** 2, float(y.size)
    post_var = 1.0 / (1.0 / t2 + n / s2)
    return float(-0.5 * n * np.log(2 * np.pi * s2) - 0.5 * (y ** 2).sum() / s2
                 + 0.5 * post_var * (y.sum() / s2) ** 2
                 + 0.5 * np.log(post_var / t2))


def build_tempered_smc(n_particles: int = 2 ** 19, n_temps: int = 16,
                       n_moves: int = 2, n_obs: int = 64, device=None):
    """Bench config 6: tempered SMC (adaptive systematic resampling, MH
    rejuvenation by ``Regenerate`` of ``mu``) on :func:`tempered_model`
    with ``sigma = 0.8`` and :func:`tempered_observations`. Returns
    ``(run, exact_log_z)``: ``run(key) -> TemperedSMCResult`` and the
    closed-form log Z."""
    ys = tempered_observations(n_obs, device)
    target = Target(tempered_model(n_obs), (TEMPERED_SIGMA,),
                    g.C["ys"].set(ys))
    run = tempered_smc(target, n_particles, n_temps=n_temps, n_moves=n_moves)
    return run, tempered_exact_log_z(ys)


def build_hmm_model(n_states: int = 64, n_steps: int = 64,
                    n_particles: int = 2 ** 19, device=None):
    """``hmm_model`` on config 3's problem (``circulant(S, S)``, a path
    from ``sample_problem(key(3), ...)``) with its observations
    constrained at ``"x0"`` and ``("chain", t, "x")``. Returns
    ``(generate, model, constraint, problem)``: ``generate(key) ->
    (trace, weight)`` importance-samples ``n_particles`` paths on
    ``split(key, n_particles)``."""
    problem = _hmm_problem(n_states, n_steps, _device(device))
    model = hmm_model(problem.config, n_steps)
    obs = problem.observations
    constraint = (g.C["x0"].set(obs[0])
                  | g.C["chain", :, "x"].set(obs[1:]))

    def generate(key):
        return model.generate(random.split(key, n_particles), constraint, ())

    return generate, model, constraint, problem


def build_hmm_batch(n_problems: int = 2048, n_states: int = 128,
                    n_steps: int = 64, per_execution_config: bool = False,
                    device=None):
    """A batch of exact-HMM problems: ``sample_problem`` on
    ``split(key(3), n_problems)`` with config 3's circulant structure
    (``circulant(S, S)``), each problem with its own observations and,
    with ``per_execution_config``, its own ``transition_variance``
    drawn from ``0.5 + 1.5 · uniform(key(7), (n_problems,))``. Returns
    ``(simulate, config, problems)``: ``simulate(key)`` runs
    ``DiscreteHMM(use_parallel_filter=True).simulate`` on
    ``split(key, n_problems)``, one path per problem; ``config`` leads
    with the batch (a zero-stride view where it is shared) and
    ``problems`` holds the observations and the exact log marginals."""
    dev = _device(device)
    variance = 1.0
    if per_execution_config:
        variance = 0.5 + 1.5 * random.uniform(random.key(7, device=dev),
                                              (n_problems,))
    config = DiscreteHMMConfiguration.circulant(
        n_states, n_states, transition_variance=variance, device=dev)
    batch = (n_problems,)
    if not per_execution_config:
        config = DiscreteHMMConfiguration(
            config.prior_logits.expand(batch + (n_states,)),
            config.transition_logits.expand(batch + (n_states, n_states)),
            config.observation_logits.expand(batch + (n_states, n_states)))
    problems = sample_problem(
        random.split(random.key(3, device=dev), n_problems), config, n_steps)
    hmm = DiscreteHMM(use_parallel_filter=True)

    def simulate(key):
        return hmm.simulate(random.split(key, n_problems),
                            (config, problems.observations))

    return simulate, config, problems


def chain_model(n_sites: int, step_sd: float = 1.0, obs_sd: float = 1.0):
    """A normal chain ``x0 ~ N(0, 1)``, ``x_i ~ N(x_{i-1}, step_sd)``,
    observed through ``y ~ N(x_{n-1}, obs_sd)``. At ``n_sites = 2``,
    ``step_sd = obs_sd = 0.5`` and ``y = 1`` the posterior mean of ``x0``
    is 2/3."""

    @g.gen
    def chain():
        x = g.normal(0.0, 1.0) @ "x0"
        for i in range(1, n_sites):
            x = g.normal(x, step_sd) @ f"x{i}"
        g.normal(x, obs_sd) @ "y"
        return x

    return chain


def build_chain_mh_sweep(n_chains: int = 2 ** 19, n_sites: int = 32,
                         step_sd: float = 1.0, obs_sd: float = 1.0,
                         y: float = 1.0, device=None):
    """Single-site MH over :func:`chain_model` with ``y`` observed: a sweep
    proposes ``Regenerate`` of ``x0``, ..., ``x_{n-1}`` in turn, each
    accepted by its weight (``inference.mh``). Returns ``(init, sweep)``:
    ``init(key)`` importance-samples the chains' start on
    ``split(key, n_chains)``; ``sweep(key, trace) -> (trace, rescored,
    accepted)`` runs one sweep, move ``i`` on ``fold_in(split(key,
    n_chains), i)``, and
    gives the sites each move re-scored (``static.edit_stats``) and the
    chains each move accepted. The edit path is whichever
    ``lang/static.py::FINE_GRAINED_EDITS`` selects."""
    from genjax_torch.lang import static

    dev = _device(device)
    model = chain_model(n_sites, step_sd, obs_sd)
    obs = g.C["y"].set(torch.full((n_chains,), y, device=dev))
    addrs = [f"x{i}" for i in range(n_sites)]

    def init(key):
        tr, _ = model.generate(random.split(key, n_chains), obs, ())
        return tr

    def sweep(key, trace):
        keys = random.split(key, n_chains)
        rescored, accepted = [], []
        for i, addr in enumerate(addrs):
            before = static.edit_stats.sites_rescored
            trace, acc = mh(random.fold_in(keys, i), trace,
                            g.Regenerate(g.Selection.at[addr]))
            rescored.append(static.edit_stats.sites_rescored - before)
            accepted.append(acc)
        return trace, rescored, torch.stack(accepted)

    return init, sweep


#: Config 2's data: ``n`` points on [-1, 1], noise sd, prior sd.
REGRESSION_POINTS, REGRESSION_NOISE, REGRESSION_PRIOR_SD = 128, 0.2, 2.0


def regression_model():
    """Config 2's model: ``slope, icept ~ normal(0, 2)``, ``ys ~
    mv_normal_diag(slope·xs + icept, 0.2)``. Under a chain batch the
    slope and the intercept have the batch's shape and ``xs`` leads with
    it, so each gains the points' axis behind it."""

    @g.gen
    def regression(xs):
        slope = g.normal(0.0, REGRESSION_PRIOR_SD) @ "slope"
        icept = g.normal(0.0, REGRESSION_PRIOR_SD) @ "icept"
        _ = g.mv_normal_diag(slope[..., None] * xs + icept[..., None],
                             REGRESSION_NOISE * torch.ones_like(xs)) @ "ys"

    return regression


def regression_data(device=None):
    """Config 2's data: ``xs = linspace(-1, 1, 128)``, ``ys = 2·xs − 0.5``."""
    xs = torch.linspace(-1.0, 1.0, REGRESSION_POINTS, device=_device(device))
    return xs, 2.0 * xs - 0.5


def regression_exact_posterior(xs=None, ys=None):
    """The closed-form posterior of config 2's conjugate model, float64:
    ``(mean, cov)`` over ``(slope, icept)``, with precision ``I/4 +
    AᵀA/0.04`` and ``A = [xs, 1]``."""
    if xs is None:
        xs, ys = regression_data("cpu")
    x = np.asarray(torch.as_tensor(xs).cpu(), np.float64)
    y = np.asarray(torch.as_tensor(ys).cpu(), np.float64)
    a = np.stack([x, np.ones_like(x)], axis=1)
    noise_var = REGRESSION_NOISE ** 2
    precision = np.eye(2) / REGRESSION_PRIOR_SD ** 2 + a.T @ a / noise_var
    cov = np.linalg.inv(precision)
    return cov @ (a.T @ y / noise_var), cov


def build_nuts_regression(n_chains: int = 2048, num_warmup: int = 200,
                          num_samples: int = 1600, max_depth: int = 6,
                          device=None, mesh=None):
    """Bench config 2: ``run_nuts`` on :func:`regression_model` with
    :func:`regression_data`. Returns ``(run, target)``: ``run(key) ->
    (choices, infos)``, the draws leading with ``(chains, samples)``.
    ``mesh``: run this rank's slice of the chains over the mesh's
    ``"chains"`` axis (the draws are then the slice's)."""
    xs, ys = regression_data(device)
    target = Target(regression_model(), (xs,), g.C["ys"].set(ys))

    def run(key):
        return run_nuts(target, key, n_chains=n_chains,
                        num_warmup=num_warmup, num_samples=num_samples,
                        max_depth=max_depth, mesh=mesh)

    return run, target


def _shared_matvec(x: torch.Tensor, beta: torch.Tensor) -> torch.Tensor:
    """``x @ beta`` per execution, ``x`` of shape ``B + (N, D)`` and
    ``beta`` of ``B + (D,)``. A lifted ``x`` (zero strides on its batch
    axes, the same matrix in every execution) is read once: the product
    is one ``(B, D) x (D, N)`` matrix product, and its gradient another,
    instead of a copy of ``x`` for every execution or ``B``
    matrix-vector products."""
    r = x.ndim - 2
    if r and all(x.stride(i) == 0 for i in range(r)):
        return beta @ x[(0,) * r].mT
    return (x @ beta[..., None])[..., 0]


def logreg_model(d: int):
    """Config 8's model: ``beta ~ mv_normal_diag(0, 1)`` over ``d``
    coefficients, ``y ~ bernoulli(X @ beta)`` (logits)."""

    @g.gen
    def logreg(x):
        beta = g.mv_normal_diag(torch.zeros(d, device=x.device),
                                torch.ones(d, device=x.device)) @ "beta"
        _ = g.bernoulli(_shared_matvec(x, beta)) @ "y"

    return logreg


def logreg_data(n: int = 8192, d: int = 512, device=None):
    """Config 8's data: ``X = normal(key 0, (n, d)) / sqrt(d)``,
    ``beta_true`` 1.5 on the first ``d/8`` coefficients and 0 elsewhere,
    ``y = bernoulli(key 1, sigmoid(X @ beta_true))``. Returns ``(X, y,
    beta_true)``."""
    dev = _device(device)
    x = random.normal(random.key(0, device=dev), (n, d)) / math.sqrt(d)
    beta_true = torch.where(torch.arange(d, device=dev) < d // 8, 1.5, 0.0)
    y = random.bernoulli(random.key(1, device=dev),
                         torch.sigmoid(x @ beta_true), (n,))
    return x, y.to(torch.float32), beta_true


def build_nuts_logreg(n_chains: int = 1024, num_warmup: int = 100,
                      num_samples: int = 100, n: int = 8192, d: int = 512,
                      max_depth: int = 5, device=None):
    """Bench config 8: ``run_nuts`` on :func:`logreg_model` with
    :func:`logreg_data`. Returns ``(run, target, beta_true)``:
    ``run(key) -> (choices, infos)``."""
    x, y, beta_true = logreg_data(n, d, device)
    target = Target(logreg_model(d), (x,), g.C["y"].set(y))

    def run(key):
        return run_nuts(target, key, n_chains=n_chains,
                        num_warmup=num_warmup, num_samples=num_samples,
                        max_depth=max_depth)

    return run, target, beta_true


#: The SLDS data's key (the JAX package's SLDS tests use it too).
SLDS_DATA_SEED = 20260820


def slds_params(n_regimes: int = 2, device=None) -> SLDSParams:
    """The SLDS of the JAX package's tests: two regimes (trans ``[[0.9,
    0.1], [0.2, 0.8]]``, prior ``[0.6, 0.4]``, a ``[0.95, 0.3]``, q ``[0.1,
    0.8]``, r ``[0.3, 0.3]``), or one (a 0.8, q 0.3, r 0.4), where the
    filter is the Kalman filter."""
    def t(v):
        return torch.tensor(v, dtype=torch.float32, device=device)

    if n_regimes == 1:
        return SLDSParams(trans_logits=torch.zeros((1, 1), device=device),
                          prior_logits=torch.zeros(1, device=device),
                          a=t([0.8]), q=t([0.3]), r=t([0.4]))
    if n_regimes != 2:
        raise ValueError("slds_params: 1 or 2 regimes")
    return SLDSParams(trans_logits=torch.log(t([[0.9, 0.1], [0.2, 0.8]])),
                      prior_logits=torch.log(t([0.6, 0.4])),
                      a=t([0.95, 0.3]), q=t([0.1, 0.8]), r=t([0.3, 0.3]))


def build_slds_rbpf(n_particles: int = 2 ** 19, n_steps: int = 64,
                    n_regimes: int = 2, device=None):
    """SLDS-RBPF at ``n_particles`` x ``n_steps`` on :func:`slds_params`,
    its data ``simulate_slds_data(key(20260820), T)`` drawn on the CPU
    (so every device filters the same observations). Returns ``(run,
    params, ys)``: ``run(key) -> RBPFResult``."""
    device = _device(device)
    _, _, ys = simulate_slds_data(random.key(SLDS_DATA_SEED),
                                  slds_params(n_regimes), n_steps)
    params = slds_params(n_regimes, device)
    rbpf = slds_rbpf(params, n_particles)
    ys = ys.to(device)

    def run(key):
        return rbpf(key, ys)

    return run, params, ys


#: The Switch mixture: component weights, the branches' means and sds,
#: the observation's noise sd and its value.
MIXTURE_PROBS = (0.3, 0.4, 0.3)
MIXTURE_MEANS, MIXTURE_SDS = (-2.0, 1.0, 3.0), (0.5, 1.0, 0.5)
MIXTURE_NOISE, MIXTURE_Y = 0.5, 2.0


def switch_mixture_model():
    """``m = mix(b0, b1, b2)(logits, (), (), ()) @ "m"``, ``y ~
    normal(m, 0.5)``, with ``b0 = normal(-2, 0.5) @ "v"``, ``b1 =
    normal(1, 1) @ "v"`` and ``b2 = 3 + 0.5·normal(0, 1) @ "u"`` (another
    address, so an untaken branch's choices are real placeholders)."""

    @g.gen
    def b0():
        return g.normal(MIXTURE_MEANS[0], MIXTURE_SDS[0]) @ "v"

    @g.gen
    def b1():
        return g.normal(MIXTURE_MEANS[1], MIXTURE_SDS[1]) @ "v"

    @g.gen
    def b2():
        return MIXTURE_MEANS[2] + MIXTURE_SDS[2] * (g.normal(0.0, 1.0) @ "u")

    mixture = g.mix(b0, b1, b2)

    @g.gen
    def model(logits):
        m = mixture(logits, (), (), ()) @ "m"
        _ = g.normal(m, MIXTURE_NOISE) @ "y"
        return m

    return model


def switch_mixture_exact() -> dict:
    """The closed-form posterior of :func:`switch_mixture_model` given
    ``y``, float64: ``P(comp = b | y) ∝ π_b N(y; m_b, s_b² + 0.25)``, and
    the posterior mean and variance of ``m`` (conjugate within each
    component)."""
    pi, mu = np.array(MIXTURE_PROBS), np.array(MIXTURE_MEANS)
    var, nv = np.array(MIXTURE_SDS) ** 2, MIXTURE_NOISE ** 2
    y = MIXTURE_Y
    s2 = var + nv
    lik = np.exp(-0.5 * (y - mu) ** 2 / s2) / np.sqrt(2 * np.pi * s2)
    probs = pi * lik / (pi * lik).sum()
    post_var = 1.0 / (1.0 / var + 1.0 / nv)
    post_mean = post_var * (mu / var + y / nv)
    mean = float((probs * post_mean).sum())
    second = float((probs * (post_var + post_mean ** 2)).sum())
    return {"probs": probs, "mean": mean, "var": second - mean ** 2,
            "log_z": float(np.log((pi * lik).sum()))}


def build_switch_mixture(n_particles: int = 2 ** 20, n_chains: int = 2 ** 19,
                         n_mh_steps: int = 64, device=None):
    """The Switch mixture through SIR and MH. Returns ``(run_sir, run_mh,
    target)``:

    - ``run_sir(key) -> dict``: ``ImportanceK`` at ``n_particles``, then
      systematic resampling (the CDF kernel on the card): the resampled
      components and ``m`` values (``"comp"``, ``"m"``), and the weighted
      particles before it (``"weighted_comp"``, ``"weighted_m"``,
      ``"log_weights"``) and the resample's key;
    - ``run_mh(key) -> (comp, m, accept_rate)``: ``n_chains`` chains from
      the prior (``y`` constrained), ``n_mh_steps`` MH steps of
      ``Regenerate(Selection.at["m"])`` (the component and its branch
      redrawn from the prior, an index change the Switch weighs 0), the
      final components and ``m`` values and the acceptance over all
      steps and chains.

    Chain ``c``'s step ``i`` runs on ``fold_in(split(k_run, n_chains)[c],
    i)``."""
    device = _device(device)
    logits = torch.log(torch.tensor(MIXTURE_PROBS, device=device))
    target = Target(switch_mixture_model(), (logits,),
                    g.C["y"].set(torch.tensor(MIXTURE_Y, device=device)))

    def values(tr):
        chm = tr.get_choices()
        return chm["m", "mixture_component"], tr.get_retval()

    def run_sir(key):
        k_run, k_res = random.split(key).unbind(-2)
        col = ImportanceK(target, k_particles=n_particles).run_smc(k_run)
        comp_w, m_w = values(col.get_particles())
        comp, m = values(col.resample(k_res).get_particles())
        return {"comp": comp, "m": m, "weighted_comp": comp_w,
                "weighted_m": m_w, "log_weights": col.get_log_weights(),
                "resample_key": k_res}

    request = g.Regenerate(g.Selection.at["m"])

    def run_mh(key):
        k_init, k_run = random.split(key).unbind(-2)
        trace, _ = batched_importance(target, random.split(k_init, n_chains),
                                      g.ChoiceMap.empty())
        chain_keys = random.split(k_run, n_chains)
        accepted = torch.zeros((), device=device)
        for i in range(n_mh_steps):
            trace, acc = mh(random.fold_in(chain_keys, i), trace, request)
            accepted = accepted + acc.sum()
        comp, m = values(trace)
        return comp, m, accepted / (n_chains * n_mh_steps)

    return run_sir, run_mh, target


#: Config 7 (``benchmarks/run_all.py:439-482``): the 1-D LGSSM
#: ``x_t = a·x_{t-1} + N(0, Q)``, ``y_t = x_t + N(0, R)`` with the true
#: coefficient 0.7, its observations from ``simulate_lgssm_data(key(11),
#: ...)``, a uniform prior on (−0.95, 0.95) for ``a`` and a random-walk
#: proposal of 0.15.
SMC2_A, SMC2_Q, SMC2_R = 0.7, 0.4, 0.4
SMC2_DATA_SEED, SMC2_PROPOSAL, SMC2_BOUND = 11, 0.15, 0.95


def lgssm_observations(n_steps: int = 50, device=None) -> torch.Tensor:
    """Config 7's observations, drawn on the CPU (so every device filters
    the same data) and moved to ``device``."""
    _, ys = simulate_lgssm_data(random.key(SMC2_DATA_SEED), SMC2_A, SMC2_Q,
                                SMC2_R, n_steps)
    return ys.to(_device(device))


def smc2_model():
    """Config 7's model for :func:`~genjax_torch.inference.smc2.smc2`, the
    θ axis leading every call: ``(init_sampler, propagate, loglik,
    prior_sample, log_prior)``."""
    sq = float(np.sqrt(np.float32(SMC2_Q)))
    sr = float(np.sqrt(np.float32(SMC2_R)))
    log_width = float(np.log(np.float32(2 * SMC2_BOUND)))

    def init_sampler(keys, a, n):
        return sq * random.normal(keys, (n,))

    def propagate(keys, a, xs):
        return a[:, None] * xs + sq * random.normal(keys, xs.shape[1:])

    def loglik(a, xs, y):
        return g.normal.logpdf(y, xs, sr)

    def prior_sample(keys):
        return random.uniform(keys, (), minval=-SMC2_BOUND,
                              maxval=SMC2_BOUND)

    def log_prior(a):
        return torch.where(a.abs() < SMC2_BOUND,
                           torch.full_like(a, -log_width),
                           torch.full_like(a, -math.inf))

    return init_sampler, propagate, loglik, prior_sample, log_prior


def smc2_oracle(ys) -> dict:
    """The exact posterior of config 7's coefficient by Kalman quadrature
    on ``linspace(−0.949, 0.949, 191)`` in float64: its mean, sd and the
    log evidence."""
    ys = torch.as_tensor(ys).detach().cpu().double()
    mean, std, log_ev = lgssm_grid_posterior(
        ys, SMC2_Q, SMC2_R, torch.linspace(-0.949, 0.949, 191,
                                           dtype=torch.float64))
    return {"mean": float(mean), "std": float(std), "log_ev": float(log_ev)}


def build_smc2(n_theta: int = 1024, n_x: int = 1024, n_steps: int = 50,
               device=None):
    """Bench config 7: SMC² with ``n_theta`` parameter particles, each an
    ``n_x``-particle bootstrap filter, over ``n_steps`` observations.
    Returns ``(run, oracle, ys)``: ``run(key) -> SMC2Result``, the work
    is ``n_theta·n_x·n_steps`` inner particle-steps."""
    device = _device(device)
    ys = lgssm_observations(n_steps, device)
    sampler = smc2(*smc2_model(), n_theta=n_theta, n_x=n_x,
                   proposal=SMC2_PROPOSAL)

    def run(key):
        return sampler(key, ys)

    return run, smc2_oracle(ys), ys


def build_trace_pf(n_particles: int = 2 ** 18, n_steps: int = 50,
                   device=None):
    """The trace-level particle filter on config 7's LGSSM at the true
    coefficient, ``lgssm_model(0.7, 0.4, 0.4, n_steps)``, observed on
    config 7's data. Returns ``(run, exact_log_z, ys)``: ``run(key) ->
    TracePFResult``; the exact log Z is the float64 Kalman filter's.

    The futures are refreshed after each resample (the filter is then
    exactly the bootstrap filter): over 50 steps the shared-future form
    copies one drawn future into every descendant of a resampled
    particle, and the ensemble's later steps collapse onto a few paths."""
    device = _device(device)
    ys = lgssm_observations(n_steps, device)
    model = lgssm_model(SMC2_A, SMC2_Q, SMC2_R, n_steps)
    pf = trace_particle_filter(model, (0.0, None), "y", ys, n_particles,
                               refresh_future=True)
    exact, _ = kalman_filter(ys.detach().cpu().double(), SMC2_A, SMC2_Q,
                             SMC2_R, mu0=0.0, p0=0.0)
    return pf, float(exact), ys


#: The coins of the JAX package's data-annealed SMC tests: p ~ Beta(2, 2)
#: and flips of p, observed in this pattern, repeated.
COINS_PATTERN = (True, True, False, True, True)


def coins_observations(n_flips: int) -> list:
    return [COINS_PATTERN[i % len(COINS_PATTERN)] for i in range(n_flips)]


def coins_model(n_flips: int):
    """``p ~ Beta(2, 2)``, ``v{i} ~ Flip(p)`` for ``i < n_flips``."""
    @g.gen
    def coins():
        p = g.beta(2.0, 2.0) @ "p"
        for i in range(n_flips):
            _ = g.flip(p) @ f"v{i}"

    return coins


def coins_exact_log_z(obs) -> float:
    """log P(obs) = log B(2 + h, 2 + t) − log B(2, 2)."""
    h = sum(bool(o) for o in obs)
    t = len(obs) - h
    return (math.lgamma(2 + h) + math.lgamma(2 + t) - math.lgamma(4 + h + t)
            - (2 * math.lgamma(2) - math.lgamma(4)))


def build_data_smc(n_particles: int = 2 ** 19, n_flips: int = 32,
                   n_moves: int = 1, device=None):
    """Data-annealed SMC on :func:`coins_model`, one flip a step, with
    ``n_moves`` MH moves of ``p`` by ``Regenerate`` after each. Returns
    ``(run, exact_log_z)``: ``run(key) -> DataSMCResult``."""
    device = _device(device)
    obs = coins_observations(n_flips)
    schedule = [g.C[f"v{i}"].set(o) for i, o in enumerate(obs)]
    run = data_annealed_smc(
        coins_model(n_flips), (), schedule, n_particles,
        make_request=lambda: g.Regenerate(g.Selection.at["p"]),
        n_moves=n_moves)
    return run, coins_exact_log_z(obs)


# -- configs 5, 9 and 10; parallel tempering; MAP / Laplace -------------------


def adev_vi_problem():
    """Config 5's model, guide and ELBO gradient: ``comp ~ flip(0.5)``,
    ``mu ~ normal(±v, 1)``, ``y ~ normal(mu, 0.5)`` observed at 1; the
    guide enumerates ``comp`` (``flip_enum``) and reparameterizes ``mu``
    (``normal_reparam(±v, 0.5)``). Returns ``(model, guide, loss_grad)``,
    ``loss_grad(keys E + (2,), (v,)) -> (dv,)`` with ``v`` of shape
    ``E``. With common random numbers across the two branches, the
    gradient is exactly ``4v`` on every key."""

    @g.gen
    def model(v):
        comp = g.flip(0.5) @ "comp"
        mu = g.normal(torch.where(comp, v, -v), 1.0) @ "mu"
        _ = g.normal(mu, 0.5) @ "y"

    @marginal()
    @g.gen
    def guide(target):
        (v,) = target.args
        b = vi.flip_enum(0.5) @ "comp"
        _ = vi.normal_reparam(torch.where(b, v, -v), 0.5) @ "mu"

    loss_grad = vi.ELBO(guide, lambda v: Target(model, (v,),
                                                g.C["y"].set(1.0)))
    return model, guide, loss_grad


def adev_vi_exact(v0, n_steps: int, lr: float = 1e-3):
    """Config 5's closed-form trajectory: every gradient is ``4v``, so
    ``v_n = v0 · (1 − 4·lr)^n`` (in float64)."""
    return np.asarray(v0, np.float64) * (1.0 - 4.0 * lr) ** n_steps


def build_adev_vi(n_fits: int = 65536, n_steps: int = 100,
                  elbo_samples: int = 8, lr: float = 1e-3, device=None):
    """Bench config 5: ``n_fits`` independent fits, ``v0 =
    linspace(0.2, 0.8)``, each of ``n_steps`` gradient steps on the mean
    of ``elbo_samples`` ELBO gradients. Fit ``f`` takes key
    ``split(key, n_fits)[f]``, step ``i`` the samples' keys
    ``split(fold_in(fit_key, i), elbo_samples)``, as
    ``run_all.py::config5_vi`` does; all fits and samples are one key
    batch ``(n_fits, elbo_samples)`` of executions. Returns ``(run,
    v0)``: ``run(key) -> (v, first_grad)``, the final ``v`` and each
    fit's first mean gradient."""
    dev = _device(device)
    _, _, loss_grad = adev_vi_problem()
    v0 = torch.linspace(0.2, 0.8, n_fits, device=dev)

    def run(key):
        fit_keys = random.split(key.to(dev), n_fits)
        v, first = v0, None
        for i in range(n_steps):
            keys = random.split(random.fold_in(fit_keys, i), elbo_samples)
            (dv,) = loss_grad(keys, (v[:, None].expand(n_fits,
                                                        elbo_samples),))
            grad = dv.mean(-1)
            first = grad if first is None else first
            v = v - lr * grad
        return v, first

    return run, v0


BNN_DATA_KEYS = (3, 4, 5, 6)


def bnn_data(din: int = 512, dh: int = 1024, b: int = 8192, device=None):
    """Config 9's data, drawn from the port's keys 3-6 as
    ``run_all.py::config9_bnn_vi`` draws it from JAX's: ``X =
    normal(key 3, (b, din)) / sqrt(din)``, a teacher ``W1 = 0.8 ·
    normal(key 4)``, ``w2 = normal(key 5) / sqrt(dh)``, ``y = tanh(X W1)
    w2 + 0.1 · normal(key 6)``. Returns ``(X, y)``."""
    dev = _device(device)
    k3, k4, k5, k6 = (random.key(s, device=dev) for s in BNN_DATA_KEYS)
    x = random.normal(k3, (b, din)) / math.sqrt(din)
    w1t = 0.8 * random.normal(k4, (din, dh))
    w2t = random.normal(k5, (dh,)) / math.sqrt(dh)
    y = torch.tanh(x @ w1t) @ w2t + 0.1 * random.normal(k6, (b,))
    return x, y


def bnn_vi_problem(x: torch.Tensor, y: torch.Tensor):
    """Config 9's model and mean-field guide over a tanh network
    ``din -> dh -> 1``: ``W1``, ``w2`` standard normal,
    ``y ~ mv_normal_diag(tanh(X W1) w2, 0.5)``; the guide draws each
    weight by ``normal_reparam(mu, softplus(rho))``. Returns ``(model,
    guide, loss_grad)``, ``loss_grad(key, (params,))`` the ELBO gradient
    of ``params = {"mu1", "rho1", "mu2", "rho2"}``."""

    @g.gen
    def bnn(params, x):
        w1 = g.normal(torch.zeros_like(params["mu1"]), 1.0) @ "W1"
        w2 = g.normal(torch.zeros_like(params["mu2"]), 1.0) @ "w2"
        f = (torch.tanh(x @ w1) @ w2[..., None])[..., 0]
        _ = g.mv_normal_diag(f, 0.5 * torch.ones_like(f)) @ "y"

    @marginal()
    @g.gen
    def guide(target):
        params, _x = target.args
        _ = vi.normal_reparam(
            params["mu1"], torch.nn.functional.softplus(params["rho1"])
        ) @ "W1"
        _ = vi.normal_reparam(
            params["mu2"], torch.nn.functional.softplus(params["rho2"])
        ) @ "w2"

    loss_grad = vi.ELBO(guide, lambda p: Target(bnn, (p, x),
                                                g.C["y"].set(y)))
    return bnn, guide, loss_grad


def bnn_params0(din: int, dh: int, device=None) -> dict:
    """Config 9's starting point: means 0, ``rho`` −2."""
    dev = _device(device)
    return {"mu1": torch.zeros(din, dh, device=dev),
            "rho1": torch.full((din, dh), -2.0, device=dev),
            "mu2": torch.zeros(dh, device=dev),
            "rho2": torch.full((dh,), -2.0, device=dev)}


def bnn_noise(key, din: int, dh: int):
    """The standard-normal noise an ELBO gradient on ``key`` gives the
    guide's two sites under the port's key discipline: ``W1`` draws from
    ``split(key)[1]``, and the continuation's key ``split(key)[0]`` gives
    ``w2`` its ``split(·)[1]``."""
    k_w2, k_w1 = random.split(key).unbind(-2)
    eps1 = random.normal(k_w1, (din, dh))
    eps2 = random.normal(random.split(k_w2)[..., 1, :], (dh,))
    return eps1, eps2


def bnn_neg_elbo(params: dict, eps1, eps2, x, y) -> torch.Tensor:
    """The reparameterized −ELBO of config 9 written out by hand (a plain
    reference, independent of the ADEV handler): ``W = mu + softplus(rho)
    · eps``, then ``−[log p(W1) + log p(w2) + log p(y | W) − log q(W1)
    − log q(w2)]``."""
    def normal_lp(v, loc, scale):
        return (-0.5 * ((v - loc) / scale) ** 2 - torch.log(scale)
                - 0.5 * math.log(2 * math.pi))

    s1 = torch.nn.functional.softplus(params["rho1"])
    s2 = torch.nn.functional.softplus(params["rho2"])
    w1 = params["mu1"] + s1 * eps1
    w2 = params["mu2"] + s2 * eps2
    f = torch.tanh(x @ w1) @ w2
    log_p = (normal_lp(w1, 0.0, torch.ones(())).sum()
             + normal_lp(w2, 0.0, torch.ones(())).sum()
             + normal_lp(y, f, torch.full((), 0.5)).sum())
    log_q = (normal_lp(w1, params["mu1"], s1).sum()
             + normal_lp(w2, params["mu2"], s2).sum())
    return -(log_p - log_q)


def bnn_neg_elbo_estimate(key, params: dict, x, y, n: int = 16):
    """The mean of :func:`bnn_neg_elbo` over ``n`` noise draws, draw
    ``j`` from :func:`bnn_noise` on ``fold_in(key, j)``."""
    din, dh = params["mu1"].shape
    total = torch.zeros((), device=x.device)
    with torch.no_grad():
        for j in range(n):
            eps1, eps2 = bnn_noise(random.fold_in(key.to(x.device), j), din,
                                   dh)
            total = total + bnn_neg_elbo(params, eps1, eps2, x, y)
    return total / n


@contextlib.contextmanager
def full_f32_matmul():
    """Matrix products in full f32 (no TF32) inside the block: the
    precision of config 9's products, which the JAX package runs as
    plain f32 XLA products."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def build_bnn_vi(din: int = 512, dh: int = 1024, b: int = 8192,
                 n_steps: int = 500, lr: float = 1e-2, device=None):
    """Bench config 9: ADEV VI of a mean-field Gaussian over the weights
    of a ``din -> dh -> 1`` tanh network on ``b`` points (:func:`bnn_data`),
    ``n_steps`` steps of a 1-sample ELBO gradient on key
    ``fold_in(key, i)`` and the Adam update of ``run_all.py`` (β 0.9 /
    0.999, ``lr``, eps 1e-8, no bias correction). Products in full f32
    (:func:`full_f32_matmul`). Returns ``(run, x, y, loss_grad)``:
    ``run(key, params=None) -> params``."""
    dev = _device(device)
    x, y = bnn_data(din, dh, b, dev)
    _, _, loss_grad = bnn_vi_problem(x, y)

    def run(key, params=None, n=n_steps):
        p = params if params is not None else bnn_params0(din, dh, dev)
        m = {k: torch.zeros_like(v) for k, v in p.items()}
        v2 = {k: torch.zeros_like(v) for k, v in p.items()}
        with full_f32_matmul():
            for i in range(n):
                (dp,) = loss_grad(random.fold_in(key.to(dev), i), (p,))
                for k in p:
                    m[k] = 0.9 * m[k] + 0.1 * dp[k]
                    v2[k] = 0.999 * v2[k] + 0.001 * dp[k] * dp[k]
                    p[k] = p[k] - lr * m[k] / (torch.sqrt(v2[k]) + 1e-8)
        return p

    return run, x, y, loss_grad


def blr_model(b: int, d: int):
    """Config 10's Bayesian linear regression: ``w ~ mv_normal_diag(0,
    1)`` over ``d`` coefficients, ``y ~ mv_normal_diag(X w, 0.25)`` over
    ``b`` points."""

    @g.gen
    def blr(x):
        w = g.mv_normal_diag(torch.zeros(d, device=x.device),
                             torch.ones(d, device=x.device)) @ "w"
        _ = g.mv_normal_diag(_shared_matvec(x, w),
                             torch.full((b,), 0.25, device=x.device)) @ "y"

    return blr


def blr_data(b: int = 1024, d: int = 64, device=None):
    """Config 10's data from the port's keys 10 and 11, as
    ``run_all.py::config10_svgd`` draws it from JAX's: ``X = normal(key
    10, (b, d)) / sqrt(d)``, ``y = X linspace(-1, 1, d) + 0.25 ·
    normal(key 11)``. Returns ``(X, y)``."""
    dev = _device(device)
    x = random.normal(random.key(10, device=dev), (b, d)) / math.sqrt(d)
    w_true = torch.linspace(-1.0, 1.0, d, device=dev)
    y = x @ w_true + 0.25 * random.normal(random.key(11, device=dev), (b,))
    return x, y


def blr_exact(x, y, noise_sd: float = 0.25) -> dict:
    """The conjugate posterior of :func:`blr_model` and its evidence, in
    float64: ``{"mean", "cov", "log_z"}``."""
    xd = torch.as_tensor(x).double().cpu()
    yd = torch.as_tensor(y).double().cpu()
    s2 = noise_sd ** 2
    prec = torch.eye(xd.shape[1], dtype=torch.float64) + xd.T @ xd / s2
    cov = torch.linalg.inv(prec)
    mean = torch.linalg.solve(prec, xd.T @ yd / s2)
    marg = s2 * torch.eye(xd.shape[0], dtype=torch.float64) + xd @ xd.T
    chol = torch.linalg.cholesky(marg)
    z = torch.linalg.solve_triangular(chol, yd[:, None], upper=False)[:, 0]
    log_z = (-0.5 * (z * z).sum() - torch.log(torch.diagonal(chol)).sum()
             - 0.5 * xd.shape[0] * math.log(2 * math.pi))
    return {"mean": mean.numpy(), "cov": cov.numpy(), "log_z": float(log_z)}


def build_svgd(n_particles: int = 4096, n_steps: int = 600, b: int = 1024,
               d: int = 64, step_size: float = 0.05, h_rows: int = 256,
               device=None):
    """Bench config 10: ``run_svgd`` on :func:`blr_model` with
    :func:`blr_data`. Returns ``(run, target, exact)``: ``run(key) ->``
    the ensemble's ``w`` (``(n_particles, d)``), and :func:`blr_exact`."""
    x, y = blr_data(b, d, device)
    target = Target(blr_model(b, d), (x,), g.C["y"].set(y))

    def run(key):
        ens = run_svgd(target, key.to(x.device), n_particles=n_particles,
                       n_steps=n_steps, step_size=step_size, h_rows=h_rows)
        return ens["w"]

    return run, target, blr_exact(x, y)


def tempered_exact_posterior(ys, sigma: float = TEMPERED_SIGMA) -> dict:
    """Config 6's conjugate posterior of ``mu``: ``{"mean", "sd"}``."""
    y = np.asarray(torch.as_tensor(ys).cpu(), np.float64)
    post_var = 1.0 / (1.0 / TEMPERED_PRIOR_SD ** 2 + y.size / sigma ** 2)
    return {"mean": float(post_var * y.sum() / sigma ** 2),
            "sd": float(math.sqrt(post_var))}


def build_pt(n_ladders: int = 4096, n_rungs: int = 16, n_steps: int = 200,
             burn_in: int = 200, n_obs: int = 64, device=None):
    """Parallel tempering on config 6's conjugate model
    (:func:`tempered_model`, ``sigma`` 0.8, :func:`tempered_observations`):
    ``n_ladders`` independent linear ladders of ``n_rungs`` rungs, the
    default ``Regenerate`` of ``mu``, ``burn_in + n_steps`` steps with the
    cold chain's ``mu`` kept after burn-in. Returns ``(run, exact)``:
    ``run(key) -> ParallelTemperingResult`` (samples ``(n_ladders,
    n_steps)``) and :func:`tempered_exact_posterior`."""
    dev = _device(device)
    ys = tempered_observations(n_obs, dev)
    target = Target(tempered_model(n_obs), (TEMPERED_SIGMA,),
                    g.C["ys"].set(ys))
    sampler = parallel_tempering(target, n_rungs)

    def run(key):
        keys = random.split(key.to(dev), n_ladders)
        return sampler(keys, burn_in + n_steps, burn_in=burn_in,
                       collect=lambda tr: tr.get_choices()["mu"])

    return run, tempered_exact_posterior(ys)


def build_map_laplace(b: int = 1024, d: int = 64, n_steps: int = 1000,
                      device=None):
    """``map_optimize(include_jacobian=True)`` (Adam, lr 1e-2) then
    ``laplace_approximation`` on config 10's regression, whose Gaussian
    posterior makes the Laplace approximation exact. Returns ``(run,
    exact)``: ``run(key) -> (MAPResult, LaplaceResult)`` and
    :func:`blr_exact`."""
    x, y = blr_data(b, d, device)
    target = Target(blr_model(b, d), (x,), g.C["y"].set(y))

    def run(key):
        res = map_optimize(key.to(x.device), target, n_steps=n_steps,
                           include_jacobian=True)
        return res, laplace_approximation(target, res.choices,
                                          transforms=res.transforms)

    return run, blr_exact(x, y)


#: The conjugate gamma-Poisson model of the JAX package's VI tests
#: (``lam ~ gamma(2, 1)``, ``y ~ poisson(lam)``) and its observation:
#: the posterior is Gamma(7, 2), with mean 3.5, and p(y = 5) = 6/128.
GAMMA_POISSON_Y = 5
GAMMA_POISSON_MEAN = 3.5
GAMMA_POISSON_LOG_Z = math.log(6.0 / 128.0)


def gamma_poisson_model():
    @g.gen
    def gamma_poisson():
        lam = g.gamma(2.0, 1.0) @ "lam"
        _ = g.poisson(lam) @ "y"
        return lam

    return gamma_poisson


def build_gamma_poisson_sir(k_particles: int = 2 ** 20,
                            y: int = GAMMA_POISSON_Y, device=None):
    """``ImportanceK`` SIR on :func:`gamma_poisson_model` with ``y``
    observed. Returns ``run``: ``run(key) -> dict`` with the posterior
    mean of ``lam`` (``"mean"``), log Ẑ (``"log_z"``), the weighted
    particles (``"lam"``, ``"log_weights"``) and the collection after one
    systematic resample (``"resampled"``, the CDF kernel on the card).
    Exact answers at y = 5: :data:`GAMMA_POISSON_MEAN` and
    :data:`GAMMA_POISSON_LOG_Z`."""
    device = _device(device)
    target = Target(gamma_poisson_model(), (),
                    g.C["y"].set(torch.tensor(y, device=device)))

    def run(key):
        k_run, k_res = random.split(key.to(device)).unbind(-2)
        col = ImportanceK(target, k_particles=k_particles).run_smc(k_run)
        lw = col.get_log_weights()
        lam = col.get_particles().get_choices()["lam"]
        return {"mean": torch.sum(torch.softmax(lw, dim=0) * lam),
                "log_z": col.get_log_marginal_likelihood_estimate(),
                "lam": lam, "log_weights": lw,
                "resampled": col.resample(k_res)}

    return run


#: The scale-free regression: config 2's priors and points, the noise
#: scale under ``half_normal(1)`` and the data drawn with sd 0.3. Each
#: chain starts from the best of 16 prior draws: from one draw, about
#: one chain in six starts at a tiny noise scale far from the data,
#: diverges at every step of the shared step size and never moves (so
#: does the JAX package's ``run_nuts``, 11 of 64 chains at 128 points).
SCALE_NOISE, SCALE_DATA_SEED, SCALE_INIT_DRAWS = 0.3, 3, 16


def scale_regression_model():
    """Config 2's regression with ``sigma ~ half_normal(1.0)`` in place
    of the fixed noise sd (the JAX package's constrained-NUTS test
    model, ``tests/inference/test_nuts.py``, with an intercept)."""

    @g.gen
    def scale_regression(xs):
        slope = g.normal(0.0, REGRESSION_PRIOR_SD) @ "slope"
        icept = g.normal(0.0, REGRESSION_PRIOR_SD) @ "icept"
        sigma = g.half_normal(1.0) @ "sigma"
        _ = g.mv_normal_diag(slope[..., None] * xs + icept[..., None],
                             sigma[..., None] * torch.ones_like(xs)) @ "ys"

    return scale_regression


def scale_regression_data(n_points: int = REGRESSION_POINTS, device=None):
    """``xs = linspace(-1, 1, n)``, ``ys = 2·xs − 0.5 + 0.3·normal(key(3),
    (n,))``, drawn on the CPU so that every device fits the same data."""
    xs = torch.linspace(-1.0, 1.0, n_points)
    ys = 2.0 * xs - 0.5 + SCALE_NOISE * random.normal(
        random.key(SCALE_DATA_SEED), (n_points,))
    dev = _device(device)
    return xs.to(dev), ys.to(dev)


def scale_nuts_exact(xs, ys, n_grid: int = 4000, sigma_max: float = 2.0
                     ) -> dict:
    """The exact posterior means of ``sigma``, ``slope`` and ``icept`` of
    :func:`scale_regression_model`, float64: ``sigma`` on a grid of
    ``n_grid`` points on (0, sigma_max], weighted by the Gaussian
    marginal ``N(y; 0, σ²I + 4·XXᵀ)`` (``X = [xs, 1]``) times the
    half-normal prior; slope and intercept by the Gaussian conditional
    means under those weights."""
    x = np.asarray(torch.as_tensor(xs).cpu(), np.float64)
    y = np.asarray(torch.as_tensor(ys).cpu(), np.float64)
    a = np.stack([x, np.ones_like(x)], axis=1)
    n, prior_var = len(y), REGRESSION_PRIOR_SD ** 2
    ata, aty, yty = a.T @ a, a.T @ y, y @ y
    sig = sigma_max * np.arange(1, n_grid + 1) / n_grid
    logw = np.empty(n_grid)
    means = np.empty((n_grid, 2))
    for i, s in enumerate(sig):
        s2 = s * s
        # Woodbury: (s²I + v·AAᵀ)⁻¹ = (I − A (s²/v I + AᵀA)⁻¹ Aᵀ) / s².
        inner = np.linalg.inv(s2 / prior_var * np.eye(2) + ata)
        quad = (yty - aty @ inner @ aty) / s2
        logdet = (2 * n * np.log(s)
                  + np.linalg.slogdet(np.eye(2) + prior_var * ata / s2)[1])
        logw[i] = -0.5 * (quad + logdet) - 0.5 * s2
        precision = np.eye(2) / prior_var + ata / s2
        means[i] = np.linalg.solve(precision, aty / s2)
    w = np.exp(logw - logw.max())
    w /= w.sum()
    return {"sigma": float(w @ sig), "slope": float(w @ means[:, 0]),
            "icept": float(w @ means[:, 1])}


def build_scale_nuts(n_chains: int = 2048, num_warmup: int = 200,
                     num_samples: int = 200, max_depth: int = 6,
                     n_points: int = REGRESSION_POINTS, device=None):
    """NUTS on :func:`scale_regression_model` with
    :func:`scale_regression_data`, ``transforms="auto"`` (``sigma`` runs
    through the positive transform its support metadata names), each
    chain from the best of :data:`SCALE_INIT_DRAWS` prior draws. Returns
    ``(run, target)``: ``run(key) -> (choices, infos)``, the draws leading
    with ``(chains, samples)``."""
    xs, ys = scale_regression_data(n_points, device)
    target = Target(scale_regression_model(), (xs,), g.C["ys"].set(ys))

    def run(key):
        return run_nuts(target, key, n_chains=n_chains,
                        num_warmup=num_warmup, num_samples=num_samples,
                        max_depth=max_depth, transforms="auto",
                        init_draws=SCALE_INIT_DRAWS)

    return run, target


def _world_mesh(mesh, device: torch.device, axis_name: str):
    """``mesh``, or the 1-D mesh over the initialized world on
    ``device``'s type (raising without a process group)."""
    from genjax_torch.parallel import particle_mesh

    return mesh if mesh is not None else particle_mesh(device.type,
                                                       axis_name)


def build_sharded_pf(n_particles: int = 2 ** 20, n_steps: int = 32,
                     model: str = "tracking", use_collectives: bool = True,
                     mesh=None, device=None):
    """Config 4 through ``parallel.sharded_particle_filter``: this rank
    runs its slice of the particles on the per-particle path (keys
    ``fold_in(k, i)``). ``model="tracking"`` is config 4's model and
    observations; ``"linear"`` the linear-Gaussian model on
    ``linear_observations(n_steps)``, initialized at zero, whose exact log
    Z is :func:`kalman_loglik`. Returns ``(run, work)``: ``run(key) ->``
    the replicated log Z, ``work`` the particle-steps of one run."""
    from genjax_torch.parallel import sharded_particle_filter

    device = _device(device)
    mesh = _world_mesh(mesh, device, "particles")
    if model == "tracking":
        ys = tracking_observations(n_steps, device)

        def init(keys):
            return random.normal(keys), torch.zeros((), device=keys.device)

        def step(keys, xs, y):
            xs_new = tracking_propagate(xs, random.normal(keys))
            return xs_new, tracking_loglik(xs_new, y)
    elif model == "linear":
        ys = torch.as_tensor(linear_observations(n_steps), device=device)

        def init(keys):
            return (torch.zeros(keys.shape[:-1], device=keys.device),
                    torch.zeros((), device=keys.device))

        def step(keys, xs, y):
            xs_new = linear_propagate(xs, random.normal(keys))
            return xs_new, linear_loglik(xs_new, y)
    else:
        raise ValueError(f"build_sharded_pf: model {model!r} is neither "
                         "'tracking' nor 'linear'")
    pf = sharded_particle_filter(init, step, n_particles, mesh,
                                 use_collectives=use_collectives)

    def run(key):
        final, _ = pf(key.to(device), ys)
        return final.log_z

    return run, n_particles * n_steps


def build_sharded_sir(k_particles: int = 2 ** 20, mesh=None, device=None):
    """Config 1's SIR through ``parallel.sharded_importance``: this rank's
    slice of the ``k_particles``, each on the key ImportanceK gives it
    (``fold_in(split(key)[1], i)``), so the ensemble is :func:`entry`'s
    on the same key. Returns ``(sir_step, (key,))``: ``sir_step(key) ->
    (posterior mean of p, log Ẑ)``, both replicated."""
    from genjax_torch.parallel import blocked_logz, weighted_mean
    from genjax_torch.parallel.smc import sharded_importance

    device = _device(device)
    mesh = _world_mesh(mesh, device, "particles")
    target = Target(quickstart_model(), (2.0, 2.0), g.C["v"].set(True))
    importance = sharded_importance(target, k_particles, mesh)

    def sir_step(key):
        col = importance(random.split(key.to(device))[1])
        lw = col.get_log_weights()
        ps = col.get_particles().get_choices()["p"]
        return weighted_mean(lw, ps, mesh), blocked_logz(lw, mesh)

    return sir_step, (random.key(0, device=device),)


def hmm_observations(n_states: int, n_steps: int, device=None):
    """``n_steps`` observations drawn uniformly from ``n_states`` symbols
    on ``key(3)`` (the time-sharded filter's input; the filter's answer
    does not need them to come from the model)."""
    k = random.key(3, device=_device(device))
    return random.bits(k, (n_steps,)) % n_states


def build_time_sharded_hmm(n_states: int = 64, n_steps: int = 65536,
                           block: int | None = None, mesh=None,
                           device=None):
    """The time-sharded forward filter and backward sampler
    (``parallel.seq``) on ``circulant(S, S)`` with
    :func:`hmm_observations`; this rank holds its ``T/D`` steps. Returns
    ``(run, (config, observations))``: ``run(key) -> (alphas, log
    marginal, path)``, the rank's rows of ``alphas`` and of the sampled
    path and the replicated log marginal; ``observations`` are all
    ``T``."""
    from genjax_torch.parallel import (
        shard_leading_axis,
        time_sharded_backward_sample,
        time_sharded_filter,
    )

    device = _device(device)
    mesh = _world_mesh(mesh, device, "time")
    config = DiscreteHMMConfiguration.circulant(n_states, n_states,
                                                device=device)
    obs = hmm_observations(n_states, n_steps, device)
    local = shard_leading_axis(obs, mesh, "time")

    def run(key):
        alphas, log_z = time_sharded_filter(config, local, mesh, "time",
                                            block)
        z = time_sharded_backward_sample(key.to(device), config, alphas,
                                         mesh, "time", block)
        return alphas, log_z, z

    return run, (config, obs)


def build_sharded_svgd(n_particles: int = 4096, n_steps: int = 600,
                       b: int = 1024, d: int = 64, step_size: float = 0.05,
                       h_rows: int = 256, mesh=None, device=None):
    """Bench config 10 through ``parallel.run_sharded_svgd``: this rank's
    slice of the ensemble, drawn from the prior on the keys ``run_svgd``
    gives the same particles. Returns ``(run, target, exact)``:
    ``run(key) ->`` the rank's rows of the ensemble's ``w`` and
    :func:`blr_exact`."""
    from genjax_torch.inference.svgd import svgd_problem
    from genjax_torch.parallel import run_sharded_svgd
    from genjax_torch.parallel.mesh import rank_range

    device = _device(device)
    mesh = _world_mesh(mesh, device, "particles")
    particle_range = rank_range(n_particles, mesh, "particles")
    x, y = blr_data(b, d, device)
    target = Target(blr_model(b, d), (x,), g.C["y"].set(y))

    def run(key):
        xs, logdensity, finish = svgd_problem(
            target, key.to(device), n_particles,
            particle_range=particle_range)
        xs = run_sharded_svgd(logdensity, xs, n_steps, step_size, mesh,
                              h_rows=h_rows)
        return finish(xs)["w"]

    return run, target, blr_exact(x, y)


def build_sharded_smc2(n_theta: int = 1024, n_x: int = 1024,
                       n_steps: int = 50, mesh=None, device=None):
    """Bench config 7 through ``parallel.sharded_smc2``: this rank runs
    its θ-rows with their whole inner filters, and the result is
    :func:`build_smc2`'s on the same key, sliced by rank. Returns ``(run,
    oracle, ys)``: ``run(key) -> SMC2Result`` (``thetas`` and
    ``log_weights`` the rank's rows, the rest replicated)."""
    from genjax_torch.parallel import sharded_smc2

    device = _device(device)
    mesh = _world_mesh(mesh, device, "particles")
    ys = lgssm_observations(n_steps, device)
    sampler = sharded_smc2(*smc2_model(), n_theta=n_theta, n_x=n_x,
                           mesh=mesh, proposal=SMC2_PROPOSAL)

    def run(key):
        return sampler(key.to(device), ys)

    return run, smc2_oracle(ys), ys


def build_sharded_pt(n_ladders: int = 4096, n_rungs: int = 16,
                     n_steps: int = 200, burn_in: int = 200, n_obs: int = 64,
                     mesh=None, device=None):
    """:func:`build_pt` through ``parallel.sharded_parallel_tempering``:
    the rung axis over the mesh, every ladder on every rank. Returns
    ``(run, exact)``: ``run(key) -> ParallelTemperingResult`` (the rank's
    rungs of the traces and acceptance rates; the cold chain's samples
    and the swap rates whole), bit for bit :func:`build_pt`'s run on the
    same key."""
    from genjax_torch.parallel import sharded_parallel_tempering

    dev = _device(device)
    mesh = _world_mesh(mesh, dev, "particles")
    ys = tempered_observations(n_obs, dev)
    target = Target(tempered_model(n_obs), (TEMPERED_SIGMA,),
                    g.C["ys"].set(ys))
    sampler = sharded_parallel_tempering(target, n_rungs, mesh)

    def run(key):
        keys = random.split(key.to(dev), n_ladders)
        return sampler(keys, burn_in + n_steps, burn_in=burn_in,
                       collect=lambda tr: tr.get_choices()["mu"])

    return run, tempered_exact_posterior(ys)


def pgas_model():
    """PGAS on config 7's LGSSM at ``a = SMC2_A`` for
    :func:`~genjax_torch.inference.pgibbs.particle_gibbs` (chain batch
    leading): ``(init_sampler, propagate, loglik, trans_logpdf)``."""
    a = SMC2_A
    sq = float(np.sqrt(np.float32(SMC2_Q)))
    sr = float(np.sqrt(np.float32(SMC2_R)))

    def init_sampler(keys, n):
        return sq * random.normal(keys, (n,))

    def propagate(keys, xs):
        return a * xs + sq * random.normal(keys, xs.shape[keys.ndim - 1:])

    def loglik(xs, y):
        return g.normal.logpdf(y, xs, sr)

    def trans_logpdf(xp, xn):
        return g.normal.logpdf(xn, a * xp, sq)

    return init_sampler, propagate, loglik, trans_logpdf


def build_sharded_pgibbs(n_chains: int = 256, n_particles: int = 128,
                         n_steps: int = 50, n_sweeps: int = 100, mesh=None,
                         device=None):
    """PGAS on config 7's data (:func:`pgas_model`, ``n_steps``
    observations) through ``parallel.sharded_particle_gibbs``: this rank's
    chains of ``n_chains``, chain ``i`` on ``fold_in(key, i)``, so its
    paths are those rows of ``particle_gibbs`` on ``split(key,
    n_chains)``. Returns ``(run, ys)``: ``run(key) ->
    ParticleGibbsResult`` of the rank's chains."""
    from genjax_torch.parallel import sharded_particle_gibbs

    device = _device(device)
    mesh = _world_mesh(mesh, device, "particles")
    ys = lgssm_observations(n_steps, device)
    init_sampler, propagate, loglik, trans_logpdf = pgas_model()
    sampler = sharded_particle_gibbs(init_sampler, propagate, loglik,
                                     n_particles, n_sweeps, n_chains, mesh,
                                     trans_logpdf=trans_logpdf)

    def run(key):
        return sampler(key.to(device), ys)

    return run, ys


def build_elastic_pf(n_particles: int = 2 ** 20, n_steps: int = 32,
                     device=None):
    """Config 4's filter (:func:`build_pf`'s model, observations and
    adaptive systematic resampling at ESS < n/2, the CDF kernel on a
    card) as a ``step(i, state)`` for ``utils.run_elastic``: step ``i``
    draws from ``fold_in(k, i)``, so a run resumed from a checkpoint
    replays it bit for bit. Returns ``make(key, fault_at=None) -> (step,
    state, log_z)``: the state is ``{"xs", "lw", "log_z", "fault"}``;
    with ``fault_at``, step ``fault_at`` turns the particles into NaN
    while ``state["fault"]`` is nonzero (a transient fault that a
    recovery hook clears); ``log_z(state)`` is the evidence estimate of
    a finished run."""
    from genjax_torch.inference.pf import _lse, _lse_ess
    from genjax_torch.inference.smc import resample_tree

    device = _device(device)
    ys = tracking_observations(n_steps, device)
    n = n_particles
    log_n = math.log(n)

    def make(key, fault_at=None):
        k_init, k_steps = random.split(key.to(device)).unbind(-2)
        state = {"xs": random.normal(k_init, (n,)),
                 "lw": torch.zeros(n, device=device),
                 "log_z": torch.zeros((), device=device),
                 "fault": torch.tensor(float(fault_at is not None),
                                       device=device)}

        def step(i, st):
            k_res, k_prop = random.split(
                random.fold_in(k_steps, i)).unbind(-2)
            xs, lw, log_z = st["xs"], st["lw"], st["log_z"]
            lse, ess = _lse_ess(lw)
            if bool(ess < 0.5 * n):
                xs = resample_tree(k_res, lw, xs, n)
                log_z = log_z + lse - log_n
                lw = torch.zeros_like(lw)
            xs = tracking_propagate(xs, random.normal(k_prop, (n,)))
            lw = lw + tracking_loglik(xs, ys[i])
            if i == fault_at:
                xs = xs + torch.where(st["fault"] != 0, torch.nan, 0.0)
            return {"xs": xs, "lw": lw, "log_z": log_z,
                    "fault": st["fault"]}

        def log_z_of(st):
            return st["log_z"] + _lse(st["lw"]) - log_n

        return step, state, log_z_of

    return make
