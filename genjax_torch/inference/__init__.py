"""Inference: targets, importance sampling / SIR with proposals,
``ChangeTarget`` and the GenSP / VI methods, ``Marginal``, particle
filters, the row resamplers, MH, the tempered SMC samplers, the particle
samplers (PMMH, SMC², particle Gibbs, the trace-level particle filter,
data-annealed SMC), gradient MCMC (HMC, MALA, NUTS with cross-chain
adaptation, elliptical slice, support transforms and diagnostics), exact
enumeration and posterior predictive sampling, variational inference
through ADEV (``vi``), SVGD, parallel tempering, and MAP with the Laplace
approximation."""

from genjax_torch.inference import vi
from genjax_torch.inference.adaptation import run_nuts, warmup_chains
from genjax_torch.inference.map_laplace import (
    LaplaceResult,
    MAPResult,
    laplace_approximation,
    map_optimize,
)
from genjax_torch.inference.pt import (
    ParallelTemperingResult,
    parallel_tempering,
)
from genjax_torch.inference.svgd import run_svgd, svgd_step
from genjax_torch.inference.data_smc import DataSMCResult, data_annealed_smc
from genjax_torch.inference.diagnostics import (
    ess_autocorr,
    split_rhat,
    summarize,
)
from genjax_torch.inference.exact_testbed import (
    DiscreteHMMInferenceProblem,
    build_test_against_exact_inference,
)
from genjax_torch.inference.enumerative import (
    EnumerationResult,
    enumerate_posterior,
)
from genjax_torch.inference.mcmc import chain, mh, multi_chain
from genjax_torch.inference.pgibbs import (
    ParticleGibbsResult,
    TraceParticleGibbsResult,
    conditional_bootstrap_filter,
    particle_gibbs,
    trace_csmc,
    trace_particle_gibbs,
)
from genjax_torch.inference.pmmh import (
    PMMHResult,
    gaussian_walk_proposal,
    pmmh,
)
from genjax_torch.inference.predictive import posterior_predictive
from genjax_torch.inference.requests import (
    HMC,
    MALA,
    NUTS,
    EllipticalSlice,
    Rejuvenate,
    SafeHMC,
    elliptical_slice_kernel,
    nuts_kernel,
    selection_gradient,
)
from genjax_torch.inference.transforms import (
    Bijector,
    constrain_choices,
    interval,
    positive,
    unconstrain_choices,
)

from genjax_torch.inference.pf import (
    FilterState,
    ParticleFilter,
    bootstrap_filter,
    fused_particle_filter,
    particle_filter,
)
from genjax_torch.inference.smc import (
    ChangeTarget,
    Importance,
    batched_importance,
    invariant_leaf_mask,
    ImportanceK,
    ParticleCollection,
    SMCAlgorithm,
    effective_sample_size,
    resample_indices,
    resample_indices_rows,
    resample_indices_sorted,
    resample_tree,
    resample_values,
    resample_values_rows,
    systematic_offspring_counts,
    systematic_offspring_cumulative,
)
from genjax_torch.inference.smc2 import SMC2Result, smc2
from genjax_torch.inference.smc_sampler import (
    TemperedSMCResult,
    annealed_importance_sampling,
    tempered_smc,
    waste_free_tempered_smc,
)
from genjax_torch.inference.trace_pf import (
    TracePFResult,
    trace_particle_filter,
)
from genjax_torch.inference.sp import (
    Algorithm,
    Marginal,
    SampleDistribution,
    Target,
    marginal,
)

__all__ = [
    "LaplaceResult",
    "MAPResult",
    "ParallelTemperingResult",
    "laplace_approximation",
    "map_optimize",
    "parallel_tempering",
    "run_svgd",
    "svgd_step",
    "vi",
    "Algorithm",
    "ChangeTarget",
    "DataSMCResult",
    "PMMHResult",
    "ParticleGibbsResult",
    "SMC2Result",
    "TracePFResult",
    "TraceParticleGibbsResult",
    "conditional_bootstrap_filter",
    "data_annealed_smc",
    "gaussian_walk_proposal",
    "particle_gibbs",
    "pmmh",
    "resample_indices_rows",
    "resample_indices_sorted",
    "resample_values",
    "resample_values_rows",
    "smc2",
    "trace_csmc",
    "trace_particle_filter",
    "trace_particle_gibbs",
    "Bijector",
    "EllipticalSlice",
    "EnumerationResult",
    "HMC",
    "MALA",
    "NUTS",
    "Rejuvenate",
    "SafeHMC",
    "constrain_choices",
    "elliptical_slice_kernel",
    "enumerate_posterior",
    "ess_autocorr",
    "interval",
    "nuts_kernel",
    "positive",
    "posterior_predictive",
    "run_nuts",
    "selection_gradient",
    "split_rhat",
    "summarize",
    "unconstrain_choices",
    "warmup_chains",
    "DiscreteHMMInferenceProblem",
    "FilterState",
    "ParticleFilter",
    "build_test_against_exact_inference",
    "Importance",
    "ImportanceK",
    "Marginal",
    "ParticleCollection",
    "SMCAlgorithm",
    "SampleDistribution",
    "Target",
    "TemperedSMCResult",
    "annealed_importance_sampling",
    "batched_importance",
    "bootstrap_filter",
    "chain",
    "effective_sample_size",
    "fused_particle_filter",
    "invariant_leaf_mask",
    "marginal",
    "mh",
    "multi_chain",
    "particle_filter",
    "resample_indices",
    "resample_tree",
    "systematic_offspring_counts",
    "systematic_offspring_cumulative",
    "tempered_smc",
    "waste_free_tempered_smc",
]
