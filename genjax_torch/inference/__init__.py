"""Inference: targets, importance sampling / SIR, particle filters, MH
and the tempered SMC samplers."""

from genjax_torch.inference.mcmc import chain, mh, multi_chain

from genjax_torch.inference.pf import (
    FilterState,
    bootstrap_filter,
    fused_particle_filter,
    particle_filter,
)
from genjax_torch.inference.smc import (
    Importance,
    batched_importance,
    invariant_leaf_mask,
    ImportanceK,
    ParticleCollection,
    SMCAlgorithm,
    effective_sample_size,
    resample_indices,
    resample_tree,
    systematic_offspring_counts,
    systematic_offspring_cumulative,
)
from genjax_torch.inference.smc_sampler import (
    TemperedSMCResult,
    annealed_importance_sampling,
    tempered_smc,
    waste_free_tempered_smc,
)
from genjax_torch.inference.sp import (
    Algorithm,
    Marginal,
    SampleDistribution,
    Target,
    marginal,
)

__all__ = [
    "Algorithm",
    "FilterState",
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
