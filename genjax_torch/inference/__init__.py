"""Inference: targets, importance sampling / SIR and particle filters."""

from genjax_torch.inference.pf import (
    FilterState,
    bootstrap_filter,
    fused_particle_filter,
    particle_filter,
)
from genjax_torch.inference.smc import (
    Importance,
    ImportanceK,
    ParticleCollection,
    SMCAlgorithm,
    effective_sample_size,
    resample_indices,
    resample_tree,
    systematic_offspring_counts,
    systematic_offspring_cumulative,
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
    "bootstrap_filter",
    "effective_sample_size",
    "fused_particle_filter",
    "marginal",
    "particle_filter",
    "resample_indices",
    "resample_tree",
    "systematic_offspring_counts",
    "systematic_offspring_cumulative",
]
