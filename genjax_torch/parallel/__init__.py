"""Distributed inference over ``torch.distributed`` process groups
(counterpart of ``genjax_tpu/parallel/``): NCCL between CUDA cards, gloo
between CPU processes. Each rank holds its slice of the particle, chain
or time axis; see ``mesh.py`` for how JAX's global arrays map here."""

from genjax_torch.parallel.mesh import (
    DeviceMesh,
    gather_leading_axis,
    host_device_mesh,
    particle_mesh,
    replicated,
    shard_leading_axis,
)
from genjax_torch.parallel.bootstrap import (
    init_distributed,
    is_multihost,
    local_particle_slice,
)
from genjax_torch.parallel.collectives import (
    blocked_ess,
    blocked_logz,
    blocked_stats,
    comm,
    ring_resample_step,
    ring_systematic_resample,
    shardmap_ess,
    shardmap_logz,
    shardmap_systematic_resample,
)
from genjax_torch.parallel.pf import sharded_particle_filter
from genjax_torch.parallel.pgibbs import (
    pooled_chain_means,
    sharded_particle_gibbs,
)
from genjax_torch.parallel.pt import sharded_parallel_tempering
from genjax_torch.parallel.seq import (
    time_sharded_backward_sample,
    time_sharded_filter,
)
from genjax_torch.parallel.smc import (
    sharded_importance,
    sharded_resample,
    sharded_smc_step,
    weighted_mean,
)
from genjax_torch.parallel.smc2 import sharded_smc2
from genjax_torch.parallel.svgd import run_sharded_svgd, sharded_svgd_step

__all__ = [
    "DeviceMesh",
    "blocked_ess",
    "blocked_logz",
    "blocked_stats",
    "comm",
    "ring_resample_step",
    "ring_systematic_resample",
    "shardmap_ess",
    "shardmap_logz",
    "shardmap_systematic_resample",
    "gather_leading_axis",
    "host_device_mesh",
    "init_distributed",
    "is_multihost",
    "local_particle_slice",
    "particle_mesh",
    "pooled_chain_means",
    "replicated",
    "shard_leading_axis",
    "run_sharded_svgd",
    "sharded_importance",
    "sharded_parallel_tempering",
    "sharded_particle_filter",
    "sharded_particle_gibbs",
    "sharded_resample",
    "sharded_smc2",
    "sharded_smc_step",
    "sharded_svgd_step",
    "time_sharded_backward_sample",
    "time_sharded_filter",
    "weighted_mean",
]
