"""Utilities: checkpointing, failure recovery, pretty rendering,
profiling hooks (counterpart of ``genjax_tpu/utils/``)."""

from genjax_torch.utils.checkpoint import restore_checkpoint, save_checkpoint
from genjax_torch.utils.failure import (
    ElasticResult,
    FailureEvent,
    Watchdog,
    all_finite,
    mesh_place,
    run_elastic,
)
from genjax_torch.utils.pretty import (
    pformat,
    pretty,
    pprint,
    render_choice_map,
    render_html,
)
from genjax_torch.utils.profiling import Timed, profile_trace

__all__ = [
    "ElasticResult",
    "FailureEvent",
    "Timed",
    "Watchdog",
    "all_finite",
    "mesh_place",
    "profile_trace",
    "run_elastic",
    "pformat",
    "pretty",
    "pprint",
    "render_choice_map",
    "render_html",
    "restore_checkpoint",
    "save_checkpoint",
]
