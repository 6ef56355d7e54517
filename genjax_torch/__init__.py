"""genjax_torch: the PyTorch / CUDA port of genjax_tpu for one NVIDIA
H100, slice by slice. Ported so far: the main path (the ``@gen``
language, the GFI data types, importance sampling / SIR and particle
filtering with systematic resampling), the discrete-HMM slice (the
exact ``DiscreteHMM`` posterior with its parallel-prefix filter, the
exact testbed, the HMM bootstrap filter), the edits slice (the five
GFI methods with ``edit``, the Vmap / repeat and Scan combinators, MH and
the tempered SMC samplers), gradient MCMC (HMC, MALA, NUTS with
cross-chain adaptation, elliptical slice, support transforms,
diagnostics; bench configs 2 and 8 in ``entry``), the switch-and-models
slice (Switch, mix, or_else; exact enumeration, posterior predictive; the
model families of ``models`` with their oracles, SLDS-RBPF among them),
the particle-samplers slice (``ChangeTarget``, the GenSP / VI methods
and ``marginal``, the row resamplers, PMMH, SMC², particle Gibbs, the
trace-level particle filter and data-annealed SMC; bench config 7), and
ADEV with variational inference, SVGD, parallel tempering and MAP /
Laplace (bench configs 5, 9 and 10), and the distributed layer
(``parallel``: sharded SMC, particle filtering, NUTS, SVGD and time-axis
HMM filtering over ``torch.distributed``),
with every kernel of the JAX package written by hand for Hopper
(``ops/``). The package imports ``torch`` and never ``jax``.
"""

from genjax_torch.core.compiler.interpreters.incremental import (
    Diff,
    NoChange,
    UnknownChange,
)
from genjax_torch.core.checks import do_checkify, optional_check
from genjax_torch.core.compiler.staging import (
    FlagOp,
    empty_trace,
    empty_value,
    multi_switch,
    to_shape_fn,
    tree_choose,
)
from genjax_torch.core.pytree import Closure, Const, Pytree, PythonicPytree
from genjax_torch.gfi.choice_map import (
    C,
    ChoiceMap,
    ChoiceMapBuilder,
    ChoiceMapNoValueAtAddress,
)
from genjax_torch.gfi.concepts import (
    Argdiffs,
    EditRequest,
    IndexRequest,
    NotSupportedEditRequest,
    PrimitiveEditRequest,
    Retdiff,
    Score,
    Weight,
)
from genjax_torch.gfi.gfn import (
    GenerativeFunction,
    GenerativeFunctionClosure,
    Trace,
)
from genjax_torch.gfi.mask import Mask
from genjax_torch.gfi.requests import (
    DiffAnnotate,
    EmptyRequest,
    Regenerate,
    Update,
)
from genjax_torch.gfi.selection import Selection
from genjax_torch.lang.distributions import *  # noqa: F401,F403
from genjax_torch.lang.distributions import __all__ as _dist_all
from genjax_torch.lang.static import (
    AddressReuse,
    Fn,
    MissingAddress,
    StaticRequest,
    StaticTrace,
    gen,
)
from genjax_torch.lang.combinators import *  # noqa: F401,F403
from genjax_torch.lang.combinators import __all__ as _comb_all
from genjax_torch.core import random  # noqa: E402
from genjax_torch import adev, inference, models, ops, parallel, utils  # noqa: E402,F401,E501
from genjax_torch.inference import (  # noqa: E402
    HMC,
    MALA,
    NUTS,
    EllipticalSlice,
    Rejuvenate,
    ess_autocorr,
    nuts_kernel,
    run_nuts,
    split_rhat,
)

#: Entry points of ``genjax_torch.entry`` reachable from the package
#: (``entry`` imports the package, so they load on first use).
_ENTRY_POINTS = ("build_nuts_regression", "build_nuts_logreg",
                 "build_slds_rbpf", "build_switch_mixture", "build_smc2",
                 "build_trace_pf", "build_data_smc", "build_adev_vi",
                 "build_bnn_vi", "build_svgd", "build_pt",
                 "build_map_laplace", "build_sharded_smc2",
                 "build_sharded_pt", "build_sharded_pgibbs")


def __getattr__(name):
    if name in _ENTRY_POINTS:
        from genjax_torch import entry

        return getattr(entry, name)
    raise AttributeError(f"module 'genjax_torch' has no attribute {name!r}")


#: ``S``: the selection builder.
S = Selection

__version__ = "0.1.0"

__all__ = [
    "AddressReuse",
    "Argdiffs",
    "C",
    "ChoiceMap",
    "ChoiceMapBuilder",
    "ChoiceMapNoValueAtAddress",
    "Closure",
    "PythonicPytree",
    "Const",
    "Diff",
    "DiffAnnotate",
    "EditRequest",
    "EllipticalSlice",
    "EmptyRequest",
    "FlagOp",
    "Fn",
    "GenerativeFunction",
    "GenerativeFunctionClosure",
    "HMC",
    "IndexRequest",
    "MALA",
    "Mask",
    "MissingAddress",
    "NUTS",
    "NoChange",
    "NotSupportedEditRequest",
    "PrimitiveEditRequest",
    "Pytree",
    "Regenerate",
    "Rejuvenate",
    "Retdiff",
    "S",
    "Score",
    "Selection",
    "StaticRequest",
    "StaticTrace",
    "Trace",
    "UnknownChange",
    "Update",
    "Weight",
    "build_nuts_logreg",
    "build_nuts_regression",
    "build_slds_rbpf",
    "build_switch_mixture",
    "do_checkify",
    "empty_trace",
    "empty_value",
    "optional_check",
    "to_shape_fn",
    "ess_autocorr",
    "gen",
    "adev",
    "inference",
    "models",
    "multi_switch",
    "nuts_kernel",
    "ops",
    "parallel",
    "utils",
    "random",
    "run_nuts",
    "split_rhat",
    "tree_choose",
    *_dist_all,
    *_comb_all,
]
