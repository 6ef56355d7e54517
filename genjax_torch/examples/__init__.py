"""The documented programs of the JAX package, ported: ``docs/examples``
as ``exNN_<name>.py`` and ``docs/cookbook`` as ``cookbook/cbNN_<name>.py``.

Each keeps its JAX program's model, sizes, seeds and prose, written in
the port's idiom: a key batch ``B + (2,)`` from
:mod:`genjax_torch.core.random` where the JAX program vmaps over keys,
an explicit ``device``, plain eager calls where it jits. Each exposes
``main(device=None) -> dict`` of the quantities its JAX program prints
as results and prints them under the same labels when run as a module::

    python -m genjax_torch.examples.ex01_beta_bernoulli_sir   # on the card
    python -c "from genjax_torch.examples import ex01_beta_bernoulli_sir \\
        as m; print(m.main(device='cpu'))"                     # on the CPU

``device=None`` means the CUDA card, and raises where there is none:
pass ``device="cpu"`` to run on the CPU.
"""

from __future__ import annotations

import contextlib

import torch

from genjax_torch.entry import _device as resolve_device

__all__ = ["resolve_device", "world", "run_program", "module_name",
           "EXAMPLES", "COOKBOOK"]

#: The module names of the ported programs, in the order of the docs.
EXAMPLES = (
    "ex01_beta_bernoulli_sir", "ex02_state_space_pf", "ex03_nuts_regression",
    "ex04_variational_inference", "ex05_sharded_smc",
    "ex06_time_travel_debugging", "ex07_tempered_smc",
    "ex08_trace_level_pf", "ex09_smc_samplers", "ex10_state_space_vi",
    "ex11_constrained_nuts", "ex12_particle_gibbs",
    "ex13_parameter_inference", "ex14_pod_scale_inference",
    "ex15_svgd_and_slice",
)
COOKBOOK = (
    "cb01_the_gfi", "cb02_choice_maps", "cb03_debugging", "cb04_speed_gains",
    "cb05_conditionals_and_masking", "cb06_custom_distributions",
    "cb07_custom_proposals", "cb08_marginals_and_stochastic_probabilities",
    "cb09_h100_performance", "cb10_ravi_stacks",
    "cb11_dirichlet_mixture_gibbs", "cb12_combinators", "cb13_exact_oracles",
    "cb14_smc2_joint_inference",
)


@contextlib.contextmanager
def world(device: torch.device):
    """The ``torch.distributed`` world the sharded programs run in: the
    caller's, if a group is up; else a world of one on ``device`` (NCCL on
    the card, gloo on the CPU), destroyed on exit."""
    import torch.distributed as dist

    from genjax_torch.parallel import init_distributed

    own = not dist.is_initialized()
    if own:
        init_distributed(num_processes=1, device=device.type)
    try:
        yield dist.get_world_size()
    finally:
        if own:
            dist.destroy_process_group()


def module_name(name: str) -> str:
    """The importable module of a program of :data:`EXAMPLES` or
    :data:`COOKBOOK`."""
    pkg = "genjax_torch.examples" + (".cookbook" if name.startswith("cb")
                                     else "")
    return f"{pkg}.{name}"


def run_program(name: str, device=None, sizes: dict | None = None) -> dict:
    """Run one program's ``main`` and report what it cost: ``{"result":
    main's dict, "wall_s": its wall on the host clock (the card's work
    synchronized at the end), "launches": each kernel wrapper's launches
    during the run}``. ``sizes`` overrides entries of the program's
    ``SIZES`` for this run (a smaller rehearsal; the documented sizes
    otherwise)."""
    import importlib
    import time

    from genjax_torch.ops import cdf_counts, expand_adaptive, fused_step
    from genjax_torch.ops import logmatmul

    wrappers = {"cdf_counts": cdf_counts.systematic_cumulative,
                "fused_step": fused_step.fused_step,
                "log_matmul": logmatmul.log_matmul,
                "expand_adaptive": expand_adaptive.expand_adaptive}
    mod = importlib.import_module(module_name(name))
    saved = dict(getattr(mod, "SIZES", {}))
    if sizes:
        unknown = set(sizes) - set(saved)
        if unknown:
            raise KeyError(f"{name} has no sizes {sorted(unknown)}")
        mod.SIZES.update(sizes)
    dev = resolve_device(device)
    before = {k: w.launches for k, w in wrappers.items()}
    try:
        t0 = time.perf_counter()
        result = mod.main(device=dev)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
    finally:
        if sizes:
            mod.SIZES.clear()
            mod.SIZES.update(saved)
    return {"result": result, "wall_s": wall,
            "launches": {k: w.launches - before[k]
                         for k, w in wrappers.items()}}
