"""The six documented programs whose documented size takes minutes on
the CPU (ex03, ex10, ex11, ex12, ex13, ex15: they define ``REHEARSAL``
sizes), run live at that size: each JAX program against its port under
the tolerances of ``genjax_torch.examples.specs``, and the port's run
against its entry in ``examples/cpu_reference.json``. The tier-1 files
hold these programs through that reference and a live ``REHEARSAL`` run;
this file holds the current code itself to the JAX programs. Marked
slow: 40-250 s a program on a CPU host."""

import pytest

from examples_harness import hold_program

NAMES = [
    "ex03_nuts_regression",
    "ex10_state_space_vi",
    "ex11_constrained_nuts",
    "ex12_particle_gibbs",
    "ex13_parameter_inference",
    "ex15_svgd_and_slice",
]


@pytest.mark.slow
@pytest.mark.parametrize("name", NAMES)
def test_program_matches_jax_at_documented_size(name):
    hold_program(name, documented=True)
