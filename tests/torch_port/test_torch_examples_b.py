"""The documented programs ex06 to ex10: each JAX program
(``docs/``) against its port in ``genjax_torch/examples``, on the CPU,
under the tolerances of ``genjax_torch.examples.specs`` (the mechanics:
``examples_harness``)."""

import pytest

from examples_harness import hold_program

NAMES = [
    "ex06_time_travel_debugging",
    "ex07_tempered_smc",
    "ex08_trace_level_pf",
    "ex09_smc_samplers",
    "ex10_state_space_vi",
]


@pytest.mark.parametrize("name", NAMES)
def test_program_matches_jax(name):
    hold_program(name)
