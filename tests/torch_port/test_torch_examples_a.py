"""The documented programs ex01 to ex05: each JAX program
(``docs/``) against its port in ``genjax_torch/examples``, on the CPU,
under the tolerances of ``genjax_torch.examples.specs`` (the mechanics:
``examples_harness``)."""

import pytest

from examples_harness import hold_program

NAMES = [
    "ex01_beta_bernoulli_sir",
    "ex02_state_space_pf",
    "ex03_nuts_regression",
    "ex04_variational_inference",
    "ex05_sharded_smc",
]


@pytest.mark.parametrize("name", NAMES)
def test_program_matches_jax(name):
    hold_program(name)
