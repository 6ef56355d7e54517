"""The documented programs cookbook 8 to 14: each JAX program
(``docs/``) against its port in ``genjax_torch/examples``, on the CPU,
under the tolerances of ``genjax_torch.examples.specs`` (the mechanics:
``examples_harness``)."""

import pytest

from examples_harness import hold_program

NAMES = [
    "cb08_marginals_and_stochastic_probabilities",
    "cb09_h100_performance",
    "cb10_ravi_stacks",
    "cb11_dirichlet_mixture_gibbs",
    "cb12_combinators",
    "cb13_exact_oracles",
    "cb14_smc2_joint_inference",
]


@pytest.mark.parametrize("name", NAMES)
def test_program_matches_jax(name):
    hold_program(name)
