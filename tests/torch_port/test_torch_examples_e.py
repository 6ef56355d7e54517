"""The documented programs cookbook 1 to 7: each JAX program
(``docs/``) against its port in ``genjax_torch/examples``, on the CPU,
under the tolerances of ``genjax_torch.examples.specs`` (the mechanics:
``examples_harness``)."""

import pytest

from examples_harness import hold_program

NAMES = [
    "cb01_the_gfi",
    "cb02_choice_maps",
    "cb03_debugging",
    "cb04_speed_gains",
    "cb05_conditionals_and_masking",
    "cb06_custom_distributions",
    "cb07_custom_proposals",
]


@pytest.mark.parametrize("name", NAMES)
def test_program_matches_jax(name):
    hold_program(name)
