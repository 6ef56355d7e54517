"""The documented programs ex11 and ex12: each JAX program
(``docs/``) against its port in ``genjax_torch/examples``, on the CPU,
under the tolerances of ``genjax_torch.examples.specs`` (the mechanics:
``examples_harness``)."""

import pytest

from examples_harness import hold_program

NAMES = [
    "ex11_constrained_nuts",
    "ex12_particle_gibbs",
]


@pytest.mark.parametrize("name", NAMES)
def test_program_matches_jax(name):
    hold_program(name)
