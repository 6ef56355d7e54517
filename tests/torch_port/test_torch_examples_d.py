"""The documented programs ex13 to ex15: each JAX program
(``docs/``) against its port in ``genjax_torch/examples``, on the CPU,
under the tolerances of ``genjax_torch.examples.specs`` (the mechanics:
``examples_harness``)."""

import pytest

from examples_harness import hold_program

NAMES = [
    "ex13_parameter_inference",
    "ex14_pod_scale_inference",
    "ex15_svgd_and_slice",
]


@pytest.mark.parametrize("name", NAMES)
def test_program_matches_jax(name):
    hold_program(name)
