"""Settings shared by the port's CPU tests.

torch's CPU ``exp``, on its first call in a process that runs on several
threads, now and then computes one thread's share of the elements with
an error near 1.5e-4 relative (torch 2.13, x86-64 with AVX-512: about
one process in eight, in one 4096-element chunk of a 32768-element
input). Later calls are exact to an ulp. That one call is enough to fail
the 1e-5 comparisons of the plain log-space product, so every test
process takes its first ``exp`` here, on an input no test reads. Nothing
else changes: the tests run the CPU kernels users run."""

import pytest
import torch


@pytest.fixture(scope="session", autouse=True)
def _first_exp_of_the_process():
    torch.exp(torch.zeros(1 << 16))
