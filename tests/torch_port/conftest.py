"""Settings shared by the port's CPU tests.

torch's CPU ``exp``, on its first call in a process that runs on several
threads, now and then computes one thread's share of the elements with
an error near 1.5e-4 relative (torch 2.13, x86-64 with AVX-512: about
one process in eight, in one 4096-element chunk of a 32768-element
input). Later calls are exact to an ulp. That one call is enough to fail
the 1e-5 comparisons of the plain log-space product, so every test
process takes its first ``exp`` here, on an input no test reads. Nothing
else changes: the tests run the CPU kernels users run.

The distributed tests run their ranks in gloo worlds of spawned
processes (``gloo_worlds``, ``torch_dist_world.py``), each rank on one
intra-op thread and through the same first ``exp``."""

import pytest
import torch


@pytest.fixture(scope="session", autouse=True)
def _first_exp_of_the_process():
    torch.exp(torch.zeros(1 << 16))


@pytest.fixture(scope="module")
def gloo_worlds(tmp_path_factory):
    """``get(size)``: this test module's gloo world of ``size`` processes
    (``torch_dist_world.World``), started on first use and reused by every
    test of the module; all are closed when the module ends."""
    from torch_dist_world import World

    store = tmp_path_factory.mktemp("gloo")
    worlds = {}

    def get(size: int) -> World:
        if size not in worlds:
            worlds[size] = World(size, str(store))
        return worlds[size]

    yield get
    for w in worlds.values():
        w.close()
