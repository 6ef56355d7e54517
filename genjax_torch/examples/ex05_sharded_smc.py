"""Mesh-sharded SMC: particle axis over all ranks, logZ/ESS as
collectives.

The mesh is ``parallel.particle_mesh()`` over the ``torch.distributed``
world. Run as a module, the program starts a world of one on its device
(NCCL on the card, gloo on the CPU) unless a group is already up. To
spread the 2^16 particles over several processes, start the world
first, one process a rank, and call ``main`` from each:

- CPU: ``parallel.init_distributed(num_processes=4, process_id=rank,
  coordinator_address="localhost:29500", device="cpu")`` in 2-8
  processes (gloo);
- cards: ``torchrun --nproc-per-node=N`` and
  ``parallel.init_distributed()`` (NCCL, one card a rank).

The sharded step is bitwise layout-independent, so log Z does not depend
on the world's size."""

import genjax_torch as g
from genjax_torch.core import random
from genjax_torch.examples import resolve_device, world
from genjax_torch.inference import Target
from genjax_torch.parallel import particle_mesh, sharded_smc_step


@g.gen
def beta_bernoulli(a, b):
    p = g.beta(a, b) @ "p"
    v = g.flip(p) @ "v"
    return v


def main(device=None) -> dict:
    device = resolve_device(device)
    with world(device) as ranks:
        mesh = particle_mesh(device.type)
        target = Target(beta_bernoulli, (2.0, 2.0), g.C["v"].set(True))
        step = sharded_smc_step(target, 1 << 16, mesh)
        _, logz = step(random.key(0, device=device))
        return {"mesh": repr(mesh), "log_z": float(logz), "ranks": ranks}


if __name__ == "__main__":
    r = main()
    print("mesh:", r["mesh"])
    print("logZ:", r["log_z"], "(exact: log 0.5 = -0.693)")
    print("weights sharded over:", r["ranks"], "ranks")
