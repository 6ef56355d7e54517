"""Pod-scale inference patterns: three pieces on one world.

1. the explicit-collective sharded particle filter — deterministic
   blocked reductions + halo-exchange resampling, bitwise identical on
   ANY layout of ranks;
2. chains-sharded warmup-adapted NUTS — cross-chain adaptation rides
   deterministic collectives, so results equal the single-process run;
3. elastic recovery — re-laying a whole ensemble onto a shrunken world
   with ``mesh_place``.

The world is ``torch.distributed``'s. Run as a module, the program
starts a world of one on its device (NCCL on the card, gloo on the
CPU). To spread it, start 2-8 ranks first and call ``main`` from each:
``parallel.init_distributed(num_processes=n, process_id=rank,
coordinator_address="localhost:29500", device="cpu")`` (gloo), or
``torchrun --nproc-per-node=n`` and ``parallel.init_distributed()``
(NCCL, one card a rank). Every result here is bitwise independent of
the world's size. In a world of one the shrunken world is the same one
rank (the JAX program halves its device list).
"""

import math

import torch

import genjax_torch as g
from genjax_torch.core import random
from genjax_torch.examples import resolve_device, world
from genjax_torch.inference import Target, run_nuts
from genjax_torch.parallel import (
    gather_leading_axis,
    particle_mesh,
    sharded_particle_filter,
)
from genjax_torch.utils.failure import mesh_place

LOG_SQRT_2PI = 0.5 * math.log(2 * math.pi)
#: The documented sizes: filter particles; NUTS chains, warmup, samples.
SIZES = {"particles": 1 << 14, "chains": 64, "warmup": 50, "samples": 50}


def init(keys):
    return random.normal(keys), torch.zeros((), device=keys.device)


def step(keys, x, y):
    x_new = 0.9 * x + 0.3 * random.normal(keys)
    return x_new, -0.5 * ((y - x_new) / 0.5) ** 2 - math.log(0.5) \
        - LOG_SQRT_2PI


@g.gen
def hier():
    mu = g.normal(0.0, 1.0) @ "mu"
    tau = g.normal(0.0, 1.0) @ "tau"
    _ = g.normal(mu, torch.exp(tau)) @ "y"


def sharded_filter_demo(device, ranks: int) -> dict:
    mesh = particle_mesh(device.type)
    ys = torch.tensor([0.1, -0.2, 0.3, 0.0, 0.4], device=device)
    key = random.key(0, device=device)
    pf = sharded_particle_filter(init, step, SIZES["particles"], mesh)
    final, _ = pf(key, ys)
    # The product path is bitwise layout-independent: a one-rank mesh
    # gives the same bits. In a world of one the world's mesh is that
    # mesh, and a second run must repeat the first bit for bit; larger
    # worlds are held to the one-rank bits by the port's gloo-world
    # tests (tests/torch_port/test_torch_sharded_smc.py).
    if ranks == 1:
        final1, _ = pf(key, ys)
        same = bool(torch.equal(final.log_z, final1.log_z))
        assert same
    else:
        same = None
    whole = gather_leading_axis(final, mesh)
    return {"pf_log_z": float(final.log_z), "pf_ranks": ranks,
            "bitwise_one_rank": same, "_final": whole}


def sharded_nuts_demo(device, ranks: int) -> dict:
    target = Target(hier, (), g.C["y"].set(torch.tensor(1.0, device=device)))
    mesh = particle_mesh(device.type, "chains")
    chms, _ = run_nuts(target, random.key(1, device=device),
                       n_chains=SIZES["chains"], num_warmup=SIZES["warmup"],
                       num_samples=SIZES["samples"], max_depth=5, mesh=mesh)
    mu = gather_leading_axis(chms["mu"], mesh, "chains")
    return {"nuts_mu_mean": round(float(mu.mean()), 3), "nuts_ranks": ranks}


def elastic_demo(final, ranks: int) -> dict:
    devs = [torch.device(final.log_weights.device)] * ranks
    half = devs[: max(1, len(devs) // 2)]
    placed = mesh_place("particles")(final, half)
    return {"elastic_from": ranks, "elastic_to": len(half),
            "values_unchanged": bool(torch.equal(
                gather_leading_axis(placed.log_weights, particle_mesh(
                    final.log_weights.device.type)),
                final.log_weights))}


def main(device=None) -> dict:
    device = resolve_device(device)
    with world(device) as ranks:
        out = sharded_filter_demo(device, ranks)
        out.update(sharded_nuts_demo(device, ranks))
        out.update(elastic_demo(out.pop("_final"), ranks))
    return out


if __name__ == "__main__":
    r = main()
    print("sharded PF logZ:", r["pf_log_z"], "on", r["pf_ranks"], "ranks")
    print("bitwise equal on a one-rank mesh:", r["bitwise_one_rank"])
    print("sharded NUTS: mu posterior mean", r["nuts_mu_mean"],
          "- chains over", r["nuts_ranks"], "ranks")
    print("elastic down-shift:", r["elastic_from"], "->", r["elastic_to"],
          "ranks;", "values unchanged:", r["values_unchanged"])
