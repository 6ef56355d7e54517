"""Cookbook 12 — The combinator zoo: structured models from small parts.

One tour of ``vmap``, ``scan`` and the iterate family, ``mix``, and
``dimap``: every combinator takes a generative function and returns a
generative function, so they nest freely. In the port each runs its
lanes or steps over whole tensors: ``vmap`` and ``repeat`` put the lane
axis behind the key batch, ``scan`` loops over its steps in Python,
``switch``/``mix`` select with ``torch.where``, and ``dimap`` is plain
function composition.
"""

import torch

import genjax_torch as g
from genjax_torch.core import random
from genjax_torch.examples import resolve_device


# -- vmap: one kernel, many sites -----------------------------------------
@g.gen
def measure(mu):
    return g.normal(mu, 0.1) @ "y"


# -- scan & the iterate family: sequences --------------------------------
@g.gen
def walk_step(prev, _):
    x = g.normal(prev, 1.0) @ "x"
    return x, x


@g.gen
def decay(x):
    return g.normal(0.5 * x, 0.01) @ "x"


# -- mix: mixture models in one line --------------------------------------
@g.gen
def left():
    return g.normal(-2.0, 0.5) @ "v"


@g.gen
def right():
    return g.normal(2.0, 0.5) @ "v"


# -- dimap / map / contramap: adapters around a kernel ---------------------
@g.gen
def std_normal():
    return g.normal(0.0, 1.0) @ "z"


def to_loc_scale(z):
    return 3.0 + 0.5 * z


def main(device=None) -> dict:
    device = resolve_device(device)
    key = random.key(0, device=device)
    out = {}

    panel = measure.vmap(in_axes=0)           # one address space per lane
    mus = torch.arange(4.0, device=device)
    tr = panel.simulate(key, (mus,))
    out["lane_2"] = float(tr.get_choices()[2, "y"])
    out["all_lanes"] = tr.get_choices()[:, "y"].tolist()   # full-slice read
    # Scores sum over lanes; constraints address single lanes:
    _, w = panel.generate(key, g.C[1, "y"].set(torch.tensor(1.0,
                                                            device=device)),
                          (mus,))
    out["lane_1_weight"] = float(w)
    # `repeat` is vmap over a dummy index — i.i.d. replicas of a model:
    reps = measure.repeat(n=3)
    out["iid"] = reps.simulate(key, (0.0,)).get_choices()[:, "y"].tolist()

    chain = walk_step.scan(n=5)               # (carry, xs) -> (carry, ys)
    tr = chain.simulate(key, (0.0, None))
    _, path = tr.get_retval()
    out["path"] = path.tolist()
    # Variants derived from scan:
    # - accumulate: keep every carry (prepends the initial one)
    # - iterate:    apply a kernel n times, keep the trajectory
    # - reduce:     keep only the final carry
    out["iterate"] = decay.iterate(n=4).simulate(key, (8.0,))\
        .get_retval().tolist()
    out["final"] = float(decay.iterate_final(n=4).simulate(key, (8.0,))
                         .get_retval())

    mixture = g.mix(left, right)
    # Args: (mixture logits, branch-0 args, branch-1 args).
    tr = mixture.simulate(key, (torch.log(torch.tensor([0.3, 0.7],
                                                       device=device)),
                                (), ()))
    out["mixture_draw"] = float(tr.get_retval())
    # The component indicator lives at "mixture_component":
    comp = tr.get_choices()["mixture_component"]
    comp = comp.unmask() if isinstance(comp, g.Mask) else comp
    out["component"] = int(comp)

    # contramap: transform the ARGUMENTS before the kernel sees them.
    # map:       transform the RETURN VALUE after.
    # dimap:     both. Scores/choices pass through untouched.
    scaled = std_normal.map(to_loc_scale)      # non-centered parameterization
    tr = scaled.simulate(key, ())
    z = tr.get_choices()["z"]
    assert torch.allclose(tr.get_retval(), 3.0 + 0.5 * z)
    out["non_centered"] = float(tr.get_retval())
    # contramap adapts calling conventions — e.g. make `measure` take a
    # config dict instead of a bare float:
    cfg_measure = measure.contramap(lambda cfg: (cfg["mu"],))
    out["contramapped"] = float(cfg_measure.simulate(
        key, ({"mu": 1.5},)).get_retval())

    # -- everything nests --------------------------------------------------
    # A vmapped scan — still one address space: (lane, step, "x").
    fleet = walk_step.scan(n=4).vmap(in_axes=(0, None))
    tr = fleet.simulate(key, (torch.zeros(3, device=device), None))
    out["fleet_shape"] = tuple(tr.get_retval()[1].shape)
    out["fleet_1_2"] = float(tr.get_choices()[1, 2, "x"])
    return out


if __name__ == "__main__":
    r = main()
    print("lane 2 draw:", r["lane_2"])
    print("all lanes:  ", r["all_lanes"])
    print("lane-1 constraint weight:", r["lane_1_weight"])
    print("3 iid draws:", r["iid"])
    print("random-walk path:", r["path"])
    print("iterate:", r["iterate"])
    print("final:  ", r["final"])
    print("mixture draw:", r["mixture_draw"])
    print("picked component:", r["component"])
    print("non-centered draw:", r["non_centered"])
    print("contramapped:", r["contramapped"])
    print("fleet paths shape:", r["fleet_shape"])
    print("lane 1, step 2:", r["fleet_1_2"])
