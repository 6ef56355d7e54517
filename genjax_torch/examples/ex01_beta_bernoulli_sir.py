"""README quickstart: Beta-Bernoulli posterior via K-particle SIR.

``ImportanceK.random_weighted`` runs on a batch of 50 keys at once (the
JAX program vmaps it over ``jax.random.split``; ``random.split`` gives
the same 50 keys), each drawing one posterior sample of ``p`` from 50
weighted particles."""

import torch

import genjax_torch as g
from genjax_torch.core import random
from genjax_torch.examples import resolve_device
from genjax_torch.inference import ImportanceK, Target


@g.gen
def beta_bernoulli(a, b):
    p = g.beta(a, b) @ "p"
    v = g.flip(p) @ "v"
    return v


def run_inference(obs: bool, device) -> torch.Tensor:
    target = Target(beta_bernoulli, (2.0, 2.0), g.C["v"].set(obs))
    alg = ImportanceK(target, k_particles=50)
    sub_keys = random.split(random.key(314159, device=device), 50)
    _, p_chm = alg.random_weighted(sub_keys, target)
    return p_chm["p"].mean()


def main(device=None) -> dict:
    device = resolve_device(device)
    return {"mean_true": float(run_inference(True, device)),
            "mean_false": float(run_inference(False, device))}


if __name__ == "__main__":
    r = main()
    print("E[p | v=True]  ≈", r["mean_true"], " (exact: 0.6)")
    print("E[p | v=False] ≈", r["mean_false"], "(exact: 0.4)")
