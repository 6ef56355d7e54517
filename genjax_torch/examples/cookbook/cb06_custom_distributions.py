"""Cookbook 6 — Custom distributions.

Any (sampler, log-density) pair becomes a first-class distribution with
``exact_density``: usable at ``@ "addr"`` sites, scored exactly in
assess/importance/edit, and (with a ``support`` spec) automatically
transformed for gradient-based inference. Implementation
``lang/distributions/distribution.py``.

The sampler draws one value per key of a key batch: ``uniform(key, ())``
gives the batch's shape, so the same code serves one key and 4096.
"""

import math

import torch

import genjax_torch as g
from genjax_torch.core import random
from genjax_torch.examples import resolve_device


# -- a Kumaraswamy(a, b) distribution, absent from the stdlib ------------
# sampler: inverse-CDF of U(0,1); logpdf: closed form. Both are plain
# PyTorch code.
def _kuma_sample(key, a, b):
    u = random.uniform(key, ())
    return (1.0 - (1.0 - u) ** (1.0 / b)) ** (1.0 / a)


def _kuma_logpdf(x, a, b):
    x = torch.as_tensor(x)
    return (math.log(a) + math.log(b) + (a - 1.0) * torch.log(x)
            + (b - 1.0) * torch.log1p(-(x ** a)))


# `support="unit_interval"` tells gradient samplers (NUTS with
# transforms="auto") to run in logit space automatically.
kumaraswamy = g.exact_density(
    _kuma_sample, _kuma_logpdf, name="kumaraswamy", support="unit_interval")


@g.gen
def coin_model():
    p = kumaraswamy(2.0, 3.0) @ "p"     # prior on the coin's bias
    heads = g.binomial(20.0, p) @ "heads"
    return heads


def main(device=None) -> dict:
    device = resolve_device(device)
    key = random.key(0, device=device)
    # Sanity: density integrates to 1 (trapezoid on a grid).
    xs = torch.linspace(1e-4, 1 - 1e-4, 4001, device=device)
    mass = torch.trapezoid(torch.exp(_kuma_logpdf(xs, 2.0, 3.0)), xs)
    assert abs(float(mass) - 1.0) < 1e-3

    # -- use it in a model like any stdlib distribution ----------------------
    tr = coin_model.simulate(key, ())
    prior_p = float(tr.get_choices()["p"])

    # Posterior over p given 17 heads out of 20, by importance sampling:
    obs = g.C["heads"].set(torch.tensor(17.0, device=device))
    keys = random.split(key, 4096)
    trs, ws = coin_model.generate(keys, obs, ())
    w = torch.exp(ws - torch.logsumexp(ws, 0))
    post_mean = float(torch.sum(w * trs.get_choices()["p"]))
    assert 0.6 < post_mean < 0.95
    # -- stochastic densities ------------------------------------------------
    # When the density itself is intractable but unbiasedly *estimable*
    # (marginals of bigger models), use `.marginal()` — see cookbook 08.
    return {"mass": float(mass), "prior_p": prior_p, "post_mean": post_mean}


if __name__ == "__main__":
    r = main()
    print("∫ pdf =", r["mass"])
    print("prior draw p =", r["prior_p"])
    print("E[p | 17/20 heads] ≈", r["post_mean"])
    print("ok")
