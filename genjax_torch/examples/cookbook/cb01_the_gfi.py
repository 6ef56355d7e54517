"""Cookbook 1 — The Generative Function Interface, by hand.

Every model in genjax_torch is a *generative function*: a probabilistic
program with a small abstract interface (the GFI). Inference algorithms
are written once against this interface and work for any model. This
walkthrough exercises each method on one tiny model and checks the
weight identities that make SMC/MCMC/VI correct.

The GFI itself is defined in ``genjax_torch/gfi/gfn.py``.

Conventions (``gfi/concepts.py``):
- ``score``  = log P(all choices; args) — a density, not a bound.
- ``weight`` = the importance/edit weight; every method below documents
  its exact identity. Getting these right is what makes logZ estimates
  unbiased and MH acceptance ratios exact.

Where the JAX walkthrough jits and vmaps, the port runs one batched
call: a key batch ``B + (2,)`` runs ``B`` executions at once.
"""

import math

import torch

import genjax_torch as g
from genjax_torch.core import random
from genjax_torch.examples import resolve_device


@g.gen
def model(mu):
    x = g.normal(mu, 1.0) @ "x"      # latent
    y = g.normal(x, 0.5) @ "y"       # observed later
    return x + y


def norm_logpdf(v, mu, sd):
    return g.normal.logpdf(torch.as_tensor(v), mu, sd)


def main(device=None) -> dict:
    device = resolve_device(device)
    key = random.key(0, device=device)
    out = {}

    # -- simulate: sample a full trace from the prior --------------------
    tr = model.simulate(key, (0.0,))
    x, y = tr.get_choices()["x"], tr.get_choices()["y"]
    out.update(x=float(x), y=float(y))
    # The score is the joint log-density of ALL sampled choices:
    want = norm_logpdf(x, 0.0, 1.0) + norm_logpdf(y, x, 0.5)
    assert torch.allclose(tr.get_score(), want), "score = log P(x, y)"

    # -- assess: score a COMPLETE choice map (no randomness) -------------
    chm = g.C["x"].set(torch.tensor(1.0, device=device)) | g.C["y"].set(
        torch.tensor(0.5, device=device))
    score, retval = model.assess(chm, (0.0,))
    assert torch.allclose(score.cpu(), norm_logpdf(1.0, 0.0, 1.0)
                          + norm_logpdf(0.5, 1.0, 0.5))
    assert torch.allclose(retval.cpu(), torch.tensor(1.5))
    out["assess"] = float(score)

    # -- generate (importance): constrain some choices, sample the rest --
    # weight = log P(all choices) - log q(sampled | constrained). For
    # @gen models q is "ancestral sampling of the unconstrained sites",
    # so the weight telescopes to the density of the CONSTRAINED sites
    # under their local kernels — here just log P(y = 0.3 | x).
    obs = g.C["y"].set(torch.tensor(0.3, device=device))
    tr_c, w = model.generate(key, obs, (0.0,))
    x_c = tr_c.get_choices()["x"]
    assert torch.allclose(w, norm_logpdf(0.3, x_c, 0.5))
    out["generate"] = float(w)

    # -- update (edit): move a trace to new constraints ------------------
    # weight = log P(new choices) - log P(old choices) + (proposal terms
    # for any freshly sampled sites; none here). The discard holds the
    # replaced values, so the edit is reversible.
    new_tr, w_up, _retdiff, discard = model.update(
        key, tr, g.C["x"].set(torch.tensor(2.0, device=device)),
        g.Diff.no_change((0.0,)))
    assert torch.allclose(w_up, new_tr.get_score() - tr.get_score()), \
        "pure-update weight identity"
    assert torch.allclose(discard["x"], x), "discard holds the old value"
    out["update"] = float(w_up)

    # -- regenerate: resample selected sites from their priors -----------
    # The MH-within-Gibbs building block: weight = the (log) MH ratio for
    # the prior-proposal kernel. (Fresh key: edits derive per-site
    # randomness from the key you pass, deterministically.)
    re_tr, w_re, _rd, _bwd = tr.edit(random.key(42, device=device),
                                     g.Regenerate(g.S.at["x"]))
    assert bool(re_tr.get_choices()["y"] == y), "unselected sites keep values"
    out.update(regenerate_x=float(re_tr.get_choices()["x"]),
               regenerate_w=float(w_re))

    # -- project: the weight of forgetting selected choices --------------
    w_proj = tr.project(key, g.S.at["y"])
    assert torch.allclose(w_proj, norm_logpdf(y, x, 0.5))
    out["project"] = float(w_proj)

    # -- everything runs batched -----------------------------------------
    # 8192 importance samples in one call on a batch of 8192 keys:
    keys = random.split(key, 8192)
    _, ws = model.generate(keys, obs, (0.0,))
    logz = torch.logsumexp(ws, 0) - math.log(len(keys))
    # Exact marginal: y ~ N(0, sqrt(1 + 0.25)) under mu=0.
    exact = norm_logpdf(0.3, 0.0, math.sqrt(1.25))
    assert abs(float(logz) - float(exact)) < 1e-1, (logz, exact)
    out.update(is_log_z=float(logz), is_exact=float(exact))
    return out


if __name__ == "__main__":
    r = main()
    print("simulate:   x =", r["x"], " y =", r["y"])
    print("assess:     log P(x=1, y=0.5) =", r["assess"])
    print("generate:   weight = log P(y|x) =", r["generate"])
    print("update:     w =", r["update"], " (= new_score - old_score)")
    print("regenerate: new x =", r["regenerate_x"],
          " MH log-ratio =", r["regenerate_w"])
    print("project:    log P(y | rest) =", r["project"])
    print("batched IS: logZ ≈", r["is_log_z"], " (exact:", r["is_exact"], ")")
    print("ok")
