"""Cookbook 11 — Block-Gibbs on a Dirichlet mixture model.

A realistic end-to-end application: cluster N points on the real line
with a K-component Gaussian mixture — Dirichlet prior on the weights,
Gaussian prior on each cluster mean, a categorical assignment per
point — and infer by block Gibbs sampling, where each block's exact
conditional draw is written into the trace with a whole-lane ``Update``.

What this exercises: ``dirichlet``, the ``repeat`` combinator (N iid
assignment/observation pairs as one vectorized site), whole-lane
Indexed constraints (``C["pts", torch.arange(N), "z"].set(...)`` edits
every lane in one O(N) update), and the GFI edit loop as the engine of
a Gibbs sampler — the conditionals are computed OUTSIDE the model (in
plain PyTorch) and the trace is the single source of truth for the
state. On the card the N and K axes are ordinary tensor axes.
"""

import numpy as np
import torch

import genjax_torch as g
from genjax_torch.core import random
from genjax_torch.examples import resolve_device

N, K = 240, 3
SIGMA = 0.6          # known observation noise
TAU = 10.0           # prior std of cluster means
TRUE_MUS = np.array([-4.0, 0.0, 5.0])
TRUE_W = np.array([0.5, 0.3, 0.2])


@g.gen
def point(weights, mus):
    zi = g.categorical(torch.log(weights)) @ "z"
    _ = g.normal(torch.gather(mus, -1, zi[..., None])[..., 0], SIGMA) @ "x"


@g.gen
def dpmm():
    ones = torch.ones(K)
    weights = g.dirichlet(ones) @ "weights"   # symmetric Dirichlet prior
    mus = g.mv_normal_diag(torch.zeros(K), TAU * ones) @ "mus"
    _ = point.repeat(n=N)(weights, mus) @ "pts"


def _norm_logpdf(x, mu, sd):
    return g.normal.logpdf(x, mu, sd)


def main(device=None) -> dict:
    device = resolve_device(device)
    key = random.key(0, device=device)
    # -- synthetic data --------------------------------------------------
    rng = np.random.default_rng(7)
    true_z = rng.choice(K, size=N, p=TRUE_W)
    xs = torch.tensor(TRUE_MUS[true_z] + SIGMA * rng.standard_normal(N),
                      dtype=torch.float32, device=device)
    idx = torch.arange(N, device=device)
    onehot_k = torch.arange(K, device=device)
    alpha = torch.ones(K, device=device)

    # -- initialize a trace consistent with the observations -------------
    tr, _ = dpmm.generate(key, g.C["pts", idx, "x"].set(xs), ())

    def gibbs_sweep(tr, key):
        k_z, k_mu, k_w = random.split(key, 3).unbind(-2)
        chm = tr.get_choices()
        weights, mus = chm["weights"], chm["mus"]
        # Block 1: assignments | weights, means — exact categorical
        # posterior per point, all N lanes at once.
        logits = torch.log(weights)[None, :] + _norm_logpdf(
            xs[:, None], mus[None, :], SIGMA)
        z_new = random.categorical(k_z, logits)
        tr, _, _, _ = tr.update(k_z, g.C["pts", idx, "z"].set(z_new))
        # Block 2: means | assignments — conjugate normal per cluster.
        onehot = (z_new[:, None] == onehot_k[None, :]).to(torch.float32)
        counts = onehot.sum(0)
        sums = (onehot * xs[:, None]).sum(0)
        post_var = 1.0 / (1.0 / TAU ** 2 + counts / SIGMA ** 2)
        post_mean = post_var * (sums / SIGMA ** 2)
        mus_new = post_mean + torch.sqrt(post_var) * random.normal(k_mu, (K,))
        tr, _, _, _ = tr.update(k_mu, g.C["mus"].set(mus_new))
        # Block 3: weights | assignments — Dirichlet posterior.
        w_new = random.dirichlet(k_w, alpha + counts)
        tr, _, _, _ = tr.update(k_w, g.C["weights"].set(w_new))
        return tr

    for i in range(60):
        tr = gibbs_sweep(tr, random.fold_in(key, i))

    chm = tr.get_choices()
    mus_np = chm["mus"].cpu().numpy()
    mus_hat = np.sort(mus_np)
    w_hat = chm["weights"].cpu().numpy()
    order = np.argsort(mus_np)
    # Cluster means recovered (label-permutation-invariant).
    assert np.abs(mus_hat - TRUE_MUS).max() < 0.3, mus_hat
    # Weights recovered.
    assert np.abs(w_hat[order] - TRUE_W).max() < 0.12, w_hat[order]
    # Assignment accuracy after aligning labels.
    z_hat = chm["pts", :, "z"].cpu().numpy()
    relabel = np.empty(K, int)
    relabel[order] = np.arange(K)
    acc = float((relabel[z_hat] == true_z).mean())
    assert acc > 0.93, acc
    # The trace stays internally consistent: its score re-assesses.
    score, _ = dpmm.assess(chm, ())
    assert np.isfinite(float(score))
    return {"mus": mus_hat.tolist(), "weights": w_hat[order].tolist(),
            "acc": acc}


if __name__ == "__main__":
    r = main()
    print("cookbook 11 ok:", np.asarray(r["mus"]), np.asarray(r["weights"]),
          f"acc={r['acc']:.3f}")
