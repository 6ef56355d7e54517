"""Cookbook 7 — Custom proposals: putting knowledge into inference.

Importance sampling with the prior as proposal wastes particles
wherever the posterior disagrees with the prior. Any generative
function can serve as a proposal instead: wrap it with ``.marginal()``
(making it a ``SampleDistribution`` over choice maps) and pass it as
``q`` to ``Importance``/``ImportanceK``. The proposal receives the
``Target`` as its argument, so it can READ the observations and aim.

The q-weighted SMC algebra is ``inference/smc.py``. The 2000 runs are
one call of ``run_smc`` on a batch of 2000 keys.
"""

import math

import torch

import genjax_torch as g
from genjax_torch.core import random
from genjax_torch.examples import resolve_device
from genjax_torch.inference import Importance, Target


# -- the model: conjugate normal-normal, so we know the exact answer ----
@g.gen
def model():
    x = g.normal(0.0, 1.0) @ "x"
    g.normal(x, 0.5) @ "y"
    return x


# -- proposal 1: the prior (what you get with q=None) --------------------
# -- proposal 2: reads the observation and aims near the posterior -------
@g.gen
def smart(target: Target):
    y = target["y"]                      # look at the data!
    return g.normal(0.8 * y, 0.5) @ "x"  # near-posterior (std slightly wide)


def main(device=None) -> dict:
    device = resolve_device(device)
    key = random.key(0, device=device)
    y_obs = 2.0
    target = Target(model, (), g.C["y"].set(torch.tensor(y_obs,
                                                         device=device)))
    # Exact posterior: x | y ~ N(y·0.8, sqrt(0.2));
    # logZ = log N(y; 0, sqrt(1.25)).
    exact_logz = float(g.normal.logpdf(torch.tensor(y_obs), 0.0,
                                       math.sqrt(1.25)))

    def logw_samples(q, n=2000):
        col = Importance(target, q=q).run_smc(random.split(key, n))
        return col.get_log_weights()[..., 0]

    out = {"exact_log_z": exact_logz}
    lws = {"prior": logw_samples(None),
           "smart": logw_samples(smart.marginal())}
    # Both are unbiased estimators of the SAME logZ...
    for name, lw in lws.items():
        logz = float(torch.logsumexp(lw, 0) - math.log(len(lw)))
        out[f"{name}_log_z"] = logz
        out[f"{name}_var"] = float(torch.var(lw, correction=0))
        assert abs(logz - exact_logz) < 0.1
    # ...but the aimed proposal's weights are far flatter — that variance
    # is exactly what ESS measures, and what costs you particles in SMC:
    assert out["smart_var"] < 0.25 * out["prior_var"]

    # The effective sample size tells the same story per-particle-budget:
    for name, lw in lws.items():
        w = torch.exp(lw - torch.logsumexp(lw, 0))
        out[f"{name}_ess_frac"] = float(1.0 / (torch.sum(w * w) * len(lw)))
    # A perfect proposal (the exact posterior) would give constant
    # weights (= logZ exactly, ESS 1.0). Proposals don't change WHAT you
    # estimate, only how many particles it takes.
    return out


if __name__ == "__main__":
    r = main()
    for name in ("prior", "smart"):
        print(f"{name:6s} logZ ≈ {r[name + '_log_z']:+.4f}  "
              f"(exact {r['exact_log_z']:+.4f})   var[log w] = "
              f"{r[name + '_var']:.3f}")
    print(f"ESS fraction: prior {r['prior_ess_frac']:.2f}, "
          f"smart {r['smart_ess_frac']:.2f}")
    print("ok")
