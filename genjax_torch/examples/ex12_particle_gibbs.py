"""Particle Gibbs: exact joint smoothing posteriors by iterated
conditional SMC — array-level PGAS and the GFI-native trace version,
both checked against the exact RTS smoother.

The array-level kernels take one key and the whole particle row
(``init(k, n) -> (n,)``, ``prop(k, xs) -> xs'``); the trace version runs
the ``@gen`` Scan's particles as one key batch."""

import math

import torch

import genjax_torch as g
from genjax_torch.core import random
from genjax_torch.examples import resolve_device
from genjax_torch.inference import particle_gibbs, trace_particle_gibbs
from genjax_torch.models import kalman_smoother, simulate_lgssm_data

A, Q, R, T = 0.9, 0.5, 0.5, 10
#: The documented sizes: particles, sweeps of each sampler, burn-in.
SIZES = {"particles": 64, "pgas_sweeps": 300, "trace_sweeps": 300,
         "burn": 50}
#: A smaller run of the same program (the CPU tests' live run and the
#: card's smoke run, where the documented size takes minutes).
REHEARSAL = {"pgas_sweeps": 30, "trace_sweeps": 4, "burn": 2}


def _norm_logpdf(x, mu, sd):
    return -0.5 * ((x - mu) / sd) ** 2 - math.log(sd) - 0.5 * math.log(
        2 * math.pi)


@g.gen
def step(carry, _):
    prev = carry
    z = g.normal(A * prev, math.sqrt(Q)) @ "x"
    g.normal(z, math.sqrt(R)) @ "y"
    return z, z


def main(device=None) -> dict:
    device = resolve_device(device)
    _, ys = simulate_lgssm_data(random.key(7, device=device), A, Q, R, T)

    # --- array-level PGAS: hand-written kernels, ancestor sampling ----
    def init(k, n):
        return math.sqrt(A * A + Q) * random.normal(k, (n,))

    def prop(k, xs):
        return A * xs + math.sqrt(Q) * random.normal(k, xs.shape)

    def ll(xs, y):
        return _norm_logpdf(y, xs, math.sqrt(R))

    def tl(xp, xn):
        return _norm_logpdf(xn, A * xp, math.sqrt(Q))

    run = particle_gibbs(init, prop, ll, SIZES["particles"],
                         SIZES["pgas_sweeps"], trans_logpdf=tl)
    res = run(random.key(314159, device=device), ys)
    paths = res.paths[SIZES["burn"]:]
    _, mu_s, _ = kalman_smoother(ys, A, Q, R)
    out = {"pgas_err": float((paths.mean(0) - mu_s).abs().max())}

    # --- GFI-native: the model is a @gen Scan, no kernels -------------
    trun = trace_particle_gibbs(step.scan(n=T), (0.0, None), "y", ys,
                                ("x",), SIZES["particles"],
                                SIZES["trace_sweeps"])
    tres = trun(random.key(314159, device=device))
    tpaths = tres.paths["x"][SIZES["burn"]:]
    _, mu_s0, _ = kalman_smoother(ys, A, Q, R, mu0=0.0, p0=0.0)
    out["trace_pg_err"] = float((tpaths.mean(0) - mu_s0).abs().max())
    return out


if __name__ == "__main__":
    r = main()
    print("PGAS max |mean - RTS|:", r["pgas_err"])
    print("trace-PG max |mean - RTS|:", r["trace_pg_err"])
