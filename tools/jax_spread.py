"""The JAX package's own Monte Carlo spread of the particle samplers'
log-evidence estimates, on the CPU over 8 keys, from which the port's
bounds against the exact oracles are derived (an estimate's sd falls as
one over the square root of its particles):

- SMC² (bench config 7's model and data) at ``--smc2`` sizes
  ``N_theta x N_x``, against the grid's log evidence;
- the trace-level particle filter on config 7's LGSSM over 50 steps, with
  and without the future refresh, against the Kalman log-likelihood;
- data-annealed SMC on the coins model (``--flips`` flips, one MH move of
  ``p`` a step), against the beta-bernoulli closed form. XLA compiles the
  unrolled schedule as one program, which at 32 flips takes tens of
  minutes and about 30 GB on the CPU; ``--eager`` runs it op by op
  instead (a few minutes a key at 4096 particles × 32 flips).

    JAX_PLATFORMS=cpu python3 tools/jax_spread.py [--keys 8] [--key0 1000] \
        [--eager] [--port]

Prints one JSON line a cell as it finishes (its size, the mean error and
the sd over the keys), then one line with them all. ``--smc2``,
``--trace-pf`` and ``--data-smc`` take comma-separated sizes; an empty
value skips the sampler. The keys are ``key(key0 + i)`` for ``i <
keys``. ``--port`` also runs the port's ``entry.build_trace_pf`` on the
CPU on the same keys, so that the two packages' spreads (and their means,
for a bias) are read side by side.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import genjax_tpu as g  # noqa: E402
from genjax_tpu.inference.data_smc import data_annealed_smc  # noqa: E402
from genjax_tpu.inference.smc2 import smc2  # noqa: E402
from genjax_tpu.inference.trace_pf import trace_particle_filter  # noqa: E402
from genjax_tpu.models.ssm import (  # noqa: E402
    kalman_filter,
    lgssm_grid_posterior,
    lgssm_model,
    simulate_lgssm_data,
)

A, Q, R, T = 0.7, 0.4, 0.4, 50


def _stats(errs):
    e = np.asarray(errs, np.float64)
    return {"mean_err": float(e.mean()), "sd": float(e.std(ddof=1)),
            "max_abs_err": float(np.abs(e).max())}


def _report(out: dict, name: str, errs) -> None:
    out[name] = _stats(errs)
    print(json.dumps({name: out[name]}), flush=True)


def _sizes(spec: str):
    return [v for v in spec.split(",") if v]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--keys", type=int, default=8)
    ap.add_argument("--key0", type=int, default=1000)
    ap.add_argument("--port", action="store_true",
                    help="the port's trace PF on the CPU on the same keys")
    ap.add_argument("--smc2", default="64x64,128x128")
    ap.add_argument("--trace-pf", default="2048")
    ap.add_argument("--data-smc", default="4096")
    ap.add_argument("--flips", type=int, default=8)
    ap.add_argument("--eager", action="store_true",
                    help="run data-annealed SMC without jax.jit")
    args = ap.parse_args()
    keys = [jax.random.key(args.key0 + i) for i in range(args.keys)]
    ys = simulate_lgssm_data(jax.random.key(11), A, Q, R, T)[1]
    out = {}

    _, _, log_ev = lgssm_grid_posterior(ys, Q, R,
                                        jnp.linspace(-0.949, 0.949, 191))
    model = (
        lambda key, a, n: jnp.sqrt(Q) * jax.random.normal(key, (n,)),
        lambda key, a, xs: a * xs + jnp.sqrt(Q) * jax.random.normal(
            key, xs.shape),
        lambda a, xs, y: jax.scipy.stats.norm.logpdf(y, xs, jnp.sqrt(R)),
        lambda key: jax.random.uniform(key, minval=-0.95, maxval=0.95),
        lambda a: jnp.where(jnp.abs(a) < 0.95, -jnp.log(1.9), -jnp.inf),
    )
    for size in _sizes(args.smc2):
        nt, nx = (int(v) for v in size.split("x"))
        run = jax.jit(smc2(*model, n_theta=nt, n_x=nx, proposal=0.15))
        errs = [float(run(k, ys).log_z) - float(log_ev) for k in keys]
        _report(out, f"smc2_{nt}x{nx}", errs)

    exact, _ = kalman_filter(ys, A, Q, R, mu0=0.0, p0=0.0)
    for n in (int(v) for v in _sizes(args.trace_pf)):
        for refresh in (False, True):
            run = jax.jit(trace_particle_filter(
                lgssm_model(A, Q, R, T), (0.0, None), "y", ys, n,
                refresh_future=refresh))
            errs = [float(run(k).log_z) - float(exact) for k in keys]
            _report(out, f"trace_pf_{n}_refresh_{refresh}", errs)
        if args.port:
            from genjax_torch import entry
            from genjax_torch.interop import key_from_numpy

            run, exact_t, _ = entry.build_trace_pf(n, device="cpu")
            errs = [float(run(key_from_numpy(np.asarray(
                jax.random.key_data(k)))).log_z) - exact_t for k in keys]
            _report(out, f"port_trace_pf_{n}_refresh_True", errs)

    nf = args.flips
    obs = [(True, True, False, True, True)[i % 5] for i in range(nf)]
    h = sum(obs)

    @g.gen
    def coins():
        p = g.beta(2.0, 2.0) @ "p"
        for i in range(nf):
            _ = g.flip(p) @ f"v{i}"

    closed = (math.lgamma(2 + h) + math.lgamma(2 + nf - h)
              - math.lgamma(4 + nf) - (2 * math.lgamma(2) - math.lgamma(4)))
    schedule = [g.C[f"v{i}"].set(o) for i, o in enumerate(obs)]
    for n in (int(v) for v in _sizes(args.data_smc)):
        run = data_annealed_smc(
            coins, (), schedule, n,
            make_request=lambda: g.Regenerate(g.S.at["p"]), n_moves=1)
        run = run if args.eager else jax.jit(run)
        errs = [float(run(k).log_z) - closed for k in keys]
        _report(out, f"data_smc_{n}_flips_{nf}", errs)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
