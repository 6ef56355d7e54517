"""CPU readings from which the card's bounds for configs 5, 9 and 10 and
MAP / Laplace come (``chip_smoke.py`` phases 24-27):

- ``--svgd-keys``: the JAX package's config 10 (``run_all.py``'s program:
  SVGD, 4096 particles x 600 steps, step 0.05, h_rows 256, on the
  1024 x 64 Bayesian linear regression) on each key: max |ensemble mean
  − exact posterior mean|, the exact mean from a float64 solve. About
  4.5 TFLOP, a few minutes a key;
- ``--sharded-svgd-keys``: the same fit through the JAX package's
  ``parallel.run_sharded_svgd`` (its bandwidth from the strided
  subsample by explicit differences) on a one-device mesh, from
  ``run_svgd``'s prior draws: the spread of the sharded fit that phase
  28g holds the port's to;
- ``--map``: the JAX package's ``map_optimize(include_jacobian=True)``
  (Adam 1e-2, ``--map-steps`` steps) and ``laplace_approximation`` on the
  same regression: the MAP, covariance and log Z against the float64
  closed form;
- ``--config5``: config 5 at 64 fits x 10 steps, in the JAX package and in
  the port: each fit's first gradient against ``4 v0`` and the final
  ``v`` against ``v0 (1 − 4e-3)^10``;
- ``--config9``: the port's config 9 at a reduced width (``--c9-width
  din,dh,b``, 500 steps): the 16-sample −ELBO at step 0 and after, and
  mean |mu1|.

    JAX_PLATFORMS=cpu python3 tools/vi_bounds.py --svgd-keys 12 --map \
        --config5 --config9

Prints one JSON line a reading as it finishes.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def _emit(record: dict):
    print(json.dumps(record), flush=True)


def _blr_jax(b: int = 1024, d: int = 64):
    import jax
    import jax.numpy as jnp

    import genjax_tpu as g
    from genjax_tpu.inference import Target

    x = jax.random.normal(jax.random.key(10), (b, d)) / jnp.sqrt(float(d))
    y = x @ jnp.linspace(-1.0, 1.0, d) + 0.25 * jax.random.normal(
        jax.random.key(11), (b,))

    @g.gen
    def blr(X):
        w = g.mv_normal_diag(jnp.zeros(d), jnp.ones(d)) @ "w"
        _ = g.mv_normal_diag(X @ w, 0.25 * jnp.ones(b)) @ "y"

    xd, yd = np.asarray(x, np.float64), np.asarray(y, np.float64)
    prec = np.eye(d) + xd.T @ xd / 0.0625
    cov = np.linalg.inv(prec)
    mean = np.linalg.solve(prec, xd.T @ yd / 0.0625)
    marg = 0.0625 * np.eye(b) + xd @ xd.T
    _, logdet = np.linalg.slogdet(marg)
    log_z = -0.5 * (yd @ np.linalg.solve(marg, yd) + logdet
                    + b * np.log(2 * np.pi))
    return Target(blr, (x,), g.C["y"].set(y)), {"mean": mean, "cov": cov,
                                                "log_z": float(log_z)}


def svgd_reading(key: int, parts: int, steps: int):
    import jax
    import jax.numpy as jnp

    from genjax_tpu.inference import run_svgd

    target, exact = _blr_jax()
    t0 = time.perf_counter()
    ens = jax.jit(lambda k: jnp.mean(run_svgd(
        target, k, n_particles=parts, n_steps=steps, step_size=0.05,
        h_rows=256)["w"], axis=0))(jax.random.key(key))
    err = float(np.max(np.abs(np.asarray(ens, np.float64) - exact["mean"])))
    _emit({"reading": "svgd_jax", "key": key, "particles": parts,
           "steps": steps, "post_mean_err": err,
           "seconds": time.perf_counter() - t0})


def sharded_svgd_reading(key: int, parts: int, steps: int):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from genjax_tpu.gfi.choice_map import ChoiceMap
    from genjax_tpu.parallel.svgd import run_sharded_svgd

    target, exact = _blr_jax()
    (x,) = target.args
    y = target.constraint["y"]
    mesh = Mesh(np.asarray(jax.devices()[:1]), ("particles",))

    def logp(w):
        # The joint's log density up to a constant (the gradient SVGD
        # reads): w ~ N(0, I), y ~ N(x w, 0.25^2).
        return -0.5 * jnp.sum(w * w) - 0.5 * jnp.sum(
            (y - x @ w) ** 2) / 0.0625

    def fit(k):
        k_init, _ = jax.random.split(k)
        keys = jax.vmap(lambda c: jax.random.fold_in(k_init, c))(
            jnp.arange(parts))
        w0 = jax.vmap(lambda kk: target.importance(
            kk, ChoiceMap.empty())[0].get_choices()["w"])(keys)
        ens = run_sharded_svgd(logp, w0, steps, 0.05, mesh, h_rows=256)
        return jnp.mean(ens, axis=0)

    t0 = time.perf_counter()
    ens = jax.jit(fit)(jax.random.key(key))
    err = float(np.max(np.abs(np.asarray(ens, np.float64) - exact["mean"])))
    _emit({"reading": "sharded_svgd_jax", "key": key, "particles": parts,
           "steps": steps, "post_mean_err": err,
           "seconds": time.perf_counter() - t0})


def map_reading(n_steps: int):
    import jax

    from genjax_tpu.inference.map_laplace import (
        laplace_approximation,
        map_optimize,
    )

    target, exact = _blr_jax()
    res = jax.jit(lambda k: map_optimize(k, target, n_steps=n_steps,
                                         include_jacobian=True))(
        jax.random.key(0))
    lap = laplace_approximation(target, res.choices,
                                transforms=res.transforms)
    _emit({"reading": "map_laplace_jax", "steps": n_steps,
           "map_err": float(np.max(np.abs(np.asarray(res.choices["w"],
                                                     np.float64)
                                          - exact["mean"]))),
           "cov_err": float(np.max(np.abs(np.asarray(lap.cov, np.float64)
                                          - exact["cov"]))),
           "log_z": float(lap.log_z), "exact_log_z": exact["log_z"],
           "log_z_err": abs(float(lap.log_z) - exact["log_z"])})


def config5_reading(fits: int = 64, steps: int = 10, samples: int = 8):
    import jax
    import jax.numpy as jnp
    import torch

    import genjax_tpu as g
    from genjax_torch import entry
    from genjax_torch.core import random
    from genjax_tpu.inference import Target, marginal, vi

    @g.gen
    def model(v):
        comp = g.flip(0.5) @ "comp"
        mu = g.normal(jnp.where(comp, v, -v), 1.0) @ "mu"
        _ = g.normal(mu, 0.5) @ "y"

    @marginal()
    @g.gen
    def guide(target):
        (v,) = target.args
        b = vi.flip_enum(0.5) @ "comp"
        _ = vi.normal_reparam(jnp.where(b, v, -v), 0.5) @ "mu"

    loss_grad = vi.ELBO(guide, lambda v: Target(model, (v,),
                                                g.C["y"].set(1.0)))

    @jax.jit
    def run(key):
        def one_fit(v0, fkey):
            def body(v, i):
                ks = jax.random.split(jax.random.fold_in(fkey, i), samples)
                dv = jax.vmap(lambda kk: loss_grad(kk, (v,))[0])(ks).mean()
                return v - 1e-3 * dv, dv

            return jax.lax.scan(body, v0, jnp.arange(steps))

        v0s = jnp.linspace(0.2, 0.8, fits)
        return jax.vmap(one_fit)(v0s, jax.random.split(key, fits))

    v, dvs = run(jax.random.key(0))
    v0 = np.linspace(0.2, 0.8, fits)
    exact = entry.adev_vi_exact(v0, steps)
    _emit({"reading": "config5_jax", "fits": fits, "steps": steps,
           "first_grad_err": float(np.max(np.abs(np.asarray(dvs)[:, 0]
                                                 - 4 * v0))),
           "final_rel_err": float(np.max(np.abs(np.asarray(v) - exact)
                                         / exact))})
    run_t, v0t = entry.build_adev_vi(fits, steps, samples, device="cpu")
    vt, first = run_t(random.key(0))
    _emit({"reading": "config5_port_cpu", "fits": fits, "steps": steps,
           "first_grad_err": float((first.double() - 4 * v0t.double())
                                   .abs().max()),
           "final_rel_err": float(((vt.double() - torch.tensor(
               entry.adev_vi_exact(v0t.numpy(), steps))).abs()
               / torch.tensor(entry.adev_vi_exact(v0t.numpy(), steps)))
               .max()),
           "port_vs_jax_final": float(np.max(np.abs(vt.numpy()
                                                    - np.asarray(v))))})


def config9_reading(din: int, dh: int, b: int, steps: int = 500):
    from genjax_torch import entry
    from genjax_torch.core import random

    run, x, y, _ = entry.build_bnn_vi(din, dh, b, n_steps=steps,
                                      device="cpu")
    p0 = entry.bnn_params0(din, dh, "cpu")
    key = random.key(11)
    before = float(entry.bnn_neg_elbo_estimate(key, p0, x, y))
    t0 = time.perf_counter()
    p = run(random.key(7))
    after = float(entry.bnn_neg_elbo_estimate(key, p, x, y))
    _emit({"reading": "config9_port_cpu", "width": [din, dh, b],
           "steps": steps, "neg_elbo_0": before, "neg_elbo_end": after,
           "drop": before - after, "drop_per_point": (before - after) / b,
           "mean_abs_mu1": float(p["mu1"].abs().mean()),
           "seconds": time.perf_counter() - t0})


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--svgd-keys", default="")
    ap.add_argument("--svgd-size", default="4096,600")
    ap.add_argument("--sharded-svgd-keys", default="")
    ap.add_argument("--map", action="store_true")
    ap.add_argument("--map-steps", type=int, default=1000)
    ap.add_argument("--config5", action="store_true")
    ap.add_argument("--config9", action="store_true")
    ap.add_argument("--c9-width", default="64,128,1024")
    args = ap.parse_args()
    if args.config5:
        config5_reading()
    if args.config9:
        config9_reading(*(int(v) for v in args.c9_width.split(",")))
    if args.map:
        map_reading(args.map_steps)
    parts, steps = (int(v) for v in args.svgd_size.split(","))
    for k in filter(None, args.svgd_keys.split(",")):
        svgd_reading(int(k), parts, steps)
    for k in filter(None, args.sharded_svgd_keys.split(",")):
        sharded_svgd_reading(int(k), parts, steps)


if __name__ == "__main__":
    main()
