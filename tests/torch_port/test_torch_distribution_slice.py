"""The distributions slice as a whole, in both packages on the CPU: the
gamma-Poisson SIR (``entry.build_gamma_poisson_sir``) at K = 4096 and
NUTS on the scale-free regression (``entry.build_scale_nuts``) at 8
chains x 25 points x (100 + 100), each package against the exact answer,
and the two packages' ``infer_transforms`` on the new support specs.

Tolerance: 5 standard errors of each run's own estimate. The SIR's are
the self-normalised estimate's (the weights' second moment about the
mean) and log Ẑ's ``sqrt(CV²/K)``; NUTS's are the Monte Carlo standard
errors of ``diagnostics.summarize`` (sd / sqrt(ESS)). Both packages'
chains start from the best of 16 prior draws: the JAX package's
``run_nuts`` starts from one, and on this model about one chain in six
is then stuck for good, so its side is driven through its own
``warmup_chains`` and ``nuts_kernel`` from the same kind of start."""

import math

import jax
import jax.numpy as jnp
from jax.flatten_util import ravel_pytree as j_ravel
import numpy as np
import pytest
import torch

import genjax_torch as gt
import genjax_tpu as gj
from genjax_torch import entry as E
from genjax_torch.inference import transforms as tt
from genjax_torch.inference.diagnostics import summarize
from genjax_torch.interop import key_from_numpy
from genjax_tpu.gfi.choice_map import partition_values as j_partition
from genjax_tpu.inference import ImportanceK as JImportanceK
from genjax_tpu.inference import Target as JTarget
from genjax_tpu.inference import transforms as jtt
from genjax_tpu.inference.adaptation import warmup_chains as j_warmup
from genjax_tpu.inference.requests.nuts import nuts_kernel as j_nuts

KEY = jax.random.key(20261017)
K = 4096
CHAINS, POINTS, WARMUP, SAMPLES = 8, 25, 100, 100


def _tkey(k):
    return key_from_numpy(np.asarray(jax.random.key_data(k)))


def _sir_stats(lam, lw):
    """Posterior mean, log Ẑ and their standard errors from one
    importance run's particles and log weights (float64)."""
    lam, lw = np.asarray(lam, np.float64), np.asarray(lw, np.float64)
    w = np.exp(lw - lw.max())
    wn = w / w.sum()
    mean = float(wn @ lam)
    se_mean = math.sqrt(float((wn ** 2) @ (lam - mean) ** 2))
    log_z = float(np.log(w.mean()) + lw.max())
    se_log_z = math.sqrt(w.var() / w.mean() ** 2 / len(w))
    return mean, se_mean, log_z, se_log_z


def _jax_gamma_poisson():
    @gj.gen
    def model():
        lam = gj.gamma(2.0, 1.0) @ "lam"
        _ = gj.poisson(lam) @ "y"
        return lam

    return model


def test_gamma_poisson_sir_port():
    out = E.build_gamma_poisson_sir(K, device="cpu")(_tkey(KEY))
    mean, se_m, log_z, se_z = _sir_stats(out["lam"], out["log_weights"])
    assert abs(float(out["mean"]) - mean) <= 1e-5 * mean
    assert abs(float(out["log_z"]) - log_z) <= 1e-5
    assert abs(mean - E.GAMMA_POISSON_MEAN) <= 5 * se_m
    assert abs(log_z - E.GAMMA_POISSON_LOG_Z) <= 5 * se_z
    res = out["resampled"].get_particles().get_choices()["lam"]
    assert res.shape == (K,) and bool((res > 0).all())


def test_gamma_poisson_sir_jax():
    target = JTarget(_jax_gamma_poisson(), (), gj.C["y"].set(5))
    col = jax.jit(lambda k: JImportanceK(target, k_particles=K).run_smc(k))(
        KEY)
    lam = np.asarray(col.get_particles().get_choices()["lam"])
    mean, se_m, log_z, se_z = _sir_stats(lam, col.get_log_weights())
    assert abs(mean - E.GAMMA_POISSON_MEAN) <= 5 * se_m
    assert abs(log_z - E.GAMMA_POISSON_LOG_Z) <= 5 * se_z


def _exact():
    xs, ys = E.scale_regression_data(POINTS, "cpu")
    return xs, ys, E.scale_nuts_exact(xs, ys)


def _check_nuts(draws: dict, exact: dict):
    for site in ("sigma", "slope", "icept"):
        s = summarize(torch.as_tensor(np.asarray(draws[site])))
        mcse = float(s["std"]) / math.sqrt(float(s["ess"]))
        assert abs(float(s["mean"]) - exact[site]) <= 5 * mcse, (
            site, float(s["mean"]), exact[site], mcse)


def test_scale_nuts_port():
    _, _, exact = _exact()
    run, _ = E.build_scale_nuts(CHAINS, WARMUP, SAMPLES, n_points=POINTS,
                                device="cpu")
    chm, _ = run(_tkey(KEY))
    assert bool((chm["sigma"] > 0).all())
    _check_nuts({k: chm[k] for k in ("sigma", "slope", "icept")}, exact)


def _jax_scale_target(xs, ys):
    @gj.gen
    def model(xs):
        slope = gj.normal(0.0, 2.0) @ "slope"
        icept = gj.normal(0.0, 2.0) @ "icept"
        sigma = gj.half_normal(1.0) @ "sigma"
        _ = gj.mv_normal_diag(slope * xs + icept,
                              sigma * jnp.ones_like(xs)) @ "ys"

    return JTarget(model, (jnp.asarray(xs),), gj.C["ys"].set(jnp.asarray(ys)))


def test_scale_nuts_jax():
    """The JAX package's NUTS pieces with ``transforms="auto"``'s
    bijectors, each chain from the best of 16 prior draws."""
    xs, ys, exact = _exact()
    target = _jax_scale_target(xs.numpy(), ys.numpy())
    transforms = jtt.resolve_transforms(target, "auto")
    assert set(transforms) == {"sigma"}

    def start(k):
        tr, _ = target.importance(k, gj.ChoiceMap.empty())
        lat = jtt.unconstrain_choices(
            target.filter_to_unconstrained(tr.get_choices()), transforms)
        return j_ravel(j_partition(lat)[0])[0]

    tr0, _ = target.importance(KEY, gj.ChoiceMap.empty())
    vals0, rebuild = j_partition(jtt.unconstrain_choices(
        target.filter_to_unconstrained(tr0.get_choices()), transforms))
    _, unravel = j_ravel(vals0)

    def logdensity(z):
        chm, fldj = jtt.constrain_choices(rebuild(unravel(z)), transforms)
        tr, _ = target.importance(jax.random.key(0), chm)
        return tr.get_score() + fldj

    def run(key):
        k_init, k_warm, k_sample = jax.random.split(key, 3)
        keys = jax.random.split(k_init, (CHAINS, 16))
        zs = jax.vmap(jax.vmap(start))(keys)                  # (C, 16, D)
        lp = jax.vmap(jax.vmap(logdensity))(zs)
        z0 = zs[jnp.arange(CHAINS), jnp.argmax(lp, axis=1)]
        z, eps, inv_mass = j_warmup(logdensity, z0, k_warm, WARMUP, 6)

        def chain(z, k):
            def step(z, sk):
                z, _ = j_nuts(logdensity, z, sk, eps, inv_mass, 6)
                return z, z
            return jax.lax.scan(step, z, jax.random.split(k, SAMPLES))[1]

        return jax.vmap(chain)(z, jax.random.split(k_sample, CHAINS))

    zs = jax.jit(run)(KEY)                                     # (C, S, D)
    draws = jax.vmap(jax.vmap(lambda z: jtt.constrain_choices(
        rebuild(unravel(z)), transforms)[0]))(zs)
    got = {k: np.asarray(draws[k]) for k in ("sigma", "slope", "icept")}
    assert (got["sigma"] > 0).all()
    _check_nuts(got, exact)


def _support_models():
    """The same model in both packages, one site of each support kind
    the new distributions declare (each distribution's own spec is held
    by test_torch_distributions.py::test_support_spec); observed,
    unsupported and integer sites are left out of the transforms."""
    def body(g, xs, lo, hi):
        a = g.half_normal(1.0) @ "a"
        b = g.exponential(2.0) @ "b"
        c = g.logit_normal(0.0, 1.0) @ "c"
        d = g.truncated_normal(0.0, 1.0, lo, hi) @ "d"
        e = g.kumaraswamy(2.0, 3.0) @ "e"
        h = g.truncated_cauchy(0.0, 1.0, lo, hi) @ "h"
        _ = g.laplace(0.0, 2.0) @ "l"
        _ = g.poisson(3.5) @ "n"
        _ = g.normal(a + b + c + d + e + h, 1.0) @ "y"

    @gt.gen
    def tm(xs, lo, hi):
        body(gt, xs, lo, hi)

    @gj.gen
    def jm(xs, lo, hi):
        body(gj, xs, lo, hi)

    return tm, jm


@pytest.mark.parametrize("bounds", [(-0.5, 1.5), (np.float32(-1.0),
                                                  np.float32(2.0))],
                         ids=["floats", "tensors"])
def test_infer_transforms_agree(bounds):
    tm, jm = _support_models()
    lo, hi = bounds
    tb = tuple(torch.tensor(b) if isinstance(b, np.floating) else b
               for b in bounds)
    jb = tuple(jnp.asarray(b) if isinstance(b, np.floating) else b
               for b in bounds)
    ttr = tm.simulate(_tkey(KEY), (0.0,) + tb)
    jtr = jm.simulate(KEY, (0.0,) + jb)
    excl = lambda addr: addr == "y"  # noqa: E731
    got = tt.infer_transforms(ttr, exclude=excl)
    want = jtt.infer_transforms(jtr, exclude=excl)
    assert set(got) == set(want) == {"a", "b", "c", "d", "e", "h"}
    for addr, spec in want.items():
        if isinstance(spec, tuple):
            assert [float(x) for x in got[addr]] == [float(x) for x in spec]
        else:
            assert got[addr] == spec
    # The tuple specs map tensor bounds: the interval bijector round-trips
    # the site's value and its log-Jacobian matches the JAX package's.
    v = ttr.get_choices()["d"]
    bij = tt.get_bijector(got["d"])
    jbij = jtt.get_bijector(want["d"])
    u = bij.inverse(v)
    assert abs(float(bij.forward(u)) - float(v)) <= 1e-5
    assert abs(float(bij.fldj(u)) - float(jbij.fldj(jnp.asarray(
        u.numpy())))) <= 1e-5


def test_scale_model_transforms_agree():
    xs, ys, _ = _exact()
    jt = _jax_scale_target(xs.numpy(), ys.numpy())
    _, tt_target = E.build_scale_nuts(2, 0, 0, n_points=POINTS, device="cpu")
    assert tt.resolve_transforms(tt_target, "auto") == \
        jtt.resolve_transforms(jt, "auto") == {"sigma": "positive"}
