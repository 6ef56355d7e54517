"""The port's main path as a whole against the JAX package, on the CPU:
SIR through ``entry()``, bench config 4 through both filter drivers, the
linear-Gaussian model against its exact Kalman log Z, the resampling
primitives, and the port's independence from JAX.

The samplers of the two packages share their key data but not every
draw (the beta sampler's rejection loop and the filters' normal streams
differ), so the end-to-end numbers agree within Monte Carlo error, each
bound stated where it is used."""

import math
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
import genjax_tpu as gj
from __graft_entry__ import entry as jax_entry
from genjax_tpu.inference import ImportanceK as JaxImportanceK
from genjax_tpu.inference import Target as JaxTarget
from genjax_tpu.inference.smc import (
    effective_sample_size as jax_ess,
    resample_indices as jax_resample_indices,
)
from genjax_torch import entry as E
from genjax_torch.core import random as R
from genjax_torch.gfi.gfn import IgnoreKwargs
from genjax_torch.inference import (
    ImportanceK,
    Marginal,
    ParticleCollection,
    Target,
    bootstrap_filter,
    effective_sample_size,
    resample_indices,
    resample_tree,
)
from genjax_torch.interop import key_from_numpy

import genjax_torch as gt

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _tkey(k):
    return key_from_numpy(np.asarray(jax.random.key_data(k)))


def test_entry_matches_jax_entry_within_mc_error():
    """20 SIR runs of K = 64 on the same 20 keys in both packages: each
    package's average posterior mean and log Ẑ sit within Monte Carlo
    error of the other's and of the exact answers (0.6, log 0.5). One
    run's sd is about 0.03 (mean) and 0.06 (log Ẑ), so the average of 20
    is within 0.035 / 0.07 of the truth at 5 sd."""
    sir_j, _ = jax_entry()
    sir_t, _ = E.entry(device="cpu")
    keys = jax.random.split(jax.random.key(0), 20)
    mj, zj = jax.jit(jax.vmap(sir_j))(keys)
    mj, zj = np.asarray(mj, np.float64), np.asarray(zj, np.float64)
    mt, zt = zip(*(sir_t(_tkey(k)) for k in keys))
    mt = np.array([float(m) for m in mt])
    zt = np.array([float(z) for z in zt])
    assert np.isfinite(mt).all() and np.isfinite(zt).all()
    for m, z in ((mj.mean(), zj.mean()), (mt.mean(), zt.mean())):
        assert abs(m - 0.6) < 0.035
        assert abs(z - math.log(0.5)) < 0.07
    assert abs(mj.mean() - mt.mean()) < 0.05
    assert abs(zj.mean() - zt.mean()) < 0.1


def test_entry_converges_at_large_k():
    sir, (key,) = E.entry(k_particles=1 << 14, device="cpu")
    mean, logz = sir(key)
    assert abs(float(mean) - 0.6) < 0.01
    assert abs(float(logz) - math.log(0.5)) < 0.02


def test_config4_filters_match_jax():
    """Both port drivers against the JAX package's two config-4 builders
    at 8192 particles x 12 steps, each averaged over the same 32 keys. The
    normal streams differ, and one run's log Z has an sd of about 0.35 on
    this bimodal model, so single runs are compared through their means:
    every pair of means agrees within 0.25 (the JAX package's bound
    between its drivers, tests/ops/test_fused_step.py:174) and within 4
    standard errors of the difference."""
    n, t, seeds = 8192, 12, range(32)
    keys = [jax.random.key(s) for s in seeds]
    runs = {}
    for name, builder in (("jax_pf", bench.build_pf),
                          ("jax_fused", bench.build_pf_fused)):
        run = jax.jit(builder(n, t)[0])
        runs[name] = np.array([float(run(k)) for k in keys])
    for name, builder in (("port_pf", E.build_pf),
                          ("port_fused", E.build_pf_fused)):
        run, work = builder(n, t, device="cpu")
        assert work == n * t
        runs[name] = np.array([float(run(_tkey(k))) for k in keys])
    assert all(np.isfinite(v).all() for v in runs.values())
    names = list(runs)
    for i, a in enumerate(names):
        for b in names[i + 1:]:
            diff = abs(runs[a].mean() - runs[b].mean())
            se = math.sqrt((runs[a].var(ddof=1) + runs[b].var(ddof=1))
                           / len(seeds))
            assert diff < 0.25 and diff < 4 * se, (a, b, runs)


def test_config4_observations_match_jax():
    ys = np.asarray(jax.random.normal(jax.random.key(9), (32,)) * 5.0)
    np.testing.assert_allclose(
        E.tracking_observations(32, device="cpu").numpy(), ys,
        rtol=1e-5, atol=1e-5)


def test_linear_model_matches_kalman():
    """The fused filter on the linear-Gaussian model: log Z within 0.1 of
    the exact Kalman value (tests/ops/test_fused_step.py:138) at the
    JAX test's 24576 particles."""
    ys = E.linear_observations()
    want = E.kalman_loglik(ys)
    got = float(E.build_linear_fused(24576, ys, device="cpu")(
        R.key(314159)))
    assert abs(got - want) < 0.1


def test_bootstrap_filter_from_gen_fns_matches_kalman():
    """The per-particle driver (a key per particle, as JAX vmaps) through
    ``@gen`` transition and prior: the same linear-Gaussian model, whose
    log Z must sit within 0.1 of Kalman at 32768 particles."""

    @gt.gen
    def prior():
        return gt.normal(0.0, 1.0) @ "x"

    @gt.gen
    def transition(x):
        return gt.normal(E.LINEAR_A * x, math.sqrt(E.LINEAR_Q)) @ "x"

    ys = E.linear_observations()

    def obs_logpdf(x, y):
        return E.linear_loglik(x, y)

    # The prior draws x_0; the filter's first step then propagates, so
    # the model seen by the filter starts one transition later: shift
    # the Kalman prior by one step (mu0 = 0, p0 = a^2 + q).
    want = E.kalman_loglik(ys, p0=E.LINEAR_A ** 2 + E.LINEAR_Q)
    pf = bootstrap_filter(transition, obs_logpdf, 32768, init_prior=prior)
    final, log_zs = pf(R.key(2), torch.as_tensor(ys))
    assert log_zs.shape == (len(ys),)
    assert abs(float(final.log_z) - want) < 0.1
    assert abs(float(log_zs[-1]) - float(final.log_z)) < 1e-4


def test_resampling_primitives_match_jax():
    rng = np.random.default_rng(3)
    lw = rng.normal(size=4096).astype(np.float32)
    k = jax.random.key(12)
    np.testing.assert_allclose(
        float(effective_sample_size(torch.as_tensor(lw))),
        float(jax_ess(jnp.asarray(lw))), rtol=1e-5)
    for method in ("systematic", "stratified", "multinomial"):
        a = resample_indices(_tkey(k), torch.as_tensor(lw), 4096, method)
        b = np.asarray(jax_resample_indices(k, jnp.asarray(lw), 4096, method))
        # Same uniforms; the CDFs are summed in different orders, so a
        # grid point on a rounded boundary may pick the neighbour.
        assert (a.numpy() == b).mean() > 0.99
        assert (np.diff(a.numpy()) >= 0).all()
    xs = torch.arange(4096.0)
    out = resample_tree(_tkey(k), torch.as_tensor(lw), {"x": xs}, 4096)
    idx = resample_indices(_tkey(k), torch.as_tensor(lw), 4096)
    assert torch.equal(out["x"], xs[idx])


def test_particle_collection_resample_keeps_log_z():
    lw = torch.as_tensor(np.random.default_rng(0).normal(size=1000),
                         dtype=torch.float32)
    col = ParticleCollection({"x": torch.arange(1000.0)}, lw,
                             torch.tensor(True))
    res = col.resample(R.key(1))
    assert torch.allclose(res.get_log_marginal_likelihood_estimate(),
                          col.get_log_marginal_likelihood_estimate())
    assert res.effective_sample_size() == pytest.approx(1000.0)


def _length_16_models():
    """``m ~ N(0, 1)``, ``y ~ N(m, 1)`` and ``ys ~ N(m, 4)`` over 16
    points, with an argument ``xs`` of length 16 returned as is."""

    @gj.gen
    def jax_model(xs):
        m = gj.normal(0.0, 1.0) @ "m"
        gj.normal(m, 1.0) @ "y"
        gj.normal(m * jnp.ones(16), 4.0) @ "ys"
        return xs

    @gt.gen
    def port_model(xs):
        m = gt.normal(0.0, 1.0) @ "m"
        gt.normal(m, 1.0) @ "y"
        gt.normal(m[..., None] * torch.ones(16), 4.0) @ "ys"
        return xs

    return jax_model, port_model


@pytest.mark.parametrize("k", [8, 16])
def test_importance_k_keeps_arguments_and_constraints(k):
    """ImportanceK with K particles against an argument and a constraint
    of length 16: at K = 16 the lengths coincide with the particle axis,
    and still both come back from ``resample`` unchanged in every
    particle. Each run's weights and draws equal the JAX package's on the
    same key data (1e-5: the normals agree to a few ulp), and the
    posterior mean of ``m`` (sd 0.58) over 40 runs agrees between K = 8
    and K = 16 and with the exact one within Monte Carlo error."""
    jax_model, port_model = _length_16_models()
    rng = np.random.default_rng(0)
    ys = rng.normal(1.0, 4.0, size=16).astype(np.float32)
    xs = np.arange(16.0, dtype=np.float32)
    tj = JaxTarget(jax_model, (jnp.asarray(xs),),
                   gj.C["y"].set(2.0) | gj.C["ys"].set(jnp.asarray(ys)))
    tt = Target(port_model, (torch.as_tensor(xs),),
                gt.C["y"].set(2.0) | gt.C["ys"].set(torch.as_tensor(ys)))
    run_j = jax.jit(lambda key: JaxImportanceK(tj, k_particles=k).run_smc(key))
    means = []
    for seed in range(40):
        key = jax.random.key(seed)
        cj = run_j(key)
        ct = ImportanceK(tt, k_particles=k).run_smc(_tkey(key))
        np.testing.assert_allclose(ct.get_log_weights().numpy(),
                                   np.asarray(cj.get_log_weights()),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(
            ct.get_particles().get_choices()["m"].numpy(),
            np.asarray(cj.get_particles().get_choices()["m"]), rtol=1e-5,
            atol=1e-6)
        res = ct.resample(_tkey(jax.random.key(1000 + seed)))
        tr = res.get_particles()
        assert tr.get_args()[0].shape == (k, 16)
        assert torch.equal(tr.get_args()[0],
                           torch.as_tensor(xs).expand(k, 16))
        assert torch.equal(tr.get_retval(), torch.as_tensor(xs).expand(k, 16))
        assert torch.equal(tr.get_choices()["ys"],
                           torch.as_tensor(ys).expand(k, 16))
        assert torch.equal(tr.get_choices()["y"],
                           torch.full((k,), 2.0))
        w = torch.softmax(ct.get_log_weights(), 0)
        means.append(float((w * ct.get_particles().get_choices()["m"]).sum()))
    # Exact posterior of m: precision 1 + 1 + 16/16 = 3. One run's
    # self-normalized mean has an sd of about 0.2 at K = 8, so a 40-run
    # average is within 0.1 of the truth at 3 sd (its O(1/K) bias is a
    # few hundredths here).
    exact = (2.0 + ys.sum() / 16.0) / 3.0
    # Both K within 0.1 of the truth puts them within 0.2 of each other.
    assert abs(np.mean(means) - exact) < 0.1, (np.mean(means), exact)


@pytest.mark.parametrize("k", [8, 16])
def test_importance_k_keeps_body_constants(k):
    """A constant that the model body makes (``arange(16)``), mapped
    through Vmap and returned: at K = 16 its length coincides with the
    particle axis, and still every particle's lanes hold ``x_i ~ N(i, 1)``
    and the constant comes back from ``resample`` unchanged. Weights and
    lane draws equal the JAX package's on the same key data (1e-5)."""

    def model(lib, xp):
        @lib.gen
        def lane(mu):
            return lib.normal(mu, 1.0) @ "x"

        @lib.gen
        def m(_):
            c = xp.arange(16.0)
            mu = lib.normal(0.0, 1.0) @ "m"
            lib.normal(mu, 1.0) @ "y"
            lane.vmap()(c) @ "v"
            return c

        return m

    tj = JaxTarget(model(gj, jnp), (0.0,), gj.C["y"].set(2.0))
    tt = Target(model(gt, torch), (0.0,), gt.C["y"].set(2.0))
    key = jax.random.key(7)
    cj = jax.jit(lambda kk: JaxImportanceK(tj, k_particles=k).run_smc(kk))(
        key)
    ct = ImportanceK(tt, k_particles=k).run_smc(_tkey(key))
    np.testing.assert_allclose(ct.get_log_weights().numpy(),
                               np.asarray(cj.get_log_weights()),
                               rtol=1e-5, atol=1e-5)
    lanes = ct.get_particles().get_choices()["v", :, "x"]
    assert lanes.shape == (k, 16)
    np.testing.assert_allclose(
        lanes.numpy(),
        np.asarray(cj.get_particles().get_choices()["v", :, "x"]),
        rtol=1e-5, atol=1e-5)
    res = ct.resample(_tkey(jax.random.key(8))).get_particles()
    assert torch.equal(res.get_retval(), torch.arange(16.0).expand(k, 16))
    new = res.get_choices()["v", :, "x"]
    # Every resampled particle is a whole row of the old ones.
    assert bool((new[:, None, :] == lanes[None, :, :]).all(-1).any(-1).all())


def test_csmc_keeps_the_retained_particle_last():
    model = E.quickstart_model()
    target = Target(model, (2.0, 2.0), gt.C["v"].set(True))
    alg = ImportanceK(target, k_particles=16)
    col = alg.run_csmc(R.key(4), gt.C["p"].set(torch.tensor(0.25)))
    ps = col.get_particles().get_choices()["p"]
    assert ps.shape == (16,) and float(ps[-1]) == 0.25
    # the retained weight is log p(v=1 | p) = log 0.25: the prior of p is
    # the proposal, and its density cancels
    assert float(col.get_log_weights()[-1]) == pytest.approx(math.log(0.25))
    drawn = col.sample_particle(R.key(5)).get_choices()["p"]
    assert bool((ps == drawn).any())


def test_unported_paths_raise():
    model = E.quickstart_model()
    target = Target(model, (2.0, 2.0), gt.C["v"].set(True))
    # ChangeTarget is ported: the estimate is finite. Named distribution
    # parameters are too, and bind to positions; a combinator's named
    # arguments are ignored, as the JAX package's IgnoreKwargs ignores
    # them: the draws are those of the positional call, bit for bit.
    assert bool(torch.isfinite(
        ImportanceK(target, k_particles=4).estimate_normalizing_constant(
            R.key(0), target)))
    assert gt.normal(loc=0.0, scale=1.0).args == (0.0, 1.0)
    vm = gt.normal.vmap(in_axes=(0, None))
    named = vm(torch.zeros(3), 1.0, scale=torch.ones(3))
    assert isinstance(named.gen_fn, IgnoreKwargs)
    tr_named = named.simulate(R.key(1))
    tr_pos = vm(torch.zeros(3), 1.0).simulate(R.key(1))
    assert torch.equal(tr_named.get_retval(), tr_pos.get_retval())
    jvm = gj.normal.vmap(in_axes=(0, None))
    jx = jvm(jnp.zeros(3), 1.0, scale=jnp.ones(3)).simulate(
        jax.random.key(1)).get_retval()
    np.testing.assert_allclose(tr_named.get_retval().numpy(), np.asarray(jx),
                               rtol=1e-5, atol=1e-6)
    marg = Marginal(model, gt.Const(gt.Selection.at["p"]))
    with pytest.raises(TypeError, match="Marginal"):
        Target(marg, (2.0, 2.0), gt.C["v"].set(True))
    # An ADEV site with a non-tail-call strategy inside a cond with a
    # per-element predicate (``adev/core.py``): each execution takes its
    # own branch's estimate, so the mean gradient over 2^14 keys is the
    # exact d/dp E[1{x > 0}·flip(p)] = 0.5 within 4 se.
    from genjax_torch import adev as ta

    @ta.expectation
    def loss(p):
        x = ta.normal_reparam(0.0, 1.0)
        return ta.cond(x > 0, lambda: torch.where(ta.flip_enum(p), 1.0, 0.0),
                       lambda: torch.zeros(()))

    (g,) = loss.grad_estimate(R.split(R.key(2), 1 << 14), (0.3,))
    assert abs(float(g.mean()) - 0.5) <= 4 * float(g.std()) / 128


def test_port_imports_without_jax():
    """Every module of the port, found by walking the package (so a
    module added later is covered without editing this list), imports
    with ``jax`` made unimportable, and none of them loads ``jax`` or
    ``genjax_tpu``."""
    code = (
        "import sys, importlib, pkgutil; sys.modules['jax'] = None\n"
        "import genjax_torch\n"
        "names = [m.name for m in pkgutil.walk_packages("
        "genjax_torch.__path__, 'genjax_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "assert not any(m == 'jax' or m.startswith('jax.') or "
        "m.startswith('genjax_tpu') for m, v in sys.modules.items() "
        "if v is not None)\n"
        "print(len(names))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 60


@pytest.mark.parametrize("call", [
    lambda **kw: E.entry(**kw),
    lambda **kw: E.tracking_observations(4, **kw),
    lambda **kw: E.build_pf(64, 2, **kw),
    lambda **kw: E.build_pf_fused(64, 2, **kw),
    lambda **kw: E.build_linear_fused(64, E.linear_observations(3), **kw),
    lambda **kw: E.build_hmm_smc(4, 4, 64, **kw),
    lambda **kw: E.build_hmm_parallel(4, 4, **kw),
], ids=["entry", "tracking_observations", "build_pf", "build_pf_fused",
        "build_linear_fused", "build_hmm_smc", "build_hmm_parallel"])
def test_entry_points_default_to_the_card(call, monkeypatch):
    """Without ``device`` an entry point asks for the card and, finding
    none, raises instead of running on the CPU; ``device="cpu"`` runs."""
    assert call(device="cpu") is not None
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        call()


def test_hmm_parallel_entry_on_the_cpu():
    run, problem = E.build_hmm_parallel(16, 20, device="cpu")
    z, score, logm = run(R.key(1))
    assert z.shape == (20,) and z.device.type == "cpu"
    assert float(score) <= 0.0
    assert float(logm) == float(problem.log_data_marginal)
