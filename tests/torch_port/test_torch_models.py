"""The port's model families and exact oracles against the JAX package:
the LGSSM data, Kalman filter and smoother, grid posterior and scanned
model; the nonlinear tracking model in the particle filter; the Gaussian
mixture and the hierarchical regression; the SLDS data, the RBPF's
regime draws and log Z, and the path-enumeration oracle; and the two
entry builders of this slice on the CPU at a small size.

Tolerance: f32 values, scores and log-likelihoods to 1e-5 relative and
1e-5 absolute (normals agree with JAX's to a few ulp); regimes and other
discrete draws exactly; an RBPF estimate against the exact evidence
within the JAX package's own bounds (mean of 8 keys within 0.05, spread
below 0.1); an S = 1 RBPF against the Kalman evidence to 1e-5 relative."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import genjax_torch as gt
import genjax_tpu as gj
from genjax_torch import entry as E
from genjax_torch import models as tm
from genjax_torch.core import random as R
from genjax_torch.inference import ImportanceK, Target
from genjax_torch.inference.pf import particle_filter
from genjax_torch.interop import key_from_numpy
from genjax_tpu import models as jm
from genjax_tpu.inference.pf import particle_filter as jax_particle_filter

TOL = dict(rtol=1e-5, atol=1e-5)
KEY = jax.random.key(20260820)


def _tkey(k):
    return key_from_numpy(np.asarray(jax.random.key_data(k)))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy().astype(np.float64)
    return np.asarray(x, np.float64)


def close(a, b, **kw):
    np.testing.assert_allclose(_np(a), _np(b), **(kw or TOL))


def _slds_pair(s):
    pt = E.slds_params(s)
    pj = jm.SLDSParams(*(jnp.asarray(v.numpy()) for v in pt[:5]))
    return pt, pj


# -- linear-Gaussian state space ----------------------------------------------


def test_lgssm_data_and_kalman_oracles_match_jax():
    a, q, r, n = 0.9, 0.5, 0.3, 12
    xs_j, ys_j = jm.simulate_lgssm_data(KEY, a, q, r, n)
    xs_t, ys_t = tm.simulate_lgssm_data(_tkey(KEY), a, q, r, n)
    close(xs_t, xs_j)
    close(ys_t, ys_j)
    ys = torch.as_tensor(np.array(ys_j))
    for mu0, p0 in ((0.0, 0.0), (0.3, 1.0)):
        ll_j, mus_j = jm.kalman_filter(ys_j, a, q, r, mu0=mu0, p0=p0)
        ll_t, mus_t = tm.kalman_filter(ys, a, q, r, mu0=mu0, p0=p0)
        close(ll_t, ll_j)
        close(mus_t, mus_j)
        sj = jm.kalman_smoother(ys_j, a, q, r, mu0=mu0, p0=p0)
        stt = tm.kalman_smoother(ys, a, q, r, mu0=mu0, p0=p0)
        for got, want in zip(stt, sj):
            close(got, want)
    grid = np.linspace(0.5, 1.2, 41).astype(np.float32)
    for got, want in zip(
            tm.lgssm_grid_posterior(ys, q, r, torch.as_tensor(grid)),
            jm.lgssm_grid_posterior(ys_j, q, r, jnp.asarray(grid))):
        close(got, want)


def test_kalman_filter_float64():
    """The oracle computes in its observations' dtype."""
    ys = torch.linspace(-1.0, 2.0, 9, dtype=torch.float64)
    ll, mus = tm.kalman_filter(ys, 0.8, 0.3, 0.4)
    assert ll.dtype == torch.float64 and mus.dtype == torch.float64
    close(ll, tm.kalman_filter(ys.float(), 0.8, 0.3, 0.4)[0], rtol=1e-5)


def test_lgssm_model_matches_jax_and_its_evidence_matches_kalman():
    a, q, r, n = 0.9, 0.5, 0.3, 6
    mj, mt = jm.lgssm_model(a, q, r, n), tm.lgssm_model(a, q, r, n)
    trj = mj.simulate(KEY, (0.0, None))
    trt = mt.simulate(_tkey(KEY), (0.0, None))
    close(trt.get_score(), trj.get_score())
    ys = torch.stack([trt.get_choices()[t, "y"] for t in range(n)])
    close(ys, [trj.get_choices()[t, "y"] for t in range(n)])
    constraint = gt.C[:, "y"].set(ys)
    target = Target(mt, (0.0, None), constraint)
    est = torch.stack([
        ImportanceK(target, k_particles=20_000)
        .log_marginal_likelihood_estimate(R.key(i)) for i in range(4)])
    logz = torch.logsumexp(est, 0) - np.log(4.0)
    want, _ = tm.kalman_filter(ys, a, q, r, mu0=0.0, p0=0.0)
    close(logz, want, atol=0.1, rtol=0.0)


def test_nonlinear_tracking_filter_matches_jax():
    init_t, step_t = tm.nonlinear_tracking_model()
    init_j, step_j = jm.nonlinear_tracking_model()
    ys_j = jax.random.normal(jax.random.key(2), (10,)) * 5.0
    ys_t = torch.as_tensor(np.array(ys_j))
    final_j, _ = jax_particle_filter(init_j, step_j, 512)(KEY, ys_j)
    final_t, _ = particle_filter(init_t, step_t, 512)(_tkey(KEY), ys_t)
    assert bool(torch.isfinite(final_t.log_z))
    close(final_t.log_z, final_j.log_z, rtol=1e-3, atol=1e-3)


# -- mixture and regression ---------------------------------------------------


def test_gaussian_mixture_matches_jax_and_batches():
    logits = np.log(np.array([0.2, 0.3, 0.5], np.float32))
    locs = np.array([-5.0, 0.0, 5.0], np.float32)
    scales = np.array([1.0, 0.5, 2.0], np.float32)
    mj, mt = jm.gaussian_mixture(3), tm.gaussian_mixture(3)
    args_j = tuple(jnp.asarray(v) for v in (logits, locs, scales))
    args_t = tuple(torch.as_tensor(v) for v in (logits, locs, scales))
    trj = mj.simulate(KEY, args_j)
    trt = mt.simulate(_tkey(KEY), args_t)
    assert int(trt.get_choices()["comp"]) == int(trj.get_choices()["comp"])
    close(trt.get_score(), trj.get_score())
    score, _ = mt.assess(trt.get_choices(), args_t)
    close(score, trt.get_score())
    keys = jax.random.split(KEY, 8)
    sj = jax.vmap(lambda k: mj.simulate(k, args_j).get_score())(keys)
    st_ = mt.simulate(_tkey(keys), tuple(v.expand(8, 3) for v in args_t))
    close(st_.get_score(), sj)


def test_hierarchical_regression_matches_jax():
    xs = np.linspace(-1, 1, 25).astype(np.float32)
    mj, mt = jm.hierarchical_regression(), tm.hierarchical_regression()
    trj = mj.simulate(KEY, (jnp.asarray(xs),))
    trt = mt.simulate(_tkey(KEY), (torch.as_tensor(xs),))
    close(trt.get_score(), trj.get_score())
    close(trt.get_choices()["ys"], trj.get_choices()["ys"])
    keys = jax.random.split(KEY, 4)
    sj = jax.vmap(lambda k: mj.simulate(k, (jnp.asarray(xs),))
                  .get_score())(keys)
    st_ = mt.simulate(_tkey(keys), (torch.as_tensor(xs).expand(4, 25),))
    close(st_.get_score(), sj)


# -- SLDS ---------------------------------------------------------------------


@pytest.mark.parametrize("s", [1, 2])
def test_slds_data_matches_jax(s):
    pt, pj = _slds_pair(s)
    zj, xj, yj = jm.simulate_slds_data(KEY, pj, 20)
    zt, xt, yt = tm.simulate_slds_data(_tkey(KEY), pt, 20)
    np.testing.assert_array_equal(zt.numpy(), np.asarray(zj))
    close(xt, xj)
    close(yt, yj)


def test_slds_exact_log_marginal_matches_jax():
    pt, pj = _slds_pair(2)
    _, _, yj = jm.simulate_slds_data(KEY, pj, 8)
    ys = torch.as_tensor(np.array(yj))
    close(tm.slds_exact_log_marginal(pt, ys),
          jm.slds_exact_log_marginal(pj, yj))
    p64 = tm.SLDSParams(*(v.double() for v in pt[:5]))
    close(tm.slds_exact_log_marginal(p64, ys),
          jm.slds_exact_log_marginal(pj, yj))


def test_rbpf_regime_draws_match_jax_bitwise():
    """With resampling off the regime path depends on the keys alone: the
    initial categorical draws and every inverse-CDF transition are the
    JAX package's, bit for bit; the statistics and log Z agree to f32."""
    pt, pj = _slds_pair(2)
    _, _, yj = jm.simulate_slds_data(KEY, pj, 10)
    ys = torch.as_tensor(np.array(yj))
    key = jax.random.key(7)
    rj = jm.slds_rbpf(pj, 4096, ess_threshold=0.0)(key, yj)
    rt = tm.slds_rbpf(pt, 4096, ess_threshold=0.0)(_tkey(key), ys)
    np.testing.assert_array_equal(rt.regimes.numpy(), np.asarray(rj.regimes))
    close(rt.means, rj.means)
    close(rt.variances, rj.variances)
    close(rt.log_z, rj.log_z)
    close(rt.ess_history, rj.ess_history, rtol=1e-4)


def test_rbpf_with_resampling_matches_jax():
    """Adaptive systematic resampling on the same keys: the first
    resample decisions and the estimate agree with the JAX package's."""
    pt, pj = _slds_pair(2)
    _, _, yj = jm.simulate_slds_data(KEY, pj, 8)
    ys = torch.as_tensor(np.array(yj))
    key = jax.random.key(11)
    rj = jm.slds_rbpf(pj, 4096)(key, yj)
    rt = tm.slds_rbpf(pt, 4096)(_tkey(key), ys)
    resampled_j = np.asarray(rj.ess_history)[:-1] < 0.5 * 4096
    resampled_t = rt.ess_history.numpy()[:-1] < 0.5 * 4096
    np.testing.assert_array_equal(resampled_t, resampled_j)
    assert resampled_t.any()
    close(rt.log_z, rj.log_z, rtol=1e-4, atol=1e-4)


def test_rbpf_matches_enumeration():
    """The JAX package's test: at S = 2, T = 8, the mean of 8 keys' log Z
    within 0.05 of the exact evidence and their spread below 0.1."""
    pt, _ = _slds_pair(2)
    _, _, ys = tm.simulate_slds_data(_tkey(KEY), pt, 8)
    exact = float(tm.slds_exact_log_marginal(pt, ys))
    run = tm.slds_rbpf(pt, 4096)
    logzs = [float(run(R.fold_in(_tkey(KEY), i), ys).log_z)
             for i in range(8)]
    assert abs(np.mean(logzs) - exact) < 0.05, (np.mean(logzs), exact)
    assert np.std(logzs) < 0.1


def test_rbpf_collapses_to_kalman_at_one_regime():
    """At S = 1 the enumeration and the RBPF are the Kalman evidence (y_0
    conditioned by hand, the tail by ``kalman_filter``)."""
    pt, _ = _slds_pair(1)
    _, _, ys = tm.simulate_slds_data(_tkey(KEY), pt, 12)
    a, q, r = float(pt.a[0]), float(pt.q[0]), float(pt.r[0])
    y = ys.double()
    s0 = pt.p0 + r
    ll0 = -0.5 * (np.log(2 * np.pi * s0) + (float(y[0]) - pt.mu0) ** 2 / s0)
    k0 = pt.p0 / s0
    kf, _ = tm.kalman_filter(y[1:], a, q, r,
                             mu0=pt.mu0 + k0 * (float(y[0]) - pt.mu0),
                             p0=(1 - k0) * pt.p0)
    want = ll0 + float(kf)
    close(tm.slds_exact_log_marginal(pt, ys), want)
    res = tm.slds_rbpf(pt, 64)(R.key(1), ys)
    close(res.log_z, want)
    assert float(res.ess_history.min()) == pytest.approx(64.0, rel=1e-5)


# -- entry builders -----------------------------------------------------------


def test_build_slds_rbpf_small_on_cpu():
    run, params, ys = E.build_slds_rbpf(2048, 8, device="cpu")
    _, _, want = tm.simulate_slds_data(R.key(E.SLDS_DATA_SEED),
                                       E.slds_params(2), 8)
    assert torch.equal(ys, want)
    res = run(R.key(1))
    exact = float(tm.slds_exact_log_marginal(params, ys))
    assert abs(float(res.log_z) - exact) < 0.1
    assert res.ess_history.shape == (8,)
    run1, params1, _ = E.build_slds_rbpf(64, 8, n_regimes=1, device="cpu")
    assert params1.a.shape == (1,)
    assert bool(torch.isfinite(run1(R.key(0)).log_z))


def test_build_switch_mixture_small_on_cpu():
    """SIR at 2^14 and MH at 2^12 chains: component frequencies and the
    mean of ``m`` within 4 standard errors of the closed form, the
    acceptance in (0, 1)."""
    sir, run_mh, target = E.build_switch_mixture(1 << 14, 1 << 12, 48,
                                                 device="cpu")
    exact = E.switch_mixture_exact()
    np.testing.assert_allclose(exact["probs"].sum(), 1.0)
    out = sir(R.key(3))
    comp, m = out["comp"], out["m"]
    w = torch.softmax(out["log_weights"].double(), 0)
    for b in range(3):
        p = exact["probs"][b]
        f = (out["weighted_comp"] == b).double()
        p_hat = float((w * f).sum())
        # The self-normalized estimate's delta-method standard error, and
        # the resampling's binomial one on top.
        se = np.sqrt(float((w * w * (f - p_hat) ** 2).sum())
                     + p * (1 - p) / comp.shape[0])
        assert abs(p_hat - p) <= 4 * se + 1e-9
        assert abs(float((comp == b).double().mean()) - p) <= 4 * se + 1e-9
    m_w = out["weighted_m"].double()
    m_hat = float((w * m_w).sum())
    se_m = np.sqrt(float((w * w * (m_w - m_hat) ** 2).sum()))
    assert abs(m_hat - exact["mean"]) <= 4 * se_m
    assert abs(float(m.double().mean()) - exact["mean"]) <= 4 * np.sqrt(
        se_m ** 2 + exact["var"] / m.shape[0])
    comp, m, acc = run_mh(R.key(4))
    n = comp.shape[0]
    for b in range(3):
        p = exact["probs"][b]
        se = np.sqrt(max(p * (1 - p), 1e-12) / n)
        assert abs(float((comp == b).double().mean()) - p) <= 4 * se + 1e-9
    assert 0.0 < float(acc) < 1.0
    assert abs(float(m.double().mean()) - exact["mean"]) <= 4 * np.sqrt(
        exact["var"] / n)
