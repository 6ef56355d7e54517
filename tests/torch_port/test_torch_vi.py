"""The port's variational inference (``genjax_torch/inference/vi.py``)
against the JAX package's, and the distributions it added (geometric,
dirichlet, mv_normal).

Config 5's loss has one keyed site (the guide enumerates ``comp``), so
its gradients equal the JAX package's at the same key data, to 1e-5.
Config 9's guide has two reparameterized sites: there the port's ADEV
gradient equals the reparameterized −ELBO's autograd gradient written out
by hand with the port's noise, and the JAX package's equals the same
formula with its shared noise (``eps_w2 = eps_W1[0]``), which
``TestSharedNoiseELBO`` records on the two-site −ELBO of a model with a
closed form. A key batch ``E + (2,)`` gives one gradient an execution
where the JAX package vmaps over keys."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import genjax_torch as gt
import genjax_tpu as gj
from genjax_torch import entry
from genjax_torch.adev import core as tcore
from genjax_torch.adev import expectation as t_expectation
from genjax_torch.core import random
from genjax_torch.inference import Importance, Target, marginal, vi
from genjax_torch.interop import key_from_numpy
from genjax_tpu.adev import expectation as j_expectation
from genjax_tpu.inference import Importance as JImportance
from genjax_tpu.inference import Target as JTarget
from genjax_tpu.inference import marginal as jmarginal
from genjax_tpu.inference import vi as jvi

KEY = jax.random.key(314159)
TOL = dict(rtol=1e-5, atol=1e-5)


def _tkey(k):
    return key_from_numpy(np.asarray(jax.random.key_data(k)))


def _keys(n, key=KEY):
    jk = jax.random.split(key, n)
    return jk, _tkey(jk)


def _close(got, want, **kw):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), **(kw or TOL))


def _mean_se(x):
    x = np.asarray(x, np.float64)
    return x.mean(0), x.std(0) / np.sqrt(x.shape[0])


def _config5_jax():
    @gj.gen
    def model(v):
        comp = gj.flip(0.5) @ "comp"
        mu = gj.normal(jnp.where(comp, v, -v), 1.0) @ "mu"
        _ = gj.normal(mu, 0.5) @ "y"

    @jmarginal()
    @gj.gen
    def guide(target):
        (v,) = target.args
        b = jvi.flip_enum(0.5) @ "comp"
        _ = jvi.normal_reparam(jnp.where(b, v, -v), 0.5) @ "mu"

    return model, guide, jvi.ELBO(
        guide, lambda v: JTarget(model, (v,), gj.C["y"].set(1.0)))


class TestConfig5:
    def test_loss_grad_matches_reference(self):
        _, _, jgrad = _config5_jax()
        _, _, tgrad = entry.adev_vi_problem()
        jk, tk = _keys(64)
        vs = np.linspace(0.2, 0.8, 64).astype(np.float32)
        (jg,) = jax.jit(jax.vmap(lambda k, v: jgrad(k, (v,))))(
            jk, jnp.asarray(vs))
        (tg,) = tgrad(tk, (torch.tensor(vs),))
        _close(tg, jg)
        _close(tg, 4.0 * vs, rtol=1e-5, atol=2e-6)

    def test_small_fit_closed_form(self):
        run, v0 = entry.build_adev_vi(16, 5, 4, device="cpu")
        v, first = run(random.key(0))
        _close(first, 4.0 * v0, atol=2e-6)
        _close(v, entry.adev_vi_exact(v0.numpy(), 5), rtol=1e-5, atol=1e-7)

    def test_iwelbo_with_enum_guide_under_particles(self):
        """``flip_enum`` at each of IWELBO's particles (per-lane
        enumeration): finite, and its mean equals that of the same guide
        with ``flip_reinforce``, another unbiased estimator of the same
        gradient."""
        tmodel, tguide, _ = entry.adev_vi_problem()

        @marginal()
        @gt.gen
        def reinforce_guide(target):
            (v,) = target.args
            b = vi.flip_reinforce(0.5) @ "comp"
            _ = vi.normal_reparam(torch.where(b, v, -v), 0.5) @ "mu"

        def grad_of(guide):
            return vi.IWELBO(guide, lambda v: Target(
                tmodel, (v,), gt.C["y"].set(1.0)), 4)

        r0 = tcore.program_runs()
        (ge,) = grad_of(tguide)(_keys(2000)[1], (0.5,))
        # the run to the site, its dual continuation, 4 lanes x 2 values
        assert tcore.program_runs() - r0 == 2 + 4 * 2
        (gr,) = grad_of(reinforce_guide)(_keys(2000, jax.random.key(1))[1],
                                         (0.5,))
        assert bool(torch.isfinite(ge).all()) and float(ge.std()) < 5.0
        (me, se_), (mr, sr) = _mean_se(ge), _mean_se(gr)
        assert abs(me - mr) < 4 * math.hypot(se_, sr), (me, mr)


class TestSharedNoiseELBO:
    """Guide ``a, b ~ N(0, 1)`` by two ``normal_reparam`` sites over the
    prior of ``a, b ~ N(0, 1)``, ``y ~ N(a − b, 1)``, ``y = 0``: the
    −ELBO is 0.5·log 2π + E[(a − b)²]/2 = 1.91894."""

    EXACT = 0.5 * math.log(2 * math.pi) + 1.0

    @staticmethod
    def _program(lib, inf, vmod, where, key, imp):
        @lib.gen
        def model():
            a = lib.normal(0.0, 1.0) @ "a"
            b = lib.normal(0.0, 1.0) @ "b"
            _ = lib.normal(a - b, 1.0) @ "y"

        @inf.marginal()
        @lib.gen
        def guide(target):
            _ = vmod.normal_reparam(0.0, 1.0) @ "a"
            _ = vmod.normal_reparam(0.0, 1.0) @ "b"

        target = inf.Target(model, (), lib.C["y"].set(0.0))
        return -imp(target, guide).estimate_normalizing_constant(key, target)

    def test_port_neg_elbo(self):
        import genjax_torch.inference as ti

        _, tk = _keys(4000)
        loss = t_expectation(lambda: self._program(
            gt, ti, vi, torch.where, tk, Importance))
        vals = loss.estimate(tk, ())
        m, se = _mean_se(vals)
        assert abs(m - self.EXACT) < 4 * se, (m, se)

    def test_reference_shares_noise(self):
        """The JAX package's estimate is exactly 0.5·log 2π on every key:
        ``b`` draws ``a``'s noise, so ``a − b = 0``."""
        import genjax_tpu.inference as ji

        def one(k):
            loss = j_expectation(lambda: self._program(
                gj, ji, jvi, jnp.where, k, JImportance))
            return loss.estimate(k, ())

        vals = jax.jit(jax.vmap(one))(jax.random.split(KEY, 200))
        _close(vals, np.full(200, 0.5 * math.log(2 * math.pi)), atol=1e-5)


class TestConfig9SmallWidth:
    DIN, DH, B = 8, 16, 64

    def _problem(self):
        x, y = entry.bnn_data(self.DIN, self.DH, self.B, "cpu")
        _, _, loss_grad = entry.bnn_vi_problem(x, y)
        p0 = entry.bnn_params0(self.DIN, self.DH, "cpu")
        g = torch.Generator().manual_seed(0)
        p0 = {k: v + 0.3 * torch.randn(v.shape, generator=g)
              for k, v in p0.items()}
        return x, y, loss_grad, p0

    def test_adev_gradient_is_the_reparameterized_gradient(self):
        x, y, loss_grad, p0 = self._problem()
        key = random.key(7)
        r0 = tcore.program_runs()
        calls = []
        grad = torch.autograd.grad

        def counted(*a, **kw):
            calls.append(1)
            return grad(*a, **kw)

        torch.autograd.grad = counted
        try:
            (dp,) = loss_grad(key, (p0,))
        finally:
            torch.autograd.grad = grad
        # one forward run of the program and one backward pass
        assert tcore.program_runs() - r0 == 1
        assert len(calls) == 1
        eps1, eps2 = entry.bnn_noise(key, self.DIN, self.DH)
        pp = {k: v.clone().requires_grad_() for k, v in p0.items()}
        want = torch.autograd.grad(entry.bnn_neg_elbo(pp, eps1, eps2, x, y),
                                   list(pp.values()))
        for k, w in zip(pp, want):
            _close(dp[k], w, rtol=1e-4, atol=1e-4 * float(w.abs().max()))

    def test_reference_gradient_uses_shared_noise(self):
        """The JAX package's config 9 gradient is the same hand-written
        formula with ``eps_w2 = eps_W1[0]``."""
        x, y, _, p0 = self._problem()
        xj, yj = jnp.asarray(x.numpy()), jnp.asarray(y.numpy())

        @gj.gen
        def bnn(params, X):
            W1 = gj.normal(jnp.zeros((self.DIN, self.DH)), 1.0) @ "W1"
            w2 = gj.normal(jnp.zeros(self.DH), 1.0) @ "w2"
            f = jnp.tanh(X @ W1) @ w2
            _ = gj.mv_normal_diag(f, 0.5 * jnp.ones(self.B)) @ "y"

        @jmarginal()
        @gj.gen
        def guide(target):
            params, _x = target.args
            _ = jvi.normal_reparam(params["mu1"],
                                   jax.nn.softplus(params["rho1"])) @ "W1"
            _ = jvi.normal_reparam(params["mu2"],
                                   jax.nn.softplus(params["rho2"])) @ "w2"

        jgrad = jvi.ELBO(guide, lambda p: JTarget(bnn, (p, xj),
                                                  gj.C["y"].set(yj)))
        k = jax.random.key(7)
        (jdp,) = jax.jit(jgrad)(k, ({n: jnp.asarray(v.numpy())
                                     for n, v in p0.items()},))
        _, sub = jax.random.split(k)
        eps1 = torch.tensor(np.asarray(jax.random.normal(
            sub, (self.DIN, self.DH))))
        eps2 = eps1[0]
        pp = {n: v.clone().requires_grad_() for n, v in p0.items()}
        want = torch.autograd.grad(entry.bnn_neg_elbo(pp, eps1, eps2, x, y),
                                   list(pp.values()))
        for n, w in zip(pp, want):
            _close(np.asarray(jdp[n]), w, rtol=1e-3,
                   atol=1e-3 * float(w.abs().max()))

    def test_fit_lowers_neg_elbo(self):
        run, x, y, _ = entry.build_bnn_vi(self.DIN, self.DH, self.B,
                                          n_steps=30, device="cpu")
        p0 = entry.bnn_params0(self.DIN, self.DH, "cpu")
        key = random.key(11)
        before = entry.bnn_neg_elbo_estimate(key, p0, x, y)
        p = run(random.key(7), params={k: v.clone() for k, v in p0.items()})
        after = entry.bnn_neg_elbo_estimate(key, p, x, y)
        assert float(p["mu1"].abs().mean()) > 0.0
        assert float(after) < float(before)


def _vi_models(lib, inf, vmod):
    @lib.gen
    def model(v):
        mu = lib.normal(0.0, 10.0) @ "mu"
        _ = lib.normal(mu, 0.1) @ "v"

    @inf.marginal()
    @lib.gen
    def guide(target):
        (v,) = target.args
        _ = vmod.normal_reparam(v, 0.1) @ "mu"

    return model, guide


class TestVI:
    def test_normal_normal_tight_variance(self):
        import genjax_torch.inference as ti

        model, guide = _vi_models(gt, ti, vi)
        grad = vi.ELBO(guide, lambda v: Target(model, (v,),
                                               gt.C["v"].set(3.0)))
        v = torch.tensor(0.1)
        key = _tkey(KEY)
        for _ in range(60):
            (dv,) = grad(key, (v,))
            v = v - 1e-3 * dv
        assert float(v) == pytest.approx(3.0, 5e-2)

    def test_one_keyed_site_matches_reference(self):
        import genjax_torch.inference as ti
        import genjax_tpu.inference as ji

        jm, jg_ = _vi_models(gj, ji, jvi)
        tm, tg_ = _vi_models(gt, ti, vi)
        jgrad = jvi.ELBO(jg_, lambda v: JTarget(jm, (v,),
                                                gj.C["v"].set(3.0)))
        tgrad = vi.ELBO(tg_, lambda v: Target(tm, (v,), gt.C["v"].set(3.0)))
        jk, tk = _keys(32)
        (jd,) = jax.jit(jax.vmap(lambda k: jgrad(k, (0.7,))))(jk)
        (td,) = tgrad(tk, (0.7,))
        _close(td, jd)

    def test_iwelbo(self):
        import genjax_torch.inference as ti

        model, guide = _vi_models(gt, ti, vi)
        grad = vi.IWELBO(guide, lambda v: Target(model, (v,),
                                                 gt.C["v"].set(3.0)), 4)
        v = torch.tensor(0.1)
        key = _tkey(KEY)
        for i in range(60):
            (dv,) = grad(random.fold_in(key, i), (v,))
            v = v - 1e-3 * dv
        assert float(v) == pytest.approx(3.0, 5e-2)

    def test_qwake(self):
        @gt.gen
        def model(theta):
            mu = gt.normal(0.0, 1.0) @ "mu"
            _ = gt.normal(mu, 0.5) @ "v"

        @marginal()
        @gt.gen
        def posterior_approx(target):
            _ = vi.normal_reparam(0.8, 0.4) @ "mu"

        @marginal()
        @gt.gen
        def proposal(target):
            (theta,) = target.args
            _ = vi.normal_reparam(theta, 0.4) @ "mu"

        grad = vi.QWake(proposal, posterior_approx,
                        lambda th: Target(model, (th,), gt.C["v"].set(1.0)))
        theta = torch.tensor(0.0)
        key = _tkey(KEY)
        for i in range(100):
            lr = 0.05 if i < 80 else 0.005
            (dt,) = grad(random.fold_in(key, i), (theta,))
            theta = theta - lr * dt
        assert abs(float(theta) - 0.8) < 0.1

    def test_pwake(self):
        @gt.gen
        def model(theta):
            mu = gt.normal(theta, 1.0) @ "mu"
            _ = gt.normal(mu, 0.5) @ "v"

        @marginal()
        @gt.gen
        def posterior_approx(target):
            _ = vi.normal_reparam(2.0, 0.3) @ "mu"

        grad = vi.PWake(posterior_approx,
                        lambda th: Target(model, (th,), gt.C["v"].set(2.0)))
        theta = torch.tensor(0.0)
        key = _tkey(KEY)
        for i in range(80):
            (dt,) = grad(random.fold_in(key, i), (theta,))
            theta = theta - 0.05 * dt
        assert abs(float(theta) - 2.0) < 0.1


class TestVmappedGuides:
    def test_vmapped_flip_reinforce_guide_unbiased(self):
        """A per-datapoint discrete guide (``flip_reinforce`` under Vmap,
        lifted REINFORCE): the mean gradient equals the exact ELBO's
        gradient by enumeration of the 8 configurations."""
        y_obs = torch.tensor([2.0, 2.0, -2.0])

        @gt.gen
        def model(_theta):
            z = gt.flip.vmap(in_axes=0)(_theta * 0.0 + 0.5) @ "z"
            _ = gt.mv_normal_diag(torch.where(z, 2.0, -2.0),
                                  torch.ones_like(_theta)) @ "y"

        @marginal()
        @gt.gen
        def guide(target):
            (theta,) = target.args
            _ = vi.flip_reinforce.vmap(in_axes=0)(torch.sigmoid(theta)) @ "z"

        grad = vi.ELBO(guide, lambda th: Target(
            model, (th,), gt.C["y"].set(y_obs.expand(th.shape))))
        theta0 = torch.tensor([0.3, -0.2, 0.1])
        n = 6000
        _, tk = _keys(n)
        (dth,) = grad(tk, (theta0.expand(n, 3),))

        th = theta0.clone().double().requires_grad_()
        q = torch.sigmoid(th)
        elbo = 0.0
        for bits in range(8):
            z = torch.tensor([(bits >> i) & 1 for i in range(3)],
                             dtype=torch.bool)
            lq = torch.where(z, torch.log(q), torch.log1p(-q)).sum()
            lp = (3 * math.log(0.5) + torch.distributions.Normal(
                torch.where(z, 2.0, -2.0).double(), 1.0).log_prob(
                    y_obs.double()).sum())
            elbo = elbo + lq.exp() * (lp - lq)
        (want,) = torch.autograd.grad(-elbo, th)
        m, se = _mean_se(dth)
        assert np.all(np.abs(m - want.numpy()) < 4 * se + 1e-6), (m, want)

    def _iw_grad(self, k_particles):
        y_obs = torch.zeros(3)

        @gt.gen
        def model(mu):
            z = gt.normal.vmap(in_axes=(0, None))(mu * 0.0, 1.0) @ "z"
            _ = gt.mv_normal_diag(z, torch.ones_like(z)) @ "y"

        @marginal()
        @gt.gen
        def guide(target):
            (mu,) = target.args
            _ = vi.normal_reparam.vmap(in_axes=(0, None))(
                mu, math.sqrt(0.5)) @ "z"

        return vi.IWELBO(guide, lambda mu: Target(
            model, (mu,), gt.C["y"].set(y_obs.expand(mu.shape))),
            k_particles)

    def test_iwelbo_vectorized_reparam_zero_at_posterior(self):
        n = 1500
        (g,) = self._iw_grad(4)(_keys(n)[1], (torch.zeros(n, 3),))
        m, se = _mean_se(g)
        assert np.all(np.abs(m) < 4 * se + 1e-6), (m, se)
        assert float(g.std()) > 0.05

    def test_k1_matches_kl_derivative(self):
        n = 4000
        (g,) = self._iw_grad(1)(_keys(n)[1], (torch.full((n, 3), 0.4),))
        m, se = _mean_se(g)
        assert np.all(np.abs(m - 0.8) < 4 * se), (m, se)


class TestScanGuideVI:
    def test_elbo_with_scan_guide(self):
        T = 4

        @gt.gen
        def step(carry, _):
            x = gt.normal(carry, 0.5) @ "x"
            _ = gt.normal(x, 0.3) @ "y"
            return x, None

        @gt.gen
        def ssm(shift):
            _ = step.scan(n=T)(shift, None) @ "chain"

        obs = gt.ChoiceMap.empty()
        for t in range(T):
            obs = obs | gt.C["chain", t, "y"].set(2.0)

        @gt.gen
        def gstep(carry, _):
            x = vi.normal_reparam(carry * 0.0 + carry, 0.4) @ "x"
            return carry, None

        @marginal()
        @gt.gen
        def guide(target):
            (shift,) = target.args
            _ = gstep.scan(n=T)(shift, None) @ "chain"

        grad = vi.ELBO(guide, lambda s: Target(ssm, (s,), obs))
        shift = torch.tensor(0.0)
        key = _tkey(KEY)
        for i in range(30):
            (dv,) = grad(random.fold_in(key, i), (shift,))
            shift = shift - 2e-2 * dv
        assert bool(torch.isfinite(shift)) and float(shift) > 1.0


class TestNewDistributions:
    def test_geometric_logpmf_and_draws(self):
        v = np.array([0, 1, 3, 7], np.int32)
        p = np.float32(0.3)
        _close(gt.geometric.logpdf(torch.tensor(v), torch.tensor(p)),
               gj.geometric.logpdf(jnp.asarray(v), jnp.asarray(p)))
        jk, tk = _keys(2000)
        jd = jax.vmap(lambda k: jax.random.geometric(k, 0.3))(jk)
        td = random.geometric(tk, 0.3)
        assert np.mean(np.asarray(td) == np.asarray(jd)) > 0.999
        draws = gt.geometric.sample(tk, torch.tensor(0.3))
        assert abs(float(draws.float().mean()) - 0.7 / 0.3) < 0.2

    def test_dirichlet_logpdf_and_draws(self):
        alpha = np.array([1.5, 2.0, 2.5], np.float32)
        x = np.array([0.2, 0.3, 0.5], np.float32)
        _close(gt.dirichlet.logpdf(torch.tensor(x), torch.tensor(alpha)),
               gj.dirichlet.logpdf(jnp.asarray(x), jnp.asarray(alpha)))
        bad = np.array([0.2, 0.3, 0.6], np.float32)
        assert float(gt.dirichlet.logpdf(torch.tensor(bad),
                                         torch.tensor(alpha))) == -math.inf
        _, tk = _keys(4000)
        d = gt.dirichlet.sample(tk, torch.tensor(alpha).expand(4000, 3))
        _close(d.sum(-1), np.ones(4000), atol=1e-5)
        m, se = _mean_se(d)
        assert np.all(np.abs(m - alpha / alpha.sum()) < 4 * se)

    def test_mv_normal_logpdf_and_draws(self):
        loc = np.array([0.5, -1.0], np.float32)
        cov = np.array([[1.0, 0.6], [0.6, 2.0]], np.float32)
        v = np.array([0.1, 0.2], np.float32)
        _close(gt.mv_normal.logpdf(torch.tensor(v), torch.tensor(loc),
                                   torch.tensor(cov)),
               gj.mv_normal.logpdf(jnp.asarray(v), jnp.asarray(loc),
                                   jnp.asarray(cov)))
        jk, tk = _keys(16)
        jd = jax.vmap(lambda k: jax.random.multivariate_normal(
            k, jnp.asarray(loc), jnp.asarray(cov)))(jk)
        td = gt.mv_normal.sample(tk, torch.tensor(loc).expand(16, 2),
                                 torch.tensor(cov).expand(16, 2, 2))
        _close(td, jd, rtol=1e-5, atol=1e-5)

    def test_guide_distributions_score_like_their_families(self):
        tk = random.split(random.key(2), 5)
        for dist, fam, args in [
            (vi.geometric_reinforce, gt.geometric, (torch.full((5,), 0.4),)),
            (vi.dirichlet_implicit, gt.dirichlet,
             (torch.tensor([1.5, 2.0, 2.5]).expand(5, 3),)),
            (vi.mv_normal_reparam, gt.mv_normal,
             (torch.zeros(5, 2), torch.eye(2).expand(5, 2, 2))),
        ]:
            tr = dist.simulate(tk, args)
            _close(tr.get_score(), fam.assess(gt.ChoiceMap.choice(
                tr.get_retval()), args, batch=(5,))[0])
