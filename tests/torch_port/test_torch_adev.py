"""The port's ADEV (``genjax_torch/adev``) against the JAX package's on
the same key data.

A program with one keyed site gives the JAX package's numbers at the same
key (to 1e-5: the two draw the same bits, normals to a few ulp). With
two keyed sites they part: the JAX package hands a tail-call site's
continuation the key it split for its own noise (``adev/core.py:87-89``),
so the next site draws the same noise; the port hands on the unused half.
``TestTailCallKeyReuse`` holds the port to the true value and records
the reference's. In-program lanes (the JAX package's ``vmap`` inside an
expectation) are a site whose bound key carries lanes behind the
executions' batch; ``lax.scan`` becomes a Python loop and ``lax.cond``
``adev.cond``. A key batch ``E + (2,)`` gives one estimate an execution
where the JAX package vmaps over keys."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import genjax_tpu.adev as ja
from genjax_torch import adev as ta
from genjax_torch.adev import core as tcore
from genjax_torch.core import random
from genjax_torch.interop import key_from_numpy

KEY = jax.random.key(314159)
TOL = dict(rtol=1e-5, atol=1e-5)


def _tkey(k):
    return key_from_numpy(np.asarray(jax.random.key_data(k)))


def _keys(n):
    jk = jax.random.split(KEY, n)
    return jk, _tkey(jk)


def _close(got, want, **kw):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), **(kw or TOL))


def _jgrads(loss, keys, args):
    return jax.jit(jax.vmap(lambda k: loss.grad_estimate(k, args)))(keys)


def _lanes(shape):
    """A bound key with lanes ``shape`` (its data is never read under
    ADEV: only its shape says where the lanes are)."""
    return random.key(0).expand(tuple(shape) + (2,))


def _mean_se(x):
    x = np.asarray(x, np.float64)
    return x.mean(0), x.std(0) / np.sqrt(x.shape[0])


class TestEnumExact:
    def test_flip_enum_exact_grad(self):
        @ta.expectation
        def loss(p):
            return torch.where(ta.flip_enum(p), 3.0, -1.0)

        for k in range(3):
            (g,) = loss.grad_estimate(random.key(k), (0.3,))
            _close(g, 4.0)

    def test_flip_enum_parallel(self):
        @ta.expectation
        def loss(p):
            return torch.where(ta.flip_enum_parallel(p), 2.0, 1.0)

        _close(loss.grad_estimate(_tkey(KEY), (0.7,))[0], 1.0)

    def test_flip_mvd_exact(self):
        @ta.expectation
        def loss(p):
            return torch.where(ta.flip_mvd(p), 3.0, -1.0)

        _close(loss.grad_estimate(_tkey(KEY), (0.3,))[0], 4.0)

    def test_categorical_enum(self):
        f = torch.tensor([1.0, 2.0, 4.0])

        @ta.expectation
        def loss(logits):
            return f[ta.categorical_enum_parallel(logits)]

        p = np.array([0.2, 0.3, 0.5])
        (g,) = loss.grad_estimate(_tkey(KEY),
                                  (torch.log(torch.tensor(p, dtype=torch.float32)),))
        fn = f.numpy()
        _close(g, p * (fn - (p * fn).sum()), rtol=1e-5, atol=1e-6)

    def test_estimate_value_and_jvp(self):
        @ta.expectation
        def loss(p):
            return torch.where(ta.flip_enum(p), 3.0, -1.0)

        _close(loss.estimate(_tkey(KEY), (0.3,)), 0.2, atol=1e-6)
        d = loss.jvp_estimate(_tkey(KEY), ta.Dual(torch.tensor(0.4),
                                                  torch.tensor(1.0)))
        _close(d.primal, 0.4 * 3.0 - 0.6)
        _close(d.tangent, 4.0)


class TestOneKeyedSiteMatchesReference:
    """Each primitive alone, and config 5's shape of program: the port's
    estimates equal the JAX package's at the same key data."""

    CASES = {
        "normal_reparam": (lambda lib, mu: lib.normal_reparam(mu, 1.0) ** 2,
                           1.5),
        "normal_reinforce": (
            lambda lib, mu: lib.normal_reinforce(mu, 1.0) ** 2, 1.5),
        "flip_reinforce": (
            lambda lib, p: 3.0 * lib.flip_reinforce(p) - 1.0, 0.3),
        "flip_mvd": (lambda lib, p: 3.0 * lib.flip_mvd(p) - 1.0, 0.3),
        "baseline": (
            lambda lib, p: 3.0 * lib.baseline(lib.flip_reinforce)(1.0, p)
            - 1.0, 0.3),
        "beta_implicit": (lambda lib, a: lib.beta_implicit(a, 2.0), 1.5),
    }

    @pytest.mark.parametrize("name", sorted(CASES))
    def test_primitive_alone(self, name):
        body, x0 = self.CASES[name]
        jloss = ja.expectation(lambda x: body(ja, x) * 1.0)
        tloss = ta.expectation(lambda x: body(ta, x) * 1.0)
        jk, tk = _keys(64)
        (jg,) = _jgrads(jloss, jk, (x0,))
        (tg,) = tloss.grad_estimate(tk, (x0,))
        if name == "beta_implicit":
            # The port's beta draws come from its own gamma loop: equal in
            # distribution only, so compare means (d/da E[x] = b/(a+b)^2).
            tk = _tkey(jax.random.split(KEY, 3000))
            (tg,) = tloss.grad_estimate(tk, (x0,))
            m, se = _mean_se(tg)
            assert abs(m - 2.0 / 3.5 ** 2) < 4 * se + 1e-3
            return
        _close(tg, jg)

    def test_mv_normal_diag_reparam(self):
        def body(lib, loc):
            x = lib.mv_normal_diag_reparam(loc, loc * 0.0 + 1.0)
            return (x * x).sum(-1)

        jk, tk = _keys(32)
        loc = np.array([1.0, -1.0], np.float32)
        (jg,) = _jgrads(ja.expectation(lambda l: body(ja, l)), jk, (loc,))
        (tg,) = ta.expectation(lambda l: body(ta, l)).grad_estimate(
            tk, (torch.tensor(loc).expand(32, 2),))
        _close(tg, jg)

    def test_enum_then_reparam_one_keyed_site(self):
        """Two sites, one keyed: enumeration hands both branches the same
        key, so the reparameterized site draws as in the JAX package."""
        def body(lib, where, p, mu):
            b = lib.flip_enum(p)
            return lib.normal_reparam(where(b, mu, mu * 0.0), 1.0)

        jk, tk = _keys(64)
        jg = _jgrads(ja.expectation(
            lambda p, mu: body(ja, jnp.where, p, mu)), jk, (0.3, 2.0))
        tg = ta.expectation(lambda p, mu: body(
            ta, torch.where, p, mu)).grad_estimate(tk, (0.3, 2.0))
        for a, b in zip(tg, jg):
            _close(a, b)

    def test_add_cost(self):
        def body(lib, mu):
            x = lib.normal_reparam(mu, 1.0)
            lib.add_cost(10.0 * mu)
            return x

        jg = ja.expectation(lambda mu: body(ja, mu)).grad_estimate(KEY,
                                                                   (1.0,))
        tg = ta.expectation(lambda mu: body(ta, mu)).grad_estimate(
            _tkey(KEY), (1.0,))
        _close(tg[0], jg[0])
        _close(tg[0], 11.0)


class TestStochasticUnbiased:
    @pytest.mark.parametrize("name,body,x0,want", [
        ("reinforce_flip", lambda p: torch.where(ta.flip_reinforce(p), 3.0,
                                                 -1.0), 0.3, 4.0),
        ("normal_reparam", lambda mu: ta.normal_reparam(mu, 1.0) ** 2, 1.5,
         3.0),
        ("normal_reinforce", lambda mu: ta.normal_reinforce(mu, 1.0) ** 2,
         1.5, 3.0),
        ("gamma_shape", lambda a: ta.gamma_implicit(a, 2.0), 2.5, 0.5),
        ("gamma_rate", lambda b: ta.gamma_implicit(2.5, b), 2.0, -2.5 / 4),
    ])
    def test_mean_gradient(self, name, body, x0, want):
        (g,) = ta.expectation(body).grad_estimate(_keys(4000)[1], (x0,))
        m, se = _mean_se(g)
        assert abs(m - want) < 4 * se, (m, se)

    def test_dirichlet_gradient(self):
        alpha = torch.tensor([1.5, 2.0, 2.5])
        (g,) = ta.expectation(lambda a: ta.dirichlet_implicit(a)[..., 0]
                              ).grad_estimate(_keys(4000)[1],
                                              (alpha.expand(4000, 3),))
        a0 = 6.0
        want = np.array([(a0 - 1.5) / a0 ** 2, -1.5 / a0 ** 2,
                         -1.5 / a0 ** 2])
        m, se = _mean_se(g)
        assert np.all(np.abs(m - want) < 4 * se + 1e-4), (m, se)


class TestImplicitTangents:
    """Each implicit primitive's tangent against JAX's ``jax.jvp`` at the
    same draw and parameters."""

    def test_gamma_tangent_vs_random_gamma_grad(self):
        alphas = np.array([0.3, 0.9, 1.5, 2.5, 7.0], np.float32)
        jk = jax.random.split(KEY, 5)
        z, dz = jax.vmap(lambda k, a: jax.jvp(
            lambda a: jax.random.gamma(k, a), (a,), (1.0,)))(
                jk, jnp.asarray(alphas))
        got = torch._standard_gamma_grad(torch.tensor(alphas),
                                         torch.tensor(np.asarray(z)))
        _close(got, dz, rtol=2e-4, atol=1e-6)

    def test_gamma_primitive_tangent(self):
        """The port's ``GammaIMPLICIT`` dual: ``z / rate`` with the implicit
        derivative of its own draw ``z``."""
        shape, rate = torch.tensor([2.5, 0.7]), torch.tensor([2.0, 3.0])
        key = random.split(random.key(3), 2)
        d = tcore.Dual
        with tcore._level():
            out = ta.gamma_implicit.before_tail_call(
                key, (d(shape, torch.ones(2)), d(rate, torch.zeros(2))))
        _, sub = random.split(key).unbind(-2)
        z = random.gamma(sub, shape, ())
        _close(out.primal, z / rate)
        _close(out.tangent, torch._standard_gamma_grad(shape, z) / rate)

    def test_dirichlet_tangent_vs_jax_jvp(self):
        """``DirichletIMPLICIT``'s tangent: the normalized gammas' jvp with
        each gamma's implicit derivative, at JAX's own draws."""
        alpha = np.array([1.5, 2.0, 2.5], np.float32)
        tan = np.array([1.0, -0.5, 0.25], np.float32)
        k = jax.random.key(9)
        z, dz = jax.jvp(lambda a: jax.random.gamma(k, a),
                        (jnp.asarray(alpha),), (jnp.asarray(tan),))
        want_x, want_dx = jax.jvp(lambda zz: zz / zz.sum(), (z,), (dz,))
        zt = torch.tensor(np.asarray(z))
        dzt = torch._standard_gamma_grad(torch.tensor(alpha), zt) * \
            torch.tensor(tan)
        got_x, got_dx = tcore.jvp(lambda zz: zz / zz.sum(-1, keepdim=True),
                                  (zt,), (dzt,))
        _close(got_x, want_x)
        _close(got_dx, want_dx, rtol=2e-4, atol=1e-6)

    def test_mv_normal_reparam_and_uniform(self):
        """Full-covariance reparameterization is pathwise in the mean
        (d/dloc E[x] = 1 on every key); the uniform's tangent is 0."""
        cov = torch.tensor([[1.0, 0.6], [0.6, 2.0]])

        @ta.expectation
        def loss(loc):
            x = ta.mv_normal_reparam(loc, cov.expand(loc.shape + (2,)))
            return x.sum(-1) + ta.uniform()

        (g,) = loss.grad_estimate(_keys(16)[1],
                                  (torch.tensor([0.5, -1.0]).expand(16, 2),))
        _close(g, np.ones((16, 2)))

    def test_beta_tangent_vs_jax_quadrature(self):
        from genjax_tpu.adev.primitives import _beta_cdf_param_partials as jq
        from genjax_torch.adev.primitives import _beta_cdf_param_partials

        xs = np.array([0.1, 0.4, 0.75], np.float32)
        a, b = np.float32(1.5), np.float32(2.0)
        for x in xs:
            jda, jdb = jq(jnp.float32(x), a, b)
            tda, tdb = _beta_cdf_param_partials(torch.tensor(x),
                                                torch.tensor(a),
                                                torch.tensor(b))
            _close(tda, jda, rtol=1e-4, atol=1e-6)
            _close(tdb, jdb, rtol=1e-4, atol=1e-6)


class TestCombinators:
    def test_nested_samples(self):
        @ta.expectation
        def loss(p, mu):
            b = ta.flip_enum(p)
            return ta.normal_reparam(torch.where(b, mu, mu * 0.0), 1.0)

        gp, gmu = loss.grad_estimate(_keys(2000)[1], (0.3, 2.0))
        _close(gp.mean(), 2.0, atol=1e-4)
        m, se = _mean_se(gmu)
        assert abs(m - 0.3) < 4 * se + 1e-6

    def test_baseline_equivalence(self):
        b_prim = ta.baseline(ta.flip_reinforce)

        @ta.expectation
        def loss(p):
            return torch.where(b_prim(1.0, p), 3.0, -1.0)

        (g,) = loss.grad_estimate(_keys(4000)[1], (0.3,))
        m, se = _mean_se(g)
        assert abs(m - 4.0) < 4 * se

    def test_cond_with_samples(self):
        @ta.expectation
        def loss(p, mu):
            x = ta.normal_reparam(mu, 1.0)
            return ta.cond(x > 0.0, lambda m: ta.normal_reparam(m, 1.0) * 2.0,
                           lambda m: m * 0.0, mu)

        g = loss.grad_estimate(_tkey(KEY), (0.5, 1.0))
        assert all(bool(torch.isfinite(gi)) for gi in g)

    def test_cond_branches_draw_fresh_noise(self):
        """Both branches of a per-execution cond run, each on its own key:
        E[cond(b, x1, x2)^2] = 1 for independent standard normals (the
        same noise in both would give it too, so check the branches
        differ)."""
        @ta.expectation
        def loss(p):
            b = ta.flip_enum(p)
            return ta.cond(b, lambda: ta.normal_reparam(0.0, 1.0),
                           lambda: -ta.normal_reparam(0.0, 1.0))

        vals = loss.estimate(_keys(4000)[1], (0.5,))
        # 0.5·x1 − 0.5·x2: mean 0, variance 0.5 with distinct noise
        # (0 if the branches shared it).
        assert abs(float(vals.var()) - 0.5) < 0.05

    def test_non_tail_call_site_in_cond_raises(self):
        """Once refused, now run as ``jax.vmap`` of the JAX package's CPS
        ``switch`` runs it: each execution takes its own branch's
        estimate, here the enumerated flip's exact 1 where x > 0 and 0
        elsewhere (``test_torch_adev_cond.py`` holds it to JAX)."""
        @ta.expectation
        def loss(p):
            x = ta.normal_reparam(0.0, 1.0)
            return ta.cond(x > 0, lambda: torch.where(ta.flip_enum(p), 1.0,
                                                      0.0),
                           lambda: torch.zeros(()))

        (g,) = loss.grad_estimate(_keys(4000)[1], (0.3,))
        g = g.numpy()
        assert set(np.unique(g)) <= {0.0, 1.0}
        mean, se = g.mean(), g.std() / np.sqrt(g.size)
        assert abs(mean - 0.5) <= 4 * se

    def test_python_predicate_runs_one_branch(self):
        @ta.expectation
        def loss(p):
            return ta.cond(True, lambda: torch.where(ta.flip_enum(p), 2.0,
                                                     0.0),
                           lambda: torch.zeros(()))

        _close(loss.grad_estimate(_tkey(KEY), (0.3,))[0], 2.0)


class TestFlipCondExactness:
    @pytest.mark.parametrize("p", [0.1, 0.3, 0.5, 0.7, 0.9])
    def test_forward_and_reverse(self, p):
        @ta.expectation
        def loss(p):
            b = ta.flip_enum(p)
            return ta.cond(b, lambda q: q * 0.0, lambda q: -q / 2.0, p)

        d = loss.jvp_estimate(_tkey(KEY), ta.Dual(torch.tensor(p),
                                                  torch.tensor(1.0)))
        assert float(d.tangent) == pytest.approx(p - 0.5, rel=1e-4)
        (g,) = loss.grad_estimate(_tkey(KEY), (p,))
        assert float(g) == pytest.approx(p - 0.5, abs=1e-4)

    def test_add_cost_on_pure_continuation(self):
        @ta.expectation
        def loss_mvd(p):
            b = ta.flip_mvd(p)
            ta.add_cost(5.0)
            return torch.where(b, 1.0, 0.3)

        for k in range(6):
            d = loss_mvd.jvp_estimate(random.fold_in(_tkey(KEY), k),
                                      ta.Dual(torch.tensor(0.4),
                                              torch.tensor(1.0)))
            assert float(d.tangent) == pytest.approx(0.7, abs=1e-5)

        @ta.expectation
        def loss_enum(p):
            b = ta.flip_enum(p)
            ta.add_cost(5.0)
            return torch.where(b, 1.0, 0.3)

        d = loss_enum.jvp_estimate(_tkey(KEY), ta.Dual(torch.tensor(0.4),
                                                       torch.tensor(1.0)))
        assert float(d.tangent) == pytest.approx(0.7, abs=1e-5)
        assert float(d.primal) == pytest.approx(0.4 + 0.6 * 0.3 + 5.0,
                                                abs=1e-5)


class TestTailCallKeyReuse:
    """The reference fault and the port's repair: two reparameterized
    sites in a row."""

    def test_port_draws_fresh_noise(self):
        @ta.expectation
        def loss(mu):
            a = ta.normal_reparam(mu, 1.0)
            b = ta.normal_reparam(mu, 1.0)
            return (a - b) ** 2

        vals = loss.estimate(_keys(4000)[1], (0.0,))
        m, se = _mean_se(vals)
        assert abs(m - 2.0) < 4 * se, (m, se)

    def test_reference_shares_noise(self):
        """The JAX package's estimate of E[(a − b)^2] is 0 on every key
        (``adev/core.py:87-89``); recorded, not repaired there."""
        loss = ja.expectation(lambda mu: (ja.normal_reparam(mu, 1.0)
                                          - ja.normal_reparam(mu, 1.0)) ** 2)
        vals = jax.jit(jax.vmap(lambda k: loss.estimate(k, (0.0,))))(
            jax.random.split(KEY, 200))
        assert float(jnp.max(jnp.abs(vals))) == 0.0


class TestBatchedSites:
    """In-program lanes: the JAX package's ``vmap`` of a site inside the
    program is a site whose bound key has lanes behind the batch."""

    def test_lanes_reparam_pathwise(self):
        @ta.expectation
        def loss(mu):
            m = mu[..., None].expand(mu.shape + (8,))
            xs = ta.sample_primitive(ta.normal_reparam, m, 1.0,
                                     key=_lanes(m.shape))
            return (xs * xs).mean(-1)

        (g,) = loss.grad_estimate(_keys(2000)[1], (1.5,))
        m, se = _mean_se(g)
        assert abs(m - 3.0) < 4 * se

    @pytest.mark.parametrize("prim,n,want", [
        ("flip_reinforce", 4, 4.0), ("normal_reinforce", 3, 3.0)])
    def test_lanes_reinforce_unbiased(self, prim, n, want):
        site = getattr(ta, prim)

        @ta.expectation
        def loss(x):
            xs = x[..., None].expand(x.shape + (n,))
            args = (xs,) if prim == "flip_reinforce" else (xs, 1.0)
            v = ta.sample_primitive(site, *args, key=_lanes(xs.shape))
            return v.to(torch.float32).sum(-1)

        x0 = 0.3 if prim == "flip_reinforce" else 0.5
        (g,) = loss.grad_estimate(_keys(6000)[1], (x0,))
        m, se = _mean_se(g)
        assert abs(m - want) < 4 * se, (m, se)


class TestEnumUnderVmap:
    def test_separable_exact(self):
        @ta.expectation
        def loss(ps):
            bs = ta.sample_primitive(ta.flip_enum, ps, key=_lanes(ps.shape))
            return torch.where(bs, 3.0, -1.0).sum(-1)

        ps = torch.tensor([0.3, 0.6, 0.9])
        for k in range(3):
            (g,) = loss.grad_estimate(random.key(k), (ps,))
            _close(g, 4.0 * np.ones(3))

    def test_coupled_unbiased_and_reference(self):
        @ta.expectation
        def loss(ps):
            bs = ta.sample_primitive(ta.flip_enum, ps, key=_lanes(ps.shape))
            return torch.where(bs, 2.0, 0.5).prod(-1)

        ps = torch.tensor([0.4, 0.7])
        e0, e1 = 2 * 0.4 + 0.5 * 0.6, 2 * 0.7 + 0.5 * 0.3
        want = np.array([1.5 * e1, 1.5 * e0])
        (g,) = loss.grad_estimate(_keys(2000)[1], (ps.expand(2000, 2),))
        m, se = _mean_se(g)
        assert np.all(np.abs(m - want) < 4 * se + 1e-6), (m, se)

    def test_categorical_separable_exact(self):
        f = torch.tensor([1.0, 2.0, 4.0])

        @ta.expectation
        def loss(logits):
            idx = ta.sample_primitive(ta.categorical_enum_parallel, logits,
                                      key=_lanes(logits.shape[:-1]))
            return f[idx].sum(-1)

        p = np.array([[0.2, 0.3, 0.5], [0.5, 0.25, 0.25]])
        (g,) = loss.grad_estimate(_tkey(KEY), (torch.tensor(
            np.log(p), dtype=torch.float32),))
        fn = f.numpy()
        _close(g, p * (fn[None] - (p * fn).sum(1, keepdims=True)),
               rtol=1e-4, atol=1e-6)

    def test_enum_lanes_with_downstream_reparam(self):
        @ta.expectation
        def loss(ps, mu):
            bs = ta.sample_primitive(ta.flip_enum, ps, key=_lanes(ps.shape))
            shift = torch.where(bs, 1.0, 0.0).sum(-1)
            return ta.normal_reparam(mu + shift, 0.1)

        gp, _ = loss.grad_estimate(_keys(500)[1], (
            torch.tensor([0.2, 0.8]).expand(500, 2), 0.5))
        m, se = _mean_se(gp)
        assert np.all(np.abs(m - 1.0) < 4 * se + 1e-6)

    def test_enum_lanes_cost_n_times_k_runs(self):
        @ta.expectation
        def loss(ps):
            bs = ta.sample_primitive(ta.flip_enum, ps, key=_lanes(ps.shape))
            return torch.where(bs, 1.0, 0.0).prod(-1)

        r0 = tcore.program_runs()
        loss.grad_estimate(_tkey(KEY), (torch.tensor([0.3, 0.5, 0.7]),))
        # the run up to the site, the dual continuation, 3 lanes x 2 values
        assert tcore.program_runs() - r0 == 2 + 3 * 2


class TestNestedVmap:
    def test_nested_reparam_unbiased(self):
        mus = torch.tensor([[0.5, -1.0, 2.0], [1.5, 0.0, -0.5]])

        @ta.expectation
        def loss(m):
            xs = ta.sample_primitive(ta.normal_reparam, m, 1.0,
                                     key=_lanes(m.shape))
            return (xs ** 2).sum((-2, -1))

        (g,) = loss.grad_estimate(_keys(4000)[1], (mus.expand(4000, 2, 3),))
        m, se = _mean_se(g)
        assert np.all(np.abs(m - 2.0 * mus.numpy()) < 4 * se)
        assert float(g.std()) > 0.01

    def test_nested_flip_enum_separable_exact(self):
        w = torch.tensor([[3.0, 1.0], [2.0, 5.0]])

        @ta.expectation
        def loss(ps):
            bs = ta.sample_primitive(ta.flip_enum, ps, key=_lanes(ps.shape))
            return torch.where(bs, w, -w).sum((-2, -1))

        (g,) = loss.grad_estimate(random.key(1), (torch.tensor(
            [[0.3, 0.6], [0.8, 0.2]]),))
        _close(g, 2.0 * w.numpy(), rtol=1e-4)

    def test_nested_lanes_independent(self):
        @ta.expectation
        def loss(mu):
            m = mu[..., None, None].expand(mu.shape + (4, 4))
            xs = ta.sample_primitive(ta.normal_reparam, m, 1.0,
                                     key=_lanes(m.shape))
            return xs.sum((-2, -1)) ** 2

        vals = loss.estimate(_keys(3000)[1], (0.0,))
        m, se = _mean_se(vals)
        assert abs(m - 16.0) < 4 * se


class TestScanFreshKeys:
    """``lax.scan`` bodies become Python loops: each iteration's site is
    a sequential site with a fresh key."""

    @staticmethod
    def _loss(power):
        @ta.expectation
        def loss(mu):
            out = mu * 0.0
            for _ in range(3):
                out = out + ta.normal_reparam(mu, 1.0)
            return out ** power

        return loss

    def test_fresh_eps_per_step_and_estimate(self):
        vals = self._loss(2).estimate(_keys(3000)[1], (0.0,))
        m, se = _mean_se(vals)
        assert abs(m - 3.0) < 4 * se
        assert float(vals.std()) > 0.5

    def test_gradient_unbiased(self):
        (g,) = self._loss(2).grad_estimate(_keys(3000)[1], (0.5,))
        m, se = _mean_se(g)
        assert abs(m - 9.0) < 4 * se
        assert float(g.std()) > 0.5

    def test_random_walk_pathwise(self):
        @ta.expectation
        def loss(mu):
            x = mu
            for _ in range(5):
                x = ta.normal_reparam(x, 0.3)
            return x

        (g,) = loss.grad_estimate(_keys(500)[1], (1.0,))
        _close(g, np.ones(500), atol=1e-5)

    def test_distinct_interpreter_keys_differ(self):
        loss = self._loss(1)
        d1 = loss.jvp_estimate(random.key(0), (ta.Dual(torch.tensor(0.0),
                                                       torch.tensor(1.0)),))
        d2 = loss.jvp_estimate(random.key(1), (ta.Dual(torch.tensor(0.0),
                                                       torch.tensor(1.0)),))
        assert float(d1.primal) != float(d2.primal)
        assert float(d1.tangent) == pytest.approx(3.0)


class TestReexecution:
    """Continuations re-run the program from its start: it must be
    deterministic given its keys, and each enumerated site costs one run
    per support value."""

    def test_program_randomness_replays(self):
        # The program draws z from its own key (not an ADEV site); both
        # enumerated branches must see the same z, so the derivative is
        # exactly f(True, z) - f(False, z).
        def f(b, z):
            return torch.where(b, z * z, 3.0 * z)

        def program(key):
            @ta.expectation
            def loss(p):
                z = random.normal(key, ())
                return f(ta.flip_enum(p), z)

            return loss

        for s in range(4):
            key = random.key(s)
            z = random.normal(key, ())
            (g,) = program(key).grad_estimate(key, (0.3,))
            _close(g, f(torch.tensor(True), z) - f(torch.tensor(False), z))

    def test_run_counts(self):
        @ta.expectation
        def pathwise(mu):
            return ta.normal_reparam(mu, 1.0) + ta.normal_reparam(mu, 2.0)

        @ta.expectation
        def enumerated(p):
            return torch.where(ta.flip_enum(p), 1.0, 0.0)

        r0 = tcore.program_runs()
        pathwise.grad_estimate(_tkey(KEY), (0.5,))
        assert tcore.program_runs() - r0 == 1
        r0 = tcore.program_runs()
        enumerated.grad_estimate(_tkey(KEY), (0.5,))
        assert tcore.program_runs() - r0 == 3

    def test_plain_execution_honors_the_key(self):
        a = ta.sample_primitive(ta.flip_reinforce, torch.full((64,), 0.5),
                                key=random.split(random.key(1), 64))
        b = ta.sample_primitive(ta.flip_reinforce, torch.full((64,), 0.5),
                                key=random.split(random.key(2), 64))
        assert not torch.equal(a, b)
        v = ta.normal_reinforce.sample(random.key(0), torch.zeros(8),
                                       torch.ones(8))
        assert v.shape == (8,) and float(v.std()) > 1e-3
