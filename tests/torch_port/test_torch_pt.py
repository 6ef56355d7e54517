"""The port's parallel tempering (``genjax_torch/inference/pt.py``)
against the JAX package's on the same key data.

The port writes the rungs out as a batch and puts a batch of independent
ladders in front of them (a key ``L + (2,)``), where the JAX package
runs one ladder and vmaps over keys. The two packages draw the same
uniforms and normals to a few ulp, so every accept and swap decision,
the cold chain's samples and both rates agree on the same keys."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

import genjax_torch as gt
import genjax_tpu as gj
from genjax_torch import entry
from genjax_torch.core import random
from genjax_torch.inference import Target
from genjax_torch.inference.pt import _pair_swap, parallel_tempering
from genjax_torch.inference.requests import Rejuvenate
from genjax_torch.interop import key_from_numpy
from genjax_tpu.inference import Target as JTarget
from genjax_tpu.inference.pt import _pair_swap as j_pair_swap
from genjax_tpu.inference.pt import parallel_tempering as j_pt

KEY = jax.random.key(314159)


def _tkey(k):
    return key_from_numpy(np.asarray(jax.random.key_data(k)))


def _close(got, want, **kw):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), **kw)


def _conjugate(lib):
    @lib.gen
    def conjugate_normal(obs_std):
        mu = lib.normal(0.0, 1.0) @ "mu"
        return lib.normal(mu, obs_std) @ "y"

    return conjugate_normal


def _tdrift(scale=0.4):
    @gt.gen
    def drift(old):
        return gt.normal(old["mu"], scale) @ "mu"

    return Rejuvenate(drift)


class TestMatchesReference:
    def test_config6_ladders_match(self):
        """Config 6's model, 6 rungs, the default Regenerate move: 8
        ladders x 12 steps on the same key data."""
        ys = np.asarray(entry.tempered_observations(64, "cpu"))

        @gj.gen
        def jmodel(sigma):
            mu = gj.normal(0.0, 3.0) @ "mu"
            _ = gj.mv_normal_diag(mu * jnp.ones(64),
                                  sigma * jnp.ones(64)) @ "ys"

        jrun = j_pt(JTarget(jmodel, (0.8,), gj.C["ys"].set(jnp.asarray(ys))),
                    6)
        keys = jax.random.split(KEY, 8)
        want = jax.jit(jax.vmap(lambda k: jrun(
            k, 12, collect=lambda tr: tr.get_choices()["mu"],
            burn_in=2)))(keys)
        trun = parallel_tempering(Target(entry.tempered_model(64), (0.8,),
                                         gt.C["ys"].set(torch.tensor(ys))), 6)
        got = trun(_tkey(keys), 12, collect=lambda tr: tr.get_choices()["mu"],
                   burn_in=2)
        _close(got.samples, want.samples, rtol=1e-4, atol=1e-5)
        _close(got.accept_rate, want.accept_rate, atol=1e-6)
        _close(np.nan_to_num(got.swap_rate.numpy(), nan=-1.0),
               np.nan_to_num(np.asarray(want.swap_rate), nan=-1.0), atol=1e-6)
        _close(got.traces.get_choices()["mu"],
               want.traces.get_choices()["mu"], rtol=1e-4, atol=1e-5)

    def test_pair_swap_matches_and_is_an_involution(self):
        tree = {"a": np.arange(12.0).reshape(2, 6),
                "b": np.arange(24.0).reshape(2, 6, 2)}
        acc = np.array([[True, False, True, False, False, False],
                        [False, True, False, False, True, False]])
        ttree = {k: torch.tensor(v) for k, v in tree.items()}
        once = _pair_swap(ttree, torch.tensor(acc))
        twice = _pair_swap(once, torch.tensor(acc))
        for k in tree:
            want = jax.vmap(lambda t, a: j_pair_swap(t, a))(
                jnp.asarray(tree[k]), jnp.asarray(acc))
            _close(once[k], want)
            _close(twice[k], tree[k])
        _close(once["a"][0], [1.0, 0.0, 3.0, 2.0, 4.0, 5.0])


class TestColdChain:
    def test_posterior_mean_and_std(self):
        tgt = Target(_conjugate(gt), (0.5,), gt.C["y"].set(1.0))
        run = parallel_tempering(tgt, 4, make_request=_tdrift)
        res = run(random.split(_tkey(KEY), 128), 250,
                  collect=lambda tr: tr.get_choices()["mu"], burn_in=50)
        mus = res.samples.numpy()
        assert mus.shape == (128, 200)
        assert abs(mus.mean() - 0.8) < 2e-2
        assert abs(mus.std() - np.sqrt(0.2)) < 2e-2
        assert np.all(res.accept_rate.mean(0).numpy() > 0.05)
        assert np.all(res.swap_rate.mean(0).numpy() > 0.05)

    def test_all_cold_ladder_reduces_to_mh(self):
        tgt = Target(_conjugate(gt), (0.5,), gt.C["y"].set(1.0))
        run = parallel_tempering(tgt, torch.ones(3), make_request=_tdrift)
        res = run(random.split(_tkey(KEY), 64), 150,
                  collect=lambda tr: tr.get_choices()["mu"], burn_in=50)
        assert np.allclose(res.swap_rate.numpy(), 1.0)
        assert abs(res.samples.numpy().mean() - 0.8) < 3e-2

    def test_config6_builder_within_mcse(self):
        run, exact = entry.build_pt(64, 8, 60, 60, device="cpu")
        res = run(random.key(1))
        s = res.samples.numpy().astype(np.float64)
        means = s.mean(1)
        mcse = means.std() / np.sqrt(len(means))
        assert abs(s.mean() - exact["mean"]) < 4 * mcse + 1e-4
        assert abs(s.std() - exact["sd"]) < 0.1 * exact["sd"]


class TestMultimodalMixing:
    def test_pt_visits_both_modes(self):
        @gt.gen
        def bimodal():
            x = gt.normal(0.0, 4.0) @ "x"
            _ = gt.normal(x * x, 0.5) @ "y"

        def local():
            @gt.gen
            def drift(old):
                return gt.normal(old["x"], 0.3) @ "x"

            return Rejuvenate(drift)

        tgt = Target(bimodal, (), gt.C["y"].set(4.0))
        run = parallel_tempering(tgt, torch.tensor([0.02, 0.1, 0.3, 1.0]),
                                 make_request=local)
        res = run(random.split(random.key(11), 16), 300,
                  collect=lambda tr: tr.get_choices()["x"], burn_in=50)
        xs = res.samples.numpy()
        signs = np.sign(xs)
        flips = (signs[:, 1:] != signs[:, :-1]).sum()
        assert flips >= 10
        assert 0.15 < (signs > 0).mean() < 0.85
        assert abs(np.abs(xs).mean() - 2.0) < 0.2
