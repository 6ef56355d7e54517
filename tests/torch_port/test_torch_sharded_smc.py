"""Sharded SMC and particle filtering of the port (``parallel/smc.py``,
``parallel/pf.py`` and the sharding hooks of ``inference/pf.py``) on gloo
worlds, and the sharded entry points on the CPU.

- ``sharded_particle_filter`` on the JAX test's model
  (``tests/parallel/test_sharded_smc.py``): log Z within 1e-3 of the JAX
  package's on its mesh of the same size; bitwise equal across worlds 1,
  2 and 4; no collective carries ``n`` elements; ``batched=True`` raises.
- ``sharded_importance`` weights and ``sharded_smc_step`` (1-D, and a
  2 x 2 mesh with a tuple axis): bitwise equal across worlds; log Z near
  log 0.5; ``sharded_resample`` keeps log Z and equalizes the weights, by
  both impls.
- The entry points reach their sharded paths with ``device="cpu"`` on
  worlds of 1 and 2 processes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_bodies as B
from genjax_tpu.parallel import sharded_particle_filter as j_sharded_pf

N = 4096
YS = np.asarray([0.1, -0.2, 0.3, 0.0], np.float32)
KEY = jax.random.key(314159)
WORLDS = (1, 2, 4)


def _kd(k):
    return np.asarray(jax.random.key_data(k))


def _mesh_of(d):
    return jax.sharding.Mesh(np.asarray(jax.devices()[:d]), ("particles",))


def _jax_pf(d):
    def init(key):
        return jax.random.normal(key), jnp.zeros(())

    def step(key, x, y):
        x_new = 0.9 * x + 0.3 * jax.random.normal(key)
        return x_new, jax.scipy.stats.norm.logpdf(y, x_new, 0.5)

    pf = j_sharded_pf(init, step, N, _mesh_of(d))
    final, _ = jax.jit(lambda k: pf(k, jnp.asarray(YS)))(KEY)
    return float(final.log_z)


@pytest.mark.parametrize("d", WORLDS)
def test_sharded_particle_filter_matches_jax(gloo_worlds, d):
    got = gloo_worlds(d).run(B.particle_filter, _kd(KEY), YS, N)
    assert len({r["log_z"] for r in got}) == 1
    assert abs(got[0]["log_z"] - _jax_pf(d)) < 1e-3
    for r in got:
        assert r["comm"]["max_elements"] < N
        assert r["particles"].shape == (N // d,)


def test_sharded_particle_filter_bitwise_across_worlds(gloo_worlds):
    runs = {d: gloo_worlds(d).run(B.particle_filter, _kd(KEY), YS, N)
            for d in WORLDS}
    ref = runs[1][0]
    for d in WORLDS[1:]:
        np.testing.assert_array_equal(
            np.concatenate([r["particles"] for r in runs[d]]),
            ref["particles"])
        np.testing.assert_array_equal(
            np.concatenate([r["lw"] for r in runs[d]]), ref["lw"])
        assert runs[d][0]["log_z"] == ref["log_z"]
        np.testing.assert_array_equal(runs[d][0]["log_zs"], ref["log_zs"])


def test_gathered_baseline_filter_agrees(gloo_worlds):
    """``use_collectives=False``: the replicated baseline gathers the
    ensemble (it carries n elements) and lands near the product path."""
    got = gloo_worlds(2).run(B.particle_filter, _kd(KEY), YS, N, False)
    prod = gloo_worlds(2).run(B.particle_filter, _kd(KEY), YS, N, True)
    assert abs(got[0]["log_z"] - prod[0]["log_z"]) < 1e-3
    assert got[0]["comm"]["max_elements"] == N


def test_batched_sharded_filter_raises(gloo_worlds):
    msg = gloo_worlds(2).run(B.batched_filter_error)[0]
    assert msg is not None and "per-particle" in msg


def test_particle_range_with_batched_raises():
    from genjax_torch.inference.pf import particle_filter

    with pytest.raises(ValueError, match="batched"):
        particle_filter(lambda k: None, lambda k, s, y: None, 8,
                        batched=True, particle_range=(0, 4))


def test_particle_filter_hooks_default_to_the_unsharded_run():
    """Without hooks the driver is the single-device one; with the range
    of the whole ensemble and the default reductions passed explicitly it
    gives the same bits."""
    from genjax_torch.core import random
    from genjax_torch.inference.pf import _lse_ess, particle_filter
    from genjax_torch.inference.smc import resample_tree

    init, step = B._pf_model()
    ys = torch.tensor(YS)
    a, za = particle_filter(init, step, 512)(random.key(1), ys)
    b, zb = particle_filter(
        init, step, 512, particle_range=(0, 512), stats_fn=_lse_ess,
        resample_fn=lambda k, lw, p: resample_tree(k, lw, p, 512))(
            random.key(1), ys)
    assert torch.equal(a.particles, b.particles)
    assert torch.equal(za, zb)


@pytest.mark.parametrize("d", WORLDS)
def test_sharded_importance_weights_bitwise(gloo_worlds, d):
    got = gloo_worlds(d).run(B.importance_weights, _kd(KEY), 1024)
    ref = gloo_worlds(1).run(B.importance_weights, _kd(KEY), 1024)[0]
    np.testing.assert_array_equal(np.concatenate([r[0] for r in got]),
                                  ref[0])
    assert got[0][1] == ref[1]
    assert abs(ref[1] - np.log(0.5)) < 0.05


def test_sharded_smc_step_bitwise_across_worlds(gloo_worlds):
    """A forced resample (threshold 1.1) through the product path."""
    outs = [gloo_worlds(d).run(B.smc_step, _kd(KEY), 2048, 1.1)
            for d in (1, 2, 4)]
    for o in outs[1:]:
        np.testing.assert_array_equal(
            np.concatenate([r["p"] for r in o]), outs[0][0]["p"])
        assert o[0]["logz"] == outs[0][0]["logz"]
    assert abs(outs[0][0]["logz"] - np.log(0.5)) < 0.05


def test_sharded_smc_step_2d_mesh(gloo_worlds):
    """A 2 x 2 mesh with the tuple axis ("hosts", "chips") is the world
    of 4 in rank order: the same bits as the 1-D mesh."""
    two = gloo_worlds(4).run(B.smc_step, _kd(KEY), 64, 1.1, "collective",
                             True)
    one = gloo_worlds(4).run(B.smc_step, _kd(KEY), 64, 1.1)
    np.testing.assert_array_equal(np.concatenate([r["p"] for r in two]),
                                  np.concatenate([r["p"] for r in one]))
    assert two[0]["logz"] == one[0]["logz"]
    assert np.isfinite(two[0]["logz"])


def test_sharded_smc_step_gspmd_baseline(gloo_worlds):
    got = gloo_worlds(2).run(B.smc_step, _kd(KEY), 2048, 1.1, "gspmd")
    prod = gloo_worlds(2).run(B.smc_step, _kd(KEY), 2048, 1.1)
    assert abs(got[0]["logz"] - prod[0]["logz"]) < 1e-5
    mism = (np.concatenate([r["p"] for r in got])
            != np.concatenate([r["p"] for r in prod])).sum()
    assert mism <= 4


@pytest.mark.parametrize("impl", ["collective", "gspmd"])
def test_sharded_resample_keeps_logz_and_equalizes(gloo_worlds, impl):
    got = gloo_worlds(4).run(B.resample_collection, _kd(KEY),
                             _kd(jax.random.key(7)), 512, impl)[0]
    assert abs(got["logz_out"] - got["logz_in"]) < 1e-5
    assert abs(got["ess_out"] - 512.0) < 1e-3


# -- the entry points, half way (device="cpu") ---------------------------------


def test_entry_sharded_pf_bitwise_and_kalman(gloo_worlds):
    from genjax_torch import entry as E

    key = _kd(jax.random.key(2))
    one = gloo_worlds(1).run(B.entry_pf, key, 8192, 8, "tracking", True)
    two = gloo_worlds(2).run(B.entry_pf, key, 8192, 8, "tracking", True)
    assert one[0][0] == two[0][0] == two[1][0]
    assert np.isfinite(one[0][0])
    assert two[0][1]["max_elements"] < 8192
    lin = gloo_worlds(2).run(B.entry_pf, key, 8192, 15, "linear", True)[0][0]
    want = E.kalman_loglik(E.linear_observations(15))
    assert abs(lin - want) < 0.3
    base = gloo_worlds(2).run(B.entry_pf, key, 8192, 15, "linear", False)
    assert abs(base[0][0] - lin) < 0.3


def test_entry_sharded_sir_is_entrys_ensemble(gloo_worlds):
    """The sharded SIR runs entry()'s particles: log Ẑ agrees with
    ImportanceK's on the same key to f32 summation order."""
    from genjax_torch import entry as E
    from genjax_torch.core import random

    key = _kd(jax.random.key(0))
    one = gloo_worlds(1).run(B.entry_sir, key, 4096)[0]
    two = gloo_worlds(2).run(B.entry_sir, key, 4096)
    assert two[0] == two[1] == one
    sir, _ = E.entry(4096, device="cpu")
    mean, logz = sir(random.key(0))
    np.testing.assert_allclose(one[1], float(logz), rtol=1e-5)
    np.testing.assert_allclose(one[0], float(mean), rtol=1e-5)
    assert abs(one[0] - 0.6) < 0.02


def test_entry_points_raise_without_a_group():
    from genjax_torch import entry as E

    with pytest.raises(RuntimeError, match="init_distributed"):
        E.build_sharded_pf(64, 2, device="cpu")
    with pytest.raises(RuntimeError, match="init_distributed"):
        E.build_sharded_sir(64, device="cpu")
