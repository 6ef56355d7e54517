"""Chain-sharded MCMC of the port: ``warmup_chains`` / ``run_nuts`` with
``mesh=`` and independent HMC chains, on gloo worlds, with the
cross-chain statistics held against the JAX package.

- ``_cross_chain_stats``: within 1e-6 of the JAX package's on the same
  inputs (its mesh of the same size); ``mesh=None`` and worlds 1, 2, 4
  and 8 bitwise equal; awkward chain counts (12, 20, 100) agree with
  plain reductions; 16 chains over 8 ranks (2 a rank) stay bitwise.
- ``warmup_chains`` and ``run_nuts`` (the normal model, and the gamma
  model through ``transforms="auto"``): eps, mass and every draw bitwise
  equal for ``mesh=None`` and worlds 1, 2 and 4.
- Communication, from ``parallel.comm``: warmup's only collectives are
  all-gathers of chain-group partials, never the (chains, D) positions.
- ``build_nuts_regression(mesh=...)`` on the CPU: a world of 2 gives the
  draws of ``mesh=None``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_bodies as B
from genjax_torch.inference.adaptation import _cross_chain_stats
from genjax_tpu.inference.adaptation import _cross_chain_stats as j_stats

KEY = np.asarray(jax.random.key_data(jax.random.key(314159)))


def _mesh_of(d):
    return jax.sharding.Mesh(np.asarray(jax.devices()[:d]), ("chains",))


def _zs_acc(n=64, dim=5, seed=0):
    zs = np.asarray(jax.random.normal(jax.random.key(seed), (n, dim)))
    acc = np.asarray(jax.random.uniform(jax.random.key(seed + 1), (n,)))
    return zs, acc


@pytest.mark.parametrize("d", (1, 2, 4))
def test_cross_chain_stats_match_jax(gloo_worlds, d):
    """256 chains: groups of 4 (the derived group keeps six powers of two
    free), so the partials are (64, D + 1) against (256, D) positions."""
    zs, acc = _zs_acc(256)
    got, comm = gloo_worlds(d).run(B.cross_chain, zs, acc)[0]
    want = jax.jit(lambda z, a: j_stats(z, a, _mesh_of(d), "chains"))(
        jnp.asarray(zs), jnp.asarray(acc))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-6, atol=1e-7)
    assert set(comm["by_op"]) == {"all_gather/chain_partials"}
    assert comm["max_elements"] == 64 * 6 < 256 * 5


def test_cross_chain_stats_bitwise_all_worlds(gloo_worlds):
    zs, acc = _zs_acc()
    ref = [x.numpy() for x in _cross_chain_stats(torch.tensor(zs),
                                                 torch.tensor(acc))]
    for d in (1, 2, 4, 8):
        for got, _ in gloo_worlds(d).run(B.cross_chain, zs, acc):
            for g, r in zip(got, ref):
                np.testing.assert_array_equal(g, r)


def test_small_per_rank_chain_count_bitwise(gloo_worlds):
    """16 chains over 8 ranks: 2 a rank, below the group cap."""
    zs, acc = _zs_acc(16, 2, 5)
    ref = [x.numpy() for x in _cross_chain_stats(torch.tensor(zs),
                                                 torch.tensor(acc))]
    for d in (2, 8):
        got, _ = gloo_worlds(d).run(B.cross_chain, zs, acc)[0]
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g, r)


@pytest.mark.parametrize("n", [12, 20, 100])
def test_awkward_chain_counts_match_plain_reductions(n):
    zs, acc = _zs_acc(n, 2, n)
    mean_b, m2_b, a_mean = _cross_chain_stats(torch.tensor(zs),
                                              torch.tensor(acc))
    np.testing.assert_allclose(mean_b.numpy(), zs.mean(0), rtol=1e-5)
    np.testing.assert_allclose(float(a_mean), acc.mean(), rtol=1e-5)
    np.testing.assert_allclose(m2_b.numpy(),
                               ((zs - zs.mean(0)) ** 2).sum(0), rtol=1e-5)


def test_warmup_bitwise_all_worlds(gloo_worlds):
    from genjax_torch.inference import warmup_chains

    z0 = np.asarray(jax.random.normal(jax.random.key(0), (64, 3)))
    key = np.asarray(jax.random.key_data(jax.random.key(2)))
    ref = warmup_chains(B._quartic, torch.tensor(z0), B._key(key),
                        num_warmup=25, max_depth=4)
    ref = [x.numpy() for x in ref]
    for d in (1, 2, 4):
        got = gloo_worlds(d).run(B.warmup, z0, key, 25, 4)
        np.testing.assert_array_equal(np.concatenate([r[0] for r in got]),
                                      ref[0])
        for r in got:
            np.testing.assert_array_equal(r[1], ref[1])
            np.testing.assert_array_equal(r[2], ref[2])
            assert set(r[3]["by_op"]) == {"all_gather/chain_partials"}


def test_warmup_collectives_are_group_partials_only(gloo_worlds):
    """256 chains x 4 dims over 4 ranks (``test_sharded_mcmc.py``'s HLO
    test): no collective carries the (chains, D) positions."""
    z0 = np.asarray(jax.random.normal(jax.random.key(0), (256, 4)))
    key = np.asarray(jax.random.key_data(jax.random.key(1)))
    for r in gloo_worlds(4).run(B.warmup, z0, key, 10, 3):
        c = r[3]
        assert set(c["by_op"]) == {"all_gather/chain_partials"}
        assert c["by_op"]["all_gather/chain_partials"]["calls"] == 2 * 10
        assert c["max_elements"] == (256 // 4) * (4 + 1) < 256 * 4


def test_warmup_matches_jax_eps_and_mass():
    """The mesh-free warmup against the JAX package's, as
    ``test_torch_nuts.py`` holds it: eps and mass within 1e-4."""
    from genjax_torch.inference import warmup_chains
    from genjax_tpu.inference.adaptation import warmup_chains as j_warmup

    z0 = np.asarray(jax.random.normal(jax.random.key(0), (64, 3)))
    key = jax.random.key(2)

    def logd(z):
        return -0.5 * jnp.sum(z ** 2) - 0.1 * jnp.sum(z ** 4)

    _, j_eps, j_mass = jax.jit(lambda z, k: j_warmup(
        logd, z, k, num_warmup=25, max_depth=4, mesh=_mesh_of(4)))(
        jnp.asarray(z0), key)
    _, eps, mass = warmup_chains(
        B._quartic, torch.tensor(z0),
        B._key(np.asarray(jax.random.key_data(key))), num_warmup=25,
        max_depth=4)
    np.testing.assert_allclose(float(eps), float(j_eps), rtol=1e-4)
    np.testing.assert_allclose(mass.numpy(), np.asarray(j_mass), rtol=1e-4)


@pytest.mark.parametrize("model,transforms", [("normal", None),
                                              ("gamma", "auto")])
def test_run_nuts_bitwise_all_worlds(gloo_worlds, model, transforms):
    args = (KEY, model, 64, 40, 40, 5, transforms)
    ref = gloo_worlds(1).run(B.nuts, *args, False)[0]
    for d in (1, 2, 4):
        got = gloo_worlds(d).run(B.nuts, *args)
        for i in range(2):
            np.testing.assert_array_equal(
                np.concatenate([r[i] for r in got]), ref[i])
    assert np.isfinite(ref[0]).all()
    if model == "gamma":
        assert (ref[1] > 0).all()


def test_hmc_chains_bitwise(gloo_worlds):
    """Independent HMC chains, each on the keys of its global index: the
    same draws on every layout (no cross-chain coupling)."""
    ref = gloo_worlds(1).run(B.hmc_chains, KEY, 256, 10)[0]
    for d in (2, 4):
        got = gloo_worlds(d).run(B.hmc_chains, KEY, 256, 10)
        np.testing.assert_array_equal(np.concatenate(got), ref)


def test_entry_nuts_regression_mesh(gloo_worlds):
    from genjax_torch import entry as E

    run, _ = E.build_nuts_regression(8, 10, 10, max_depth=4, device="cpu")
    chms, _ = run(B._key(KEY))
    got = gloo_worlds(2).run(B.entry_nuts, KEY, 8, 10, 10)
    np.testing.assert_array_equal(np.concatenate([r[0] for r in got]),
                                  chms["slope"].numpy())
    np.testing.assert_array_equal(np.concatenate([r[1] for r in got]),
                                  chms["icept"].numpy())
