"""The port's collectives (``genjax_torch/parallel/collectives.py``) on gloo
worlds of 1, 2 and 4 processes (and 8 once), against the JAX package on
its CPU mesh of the same size, on the same numpy inputs.

- ``_layout_free_block`` / ``_pick_block``: equal over a sweep of ``n``
  and caps, the same error text.
- ``blocked_stats``, ``shardmap_logz`` / ``_ess``: 1e-6 relative to JAX.
- The resamplers' offspring intervals: equal to JAX's except where an
  f32 cumulative value straddles a grid point (the two libraries add in
  their own orders); those ties are counted, and the resampled leaves
  are equal at every other slot.
- The product path is bitwise equal across worlds 1, 2, 4 and 8, for the
  awkward ``n``, every halo size and the skewed fallback, which is exact.
- Communication, from ``parallel.comm`` (where the JAX tests read the
  HLO): a resample gathers 3·(n/B) floats and sends 2·H halo slots of
  each leaf; a balanced resample makes zero ring trips; nothing carries
  ``n`` elements.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_bodies as B
from genjax_torch.parallel import collectives as TC
from genjax_tpu.inference.smc import resample_tree
from genjax_tpu.parallel import collectives as JC

N = 1 << 12
BLOCK = TC._layout_free_block(N, 256)       # 64: v2(N) - 6
WORLDS = (1, 2, 4)


def _mesh_of(d):
    return jax.sharding.Mesh(np.asarray(jax.devices()[:d]), ("particles",))


def _kd(k):
    return np.asarray(jax.random.key_data(k))


def _weights(seed, n=N, scale=3.0):
    return np.asarray(jax.random.normal(jax.random.key(seed), (n,))) * scale


def _inputs():
    lw = _weights(4)
    xs = np.asarray(jax.random.normal(jax.random.key(5), (N,)))
    aux = np.asarray(jax.random.normal(jax.random.key(6), (N, 3)))
    idx = np.arange(N, dtype=np.float32)
    return lw, (idx, xs, aux)


def _stitch(per_rank, i):
    return np.concatenate([r["out"][i] for r in per_rank])


def _counts(ancestors):
    """Cumulative offspring counts from the resampled index leaf."""
    return np.cumsum(np.bincount(ancestors.astype(np.int64), minlength=N))


def _hold_to_jax(got_leaves, want_leaves, max_ties=4):
    """Offspring intervals equal but at f32 ties (at most ``max_ties``
    particles, each off by one destination); leaves equal wherever the
    ancestor agrees."""
    cc_t, cc_j = _counts(got_leaves[0]), _counts(want_leaves[0])
    ties = cc_t != cc_j
    assert ties.sum() <= max_ties, ties.sum()
    assert np.abs(cc_t - cc_j).max(initial=0) <= 1
    same = got_leaves[0] == want_leaves[0]
    for g, w in zip(got_leaves, want_leaves):
        np.testing.assert_array_equal(g[same], w[same])
    return int(ties.sum())


class TestBlocks:
    def test_layout_free_block_sweep_matches_jax(self):
        for n in list(range(1, 300)) + [3000, 4096, 12288, 1 << 20, 100000]:
            for cap in (1, 7, 8, 64, 256):
                assert TC._layout_free_block(n, cap) == \
                    JC._layout_free_block(n, cap), (n, cap)

    @pytest.mark.parametrize("n,local_n", [(3000, 375), (1 << 12, 1 << 9),
                                           (12288, 4096), (3 << 8, 256)])
    def test_pick_block_matches_jax(self, n, local_n):
        def outcome(mod):
            try:
                return mod._pick_block(n, local_n, 256)
            except ValueError as e:
                return str(e)

        assert outcome(TC) == outcome(JC)

    def test_derivation_is_global_only(self):
        for n in (3000, 1 << 20, 4096, 12, 100):
            b = TC._layout_free_block(n, 256)
            v = (n & -n).bit_length() - 1
            for k in range(0, min(v, 6) + 1):
                assert (n >> k) % b == 0, (n, k, b)
        assert TC._layout_free_block(1 << 20, 256) == 256

    def test_block_partials_of_a_slice_are_rows_of_the_whole(self):
        """The rank-local part: each slice's partials are the rows of the
        one-rank partials, bit for bit (what phase 28b holds on the card)."""
        lw = torch.tensor(_weights(11, 1 << 14))
        m = lw.max()
        within, stats = TC.block_partials(lw, m, 256)
        for d in (2, 4, 8):
            per = lw.shape[0] // d
            for r in range(d):
                w, s = TC.block_partials(lw[r * per:(r + 1) * per], m, 256)
                rows = slice(r * per // 256, (r + 1) * per // 256)
                assert torch.equal(w, within[rows])
                assert torch.equal(s, stats[:, rows])


@pytest.mark.parametrize("d", WORLDS)
def test_blocked_stats_match_jax(gloo_worlds, d):
    lw = _weights(0)
    got = gloo_worlds(d).run(B.blocked, lw)
    want_logz, want_ess = jax.jit(
        lambda w: JC.blocked_stats(w, _mesh_of(d)))(jnp.asarray(lw))
    for r in got:
        np.testing.assert_allclose(r["logz"], float(want_logz), rtol=1e-6)
        np.testing.assert_allclose(r["ess"], float(want_ess), rtol=1e-6)
        assert (r["logz1"], r["ess1"]) == (r["logz"], r["ess"])
    # One max all-reduce and one all-gather of the 3·(n/B) partials.
    by = got[0]["comm"]["by_op"]
    assert by["all_gather/block_stats"]["elements"] == 3 * (N // BLOCK)
    assert by["all_reduce/max"]["elements"] == 1
    assert got[0]["comm"]["max_elements"] < N


@pytest.mark.parametrize("d", WORLDS)
def test_shardmap_stats_match_jax(gloo_worlds, d):
    lw = _weights(1)
    got = gloo_worlds(d).run(B.shardmap_stats, lw)
    want_logz, want_ess = jax.jit(lambda w: (
        JC.shardmap_logz(w, _mesh_of(d)), JC.shardmap_ess(w, _mesh_of(d))))(
        jnp.asarray(lw))
    for r in got:
        np.testing.assert_allclose(r["logz"], float(want_logz), rtol=1e-6)
        np.testing.assert_allclose(r["ess"], float(want_ess), rtol=1e-6)


@pytest.mark.parametrize("d", WORLDS)
def test_ring_resample_step_matches_jax(gloo_worlds, d):
    lw, leaves = _inputs()
    key = jax.random.key(3)
    got = gloo_worlds(d).run(B.ring_step, _kd(key), lw, leaves)
    want, want_logz, want_ess = jax.jit(
        lambda k, w, t: JC.ring_resample_step(k, w, t, _mesh_of(d)))(
        key, jnp.asarray(lw), tuple(jnp.asarray(v) for v in leaves))
    _hold_to_jax([_stitch(got, i) for i in range(3)],
                 [np.asarray(w) for w in want])
    np.testing.assert_allclose(got[0]["logz"], float(want_logz), rtol=1e-6)
    np.testing.assert_allclose(got[0]["ess"], float(want_ess), rtol=1e-6)


@pytest.mark.parametrize("d", WORLDS)
def test_ring_systematic_resample_matches_jax(gloo_worlds, d):
    lw, leaves = _inputs()
    key = jax.random.key(13)
    got = gloo_worlds(d).run(B.ring_resample, _kd(key), lw, leaves)
    want = jax.jit(
        lambda k, w, t: JC.ring_systematic_resample(k, w, t, _mesh_of(d)))(
        key, jnp.asarray(lw), tuple(jnp.asarray(v) for v in leaves))
    _hold_to_jax([np.concatenate([r[i] for r in got]) for i in range(3)],
                 [np.asarray(w) for w in want])


@pytest.mark.parametrize("d", WORLDS)
def test_shardmap_systematic_resample_matches_jax(gloo_worlds, d):
    lw, leaves = _inputs()
    key = jax.random.key(3)
    got = gloo_worlds(d).run(B.shardmap_resample, _kd(key), lw, leaves)
    want = jax.jit(
        lambda k, w, t: JC.shardmap_systematic_resample(k, w, t,
                                                        _mesh_of(d)))(
        key, jnp.asarray(lw), tuple(jnp.asarray(v) for v in leaves))
    _hold_to_jax([_stitch(got, i) for i in range(3)],
                 [np.asarray(w) for w in want])
    # The psum path streams every block around the whole ring.
    sends = got[0]["comm"]["by_op"].get("send/ring", {"calls": 0})
    assert sends["calls"] == 5 * (d - 1)     # runs and 3 leaves


def test_ring_step_near_the_single_device_resampler(gloo_worlds):
    lw, leaves = _inputs()
    key = jax.random.key(3)
    got = gloo_worlds(4).run(B.ring_resample, _kd(key), lw, leaves)
    want = resample_tree(key, jnp.asarray(lw), jnp.asarray(leaves[0]), N,
                         "systematic")
    mism = (np.concatenate([r[0] for r in got]) != np.asarray(want)).sum()
    assert mism <= 4, mism


def test_product_path_bitwise_across_worlds(gloo_worlds):
    lw, leaves = _inputs()
    key = _kd(jax.random.key(3))
    runs = [gloo_worlds(d).run(B.ring_step, key, lw, leaves)
            for d in (1, 2, 4, 8)]
    ref = runs[0]
    for run in runs[1:]:
        for i in range(3):
            np.testing.assert_array_equal(_stitch(run, i), _stitch(ref, i))
        for r in run:
            assert (r["logz"], r["ess"]) == (ref[0]["logz"], ref[0]["ess"])


def test_blocked_stats_bitwise_across_worlds_awkward_n(gloo_worlds):
    """n = 3000: n/D = 375 at D = 8, an odd layout-free block (125)."""
    lw = _weights(30, 3000, 2.0)
    outs = {d: gloo_worlds(d).run(B.blocked, lw) for d in WORLDS}
    vals = [(r["logz"], r["ess"]) for d in WORLDS for r in outs[d]]
    assert vals.count(vals[0]) == len(vals)
    want = float(jax.scipy.special.logsumexp(jnp.asarray(lw))
                 - jnp.log(3000))
    np.testing.assert_allclose(vals[0][0], want, rtol=1e-5)


@pytest.mark.parametrize("halo", [None, 0, 4, 64, N])
def test_halo_sizes_bitwise_equal(gloo_worlds, halo):
    lw, leaves = _inputs()
    key = _kd(jax.random.key(3))
    ref = gloo_worlds(1).run(B.ring_step, key, lw, leaves)
    got = gloo_worlds(4).run(B.ring_step, key, lw, leaves, halo)
    for i in range(3):
        np.testing.assert_array_equal(_stitch(got, i), _stitch(ref, i))
    assert got[0]["logz"] == ref[0]["logz"]


def test_balanced_resample_is_halo_sized_with_zero_ring_trips(gloo_worlds):
    _, leaves = _inputs()
    lw = _weights(4, scale=0.5)
    got = gloo_worlds(4).run(B.ring_step, _kd(jax.random.key(3)), lw, leaves,
                             64)
    local_n = N // 4
    for r in got:
        c = r["comm"]
        assert c["ring_trips"] == 0
        assert c["host_syncs"] == 1            # the halo's "unfilled" read
        by = c["by_op"]
        assert set(by) == {"all_reduce/max", "all_gather/block_stats",
                           "send/halo", "all_reduce/unfilled"}
        assert by["all_gather/block_stats"]["elements"] == 3 * (N // BLOCK)
        # Runs (starts, ends) and three leaves, H slots each way; aux is
        # (H, 3).
        assert by["send/halo"]["elements"] == 2 * 64 * (1 + 1 + 1 + 1 + 3)
        assert c["max_elements"] < local_n < N


def test_skewed_forces_the_ring_and_stays_exact(gloo_worlds):
    lw = np.full((N,), -1e9, np.float32)
    lw[:4] = [0.0, 0.1, 0.2, 0.3]
    idx = np.arange(N, dtype=np.float32)
    key = jax.random.key(7)
    want = np.asarray(resample_tree(key, jnp.asarray(lw), jnp.asarray(idx),
                                    N, "systematic"))
    for d, halo in ((4, 8), (8, None)):
        got = gloo_worlds(d).run(B.ring_step, _kd(key), lw, (idx,), halo)
        np.testing.assert_array_equal(_stitch(got, 0), want)
        assert got[0]["comm"]["ring_trips"] >= 1
        assert got[0]["comm"]["by_op"]["send/ring"]["elements"] > 0


def test_every_slot_filled_stress(gloo_worlds):
    idx = np.arange(N, dtype=np.float32)
    for seed in range(4):
        lw = _weights(100 + seed) * (seed + 1)
        got = gloo_worlds(4).run(B.ring_resample,
                                 _kd(jax.random.key(seed)), lw, (idx,))
        a = np.concatenate([r[0] for r in got])
        assert (np.diff(a) >= 0).all()
        assert (a >= 0).all() and (a < N).all()
        assert a[-1] > 0 or lw.argmax() == 0


def test_a_block_that_does_not_divide_raises(gloo_worlds):
    """12288 = 3·2^12: its layout-free block is 192, which does not divide
    n/D on a world of 3 (not a power of two)."""
    msg = gloo_worlds(3).run(B.blocked_error, 12288)[0]
    want = None
    try:
        JC._pick_block(12288, 4096, 256)
    except ValueError as e:
        want = str(e)
    assert msg == want and "does not divide" in msg


def test_gather_and_replicated(gloo_worlds):
    x = np.arange(16, dtype=np.float32)
    full, differs = gloo_worlds(4).run(B.gather_and_check, x)[0]
    np.testing.assert_array_equal(full, x)
    assert differs is not None and "differs" in differs


NAN = float("nan")


@pytest.mark.parametrize("d,values,raises", [
    (1, [[NAN, 1.0]], False),
    (2, [[NAN, 1.0], [NAN, 1.0]], False),
    (1, [[1.0, -np.inf]], False),
    (2, [[1.0, -np.inf], [1.0, -np.inf]], False),
    (2, [[NAN], [1.0]], True),
    (2, [[1.0, NAN], [2.0, NAN]], True),
], ids=["nan-1", "nan-2", "inf-1", "inf-2", "nan-vs-value", "value-differs"])
def test_replicated_nan(gloo_worlds, d, values, raises):
    """A NaN that every rank holds at the same position is replicated; a
    NaN on one rank against a number on the other, or a number that
    differs beside a shared NaN, still raises."""
    got = gloo_worlds(d).run(B.replicated_check, values)
    if raises:
        assert all(m is not None and "differs" in m for m in got), got
    else:
        assert got == [None] * d


def test_particle_mesh_without_a_group_raises():
    from genjax_torch.parallel import particle_mesh

    with pytest.raises(RuntimeError, match="init_distributed"):
        particle_mesh("cpu")
