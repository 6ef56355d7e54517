"""The port's row resamplers against the JAX package on the same key data
and weights: ``resample_values(_rows)``, ``resample_indices_rows``,
``resample_indices_sorted``, the row-scale guard and
``random.exponential``.

The port finds each destination's owner by a searchsorted in the
cumulative counts where the JAX package compares every source with
every destination; the owners agree wherever the f32 counts agree. The
counts themselves are the same f32 pipeline in both packages, but the
two libraries may add a cumulative sum in different orders, so a grid
point that lands within an ulp of a boundary can round to the other
side: such ties are counted and bounded, and the values are held equal
everywhere else."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genjax_tpu.inference import smc as jsmc
from genjax_torch.core import random as R
from genjax_torch.inference import smc as tsmc
from genjax_torch.interop import key_from_numpy

ROWS, K, N = 12, 96, 96


def _tkey(k):
    return key_from_numpy(np.asarray(jax.random.key_data(k)))


@pytest.fixture(scope="module")
def weights():
    rng = np.random.default_rng(7)
    lw = (3.0 * rng.standard_normal((ROWS, K))).astype(np.float32)
    lw[0, 5:40] = -np.inf          # a run of zero-weight particles
    lw[1] = 0.0                    # uniform weights: many exact ties
    vals = rng.standard_normal((ROWS, K, 2)).astype(np.float32)
    return lw, vals


def _jax_cc_rows(key, lw, n):
    """The JAX package's per-row counts of ``resample_values_rows``."""
    mx = jnp.max(lw, axis=1, keepdims=True)
    cum = jax.lax.cummax(jnp.cumsum(jnp.exp(lw - mx), axis=1), axis=1)
    u0 = jax.random.uniform(key, (lw.shape[0], 1))
    cc = jnp.clip(jnp.ceil(cum * (n / cum[:, -1:]) - u0), 0.0, float(n))
    return np.asarray(cc.at[:, -1].set(float(n)))


def test_log1p_f32_is_xlas():
    """Both branches of XLA's CPU log1p, and its edges (0, -0, a tiny
    value, -1, beyond -1, +inf, NaN), bit for bit."""
    u = np.asarray(jax.random.uniform(jax.random.key(0), (20000,)))
    edges = np.asarray([0.0, -0.0, 1e-30, -1.0, -2.0, np.inf, np.nan,
                        5e30, 0.41421354, -0.41421357], np.float32)
    for x in (-u, 3 * u, -0.999 * u, 1e-3 * u, edges):
        want = np.asarray(jnp.log1p(jnp.asarray(x)))
        got = R.log1p_f32(torch.tensor(x)).numpy()
        assert np.array_equal(got.view(np.uint32), want.view(np.uint32))


def test_exponential_is_bitwise():
    for seed in (0, 1, 99):
        k = jax.random.key(seed)
        want = np.asarray(jax.random.exponential(k, (3, 1000)))
        got = R.exponential(_tkey(k), (3, 1000)).numpy()
        assert np.array_equal(got.view(np.uint32), want.view(np.uint32))


def test_resample_values_rows_matches_jax(weights):
    """Counts equal except at f32 ties (at most 1 % of the entries), and
    every destination's value equal wherever its row's counts agree."""
    lw, vals = weights
    ties = 0
    for seed in range(4):
        k = jax.random.key(seed)
        want = np.asarray(jsmc.resample_values_rows(
            k, jnp.asarray(lw), jnp.asarray(vals), N))
        got = tsmc.resample_values_rows(
            _tkey(k), torch.tensor(lw), torch.tensor(vals), N).numpy()
        u0 = R.uniform(_tkey(k), (ROWS, 1))[:, 0]
        cc_t = tsmc._counts_cum_rows(u0, torch.tensor(lw), N).numpy()
        cc_j = _jax_cc_rows(k, jnp.asarray(lw), N)
        diff = cc_t != cc_j
        ties += int(diff.sum())
        agree = ~diff.any(axis=1)
        assert agree.sum() >= ROWS - 2
        np.testing.assert_array_equal(got[agree], want[agree])
    assert ties <= 0.01 * 4 * ROWS * K, ties


def test_resample_values_per_row_keys_match_jax_vmap(weights):
    """A key batch resamples each row on its own key, as the JAX function
    does under vmap (the SMC² inner filters' form)."""
    lw, vals = weights
    keys = jax.random.split(jax.random.key(3), ROWS)
    want = np.asarray(jax.vmap(
        lambda k, l, v: jsmc.resample_values(k, l, v, N))(
            keys, jnp.asarray(lw), jnp.asarray(vals)))
    got = tsmc.resample_values(
        key_from_numpy(np.asarray(jax.random.key_data(keys))),
        torch.tensor(lw), torch.tensor(vals), N).numpy()
    rows_equal = (got == want).all(axis=(1, 2))
    assert rows_equal.sum() >= ROWS - 2
    # One row, one key: the unbatched form.
    one = tsmc.resample_values(_tkey(keys[2]), torch.tensor(lw[2]),
                               torch.tensor(vals[2]), N).numpy()
    np.testing.assert_array_equal(one, got[2])


@pytest.mark.parametrize("method", ["systematic", "stratified",
                                    "multinomial"])
def test_resample_indices_rows_matches_jax(weights, method):
    lw, _ = weights
    k = jax.random.key(11)
    want = np.asarray(jsmc.resample_indices_rows(k, jnp.asarray(lw), N,
                                                 method))
    got = tsmc.resample_indices_rows(_tkey(k), torch.tensor(lw), N,
                                     method).numpy()
    assert got.shape == want.shape == (ROWS, N)
    assert (got != want).sum() <= 0.01 * ROWS * N
    assert (np.diff(got, axis=1) >= 0).all()


@pytest.mark.parametrize("method", ["systematic", "stratified",
                                    "multinomial"])
def test_resample_indices_sorted_matches_jax(weights, method):
    """One row on one key, and rows on a key batch (JAX's vmap)."""
    lw, _ = weights
    keys = jax.random.split(jax.random.key(5), ROWS)
    want = np.asarray(jax.vmap(
        lambda kk, l: jsmc.resample_indices_sorted(kk, l, N, method))(
            keys, jnp.asarray(lw)))
    tkeys = key_from_numpy(np.asarray(jax.random.key_data(keys)))
    got = tsmc.resample_indices_sorted(tkeys, torch.tensor(lw), N,
                                       method).numpy()
    assert (got != want).sum() <= 0.01 * ROWS * N
    one = tsmc.resample_indices_sorted(tkeys[4], torch.tensor(lw[4]), N,
                                       method).numpy()
    np.testing.assert_array_equal(one, got[4])


def test_zero_weight_particles_get_no_offspring(weights):
    lw, vals = weights
    got = tsmc.resample_values_rows(R.key(2), torch.tensor(lw),
                                    torch.tensor(vals), N).numpy()
    dead = vals[0, 5:40]
    assert not (got[0][:, None, :] == dead[None]).all(-1).any()


@pytest.mark.parametrize("k,n,raises", [
    (1 << 14, 1 << 14, False),
    (1 << 14, (1 << 14) + 1, True),
    (1 << 20, 1 << 20, True),
])
def test_row_scale_guard_raises_at_the_same_sizes(k, n, raises):
    def outcome(fn):
        try:
            fn(k, n)
        except ValueError as e:
            assert "ROW-scale" in str(e)
            return True
        return False

    assert outcome(jsmc._check_row_scale) == raises
    assert outcome(tsmc._check_row_scale) == raises
    if raises:
        # The public functions refuse before they compute anything.
        with pytest.raises(ValueError, match="ROW-scale"):
            tsmc.resample_values(R.key(0), torch.zeros(k), torch.zeros(k), n)
        with pytest.raises(ValueError, match="ROW-scale"):
            tsmc.resample_values_rows(R.key(0), torch.zeros(1, k),
                                      torch.zeros(1, k), n)
