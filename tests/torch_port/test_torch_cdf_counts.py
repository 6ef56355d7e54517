"""The CDF->counts module of the port (genjax_torch/ops/cdf_counts.py):
its plain version against the JAX package's
``smc.systematic_offspring_cumulative`` and against its Pallas kernel
``systematic_cumulative_pallas`` in interpret mode, on the same
log-weights (numpy, from a seed) and the same key data. The kernel
itself (CUDA) runs only on the card and is checked by chip_smoke.py.

Invariants are exact (nondecreasing, last == n, counts >= 0 summing to
n). Entries may differ by a few dests where the summation orders (torch
cumsum, XLA cumsum, Hillis–Steele + carry) round a dest boundary
differently; the JAX package's own bound between its two versions is 4
(tests/ops/test_cdf_counts.py:47-52), and the same bound holds here."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genjax_tpu.inference.smc import systematic_offspring_cumulative
from genjax_tpu.ops.cdf_counts import systematic_cumulative_pallas
from genjax_torch.interop import key_from_numpy
from genjax_torch.ops import cdf_counts

N = 1 << 16
REGIMES = ["uniform", "mild", "skewed", "one_hot", "head_tail"]


def _lw(regime: str, n: int) -> np.ndarray:
    rng = np.random.default_rng(5)
    if regime == "uniform":
        return np.zeros(n, np.float32)
    if regime == "mild":
        return rng.normal(size=n).astype(np.float32)
    if regime == "skewed":
        return (4.0 * rng.normal(size=n)).astype(np.float32)
    if regime == "one_hot":
        return np.where(np.arange(n) == 12345, 0.0, -1e9).astype(np.float32)
    return np.where(np.arange(n) < 9, 8.0, -2.0).astype(np.float32)


def _check_invariants(cc: np.ndarray, n: int):
    assert cc[-1] == n
    counts = np.diff(np.concatenate([[0], cc.astype(np.int64)]))
    assert (counts >= 0).all() and counts.sum() == n


@pytest.mark.parametrize("regime", REGIMES)
def test_plain_vs_jax_and_pallas(regime):
    lw = _lw(regime, N)
    k = jax.random.key(5)
    kt = key_from_numpy(np.asarray(jax.random.key_data(k)))
    got = cdf_counts.systematic_cumulative_plain(kt, torch.as_tensor(lw), N)
    got = got.numpy()
    assert got.dtype == np.int32
    _check_invariants(got, N)
    ref = np.asarray(systematic_offspring_cumulative(k, jnp.asarray(lw), N))
    pallas = np.asarray(systematic_cumulative_pallas(
        k, jnp.asarray(lw), N, chunk_rows=128, interpret=True))
    for other in (ref, pallas):
        assert np.abs(got.astype(np.int64) - other).max() <= 4


def test_wrapper_takes_plain_on_cpu_and_counts_nothing():
    lw = torch.as_tensor(_lw("mild", 1000))
    key = key_from_numpy(np.array([0, 9], np.uint32))
    before = cdf_counts.systematic_cumulative.launches
    got = cdf_counts.systematic_cumulative(key, lw, 1000)
    assert torch.equal(got, cdf_counts.systematic_cumulative_plain(key, lw,
                                                                   1000))
    assert cdf_counts.systematic_cumulative.launches == before


@pytest.mark.parametrize("n_dest", [1, 777, 4096])
def test_plain_other_destination_counts(n_dest):
    lw = torch.as_tensor(_lw("skewed", 3000))
    cc = cdf_counts.systematic_cumulative_plain(
        key_from_numpy(np.array([0, 2], np.uint32)), lw, n_dest).numpy()
    _check_invariants(cc, n_dest)


def test_counts_proportional_to_weights():
    n = 4096
    lw = np.log(np.arange(1, n + 1, dtype=np.float32))
    cc = cdf_counts.systematic_cumulative_plain(
        key_from_numpy(np.array([0, 9], np.uint32)), torch.as_tensor(lw), n)
    counts = np.diff(np.concatenate([[0], cc.numpy()])).astype(np.float64)
    w = np.arange(1, n + 1, dtype=np.float64)
    # systematic resampling: counts are the floor or ceil of n·w/Σw
    assert np.abs(counts - n * w / w.sum()).max() <= 1.0 + 1e-6
