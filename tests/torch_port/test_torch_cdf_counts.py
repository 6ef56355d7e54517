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
(tests/ops/test_cdf_counts.py:47-52), and the same bound holds here.

The card's kernel is two launches over tiles (``csrc/cdf_counts.cu``);
``_cdf_blocked`` repeats its algorithm tile by tile in torch and is held
to the same invariants and bound at sizes of one tile, two, a ragged last
tile and many."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genjax_tpu.inference.smc import systematic_offspring_cumulative
from genjax_tpu.ops.cdf_counts import (
    pick_chunk_rows,
    systematic_cumulative_pallas,
)
from genjax_torch.core import random
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
        hot = min(12345, n // 3)
        return np.where(np.arange(n) == hot, 0.0, -1e9).astype(np.float32)
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


def _cdf_blocked(key, lw: torch.Tensor, n_dest: int,
                 tile: int) -> torch.Tensor:
    """The kernel's algorithm in torch, tile by tile: launch 1's per-tile
    maximum ``m_t`` and ``s_t = sum exp(lw - m_t)``; from those partials
    alone the global ``m``, the total ``sum s_t exp(m_t - m)`` and each
    tile's exclusive offset (in float64); each tile's prefix sums of
    ``exp(lw - m)`` plus its offset, lifted to their running maximum and
    to the maximum of every earlier tile (what the look-back reads); the
    clamped counts, the last pinned to ``n_dest``."""
    n = lw.shape[0]
    nb = -(-n // tile)
    tiles = torch.full((nb * tile,), -math.inf)
    tiles[:n] = lw
    tiles = tiles.view(nb, tile)
    m_t = tiles.amax(1)
    live = m_t > -math.inf
    s_t = torch.exp(tiles - torch.where(live, m_t, 0.0)[:, None]).sum(1)
    m = m_t.max()
    scaled = torch.where(live, s_t.double() * torch.exp(
        m_t.double() - m.double()), 0.0)
    ends = torch.cumsum(scaled, 0)
    offsets = ends - scaled
    cum = offsets[:, None] + torch.cumsum(torch.exp(tiles - m), 1).double()
    cum = torch.cummax(cum.float(), 1).values
    tile_max = cum[:, -1]
    prior = torch.cat([torch.zeros(1), torch.cummax(tile_max, 0).values[:-1]])
    cum = torch.maximum(cum, prior[:, None]).reshape(-1)[:n]
    u0 = random.uniform(key, ())
    scale = n_dest / ends[-1].float()
    out = torch.clamp(torch.ceil(cum * scale - u0), 0, n_dest).to(torch.int32)
    out[-1] = n_dest
    return out


# (n, tile): one tile, two, a ragged last tile, many (128 and 79 ragged);
# and a single element.
BLOCKED_SIZES = [(1024, 4096), (8192, 4096), (12305, 4096), (32768, 256),
                 (20000, 256), (1, 4096)]


@pytest.mark.parametrize("n,tile", BLOCKED_SIZES)
@pytest.mark.parametrize("regime", REGIMES)
def test_blocked_algorithm_vs_jax_and_pallas(regime, n, tile):
    lw = _lw(regime, n)
    k = jax.random.key(5)
    kt = key_from_numpy(np.asarray(jax.random.key_data(k)))
    got = _cdf_blocked(kt, torch.as_tensor(lw), n, tile).numpy()
    assert got.dtype == np.int32
    _check_invariants(got, n)
    refs = [np.asarray(systematic_offspring_cumulative(k, jnp.asarray(lw), n)),
            cdf_counts.systematic_cumulative_plain(
                kt, torch.as_tensor(lw), n).numpy()]
    rows = pick_chunk_rows(n)
    if rows is not None:
        refs.append(np.asarray(systematic_cumulative_pallas(
            k, jnp.asarray(lw), n, chunk_rows=rows, interpret=True)))
    for ref in refs:
        assert np.abs(got.astype(np.int64) - ref).max() <= 4
