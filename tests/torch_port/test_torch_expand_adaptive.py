"""The resampling expansion against the JAX package on the CPU:
``expand_adaptive_plain`` (what the wrapper takes for a CPU tensor) bit
for bit against the Pallas kernel in interpret mode at N = 1024 with two
dest blocks per grid step, in every case of
``tests/ops/test_expand_adaptive.py``, and against ``repeat_interleave``;
and the JAX kernel's gate, ported unchanged.

The card's kernel is a merge path (``csrc/expand_adaptive.cu``);
``_merge_path_expand`` repeats it in Python, tile by tile: the 32-way
search of each tile's two diagonals, the staged window of counts with its
sentinel, each thread's binary search of its own diagonal and its serial
merge. It is held bit for bit to the plain version and to
``repeat_interleave`` in the same cases, at tiles of 8 and 64 merged
items, and at sizes that are not a multiple of the tile."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genjax_torch.ops.expand_adaptive import (
    expand_adaptive,
    expand_adaptive_plain,
    supports_adaptive_expand,
)
from genjax_tpu.inference.smc import systematic_offspring_cumulative
from genjax_tpu.ops.expand_adaptive import (
    expand_adaptive as jax_expand,
    supports_adaptive_expand as jax_supports,
)

KEY = jax.random.key(23)
N = 1024
TB = 2
CASES = ["uniform", "mild", "skewed", "one_hot", "two_far", "head_tail",
         "int32", "block_boundary", "degenerate_tail", "seed0", "seed1",
         "seed2", "seed3"]


def _log_weights(regime):
    idx = jnp.arange(N)
    return {
        "uniform": lambda: jnp.zeros(N),
        "mild": lambda: jax.random.normal(KEY, (N,)),
        "skewed": lambda: 3.0 * jax.random.normal(KEY, (N,)),
        "one_hot": lambda: jnp.where(idx == 389, 0.0, -1e9),
        "two_far": lambda: jnp.where((idx == 3) | (idx == N - 2), 0.0, -1e9),
        "head_tail": lambda: jnp.where(idx < 8, 10.0, -2.0),
        "int32": lambda: 2.0 * jax.random.normal(KEY, (N,)),
    }[regime]()


def _counts(case):
    """``(counts_cum, leaf)`` of a case of the JAX test file."""
    if case in ("block_boundary", "degenerate_tail"):
        counts = np.zeros(N, np.int32)
        if case == "block_boundary":
            counts[[0, 511, 512]] = [300, 212, N - 512]
        else:
            g = N // 128
            counts[0] = N - (g - 1)
            counts[128 * np.arange(1, g)] = 1
        return jnp.cumsum(jnp.asarray(counts)).astype(jnp.int32), jnp.arange(
            N, dtype=jnp.float32)
    if case.startswith("seed"):
        k = jax.random.key(int(case[4:]))
        cc = systematic_offspring_cumulative(
            k, 3.0 * jax.random.normal(k, (N,)), N)
        return cc, jax.random.normal(jax.random.key(int(case[4:]) + 100),
                                     (N,))
    cc = systematic_offspring_cumulative(KEY, _log_weights(case), N)
    if case == "int32":
        return cc, jax.random.randint(jax.random.key(2), (N,), -(2**31),
                                      2**31 - 1, dtype=jnp.int32)
    return cc, jax.random.normal(jax.random.key(1), (N,))


@pytest.mark.parametrize("case", CASES)
def test_plain_is_bitwise_the_jax_kernel(case):
    cc, leaf = _counts(case)
    want = np.asarray(jax_expand(leaf, cc, N, interpret=True, tb=TB))
    t_cc = torch.tensor(np.asarray(cc))
    t_leaf = torch.tensor(np.asarray(leaf))
    got = expand_adaptive(t_leaf, t_cc, N)
    assert got.dtype == t_leaf.dtype
    assert torch.equal(got, expand_adaptive_plain(t_leaf, t_cc, N))
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  want.view(np.int32))
    counts = torch.diff(t_cc, prepend=torch.zeros(1, dtype=t_cc.dtype))
    rep = torch.repeat_interleave(t_leaf, counts, output_size=N)
    assert torch.equal(got.view(torch.int32), rep.view(torch.int32))


def test_plain_keeps_bit_patterns():
    """-0.0 and NaN payloads pass through the gather untouched."""
    words = torch.tensor([0x80000000, 0x7FC00001, 0x7F800001, 5],
                         dtype=torch.int64).to(torch.int32)
    leaf = words.view(torch.float32)
    cc = torch.tensor([1, 3, 3, 4], dtype=torch.int32)
    out = expand_adaptive_plain(leaf, cc, 4).view(torch.int32)
    assert out.tolist() == [words[0], words[1], words[1], words[3]]


def test_supports_gate_matches_jax():
    cases = [
        (1 << 20, 1 << 20, [(1 << 20,), "f32"]),
        (1 << 20, 1 << 19, [(1 << 20,), "f32"]),
        (1 << 20, 1 << 20, [(1 << 20,), "f32", (1 << 20,), "f32"]),
        (1 << 21, 1 << 21, [(1 << 21,), "f32"]),
        (1 << 20, 1 << 20, [(1 << 20,), "bf16"]),
        (1 << 20, 1 << 20, [(1 << 20, 2), "f32"]),
        (1 << 14, 1 << 14, [(1 << 14,), "i32"]),
        (1000, 1000, [(1000,), "f32"]),
    ]
    dt = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16),
          "i32": (jnp.int32, torch.int32)}
    for n_src, n_dest, spec in cases:
        shapes, kinds = spec[0::2], spec[1::2]
        jl = [jnp.zeros(s, dt[k][0]) for s, k in zip(shapes, kinds)]
        tl = [torch.empty(s, dtype=dt[k][1], device="meta")
              for s, k in zip(shapes, kinds)]
        assert supports_adaptive_expand(n_src, n_dest, tl) == jax_supports(
            n_src, n_dest, jl), (n_src, n_dest, spec)


def test_wrapper_rejects_devices_without_a_kernel():
    x = torch.zeros(8, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        expand_adaptive(x, torch.zeros(8, dtype=torch.int32, device="meta"),
                        8)


INT32_MAX = 2**31 - 1


def _warp_split(cc, n: int, diag: int, lanes: int = 32) -> int:
    """The kernel's ``warp_split``: the number of sources among the first
    ``diag`` merged items, by rounds in which each of ``lanes`` lanes
    probes the end of one equal part of the range and the count of
    probes that see a source first narrows it."""
    lo, hi = max(0, diag - n), min(diag, n)
    while lo < hi:
        step = -(-(hi - lo) // lanes)
        k = sum(1 for lane in range(lanes)
                if (q := lo + (lane + 1) * step - 1) < hi
                and cc[q] <= diag - 1 - q)
        top = lo + (k + 1) * step - 1
        lo, hi = min(lo + k * step, hi), min(top, hi)
    return lo


def _merge_path_expand(cc, leaf, threads: int, items: int):
    """The kernel's algorithm: tiles of ``threads * items`` merged items
    (sources before destinations on ties), each one's counts staged with
    a sentinel and merged by ``threads`` threads of ``items`` steps."""
    cc, leaf = [int(c) for c in cc], list(leaf)
    n, tile = len(cc), threads * items
    out = [None] * n
    for d0 in range(0, 2 * n, tile):
        d1 = min(d0 + tile, 2 * n)
        a0, a1 = _warp_split(cc, n, d0), _warp_split(cc, n, d1)
        na, b0 = a1 - a0, d0 - a0
        nb = (d1 - d0) - na
        s_cc = cc[a0:a1] + [INT32_MAX]
        total = na + nb
        for t in range(threads):
            dg = min(t * items, total)
            lo, hi = max(0, dg - nb), min(dg, na)
            while lo < hi:
                mid = (lo + hi) // 2
                if s_cc[mid] <= b0 + (dg - 1 - mid):
                    lo = mid + 1
                else:
                    hi = mid
            a, b = lo, dg - lo
            for k in range(items):
                if dg + k < total:
                    take_src = b >= nb or s_cc[a] <= b0 + b
                    if not take_src:
                        out[b0 + b] = leaf[min(a0 + a, n - 1)]
                    a, b = a + take_src, b + (not take_src)
    return out


def _check_merge_path(cc: np.ndarray, words: np.ndarray, threads, items):
    n = len(cc)
    got = np.asarray(_merge_path_expand(cc, words, threads, items), np.int32)
    t_cc, t_words = torch.tensor(cc), torch.tensor(words)
    np.testing.assert_array_equal(
        got, expand_adaptive_plain(t_words, t_cc, n).numpy())
    counts = torch.diff(t_cc, prepend=torch.zeros(1, dtype=t_cc.dtype))
    np.testing.assert_array_equal(
        got, torch.repeat_interleave(t_words, counts, output_size=n).numpy())


@pytest.mark.parametrize("threads,items", [(2, 4), (8, 8)],
                         ids=["tile8", "tile64"])
@pytest.mark.parametrize("case", CASES)
def test_merge_path_emulation_is_bitwise_the_plain_version(case, threads,
                                                           items):
    cc, leaf = _counts(case)
    words = np.asarray(leaf).view(np.int32)
    _check_merge_path(np.asarray(cc, np.int32), words, threads, items)


def _ragged_counts(kind: str, n: int) -> np.ndarray:
    rng = np.random.default_rng(n)
    if kind == "random":
        counts = rng.multinomial(n, rng.dirichlet(np.full(n, 0.3)))
    else:  # every destination on one source
        counts = np.zeros(n, np.int64)
        counts[{"one_hot": n // 3, "last": n - 1, "first": 0}[kind]] = n
    return np.cumsum(counts).astype(np.int32)


@pytest.mark.parametrize("threads,items", [(2, 4), (8, 8)],
                         ids=["tile8", "tile64"])
@pytest.mark.parametrize("kind,n", [
    ("random", 1000), ("random", 37), ("random", 1), ("one_hot", 999),
    ("last", 77), ("first", 130),
])
def test_merge_path_emulation_at_ragged_sizes(kind, n, threads, items):
    """Sizes whose 2n merged items do not fill the last tile."""
    cc = _ragged_counts(kind, n)
    words = np.random.default_rng(1).integers(-(2**31), 2**31, n,
                                              dtype=np.int64).astype(np.int32)
    _check_merge_path(cc, words, threads, items)


@pytest.mark.parametrize("case", ["mild", "one_hot", "degenerate_tail"])
def test_warp_split_is_the_merge_path_split(case):
    """Every diagonal's 32-way split is the merge path's: the number of
    sources i with counts_cum[i] + i <= diag - 1."""
    cc = np.asarray(_counts(case)[0], np.int64)
    ends = cc + np.arange(N)
    for diag in range(2 * N + 1):
        want = int(np.searchsorted(ends, diag - 1, side="right"))
        assert _warp_split(cc, N, diag) == want, diag
