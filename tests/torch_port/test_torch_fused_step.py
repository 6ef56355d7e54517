"""The fused filter-step module of the port (genjax_torch/ops/fused_step.py):
its plain version against the JAX package's ``fused_step_reference`` and
its Pallas kernel ``make_fused_step`` in interpret mode, on the same state,
weights (numpy, from a seed) and key data. The CUDA kernel runs only on
the card and is checked by chip_smoke.py; its statistics (per-block
partials folded by the last block) are emulated here in its order.

The threefry words and the uniforms built from them are equal bit for
bit. ``xs``/``lw`` go through log1p, sqrt and cos, whose CPU
implementations differ between XLA and torch by an ulp here and there;
the tracking model then amplifies an ulp of ``x`` (``x^2/20``, squared),
so they are held to 1e-5 relative + 1e-5 absolute. ``lse``/``ess`` to
1e-4, the JAX package's own bound between its two versions
(tests/ops/test_fused_step.py:74-75). The kernel's fold (emulated) and the
plain version's torch sums are each held to float64 of the same new
log-weights within the error f32 leaves them (``_stats_within_bound``)."""

import math
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genjax_tpu.ops.fused_step import (
    fused_step_reference,
    make_fused_step,
    normal_from_counter as jax_normal_from_counter,
    threefry2x32 as jax_threefry2x32,
)
from genjax_torch import entry as E
from genjax_torch.core import random as R
from genjax_torch.entry import tracking_loglik, tracking_propagate
from genjax_torch.inference.pf import fused_particle_filter
from genjax_torch.interop import ensemble_from_numpy, key_from_numpy
from genjax_torch.ops import fused_step as fs
from genjax_torch.ops._build import CSRC_DIR

N = 4096
KEY = jax.random.key(314159)


def _jax_tracking(x, e):
    return 0.5 * x + 25.0 * x / (1.0 + x * x) + jnp.sqrt(10.0) * e


def _jax_tracking_ll(x, y):
    return -0.5 * (y - x * x / 20.0) ** 2 - 0.5 * jnp.log(2 * jnp.pi)


def _inputs():
    rng = np.random.default_rng(1)
    xs = rng.normal(size=N).astype(np.float32)
    lw = (0.3 * rng.normal(size=N)).astype(np.float32)
    return xs, lw


def test_threefry_words_and_uniforms_bitwise():
    seeds = np.asarray(jax.random.key_data(KEY))
    ctr = np.arange(N, dtype=np.uint32)
    j0, j1 = jax_threefry2x32(jnp.uint32(seeds[0]), jnp.uint32(seeds[1]),
                              jnp.asarray(ctr), jnp.zeros(N, jnp.uint32))
    st = key_from_numpy(seeds)
    t0, t1 = R.threefry2x32(st[0], st[1], torch.arange(N),
                            torch.zeros(N, dtype=torch.int64))
    np.testing.assert_array_equal(t0.numpy().astype(np.uint32), np.asarray(j0))
    np.testing.assert_array_equal(t1.numpy().astype(np.uint32), np.asarray(j1))
    u = fs._u24_to_unit(t0).numpy()
    uj = ((np.asarray(j0) >> 8).astype(np.float32) * np.float32(2.0**-24))
    np.testing.assert_array_equal(u, uj)
    z = fs.normal_from_counter(st[0], st[1], torch.arange(N)).numpy()
    zj = np.asarray(jax_normal_from_counter(
        jnp.uint32(seeds[0]), jnp.uint32(seeds[1]), jnp.asarray(ctr)))
    np.testing.assert_allclose(z, zj, rtol=1e-5, atol=1e-6)


def test_threefry_torch_body_words_bitwise():
    """The torch body of threefry2x32 (the card's; a CPU tensor takes the
    numpy body) on CPU tensors against the JAX package's words."""
    seeds = np.asarray(jax.random.key_data(KEY))
    ctr = np.arange(N, dtype=np.uint32)
    j0, j1 = jax_threefry2x32(jnp.uint32(seeds[0]), jnp.uint32(seeds[1]),
                              jnp.asarray(ctr), jnp.zeros(N, jnp.uint32))
    st = key_from_numpy(seeds)
    t0, t1 = R._threefry2x32_torch(st[0], st[1], torch.arange(N),
                                   torch.zeros(N, dtype=torch.int64))
    np.testing.assert_array_equal(t0.numpy().astype(np.uint32), np.asarray(j0))
    np.testing.assert_array_equal(t1.numpy().astype(np.uint32), np.asarray(j1))


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
def test_plain_vs_jax_reference_and_pallas(state_dtype):
    xs, lw = _inputs()
    jdt = jnp.dtype(state_dtype)
    tdt = getattr(torch, state_dtype)
    seeds = jax.random.key_data(KEY).astype(jnp.uint32)
    jxs = jnp.asarray(xs).astype(jdt)
    ref = fused_step_reference(_jax_tracking, _jax_tracking_ll, N,
                               state_dtype=jdt)
    kern = make_fused_step(_jax_tracking, _jax_tracking_ll, N, chunk_rows=8,
                           state_dtype=jdt, interpret=True)
    outs_j = [jax.jit(f)(seeds, jxs, jnp.asarray(lw), 2.5) for f in (ref, kern)]
    txs, tlw = ensemble_from_numpy(np.asarray(jxs.astype(jnp.float32)), lw)
    got = fs.fused_step_plain(key_from_numpy(np.asarray(seeds)), txs.to(tdt),
                              tlw, 2.5, tracking_propagate, tracking_loglik,
                              state_dtype=tdt)
    assert got[0].dtype == tdt and got[1].dtype == torch.float32
    for xj, lwj, lsej, essj in outs_j:
        x_t = got[0].float().numpy()
        x_j = np.asarray(xj.astype(jnp.float32))
        if state_dtype == "float32":
            np.testing.assert_allclose(x_t, x_j, rtol=1e-5, atol=1e-5)
        else:
            # one bf16 rounding of an f32 value that moved by an ulp
            np.testing.assert_allclose(x_t, x_j, rtol=2**-7, atol=1e-5)
        np.testing.assert_allclose(got[1].numpy(), np.asarray(lwj),
                                   rtol=1e-5, atol=1e-4)
        assert abs(float(got[2]) - float(lsej)) < 1e-4
        assert abs(float(got[3]) - float(essj)) / float(essj) < 1e-4


def test_wrapper_takes_plain_on_cpu_and_counts_nothing():
    xs, lw = ensemble_from_numpy(*_inputs())
    seeds = R.key(3)
    before = fs.fused_step.launches
    a = fs.fused_step(seeds, xs, lw, 1.0, tracking_propagate, tracking_loglik)
    b = fs.fused_step_plain(seeds, xs, lw, 1.0, tracking_propagate,
                            tracking_loglik)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert fs.fused_step.launches == before


def test_wrapper_rejects_devices_without_a_kernel():
    xs = torch.zeros(8, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        fs.fused_step(R.key(0), xs, xs, 0.0, tracking_propagate,
                      tracking_loglik)


def test_wrapper_with_a_cuda_model_still_needs_a_cuda_tensor():
    xs = torch.zeros(8, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        fs.fused_step(R.key(0), xs, xs, 0.0, tracking_propagate,
                      tracking_loglik, cuda_model=E.TRACKING_CUDA)


def test_filter_off_the_cpu_needs_a_cuda_model():
    """No model's CUDA form is needed any more (``cuda_model=None``
    generates it on the card); a device with no kernel still raises."""
    pf = fused_particle_filter(lambda k: torch.zeros(8, device="meta"),
                               tracking_propagate, tracking_loglik, 8)
    with pytest.raises(ValueError, match="no kernel") as err:
        pf(R.key(0), torch.zeros(3))
    assert "cuda_model" not in str(err.value)


@pytest.mark.parametrize("model", [E.TRACKING_CUDA, E.LINEAR_CUDA],
                         ids=["tracking", "linear"])
def test_cuda_model_constants_are_entrys(model):
    """The header's ``kParams`` and its list ``p[k] = <entry.py name>``
    match the constants handed to the launch, as f32."""
    with open(os.path.join(CSRC_DIR, "models", f"{model.name}.cuh")) as f:
        header = f.read()
    k_params = int(re.search(r"kParams = (\d+);", header).group(1))
    named = dict(re.findall(r"p\[(\d)\] = ([A-Za-z_0-9()]+)", header))
    assert k_params == len(model.params) == len(named)
    scope = {"sqrt": math.sqrt, **vars(E)}
    want = np.float32([eval(named[str(k)], scope) for k in range(k_params)])
    got = fs.param_table(model.params, torch.device("cpu")).numpy()
    np.testing.assert_array_equal(got, want)


def test_param_table_is_made_once_a_tuple_and_keeps_signs():
    """The launch's constants on the device: one table a tuple of
    constants (a generation's) and device, reused by every later call with
    that tuple; an equal tuple of another generation gets its own, and a
    -0.0 keeps its sign (equal values, other bits)."""
    cpu = torch.device("cpu")
    params = (0.5, -0.0, 3.0)
    table = fs.param_table(params, cpu)
    assert fs.param_table(params, cpu) is table
    assert table.dtype == torch.float32 and table.tolist() == [0.5, 0.0, 3.0]
    assert str(table[1].item()) == "-0.0"
    zero = fs.param_table((0.5, 0.0, 3.0), cpu)
    assert zero is not table and str(zero[1].item()) == "0.0"
    again = tuple(list(params))
    assert fs.param_table(again, cpu) is not table
    assert fs.param_table((), cpu).numel() == 0


TILE, THREADS, WARPS = 1024, 256, 8


def _tree_sum(v: np.ndarray) -> np.float32:
    """``block_sum``'s order over one value a thread: a shuffle-down tree
    inside each warp of 32, then the warps in order, in f32."""
    w = v.astype(np.float32).reshape(-1, 32).copy()
    for o in (16, 8, 4, 2, 1):
        w[:, :o] = w[:, :o] + w[:, o:2 * o]
    total = w[0, 0]
    for k in range(1, w.shape[0]):
        total = np.float32(total + w[k, 0])
    return total


def _kernel_stats(lw: np.ndarray, mutation: str | None = None):
    """``(lse, ess)`` as the kernel forms them: per block of TILE, the
    maximum c and the sums of exp(lw - c) and its square (each thread's
    four elements in order, then the tree); the last block's fold of the
    partials, each thread a contiguous run, in the same tree.

    ``mutation`` breaks the fold on purpose, to show that the bound of
    :func:`_stats_within_bound` catches it: ``"drop_block"`` leaves the
    partial of the block holding the maximum out, ``"no_rescale"`` folds
    every block's sums without its ``exp(c - m)``."""
    n = len(lw)
    nb = -(-n // TILE)
    pad = np.full(nb * TILE, -np.inf, np.float32)
    pad[:n] = lw
    parts = []
    for blk in pad.reshape(nb, THREADS, TILE // THREADS):
        c = np.float32(blk.max())
        e = (np.zeros_like(blk) if c == -np.inf
             else np.exp(blk - c).astype(np.float32))
        t1, t2 = np.zeros(THREADS, np.float32), np.zeros(THREADS, np.float32)
        for j in range(blk.shape[1]):
            t1 += e[:, j]
            t2 += e[:, j] * e[:, j]
        parts.append((c, _tree_sum(t1), _tree_sum(t2)))
    m = np.float32(max(p[0] for p in parts))
    per = -(-nb // THREADS)
    s1, s2 = np.zeros(THREADS, np.float32), np.zeros(THREADS, np.float32)
    for i, (c, t1, t2) in enumerate(parts):
        if mutation == "drop_block" and c == m:
            mutation = None           # only the first block holding m
            continue
        if c != -np.inf:
            e = (np.float32(1.0) if mutation == "no_rescale"
                 else np.float32(np.exp(np.float32(c - m))))
            s1[i // per] += t1 * e
            s2[i // per] += t2 * (e * e)
    lse = m + np.log(_tree_sum(s1))
    lse2 = np.float32(2.0) * m + np.log(_tree_sum(s2))
    return lse, np.exp(np.float32(2.0) * lse - lse2)


#: f32's unit roundoff: a rounded operation errs by at most U relative,
#: half an ulp of its result.
U = 2.0 ** -24
#: Ulps within which an f32 ``exp`` or ``log`` of NumPy (its SIMD float32
#: functions promise 4) or of torch (SLEEF's, 1) lands; ``L`` ulps of a
#: value are at most ``2 L U`` of it.
LIB_ULPS = 4


def _ulp(v: float) -> float:
    return float(np.spacing(np.float32(abs(v))))


def _kernel_fold(n: int) -> tuple:
    """``(depth, r1, r2)`` of the kernel's fold of ``n`` elements:
    ``depth`` the most roundings of a sum on an element's path: its
    thread's four (3 adds; the first onto 0 is exact), the warp tree (5)
    and the warps in order (7); then the fold's run of ``per`` partials a
    thread (``per - 1``) and the same tree (12). ``r1`` (in U) for the
    roundings that form a term of S1: exp(lw - c), exp(c - m) and their
    product; ``r2`` for S2's: each exponential squared (twice its error
    and a product) and the product of the two."""
    per = -(-(-(-n // TILE)) // THREADS)
    exp_u = 2 * LIB_ULPS
    return (3 + 12 + (per - 1) + 12, 2 * exp_u + 1,
            2 * (2 * exp_u + 1) + 1)


def _torch_fold(threads: int) -> tuple:
    """The same for :func:`fused_step_plain`'s torch sums at ``threads``
    threads: torch's CPU sum of one contiguous f32 row (``cascade_sum``
    of ATen's SumKernel.cpp) takes four levels of at most 16 adds, the
    three upper levels folded into the first (3), four interleaved rows
    (3 adds, and up to 3 of a tail), the 16 lanes of a vector in order
    (16; a scalar tail's element takes at most 15 + 16), then one partial
    a thread in order; each term is one exp (of x, or of 2 x for S2)."""
    exp_u = 2 * LIB_ULPS
    return max(16 * 4 + 3 + 6 + 16, 15 + 16) + threads - 1, exp_u, exp_u


def _stats_within_bound(lse, ess, lw_new: np.ndarray, fold: tuple,
                        report: dict | None = None) -> bool:
    """Whether f32 ``(lse, ess)`` of ``lw_new`` lie within what f32 can
    resolve of the float64 values, for a fold ``(depth, r1, r2)``
    (:func:`_kernel_fold`, :func:`_torch_fold`); ``report``, where given,
    receives the bounds and errors in ulps of lse and relative on ess.

    With m = max lw (exact), x_i = lw_i - m <= 0, t_i = exp(x_i),
    S1 = sum t_i >= 1 and S2 = sum t_i^2 >= 1, the f32 sum S1 errs
    relatively by at most U (w1 + r1 + depth): w1 = sum t_i |x_i| / S1 for
    the rounded arguments (exp's condition number is |x|; the kernel's
    lw - c and c - m, both <= 0, add up to x, so their roundings sum to
    at most U |x| too), r1 for the roundings that form a term, and one U
    a rounding of the sum on the element's path. S2 likewise, with
    w2 = sum t_i^2 |2 x_i| / S2 and r2. log turns S's relative error into an
    absolute one in lse = m + log S, adds LIB_ULPS ulps of log S, and the
    add rounds to half an ulp of lse:

        |lse - lse64| <= U (w1 + r1 + depth) + LIB_ULPS ulp(log S1)
                         + ulp(lse) / 2,

    and lse2 = 2 m + log S2 the same. ess = exp(2 lse - lse2): 2 lse is
    exact, the difference d rounds to half an ulp of d, and exp adds
    2 LIB_ULPS U relative:

        |ess / ess64 - 1| <= expm1(2 b_lse + b_lse2 + ulp(d) / 2)
                             + 2 LIB_ULPS U.

    At the skewed 65536-element case (lse 16.08, one ulp 1.9e-6; ess
    20.6) that is 2.2 ulps of lse and 1.39e-5 relative on ess for the
    kernel's fold, 3.9-4.1 ulps and 2.24e-5-2.36e-5 for torch's at 1-8
    threads; each lands within 0.56 ulp of lse and 2.4e-6 on ess. A
    dropped block or a missing rescale moves lse by 8.5e4 ulps or more."""
    x = lw_new.astype(np.float64) - float(np.max(lw_new))
    x = x[np.isfinite(x)]                 # exp(-inf) adds nothing
    t1 = np.exp(x)
    t2 = t1 * t1
    s1, s2 = t1.sum(), t2.sum()
    m = float(np.max(lw_new))
    lse64, lse2_64 = m + math.log(s1), 2.0 * m + math.log(s2)
    ess64 = math.exp(2.0 * lse64 - lse2_64)
    w1 = float((t1 * -x).sum() / s1)
    w2 = float((t2 * -2.0 * x).sum() / s2)
    depth, r1, r2 = fold
    b_lse = (U * (w1 + r1 + depth) + LIB_ULPS * _ulp(math.log(s1))
             + _ulp(lse64) / 2)
    b_lse2 = (U * (w2 + r2 + depth) + LIB_ULPS * _ulp(math.log(s2))
              + _ulp(lse2_64) / 2)
    b_ess = (math.expm1(2 * b_lse + b_lse2 + _ulp(2 * lse64 - lse2_64) / 2)
             + 2 * LIB_ULPS * U)
    err_lse, err_ess = abs(float(lse) - lse64), abs(float(ess) / ess64 - 1)
    if report is not None:
        report.update(lse_ulps=err_lse / _ulp(lse64),
                      bound_ulps=b_lse / _ulp(lse64), ess=err_ess,
                      bound_ess=b_ess)
    return err_lse <= b_lse and err_ess <= b_ess


CASES = [("mild", 1000), ("mild", 5000), ("skewed", 3 * 1024),
         ("skewed", 65536), ("one_hot", 4097), ("dead_block", 5000)]


def _step_inputs(regime: str, n: int):
    rng = np.random.default_rng(n)
    xs = rng.normal(size=n).astype(np.float32)
    lw = {"mild": 0.3 * rng.normal(size=n),
          "skewed": 4.0 * rng.normal(size=n),
          "one_hot": np.where(np.arange(n) == n // 2, 0.0, -1e9),
          "dead_block": np.where(np.arange(n) // TILE == 1, -np.inf,
                                 rng.normal(size=n))}[regime]
    return ensemble_from_numpy(xs, lw.astype(np.float32))


@pytest.mark.parametrize("regime,n", CASES)
def test_partials_folded_in_kernel_order_match_plain(regime, n):
    """The kernel's lse and ess from its per-block partials, folded in its
    order, and the plain version's at torch thread counts 1, 2, 4 and 8
    (each its own summation order), each within the bound f32 gives them
    against float64 of the same new log-weights
    (:func:`_stats_within_bound`)."""
    txs, tlw = _step_inputs(regime, n)
    threads = torch.get_num_threads()
    try:
        for count in (1, 2, 4, 8):
            torch.set_num_threads(count)
            _, lw_new, lse, ess = fs.fused_step_plain(
                R.key(7), txs, tlw, 1.5, tracking_propagate, tracking_loglik)
            lw_np = lw_new.numpy()
            assert _stats_within_bound(lse, ess, lw_np,
                                       _torch_fold(count)), count
            k_lse, k_ess = _kernel_stats(lw_np)
            assert _stats_within_bound(k_lse, k_ess, lw_np,
                                       _kernel_fold(n)), count
    finally:
        torch.set_num_threads(threads)


@pytest.mark.parametrize("mutation,regime,n", [
    *(("drop_block", r, n) for r, n in CASES),
    *(("no_rescale", r, n) for r, n in CASES if n > TILE),
])
def test_fold_bound_catches_a_broken_fold(mutation, regime, n):
    """The bound stays sharp: a fold that leaves a block's partial out, or
    folds a block's sums without rescaling them to the common maximum,
    lands outside it in every case where the fault changes the sums (a
    one-block case has nothing to rescale)."""
    _, lw_new, _, _ = fs.fused_step_plain(
        R.key(7), *_step_inputs(regime, n), 1.5, tracking_propagate,
        tracking_loglik)
    lw_np = lw_new.numpy()
    assert _stats_within_bound(*_kernel_stats(lw_np), lw_np, _kernel_fold(n))
    with np.errstate(divide="ignore", invalid="ignore"):
        broken = _kernel_stats(lw_np, mutation)
    assert not _stats_within_bound(*broken, lw_np, _kernel_fold(n))
