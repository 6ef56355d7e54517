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
(tests/ops/test_fused_step.py:74-75)."""

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
    got = np.ctypeslib.as_array(fs.param_array(model.params))
    np.testing.assert_array_equal(got, want)


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


def _kernel_stats(lw: np.ndarray):
    """``(lse, ess)`` as the kernel forms them: per block of TILE, the
    maximum c and the sums of exp(lw - c) and its square (each thread's
    four elements in order, then the tree); the last block's fold of the
    partials, each thread a contiguous run, in the same tree."""
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
        if c != -np.inf:
            e = np.float32(np.exp(np.float32(c - m)))
            s1[i // per] += t1 * e
            s2[i // per] += t2 * (e * e)
    lse = m + np.log(_tree_sum(s1))
    lse2 = np.float32(2.0) * m + np.log(_tree_sum(s2))
    return lse, np.exp(np.float32(2.0) * lse - lse2)


@pytest.mark.parametrize("regime,n", [
    ("mild", 1000), ("mild", 5000), ("skewed", 3 * 1024), ("skewed", 65536),
    ("one_hot", 4097), ("dead_block", 5000),
])
def test_partials_folded_in_kernel_order_match_plain(regime, n):
    """The kernel's lse and ess from its per-block partials, folded in its
    order, equal the plain version's within 1e-6 relative."""
    rng = np.random.default_rng(n)
    xs = rng.normal(size=n).astype(np.float32)
    lw = {"mild": 0.3 * rng.normal(size=n),
          "skewed": 4.0 * rng.normal(size=n),
          "one_hot": np.where(np.arange(n) == n // 2, 0.0, -1e9),
          "dead_block": np.where(np.arange(n) // TILE == 1, -np.inf,
                                 rng.normal(size=n))}[regime]
    txs, tlw = ensemble_from_numpy(xs, lw.astype(np.float32))
    _, lw_new, lse, ess = fs.fused_step_plain(
        R.key(7), txs, tlw, 1.5, tracking_propagate, tracking_loglik)
    k_lse, k_ess = _kernel_stats(lw_new.numpy())
    assert abs(k_lse - float(lse)) <= 1e-6 * abs(float(lse))
    assert abs(k_ess - float(ess)) <= 1e-6 * float(ess)
