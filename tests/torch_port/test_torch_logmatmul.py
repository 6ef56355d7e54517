"""The log-space matrix product and the parallel-prefix scan against the
JAX package, on the CPU: ``log_matmul_plain`` (what the wrapper takes for
a CPU tensor) against ``log_matmul_jnp`` and the Pallas kernel in
interpret mode, and ``associative_scan`` against ``lax.associative_scan``.

Inputs are made with numpy and handed to both packages. Float results
agree to 1e-5 relative and absolute, the JAX package's own tolerance
(``tests/ops/test_logmatmul.py``): the two sum the f32 product in
different orders. Integer scans agree exactly.

The card's kernel runs the product in split TF32 on the tensor cores,
which cannot run here; ``_log_matmul_split_tf32`` repeats its arithmetic
on the CPU (TF32 rounding as ``cvt.rna`` does it, the 2^32 operand
scale, three products) and is held to the same tolerance, alone and
inside the parallel filter, beside controls that show why the kernel
takes three products and scales its operands."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax
from jax.scipy.special import logsumexp

from genjax_torch.core.scan import associative_scan, count_combines
from genjax_torch.interop import hmm_config_from_numpy
from genjax_torch.ops.logmatmul import (
    _batch_stride,
    log_matmul,
    log_matmul_plain,
)
from genjax_tpu.inference import exact_testbed as jtb
from genjax_tpu.ops import log_matmul_jnp, log_matmul_pallas

# The packages' ``discrete_hmm`` attributes are singletons, not modules.
jhmm = importlib.import_module("genjax_tpu.lang.distributions.discrete_hmm")
thmm = importlib.import_module(
    "genjax_torch.lang.distributions.discrete_hmm")

TOL = dict(rtol=1e-5, atol=1e-5)


def _pair(shape, scale, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=shape).astype(np.float32) * scale,
            rng.normal(size=shape).astype(np.float32) * scale)


@pytest.mark.parametrize("shape", [(2, 128, 128), (128, 128)])
def test_plain_matches_jnp_and_pallas_interpret(shape):
    x, y = _pair(shape, 2.0, 0)
    got = log_matmul_plain(torch.as_tensor(x), torch.as_tensor(y)).numpy()
    np.testing.assert_allclose(
        got, np.asarray(log_matmul_jnp(jnp.asarray(x), jnp.asarray(y))), **TOL)
    np.testing.assert_allclose(
        got, np.asarray(log_matmul_pallas(jnp.asarray(x), jnp.asarray(y),
                                          interpret=True)), **TOL)


@pytest.mark.parametrize("shape", [(3, 7, 7), (5, 100, 100), (4, 33, 33)])
def test_plain_matches_naive_logsumexp_at_ragged_sizes(shape):
    """Sizes the TPU kernel did not take (S % 128 != 0): the card's
    kernel does, and its plain version is held here to the naive form."""
    x, y = _pair(shape, 3.0, 1)
    want = jax.jit(lambda a, b: logsumexp(
        a[..., :, :, None] + b[..., None, :, :], axis=-2))(
        jnp.asarray(x), jnp.asarray(y))
    got = log_matmul_plain(torch.as_tensor(x), torch.as_tensor(y))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_extreme_and_all_minus_inf_rows():
    x = torch.full((8, 8), -1e30)
    out = log_matmul_plain(x, torch.zeros(8, 8))
    assert bool(torch.all(torch.isfinite(out) | (out < -1e29)))
    # A row that is all -inf is NaN in both packages (not repaired).
    xi = np.zeros((4, 4), np.float32)
    xi[1] = -np.inf
    yi = np.zeros((4, 4), np.float32)
    want = np.asarray(log_matmul_jnp(jnp.asarray(xi), jnp.asarray(yi)))
    got = log_matmul_plain(torch.as_tensor(xi), torch.as_tensor(yi)).numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    assert np.isnan(got[1]).all() and np.isfinite(np.delete(got, 1, 0)).all()


def test_wrapper_takes_the_plain_version_on_the_cpu_and_counts_nothing():
    x, y = _pair((3, 16, 16), 1.0, 2)
    before = log_matmul.launches
    got = log_matmul(torch.as_tensor(x), torch.as_tensor(y))
    assert torch.equal(got, log_matmul_plain(torch.as_tensor(x),
                                             torch.as_tensor(y)))
    empty = log_matmul(torch.zeros(0, 16, 16), torch.zeros(0, 16, 16))
    assert empty.shape == (0, 16, 16)
    assert log_matmul.launches == before


def test_scan_slices_are_read_in_place():
    """The scan's strided operands keep rows contiguous and go to the
    kernel through their batch stride; a permuted layout is copied."""
    ms = torch.randn(9, 6, 6)
    for view in (ms[0:-1:2], ms[1::2], ms[2::2], ms[:-1]):
        assert _batch_stride(view).data_ptr() == view.data_ptr()
    permuted = ms.transpose(1, 2)
    fixed = _batch_stride(permuted)
    assert fixed.is_contiguous() and torch.equal(fixed, permuted)


def test_wrapper_rejects_devices_without_a_kernel():
    x = torch.zeros(2, 8, 8, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        log_matmul(x, x)


@pytest.mark.parametrize("n", range(1, 18))
def test_scan_integer_add_exact(n):
    xs = np.random.default_rng(n).integers(-1000, 1000, size=(n, 3))
    want = np.asarray(jax.jit(lambda v: lax.associative_scan(jnp.add, v))(
        jnp.asarray(xs, jnp.int32)))
    got = associative_scan(torch.add, torch.as_tensor(xs))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("n", [2, 5, 8, 13])
def test_scan_keeps_the_order_of_a_noncommutative_combine(n):
    """Products of permutation matrices are exact and do not commute, so
    an operand swapped anywhere in the tree shows."""
    rng = np.random.default_rng(n)
    mats = np.stack([np.eye(4, dtype=np.int32)[rng.permutation(4)]
                     for _ in range(n)])
    want = np.asarray(jax.jit(lambda v: lax.associative_scan(jnp.matmul, v))(
        jnp.asarray(mats)))
    got = associative_scan(torch.matmul, torch.as_tensor(mats))
    np.testing.assert_array_equal(got.numpy(), want)


def test_scan_over_a_tuple_and_its_combine_count():
    rng = np.random.default_rng(7)
    a = rng.integers(0, 50, size=11)
    b = rng.integers(0, 50, size=11)

    def jfn(p, q):
        return (p[0] + q[0], jnp.maximum(p[1], q[1]))

    calls = []

    def tfn(p, q):
        calls.append(p[0].shape[0])
        return (p[0] + q[0], torch.maximum(p[1], q[1]))

    want = jax.jit(lambda v: lax.associative_scan(jfn, v))(
        (jnp.asarray(a), jnp.asarray(b)))
    got = associative_scan(tfn, (torch.as_tensor(a), torch.as_tensor(b)))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert sum(1 for c in calls if c > 0) == count_combines(11)
    for n in range(1, 40):
        calls.clear()
        associative_scan(tfn, (torch.arange(n), torch.arange(n)))
        assert sum(1 for c in calls if c > 0) == count_combines(n)


@pytest.mark.parametrize("n", [1, 2, 7, 16])
def test_scan_with_log_matmul_matches_jax(n):
    rng = np.random.default_rng(n)
    ms = rng.normal(size=(n, 12, 12)).astype(np.float32)
    want = jax.jit(lambda v: lax.associative_scan(log_matmul_jnp, v))(
        jnp.asarray(ms))
    got = associative_scan(log_matmul, torch.as_tensor(ms))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _tf32_rna(a: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32`` on the CPU: keep 10 of the 23 mantissa bits,
    rounding to nearest with ties away from zero (add half the weight of
    the 13 dropped bits to the magnitude, then clear them). Bit
    arithmetic on the int32 view; inf and NaN pass unchanged."""
    bits = a.contiguous().view(torch.int32)
    rounded = (bits + 0x1000) & ~0x1FFF
    return torch.where(torch.isfinite(a), rounded, bits).view(torch.float32)


def _log_matmul_split_tf32(X: torch.Tensor, Y: torch.Tensor, *,
                           terms: int = 3, operand_scale: float = 2.0 ** 32,
                           flush: bool = False) -> torch.Tensor:
    """The kernel's arithmetic (``csrc/logmatmul.cu``): the exponentials
    ``exp(x - shift)`` times ``operand_scale``, each split into ``hi =
    rna(e)`` and ``lo = rna(e - hi)``, the products ``lo·hi + hi·lo +
    hi·hi`` in f64 summed and cast to f32, unscaled, then ``log(max(P,
    tiny))`` plus the shifts. ``terms=1`` keeps ``hi·hi`` alone (plain
    TF32); ``flush`` zeroes operands below the f32 normal range, as a
    tensor core that flushes subnormals would."""
    tiny = torch.finfo(torch.float32).tiny
    rx = torch.amax(X, dim=-1, keepdim=True)
    cy = torch.amax(Y, dim=-2, keepdim=True)

    def split(e):
        hi = _tf32_rna(e)
        lo = _tf32_rna(e - hi)
        if flush:
            hi, lo = (torch.where(v.abs() < tiny, 0.0, v) for v in (hi, lo))
        return hi.double(), lo.double()

    xh, xl = split(torch.exp(X - rx) * operand_scale)
    yh, yl = split(torch.exp(Y - cy) * operand_scale)
    p = xh @ yh if terms == 1 else xl @ yh + xh @ yl + xh @ yh
    p = p.float() * (1.0 / operand_scale ** 2)
    return torch.log(torch.clamp(p, min=tiny)) + rx + cy


def test_tf32_rounding_is_nearest_ties_away():
    one = 1.0
    ulp = 2.0 ** -10          # the spacing of TF32 values at 1
    vals = torch.tensor([one + ulp / 2, one + ulp / 2 - 2.0 ** -23,
                         -(one + ulp / 2), one + ulp * 1.5, 3.0,
                         float("inf"), 0.0], dtype=torch.float32)
    want = torch.tensor([one + ulp, one, -(one + ulp), one + 2 * ulp, 3.0,
                         float("inf"), 0.0], dtype=torch.float32)
    assert torch.equal(_tf32_rna(vals), want)
    x = torch.as_tensor(np.random.default_rng(3).normal(size=1000)
                        .astype(np.float32))
    r = _tf32_rna(x)
    assert bool(((r.view(torch.int32) & 0x1FFF) == 0).all())
    assert float(((r - x).abs() / x.abs()).max()) <= 2.0 ** -11


def _hmm_operators(s_states: int, n_steps: int):
    """``Ms = T[None] + obs_ll[1:, None, :]`` of circulant(s, s) on the
    testbed's observations: the parallel filter's operands."""
    jconfig = jhmm.DiscreteHMMConfiguration.circulant(s_states, s_states)
    obs = np.asarray(jax.jit(jtb.sample_problem, static_argnums=2)(
        jax.random.key(s_states), jconfig, n_steps).observations)
    trans = np.asarray(jconfig.transition_logits, np.float32)
    obs_ll = np.asarray(jconfig.observation_logits, np.float32)[:, obs].T
    return jconfig, obs, (trans[None] + obs_ll[1:, None, :]).astype(
        np.float32)


@pytest.mark.parametrize("operands", ["normal", "hmm"])
def test_split_tf32_matches_jnp_and_pallas_interpret(operands):
    """The kernel's split-TF32 arithmetic at S = 128, on scale-2 normals
    and on the HMM operators of circulant(128, 128), within the unchanged
    1e-5 tolerance: at every entry against the port's plain version,
    which keeps subnormal exponentials as the card's f32 product does, and
    against the JAX package's two versions wherever P is above the
    subnormal range (by 20 nats). XLA on the CPU flushes subnormals to
    zero, so below that range the JAX package computes another function
    (the HMM operators' floor regime, as in
    test_torch_discrete_hmm.py::test_filters_match_jax)."""
    if operands == "normal":
        x, y = _pair((4, 128, 128), 2.0, 11)
    else:
        ms = _hmm_operators(128, 9)[2]
        x, y = ms[0:-1:2], ms[1::2]
    tx, ty = torch.as_tensor(x), torch.as_tensor(y)
    got = _log_matmul_split_tf32(tx, ty).numpy()
    np.testing.assert_allclose(got, log_matmul_plain(tx, ty).numpy(), **TOL)
    log_p = got - x.max(-1, keepdims=True) - y.max(-2, keepdims=True)
    live = log_p > np.log(np.finfo(np.float32).tiny) + 20.0
    assert live.all() if operands == "normal" else live.mean() > 0.2
    for want in (log_matmul_jnp(jnp.asarray(x), jnp.asarray(y)),
                 log_matmul_pallas(jnp.asarray(x), jnp.asarray(y),
                                   interpret=True)):
        np.testing.assert_allclose(got[live], np.asarray(want)[live], **TOL)


def test_parallel_filter_on_split_tf32_products(monkeypatch):
    """The parallel filter with every combine in the kernel's arithmetic
    (S = T = 128) against the JAX package's sequential filter: the live
    alphas (filtering probability above e^-80) within 2e-5 relative and
    the log marginal within 1e-5 relative, the card's bounds."""
    jconfig, obs, _ = _hmm_operators(128, 128)
    config = hmm_config_from_numpy(jconfig.prior_logits,
                                   jconfig.transition_logits,
                                   jconfig.observation_logits)
    a_ref, m_ref = (np.asarray(v) for v in jax.jit(jhmm.forward_filter)(
        jconfig, jnp.asarray(obs)))
    monkeypatch.setattr(thmm, "log_matmul", _log_matmul_split_tf32)
    alphas, logm = thmm.forward_filter_parallel(config, torch.tensor(obs))
    live = (a_ref - logsumexp(a_ref, -1, keepdims=True)) > -80.0
    a = alphas.numpy()[live]
    assert np.all(np.abs(a - a_ref[live]) <= 2e-5 * np.abs(a_ref[live]))
    assert abs(float(logm) - float(m_ref)) <= 1e-5 * abs(float(m_ref))


def test_plain_tf32_misses_the_f32_tolerance():
    """Negative control: one TF32 product (hi·hi alone) is off by ~5e-4
    relative in P, far outside 1e-5: why the kernel takes three."""
    x, y = _pair((4, 128, 128), 2.0, 11)
    want = np.asarray(log_matmul_jnp(jnp.asarray(x), jnp.asarray(y)))
    one = _log_matmul_split_tf32(torch.as_tensor(x), torch.as_tensor(y),
                                 terms=1).numpy()
    assert not np.all(np.abs(one - want) <= 1e-5 + 1e-5 * np.abs(want))


def test_operand_scale_keeps_subnormals_off_the_tensor_cores():
    """At scale-30 normals the exponentials reach the subnormals. With
    the kernel's 2^32 operand scale a flush of subnormal operands changes
    nothing against the plain f32 product (which keeps them, as the
    card's does); without it, the flush drops terms that sum to more than
    FLT_MIN and misses the tolerance by far (control)."""
    x, y = _pair((4, 128, 128), 30.0, 12)
    tx, ty = torch.as_tensor(x), torch.as_tensor(y)
    want = log_matmul_plain(tx, ty).numpy()  # keeps subnormals, as cuBLAS
    scaled = _log_matmul_split_tf32(tx, ty, flush=True).numpy()
    np.testing.assert_allclose(scaled, want, **TOL)
    unscaled = _log_matmul_split_tf32(tx, ty, flush=True,
                                      operand_scale=1.0).numpy()
    assert not np.all(np.abs(unscaled - want) <= 1e-5 + 1e-5 * np.abs(want))
