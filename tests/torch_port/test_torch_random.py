"""The port's functional key layer (genjax_torch/core/random.py) against
jax.random on the same key data: threefry2x32 on the Random123 vectors,
key / split / fold_in / bits / uniform bit for bit, normals to a few ulp
(XLA's and torch's log1p/sqrt differ by an ulp here and there), and the
rejection samplers (gamma, beta) by Kolmogorov–Smirnov tests, since their
rejection loops draw differently."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats
import torch

from genjax_torch.core import random as R
from genjax_torch.interop import key_from_numpy

SEEDS = [0, 1, 314159, 2**31 - 1]
SHAPES = [(), (5,), (3, 4), (1000,)]


def _pair(seed):
    k = jax.random.key(seed)
    return k, key_from_numpy(np.asarray(jax.random.key_data(k)))


def test_partitionable_threefry_is_on():
    assert jax.config.jax_threefry_partitionable is True


def test_key_facts():
    assert R.key(314159).tolist() == [0, 314159]
    assert np.asarray(jax.random.key_data(jax.random.key(314159))).tolist() \
        == [0, 314159]
    assert R.fold_in(R.key(314159), 3).tolist() == [2473790041, 1386401691]
    # 32-bit seeds wrap as JAX's do with x64 off.
    assert R.key(-1).tolist() == [0, 4294967295]


@pytest.mark.parametrize("key,ctr,want", [
    ((0, 0), (0, 0), (0x6B200159, 0x99BA4EFE)),
    ((0xFFFFFFFF, 0xFFFFFFFF), (0xFFFFFFFF, 0xFFFFFFFF),
     (0x1CB996FC, 0xBB002BE7)),
    ((0x13198A2E, 0x03707344), (0x243F6A88, 0x85A308D3),
     (0xC4923A9C, 0x483DF7A0)),
])
def test_threefry_random123_vectors(key, ctr, want):
    t = lambda v: torch.tensor(v, dtype=torch.int64)
    z0, z1 = R.threefry2x32(t(key[0]), t(key[1]), t(ctr[0]), t(ctr[1]))
    assert (int(z0), int(z1)) == want


@pytest.mark.parametrize("key,ctr,want", [
    ((0, 0), (0, 0), (0x6B200159, 0x99BA4EFE)),
    ((0xFFFFFFFF, 0xFFFFFFFF), (0xFFFFFFFF, 0xFFFFFFFF),
     (0x1CB996FC, 0xBB002BE7)),
    ((0x13198A2E, 0x03707344), (0x243F6A88, 0x85A308D3),
     (0xC4923A9C, 0x483DF7A0)),
])
def test_threefry_torch_body_random123_vectors(key, ctr, want):
    """The torch body, which runs on the card (a CPU tensor takes the
    numpy body), on CPU tensors."""
    t = lambda v: torch.tensor(v, dtype=torch.int64)
    z0, z1 = R._threefry2x32_torch(t(key[0]), t(key[1]), t(ctr[0]),
                                   t(ctr[1]))
    assert (int(z0), int(z1)) == want


@pytest.mark.parametrize("seed", SEEDS)
def test_key_layer_through_torch_body_bitwise(seed, monkeypatch):
    """split, fold_in, bits and uniform with every threefry call taking
    the torch body, against jax.random."""
    monkeypatch.setattr(R, "_threefry2x32_numpy", R._threefry2x32_torch)
    k, kt = _pair(seed)
    for num in (2, 7):
        want = np.asarray(jax.random.key_data(jax.random.split(k, num)))
        np.testing.assert_array_equal(R.split(kt, num).numpy(), want)
    for d in (0, 12345, 2**32 - 1):
        want = np.asarray(jax.random.key_data(jax.random.fold_in(k, d)))
        np.testing.assert_array_equal(R.fold_in(kt, d).numpy(), want)
    for shape in SHAPES:
        np.testing.assert_array_equal(
            R.bits(kt, shape).numpy().astype(np.uint32),
            np.asarray(jax.random.bits(k, shape)))
        np.testing.assert_array_equal(
            R.uniform(kt, shape).numpy(),
            np.asarray(jax.random.uniform(k, shape)))


@pytest.mark.parametrize("seed", SEEDS)
def test_split_and_fold_in_bitwise(seed):
    k, kt = _pair(seed)
    for num in (2, 3, 7):
        want = np.asarray(jax.random.key_data(jax.random.split(k, num)))
        np.testing.assert_array_equal(R.split(kt, num).numpy(), want)
    for d in (0, 1, 3, 12345, 2**32 - 1):
        want = np.asarray(jax.random.key_data(jax.random.fold_in(k, d)))
        np.testing.assert_array_equal(R.fold_in(kt, d).numpy(), want)
    # fold_in over a tensor of indices is fold_in under vmap
    idx = np.arange(6)
    want = np.asarray(jax.random.key_data(
        jax.vmap(lambda i: jax.random.fold_in(k, i))(jnp.asarray(idx))))
    np.testing.assert_array_equal(
        R.fold_in(kt, torch.as_tensor(idx)).numpy(), want)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", SHAPES)
def test_bits_and_uniform_bitwise(seed, shape):
    k, kt = _pair(seed)
    np.testing.assert_array_equal(
        R.bits(kt, shape).numpy().astype(np.uint32),
        np.asarray(jax.random.bits(k, shape)))
    np.testing.assert_array_equal(
        R.uniform(kt, shape).numpy(), np.asarray(jax.random.uniform(k, shape)))
    np.testing.assert_array_equal(
        R.uniform(kt, shape, minval=-2.0, maxval=3.0).numpy(),
        np.asarray(jax.random.uniform(k, shape, minval=-2.0, maxval=3.0)))


def test_batched_keys_are_vmap():
    k, kt = _pair(7)
    ks = jax.random.split(k, 5)
    kts = R.split(kt, 5)
    want = np.asarray(jax.vmap(lambda kk: jax.random.uniform(kk, (3,)))(ks))
    np.testing.assert_array_equal(R.uniform(kts, (3,)).numpy(), want)
    want = np.asarray(jax.vmap(lambda kk: jax.random.bernoulli(kk, 0.3))(ks))
    np.testing.assert_array_equal(R.bernoulli(kts, 0.3).numpy(), want)


@pytest.mark.parametrize("seed", [0, 314159])
def test_normal_within_a_few_ulp(seed):
    k, kt = _pair(seed)
    z = R.normal(kt, (20000,)).numpy()
    zj = np.asarray(jax.random.normal(k, (20000,)))
    ulp = np.abs(z.view(np.int32).astype(np.int64)
                 - zj.view(np.int32).astype(np.int64))
    assert ulp.max() <= 4
    assert (ulp > 0).mean() < 0.05


def test_categorical_matches_jax():
    k, kt = _pair(11)
    logits = np.log(np.array([0.1, 0.2, 0.3, 0.4], np.float32))
    ks, kts = jax.random.split(k, 2000), R.split(kt, 2000)
    want = np.asarray(jax.vmap(lambda kk: jax.random.categorical(
        kk, jnp.asarray(logits)))(ks))
    got = R.categorical(kts, torch.as_tensor(logits)).numpy()
    # Gumbel-max on the same uniforms: equal except where a log rounds
    # differently across a near tie.
    assert (got == want).mean() > 0.999


@pytest.mark.parametrize("a,b", [(2.0, 2.0), (0.5, 3.0), (5.0, 1.5)])
def test_beta_ks(a, b):
    x = R.beta(R.split(R.key(3), 20000), a, b).numpy()
    assert x.min() > 0.0 and x.max() < 1.0
    assert scipy.stats.kstest(x, scipy.stats.beta(a, b).cdf).pvalue > 1e-3
    xj = np.asarray(jax.random.beta(jax.random.key(3), a, b, (20000,)))
    assert scipy.stats.ks_2samp(x, xj).pvalue > 1e-3


@pytest.mark.parametrize("alpha", [0.3, 1.0, 4.5])
def test_gamma_ks(alpha):
    x = R.gamma(R.key(4), alpha, (20000,)).numpy()
    assert (x > 0).all()
    assert scipy.stats.kstest(x, scipy.stats.gamma(alpha).cdf).pvalue > 1e-3
    xj = np.asarray(jax.random.gamma(jax.random.key(4), alpha, (20000,)))
    assert scipy.stats.ks_2samp(x, xj).pvalue > 1e-3


def test_categorical_distribution_int64_values_are_jax_int32_draws():
    """``categorical`` draws int64 indices where the JAX package's are
    int32 (a deliberate deviation: ``torch.gather``, ``scatter`` and
    ``take_along_dim`` index with int64 only). The values are JAX's draws
    on the same keys."""
    import genjax_torch as gt
    import genjax_tpu as gj

    logits = np.log(np.array([0.15, 0.25, 0.35, 0.25], np.float32))
    ks = jax.random.split(jax.random.key(17), 512)
    want = jax.vmap(lambda k: gj.categorical.simulate(
        k, (jnp.asarray(logits),)).get_retval())(ks)
    got = gt.categorical.simulate(
        key_from_numpy(np.asarray(jax.random.key_data(ks))),
        (torch.as_tensor(logits).expand(512, 4),)).get_retval()
    assert want.dtype == jnp.int32 and got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), np.asarray(want, np.int64))
