"""ADEV's per-element ``cond`` whose branches hold non-tail-call sites
(``genjax_torch/adev/core.py``, ``_Run._split``), against what
``jax.vmap`` of the JAX package's ``lax.switch`` of CPS branches
computes (``genjax_tpu/adev/core.py:806-835``): a site's continuation is
the rest of its branch and then the program after the ``cond``, and each
execution takes its own branch's estimate.

- Enumeration in both branches behind a data predicate, no other noise:
  the gradient is exact in both packages, equal within 1e-6.
- ``x ~ normal_reparam``; ``cond(x > 0, enumerated flip, 0)``: the mean
  gradient over 2^14 keys within 4 se of the exact 0.5.
- REINFORCE in one branch: within 4 se of the exact gradient.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

import genjax_tpu.adev as ja
from genjax_torch import adev as ta
from genjax_torch.adev import core as tcore
from genjax_torch.core import random
from genjax_torch.interop import key_from_numpy

KEY = jax.random.key(314159)


def _tkey(k):
    return key_from_numpy(np.asarray(jax.random.key_data(k)))


def _mean_se(x):
    x = np.asarray(x, np.float64)
    return x.mean(), x.std() / np.sqrt(x.size)


def test_enumeration_in_both_branches_matches_jax():
    def body(lib, cond, where, p, d):
        return cond(d > 0,
                    lambda: where(lib.flip_enum(p), 2.0, 0.0),
                    lambda: where(lib.flip_enum(p * p), 1.0, 3.0))

    keys = jax.random.split(KEY, 8)
    ds = np.asarray([1.0, -1.0, 0.5, -2.0, 3.0, -0.1, 0.2, -0.3],
                    np.float32)
    p = 0.3
    jloss = ja.expectation(lambda p, d: body(
        ja, lambda c, t, f: jax.lax.cond(c, t, f), jnp.where, p, d))
    want = jax.jit(jax.vmap(lambda k, d: jloss.grad_estimate(k, (p, d))))(
        keys, jnp.asarray(ds))
    tloss = ta.expectation(lambda p, d: body(ta, ta.cond, torch.where, p, d))
    got = tloss.grad_estimate(_tkey(keys), (torch.full((8,), p),
                                             torch.tensor(ds)))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=1e-6, atol=1e-6)
    # The exact gradients: 2 where d > 0, -4p elsewhere.
    np.testing.assert_allclose(got[0].numpy(),
                               np.where(ds > 0, 2.0, -4 * p), rtol=1e-6)
    value = tloss.estimate(_tkey(keys), (torch.full((8,), p),
                                         torch.tensor(ds)))
    np.testing.assert_allclose(value.numpy(),
                               np.where(ds > 0, 2 * p, 3 - 2 * p * p),
                               rtol=1e-6)


def test_reparameterized_predicate_enumerated_branch():
    @ta.expectation
    def loss(p):
        x = ta.normal_reparam(0.0, 1.0)
        return ta.cond(x > 0, lambda: torch.where(ta.flip_enum(p), 1.0, 0.0),
                       lambda: torch.zeros(()))

    g = loss.grad_estimate(random.split(random.key(2), 1 << 14), (0.3,))[0]
    mean, se = _mean_se(g.numpy())
    assert abs(mean - 0.5) <= 4 * se, (mean, se)


def test_reinforce_in_one_branch():
    """E[cond(d > 0, 3·flip(p), p²)] over d = ±1 per execution: the
    gradient is 3 where d > 0 and 2p elsewhere; REINFORCE's estimate of
    the first within 4 se, the second exact (no site in that branch)."""
    @ta.expectation
    def loss(p, d):
        return ta.cond(d > 0,
                       lambda: 3.0 * ta.flip_reinforce(p).float(),
                       lambda: p * p)

    n, p = 1 << 14, 0.4
    d = torch.where(torch.arange(n) % 2 == 0, 1.0, -1.0)
    runs = tcore.program_runs()
    g = loss.grad_estimate(random.split(random.key(5), n),
                           (torch.full((n,), p), d))[0].numpy()
    assert tcore.program_runs() > runs
    pos, neg = g[d.numpy() > 0], g[d.numpy() < 0]
    mean, se = _mean_se(pos)
    assert abs(mean - 3.0) <= 4 * se, (mean, se)
    np.testing.assert_allclose(neg, 2 * p, rtol=1e-6)


def test_nested_conds_split_at_the_outermost():
    """An enumerated site in a cond inside a cond: every execution takes
    its own path through both predicates, so each gradient is exact (2,
    2p or 3 by the path)."""
    @ta.expectation
    def loss(p, d1, d2):
        return ta.cond(
            d1 > 0,
            lambda: ta.cond(d2 > 0,
                            lambda: torch.where(ta.flip_enum(p), 2.0, 0.0),
                            lambda: p * p),
            lambda: 3.0 * p)

    p = 0.3
    d1 = torch.tensor([1.0, 1.0, -1.0, -1.0])
    d2 = torch.tensor([1.0, -1.0, 1.0, -1.0])
    g = loss.grad_estimate(random.split(random.key(9), 4),
                           (torch.full((4,), p), d1, d2))[0]
    np.testing.assert_allclose(g.numpy(), [2.0, 2 * p, 3.0, 3.0], rtol=1e-6)
