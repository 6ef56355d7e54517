"""The gradient of the port's log-space product on the card's path
(genjax_torch/ops/logmatmul.py): ``log_matmul_vjp``, the backward of the
``torch.autograd.Function`` around the kernel's launch, against JAX's
autodiff of ``log_matmul_jnp`` (what the JAX package differentiates off
the TPU), on the same seeded inputs and cotangents.

On a CPU tensor the Function's forward is the plain version, so the
Function runs here as on the card but for the launch; the kernel's
forward is held to the plain version on the card by chip_smoke.py phase
8, which also holds this gradient there.

Tolerance 1e-5 relative + 1e-5 absolute: torch and XLA sum the products
(and the shifts' shares, a difference of two sums of order 10) in other
orders."""

import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genjax_tpu.ops.logmatmul import log_matmul_jnp
from genjax_torch.interop import hmm_config_from_numpy
from genjax_torch.lang.distributions.discrete_hmm import (
    forward_filter_parallel,
)
from genjax_torch.ops import logmatmul as lm

jhmm = importlib.import_module("genjax_tpu.lang.distributions.discrete_hmm")
thmm = importlib.import_module(
    "genjax_torch.lang.distributions.discrete_hmm")
TOL = dict(rtol=1e-5, atol=1e-5)


def _operands(case: str, seed: int):
    rng = np.random.default_rng(seed)
    shape = {"s128": (8, 128, 128), "ragged": (8, 100, 100),
             "rows_1e30": (8, 64, 64), "floor": (2, 4, 4)}[case]
    x = (2.0 * rng.normal(size=shape)).astype(np.float32)
    y = (2.0 * rng.normal(size=shape)).astype(np.float32)
    if case == "rows_1e30":
        x[:, 3] = -1e30                 # a whole row
        x[:, 5, 1:] = -1e30             # a row with one live entry
        y[:, 7:9] = -1e30               # rows of Y: dead inner indices
    if case == "floor":
        # Each row of X lives at k = 0 alone and column 1 of Y is dead
        # there, so P[:, :, 1] = 0 and the tiny floor binds.
        x[:] = -1e30
        x[:, :, 0] = 0.0
        y[:, 0, 1] = -1e30
    g = rng.normal(size=shape).astype(np.float32)
    return x, y, g


@pytest.mark.parametrize("case", ["s128", "ragged", "rows_1e30", "floor"])
def test_vjp_matches_jax_autodiff(case):
    x, y, g = _operands(case, 11)
    _, vjp = jax.vjp(log_matmul_jnp, jnp.asarray(x), jnp.asarray(y))
    jx, jy = (np.asarray(v) for v in vjp(jnp.asarray(g)))
    tx, ty = lm.log_matmul_vjp(torch.tensor(x), torch.tensor(y),
                               torch.tensor(g))
    np.testing.assert_allclose(tx.numpy(), jx, **TOL)
    np.testing.assert_allclose(ty.numpy(), jy, **TOL)
    if case == "floor":
        want = np.asarray(log_matmul_jnp(x, y))
        assert (want[:, :, 1] < -80).all()    # log(tiny) + shifts
        np.testing.assert_array_equal(np.isfinite(jx),
                                      np.isfinite(tx.numpy()))


@pytest.mark.parametrize("how", ["autograd", "func"])
def test_function_backward_is_the_vjp(how):
    """``torch.autograd.grad`` and ``torch.func.grad`` both go through the
    Function's backward."""
    x, y, g = (torch.tensor(a) for a in _operands("ragged", 12))
    want = lm.log_matmul_vjp(x, y, g)
    if how == "autograd":
        xr, yr = x.clone().requires_grad_(), y.clone().requires_grad_()
        out = lm._LogMatmul.apply(xr, yr)
        assert out.grad_fn is not None
        got = torch.autograd.grad(out, (xr, yr), g)
    else:
        got = torch.func.grad(
            lambda a, b: (lm._LogMatmul.apply(a, b) * g).sum(),
            argnums=(0, 1))(x, y)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_function_forward_on_the_cpu_is_plain():
    x, y, _ = (torch.tensor(a) for a in _operands("s128", 13))
    assert torch.equal(lm._LogMatmul.apply(x, y), lm.log_matmul_plain(x, y))


@functools.cache
def _filter_case():
    """A random HMM (S = 32, T = 48) and ``jax.grad`` of the JAX
    package's parallel filter's log marginal with respect to its
    transition logits."""
    s, t, n_obs = 32, 48, 6
    rng = np.random.default_rng(5)

    def logits(shape):
        v = rng.normal(size=shape)
        return (v - np.log(np.exp(v).sum(-1, keepdims=True))).astype(
            np.float32)

    prior, trans, obs_l = logits(s), logits((s, s)), logits((s, n_obs))
    xs = rng.integers(0, n_obs, size=t)

    def jax_logm(tr):
        cfg = jhmm.DiscreteHMMConfiguration(jnp.asarray(prior), tr,
                                            jnp.asarray(obs_l))
        return jhmm.forward_filter_parallel(cfg, jnp.asarray(xs))[1]

    want = np.asarray(jax.jit(jax.grad(jax_logm))(jnp.asarray(trans)))
    return prior, trans, obs_l, xs, want


@pytest.mark.parametrize("route", ["function", "plain"])
def test_parallel_filter_gradient_matches_jax(route, monkeypatch):
    """d log p(x_{1:T}) / d transition_logits through the parallel-prefix
    filter, against ``jax.grad`` of the JAX package's filter: through
    the card's Function (its backward), and through autograd of the plain
    version (the CPU path)."""
    prior, trans, obs_l, xs, want = _filter_case()
    if route == "function":
        monkeypatch.setattr(thmm, "log_matmul", lm._LogMatmul.apply)
    cfg = hmm_config_from_numpy(prior, trans, obs_l)
    tr = cfg.transition_logits.clone().requires_grad_()
    cfg = type(cfg)(cfg.prior_logits, tr, cfg.observation_logits)
    _, logm = forward_filter_parallel(cfg, torch.as_tensor(xs))
    (got,) = torch.autograd.grad(logm, tr)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
