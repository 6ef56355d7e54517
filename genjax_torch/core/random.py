"""Functional counter-based random numbers with ``jax.random``'s threefry2x32
semantics (jax 0.9, ``jax_threefry_partitionable=True``).

A key is a tensor whose last axis holds two 32-bit words, kept in int64
(``torch`` has no working ``uint32`` arithmetic on the CPU, so every add,
rotate and xor is masked back to 32 bits). The same key data gives the
same bits and uniforms as ``jax.random``; normals go through XLA's f32
``erf_inv`` polynomial and agree to a few ulp.

The particle axis is written out instead of vmapped: a key of shape
``B + (2,)`` is a batch ``B`` of keys, and every draw of per-key shape
``shape`` returns ``B + shape``, element ``[b, ...]`` being what
``jax.random`` gives for key ``b``. Parameters broadcast against that
output from the right, so a per-particle parameter carries the full
``B + event`` shape.

Counterpart of ``jax.random`` plus the in-kernel generator of
``genjax_tpu/ops/fused_step.py:53-93``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

__all__ = [
    "MASK32",
    "threefry2x32",
    "key",
    "key_data",
    "split",
    "fold_in",
    "bits",
    "uniform",
    "normal",
    "erfinv_f32",
    "bernoulli",
    "exponential",
    "log1p_f32",
    "categorical",
    "gumbel",
    "gamma",
    "loggamma",
    "beta",
    "dirichlet",
    "geometric",
    "event_shape",
]

MASK32 = 0xFFFFFFFF
_ROT_A = (13, 15, 26, 6)
_ROT_B = (17, 29, 16, 24)
_PARITY = 0x1BD11BDA


def _rotl(v: torch.Tensor, r: int) -> torch.Tensor:
    return ((v << r) | (v >> (32 - r))) & MASK32


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32, 20 rounds (Random123): encrypt counter words
    ``(x0, x1)`` under key ``(k0, k1)``. Words are int64 tensors holding
    values in ``[0, 2^32)``; all four broadcast together."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & MASK32
    x1 = (x1 + ks[1]) & MASK32
    for g in range(5):
        rots = _ROT_A if g % 2 == 0 else _ROT_B
        for r in rots:
            x0 = (x0 + x1) & MASK32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(g + 1) % 3]) & MASK32
        x1 = (x1 + ks[(g + 2) % 3] + (g + 1)) & MASK32
    return x0, x1


def _words(k: torch.Tensor) -> torch.Tensor:
    if k.dtype != torch.int64:
        k = k.to(torch.int64) & MASK32
    if k.shape[-1:] != (2,):
        raise ValueError(f"a key's last axis holds 2 words, got {tuple(k.shape)}")
    return k


def key(seed: int, device=None) -> torch.Tensor:
    """``jax.random.key(seed)`` with x64 off: words ``[0, seed mod 2^32]``."""
    return torch.tensor([0, int(seed) & MASK32], dtype=torch.int64,
                        device=device)


def key_data(k: torch.Tensor) -> torch.Tensor:
    """The key's words (the port's keys are their data)."""
    return _words(k)


def _hash(k: torch.Tensor, lo: torch.Tensor):
    """threefry2x32 of counter ``(0, lo)`` under every key of ``k``;
    ``lo`` has the per-key shape and broadcasts against the key batch."""
    k = _words(k)
    extra = lo.ndim
    k0 = k[..., 0].reshape(k.shape[:-1] + (1,) * extra)
    k1 = k[..., 1].reshape(k.shape[:-1] + (1,) * extra)
    return threefry2x32(k0, k1, torch.zeros_like(lo), lo)


def split(k: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split``: ``B + (2,)`` keys -> ``B + (num, 2)``. Unpack
    with ``.unbind(-2)``."""
    lo = torch.arange(num, dtype=torch.int64, device=k.device)
    y0, y1 = _hash(k, lo)
    return torch.stack([y0, y1], dim=-1)


def fold_in(k: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in``; ``data`` (int or int tensor) broadcasts
    against the key batch, so ``fold_in(k, arange(n))`` is the vmap of
    ``fold_in`` over ``n`` indices."""
    k = _words(k)
    d = torch.as_tensor(data, dtype=torch.int64, device=k.device) & MASK32
    y0, y1 = threefry2x32(k[..., 0], k[..., 1], torch.zeros_like(d), d)
    return torch.stack([y0, y1], dim=-1)


def bits(k: torch.Tensor, shape=()) -> torch.Tensor:
    """``jax.random.bits`` (32-bit) per key: int64 words of shape
    ``B + shape``."""
    shape = tuple(shape)
    size = math.prod(shape)
    if size >= 1 << 32:
        raise NotImplementedError("bits beyond 2^32 elements per key")
    lo = torch.arange(size, dtype=torch.int64, device=k.device).reshape(shape)
    y0, y1 = _hash(k, lo)
    return y0 ^ y1


def _f32(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``a·b + c`` rounded once to f32, as XLA's fused multiply-add gives
    it: the f32 product is exact in f64, so only the final cast rounds."""
    return (a.double() * b.double() + c.double()).float()


def uniform(k: torch.Tensor, shape=(), dtype=torch.float32, minval=0.0,
            maxval=1.0) -> torch.Tensor:
    """``jax.random.uniform`` for f32: the top 23 bits become the
    mantissa of a float in [1, 2), minus one, then scaled and shifted in
    one fused multiply-add and clamped below."""
    if dtype != torch.float32:
        raise NotImplementedError("uniform: only float32")
    b = bits(k, shape)
    fbits = ((b >> 9) | 0x3F800000).to(torch.int32)
    floats = fbits.view(torch.float32) - 1.0
    lo = _f32(minval, k.device)
    hi = _f32(maxval, k.device)
    return torch.maximum(lo, _fma(floats, hi - lo, lo))


_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def erfinv_f32(x: torch.Tensor) -> torch.Tensor:
    """XLA's single-precision ``erf_inv`` (Giles' polynomial), so that
    normals follow ``jax.random.normal`` to a few ulp rather than torch's
    own ``erfinv``."""
    w = -torch.log1p(-x * x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)
    p = torch.where(lt, _f32(_ERFINV_LT5[0], x.device),
                    _f32(_ERFINV_GE5[0], x.device))
    for a, b in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        c = torch.where(lt, _f32(a, x.device), _f32(b, x.device))
        p = _fma(p, w, c)
    out = p * x
    return torch.where(x.abs() == 1.0, x * torch.finfo(torch.float32).max,
                       out)


_NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))


def normal(k: torch.Tensor, shape=(), dtype=torch.float32) -> torch.Tensor:
    """``jax.random.normal``: ``sqrt(2)·erfinv(u)``, ``u`` uniform on
    ``(-1, 1)``."""
    u = uniform(k, shape, dtype, _NORMAL_LO, 1.0)
    return _f32(np.sqrt(2.0), k.device) * erfinv_f32(u)


def bernoulli(k: torch.Tensor, p, shape=()) -> torch.Tensor:
    """``jax.random.bernoulli``: ``uniform < p``."""
    return uniform(k, shape) < _f32(p, k.device)


def _f32_bits(h: str) -> float:
    return float(np.frombuffer(bytes.fromhex(h), ">f8")[0].astype(np.float32))


# XLA's CPU ``log1p`` for f32 (its ``xla.log1p.f32``): below |x| < √2 − 1
# the Cephes rational form, above it ``log(1 + x)`` by XLA's polynomial
# ``log``; the constants are the f32 values of its IR, and the multiply-
# adds that LLVM contracts there are single-rounding FMAs here.
_LOG_P = tuple(_f32_bits(h) for h in (
    "3FB2043760000000", "BFBD7A3700000000", "3FBDE4A340000000",
    "BFBFCBA9E0000000", "3FC23D37E0000000", "BFC555CA00000000",
    "3FC999D580000000", "BFCFFFFF80000000", "3FD5555540000000"))
_LOG_C1, _LOG_C2 = _f32_bits("BF2BD01060000000"), 0.693359375
_SQRT_HALF = _f32_bits("3FE6A09E60000000")
_LOG1P_SMALL = _f32_bits("3FDA8279A0000000")
_LOG1P_DEN = tuple(_f32_bits(h) for h in (
    "402E2035A0000000", "4054C30B60000000", "406BB865A0000000",
    "4073519460000000", "406B0DB140000000", "404E0F3040000000"))
_LOG1P_NUM = tuple(_f32_bits(h) for h in (
    "3F07BC0960000000", "3FDFE818A0000000", "401A509F40000000",
    "403DE97380000000", "404E798EC0000000", "404C8E75A0000000",
    "40340A2020000000"))


def log1p_f32(x: torch.Tensor) -> torch.Tensor:
    """``log1p`` of an f32 tensor as XLA computes it on the CPU, bit for
    bit (torch's own is 1 ulp off for about one input in fourteen).
    Another device takes ``torch.log1p``."""
    if x.device.type != "cpu":
        return torch.log1p(x)
    dev = x.device

    def c(v):
        return _f32(v, dev)

    v = x + 1.0
    bits = torch.clamp(v, min=float(np.finfo(np.float32).tiny)).view(
        torch.int32)
    m = ((bits & 0x7FFFFF) | 0x3F000000).view(torch.float32)
    low = m < _SQRT_HALF
    e = ((bits >> 23) - 127).to(torch.float32) + 1.0 - low.to(torch.float32)
    t = (m - 1.0) + torch.where(low, m, c(0.0))
    z = t * t
    z3 = z * t
    p = [_fma(_fma(t, c(_LOG_P[i]), c(_LOG_P[i + 1])), t, c(_LOG_P[i + 2]))
         for i in (0, 3, 6)]
    y = _fma(_fma(_fma(p[0], z3, p[1]), z3, p[2]), z3, e * _LOG_C1)
    large = _fma(e, c(_LOG_C2), _fma(z, c(-0.5), t) + y)
    # XLA's NaN here is all ones.
    nan = torch.tensor(-1, dtype=torch.int32, device=dev).view(torch.float32)
    large = torch.where(v > 0, large, nan)
    large = torch.where(v == 0, c(-math.inf), large)
    large = torch.where(v == math.inf, c(math.inf), large)
    x2 = x * x
    den = x + _LOG1P_DEN[0]
    for d in _LOG1P_DEN[1:]:
        den = _fma(den, x, c(d))
    num = _fma(c(_LOG1P_NUM[0]), x, c(_LOG1P_NUM[1]))
    for n in _LOG1P_NUM[2:]:
        num = _fma(num, x, c(n))
    small = x + _fma(x2, c(-0.5), (x * x2) * (num / den))
    return torch.where(x.abs() < _LOG1P_SMALL, small, large)


def exponential(k: torch.Tensor, shape=()) -> torch.Tensor:
    """``jax.random.exponential``: ``-log1p(-u)``, ``u`` uniform on [0, 1);
    bit for bit on the CPU (:func:`log1p_f32`)."""
    return -log1p_f32(-uniform(k, shape))


def gumbel(k: torch.Tensor, shape=()) -> torch.Tensor:
    """``jax.random.gumbel`` (``mode="low"``)."""
    tiny = torch.finfo(torch.float32).tiny
    return -torch.log(-torch.log(uniform(k, shape, minval=tiny, maxval=1.0)))


def categorical(k: torch.Tensor, logits, shape=None) -> torch.Tensor:
    """``jax.random.categorical`` by the Gumbel-max trick over the last
    axis of ``logits``; ``shape`` defaults to the per-key batch of the
    logits."""
    logits = _f32(logits, k.device)
    if shape is None:
        shape = event_shape(k, logits[..., 0])
    g = gumbel(k, tuple(shape) + logits.shape[-1:])
    return torch.argmax(g + logits, dim=-1)


def event_shape(k: torch.Tensor, *params) -> tuple:
    """The per-key draw shape for parameters ``params``: their broadcast
    shape behind the key batch. Every tensor parameter of a batched draw
    leads with the batch (``gfi/gfn.py``), so the batch rank is the
    key's, never read from a length; a 0-d parameter or a Python number
    is the same for every key."""
    shp = torch.broadcast_shapes(*(tuple(np.shape(p)) if not isinstance(
        p, torch.Tensor) else tuple(p.shape) for p in params))
    return tuple(shp[k.ndim - 1:])


#: Rejection rounds before :func:`loggamma` gives up; one round accepts
#: with probability above 0.95 for every ``alpha``.
_GAMMA_MAX_ROUNDS = 64


def loggamma(k: torch.Tensor, alpha, shape=()):
    """``log`` of a Gamma(``alpha``, 1) draw per key, by Marsaglia–Tsang
    with the ``alpha < 1`` boost. Each round draws one normal and one
    uniform per element from keys folded with the round number and
    accepts under a mask, so the rejection loop runs over the whole batch
    at once. Distributionally equal to ``jax.random.loggamma``, not
    bitwise."""
    out_shape = tuple(k.shape[:-1]) + tuple(shape)
    alpha = torch.broadcast_to(_f32(alpha, k.device), out_shape)
    boost = alpha < 1.0
    a = torch.where(boost, alpha + 1.0, alpha)
    d = a - 1.0 / 3.0
    c = 1.0 / torch.sqrt(9.0 * d)
    k_boost, k_loop = split(k).unbind(-2)
    log_g = torch.zeros(out_shape, dtype=torch.float32, device=k.device)
    done = torch.zeros(out_shape, dtype=torch.bool, device=k.device)
    for r in range(_GAMMA_MAX_ROUNDS):
        k_n, k_u = split(fold_in(k_loop, r)).unbind(-2)
        x = normal(k_n, shape)
        v = (1.0 + c * x) ** 3
        u = uniform(k_u, shape)
        ok = (v > 0) & (torch.log(u) < 0.5 * x * x + d - d * v
                        + d * torch.log(torch.clamp(v, min=1e-30)))
        take = ok & ~done
        log_g = torch.where(take, torch.log(d) + torch.log(
            torch.clamp(v, min=1e-30)), log_g)
        done = done | ok
        if bool(done.all()):
            break
    else:
        raise RuntimeError("loggamma: rejection loop did not finish")
    ub = uniform(k_boost, shape, minval=torch.finfo(torch.float32).tiny)
    return torch.where(boost, log_g + torch.log(ub) / alpha, log_g)


def gamma(k: torch.Tensor, alpha, shape=()) -> torch.Tensor:
    """A Gamma(``alpha``, 1) draw per key (see :func:`loggamma`)."""
    return torch.exp(loggamma(k, alpha, shape))


def beta(k: torch.Tensor, a, b, shape=()) -> torch.Tensor:
    """A Beta(``a``, ``b``) draw per key: the ratio of two Gamma draws,
    formed in log space as ``jax.random.beta`` does."""
    ka, kb = split(k).unbind(-2)
    la = loggamma(ka, a, shape)
    lb = loggamma(kb, b, shape)
    m = torch.maximum(la, lb)
    ga = torch.exp(la - m)
    gb = torch.exp(lb - m)
    return ga / (ga + gb)


def dirichlet(k: torch.Tensor, alpha, shape=()) -> torch.Tensor:
    """A Dirichlet(``alpha``) draw per key, as ``jax.random.dirichlet``
    forms it: the softmax of ``loggamma`` draws over the last axis.
    ``shape`` is the per-key batch in front of ``alpha``'s last axis."""
    alpha = _f32(alpha, k.device)
    return torch.softmax(
        loggamma(k, alpha, tuple(shape) + tuple(alpha.shape[-1:])), dim=-1)


def geometric(k: torch.Tensor, p, shape=()) -> torch.Tensor:
    """``jax.random.geometric``: the number of trials to the first success
    (support 1, 2, ...), ``floor(log u / log1p(-p)) + 1``, as int32."""
    p = _f32(p, k.device)
    u = uniform(k, shape)
    g = torch.floor(torch.log(u) / torch.log1p(-p).expand(u.shape)) + 1.0
    return g.to(torch.int32)
