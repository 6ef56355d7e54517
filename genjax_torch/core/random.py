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
    "cauchy",
    "laplace",
    "logistic",
    "truncated_normal",
    "t",
    "chisquare",
    "poisson",
    "binomial",
    "multinomial",
    "loops",
]

MASK32 = 0xFFFFFFFF
_ROT_A = (13, 15, 26, 6)
_ROT_B = (17, 29, 16, 24)
_PARITY = 0x1BD11BDA


def _rotl(v: torch.Tensor, r: int) -> torch.Tensor:
    return ((v << r) | (v >> (32 - r))) & MASK32


def _threefry2x32_numpy(k0, k1, x0, x1):
    """:func:`threefry2x32` of CPU tensors in numpy's ``uint32``, which
    wraps and shifts as the cipher needs: the same words with no masking,
    at a fraction of torch's per-op cost on small tensors."""
    words = np.broadcast_arrays(*(np.asarray(w, dtype=np.uint32)
                                  for w in (k0, k1, x0, x1)))
    shape = words[0].shape
    k0, k1, x0, x1 = (w.reshape(-1) for w in words)
    ks = (k0, k1, k0 ^ k1 ^ np.uint32(_PARITY))
    x0 = x0 + ks[0]
    x1 = x1 + ks[1]
    for g in range(5):
        rots = _ROT_A if g % 2 == 0 else _ROT_B
        for r in rots:
            x0 = x0 + x1
            x1 = ((x1 << np.uint32(r)) | (x1 >> np.uint32(32 - r))) ^ x0
        x0 = x0 + ks[(g + 1) % 3]
        x1 = x1 + ks[(g + 2) % 3] + np.uint32(g + 1)
    return tuple(torch.from_numpy(w.astype(np.int64).reshape(shape))
                 for w in (x0, x1))


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32, 20 rounds (Random123): encrypt counter words
    ``(x0, x1)`` under key ``(k0, k1)``. Words are int64 tensors holding
    values in ``[0, 2^32)``; all four broadcast together. On the CPU the
    rounds run in numpy's ``uint32``, on the card in torch's ``int64``:
    bit for bit the same words."""
    if all(not isinstance(w, torch.Tensor) or w.device.type == "cpu"
           for w in (k0, k1, x0, x1)):
        return _threefry2x32_numpy(k0, k1, x0, x1)
    return _threefry2x32_torch(k0, k1, x0, x1)


def _threefry2x32_torch(k0, k1, x0, x1):
    """:func:`threefry2x32` in torch's ``int64``, masked to 32 bits after
    each add and rotation: the body that runs on the card."""
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


def split(k: torch.Tensor, num: int = 2, offset: int = 0) -> torch.Tensor:
    """``jax.random.split``: ``B + (2,)`` keys -> ``B + (num, 2)``. Unpack
    with ``.unbind(-2)``. ``offset``: keys ``[offset, offset + num)`` of a
    larger split, bit for bit (a rank's rows of ``split(k, n)``)."""
    lo = torch.arange(offset, offset + num, dtype=torch.int64,
                      device=k.device)
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


def bits(k: torch.Tensor, shape=(), offset: int = 0) -> torch.Tensor:
    """``jax.random.bits`` (32-bit) per key: int64 words of shape
    ``B + shape``. ``offset``: the draw's counters start there, so
    ``bits(k, (r,) + rest, offset=lo * prod(rest))`` is bit for bit rows
    ``[lo, lo + r)`` of ``bits(k, (n,) + rest)`` (a rank's slice of a
    one-key grid draw, made without drawing the rest)."""
    shape = tuple(shape)
    size = math.prod(shape)
    if offset + size >= 1 << 32:
        raise NotImplementedError("bits beyond 2^32 elements per key")
    lo = torch.arange(offset, offset + size, dtype=torch.int64,
                      device=k.device).reshape(shape)
    y0, y1 = _hash(k, lo)
    return y0 ^ y1


def _f32(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``a·b + c`` rounded once to f32, as XLA's fused multiply-add gives
    it: the f32 product is exact in f64, so only the final cast rounds."""
    return (a.double() * b.double() + c.double()).float()


def uniform(k: torch.Tensor, shape=(), dtype=torch.float32, minval=0.0,
            maxval=1.0, offset: int = 0) -> torch.Tensor:
    """``jax.random.uniform`` for f32: the top 23 bits become the
    mantissa of a float in [1, 2), minus one, then scaled and shifted in
    one fused multiply-add and clamped below. ``offset`` as in
    :func:`bits`."""
    if dtype != torch.float32:
        raise NotImplementedError("uniform: only float32")
    b = bits(k, shape, offset)
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


def exponential(k: torch.Tensor, shape=(), offset: int = 0) -> torch.Tensor:
    """``jax.random.exponential``: ``-log1p(-u)``, ``u`` uniform on [0, 1);
    bit for bit on the CPU (:func:`log1p_f32`). ``offset`` as in
    :func:`bits`."""
    return -log1p_f32(-uniform(k, shape, offset=offset))


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


class LoopStats:
    """What the masked rejection loops cost: their trips, and their host
    syncs (one read of "is any lane still active" a trip)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.trips = 0
        self.host_syncs = 0


#: The counts of every masked loop of this module and of the
#: distributions' own loops (``lang/distributions/stdlib.py``).
loops = LoopStats()


def any_active(mask: torch.Tensor) -> bool:
    """Whether any lane of a masked loop is still active: one host sync,
    counted in :data:`loops`."""
    loops.host_syncs += 1
    return bool(mask.any())


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
        loops.trips += 1
        if not any_active(~done):
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


def cauchy(k: torch.Tensor, shape=()) -> torch.Tensor:
    """``jax.random.cauchy``: ``tan(pi (u - 1/2))``, ``u`` uniform on
    [eps, 1)."""
    u = uniform(k, shape, minval=float(np.finfo(np.float32).eps), maxval=1.0)
    return torch.tan(_f32(np.pi, k.device) * (u - 0.5))


def laplace(k: torch.Tensor, shape=()) -> torch.Tensor:
    """``jax.random.laplace``: ``sign(u) log1p(-|u|)``, ``u`` uniform on
    (-1, 1)."""
    lo = -1.0 + float(np.finfo(np.float32).epsneg)
    u = uniform(k, shape, minval=lo, maxval=1.0)
    return torch.sign(u) * log1p_f32(-u.abs())


def logistic(k: torch.Tensor, shape=()) -> torch.Tensor:
    """``jax.random.logistic``: ``log(u) - log1p(-u)``."""
    u = uniform(k, shape, minval=float(np.finfo(np.float32).tiny),
                maxval=1.0)
    return torch.log(u) - log1p_f32(-u)


def truncated_normal(k: torch.Tensor, lower, upper, shape=()
                     ) -> torch.Tensor:
    """``jax.random.truncated_normal``: the normal's inverse CDF of a
    uniform between ``erf(lower/√2)`` and ``erf(upper/√2)``, clipped to
    the open interval (``erfinv_f32``, XLA's polynomial)."""
    lower, upper = _f32(lower, k.device), _f32(upper, k.device)
    sqrt2 = _f32(np.sqrt(2.0), k.device)
    a = torch.erf(lower / sqrt2)
    b = torch.erf(upper / sqrt2)
    u = uniform(k, shape, minval=a, maxval=b)
    out = sqrt2 * erfinv_f32(u)
    inf = _f32(math.inf, k.device)
    return torch.clamp(out, torch.nextafter(lower, inf),
                       torch.nextafter(upper, -inf))


def t(k: torch.Tensor, df, shape=()) -> torch.Tensor:
    """``jax.random.t``: ``n sqrt(df/2 / g)``, ``n`` normal and ``g`` a
    Gamma(df/2) draw on the split keys (the gamma from :func:`loggamma`,
    so equal to JAX's in distribution only)."""
    df = _f32(df, k.device)
    key_n, key_g = split(k).unbind(-2)
    n = normal(key_n, shape)
    half_df = df / 2.0
    g = gamma(key_g, half_df, shape)
    return n * torch.sqrt(half_df / g)


def chisquare(k: torch.Tensor, df, shape=()) -> torch.Tensor:
    """``jax.random.chisquare``: ``2 exp(loggamma(df/2))``."""
    return torch.exp(loggamma(k, _f32(df, k.device) / 2.0, shape)) * 2.0


# -- integer samplers: JAX's loops, lane by lane ----------------------------
#
# ``jax.random.poisson`` and ``binomial`` loop until every element of a
# key's draw is done, splitting the key each trip. Under ``vmap`` over
# keys each key loops on its own and keeps its state once done; here all
# keys step together, and a key's state changes only while one of its
# elements is active, so every key follows the schedule it has alone.

_INT32_MAX = 2 ** 31 - 1
_F32_MAX = float(np.finfo(np.float32).max)


def _key_active(mask: torch.Tensor, nd: int) -> torch.Tensor:
    """Per key: whether any of its ``nd`` trailing draw axes is active,
    broadcast back over them."""
    if nd == 0:
        return mask
    flat = mask.reshape(tuple(mask.shape[:mask.ndim - nd]) + (-1,)).any(-1)
    return flat.reshape(tuple(flat.shape) + (1,) * nd)


def _poisson_knuth(k, lam, shape):
    nd = len(shape)
    count = torch.zeros(lam.shape, dtype=torch.int32, device=lam.device)
    log_prod = torch.zeros_like(lam)
    rng, i = k, 0
    while i < _INT32_MAX:
        live = log_prod > -lam
        on = _key_active(live, nd)
        if not any_active(on):
            break
        rng, sub = split(rng).unbind(-2)
        count = torch.where(on & live, count + 1, count)
        u = uniform(sub, shape)
        log_prod = torch.where(on, log_prod + torch.log(u), log_prod)
        i += 1
        loops.trips += 1
    return count - 1


def _poisson_rejection(k, lam, shape):
    nd = len(shape)
    log_lam = torch.log(lam)
    b = 0.931 + 2.53 * torch.sqrt(lam)
    a = -0.059 + 0.02483 * b
    inv_alpha = 1.1239 + 1.1328 / (b - 3.4)
    v_r = 0.9277 - 3.6224 / (b - 2)
    k_out = torch.full_like(lam, -1.0)
    accepted = torch.zeros(lam.shape, dtype=torch.bool, device=lam.device)
    key, i = k, 0
    while i < _INT32_MAX:
        on = _key_active(~accepted, nd)
        if not any_active(on):
            break
        key, sub0, sub1 = split(key, 3).unbind(-2)
        u = uniform(sub0, shape) - 0.5
        v = uniform(sub1, shape)
        u_shifted = 0.5 - u.abs()
        kk = torch.floor((2 * a / u_shifted + b) * u + lam + 0.43)
        s = torch.log(v * inv_alpha / (a / (u_shifted * u_shifted) + b))
        tt = -lam + kk * log_lam - torch.lgamma(kk + 1)
        accept1 = (u_shifted >= 0.07) & (v <= v_r)
        reject = (kk < 0) | ((u_shifted < 0.013) & (v > u_shifted))
        accept = (accept1 | (~reject & (s <= tt))) & on
        k_out = torch.where(accept, kk, k_out)
        accepted = accepted | accept
        i += 1
        loops.trips += 1
    return k_out.to(torch.int32)


def poisson(k: torch.Tensor, lam, shape=()) -> torch.Tensor:
    """``jax.random.poisson`` (int32): Knuth's product of uniforms below
    ``lam = 10``, Hörmann's transformed rejection above, each with JAX's
    key schedule, so that a key gives JAX's integer wherever the two
    libraries' ``log`` and ``lgamma`` round alike. An algorithm that no
    lane needs is not run (JAX runs both and selects)."""
    out_shape = tuple(k.shape[:-1]) + tuple(shape)
    lam = torch.broadcast_to(_f32(lam, k.device), out_shape)
    use_knuth = torch.isnan(lam) | (lam < 10)
    zero = torch.zeros((), dtype=torch.int32, device=k.device)
    result = torch.zeros(out_shape, dtype=torch.int32, device=k.device)
    if any_active(use_knuth):
        lam_knuth = torch.where(use_knuth, lam, torch.zeros_like(lam))
        result = torch.where(use_knuth, _poisson_knuth(k, lam_knuth, shape),
                             result)
    if any_active(~use_knuth):
        lam_rej = torch.where(use_knuth, torch.full_like(lam, 1e5), lam)
        result = torch.where(use_knuth, result,
                             _poisson_rejection(k, lam_rej, shape))
    return torch.where(lam == 0, zero, result)


def _stirling_approx_tail(k: torch.Tensor) -> torch.Tensor:
    """JAX's ``_stirling_approx_tail``, its clamp before the series
    included."""
    table = torch.tensor([
        0.0810614667953272, 0.0413406959554092, 0.0276779256849983,
        0.02079067210376509, 0.0166446911898211, 0.0138761288230707,
        0.0118967099458917, 0.0104112652619720, 0.00925546218271273,
        0.00833056343336287], dtype=k.dtype, device=k.device)
    use_table = k <= 9
    k = torch.clamp(k, 0.0, 9.0)
    kp1sq = (k + 1) * (k + 1)
    approx = (1.0 / 12 - (1.0 / 360 - 1.0 / 1260 / kp1sq) / kp1sq) / (k + 1)
    # A NaN k (never drawn here) must not index out of the table.
    idx = torch.floor(k).to(torch.int64).clamp(0, 9)
    return torch.where(use_table, table[idx], approx)


def _binomial_inversion(key, count, prob, shape):
    nd = len(shape)
    log1minusprob = log1p_f32(-prob)
    num_geom = torch.zeros_like(prob)
    geom_sum = torch.zeros_like(prob)
    i = 0
    while i < _F32_MAX:
        live = geom_sum <= count
        on = _key_active(live, nd)
        if not any_active(on):
            break
        sub, key = split(key).unbind(-2)
        num_geom = torch.where(on & live, num_geom + 1, num_geom)
        u = uniform(sub, shape)
        geom = torch.ceil(torch.log(u) / log1minusprob)
        geom_sum = torch.where(on, geom_sum + geom, geom_sum)
        i += 1
        loops.trips += 1
    return num_geom - 1


def _btrs(key, count, prob, shape):
    nd = len(shape)
    stddev = torch.sqrt(count * prob * (1 - prob))
    b = 1.15 + 2.53 * stddev
    a = -0.0873 + 0.0248 * b + 0.01 * prob
    c = count * prob + 0.5
    v_r = 0.92 - 4.2 / b
    r = prob / (1 - prob)
    alpha = (2.83 + 5.1 / b) * stddev
    m = torch.floor((count + 1) * prob)
    k_out = torch.full_like(prob, -1.0)
    accepted = torch.zeros(prob.shape, dtype=torch.bool, device=prob.device)
    i = 0
    while i < _F32_MAX:
        on = _key_active(~accepted, nd)
        if not any_active(on):
            break
        key, sub0, sub1 = split(key, 3).unbind(-2)
        u = uniform(sub0, shape)
        v = uniform(sub1, shape)
        u = u - 0.5
        us = 0.5 - u.abs()
        accept1 = (us >= 0.07) & (v <= v_r)
        kk = torch.floor((2 * a / us + b) * u + c)
        reject = (kk < 0) | (kk > count)
        v = torch.log(v * alpha / (a / (us * us) + b))
        ub = ((m + 0.5) * torch.log((m + 1) / (r * (count - m + 1)))
              + (count + 1) * torch.log((count - m + 1) / (count - kk + 1))
              + (kk + 0.5) * torch.log(r * (count - kk + 1) / (kk + 1))
              + _stirling_approx_tail(m)
              + _stirling_approx_tail(count - m)
              - _stirling_approx_tail(kk)
              - _stirling_approx_tail(count - kk))
        accept = (accept1 | (~reject & (v <= ub))) & on
        k_out = torch.where(accept, kk, k_out)
        accepted = accepted | accept
        i += 1
        loops.trips += 1
    return k_out


def binomial(k: torch.Tensor, n, p, shape=()) -> torch.Tensor:
    """``jax.random.binomial`` (f32): inversion by geometric gaps where
    ``n·min(p, 1-p) <= 10``, BTRS above, with JAX's key schedules and its
    handling of NaN, negative and infinite arguments."""
    out_shape = tuple(k.shape[:-1]) + tuple(shape)
    prob = torch.broadcast_to(_f32(p, k.device), out_shape)
    count = torch.broadcast_to(_f32(n, k.device), out_shape)
    p_lt_half = prob < 0.5
    q = torch.where(p_lt_half, prob, 1.0 - prob)
    count_nan_or_neg = torch.isnan(count) | (count < 0.0)
    count_inf = torch.isinf(count)
    q_is_nan = torch.isnan(q)
    q_l_0 = q < 0.0
    q = torch.where(q_is_nan | q_l_0, torch.full_like(q, 0.01), q)
    use_inversion = count_nan_or_neg | (count * q <= 10.0)
    count = torch.floor(count)
    samples = torch.zeros(out_shape, dtype=torch.float32, device=k.device)
    if any_active(use_inversion):
        count_inv = torch.where(use_inversion, count, torch.zeros_like(count))
        samples = torch.where(use_inversion,
                              _binomial_inversion(k, count_inv, q, shape),
                              samples)
    if any_active(~use_inversion):
        count_btrs = torch.where(use_inversion, torch.full_like(count, 1e4),
                                 count)
        q_btrs = torch.where(use_inversion, torch.full_like(q, 0.5), q)
        samples = torch.where(use_inversion, samples,
                              _btrs(k, count_btrs, q_btrs, shape))
    invalid = q_l_0 | q_is_nan | count_nan_or_neg
    samples = torch.where(invalid, torch.full_like(samples, math.nan),
                          samples)
    samples = torch.where(count_inf & ~invalid,
                          torch.full_like(samples, math.inf), samples)
    return torch.where(p_lt_half | count_nan_or_neg | q_is_nan | count_inf,
                       samples, count - samples)


def multinomial(k: torch.Tensor, n, p, shape=None) -> torch.Tensor:
    """``jax.random.multinomial`` (f32 counts): a chain of binomials over
    the outcomes in order, outcome ``j`` on key ``split(k, K)[j]`` with the
    ratio of its probability to the mass left. ``shape`` is the per-key
    batch in front of the outcomes (default: ``p``'s behind the key
    batch)."""
    p = _f32(p, k.device)
    if shape is None:
        shape = event_shape(k, p[..., 0], n)
    out_shape = tuple(k.shape[:-1]) + tuple(shape)
    n = torch.broadcast_to(_f32(n, k.device), out_shape)
    p = torch.broadcast_to(p, out_shape + tuple(p.shape[-1:]))
    remaining = torch.flip(torch.cumsum(torch.flip(p, (-1,)), dim=-1), (-1,))
    ratios = p / torch.where(remaining == 0, torch.ones_like(remaining),
                             remaining)
    keys = split(k, p.shape[-1])
    counts = []
    for j in range(p.shape[-1]):
        c = binomial(keys[..., j, :], n, ratios[..., j].clamp(0, 1), shape)
        n = n - c
        counts.append(c)
    return torch.stack(counts, dim=-1)
