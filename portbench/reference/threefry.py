"""A frozen copy of the counter-based draws that the benchmark's
references and its input generator need: ``jax.random``'s threefry2x32
keys (``jax_threefry_partitionable=True``) and the draws built on them,
written from the published algorithms in plain PyTorch.

It imports nothing of the program under test, so a later change to the
program's own key layer cannot move what the reference draws. Words are
int64 tensors holding values in ``[0, 2^32)``; every add and rotation is
masked back to 32 bits. It runs on any device.

Draws come out in float64 where the program draws in float32: a uniform
is built from the same 23 (or 24) bits, so it is the program's float32
value exactly, and what follows it (the inverse error function, the
logarithm, Box-Muller) is taken in float64.
"""

from __future__ import annotations

import math

import torch

MASK32 = 0xFFFFFFFF
_ROT_A = (13, 15, 26, 6)
_ROT_B = (17, 29, 16, 24)
_PARITY = 0x1BD11BDA


def _rotl(v: torch.Tensor, r: int) -> torch.Tensor:
    return ((v << r) | (v >> (32 - r))) & MASK32


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32 with 20 rounds (Random123), all four words
    broadcast together: ``(y0, y1)``."""
    k0, k1, x0, x1 = torch.broadcast_tensors(k0, k1, x0, x1)
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & MASK32
    x1 = (x1 + ks[1]) & MASK32
    for g in range(5):
        for r in (_ROT_A if g % 2 == 0 else _ROT_B):
            x0 = (x0 + x1) & MASK32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(g + 1) % 3]) & MASK32
        x1 = (x1 + ks[(g + 2) % 3] + (g + 1)) & MASK32
    return x0, x1


def seed_key(seed: int, device=None) -> torch.Tensor:
    """The key of a seed of up to 64 bits: words ``[seed >> 32, seed mod
    2^32]`` (``jax.random.key`` with x64 on; a seed below 2^32 gives the
    key that ``jax.random.key`` gives with x64 off)."""
    seed = int(seed)
    if not 0 <= seed < 1 << 64:
        raise ValueError(f"seed {seed} is not a whole number of 64 bits")
    return torch.tensor([(seed >> 32) & MASK32, seed & MASK32],
                        dtype=torch.int64, device=device)


def _hash(k: torch.Tensor, lo: torch.Tensor):
    """threefry of counter ``(0, lo)`` under each key of ``k`` (``B +
    (2,)``); ``lo`` has the per-key shape."""
    extra = lo.ndim
    k0 = k[..., 0].reshape(k.shape[:-1] + (1,) * extra)
    k1 = k[..., 1].reshape(k.shape[:-1] + (1,) * extra)
    return threefry2x32(k0, k1, torch.zeros_like(lo), lo)


def split(k: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split``: ``B + (2,)`` -> ``B + (num, 2)``."""
    lo = torch.arange(num, dtype=torch.int64, device=k.device)
    y0, y1 = _hash(k, lo)
    return torch.stack([y0, y1], dim=-1)


def fold_in(k: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in``, ``data`` broadcast against the keys."""
    d = torch.as_tensor(data, dtype=torch.int64, device=k.device) & MASK32
    y0, y1 = threefry2x32(k[..., 0], k[..., 1], torch.zeros_like(d), d)
    return torch.stack([y0, y1], dim=-1)


def bits(k: torch.Tensor, shape=()) -> torch.Tensor:
    """``jax.random.bits`` (32-bit): ``B + shape`` words."""
    shape = tuple(shape)
    lo = torch.arange(math.prod(shape), dtype=torch.int64,
                      device=k.device).reshape(shape)
    y0, y1 = _hash(k, lo)
    return y0 ^ y1


def _unit23(b: torch.Tensor) -> torch.Tensor:
    """The top 23 bits as the float in [0, 1) that ``jax.random.uniform``
    builds (mantissa of [1, 2), minus one): exact in float64."""
    return (b >> 9).to(torch.float64) * 2.0 ** -23


def uniform(k: torch.Tensor, shape=(), minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform`` in float32, returned in float64: the unit
    float times ``(hi - lo)`` plus ``lo`` rounded once to float32 (XLA's
    fused multiply-add), clamped below by ``lo``."""
    lo = torch.tensor(minval, dtype=torch.float32).double()
    hi = torch.tensor(maxval, dtype=torch.float32).double()
    span = (hi.float() - lo.float()).double()
    f = (_unit23(bits(k, shape)) * span + lo).float().double()
    return torch.maximum(f, lo.to(f.device))


_NORMAL_LO = float(torch.nextafter(torch.tensor(-1.0),
                                   torch.tensor(0.0)).item())


def normal(k: torch.Tensor, shape=()) -> torch.Tensor:
    """``jax.random.normal``: ``sqrt 2 · erfinv(u)``, ``u`` the float32
    uniform on ``(-1, 1)``; the inverse error function in float64."""
    return math.sqrt(2.0) * torch.erfinv(uniform(k, shape, _NORMAL_LO, 1.0))


def gumbel(k: torch.Tensor, shape=()) -> torch.Tensor:
    """``jax.random.gumbel``: ``-log(-log u)``, ``u`` the float32 uniform
    on ``[tiny, 1)``."""
    tiny = float(torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(uniform(k, shape, tiny, 1.0)))


def counter_normal(k: torch.Tensor, n: int) -> torch.Tensor:
    """The fused filter step's normals: threefry of counter ``(i, 0)``
    under the key for ``i < n``, the top 24 bits of each word as a unit
    float, then the cosine branch of Box-Muller, in float64."""
    ctr = torch.arange(n, dtype=torch.int64, device=k.device)
    b0, b1 = threefry2x32(k[0], k[1], ctr, torch.zeros_like(ctr))
    u1 = (b0 >> 8).to(torch.float64) * 2.0 ** -24
    u2 = (b1 >> 8).to(torch.float64) * 2.0 ** -24
    return torch.sqrt(-2.0 * torch.log1p(-u1)) * torch.cos(2 * math.pi * u2)
