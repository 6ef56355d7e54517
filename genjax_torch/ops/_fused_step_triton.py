"""The Triton kernel of ``ops/fused_step.py``. This module imports
``triton`` at its top, so only the launching function imports it, and
only for a CUDA tensor.

``_fused_step_kernel``: one program per block of ``BLOCK`` elements. The
counter is the global flat index as uint32, as in the TPU kernel
(``genjax_tpu/ops/fused_step.py:116-122``); threefry2x32 runs on
``(counter, 0)`` with the key schedule and rotations of ``:53-74``; the
top 24 bits of each word become a uniform (``:77-81``); Box–Muller is
``sqrt(-2·log1p(-u1))·cos(2π·u2)`` (``:92-93``). Each program stores its
block's ``x_new`` (in the state dtype) and ``lw_new``, and its partial
``(max, sumexp(lw − max), sumexp(2·(lw − max)))``.

``_combine_kernel``: one program folds the partials into ``lse`` and
``ess`` in a fixed order, the streaming update of ``:100-104`` done as
one block reduction.
"""

from __future__ import annotations

import torch
import triton
import triton.language as tl
from triton.language.extra import libdevice

from genjax_torch.ops._build import triton_cache_dir

triton_cache_dir()


@triton.jit
def _rotl(v, r: tl.constexpr):
    return (v << r) | (v >> (32 - r))


@triton.jit
def _threefry2x32(k0, k1, x0, x1):
    k2 = k0 ^ k1 ^ 0x1BD11BDA
    x0 = x0 + k0
    x1 = x1 + k1
    # group 0: rotations 13 15 26 6; inject (k1, k2 + 1)
    x0 = x0 + x1; x1 = _rotl(x1, 13) ^ x0
    x0 = x0 + x1; x1 = _rotl(x1, 15) ^ x0
    x0 = x0 + x1; x1 = _rotl(x1, 26) ^ x0
    x0 = x0 + x1; x1 = _rotl(x1, 6) ^ x0
    x0 = x0 + k1
    x1 = x1 + k2 + 1
    # group 1: rotations 17 29 16 24; inject (k2, k0 + 2)
    x0 = x0 + x1; x1 = _rotl(x1, 17) ^ x0
    x0 = x0 + x1; x1 = _rotl(x1, 29) ^ x0
    x0 = x0 + x1; x1 = _rotl(x1, 16) ^ x0
    x0 = x0 + x1; x1 = _rotl(x1, 24) ^ x0
    x0 = x0 + k2
    x1 = x1 + k0 + 2
    # group 2: inject (k0, k1 + 3)
    x0 = x0 + x1; x1 = _rotl(x1, 13) ^ x0
    x0 = x0 + x1; x1 = _rotl(x1, 15) ^ x0
    x0 = x0 + x1; x1 = _rotl(x1, 26) ^ x0
    x0 = x0 + x1; x1 = _rotl(x1, 6) ^ x0
    x0 = x0 + k0
    x1 = x1 + k1 + 3
    # group 3: inject (k1, k2 + 4)
    x0 = x0 + x1; x1 = _rotl(x1, 17) ^ x0
    x0 = x0 + x1; x1 = _rotl(x1, 29) ^ x0
    x0 = x0 + x1; x1 = _rotl(x1, 16) ^ x0
    x0 = x0 + x1; x1 = _rotl(x1, 24) ^ x0
    x0 = x0 + k1
    x1 = x1 + k2 + 4
    # group 4: inject (k2, k0 + 5)
    x0 = x0 + x1; x1 = _rotl(x1, 13) ^ x0
    x0 = x0 + x1; x1 = _rotl(x1, 15) ^ x0
    x0 = x0 + x1; x1 = _rotl(x1, 26) ^ x0
    x0 = x0 + x1; x1 = _rotl(x1, 6) ^ x0
    x0 = x0 + k2
    x1 = x1 + k0 + 5
    return x0, x1


@triton.jit
def _fused_step_kernel(seed_ptr, obs_ptr, xs_ptr, lw_ptr, xs_out_ptr,
                       lw_out_ptr, part_ptr, n,
                       propagate: tl.constexpr, loglik: tl.constexpr,
                       BLOCK: tl.constexpr):
    pid = tl.program_id(0)
    offs = pid * BLOCK + tl.arange(0, BLOCK)
    mask = offs < n
    k0 = tl.load(seed_ptr).to(tl.uint32)
    k1 = tl.load(seed_ptr + 1).to(tl.uint32)
    obs = tl.load(obs_ptr)
    ctr = offs.to(tl.uint32)
    b0, b1 = _threefry2x32(k0, k1, ctr, tl.zeros_like(ctr))
    u1 = (b0 >> 8).to(tl.float32) * (1.0 / 16777216.0)
    u2 = (b1 >> 8).to(tl.float32) * (1.0 / 16777216.0)
    r = tl.sqrt(-2.0 * libdevice.log1p(-u1))
    eps = r * tl.cos(6.283185307179586 * u2)
    x = tl.load(xs_ptr + offs, mask=mask, other=0.0).to(tl.float32)
    x_new = propagate(x, eps)
    lw_new = tl.load(lw_ptr + offs, mask=mask, other=0.0) + loglik(x_new, obs)
    tl.store(xs_out_ptr + offs, x_new.to(xs_out_ptr.dtype.element_ty),
             mask=mask)
    tl.store(lw_out_ptr + offs, lw_new, mask=mask)
    lw_m = tl.where(mask, lw_new, -float("inf"))
    c = tl.max(lw_m, axis=0)
    t1 = tl.sum(tl.where(mask, tl.exp(lw_new - c), 0.0), axis=0)
    t2 = tl.sum(tl.where(mask, tl.exp(2.0 * (lw_new - c)), 0.0), axis=0)
    tl.store(part_ptr + pid * 3, c)
    tl.store(part_ptr + pid * 3 + 1, t1)
    tl.store(part_ptr + pid * 3 + 2, t2)


@triton.jit
def _combine_kernel(part_ptr, stats_ptr, n_parts, P: tl.constexpr):
    i = tl.arange(0, P)
    mask = i < n_parts
    c = tl.load(part_ptr + i * 3, mask=mask, other=-float("inf"))
    t1 = tl.load(part_ptr + i * 3 + 1, mask=mask, other=0.0)
    t2 = tl.load(part_ptr + i * 3 + 2, mask=mask, other=0.0)
    m = tl.max(c, axis=0)
    s1 = tl.sum(tl.where(mask, t1 * tl.exp(c - m), 0.0), axis=0)
    s2 = tl.sum(tl.where(mask, t2 * tl.exp(2.0 * (c - m)), 0.0), axis=0)
    lse = m + tl.log(s1)
    lse2 = 2.0 * m + tl.log(s2)
    tl.store(stats_ptr, lse)
    tl.store(stats_ptr + 1, tl.exp(2.0 * lse - lse2))


def launch(seeds, obs, xs, lw, propagate, loglik, block: int):
    """Two launches on the current stream; no host sync."""
    n = xs.shape[0]
    n_parts = triton.cdiv(n, block)
    xs_new = torch.empty_like(xs)
    lw_new = torch.empty_like(lw)
    parts = torch.empty(n_parts * 3, dtype=torch.float32, device=xs.device)
    stats = torch.empty(2, dtype=torch.float32, device=xs.device)
    _fused_step_kernel[(n_parts,)](
        seeds, obs, xs, lw, xs_new, lw_new, parts, n,
        propagate=propagate, loglik=loglik, BLOCK=block, num_warps=4,
    )
    _combine_kernel[(1,)](
        parts, stats, n_parts, P=triton.next_power_of_2(n_parts),
        num_warps=8,
    )
    return xs_new, lw_new, stats[0], stats[1]
