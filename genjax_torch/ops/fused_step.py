"""One particle-filter step in one pass: counter-based RNG + propagate +
log-likelihood + weight accumulate + logsumexp / ESS statistics. The
kernel is written in Triton for Hopper (``ops/_fused_step_triton.py``);
its plain PyTorch version is :func:`fused_step_plain`.

Replaces ``genjax_tpu/ops/fused_step.py::make_fused_step`` (body
``_fused_kernel``, with ``threefry2x32`` and ``normal_from_counter``).
The TPU kernel traces the user's ``propagate`` / ``loglik`` Python
callables into its body; the Triton kernel takes them as ``@triton.jit``
functions passed as ``tl.constexpr`` arguments, so the model comes in
two forms: torch callables for the plain version and Triton callables
for the kernel.

What bounds it on the card: bytes. At 2^20 particles a step reads the
state and the weights and writes them back, about 16 MB against 3.35
TB/s; the threefry rounds (~100 integer ops per element) stay in
registers. Each program takes one block of elements and writes its
partial (max, sumexp) pairs of ``lw`` and ``2·lw``; a second one-program
pass combines them in a fixed order (no atomics), so the step costs two
launches and no host sync: the seeds and the observation are read
through pointers from device tensors.
"""

from __future__ import annotations

import math

import torch

from genjax_torch.core import random

__all__ = [
    "normal_from_counter",
    "fused_step_plain",
    "fused_step",
    "BLOCK",
]

#: Elements per Triton program.
BLOCK = 1024


def _u24_to_unit(b: torch.Tensor) -> torch.Tensor:
    """Top 24 bits -> f32 uniform in [0, 1) (exact conversion)."""
    return (b >> 8).to(torch.float32) * (1.0 / (1 << 24))


def normal_from_counter(k0, k1, ctr: torch.Tensor) -> torch.Tensor:
    """One standard normal per counter element: threefry2x32 of
    ``(ctr, 0)`` under ``(k0, k1)``, then the Box–Muller cosine branch,
    as ``genjax_tpu/ops/fused_step.py:84-93``."""
    b0, b1 = random.threefry2x32(k0, k1, ctr, torch.zeros_like(ctr))
    u1 = _u24_to_unit(b0)
    u2 = _u24_to_unit(b1)
    r = torch.sqrt(-2.0 * torch.log1p(-u1))
    return r * torch.cos((2.0 * math.pi) * u2)


def fused_step_plain(seeds, xs, lw, obs, propagate, loglik,
                     state_dtype=torch.float32):
    """``fused_step_reference`` of the JAX package in torch: returns
    ``(xs_new, lw_new, lse, ess)``."""
    seeds = random.key_data(torch.as_tensor(seeds, device=xs.device))
    n = xs.shape[0]
    ctr = torch.arange(n, dtype=torch.int64, device=xs.device)
    eps = normal_from_counter(seeds[0], seeds[1], ctr)
    x_new = propagate(xs.to(torch.float32), eps)
    dlw = loglik(x_new, torch.as_tensor(obs, dtype=torch.float32,
                                        device=xs.device))
    lw_new = lw + dlw
    m = lw_new.max()
    lse = m + torch.log(torch.exp(lw_new - m).sum())
    lse2 = 2.0 * m + torch.log(torch.exp(2.0 * (lw_new - m)).sum())
    ess = torch.exp(2.0 * lse - lse2)
    return x_new.to(state_dtype), lw_new, lse, ess


def fused_step(seeds, xs, lw, obs, propagate, loglik, *,
               propagate_triton=None, loglik_triton=None,
               state_dtype=torch.float32):
    """One filter step ``(seeds, xs, lw, obs) -> (xs_new, lw_new, lse,
    ess)``: ``seeds`` the step key's two words, ``xs`` the state
    (``state_dtype``), ``lw`` f32 log-weights, ``obs`` a scalar
    observation. A CPU tensor takes :func:`fused_step_plain` with the
    torch model; a CUDA tensor launches the Triton kernel with the Triton
    model, or raises."""
    if xs.device.type == "cpu":
        return fused_step_plain(seeds, xs, lw, obs, propagate, loglik,
                                state_dtype)
    if xs.device.type != "cuda":
        raise ValueError(f"fused_step: no kernel for {xs.device}")
    if propagate_triton is None or loglik_triton is None:
        raise ValueError(
            "fused_step on a CUDA tensor needs the model's Triton form "
            "(propagate_triton= and loglik_triton=)"
        )
    if xs.dtype != state_dtype or xs.ndim != 1:
        raise ValueError(f"fused_step: xs must be 1-D {state_dtype}")
    if lw.dtype != torch.float32 or lw.shape != xs.shape:
        raise ValueError("fused_step: lw must be float32 shaped like xs")
    if xs.shape[0] >= 1 << 32:
        raise ValueError("fused_step: the element counter is 32-bit")
    from genjax_torch.ops import _fused_step_triton as tk

    seeds = torch.as_tensor(seeds, device=xs.device).to(torch.int64)
    obs = torch.as_tensor(obs, dtype=torch.float32, device=xs.device)
    xs_new, lw_new, lse, ess = tk.launch(
        seeds.contiguous(), obs.reshape(1), xs.contiguous(), lw.contiguous(),
        propagate_triton, loglik_triton, BLOCK,
    )
    fused_step.launches += 1
    return xs_new, lw_new, lse, ess


#: Kernel launches so far (the CPU path does not count).
fused_step.launches = 0
