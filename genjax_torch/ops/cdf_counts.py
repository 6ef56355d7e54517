"""Systematic-resampling CDF -> cumulative offspring counts: the kernel
written in CUDA C++ for Hopper (``csrc/cdf_counts.cu``) and its plain
PyTorch version.

Replaces ``genjax_tpu/ops/cdf_counts.py::systematic_cumulative_pallas``
(body ``_cdf_counts_kernel``). The TPU kernel carries a running (sum,
max) pair across a sequential grid; on the card the blocks run in no
order, so the kernel is two launches: per-tile (max, sum) partials, then
each tile's offsets from those partials, its prefix sums and a
decoupled look-back for the cross-tile running maximum, without float
atomics (see the source's header). It is bound by bytes: 12 MB at 2^20
particles, a few microseconds of the card's 3.35 TB/s.

``m = max(lw)`` is found inside the launches, so a call is two device
operations and nothing more. The normalizer is the kernel's own total of
the tile partials, and ``u0`` is drawn inside the kernel from the key's
two words, bit for bit as ``random.uniform(key, ())``: the key
arithmetic of the plain version is about a hundred tiny launches, which
would cost more than the kernel. Nothing syncs the host.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from genjax_torch.core import random

__all__ = [
    "systematic_cumulative",
    "systematic_cumulative_plain",
    "build",
]


def systematic_cumulative_plain(key, log_weights: torch.Tensor,
                                n: int) -> torch.Tensor:
    """``smc.systematic_offspring_cumulative`` of the JAX package in torch:
    cumsum, exact monotone repair by ``cummax``, ``ceil(cum·n/total −
    u0)`` clipped to ``[0, n]``, and the last entry pinned to ``n``."""
    cum = torch.cumsum(torch.exp(log_weights - log_weights.max()), dim=0)
    cum = torch.cummax(cum, dim=0).values
    u0 = random.uniform(key.to(log_weights.device), ())
    scale = n / cum[-1]
    counts_cum = torch.clamp(torch.ceil(cum * scale - u0), 0, n).to(torch.int32)
    counts_cum[-1] = n
    return counts_cum


@functools.cache
def build() -> ctypes.CDLL:
    """Compile (at first use) and load the kernel's library, and set its
    functions' signatures, once per process."""
    from genjax_torch.ops._build import load_cuda_library

    lib = load_cuda_library("cdf_counts", "cdf_counts.cu")
    lib.cdf_counts_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p,
    ]
    lib.cdf_counts_launch.restype = ctypes.c_int
    lib.cdf_counts_scratch_bytes.argtypes = [ctypes.c_longlong]
    lib.cdf_counts_scratch_bytes.restype = ctypes.c_longlong
    return lib


def systematic_cumulative(key, log_weights: torch.Tensor,
                          n: int) -> torch.Tensor:
    """Inclusive cumulative offspring counts of systematic resampling of
    ``n`` destinations from ``log_weights`` (int32, one per source).

    A CPU tensor takes :func:`systematic_cumulative_plain`; a CUDA tensor
    launches the kernel or raises."""
    if log_weights.device.type == "cpu":
        return systematic_cumulative_plain(key, log_weights, n)
    if log_weights.device.type != "cuda":
        raise ValueError(f"cdf_counts: no kernel for {log_weights.device}")
    if log_weights.dtype != torch.float32 or log_weights.ndim != 1:
        raise ValueError("cdf_counts: log_weights must be 1-D float32")
    k = log_weights.shape[0]
    if k == 0 or not 0 <= n < 2**31:
        raise ValueError(f"cdf_counts: unsupported sizes k={k}, n={n}")
    lw = log_weights.contiguous()
    words = random.key_data(key.to(lw.device)).contiguous()
    if words.shape != (2,):
        raise ValueError("cdf_counts: one key of two words")
    lib = build()
    out = torch.empty(k, dtype=torch.int32, device=lw.device)
    scratch = torch.empty(lib.cdf_counts_scratch_bytes(k),
                          dtype=torch.uint8, device=lw.device)
    stream = torch.cuda.current_stream(lw.device).cuda_stream
    err = lib.cdf_counts_launch(lw.data_ptr(), words.data_ptr(),
                                out.data_ptr(), scratch.data_ptr(), k, n,
                                stream)
    if err != 0:
        raise RuntimeError(f"cdf_counts kernel launch failed: CUDA error {err}")
    systematic_cumulative.launches += 1
    return out


#: Kernel launches so far (the CPU path does not count).
systematic_cumulative.launches = 0
