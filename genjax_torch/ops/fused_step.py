"""One particle-filter step in one pass: counter-based RNG + propagate +
log-likelihood + weight accumulate + logsumexp / ESS statistics. The
kernel is written in CUDA C++ for Hopper (``csrc/fused_step.cu``), one
launch a step; its plain PyTorch version is :func:`fused_step_plain`.

Replaces ``genjax_tpu/ops/fused_step.py::make_fused_step`` (body
``_fused_kernel``, with ``threefry2x32`` and ``normal_from_counter``).
The TPU kernel traces the user's ``propagate`` / ``loglik`` Python
callables into its body; the CUDA kernel compiles the model in from a
header of ``__device__`` functions, one library a header. The header is
generated from the torch callables by :mod:`genjax_torch.ops.fused_model`
(``cuda_model=None``, the default: any elementwise model, traced at
each call with the constants it reads then), or is a
hand-written one of ``csrc/models/<name>.cuh`` named by a
:class:`CudaModel` (the header's name and the constants it reads, taken
from the same Python values as the torch form).

What bounds it on the card: bytes and the integer pipe, about equally
(see the source's header). Each block writes one partial (max, sumexp)
pair of ``lw`` and ``2·lw``, and the last block to finish folds them in
a fixed order (no float atomics), so a step is one launch and no host
sync: the key's words and the observation are read through pointers
from device tensors. The host path of a call is the checks, one
``torch.empty`` (two for bf16 state) and one ctypes call; the first call
with a tuple of constants also copies them to the device
(:func:`param_table`), where the kernel reads them, any number of them.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from genjax_torch.core import random
from genjax_torch.core.random import threefry2x32

__all__ = [
    "CudaModel",
    "threefry2x32",
    "normal_from_counter",
    "fused_step_plain",
    "fused_step",
    "build",
]


class CudaModel(NamedTuple):
    """A scalar-state model's CUDA form: the header ``csrc/models/<name>
    .cuh``, or for a ``gen_<sha256>`` name the one that
    :func:`~genjax_torch.ops.fused_model.cuda_model` generated, defines
    its ``propagate`` and ``loglik``, which read ``params`` (float
    constants, any number, in the order the header lists; the launch
    reads them from a copy on the device, :func:`param_table`)."""

    name: str
    params: tuple[float, ...]


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


@functools.cache
def build(model: str) -> ctypes.CDLL:
    """Compile (at first use) and load the kernel's library for the model
    ``csrc/models/<model>.cuh``, or the generated header of a ``gen_``
    model, and set its functions' signatures, once per process and
    model."""
    from genjax_torch.ops._build import load_cuda_library
    from genjax_torch.ops.fused_model import header_path

    header = (header_path(model) if model.startswith("gen_")
              else f"models/{model}.cuh")
    lib = load_cuda_library(f"fused_step_{model}", "fused_step.cu",
                            include=header)
    p = ctypes.c_void_p
    lib.fused_step_launch.argtypes = [
        p, p, p, p, p, p, p, p, p, ctypes.c_longlong, ctypes.c_int, p,
        ctypes.c_int, p,
    ]
    lib.fused_step_launch.restype = ctypes.c_int
    lib.fused_step_partial_floats.argtypes = [ctypes.c_longlong]
    lib.fused_step_partial_floats.restype = ctypes.c_longlong
    lib.fused_step_threefry_bits.argtypes = [p, p, ctypes.c_longlong, p]
    lib.fused_step_threefry_bits.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=64)
def _scratch_floats(model: str, n: int) -> int:
    """Floats of the partials a launch for ``n`` elements writes."""
    return build(model).fused_step_partial_floats(n)


#: ``param_table``'s tables: (id of the tuple, device) -> (tuple, table).
_tables: dict = {}
_TABLES_KEPT = 64


def param_table(params: tuple[float, ...], device) -> torch.Tensor:
    """The model's constants as the f32 tensor on ``device`` that the
    launch points to, any number of them. It is made once for each
    ``params`` tuple and device: a generated model's tuple is new at each
    generation (once a fused filter run), a :class:`CudaModel`'s lives as
    long as it does, so a run's steps copy the constants once. Keyed by
    the tuple's identity, not its values, so a -0.0 keeps its sign; the
    last ``_TABLES_KEPT`` are kept."""
    key = (id(params), device)
    hit = _tables.get(key)
    if hit is not None and hit[0] is params:
        return hit[1]
    table = torch.tensor(params, dtype=torch.float32, device=device)
    if len(_tables) >= _TABLES_KEPT:
        del _tables[next(iter(_tables))]
    _tables[key] = (params, table)
    return table


@functools.cache
def _ticket(device: torch.device, stream: int) -> torch.Tensor:
    """The kernel's last-block ticket for the launches on one stream:
    zeroed once; every launch leaves it at 0 again."""
    return torch.zeros(1, dtype=torch.int32, device=device)


def fused_step(seeds, xs, lw, obs, propagate, loglik, *,
               cuda_model: CudaModel | None = None,
               state_dtype=torch.float32):
    """One filter step ``(seeds, xs, lw, obs) -> (xs_new, lw_new, lse,
    ess)``: ``seeds`` the step key's two words, ``xs`` the state
    (``state_dtype``), ``lw`` f32 log-weights, ``obs`` a scalar
    observation. A CPU tensor takes :func:`fused_step_plain` with the
    torch model; a CUDA tensor launches the kernel with ``cuda_model``,
    or, where that is None, with the CUDA form generated from
    ``propagate`` / ``loglik`` as they are at this call
    (:mod:`~genjax_torch.ops.fused_model`, which raises on an op it
    cannot take; the trace costs milliseconds, so a loop generates it
    once and passes it, as :func:`~genjax_torch.inference.pf.
    fused_particle_filter` does a run), or raises. On the card the inputs must already conform
    (contiguous ``xs`` / ``lw`` on one device, the key's int64 words there, ``obs`` a
    one-element f32 tensor there or a number): nothing is converted but a
    number. The outputs are new tensors; ``lse`` and ``ess`` are 0-d
    views of the same allocation as ``lw_new``."""
    if xs.device.type == "cpu":
        return fused_step_plain(seeds, xs, lw, obs, propagate, loglik,
                                state_dtype)
    if xs.device.type != "cuda":
        raise ValueError(f"fused_step: no kernel for {xs.device}")
    dev = xs.device
    if (state_dtype not in (torch.float32, torch.bfloat16)
            or xs.dtype != state_dtype or xs.ndim != 1
            or not xs.is_contiguous()):
        raise ValueError(f"fused_step: xs must be 1-D contiguous "
                         f"{state_dtype} (float32 or bfloat16)")
    if (lw.dtype != torch.float32 or lw.shape != xs.shape
            or lw.device != dev or not lw.is_contiguous()):
        raise ValueError("fused_step: lw must be contiguous float32 shaped "
                         "like xs, on its device")
    n = xs.shape[0]
    if not 0 < n < 1 << 32:
        raise ValueError("fused_step: the element counter is 32-bit")
    if (not isinstance(seeds, torch.Tensor) or seeds.dtype != torch.int64
            or seeds.shape != (2,) or seeds.device != dev
            or not seeds.is_contiguous()):
        raise ValueError("fused_step: seeds must be the key's two int64 "
                         "words on the ensemble's device")
    if not isinstance(obs, torch.Tensor):
        obs = torch.tensor(float(obs), device=dev)
    elif obs.dtype != torch.float32 or obs.numel() != 1 or obs.device != dev:
        raise ValueError("fused_step: obs must be one float32 on the "
                         "ensemble's device")
    if cuda_model is None:
        from genjax_torch.ops.fused_model import cuda_model as generate

        cuda_model = generate(propagate, loglik, dev)
    lib = build(cuda_model.name)
    # One allocation for lw_new, the partials and (lse, ess), and x_new
    # too where it is f32; each part starts on 16 bytes.
    pad = -(-n // 4) * 4
    n_part = _scratch_floats(cuda_model.name, n)
    f32_state = state_dtype == torch.float32
    head = pad if f32_state else 0
    buf = torch.empty(head + pad + n_part + 2, dtype=torch.float32,
                      device=dev)
    xs_new = (buf[:n] if f32_state
              else torch.empty(n, dtype=state_dtype, device=dev))
    lw_new = buf[head:head + n]
    stats_at = head + pad + n_part
    base = buf.data_ptr()
    # The current stream's handle without building a torch.cuda.Stream
    # (the call torch.compile's generated code makes): 0.1 us, not 3.4.
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    err = lib.fused_step_launch(
        seeds.data_ptr(), obs.data_ptr(), xs.data_ptr(), lw.data_ptr(),
        xs_new.data_ptr(), base + 4 * head, base + 4 * (head + pad),
        base + 4 * stats_at, _ticket(dev, stream).data_ptr(), n,
        int(not f32_state), param_table(cuda_model.params, dev).data_ptr(),
        len(cuda_model.params), stream,
    )
    if err != 0:
        raise RuntimeError(f"fused_step kernel launch failed: CUDA error "
                           f"{err}")
    fused_step.launches += 1
    by_model = fused_step.launches_by_model
    by_model[cuda_model.name] = by_model.get(cuda_model.name, 0) + 1
    return xs_new, lw_new, buf[stats_at], buf[stats_at + 1]


#: Kernel launches so far (the CPU path does not count), in all and by the
#: model's header name.
fused_step.launches = 0
fused_step.launches_by_model = {}
