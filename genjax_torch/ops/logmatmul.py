"""Log-space matrix product ``C[b,i,j] = logsum_k X[b,i,k] + Y[b,k,j]``:
the kernel written in CUDA C++ for Hopper (``csrc/logmatmul.cu``) and its
plain PyTorch version.

Replaces ``genjax_tpu/ops/logmatmul.py::log_matmul_pallas`` (body
``_kernel``), the combine of the parallel-prefix HMM filter
(``lang/distributions/discrete_hmm.py::forward_filter_parallel``). The
TPU kernel takes one whole (S, S) block per grid step and needs S a
multiple of 128, at most 1024; the Hopper kernel tiles the product and
takes any shape. It runs the product on the tensor cores in split TF32
(each f32 operand as a TF32 ``hi`` plus a TF32 ``lo``, three products
``lo·hi + hi·lo + hi·hi`` into one f32 sum), which keeps about 22
significant bits: plain TF32's 11 would miss the f32 tolerance. See the
source's header for the launches, the bound and the TMA / ``wgmma``
pipeline.
"""

from __future__ import annotations

import ctypes
import functools

import torch

__all__ = ["log_matmul", "log_matmul_plain", "build"]


def log_matmul_plain(X: torch.Tensor, Y: torch.Tensor) -> torch.Tensor:
    """``log_matmul_jnp`` of the JAX package: shift each row of ``X`` and
    each column of ``Y`` by its maximum, multiply the exponentials in
    f32, and take ``log(max(P, tiny))`` plus the shifts (batched over the
    leading dims). A row or column that is all ``-inf`` gives NaN, as in
    JAX."""
    rx = torch.amax(X, dim=-1, keepdim=True)
    cy = torch.amax(Y, dim=-2, keepdim=True)
    p = torch.matmul(torch.exp(X - rx), torch.exp(Y - cy))
    tiny = p.new_tensor(torch.finfo(p.dtype).tiny)
    return torch.log(torch.maximum(p, tiny)) + rx + cy


@functools.cache
def build() -> ctypes.CDLL:
    """Compile (at first use) and load the kernel's library, and set its
    function's signature, once per process."""
    from genjax_torch.ops._build import load_cuda_library

    lib = load_cuda_library("logmatmul", "logmatmul.cu")
    lib.log_matmul_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
        ctypes.c_longlong, ctypes.c_void_p,
    ]
    lib.log_matmul_launch.restype = ctypes.c_int
    lib.log_matmul_scratch_floats.argtypes = [ctypes.c_longlong] * 4
    lib.log_matmul_scratch_floats.restype = ctypes.c_longlong
    return lib


def _batch_stride(t: torch.Tensor) -> torch.Tensor:
    """``t`` (3-D) with rows contiguous, so the kernel reads it through a
    batch stride alone; a copy only where the rows are not."""
    _, r, c = t.shape
    if t.stride(2) == 1 and (t.stride(1) == c or r == 1):
        return t
    return t.contiguous()


def log_matmul(X: torch.Tensor, Y: torch.Tensor) -> torch.Tensor:
    """The log-space product of ``X`` (..., M, K) and ``Y`` (..., K, N)
    with the same leading axes, or of two matrices. Leading axes (a batch
    of problems and their pairs, ``(B, pairs)``) flatten into the one
    batch axis of a single launch.

    A CPU tensor takes :func:`log_matmul_plain`; a CUDA f32 tensor
    launches the kernel or raises. An empty batch returns an empty result
    without a launch."""
    if X.device.type == "cpu" and Y.device.type == "cpu":
        return log_matmul_plain(X, Y)
    if X.device.type != "cuda" or Y.device != X.device:
        raise ValueError(f"log_matmul: no kernel for {X.device} x {Y.device}")
    if X.dtype != torch.float32 or Y.dtype != torch.float32:
        raise ValueError("log_matmul: the kernel takes float32")
    if X.ndim != Y.ndim or X.ndim < 2 or X.shape[:-2] != Y.shape[:-2]:
        raise ValueError(f"log_matmul: shapes {tuple(X.shape)} x "
                         f"{tuple(Y.shape)}: want (..., M, K) x (..., K, N) "
                         "or two matrices")
    if X.ndim > 3:
        lead = tuple(X.shape[:-2])
        out = log_matmul(X.reshape((-1,) + tuple(X.shape[-2:])),
                         Y.reshape((-1,) + tuple(Y.shape[-2:])))
        return out.reshape(lead + tuple(out.shape[-2:]))
    squeeze = X.ndim == 2
    if squeeze:
        X, Y = X[None], Y[None]
    b, m, k = X.shape
    if Y.shape[0] != b or Y.shape[1] != k:
        raise ValueError(f"log_matmul: shapes {tuple(X.shape)} x "
                         f"{tuple(Y.shape)} do not chain")
    n = Y.shape[2]
    if min(m, k, n) == 0:
        raise ValueError("log_matmul: empty matrices")
    out = torch.empty((b, m, n), dtype=torch.float32, device=X.device)
    if b > 0:
        X, Y = _batch_stride(X), _batch_stride(Y)
        lib = build()
        scratch = torch.empty(lib.log_matmul_scratch_floats(b, m, k, n),
                              dtype=torch.float32, device=X.device)
        stream = torch.cuda.current_stream(X.device).cuda_stream
        err = lib.log_matmul_launch(
            X.data_ptr(), X.stride(0), Y.data_ptr(), Y.stride(0),
            out.data_ptr(), scratch.data_ptr(), b, m, k, n, stream)
        if err != 0:
            raise RuntimeError(
                "log_matmul kernel launch failed: "
                + ("no tensor map from the CUDA driver" if err == -1
                   else f"CUDA error {err}"))
        log_matmul.launches += 1
    return out[0] if squeeze else out


#: Kernel launches so far (the CPU path and empty batches do not count).
log_matmul.launches = 0
