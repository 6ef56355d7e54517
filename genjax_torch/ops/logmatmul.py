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

On the card the kernel's result carries a gradient: the launch sits in a
``torch.autograd.Function`` whose backward is :func:`log_matmul_vjp`,
plain products of the max-shifted exponentials (the JAX package's
gradient comes from XLA's autodiff of ``log_matmul_jnp``, outside any
Pallas kernel). A CPU tensor takes the plain version, which autograd
differentiates itself.
"""

from __future__ import annotations

import ctypes
import functools

import torch

__all__ = ["log_matmul", "log_matmul_plain", "log_matmul_vjp", "build"]


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


def log_matmul_vjp(X: torch.Tensor, Y: torch.Tensor, G: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """The gradients of ``<G, log_matmul(X, Y)>`` with respect to ``X``
    and ``Y``, in the order of JAX's autodiff of ``log_matmul_jnp``: the
    product's cotangent ``G / P`` where ``P`` is above the ``tiny`` floor
    (half at a tie, as ``maximum`` splits one; 0 below), through the two
    exponentials, and what the shifts receive (``G``'s sums less the
    exponentials' share) split evenly over each row's or column's
    maxima."""
    rx = torch.amax(X, dim=-1, keepdim=True)
    cy = torch.amax(Y, dim=-2, keepdim=True)
    a, b = torch.exp(X - rx), torch.exp(Y - cy)
    p = torch.matmul(a, b)
    tiny = p.new_tensor(torch.finfo(p.dtype).tiny)
    share = torch.where(p > tiny, 1.0, torch.where(p == tiny, 0.5, 0.0))
    gp = G * share / torch.maximum(p, tiny)
    gxs = a * torch.matmul(gp, b.transpose(-1, -2))
    gys = b * torch.matmul(a.transpose(-1, -2), gp)
    g_rx = G.sum(-1, keepdim=True) - gxs.sum(-1, keepdim=True)
    g_cy = G.sum(-2, keepdim=True) - gys.sum(-2, keepdim=True)
    at_x, at_y = X == rx, Y == cy
    gx = gxs + at_x * (g_rx / at_x.sum(-1, keepdim=True))
    gy = gys + at_y * (g_cy / at_y.sum(-2, keepdim=True))
    return gx, gy


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


def _launch(X: torch.Tensor, Y: torch.Tensor) -> torch.Tensor:
    """One launch of the kernel on ``X`` (B, M, K) and ``Y`` (B, K, N),
    rows contiguous; no launch for B = 0."""
    b, m, k = X.shape
    n = Y.shape[2]
    out = torch.empty((b, m, n), dtype=torch.float32, device=X.device)
    if b == 0:
        return out
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
    return out


class _LogMatmul(torch.autograd.Function):
    """The kernel's launch with :func:`log_matmul_vjp` as its backward
    (``setup_context``, so ``torch.func.grad`` takes it as
    ``torch.autograd.grad`` does)."""

    @staticmethod
    def forward(X, Y):
        # log_matmul sends CPU tensors to the plain version before this;
        # the CPU branch lets the tests and phase 8's rehearsal take the
        # card's route, this Function, on the CPU.
        return log_matmul_plain(X, Y) if X.device.type == "cpu" else _launch(
            X, Y)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs)

    @staticmethod
    def backward(ctx, g):
        X, Y = ctx.saved_tensors
        gx, gy = log_matmul_vjp(X, Y, g)
        return (gx if ctx.needs_input_grad[0] else None,
                gy if ctx.needs_input_grad[1] else None)


def log_matmul(X: torch.Tensor, Y: torch.Tensor) -> torch.Tensor:
    """The log-space product of ``X`` (..., M, K) and ``Y`` (..., K, N)
    with the same leading axes, or of two matrices. Leading axes (a batch
    of problems and their pairs, ``(B, pairs)``) flatten into the one
    batch axis of a single launch.

    A CPU tensor takes :func:`log_matmul_plain`; a CUDA f32 tensor
    launches the kernel, whose result autograd differentiates through
    :func:`log_matmul_vjp`, or raises. An empty batch returns an empty
    result without a launch."""
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
    out = _LogMatmul.apply(_batch_stride(X), _batch_stride(Y))
    return out[0] if squeeze else out


#: Kernel launches so far (the CPU path and empty batches do not count).
log_matmul.launches = 0
