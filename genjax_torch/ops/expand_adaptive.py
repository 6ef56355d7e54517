"""The systematic-resampling expansion ``repeat(leaf, diff(counts_cum))``
for one 4-byte leaf: the kernel written in CUDA C++ for Hopper
(``csrc/expand_adaptive.cu``) and its plain PyTorch version.

Replaces ``genjax_tpu/ops/expand_adaptive.py::expand_adaptive`` (body
``_kernel``). The TPU kernel's adaptive windows and integer telescope
exist for the VPU's cost model and are not ported: on the card the
expansion is a merge path of the source ends and the destinations, cut
into equal tiles of the merged sequence, so that every block does the
same work whatever the counts, stages its windows in shared memory and
writes its destinations as one contiguous run. It is bound by bytes, 12
a destination (see the source's header). As in the JAX package, nothing
on the product path calls it: ``inference/smc.py::resample_tree``
expands with ``repeat_interleave``. Its entry point is this public
function.
"""

from __future__ import annotations

import ctypes
import functools

import torch

__all__ = ["expand_adaptive", "expand_adaptive_plain",
           "supports_adaptive_expand", "build"]

# The JAX kernel's gate, kept as it is: lanes, dest blocks per grid step
# and the VMEM budget of the TPU kernel.
LANES = 128
TB = 128
VMEM_CAP_BYTES = 12 * 1024 * 1024


def supports_adaptive_expand(n_src: int, n_dest: int, leaves) -> bool:
    """The JAX kernel's preconditions, unchanged: square expansion, one
    4-byte-wide vector leaf, lane/grid-aligned size, comb + values + out
    within VMEM. The card's kernel takes any ``n``; this predicate says
    where the TPU's did."""
    if n_src != n_dest or n_src % (LANES * TB) != 0:
        return False
    if len(leaves) != 1:
        return False
    (leaf,) = leaves
    if leaf.ndim != 1 or leaf.element_size() != 4:
        return False
    return 2 * 4 * n_src <= VMEM_CAP_BYTES


def expand_adaptive_plain(leaf: torch.Tensor, counts_cum: torch.Tensor,
                          n: int) -> torch.Tensor:
    """Destination ``j`` takes the first source ``i`` with
    ``counts_cum[i] > j`` (``searchsorted(..., right=True)``), then a
    gather: bit for bit ``repeat_interleave(leaf, diff(counts_cum),
    output_size=n)``."""
    dest = torch.arange(n, dtype=counts_cum.dtype, device=counts_cum.device)
    return leaf[torch.searchsorted(counts_cum, dest, right=True)]


@functools.cache
def build() -> ctypes.CDLL:
    """Compile (at first use) and load the kernel's library, and set its
    function's signature, once per process."""
    from genjax_torch.ops._build import load_cuda_library

    lib = load_cuda_library("expand_adaptive", "expand_adaptive.cu")
    lib.expand_adaptive_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_void_p,
    ]
    lib.expand_adaptive_launch.restype = ctypes.c_int
    return lib


def expand_adaptive(leaf: torch.Tensor, counts_cum: torch.Tensor,
                    n: int) -> torch.Tensor:
    """``repeat(leaf, diff(counts_cum), output_size=n)``, bit for bit, for
    one ``(n,)`` leaf of 4-byte elements; ``counts_cum`` is the inclusive
    cumulative offspring count (nondecreasing, ``counts_cum[-1] == n``),
    the contract of ``inference/smc.py::systematic_offspring_cumulative``.

    A CPU tensor takes :func:`expand_adaptive_plain`; a CUDA tensor
    launches the kernel or raises."""
    if leaf.device.type == "cpu" and counts_cum.device.type == "cpu":
        return expand_adaptive_plain(leaf, counts_cum, n)
    if leaf.device.type != "cuda" or counts_cum.device != leaf.device:
        raise ValueError(f"expand_adaptive: no kernel for {leaf.device} / "
                         f"{counts_cum.device}")
    if leaf.ndim != 1 or leaf.element_size() != 4:
        raise ValueError("expand_adaptive: one 1-D leaf of 4-byte elements")
    if counts_cum.dtype != torch.int32 or counts_cum.shape != leaf.shape:
        raise ValueError("expand_adaptive: counts_cum must be int32 of the "
                         "leaf's shape")
    if leaf.shape[0] != n or not 0 < n < 2**31:
        raise ValueError(f"expand_adaptive: the kernel expands n = "
                         f"{leaf.shape[0]} sources into as many dests, "
                         f"not {n}")
    src = leaf.contiguous().view(torch.int32)
    cc = counts_cum.contiguous()
    out = torch.empty(n, dtype=torch.int32, device=leaf.device)
    stream = torch.cuda.current_stream(leaf.device).cuda_stream
    err = build().expand_adaptive_launch(src.data_ptr(), cc.data_ptr(),
                                         out.data_ptr(), n, stream)
    if err != 0:
        raise RuntimeError(f"expand_adaptive kernel launch failed: CUDA "
                           f"error {err}")
    expand_adaptive.launches += 1
    return out.view(leaf.dtype)


#: Kernel launches so far (the CPU path does not count).
expand_adaptive.launches = 0
