"""Kernels written by hand for Hopper in CUDA C++, each beside its plain
PyTorch version in the same module: ``cdf_counts``
(``csrc/cdf_counts.cu``), ``fused_step`` (``csrc/fused_step.cu``, with
the model compiled in from ``csrc/models/``), ``logmatmul``
(``csrc/logmatmul.cu``) and ``expand_adaptive``
(``csrc/expand_adaptive.cu``)."""

from genjax_torch.ops.logmatmul import log_matmul

__all__ = ["log_matmul"]
