"""Kernels written by hand for Hopper, each beside its plain PyTorch
version in the same module: ``cdf_counts`` (CUDA C++,
``csrc/cdf_counts.cu``) and ``fused_step`` (Triton,
``_fused_step_triton.py``)."""
