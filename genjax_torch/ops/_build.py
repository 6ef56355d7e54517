"""Building the port's kernels at first use, from the sources in the
package, into ``genjax_torch/_build/`` (listed in ``.gitignore``).

CUDA C++ sources are compiled by ``nvcc`` into a shared library with a
plain C interface and loaded with ``ctypes``: a build takes seconds
because no PyTorch header is included.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import tempfile

__all__ = ["BUILD_DIR", "CSRC_DIR", "load_cuda_library"]

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD_DIR = os.path.join(_PKG, "_build")
CSRC_DIR = os.path.join(_PKG, "csrc")

#: Hopper with its architecture-specific features (``sm_90a``).
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([os.path.join(home, "bin", "nvcc")] if home else []) + [
        shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"
    ]:
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")


def load_cuda_library(name: str, *sources: str,
                      include: str | None = None) -> ctypes.CDLL:
    """Compile ``csrc/<sources>`` into ``_build/lib<name>.so`` (again only
    when a source, or the header ``include`` that nvcc includes before
    each of them, is newer than the library) and load it. ``include`` is
    a path under ``csrc/`` or an absolute one, which ``os.path.join``
    keeps (a header generated into ``_build/``). The build goes to a
    temporary file that replaces the library, so processes may build it
    at once. The caller keeps the handle."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    srcs = [os.path.join(CSRC_DIR, s) for s in sources]
    pre = [] if include is None else [os.path.join(CSRC_DIR, include)]
    lib = os.path.join(BUILD_DIR, f"lib{name}.so")
    stale = not os.path.exists(lib) or any(
        os.path.getmtime(s) > os.path.getmtime(lib) for s in srcs + pre
    )
    if stale:
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        includes = [f for h in pre for f in ("-include", h)]
        cmd = [_nvcc(), *NVCC_FLAGS, *includes, "-o", tmp, *srcs]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(
                f"nvcc failed building {name}:\n{' '.join(cmd)}\n"
                f"{proc.stdout}{proc.stderr}"
            )
        os.replace(tmp, lib)
    return ctypes.CDLL(lib)
