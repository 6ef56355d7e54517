"""Type vocabulary for the port (counterpart of ``genjax_tpu/core/typing.py``).

PyTorch runs eagerly, so every tensor is concrete: there is no tracer to
tell apart, and :func:`static_check_is_concrete` is true for every value.
"""

from __future__ import annotations

from typing import Any, Callable, Sequence, TypeAlias, Union

import numpy as np
import torch

__all__ = [
    "PRNGKey",
    "IntArray",
    "FloatArray",
    "BoolArray",
    "ArrayLike",
    "Flag",
    "ScalarFlag",
    "Address",
    "AddressComponent",
    "static_check_is_concrete",
    "static_check_supports_grad",
    "to_float",
]

#: A key: a tensor whose last axis holds two 32-bit words (see core/random.py).
PRNGKey: TypeAlias = torch.Tensor
IntArray: TypeAlias = Union[int, torch.Tensor, np.ndarray]
FloatArray: TypeAlias = Union[float, torch.Tensor, np.ndarray]
BoolArray: TypeAlias = Union[bool, torch.Tensor, np.ndarray]
ArrayLike: TypeAlias = Union[bool, int, float, torch.Tensor, np.ndarray]

#: A possibly-vectorized boolean: a Python bool or a bool tensor.
Flag: TypeAlias = Union[bool, torch.Tensor, np.ndarray]
ScalarFlag: TypeAlias = Union[bool, torch.Tensor, np.ndarray]

AddressComponent: TypeAlias = Union[str, int, torch.Tensor, np.ndarray, slice]
Address: TypeAlias = Union[AddressComponent, tuple]

Callable = Callable  # re-export
Sequence = Sequence  # re-export


def static_check_is_concrete(x: Any) -> bool:
    """True iff ``x`` is a concrete value: always, in eager PyTorch."""
    return True


def static_check_supports_grad(v: Any) -> bool:
    """True iff ``v`` is a floating-point value (a differentiable leaf):
    a float tensor or array, or a Python float."""
    if isinstance(v, torch.Tensor):
        return v.is_floating_point()
    if isinstance(v, np.ndarray | np.generic):
        return np.issubdtype(v.dtype, np.floating)
    return isinstance(v, float)


def to_float(x: ArrayLike) -> torch.Tensor:
    """``x`` as a tensor of the default float type (float32), on its own
    device if it is a tensor."""
    return torch.as_tensor(x, dtype=torch.get_default_dtype())
