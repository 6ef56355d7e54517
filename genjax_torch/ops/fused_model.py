"""A scalar-state model's CUDA form, generated from its torch form.

The TPU kernel of the fused filter step (``genjax_tpu/ops/fused_step.py::
make_fused_step``) traces the user's elementwise ``propagate(x, eps)`` and
``loglik(x_new, obs)`` into its body. The CUDA kernel
(``csrc/fused_step.cu``) compiles its model in from a header that defines
``fused_model::propagate``, ``loglik`` and ``kParams``. This module writes
that header from the torch callables, so that any elementwise model
reaches the card without a hand-written header:

1. each callable is traced with ``make_fx`` on one-element f32 tensors
   on the ensemble's device (so a closed-over 0-d tensor on the card
   mixes with them) into a flat graph of aten ops;
2. each op of an explicit list becomes one line of C: arithmetic, ``pow``
   (an integer exponent as products, any other through ``powf``), the
   C math functions, minimum / maximum / clamp (NaN-propagating, as
   torch's), ``where`` over comparisons, and f32 copies and casts as
   no-ops. Any other op raises ``ValueError`` naming it and the callable:
   a reduction, indexing, a second random draw, a Python branch on a
   tensor value, a cast to another type. Nothing falls back;
3. every float constant of the graph (Python numbers, closed-over 0-d
   tensors read as f32) is hoisted into the launch's ``p[]`` in graph
   order, propagate's first; only an integer ``pow`` exponent stays in
   the text. So the source depends on the model's structure alone: a
   model whose constants change reuses its library, and only ``params``
   change. The constants are read when the model is generated: a
   callable that reads them from a global, a closure, a list or a 0-d
   tensor changed in place gives the new values on the next generation
   (the fused filter generates once a run).

The header uses C math functions (``expf``, ``log1pf``, ...) and IEEE
``/`` only, so the same text compiles on the host (the CPU tests build it
with ``g++``). It goes to ``_build/models/<sha256 of source>.cuh``, and
:func:`genjax_torch.ops.fused_step.build` compiles
``_build/libfused_step_gen_<sha256>.so`` from it at first use.
"""

from __future__ import annotations

import hashlib
import os
import tempfile
from typing import Callable

import torch

from genjax_torch.ops._build import BUILD_DIR
from genjax_torch.ops.fused_step import CudaModel

__all__ = ["MAX_PARAMS", "model_source", "cuda_model", "header_path"]

#: ``kMaxParams`` of ``csrc/fused_step.cu``: the constants a launch carries.
MAX_PARAMS = 32

_aten = torch.ops.aten

_UNARY = {
    _aten.exp.default: "expf({})",
    _aten.expm1.default: "expm1f({})",
    _aten.log.default: "logf({})",
    _aten.log1p.default: "log1pf({})",
    _aten.sqrt.default: "sqrtf({})",
    _aten.rsqrt.default: "1.0f / sqrtf({})",
    _aten.abs.default: "fabsf({})",
    _aten.sin.default: "sinf({})",
    _aten.cos.default: "cosf({})",
    _aten.tanh.default: "tanhf({})",
    _aten.sigmoid.default: "1.0f / (1.0f + expf(-{}))",
    _aten.neg.default: "-{}",
    _aten.reciprocal.default: "1.0f / {}",
}
_BINARY = {
    _aten.mul.Tensor: "{} * {}", _aten.mul.Scalar: "{} * {}",
    _aten.div.Tensor: "{} / {}", _aten.div.Scalar: "{} / {}",
    _aten.minimum.default: "fm_min({}, {})",
    _aten.maximum.default: "fm_max({}, {})",
    _aten.clamp_min.default: "fm_max({}, {})",
    _aten.clamp_min.Tensor: "fm_max({}, {})",
    _aten.clamp_max.default: "fm_min({}, {})",
    _aten.clamp_max.Tensor: "fm_min({}, {})",
    _aten.pow.Tensor_Tensor: "powf({}, {})",
    _aten.pow.Scalar: "powf({}, {})",
}
_COMPARE = {}
for _name, _sym in (("gt", ">"), ("ge", ">="), ("lt", "<"), ("le", "<="),
                    ("eq", "=="), ("ne", "!=")):
    for _overload in ("Tensor", "Scalar"):
        _COMPARE[getattr(getattr(_aten, _name), _overload)] = _sym
# a + alpha b and a - alpha b; rsub is other - alpha self.
_ADD = {_aten.add.Tensor: "+", _aten.add.Scalar: "+",
        _aten.sub.Tensor: "-", _aten.sub.Scalar: "-"}
_RSUB = (_aten.rsub.Scalar, _aten.rsub.Tensor)
_CLAMP = (_aten.clamp.default, _aten.clamp.Tensor)
_WHERE = (_aten.where.self, _aten.where.ScalarSelf, _aten.where.ScalarOther,
          _aten.where.Scalar)
_SAME = (_aten.clone.default, _aten.alias.default, _aten.detach.default,
         _aten.lift_fresh_copy.default)
#: An integer exponent up to this size becomes products (torch's CPU pow
#: takes products for 2 and 3, and the C library's powf is within an ulp
#: of them); a larger one stays a literal of powf.
_MAX_PRODUCTS = 8

_HEADER = """\
// Generated by genjax_torch/ops/fused_model.py from the torch form of a
// scalar-state model, for the fused filter step (csrc/fused_step.cu):
// p[0..{n_prop}) are propagate's constants and p[{n_prop}..{n_all})
// loglik's, in graph order.

#pragma once

#include <math.h>

namespace fused_model {{

constexpr int kParams = {n_all};

// max / min that keep a NaN of either operand, as torch's.
__device__ __forceinline__ float fm_max(float a, float b) {{
  return (a != a || a > b) ? a : b;
}}
__device__ __forceinline__ float fm_min(float a, float b) {{
  return (a != a || a < b) ? a : b;
}}

__device__ __forceinline__ float propagate(float x, float eps,
                                           const float* p) {{
{prop}
}}

__device__ __forceinline__ float loglik(float x, float y, const float* p) {{
{ll}
}}

}}  // namespace fused_model
"""


def _describe(fn: Callable) -> str:
    code = getattr(fn, "__code__", None)
    where = f" ({code.co_filename}:{code.co_firstlineno})" if code else ""
    return f"{getattr(fn, '__qualname__', repr(fn))}{where}"


class _Emitter:
    """C lines for one traced callable; constants go to ``params``."""

    def __init__(self, fn: Callable, role: str, names: tuple[str, str],
                 params: list):
        self.fn, self.role, self.params = fn, role, params
        self.names = names
        self.lines: list[str] = []
        self.value: dict = {}     # node -> (C expression, is_bool)

    def refuse(self, what: str):
        raise ValueError(f"fused_model: {self.role} {_describe(self.fn)}: "
                         f"{what}; the fused step's CUDA form takes "
                         f"elementwise f32 ops only")

    def const(self, v) -> str:
        self.params.append(float(torch.tensor(v, dtype=torch.float32)))
        return f"p[{len(self.params) - 1}]"

    def arg(self, a, op) -> str:
        if isinstance(a, torch.fx.Node):
            return self.value[a][0]
        if isinstance(a, (bool, complex)) or not isinstance(a, (int, float)):
            self.refuse(f"{op} with the argument {a!r}")
        return self.const(a)

    def define(self, node, expr: str, is_bool: bool = False):
        name = f"v{len(self.value)}"
        ctype = "bool" if is_bool else "float"
        self.lines.append(f"  const {ctype} {name} = {expr};")
        self.value[node] = (name, is_bool)

    def check_value(self, node, op):
        """One element, bool from a comparison (or a copy of one) and f32
        from any other op."""
        val = node.meta.get("val")
        want = ((torch.bool, torch.float32) if op in _SAME
                else (torch.bool,) if op in _COMPARE else (torch.float32,))
        if isinstance(val, torch.Tensor) and (val.numel() != 1
                                              or val.dtype not in want):
            self.refuse(f"{op} gives a {val.dtype} value of shape "
                        f"{tuple(val.shape)}, not one "
                        f"{'bool' if op in _COMPARE else 'f32'} element")

    def power(self, base: str, e) -> str:
        if isinstance(e, int) and not isinstance(e, bool) \
                and abs(e) <= _MAX_PRODUCTS:
            if e == 0:
                return "1.0f"
            prod = " * ".join([base] * abs(e))
            return prod if e > 0 else f"1.0f / ({prod})"
        if isinstance(e, int) and not isinstance(e, bool):
            return f"powf({base}, {float(e)!r}f)"
        return f"powf({base}, {self.arg(e, 'pow')})"

    def node(self, node, gm):
        if node.op == "placeholder":
            self.value[node] = (self.names[len(self.value)], False)
            return
        if node.op == "get_attr":
            t = getattr(gm, node.target)
            if not isinstance(t, torch.Tensor) or t.numel() != 1 \
                    or t.is_complex():
                self.refuse(f"a closed-over tensor of shape "
                            f"{tuple(getattr(t, 'shape', ()))}")
            self.value[node] = (self.const(t.item()), False)
            return
        if node.op == "output":
            out = node.args[0]
            if isinstance(out, (list, tuple)):
                if len(out) != 1:
                    self.refuse("it returns more than one value")
                out = out[0]
            if not isinstance(out, torch.fx.Node) or self.value[out][1]:
                self.refuse("it does not return one f32 tensor")
            self.lines.append(f"  return {self.value[out][0]};")
            return
        if node.op != "call_function":
            self.refuse(f"the graph node {node.op} {node.target}")
        op, a, kw = node.target, node.args, dict(node.kwargs)
        self.check_value(node, op)
        if op in _SAME:
            self.value[node] = self.value[a[0]]
        elif op == _aten._to_copy.default:
            kw.pop("device", None), kw.pop("layout", None)
            kw.pop("pin_memory", None)
            dtype = kw.pop("dtype", None)
            if dtype not in (None, torch.float32) or kw:
                self.refuse(f"{op} to {dtype} {kw or ''}".rstrip())
            src, is_bool = self.value[a[0]]
            if is_bool:
                self.define(node, f"{src} ? 1.0f : 0.0f")
            else:
                self.value[node] = (src, False)
        elif op == _aten.scalar_tensor.default:
            if kw.get("dtype", torch.float32) != torch.float32:
                self.refuse(f"{op} of {kw.get('dtype')}")
            self.value[node] = (self.const(a[0]), False)
        elif op in _UNARY and len(a) == 1 and not kw:
            self.define(node, _UNARY[op].format(self.arg(a[0], op)))
        elif op in _BINARY and len(a) == 2 and not kw:
            self.define(node, _BINARY[op].format(self.arg(a[0], op),
                                                 self.arg(a[1], op)))
        elif op in _ADD and len(a) == 2 and set(kw) <= {"alpha"}:
            lhs, rhs = self.arg(a[0], op), self.arg(a[1], op)
            if kw.get("alpha", 1) != 1:
                rhs = f"{self.arg(kw['alpha'], op)} * {rhs}"
            self.define(node, f"{lhs} {_ADD[op]} {rhs}")
        elif op in _RSUB and len(a) == 2 and set(kw) <= {"alpha"}:
            rhs = self.arg(a[0], op)
            if kw.get("alpha", 1) != 1:
                rhs = f"{self.arg(kw['alpha'], op)} * {rhs}"
            self.define(node, f"{self.arg(a[1], op)} - {rhs}")
        elif op == _aten.pow.Tensor_Scalar and len(a) == 2 and not kw:
            self.define(node, self.power(self.arg(a[0], op), a[1]))
        elif op in _CLAMP and not kw and 1 <= len(a) <= 3:
            expr = self.arg(a[0], op)
            lo = a[1] if len(a) > 1 else None
            hi = a[2] if len(a) > 2 else None
            if lo is not None:
                expr = f"fm_max({expr}, {self.arg(lo, op)})"
            if hi is not None:
                expr = f"fm_min({expr}, {self.arg(hi, op)})"
            self.define(node, expr)
        elif op in _WHERE and len(a) == 3 and not kw:
            cond = self.value.get(a[0]) if isinstance(a[0], torch.fx.Node) \
                else None
            if cond is None or not cond[1]:
                self.refuse(f"{op} on a condition that is not a comparison")
            self.define(node, f"{cond[0]} ? {self.arg(a[1], op)} : "
                              f"{self.arg(a[2], op)}")
        elif op in _COMPARE and len(a) == 2 and not kw:
            self.define(node, f"{self.arg(a[0], op)} {_COMPARE[op]} "
                              f"{self.arg(a[1], op)}", is_bool=True)
        else:
            self.refuse(f"the op {op} is not among the elementwise ops it "
                        f"takes")


def _trace(fn: Callable, role: str, device) -> torch.fx.GraphModule:
    from torch.fx.experimental.proxy_tensor import make_fx

    one = torch.zeros(1, dtype=torch.float32, device=device)
    try:
        return make_fx(fn)(one, one.clone())
    except Exception as err:  # noqa: BLE001 - re-raised with the callable
        if "_local_scalar_dense" in str(err) or "data-dependent" in str(err):
            raise ValueError(
                f"fused_model: {role} {_describe(fn)}: a Python branch or "
                f"read of a tensor value (aten._local_scalar_dense); the "
                f"fused step's CUDA form takes elementwise f32 ops only"
            ) from err
        raise ValueError(f"fused_model: {role} {_describe(fn)} could not be "
                         f"traced: {err}") from err


def model_source(propagate: Callable, loglik: Callable, device="cpu"
                 ) -> tuple[str, tuple[float, ...]]:
    """The CUDA header of the model ``propagate(x, eps)`` /
    ``loglik(x_new, obs)`` and its constants as they are now, in the
    order ``p[]`` reads them, traced on ``device``. Raises
    ``ValueError`` on an op the header cannot take or more than
    :data:`MAX_PARAMS` constants."""
    params: list[float] = []
    bodies = []
    for fn, role, names in ((propagate, "propagate", ("x", "eps")),
                            (loglik, "loglik", ("x", "y"))):
        gm = _trace(fn, role, device)
        em = _Emitter(fn, role, names, params)
        for node in gm.graph.nodes:
            em.node(node, gm)
        bodies.append((len(params), "\n".join(em.lines)))
    if len(params) > MAX_PARAMS:
        raise ValueError(f"fused_model: the model has {len(params)} float "
                         f"constants; a launch carries at most {MAX_PARAMS}")
    source = _HEADER.format(n_prop=bodies[0][0], n_all=len(params),
                            prop=bodies[0][1], ll=bodies[1][1])
    return source, tuple(params)


def header_path(model: str) -> str:
    """Where the generated model ``gen_<sha>`` keeps its header."""
    return os.path.join(BUILD_DIR, "models", f"{model[len('gen_'):]}.cuh")


def cuda_model(propagate: Callable, loglik: Callable, device="cpu"
               ) -> CudaModel:
    """The model's CUDA form for :func:`~genjax_torch.ops.fused_step.
    fused_step`, traced on ``device``: ``CudaModel("gen_<sha256 of
    source>", params)``, ``params`` the constants' values now, its
    header written to ``_build/models/`` if it is not there yet (through
    a temporary file and ``os.replace``, since processes may generate the
    same model at once)."""
    source, params = model_source(propagate, loglik, device)
    name = "gen_" + hashlib.sha256(source.encode()).hexdigest()
    path = header_path(name)
    if not os.path.exists(path):
        os.makedirs(os.path.dirname(path), exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".cuh", dir=os.path.dirname(path))
        with os.fdopen(fd, "w") as f:
            f.write(source)
        os.replace(tmp, path)
    return CudaModel(name, params)

