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
   mixes with them) into a flat graph of aten ops (a Python loop over a
   fixed count is unrolled there);
2. each op becomes one line of C. A value is an f32, a bool or an int32,
   as torch's type promotion makes it; a mixed operand is converted as
   torch converts it. The ops are those the TPU kernel's Mosaic lowering
   takes that have a torch form:

   - f32: arithmetic, ``pow`` (an integer exponent as products, any other
     through ``powf``), the C math functions (``exp``, ``exp2``, ``log``,
     ``log2``, ``log10``, ``log1p``, ``sqrt``, ``rsqrt``, ``sin``, ``cos``,
     ``tan``, ``tanh``, ``erfinv``), rounding (``floor``, ``ceil``,
     ``round`` half to even and to ``decimals``, ``trunc``, ``frac``),
     ``sign``, ``copysign``, ``nextafter``, ``hypot``, ``fmod``,
     ``remainder``, ``floor_divide``, ``fmax`` / ``fmin``, ``xlogy``,
     ``xlog1py``, ``entr``, ``logaddexp(2)``, ``ldexp`` (int32
     exponent), ``lerp``, ``heaviside``, ``sigmoid``, ``logit``, ``sinc``,
     ``deg2rad`` / ``rad2deg`` and the activations ``relu``, ``hardtanh``
     (``relu6``), ``leaky_relu``, ``softplus``,
     ``log_sigmoid``, ``silu``, ``mish``, ``gelu`` (tanh form),
     ``hardsigmoid``, ``hardswish``; minimum / maximum / clamp
     (NaN-propagating, as torch's) and ``where``;
   - bool: comparisons, ``isnan`` / ``isinf`` / ``isposinf`` /
     ``isneginf`` / ``signbit`` (and ``isfinite``, which torch writes
     with them), ``& | ^ ~`` and ``logical_*``;
   - int32: casts from and to f32 and bool (f32 -> int32 as torch's cast
     on the device the header is built for, where C leaves NaN and
     out-of-range values undefined: saturating, NaN to 0, on the card as
     its CUDA cast and the TPU kernel's; ``INT32_MIN`` on the host as its
     CPU cast), the bit casts ``view(torch.int32)`` /
     ``view(torch.float32)``, ``+ - *`` (in ``uint32_t``, so that they
     wrap as torch's), ``neg``, ``abs``, ``sign``, ``& | ^ ~``, shifts
     (torch's rule outside [0, 31]), comparisons, min / max / clamp;
   - constant-creating ops (``zeros_like``, ``ones_like``, ``full_like``,
     ``full``, ``scalar_tensor``) and copies.

   Any other op raises ``ValueError`` naming it and the callable: a
   reduction, indexing, a second random draw, a Python branch on a
   tensor value, another dtype (f64, f16, int64, ...), integer ``//``
   and ``%`` (torch raises on a zero divisor, which a kernel cannot),
   and the special functions the TPU lowering lacks too (``erf``,
   ``lgamma``, ``digamma``, ``atan``, the hyperbolic functions, Bessel
   and zeta). ``expm1`` is taken although Mosaic lowers none. Nothing
   falls back;
3. every float constant of the graph (Python numbers, closed-over 0-d
   tensors read as f32, the value of a constant-creating op) is hoisted
   into the launch's ``p[]`` in graph order, propagate's first; only an
   integer ``pow`` exponent and the int32 and bool constants (masks,
   shift counts, flags: an f32 slot cannot carry every int32) stay in
   the text. So the source depends on the model's structure alone: a
   model whose float constants change reuses its library, and only
   ``params`` change. The constants are read when the model is
   generated: a callable that reads them from a global, a closure, a
   list or a 0-d tensor changed in place gives the new values on the
   next generation (the fused filter generates once a run). A model may
   have any number of them, as the TPU kernel may: the launch reads them
   from a buffer on the device. Equal constants are not merged, so a
   Python loop unrolled over 1100 steps with a constant each carries
   1100;

The header uses C math functions (``expf``, ``log1pf``, ...) and IEEE
``/`` only, so the same text compiles on the host (the CPU tests build it
with ``g++``); a helper (``fm_erfinv``, the int32 casts, ...) is written
into a header only where the model uses it. It goes to
``_build/models/<sha256 of source>.cuh``, and
:func:`genjax_torch.ops.fused_step.build` compiles
``_build/libfused_step_gen_<sha256>.so`` from it at first use.
"""

from __future__ import annotations

import hashlib
import operator
import os
import tempfile
from typing import Callable

import numpy as np
import torch

from genjax_torch.ops._build import BUILD_DIR
from genjax_torch.ops.fused_step import CudaModel

__all__ = ["model_source", "cuda_model", "header_path"]

_aten = torch.ops.aten
_F32, _BOOL, _I32 = torch.float32, torch.bool, torch.int32
_CTYPE = {_F32: "float", _BOOL: "bool", _I32: "int32_t"}


def _f32_literal(v: float) -> str:
    """An op's own f32 constant (pi / 180, ...) as C text that parses to
    the same float."""
    return f"{np.float32(v)!r}"[len("np.float32("):-1] + "f"


# f32 -> f32; "{0}" is the operand (converted to f32).
_UNARY = {
    _aten.exp.default: "expf({})",
    _aten.expm1.default: "expm1f({})",
    _aten.log.default: "logf({})",
    _aten.log1p.default: "log1pf({})",
    _aten.sqrt.default: "sqrtf({})",
    _aten.rsqrt.default: "1.0f / sqrtf({})",
    _aten.sin.default: "sinf({})",
    _aten.cos.default: "cosf({})",
    _aten.tanh.default: "tanhf({})",
    _aten.sigmoid.default: "1.0f / (1.0f + expf(-{}))",
    _aten.reciprocal.default: "1.0f / {}",
    _aten.exp2.default: "exp2f({})",
    _aten.log2.default: "log2f({})",
    _aten.log10.default: "log10f({})",
    _aten.tan.default: "tanf({})",
    _aten.erfinv.default: "fm_erfinv({})",
    _aten.floor.default: "floorf({})",
    _aten.ceil.default: "ceilf({})",
    # torch.round rounds half to even: rintf in the default rounding mode.
    _aten.round.default: "rintf({})",
    _aten.trunc.default: "truncf({})",
    _aten.frac.default: "{0} - truncf({0})",
    # relu keeps -0 and NaN, as torch's.
    _aten.relu.default: "{0} < 0.0f ? 0.0f : {0}",
    _aten.silu.default: "{0} / (1.0f + expf(-{0}))",
    _aten.mish.default: "{0} * tanhf(log1pf(expf({0})))",
    _aten.hardsigmoid.default:
        "fm_min(fm_max({0} + 3.0f, 0.0f), 6.0f) / 6.0f",
    _aten.hardswish.default:
        "{0} * fm_min(fm_max({0} + 3.0f, 0.0f), 6.0f) / 6.0f",
    _aten.log_sigmoid_forward.default:
        "fm_min(0.0f, {0}) - log1pf(expf(-fabsf({0})))",
    _aten.special_entr.default:
        "{0} != {0} ? {0} : {0} > 0.0f ? -{0} * logf({0}) : "
        "{0} == 0.0f ? 0.0f : -INFINITY",
    _aten.sinc.default:
        f"{{0}} == 0.0f ? 1.0f : sinf({_f32_literal(np.pi)} * {{0}}) / "
        f"({_f32_literal(np.pi)} * {{0}})",
    _aten.deg2rad.default: f"{{}} * {_f32_literal(np.pi / 180)}",
    _aten.rad2deg.default: f"{{}} * {_f32_literal(180 / np.pi)}",
}
# f32 -> bool.
_PREDICATE = {
    _aten.isnan.default: "{0} != {0}",
    _aten.isinf.default: "fabsf({}) == INFINITY",
    _aten.isposinf.default: "{} == INFINITY",
    _aten.isneginf.default: "{} == -INFINITY",
    _aten.signbit.default: "signbit({})",
}
# (f32, f32) -> f32.
_BINARY = {
    _aten.div.Tensor: "{} / {}", _aten.div.Scalar: "{} / {}",
    _aten.pow.Tensor_Tensor: "powf({}, {})",
    _aten.pow.Scalar: "powf({}, {})",
    _aten.nextafter.default: "nextafterf({}, {})",
    _aten.hypot.default: "hypotf({}, {})",
    _aten.copysign.Tensor: "copysignf({}, {})",
    _aten.copysign.Scalar: "copysignf({}, {})",
    _aten.fmax.default: "fmaxf({}, {})",
    _aten.fmin.default: "fminf({}, {})",
    _aten.xlogy.Tensor: "fm_xlogy({}, {})",
    _aten.xlogy.Scalar_Self: "fm_xlogy({}, {})",
    _aten.xlogy.Scalar_Other: "fm_xlogy({}, {})",
    _aten.special_xlog1py.default: "fm_xlog1py({}, {})",
    _aten.logaddexp.default: "fm_logaddexp({}, {})",
    _aten.logaddexp2.default: "fm_logaddexp2({}, {})",
    _aten.heaviside.default:
        "{0} == 0.0f ? {1} : ({0} > 0.0f ? 1.0f : 0.0f)",
}
# (f32, f32) -> f32 division that torch refuses on integers with a zero
# divisor: taken on f32 only.
_FDIV = {
    _aten.fmod.Tensor: "fmodf({}, {})", _aten.fmod.Scalar: "fmodf({}, {})",
    _aten.remainder.Tensor: "fm_remainder({}, {})",
    _aten.remainder.Scalar: "fm_remainder({}, {})",
    _aten.floor_divide.default: "fm_floordiv({}, {})",
    _aten.floor_divide.Scalar: "fm_floordiv({}, {})",
}
_DIV_MODE = (_aten.div.Tensor_mode, _aten.div.Scalar_mode)
_COMPARE = {}
for _name, _sym in (("gt", ">"), ("ge", ">="), ("lt", "<"), ("le", "<="),
                    ("eq", "=="), ("ne", "!=")):
    for _overload in ("Tensor", "Scalar"):
        _COMPARE[getattr(getattr(_aten, _name), _overload)] = _sym
# a + alpha b and a - alpha b; rsub is other - alpha self.
_ADD = {_aten.add.Tensor: "+", _aten.add.Scalar: "+",
        _aten.sub.Tensor: "-", _aten.sub.Scalar: "-"}
_RSUB = (_aten.rsub.Scalar, _aten.rsub.Tensor)
_MUL = (_aten.mul.Tensor, _aten.mul.Scalar)
_MINMAX = {_aten.minimum.default: "min", _aten.maximum.default: "max",
           _aten.clamp_min.default: "max", _aten.clamp_min.Tensor: "max",
           _aten.clamp_max.default: "min", _aten.clamp_max.Tensor: "min"}
_CLAMP = (_aten.clamp.default, _aten.clamp.Tensor)
_WHERE = (_aten.where.self, _aten.where.ScalarSelf, _aten.where.ScalarOther,
          _aten.where.Scalar)
_SAME = (_aten.clone.default, _aten.alias.default, _aten.detach.default,
         _aten.lift_fresh_copy.default)
_BITWISE = {}
for _name, _sym in (("and", "&"), ("or", "|"), ("xor", "^")):
    for _overload in ("Tensor", "Scalar"):
        _BITWISE[getattr(getattr(_aten, f"bitwise_{_name}"), _overload)] = _sym
_LOGICAL = {_aten.logical_and.default: "&&", _aten.logical_or.default: "||",
            _aten.logical_xor.default: "!="}
_SHIFT = {_aten.__lshift__.Scalar: "<<", _aten.__lshift__.Tensor: "<<",
          _aten.__rshift__.Scalar: ">>", _aten.__rshift__.Tensor: ">>",
          _aten.bitwise_left_shift.Tensor: "<<",
          _aten.bitwise_left_shift.Tensor_Scalar: "<<",
          _aten.bitwise_right_shift.Tensor: ">>",
          _aten.bitwise_right_shift.Tensor_Scalar: ">>"}
# Ops that make a constant, and the value they fill with (None: their
# last argument, scalar_tensor's first).
_FILL = {_aten.zeros_like.default: 0, _aten.ones_like.default: 1,
         _aten.full_like.default: None, _aten.full.default: None,
         _aten.scalar_tensor.default: None}
#: An integer exponent up to this size becomes products (torch's CPU pow
#: takes products for 2 and 3, and the C library's powf is within an ulp
#: of them); a larger one stays a literal of powf.
_MAX_PRODUCTS = 8

#: Helpers written into a header only where the model uses them, in this
#: order: (name, C text).
_HELPERS = (
    ("<stdint.h>", "#include <stdint.h>\n"),
    ("<string.h>", "#include <string.h>\n"),
    ("fm_f2i", """
// f32 -> int32 as torch's cast gives it on the device the header is built
// for, where C leaves NaN and values out of range undefined: on the card
// its CUDA cast's cvt.rzi (saturating, NaN -> 0); on the host its CPU
// cast's INT32_MIN.
__device__ __forceinline__ int32_t fm_f2i(float a) {
#ifdef __CUDA_ARCH__
  return __float2int_rz(a);
#else
  return (a >= -2147483648.0f && a < 2147483648.0f) ? (int32_t)a : INT32_MIN;
#endif
}
"""),
    ("fm_as_int", """
// The bits of an f32 as an int32 (torch's view(torch.int32)).
__device__ __forceinline__ int32_t fm_as_int(float a) {
  int32_t r;
  memcpy(&r, &a, sizeof r);
  return r;
}
"""),
    ("fm_as_float", """
// The bits of an int32 as an f32 (torch's view(torch.float32)).
__device__ __forceinline__ float fm_as_float(int32_t a) {
  float r;
  memcpy(&r, &a, sizeof r);
  return r;
}
"""),
    ("fm_shl", """
// Shifts as torch's: a left shift by an amount outside [0, 31] gives 0,
// a right shift the sign.
__device__ __forceinline__ int32_t fm_shl(int32_t a, int32_t s) {
  return (s < 0 || s > 31) ? 0 : (int32_t)((uint32_t)a << s);
}
"""),
    ("fm_shr", """
__device__ __forceinline__ int32_t fm_shr(int32_t a, int32_t s) {
  return a >> ((s < 0 || s > 31) ? 31 : s);
}
"""),
    ("fm_remainder", """
// The remainder with the divisor's sign (ATen's formula).
__device__ __forceinline__ float fm_remainder(float a, float b) {
  const float m = fmodf(a, b);
  return (m != 0.0f && ((b < 0.0f) != (m < 0.0f))) ? m + b : m;
}
"""),
    ("fm_floordiv", """
// Floor division of floats (ATen's div_floor).
__device__ __forceinline__ float fm_floordiv(float a, float b) {
  if (b == 0.0f) return a / b;
  const float m = fmodf(a, b);
  float d = (a - m) / b;
  if (m != 0.0f && ((b < 0.0f) != (m < 0.0f))) d -= 1.0f;
  if (d == 0.0f) return copysignf(0.0f, a / b);
  float f = floorf(d);
  if (d - f > 0.5f) f += 1.0f;
  return f;
}
"""),
    ("fm_xlogy", """
// x log y, 0 where x is 0 unless y is NaN (torch's).
__device__ __forceinline__ float fm_xlogy(float x, float y) {
  if (y != y) return y;
  return x == 0.0f ? 0.0f : x * logf(y);
}
"""),
    ("fm_xlog1py", """
__device__ __forceinline__ float fm_xlog1py(float x, float y) {
  if (y != y) return y;
  return x == 0.0f ? 0.0f : x * log1pf(y);
}
"""),
    ("fm_logaddexp", """
// log(e^a + e^b), stable (ATen's form).
__device__ __forceinline__ float fm_logaddexp(float a, float b) {
  if (fabsf(a) == INFINITY && a == b) return a;
  const float m = a < b ? b : a;
  return m + log1pf(expf(-fabsf(a - b)));
}
"""),
    ("fm_logaddexp2", f"""
// log2(2^a + 2^b), stable (ATen's form).
__device__ __forceinline__ float fm_logaddexp2(float a, float b) {{
  if (fabsf(a) == INFINITY && a == b) return a;
  const float m = a < b ? b : a;
  return m + log1pf(exp2f(-fabsf(a - b))) * {_f32_literal(1 / np.log(2))};
}}
"""),
    ("fm_erfinv", """
// The inverse error function: ATen's calc_erfinv (a rational first guess,
// then two Newton steps) in double, rounded once to f32, as near the true
// value as torch's (glibc has no erfinvf).
__device__ __forceinline__ float fm_erfinv(float yf) {
  const double y = yf, ya = fabs(y);
  if (ya > 1.0) return NAN;
  if (ya == 1.0) return copysignf(INFINITY, yf);
  double x;
  if (ya <= 0.7) {
    const double z = y * y;
    const double num = ((-0.140543331 * z + 0.914624893) * z
                        - 1.645349621) * z + 0.886226899;
    const double dem = (((0.012229801 * z - 0.329097515) * z
                         + 1.442710462) * z - 2.118377725) * z + 1.0;
    x = y * num / dem;
  } else {
    const double z = sqrt(-log((1.0 - ya) / 2.0));
    const double num = ((1.641345311 * z + 3.429567803) * z
                        - 1.624906493) * z - 1.970840454;
    const double dem = (1.6370678 * z + 3.5438892) * z + 1.0;
    x = copysign(num, y) / dem;
  }
  x = x - (erf(x) - y) / (1.1283791670955126 * exp(-x * x));
  x = x - (erf(x) - y) / (1.1283791670955126 * exp(-x * x));
  return (float)x;
}
"""),
)
#: The includes a helper needs.
_NEEDS = {"fm_f2i": ("<stdint.h>",), "fm_shl": ("<stdint.h>",),
          "fm_shr": ("<stdint.h>",),
          "fm_as_int": ("<stdint.h>", "<string.h>"),
          "fm_as_float": ("<stdint.h>", "<string.h>")}

_HEADER = """\
// Generated by genjax_torch/ops/fused_model.py from the torch form of a
// scalar-state model, for the fused filter step (csrc/fused_step.cu):
// p[0..{n_prop}) are propagate's constants and p[{n_prop}..{n_all})
// loglik's, in graph order.

#pragma once

#include <math.h>
{includes}
namespace fused_model {{

constexpr int kParams = {n_all};

// max / min that keep a NaN of either operand, as torch's.
__device__ __forceinline__ float fm_max(float a, float b) {{
  return (a != a || a > b) ? a : b;
}}
__device__ __forceinline__ float fm_min(float a, float b) {{
  return (a != a || a < b) ? a : b;
}}
{helpers}
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
    """C lines for one traced callable; float constants go to ``params``,
    the helpers it calls to ``helpers``."""

    def __init__(self, fn: Callable, role: str, names: tuple[str, str],
                 params: list, helpers: set):
        self.fn, self.role, self.params = fn, role, params
        self.names, self.helpers = names, helpers
        self.lines: list[str] = []
        self.value: dict = {}     # node -> (C expression, dtype)

    def refuse(self, what: str):
        raise ValueError(f"fused_model: {self.role} {_describe(self.fn)}: "
                         f"{what}; the fused step's CUDA form takes "
                         f"elementwise f32, bool and int32 ops only")

    def use(self, helper: str):
        self.helpers.add(helper)
        self.helpers.update(_NEEDS.get(helper, ()))

    def const(self, v, dtype=_F32) -> str:
        """The constant ``v`` as a value of ``dtype``: an f32 one in
        ``p[]``, an int32 or bool one as a literal."""
        if dtype == _F32:
            self.params.append(float(torch.tensor(v, dtype=torch.float32)))
            return f"p[{len(self.params) - 1}]"
        if dtype == _BOOL:
            return "true" if v else "false"
        if isinstance(v, float) and not v.is_integer() \
                or not -2 ** 31 <= v < 2 ** 31:
            self.refuse(f"the constant {v!r} is not an int32")
        if int(v) == -2 ** 31:
            self.use("<stdint.h>")
            return "INT32_MIN"
        return str(int(v))

    def convert(self, expr: str, src, dst) -> str:
        """``expr`` of ``src`` as ``dst``, as torch converts."""
        if src == dst:
            return expr
        if dst == _F32:
            return (f"({expr} ? 1.0f : 0.0f)" if src == _BOOL
                    else f"(float){expr}")
        if dst == _BOOL:
            return f"({expr} != {'0.0f' if src == _F32 else '0'})"
        if src == _BOOL:
            return f"({expr} ? 1 : 0)"
        self.use("fm_f2i")
        return f"fm_f2i({expr})"

    def arg(self, a, op, dtype=_F32) -> str:
        if isinstance(a, torch.fx.Node):
            expr, src = self.value[a]
            return self.convert(expr, src, dtype)
        if not isinstance(a, (int, float)):
            self.refuse(f"{op} with the argument {a!r}")
        return self.const(a, dtype)

    def define(self, node, expr: str, dtype=_F32):
        name = f"v{len(self.value)}"
        if dtype == _I32:
            self.use("<stdint.h>")
        self.lines.append(f"  const {_CTYPE[dtype]} {name} = {expr};")
        self.value[node] = (name, dtype)

    def dtype_of(self, node, op):
        """The node's one-element value type: f32, bool or int32."""
        val = node.meta.get("val")
        if op == _aten.log_sigmoid_forward.default:
            val = val[0] if isinstance(val, (tuple, list)) else val
        if not isinstance(val, torch.Tensor):
            self.refuse(f"{op} gives no tensor")
        if val.numel() != 1 or val.dtype not in _CTYPE:
            self.refuse(f"{op} gives a {val.dtype} value of shape "
                        f"{tuple(val.shape)}, not one f32, bool or int32 "
                        f"element")
        return val.dtype

    def power(self, base: str, e, dtype=_F32) -> str:
        if isinstance(e, int) and not isinstance(e, bool) \
                and abs(e) <= _MAX_PRODUCTS:
            if dtype == _I32:
                if e < 0:
                    self.refuse("an int32 to a negative power")
                if e == 0:
                    return "1"
                return ("(int32_t)(" + " * ".join(["(uint32_t)" + base] * e)
                        + ")")
            if e == 0:
                return "1.0f"
            prod = " * ".join([base] * abs(e))
            return prod if e > 0 else f"1.0f / ({prod})"
        if dtype != _F32:
            self.refuse(f"an int32 to the power {e!r}")
        if isinstance(e, int) and not isinstance(e, bool):
            return f"powf({base}, {float(e)!r}f)"
        return f"powf({base}, {self.arg(e, 'pow')})"

    def minmax(self, kind: str, a: str, b: str, dtype) -> str:
        if dtype == _F32:
            return f"fm_{kind}({a}, {b})"
        if dtype == _BOOL:
            return f"({a} {'&&' if kind == 'min' else '||'} {b})"
        return f"({a} {'<' if kind == 'min' else '>'} {b} ? {a} : {b})"

    def int_arith(self, sym: str, a: str, b: str) -> str:
        """``a sym b`` of int32s as torch's, wrapping."""
        self.use("<stdint.h>")
        return f"(int32_t)((uint32_t){a} {sym} (uint32_t){b})"

    def node(self, node, gm):
        if node.op == "placeholder":
            self.value[node] = (self.names[len(self.value)], _F32)
            return
        if node.op == "get_attr":
            t = getattr(gm, node.target)
            if not isinstance(t, torch.Tensor) or t.numel() != 1 \
                    or t.is_complex():
                self.refuse(f"a closed-over tensor of shape "
                            f"{tuple(getattr(t, 'shape', ()))}")
            dtype = (_F32 if t.is_floating_point()
                     else _BOOL if t.dtype == torch.bool else _I32)
            self.value[node] = (self.const(t.item(), dtype), dtype)
            return
        if node.op == "output":
            out = node.args[0]
            if isinstance(out, (list, tuple)):
                if len(out) != 1:
                    self.refuse("it returns more than one value")
                out = out[0]
            if not isinstance(out, torch.fx.Node) \
                    or self.value[out][1] != _F32:
                self.refuse("it does not return one f32 tensor")
            self.lines.append(f"  return {self.value[out][0]};")
            return
        if node.op != "call_function":
            self.refuse(f"the graph node {node.op} {node.target}")
        op, a, kw = node.target, node.args, dict(node.kwargs)
        if op is operator.getitem:
            # log_sigmoid_forward's (output, buffer): the buffer is unused.
            if a[1] != 0 or a[0] not in self.value:
                if node.users:
                    self.refuse(f"an item of {a[0].target}")
                return
            self.value[node] = self.value[a[0]]
            return
        out = self.dtype_of(node, op)
        if op in _SAME:
            self.value[node] = self.value[a[0]]
        elif op == _aten._to_copy.default:
            kw.pop("device", None), kw.pop("layout", None)
            kw.pop("pin_memory", None)
            dtype = kw.pop("dtype", None)
            if dtype not in (None, *_CTYPE) or kw:
                self.refuse(f"{op} to {dtype} {kw or ''}".rstrip())
            src, src_type = self.value[a[0]]
            if src_type == out:
                self.value[node] = (src, out)
            elif src_type == _BOOL and out == _F32:
                self.define(node, f"{src} ? 1.0f : 0.0f")
            else:
                self.define(node, self.convert(src, src_type, out), out)
        elif op == _aten.view.dtype:
            src, src_type = self.value[a[0]]
            if src_type == out:
                self.value[node] = (src, out)
            elif {src_type, out} == {_F32, _I32}:
                helper = "fm_as_int" if out == _I32 else "fm_as_float"
                self.use(helper)
                self.define(node, f"{helper}({src})", out)
            else:
                self.refuse(f"{op} of a {src_type} value as {out}")
        elif op in _FILL:
            at = _FILL[op]
            v = (at if at is not None
                 else a[0] if op == _aten.scalar_tensor.default else a[-1])
            self.value[node] = (self.const(v, out), out)
        elif op in _UNARY and len(a) == 1 and not kw:
            self.use_helpers(_UNARY[op])
            self.define(node, _UNARY[op].format(self.arg(a[0], op)))
        elif op in _PREDICATE and len(a) == 1 and not kw:
            self.define(node, _PREDICATE[op].format(self.arg(a[0], op)),
                        _BOOL)
        elif op == _aten.neg.default and len(a) == 1 and not kw:
            x = self.arg(a[0], op, out)
            self.define(node, f"-{x}" if out == _F32
                        else f"(int32_t)(0u - (uint32_t){x})", out)
        elif op == _aten.abs.default and len(a) == 1 and not kw:
            x = self.arg(a[0], op, out)
            self.define(node, f"fabsf({x})" if out == _F32
                        else f"({x} < 0 ? (int32_t)(0u - (uint32_t){x}) "
                             f": {x})", out)
        elif op in (_aten.sign.default, _aten.sgn.default) and len(a) == 1:
            x = self.arg(a[0], op, out)
            # (0 < x) - (x < 0): NaN and -0 give +0, as torch's.
            self.define(node, f"(float)((0.0f < {x}) - ({x} < 0.0f))"
                        if out == _F32 else f"((0 < {x}) - ({x} < 0))", out)
        elif op in _BINARY and len(a) == 2 and not kw:
            if out != _F32:
                self.refuse(f"{op} of {out} values")
            self.use_helpers(_BINARY[op])
            self.define(node, _BINARY[op].format(self.arg(a[0], op),
                                                 self.arg(a[1], op)))
        elif op in _FDIV and len(a) == 2 and not kw:
            self.float_division(node, op, out)
            self.use_helpers(_FDIV[op])
            self.define(node, _FDIV[op].format(self.arg(a[0], op),
                                               self.arg(a[1], op)))
        elif op in _DIV_MODE and len(a) == 2 \
                and kw.get("rounding_mode") in ("floor", "trunc"):
            self.float_division(node, op, out)
            lhs, rhs = self.arg(a[0], op), self.arg(a[1], op)
            if kw["rounding_mode"] == "floor":
                self.use("fm_floordiv")
                self.define(node, f"fm_floordiv({lhs}, {rhs})")
            else:
                self.define(node, f"truncf({lhs} / {rhs})")
        elif op in _MUL and len(a) == 2 and not kw:
            lhs, rhs = self.arg(a[0], op, out), self.arg(a[1], op, out)
            self.define(node, f"{lhs} * {rhs}" if out == _F32
                        else f"({lhs} && {rhs})" if out == _BOOL
                        else self.int_arith("*", lhs, rhs), out)
        elif op in _MINMAX and len(a) == 2 and not kw:
            self.define(node, self.minmax(_MINMAX[op], self.arg(a[0], op, out),
                                          self.arg(a[1], op, out), out), out)
        elif op in _ADD and len(a) == 2 and set(kw) <= {"alpha"}:
            lhs, rhs = self.arg(a[0], op, out), self.arg(a[1], op, out)
            if out == _BOOL:
                if kw.get("alpha", 1) != 1 or _ADD[op] != "+":
                    self.refuse(f"{op} of bool values")
                self.define(node, f"({lhs} || {rhs})", out)
                return
            if kw.get("alpha", 1) != 1:
                alpha = self.arg(kw["alpha"], op, out)
                rhs = (f"{alpha} * {rhs}" if out == _F32
                       else self.int_arith("*", alpha, rhs))
            self.define(node, f"{lhs} {_ADD[op]} {rhs}" if out == _F32
                        else self.int_arith(_ADD[op], lhs, rhs), out)
        elif op in _RSUB and len(a) == 2 and set(kw) <= {"alpha"} \
                and out != _BOOL:
            rhs = self.arg(a[0], op, out)
            if kw.get("alpha", 1) != 1:
                alpha = self.arg(kw["alpha"], op, out)
                rhs = (f"{alpha} * {rhs}" if out == _F32
                       else self.int_arith("*", alpha, rhs))
            lhs = self.arg(a[1], op, out)
            self.define(node, f"{lhs} - {rhs}" if out == _F32
                        else self.int_arith("-", lhs, rhs), out)
        elif op == _aten.pow.Tensor_Scalar and len(a) == 2 and not kw:
            self.define(node, self.power(self.arg(a[0], op, out), a[1], out),
                        out)
        elif op in _CLAMP and not kw and 1 <= len(a) <= 3:
            if out == _BOOL:
                self.refuse(f"{op} of bool values")
            expr = self.arg(a[0], op, out)
            lo = a[1] if len(a) > 1 else None
            hi = a[2] if len(a) > 2 else None
            if lo is not None:
                expr = self.minmax("max", expr, self.arg(lo, op, out), out)
            if hi is not None:
                expr = self.minmax("min", expr, self.arg(hi, op, out), out)
            self.define(node, expr, out)
        elif op in _WHERE and len(a) == 3 and not kw:
            cond = self.value.get(a[0]) if isinstance(a[0], torch.fx.Node) \
                else None
            if cond is None or cond[1] != _BOOL:
                self.refuse(f"{op} on a condition that is not a bool value")
            self.define(node, f"{cond[0]} ? {self.arg(a[1], op, out)} : "
                              f"{self.arg(a[2], op, out)}", out)
        elif op in _COMPARE and len(a) == 2 and not kw:
            ct = self.compare_type(a)
            self.define(node, f"{self.arg(a[0], op, ct)} {_COMPARE[op]} "
                              f"{self.arg(a[1], op, ct)}", _BOOL)
        elif op in _BITWISE and len(a) == 2 and not kw and out != _F32:
            lhs, rhs = self.arg(a[0], op, out), self.arg(a[1], op, out)
            sym = _BITWISE[op]
            if out == _BOOL:
                sym = {"&": "&&", "|": "||", "^": "!="}[sym]
            self.define(node, f"({lhs} {sym} {rhs})", out)
        elif op == _aten.bitwise_not.default and out != _F32:
            x = self.arg(a[0], op, out)
            self.define(node, f"!{x}" if out == _BOOL else f"~{x}", out)
        elif op in _LOGICAL and len(a) == 2 and not kw and out == _BOOL:
            self.define(node, f"({self.arg(a[0], op, _BOOL)} {_LOGICAL[op]} "
                              f"{self.arg(a[1], op, _BOOL)})", _BOOL)
        elif op == _aten.logical_not.default and out == _BOOL:
            self.define(node, f"!{self.arg(a[0], op, _BOOL)}", _BOOL)
        elif op in _SHIFT and len(a) == 2 and not kw and out == _I32:
            self.shift(node, op, a)
        elif op == _aten.softplus.default and not kw and 1 <= len(a) <= 3:
            x = self.arg(a[0], op)
            beta = self.arg(a[1] if len(a) > 1 else 1.0, op)
            threshold = self.arg(a[2] if len(a) > 2 else 20.0, op)
            self.define(node, f"{x} * {beta} > {threshold} ? {x} : "
                              f"log1pf(expf({x} * {beta})) / {beta}")
        elif op == _aten.hardtanh.default and not kw and 1 <= len(a) <= 3:
            x = self.arg(a[0], op)
            lo = self.arg(a[1] if len(a) > 1 else -1.0, op)
            hi = self.arg(a[2] if len(a) > 2 else 1.0, op)
            # Keeps NaN, and x where it equals a bound (-0 at 0).
            self.define(node, f"{x} < {lo} ? {lo} : {x} > {hi} ? {hi} : {x}")
        elif op == _aten.ldexp.Tensor and len(a) == 2 and not kw \
                and self.value[a[1]][1] == _I32:
            # An int32 exponent scales as C's ldexpf, as torch's.
            self.define(node, f"ldexpf({self.arg(a[0], op)}, "
                              f"{self.value[a[1]][0]})")
        elif op == _aten.leaky_relu.default and not kw and 1 <= len(a) <= 2:
            x = self.arg(a[0], op)
            slope = self.arg(a[1] if len(a) > 1 else 0.01, op)
            self.define(node, f"{x} > 0.0f ? {x} : {x} * {slope}")
        elif op == _aten.gelu.default and len(a) == 1 \
                and kw.get("approximate", "none") == "tanh":
            x = self.arg(a[0], op)
            self.define(node, f"0.5f * {x} * (1.0f + tanhf("
                              f"{_f32_literal(np.sqrt(2 / np.pi))} * ({x} + "
                              f"{_f32_literal(0.044715)} * ({x} * {x} * {x}"
                              f"))))")
        elif op == _aten.logit.default and not kw and 1 <= len(a) <= 2:
            x = self.arg(a[0], op)
            if len(a) == 2 and a[1] is not None:
                lo = self.arg(a[1], op)
                self.define((node, "clamped"),
                            f"{x} < {lo} ? {lo} : {x} > 1.0f - {lo} ? "
                            f"1.0f - {lo} : {x}")
                x = self.value[(node, "clamped")][0]
            self.define(node, f"logf({x} / (1.0f - {x}))")
        elif op == _aten.lerp.Scalar and len(a) == 3 and not kw:
            s, e = self.arg(a[0], op), self.arg(a[1], op)
            w = self.arg(a[2], op)
            self.define(node, f"fabsf({w}) < 0.5f ? {s} + {w} * ({e} - {s}) "
                              f": {e} - ({e} - {s}) * (1.0f - {w})")
        elif op == _aten.round.decimals and len(a) == 1 \
                and set(kw) == {"decimals"}:
            # ATen's: rint(x * 10^k) / 10^k, or rint(x / 10^-k) * 10^-k
            # for k < 0, 10^|k| an f32 constant.
            x, k = self.arg(a[0], op), int(kw["decimals"])
            scale = self.arg(float(10 ** abs(k)), op)
            self.define(node, f"rintf({x} * {scale}) / {scale}" if k >= 0
                        else f"rintf({x} / {scale}) * {scale}")
        elif op == _aten.gelu.default:
            self.refuse(f"{op} with approximate='none' (through erf, which "
                        f"the TPU kernel does not lower either)")
        else:
            self.refuse(f"the op {op} is not among the elementwise ops it "
                        f"takes")

    def use_helpers(self, form: str):
        for name, _ in _HELPERS:
            if name.startswith("fm_") and name + "(" in form:
                self.use(name)

    def float_division(self, node, op, out):
        if out != _F32:
            self.refuse(f"{op} of integers (torch raises on a zero divisor, "
                        f"which the kernel cannot)")

    def compare_type(self, args):
        """The type two operands are compared in: f32 if either is, else
        int32 if either is, else bool (torch's promotion)."""
        types = [self.value[x][1] if isinstance(x, torch.fx.Node)
                 else _F32 if isinstance(x, float)
                 else _BOOL if isinstance(x, bool) else _I32 for x in args]
        return (_F32 if _F32 in types else _I32 if _I32 in types else _BOOL)

    def shift(self, node, op, args):
        x = self.arg(args[0], op, _I32)
        s = args[1]
        left = _SHIFT[op] == "<<"
        if not isinstance(s, torch.fx.Node) and 0 <= s <= 31 \
                and not isinstance(s, bool):
            self.define(node, f"(int32_t)((uint32_t){x} << {int(s)})" if left
                        else f"{x} >> {int(s)}", _I32)
            return
        helper = "fm_shl" if left else "fm_shr"
        self.use(helper)
        self.define(node, f"{helper}({x}, {self.arg(s, op, _I32)})", _I32)


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
                f"fused step's CUDA form takes elementwise f32, bool and "
                f"int32 ops only"
            ) from err
        raise ValueError(f"fused_model: {role} {_describe(fn)} could not be "
                         f"traced: {err}") from err


def model_source(propagate: Callable, loglik: Callable, device="cpu"
                 ) -> tuple[str, tuple[float, ...]]:
    """The CUDA header of the model ``propagate(x, eps)`` /
    ``loglik(x_new, obs)`` and its constants as they are now, in the
    order ``p[]`` reads them, traced on ``device``. Raises
    ``ValueError`` on an op the header cannot take."""
    params: list[float] = []
    helpers: set = set()
    bodies = []
    for fn, role, names in ((propagate, "propagate", ("x", "eps")),
                            (loglik, "loglik", ("x", "y"))):
        gm = _trace(fn, role, device)
        em = _Emitter(fn, role, names, params, helpers)
        for node in gm.graph.nodes:
            em.node(node, gm)
        bodies.append((len(params), "\n".join(em.lines)))
    used = [text for name, text in _HELPERS if name in helpers]
    source = _HEADER.format(
        n_prop=bodies[0][0], n_all=len(params), prop=bodies[0][1],
        ll=bodies[1][1],
        includes="".join(t for t in used if t.startswith("#include")),
        helpers="".join(t for t in used if not t.startswith("#include")))
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
