"""The reach of the fused step's model generator
(genjax_torch/ops/fused_model.py) against the TPU kernel's own lowering.

- **Oracle table.** One row an op, its jnp form beside its torch form.
  The TPU kernel takes a jnp model exactly when Mosaic lowers it:
  ``jax.export`` of ``make_fused_step`` for the ``tpu`` platform runs that
  lowering on the CPU and raises on an op it has no rule for. Each row
  asserts that the port generates the torch form exactly when the jnp
  form lowers, but for the rows of ``EXCEPTIONS``, where the two differ
  by design (each with its reason); a refusal names the op.
- **Three-way agreement** for every row that lowers, and for every
  scalar stdlib distribution whose ``logpdf`` lowers: the generated
  header built with the host ``g++`` (``-ffp-contract=off``; all headers
  in one library, each in a namespace of its own), the torch callable
  and the JAX package's ``fused_step_reference`` (the kernel's jnp
  oracle; all rows in one ``jax.jit``) on the same seeded inputs with
  edge values (NaN, ±inf, ±0, exact halves, subnormals, values out of
  int32's range). Tolerances: bit for bit (NaN with NaN) for the
  rounding, integer, bool and selection rows; 1e-5 relative + 1e-5
  absolute for the others, as test_torch_fused_model.py; ``erfinv`` in
  ulps (``ERFINV_ULPS``); the distributions as
  test_torch_distributions.py (1e-5 of max(1, |value|), 1e-4 for
  ``lambert_w_normal``'s series). Where torch and jnp differ by
  definition (``JNP_DIFFERS``: NaN and -0 in ``sign``, f32 -> int32 out
  of range, ...), the header follows torch, and the jnp comparison leaves
  those points out.
- **Distribution table.** Each scalar-parameter distribution of the
  stdlib (the 40 of test_torch_distributions.py's TABLE without vector
  parameters or values), its particle in the first parameter: the port
  generates its ``logpdf`` exactly when the JAX package's lowers, and a
  refusal names the op the TPU lowering lacks.
- **Models.** The three models of chip_smoke.py's phase 34 through the
  port's fused filter and the JAX package's at 4096 particles (where JAX
  takes its jnp reference), their mean log Z over 16 keys within 4
  standard errors; their headers and the ``ops`` model's (every new op
  and value type) against their torch forms on 4096 seeded inputs. The
  rows ``long_loop`` and ``long_loop_1100`` carry 33 and 1100 float
  constants, one a step of an unrolled loop.
"""

import ctypes
import hashlib
import math
import os
import subprocess
import sys
from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp
import jax.scipy.special as jss
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import genjax_torch as gt
import genjax_tpu as gj
from genjax_tpu.inference.pf import (
    fused_particle_filter as jax_fused_particle_filter,
)
from genjax_tpu.ops.fused_step import fused_step_reference, make_fused_step
from genjax_torch import entry as E
from genjax_torch.interop import key_from_numpy
from genjax_torch.ops import fused_model as fm

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))
import chip_smoke  # noqa: E402

#: The ensemble size of the exported TPU step: one grid chunk.
N_EXPORT = 512 * 128


def _tpu_lowers(propagate, loglik) -> tuple[bool, str]:
    """Whether Mosaic lowers the TPU kernel with this model, and its
    error."""
    step = make_fused_step(propagate, loglik, N_EXPORT)
    spec = (jax.ShapeDtypeStruct((2,), jnp.uint32),
            jax.ShapeDtypeStruct((N_EXPORT,), jnp.float32),
            jax.ShapeDtypeStruct((N_EXPORT,), jnp.float32),
            jax.ShapeDtypeStruct((), jnp.float32))
    try:
        jax.export.export(jax.jit(step), platforms=["tpu"])(*spec)
    except Exception as err:  # noqa: BLE001 - the lowering's refusal
        return False, str(err).split("\n")[0]
    return True, ""


def _tpu_verdicts(forms: dict, expected: list, role: str) -> dict:
    """``name -> (lowers, error)`` for each jnp form, as ``propagate``
    or ``loglik`` (the other the identity or a square). The forms
    expected to lower are exported as one model, their sum: if it lowers,
    each does (each op is in its kernel); any other form, and all of them
    if the sum does not lower, is exported alone. The TPU kernel's normal
    draw, which lowers whatever the model, is its counter's bits here:
    the same shape and dtype, a tenth of the ops to trace and lower."""
    from genjax_tpu.ops import fused_step as jfs

    def model(f):
        return (f, _j_square) if role == "propagate" else (_j_ident, f)

    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jfs, "normal_from_counter", lambda k0, k1, ctr: (
            jax.lax.bitcast_convert_type(ctr, jnp.float32)))
        group = [forms[k] for k in expected]
        if _tpu_lowers(*model(lambda x, y: sum(f(x, y) for f in group)))[0]:
            out = {k: (True, "") for k in expected}
        for k, f in forms.items():
            if k not in out:
                out[k] = _tpu_lowers(*model(f))
    return out


def _port_verdict(propagate, loglik):
    """``(generates, error, source, params)`` of the port's generator."""
    try:
        return (True, "", *fm.model_source(propagate, loglik))
    except ValueError as e:
        return False, str(e), None, None


@pytest.fixture(scope="module")
def tpu_rows():
    return _tpu_verdicts(
        {k: r.jax_loglik for k, r in ROW.items()},
        [k for k, r in ROW.items()
         if r.refused_as is None or EXCEPTIONS.get(k, ((0,),))[0][0]],
        "propagate")


@pytest.fixture(scope="module")
def port_rows():
    """The port's verdict on each row as ``propagate(x, eps)``."""
    return {k: _port_verdict(r.torch_loglik, _t_square)
            for k, r in ROW.items()}


@pytest.fixture(scope="module")
def tpu_dists():
    return _tpu_verdicts({k: _dist_forms(k)[0] for k in SCALAR_DISTS},
                         DIST_LOWERED, "loglik")


@pytest.fixture(scope="module")
def port_dists():
    return {k: _port_verdict(_t_ident, _dist_forms(k)[1])
            for k in SCALAR_DISTS}


def _j_ident(x, e):
    return x


def _j_square(x, y):
    return -(x * x)


def _t_square(x, y):
    return -(x * x)


def _t_ident(x, e):
    return x


class Row(NamedTuple):
    """An op: its jnp and torch forms ``f(x, y)`` (``x`` the particle,
    ``y`` the observation), how the header is held to torch
    (``exact``, ``close`` or ``erfinv``), and for a form the port refuses
    the name its error gives."""

    name: str
    jf: Callable
    tf: Callable
    check: str = "close"
    refused_as: str | None = None

    @property
    def jax_loglik(self):
        def loglik(x, y):
            r = self.jf(x, y)
            return r if r.dtype == jnp.float32 else r.astype(jnp.float32)

        return loglik

    @property
    def torch_loglik(self):
        def loglik(x, y):
            r = self.tf(x, y)
            return r if r.dtype == torch.float32 else r.to(torch.float32)

        return loglik


def U(name, jf, tf, check="close", refused_as=None):
    return Row(name, lambda x, y: jf(x), lambda x, y: tf(x), check,
               refused_as)


def B(name, jf, tf, check="close", refused_as=None):
    return Row(name, jf, tf, check, refused_as)


def _ji(v):
    return v.astype(jnp.int32)


def _ti(v):
    return v.to(torch.int32)


def _jbits(v):
    return jax.lax.bitcast_convert_type(v, jnp.int32)


def _tbits(v):
    return v.view(torch.int32)


_T_FLAG = torch.tensor(True)
_T_SEVEN = torch.tensor(7, dtype=torch.int32)
_T_HALF = torch.tensor(0.5)


def _j_loop(x, y):
    return jax.lax.fori_loop(0, 3, lambda i, v: v * 0.5 + y, x)


def _t_loop(x, y):
    for _ in range(3):
        x = x * 0.5 + y
    return x


def _long_loop(steps: int):
    """``x = x * 0.5 + y`` ``steps`` times: jnp's ``fori_loop`` keeps one
    constant, torch's Python loop unrolls into one a step (``steps`` float
    constants, read from the device)."""

    def jf(x, y):
        return jax.lax.fori_loop(0, steps, lambda i, v: v * 0.5 + y, x)

    def tf(x, y):
        for _ in range(steps):
            x = x * 0.5 + y
        return x

    return jf, tf


nn = jax.nn
ROWS = [
    # -- f32 math that the port took before -------------------------------
    U("exp", jnp.exp, torch.exp), U("log", jnp.log, torch.log),
    U("log1p", jnp.log1p, torch.log1p), U("sqrt", jnp.sqrt, torch.sqrt),
    U("rsqrt", jax.lax.rsqrt, torch.rsqrt), U("abs", jnp.abs, torch.abs,
                                              "exact"),
    U("neg", jnp.negative, torch.neg, "exact"),
    U("sin", jnp.sin, torch.sin), U("cos", jnp.cos, torch.cos),
    U("tanh", jnp.tanh, torch.tanh), U("sigmoid", nn.sigmoid, torch.sigmoid),
    U("reciprocal", jnp.reciprocal, torch.reciprocal),
    U("square", jnp.square, torch.square),
    B("pow", jnp.power, torch.pow), B("div", jnp.divide, torch.div),
    B("maximum", jnp.maximum, torch.maximum, "exact"),
    B("minimum", jnp.minimum, torch.minimum, "exact"),
    B("clamp", lambda x, y: jnp.clip(x, -1.0, y),
      lambda x, y: torch.clamp(torch.clamp(x, min=-1.0), max=y), "exact"),
    B("where_compare", lambda x, y: jnp.where(x > y, x, y * 2.0),
      lambda x, y: torch.where(x > y, x, y * 2.0), "exact"),
    # -- f32 math that Mosaic lowers ---------------------------------------
    U("floor", jnp.floor, torch.floor, "exact"),
    U("ceil", jnp.ceil, torch.ceil, "exact"),
    U("round", jnp.round, torch.round, "exact"),
    U("round_decimals", lambda x: jnp.round(x, 2),
      lambda x: torch.round(x, decimals=2), "exact"),
    U("trunc", jnp.trunc, torch.trunc, "exact"),
    U("frac", lambda x: x - jnp.trunc(x), torch.frac, "exact"),
    U("sign", jnp.sign, torch.sign, "exact"),
    U("exp2", jnp.exp2, torch.exp2), U("tan", jnp.tan, torch.tan),
    U("erfinv", jss.erfinv, torch.erfinv, "erfinv"),
    U("log2", jnp.log2, torch.log2), U("log10", jnp.log10, torch.log10),
    U("relu", nn.relu, torch.relu, "exact"),
    U("logit", jss.logit, torch.logit),
    U("logit_eps", lambda x: jss.logit(jnp.clip(x, 1e-3, 1 - 1e-3)),
      lambda x: torch.logit(x, eps=1e-3)),
    U("sinc", jnp.sinc, torch.sinc),
    U("deg2rad", jnp.deg2rad, torch.deg2rad),
    U("rad2deg", jnp.rad2deg, torch.rad2deg),
    U("softplus", nn.softplus, F.softplus),
    U("softplus_beta",
      lambda x: jnp.where(2.0 * x > 10.0, x, jnp.log1p(jnp.exp(2.0 * x)) / 2),
      lambda x: F.softplus(x, beta=2.0, threshold=10.0)),
    U("log_sigmoid", nn.log_sigmoid, F.logsigmoid),
    U("silu", nn.silu, F.silu),
    U("gelu_tanh", lambda x: nn.gelu(x, approximate=True),
      lambda x: F.gelu(x, approximate="tanh")),
    U("relu6", nn.relu6, F.relu6, "exact"),
    U("hardtanh", nn.hard_tanh, F.hardtanh, "exact"),
    U("leaky_relu", nn.leaky_relu, F.leaky_relu),
    U("mish", nn.mish, F.mish),
    U("hardsigmoid", nn.hard_sigmoid, F.hardsigmoid),
    U("hardswish", nn.hard_swish, F.hardswish),
    U("softsign", nn.soft_sign, F.softsign),
    U("entr", jss.entr, torch.special.entr),
    B("fmod", jnp.fmod, torch.fmod, "exact"),
    B("remainder", jnp.remainder, torch.remainder, "exact"),
    B("floor_divide", jnp.floor_divide, torch.floor_divide, "exact"),
    B("div_floor", jnp.floor_divide,
      lambda x, y: torch.div(x, y, rounding_mode="floor"), "exact"),
    B("div_trunc", lambda x, y: jnp.trunc(x / y),
      lambda x, y: torch.div(x, y, rounding_mode="trunc"), "exact"),
    B("hypot", jnp.hypot, torch.hypot),
    B("copysign", jnp.copysign, torch.copysign, "exact"),
    B("xlogy", jss.xlogy, torch.xlogy),
    B("xlog1py", jss.xlog1py, torch.special.xlog1py),
    B("logaddexp", jnp.logaddexp, torch.logaddexp),
    B("logaddexp2", jnp.logaddexp2, torch.logaddexp2),
    B("nextafter", jnp.nextafter, torch.nextafter, "exact"),
    B("fmax", jnp.fmax, torch.fmax, "exact"),
    B("fmin", jnp.fmin, torch.fmin, "exact"),
    B("heaviside", jnp.heaviside, torch.heaviside, "exact"),
    B("ldexp", lambda x, y: jnp.ldexp(x, _ji(jnp.clip(y, -20, 20))),
      lambda x, y: torch.ldexp(x, _ti(torch.clamp(y, -20, 20))), "exact"),
    B("lerp", lambda x, y: x + 0.3 * (y - x),
      lambda x, y: torch.lerp(x, y, 0.3)),
    B("fori_loop", _j_loop, _t_loop),
    # -- bool values --------------------------------------------------------
    U("isnan", jnp.isnan, torch.isnan, "exact"),
    U("isinf", jnp.isinf, torch.isinf, "exact"),
    U("isfinite", jnp.isfinite, torch.isfinite, "exact"),
    U("isposinf", jnp.isposinf, torch.isposinf, "exact"),
    U("isneginf", jnp.isneginf, torch.isneginf, "exact"),
    U("signbit", jnp.signbit, torch.signbit, "exact"),
    B("and", lambda x, y: (x > 0) & (y > 0), lambda x, y: (x > 0) & (y > 0),
      "exact"),
    B("or", lambda x, y: (x > 0) | (y > 0), lambda x, y: (x > 0) | (y > 0),
      "exact"),
    B("xor", lambda x, y: (x > 0) ^ (y > 0), lambda x, y: (x > 0) ^ (y > 0),
      "exact"),
    U("not", lambda x: ~(x > 0), lambda x: ~(x > 0), "exact"),
    B("logical_and", lambda x, y: jnp.logical_and(x > 0, y),
      lambda x, y: torch.logical_and(x > 0, y), "exact"),
    B("logical_or", jnp.logical_or, torch.logical_or, "exact"),
    B("logical_xor", jnp.logical_xor, torch.logical_xor, "exact"),
    U("logical_not", jnp.logical_not, torch.logical_not, "exact"),
    B("eq_bool", lambda x, y: (x > 0) == (y > 0),
      lambda x, y: (x > 0) == (y > 0), "exact"),
    U("to_bool", lambda x: x.astype(jnp.bool_), lambda x: x.bool(), "exact"),
    B("where_isnan", lambda x, y: jnp.where(jnp.isnan(x), y, x),
      lambda x, y: torch.where(torch.isnan(x), y, x), "exact"),
    B("bool_times_f32", lambda x, y: (x > 0) * y, lambda x, y: (x > 0) * y,
      "exact"),
    B("bool_plus_bool", lambda x, y: (x > 0) + (y > 0),
      lambda x, y: (x > 0) + (y > 0), "exact"),
    U("closed_bool", lambda x: jnp.where(True, x, 0.0),
      lambda x: torch.where(_T_FLAG, x, torch.zeros_like(x)), "exact"),
    # -- int32 values -------------------------------------------------------
    U("to_int32", _ji, _ti, "exact"),
    U("view_int32", _jbits, _tbits, "exact"),
    U("view_float32", lambda x: jax.lax.bitcast_convert_type(
        _jbits(x) + 1, jnp.float32),
        lambda x: (_tbits(x) + 1).view(torch.float32), "exact"),
    U("bool_to_int32", lambda x: _ji(x > 0), lambda x: _ti(x > 0), "exact"),
    U("int32_to_bool", lambda x: _ji(x).astype(jnp.bool_),
      lambda x: _ti(x).bool(), "exact"),
    U("int32_to_f32_mix", lambda x: _ji(x) + x, lambda x: _ti(x) + x,
      "exact"),
    B("int_add", lambda x, y: _ji(x) + _ji(y), lambda x, y: _ti(x) + _ti(y),
      "exact"),
    U("int_sub_const", lambda x: _jbits(x) - 3, lambda x: _tbits(x) - 3,
      "exact"),
    B("int_mul", lambda x, y: _jbits(x) * _ji(y),
      lambda x, y: _tbits(x) * _ti(y), "exact"),
    U("int_and", lambda x: _jbits(x) & 0x7FFFFFFF,
      lambda x: _tbits(x) & 0x7FFFFFFF, "exact"),
    U("int_or", lambda x: _ji(x) | 5, lambda x: _ti(x) | 5, "exact"),
    B("int_xor", lambda x, y: _jbits(x) ^ _ji(y),
      lambda x, y: _tbits(x) ^ _ti(y), "exact"),
    U("int_not", lambda x: ~_jbits(x), lambda x: ~_tbits(x), "exact"),
    U("int_shl", lambda x: _jbits(x) << 3, lambda x: _tbits(x) << 3,
      "exact"),
    U("int_shr", lambda x: _jbits(x) >> 23, lambda x: _tbits(x) >> 23,
      "exact"),
    B("int_shl_var", lambda x, y: _ji(x) << _ji(y),
      lambda x, y: _ti(x) << _ti(y), "exact"),
    B("int_shr_var", lambda x, y: _jbits(x) >> _ji(y),
      lambda x, y: _tbits(x) >> _ti(y), "exact"),
    U("int_abs", lambda x: jnp.abs(_jbits(x)), lambda x: _tbits(x).abs(),
      "exact"),
    U("int_neg", lambda x: -_jbits(x), lambda x: -_tbits(x), "exact"),
    U("int_sign", lambda x: jnp.sign(_ji(x)), lambda x: _ti(x).sign(),
      "exact"),
    B("int_max", lambda x, y: jnp.maximum(_ji(x), _ji(y)),
      lambda x, y: torch.maximum(_ti(x), _ti(y)), "exact"),
    B("int_min", lambda x, y: jnp.minimum(_ji(x), _ji(y)),
      lambda x, y: torch.minimum(_ti(x), _ti(y)), "exact"),
    U("int_clamp", lambda x: jnp.clip(_ji(x), -3, 3),
      lambda x: torch.clamp(_ti(x), -3, 3), "exact"),
    U("int_pow", lambda x: _jbits(x) ** 2, lambda x: _tbits(x) ** 2,
      "exact"),
    B("int_compare", lambda x, y: _ji(x) > _ji(y),
      lambda x, y: _ti(x) > _ti(y), "exact"),
    U("int_where", lambda x: jnp.where(x > 0, _ji(x), 7),
      lambda x: torch.where(x > 0, _ti(x), 7), "exact"),
    U("closed_int", lambda x: _ji(x) + 7, lambda x: _ti(x) + _T_SEVEN,
      "exact"),
    # -- constants ----------------------------------------------------------
    U("zeros_like", lambda x: x + jnp.zeros_like(x),
      lambda x: x + torch.zeros_like(x), "exact"),
    U("ones_like", lambda x: x * jnp.ones_like(x),
      lambda x: x * torch.ones_like(x), "exact"),
    U("full_like", lambda x: x * jnp.full_like(x, 2.5),
      lambda x: x * torch.full_like(x, 2.5), "exact"),
    U("full", lambda x: x - jnp.full((1,), 0.75),
      lambda x: x - torch.full((1,), 0.75), "exact"),
    U("scalar_tensor", lambda x: x + 0.25,
      lambda x: x + torch.scalar_tensor(0.25), "exact"),
    U("closed_f32", lambda x: x * 0.5, lambda x: x * _T_HALF, "exact"),
    B("long_loop", *_long_loop(33)),
    B("long_loop_1100", *_long_loop(1100)),
    # -- refused by both ----------------------------------------------------
    U("erf", jss.erf, torch.erf, refused_as="aten.erf"),
    U("erfc", jss.erfc, torch.erfc, refused_as="aten.erfc"),
    U("lgamma", jss.gammaln, torch.lgamma, refused_as="aten.lgamma"),
    U("digamma", jss.digamma, torch.digamma, refused_as="aten.digamma"),
    U("sinh", jnp.sinh, torch.sinh, refused_as="aten.sinh"),
    U("cosh", jnp.cosh, torch.cosh, refused_as="aten.cosh"),
    U("asinh", jnp.arcsinh, torch.asinh, refused_as="aten.asinh"),
    U("acosh", jnp.arccosh, torch.acosh, refused_as="aten.acosh"),
    U("atanh", jnp.arctanh, torch.atanh, refused_as="aten.atanh"),
    U("asin", jnp.arcsin, torch.asin, refused_as="aten.asin"),
    U("acos", jnp.arccos, torch.acos, refused_as="aten.acos"),
    U("atan", jnp.arctan, torch.atan, refused_as="aten.atan"),
    B("atan2", jnp.arctan2, torch.atan2, refused_as="aten.atan2"),
    U("i0e", jss.i0e, torch.special.i0e, refused_as="aten.special_i0e"),
    U("i1e", jss.i1e, torch.special.i1e, refused_as="aten.special_i1e"),
    U("ndtri", jss.ndtri, torch.special.ndtri,
      refused_as="aten.special_ndtri"),
    U("log_ndtr", jss.log_ndtr, torch.special.log_ndtr,
      refused_as="aten.special_log_ndtr"),
    B("zeta", jss.zeta, torch.special.zeta, refused_as="aten.special_zeta"),
    U("elu", nn.elu, F.elu, refused_as="aten.elu"),
    U("selu", nn.selu, F.selu, refused_as="aten.elu"),
    U("celu", nn.celu, F.celu, refused_as="aten.celu"),
    U("gelu", lambda x: nn.gelu(x, approximate=False), F.gelu,
      refused_as="aten.gelu"),
    # -- the exceptions (EXCEPTIONS) ----------------------------------------
    U("expm1", jnp.expm1, torch.expm1, refused_as="aten.expm1"),
    U("int_floor_divide", lambda x: _ji(x) // 3, lambda x: _ti(x) // 3,
      refused_as="aten.floor_divide"),
    U("int_remainder", lambda x: _ji(x) % 3, lambda x: _ti(x) % 3,
      refused_as="aten.remainder"),
    B("float_power", jnp.float_power, torch.float_power,
      refused_as="torch.float64"),
    U("to_float64", lambda x: x.astype(jnp.float64).astype(jnp.float32),
      lambda x: x.double().float(), refused_as="torch.float64"),
    U("to_int16", lambda x: x.astype(jnp.int16),
      lambda x: x.to(torch.int16), refused_as="torch.int16"),
]
ROW = {r.name: r for r in ROWS}

#: Rows where the TPU kernel and the port differ by design: (TPU lowers,
#: port generates) and why.
EXCEPTIONS = {
    "expm1": ((False, True), "the port takes expm1 (expm1f), which Mosaic "
              "does not lower"),
    "int_floor_divide": ((True, False), "torch raises on an integer zero "
                         "divisor, which a kernel cannot"),
    "int_remainder": ((True, False), "torch raises on an integer zero "
                      "divisor, which a kernel cannot"),
    "float_power": ((True, False), "torch's float_power computes in "
                    "float64, a dtype the port's values exclude; JAX with "
                    "x64 off computes it in f32"),
    "to_float64": ((True, False), "float64 is refused; JAX with x64 off "
                   "keeps f32"),
    "to_int16": ((True, False), "the port's values are f32, bool and "
                 "int32"),
}

_OUT_OF_INT32 = 2.0 ** 31


def _beyond_int32(v):
    return ~(np.abs(v) < _OUT_OF_INT32)


def _x_beyond(x, y):
    return _beyond_int32(x)


def _xy_beyond(x, y):
    return _beyond_int32(x) | _beyond_int32(y)


def _flushed(v):
    """Subnormal inputs, which XLA on the CPU (as the TPU) reads as 0."""
    return (v != 0) & (np.abs(v) < np.finfo(np.float32).tiny)


#: Points where torch and jnp differ by definition; the header follows
#: torch there.
JNP_DIFFERS = {
    # torch: (0 < x) - (x < 0), so NaN and -0 give +0; jnp keeps them.
    "sign": lambda x, y: np.isnan(x) | (x == 0),
    # torch's CPU cast (and the header's host form) gives INT32_MIN for
    # NaN and out of range, XLA's saturates (NaN to 0), as torch's CUDA
    # cast and the header's card form do.
    **{k: _x_beyond for k in ("to_int32", "bool_to_int32", "int32_to_bool",
                              "int32_to_f32_mix", "int_or", "int_sign",
                              "int_clamp", "int_where", "closed_int")},
    # the exponent: NaN and out of range cast as above.
    "ldexp": lambda x, y: _beyond_int32(y),
    # jnp multiplies by a bool by selecting: 0 where it is false, whatever
    # the f32 (NaN, ±inf, a negative); torch multiplies by 0.
    "bool_times_f32": lambda x, y: ~(x > 0),
    **{k: _xy_beyond for k in ("int_add", "int_mul", "int_xor",
                               "int_shl_var", "int_shr_var", "int_max",
                               "int_min", "int_compare")},
    # round(x, decimals=k) overflows to inf in x 10^k in both.
    # xlogy / xlog1py: torch gives NaN where y is NaN even at x = 0; jnp 0.
    "xlogy": lambda x, y: (x == 0) & np.isnan(y),
    "xlog1py": lambda x, y: (x == 0) & np.isnan(y),
    # floor division by 0: torch gives a / 0 (±inf, NaN), jnp NaN; jnp
    # rounds the quotient where torch floors it, so they part at ±inf.
    "floor_divide": lambda x, y: (y == 0) | np.isinf(x) | np.isinf(y),
    "div_floor": lambda x, y: (y == 0) | np.isinf(x) | np.isinf(y),
    # heaviside at NaN: torch 0 (NaN > 0 is false), jnp NaN.
    "heaviside": lambda x, y: np.isnan(x),
}

_rng = np.random.default_rng(20261018)
X_EDGE = np.array([
    np.nan, np.inf, -np.inf, -0.0, 0.0, 0.5, 1.5, 2.5, -0.5, -2.5, 1.0, -1.0,
    3e9, -3e9, 2147483520.0, -2147483648.0, 1e-45, -1e-45, 1.1754944e-38,
    0.999, -0.999, 0.7, -0.7, 0.0625, 20.0, -20.0, 31.0, 33.0, -40.0, 88.5,
    -104.0, 1e30, -1e30, 0.2, 0.8], np.float32)
X = np.concatenate([
    X_EDGE, _rng.normal(0, 3, 96), _rng.uniform(-1, 1, 48),
    _rng.normal(0, 40, 16), np.round(_rng.normal(0, 4, 16)) + 0.5,
]).astype(np.float32)
Y = np.array([np.nan, np.inf, -np.inf, -0.0, 0.0, 0.5, -1.5, 2.0, 3.0,
              -7.25, 40.0], np.float32)

LOWERED = [r.name for r in ROWS if r.refused_as is None]

#: Header and jnp erfinv against torch's, in ulps, on (-1, 1): the
#: header's (torch's algorithm in double, rounded once) and torch's are
#: within an ulp of the float64 value; XLA's f32 polynomial is up to 64
#: ulps from it at 0.99-0.99999.
ERFINV_ULPS = {"header": 1, "jnp": 64}

# -- distributions --------------------------------------------------------

SCALAR_DISTS = {
    "normal": (0.5, 2.0), "cauchy": (0.0, 1.5), "laplace": (1.0, 2.0),
    "logistic": (0.0, 1.0), "gumbel": (0.5, 1.2),
    "student_t": (4.0, 0.0, 1.0), "half_student_t": (3.0, 0.0, 1.0),
    "half_cauchy": (0.0, 1.0), "half_normal": (2.0,),
    "log_normal": (0.0, 1.0), "logit_normal": (0.0, 1.0),
    "uniform": (1.0, 3.0), "exponential": (2.0,), "beta": (2.0, 3.0),
    "gamma": (2.0, 3.0), "inverse_gamma": (3.0, 2.0),
    "exp_gamma": (2.0, 1.0), "exp_inverse_gamma": (2.0, 1.0),
    "chi2": (3.0,), "chi": (3.0,), "weibull": (2.0, 1.5),
    "kumaraswamy": (2.0, 3.0), "double_sided_maxwell": (0.0, 1.0),
    "moyal": (0.0, 1.0), "truncated_normal": (0.0, 1.0, -1.0, 2.0),
    "truncated_cauchy": (0.0, 1.0, -2.0, 2.0),
    "inverse_gaussian": (1.0, 2.0), "von_mises": (0.0, 2.0),
    "bernoulli": (0.3,), "flip": (0.3,), "poisson": (3.5,),
    "geometric": (0.3,), "binomial": (10.0, 0.4),
    "beta_binomial": (10.0, 2.0, 3.0), "negative_binomial": (5.0, 0.4),
    "non_central_chi2": (3.0, 2.0), "skellam": (2.0, 3.0), "zipf": (2.5,),
    "beta_quotient": (2.0, 3.0, 4.0, 3.0),
    "lambert_w_normal": (0.5, 1.5, 0.2),
}
#: The op each refusing distribution is refused for, in both packages'
#: terms (the port's aten name; the TPU lowering's primitive). The
#: series of non_central_chi2 and skellam add a trailing axis that a
#: kernel's elementwise body cannot hold; beta_quotient branches in
#: Python before it reaches lgamma; Mosaic refuses a ``copy`` in the
#: JAX truncated_normal, the port its ``log_ndtr``.
DIST_REFUSED = {
    **{k: ("aten.lgamma", "lgamma") for k in (
        "student_t", "half_student_t", "beta", "gamma", "inverse_gamma",
        "exp_gamma", "exp_inverse_gamma", "chi2", "chi", "poisson",
        "binomial", "beta_binomial", "negative_binomial")},
    "beta_quotient": ("aten._local_scalar_dense", "lgamma"),
    "truncated_normal": ("aten.special_log_ndtr", "copy"),
    "truncated_cauchy": ("aten.atan", "atan"),
    "von_mises": ("aten.special_i0e", "bessel_i0e"),
    "zipf": ("aten.special_zeta", "zeta"),
    "non_central_chi2": ("aten.unsqueeze", "broadcasting"),
    "skellam": ("aten.unsqueeze", "broadcasting"),
}
DIST_LOWERED = [k for k in SCALAR_DISTS if k not in DIST_REFUSED]
DIST_VALUES = {
    "normal": [0.0, 1.0, -3.0], "cauchy": [0.0, 2.0], "laplace": [0.0, 3.0],
    "logistic": [0.0, 1.0], "gumbel": [0.0, 2.0],
    "half_cauchy": [0.5, 3.0, -1.0], "half_normal": [0.5, 3.0, -1.0],
    "log_normal": [0.5, 2.0], "logit_normal": [0.3, 0.7],
    "uniform": [1.5, 2.5, 0.5], "exponential": [0.5, 2.0, -1.0],
    "weibull": [0.5, 2.0], "kumaraswamy": [0.3, 0.6],
    "double_sided_maxwell": [1.0, -1.5], "moyal": [0.0, 2.0],
    "inverse_gaussian": [0.5, 1.5], "bernoulli": [0.0, 1.0],
    "flip": [0.0, 1.0], "geometric": [0.0, 1.0, 5.0],
    "lambert_w_normal": [0.7, -1.0, 3.0],
}
DIST_TOL = {"lambert_w_normal": 1e-4}


def _dist_forms(name):
    rest = [float(p) for p in SCALAR_DISTS[name][1:]]
    dj, dt = getattr(gj, name), getattr(gt, name)
    return (lambda x, y: dj.logpdf(y, x, *rest),
            lambda x, y: dt.logpdf(y, x, *rest))


def _dist_particles(name):
    """64 values of the distribution's first parameter around TABLE's."""
    p0 = SCALAR_DISTS[name][0]
    u = np.random.default_rng(len(name)).uniform(-1, 1, 64)
    return (p0 + 0.2 * u if p0 == 0 else p0 * (1 + 0.2 * u)).astype(
        np.float32)


# -- the host build and the JAX reference, once a module -------------------

HARNESS = r"""
extern "C" void run_{ns}(const float* x, const float* y, const float* p,
                         float* out, long n, int prop) {{
  for (long i = 0; i < n; ++i)
    out[i] = prop ? {ns}::propagate(x[i], y[i], p)
                  : {ns}::loglik(x[i], y[i], p);
}}
"""


def _model_forms():
    """The three headers phase 2 adds, by label: ``(propagate, loglik)``."""
    return {k: v for k, v in chip_smoke.generated_models("cpu").items()
            if k in chip_smoke.GEN34_MODELS}


class _Library:
    """Every generated header of this module in one host library: the
    rows as ``propagate``, the distributions as ``loglik``, the models."""

    def __init__(self, tmp, port_rows, port_dists):
        self.params, parts = {}, []
        units = {f"row_{r}": port_rows[r][2:] for r in LOWERED}
        units.update({f"dist_{d}": port_dists[d][2:] for d in DIST_LOWERED})
        units.update({f"model_{k}": fm.model_source(*fns)
                      for k, fns in _model_forms().items()})
        for ns, (source, self.params[ns]) in units.items():
            body = source.replace("#pragma once\n", "").replace(
                "namespace fused_model", f"namespace {ns}")
            parts.append(body + HARNESS.format(ns=ns))
        cpp = tmp / "headers.cpp"
        cpp.write_text("\n".join(parts))
        lib = tmp / "libheaders.so"
        subprocess.run(
            ["g++", "-std=c++17", "-O1", "-shared", "-fPIC",
             "-ffp-contract=off", "-D__device__=",
             "-D__forceinline__=inline", "-o", str(lib), str(cpp)],
            check=True, capture_output=True, text=True)
        self.so = ctypes.CDLL(str(lib))

    def run(self, ns, x, y, prop=False):
        x = np.ascontiguousarray(x, np.float32)
        y = np.ascontiguousarray(np.broadcast_to(y, x.shape), np.float32)
        out = np.empty_like(x)
        p = np.asarray(self.params[ns] or (0.0,), np.float32)
        fn = getattr(self.so, f"run_{ns}")
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_long, ctypes.c_int]
        fn(x.ctypes.data, y.ctypes.data, p.ctypes.data, out.ctypes.data,
           len(x), int(prop))
        return out


@pytest.fixture(scope="module")
def library(tmp_path_factory, port_rows, port_dists):
    return _Library(tmp_path_factory.mktemp("fused_model_ops"), port_rows,
                    port_dists)


def _reference(fns: dict, xs: dict, ys: dict, calls: int) -> dict:
    """``fused_step_reference``'s ``lw_new - lw`` (``lw`` = -0, which
    keeps the sign of a zero) for each loglik of ``fns`` on its ``xs``:
    one step over their particles end to end, whose ``loglik`` applies
    each form to its own stretch, at each of ``calls`` observations ``j``
    (a form's ``y`` is ``ys[name][j]``): ``{name: (calls, len(xs))}``."""
    names = list(fns)
    sizes = [len(xs[k]) for k in names]
    ends = np.cumsum([0] + sizes)
    table = {k: jnp.asarray(ys[k], jnp.float32) for k in names}

    def loglik(x, obs):
        j = obs.astype(jnp.int32)
        return jnp.concatenate([fns[k](x[a:b], table[k][j])
                                for k, a, b in zip(names, ends, ends[1:])])

    step = jax.jit(fused_step_reference(_j_ident, loglik, int(ends[-1])))
    x = jnp.asarray(np.concatenate([xs[k] for k in names]))
    lw = jnp.full(x.shape, -0.0, jnp.float32)
    seeds = jnp.zeros(2, jnp.uint32)
    outs = [np.asarray(step(seeds, x, lw, jnp.float32(j))[1])
            for j in range(calls)]
    return {k: np.stack([o[a:b] for o in outs])
            for k, a, b in zip(names, ends, ends[1:])}


@pytest.fixture(scope="module")
def jax_rows():
    return _reference({r: ROW[r].jax_loglik for r in LOWERED},
                      {r: X for r in LOWERED}, {r: Y for r in LOWERED},
                      len(Y))


@pytest.fixture(scope="module")
def jax_dists():
    calls = max(map(len, DIST_VALUES.values()))
    return _reference({d: _dist_forms(d)[0] for d in DIST_LOWERED},
                      {d: _dist_particles(d) for d in DIST_LOWERED},
                      {d: np.resize(DIST_VALUES[d], calls)
                       for d in DIST_LOWERED}, calls)


#: Rows whose jnp form is within this many ulps of torch's, not equal:
#: jnp's round(x, 2) on XLA's CPU returns rint(100 x) / 100 an ulp off
#: the correctly rounded quotient that torch's (and the header's) gives.
JNP_ULPS = {"round_decimals": 1}


def _same_value(ref, want):
    """XLA against torch: equal values (either sign of a zero), both NaN,
    or a subnormal result of torch's flushed to 0 by XLA (as the TPU)."""
    ref, want = np.asarray(ref, np.float32), np.asarray(want, np.float32)
    return ((np.isnan(ref) & np.isnan(want)) | (ref == want)
            | (_flushed(want) & (ref == 0)))


def _same(a, b):
    """Equal bits, or both NaN."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return (np.isnan(a) & np.isnan(b)) | (a.view(np.int32) == b.view(np.int32))


def _close(a, b, rtol=1e-5, atol=1e-5):
    return np.isclose(a, b, rtol=rtol, atol=atol, equal_nan=True)


def _ulps(a, b):
    """Distance in f32 steps (finite values)."""
    def ordered(v):
        i = np.asarray(v, np.float32).view(np.int32).astype(np.int64)
        return np.where(i < 0, -(1 << 31) - i, i)

    return np.abs(ordered(a) - ordered(b))


# -- the oracle table -----------------------------------------------------


@pytest.mark.parametrize("name", list(ROW))
def test_port_generates_exactly_what_the_tpu_kernel_lowers(name, tpu_rows,
                                                         port_rows):
    """The row as ``propagate(x, eps)``, both operands vectors (Mosaic
    lowers ``copysign`` of two vectors, not of a vector and the scalar
    observation)."""
    row = ROW[name]
    lowers, why = tpu_rows[name]
    generates, err = port_rows[name][:2]
    want = EXCEPTIONS.get(name, ((lowers, lowers), ""))[0]
    assert (lowers, generates) == want, (why, err)
    if not generates:
        assert row.refused_as in err and "propagate" in err, err
        assert "torch_loglik" in err


# -- three-way agreement ----------------------------------------------------


@pytest.mark.parametrize("name", LOWERED)
def test_header_torch_and_jax_reference_agree(name, library, jax_rows):
    row = ROW[name]
    check = {"exact": _same, "close": _close, "erfinv": _same}[row.check]
    differs = JNP_DIFFERS.get(name)
    for j, y in enumerate(Y):
        got = library.run(f"row_{name}", X, y, prop=True)
        want = row.torch_loglik(torch.tensor(X), torch.tensor(y)).numpy()
        ref = jax_rows[name][j]
        if row.check == "erfinv":
            inside = np.abs(X) < 1
            assert (_ulps(got, want)[inside] <= ERFINV_ULPS["header"]).all()
            normal = inside & ~_flushed(X) & ~_flushed(want)
            assert (_ulps(ref, want)[normal] <= ERFINV_ULPS["jnp"]).all()
            assert _same(got[~inside], want[~inside]).all()
            assert _same(ref[~inside], want[~inside]).all()
            continue
        bad = ~check(got, want)
        assert not bad.any(), (y, X[bad], got[bad], want[bad])
        keep = ~_flushed(X) & (np.ones_like(X, bool) if differs is None
                               else ~differs(X, np.float32(y)))
        if name in JNP_ULPS:
            near = _same_value(ref, want) | (
                np.isfinite(want) & (_ulps(ref, want) <= JNP_ULPS[name]))
        else:
            near = (_same_value(ref, want) if row.check == "exact"
                    else _close(ref, want))
        bad = ~near & keep
        assert not bad.any(), (y, X[bad], ref[bad], want[bad])


def test_erfinv_ulps(library):
    """``fm_erfinv`` (torch's algorithm; glibc has no ``erfinvf``) within
    ``ERFINV_ULPS`` of torch's over 2^16 points of (-1, 1), as jnp's is;
    ±inf at ±1 and NaN beyond, as torch's."""
    x = np.concatenate([
        np.linspace(-1, 1, 1 << 16, dtype=np.float32)[1:-1],
        np.float32(1) - np.logspace(-7, -1, 512, dtype=np.float32)])
    got = library.run("row_erfinv", x, 0.0, prop=True)
    want = torch.erfinv(torch.tensor(x)).numpy()
    ref = np.asarray(jax.jit(jss.erfinv)(x))
    assert _ulps(got, want).max() <= ERFINV_ULPS["header"]
    assert _ulps(ref, want).max() <= ERFINV_ULPS["jnp"]
    edges = library.run("row_erfinv", np.array([1, -1, 1.5, -2], np.float32),
                        0.0, prop=True)
    assert edges[0] == np.inf and edges[1] == -np.inf
    assert np.isnan(edges[2:]).all()


# -- distributions ------------------------------------------------------------


@pytest.mark.parametrize("name", list(SCALAR_DISTS))
def test_distribution_generates_exactly_when_it_lowers(name, tpu_dists,
                                                        port_dists):
    lowers, why = tpu_dists[name]
    generates, err = port_dists[name][:2]
    assert generates == lowers, (why, err)
    assert lowers == (name not in DIST_REFUSED)
    if not lowers:
        port_name, tpu_name = DIST_REFUSED[name]
        assert port_name in err, err
        assert tpu_name in why, why


@pytest.mark.parametrize("name", DIST_LOWERED)
def test_distribution_header_torch_and_jax_agree(name, library, jax_dists):
    tol = DIST_TOL.get(name, 1e-5)
    x = _dist_particles(name)
    tf = _dist_forms(name)[1]
    for j, y in enumerate(DIST_VALUES[name]):
        got = library.run(f"dist_{name}", x, y)
        want = tf(torch.tensor(x), torch.tensor(np.float32(y))).numpy()
        ref = jax_dists[name][j]
        scale = np.maximum(1.0, np.abs(np.where(np.isfinite(ref), ref, 0)))
        assert _close(got, want, 1e-5, 1e-5).all(), (y, got, want)
        assert (np.isclose(want, ref, rtol=0, atol=0, equal_nan=True)
                | (np.abs(want - ref) <= tol * scale)).all(), (y, want, ref)


# -- models ----------------------------------------------------------------


@pytest.mark.parametrize("label", sorted(chip_smoke.GEN34_MODELS))
def test_model_header_matches_torch(label, library):
    propagate, loglik = _model_forms()[label]
    rng = np.random.default_rng(11)
    x, e = (rng.normal(size=4096).astype(np.float32) for _ in range(2))
    y = np.where(rng.uniform(size=4096) < 0.5, 2.5,
                 rng.normal(0, 2, 4096)).astype(np.float32)
    for prop, b, fn in ((True, e, propagate), (False, y, loglik)):
        got = library.run(f"model_{label}", x, b, prop=prop)
        want = fn(torch.tensor(x), torch.tensor(b)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def _jax_phase34(label):
    phi, sigma = E.AR_PHI, E.AR_SIGMA

    def propagate(x, e):
        return phi * x + sigma * e

    if label == "dynamic_logit":
        def loglik(x, y):
            return gj.bernoulli.logpdf(y > 0.5, x)
    elif label == "lambert_w":
        def loglik(x, y):
            return gj.lambert_w_normal.logpdf(y, x, E.LW_SCALE, E.LW_TAIL)
    else:
        step, scale = E.QUANT_STEP, E.QUANT_SCALE

        def loglik(x, y):
            return gj.logistic.logpdf(y, step * jnp.round(x / step), scale)

    return propagate, loglik


@pytest.mark.parametrize("label", ["dynamic_logit", "quantised",
                                   "lambert_w"])
def test_phase_34_models_match_the_jax_fused_filter(label):
    """The port's fused filter (its plain step on the CPU) and the JAX
    package's at 4096 particles x 32 steps (its jnp reference: 4096 is
    below one Pallas grid chunk), averaged over the same 16 keys: the
    means within 4 standard errors of their difference."""
    n, t, keys = 4096, 32, 16
    build = {"dynamic_logit": E.build_dynamic_logit,
             "quantised": E.build_quantised,
             "lambert_w": E.build_lambert_w}[label]
    ys = {"dynamic_logit": E.dynamic_logit_observations,
          "quantised": E.quantised_observations,
          "lambert_w": E.lambert_w_observations}[label](t)
    sd0 = E.AR_SIGMA / math.sqrt(1 - E.AR_PHI ** 2)
    jpf = jax_fused_particle_filter(
        lambda k: sd0 * jax.random.normal(k, (n,)), *_jax_phase34(label), n)
    jrun = jax.jit(lambda k: jpf(k, jnp.asarray(ys))[0].log_z)
    trun, work = build(n, t, device="cpu")
    assert work == n * t
    jkeys = [jax.random.key(s) for s in range(keys)]
    zj = np.array([float(jrun(k)) for k in jkeys])
    # One intra-op thread: the suite's workers share the host's cores,
    # and 2^12-element ops slow down tenfold when each takes them all.
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        zt = np.array([float(trun(key_from_numpy(np.asarray(
            jax.random.key_data(k))))) for k in jkeys])
    finally:
        torch.set_num_threads(threads)
    assert np.isfinite(zj).all() and np.isfinite(zt).all()
    diff = abs(zj.mean() - zt.mean())
    se = math.sqrt((zj.var(ddof=1) + zt.var(ddof=1)) / keys)
    assert diff < 4 * se, (zj, zt)


# -- what phase 33 built stays as it was -----------------------------------

#: sha256 of the headers generated from phase 33's four models before
#: value types: their libraries stay valid.
PHASE33_SHA256 = {
    "sv": "f6c141974ab643d6931fadaf47b62c4041bda71f43faee60d1ce664630fdfb67",
    "linear":
        "e263ba13f3c6eddb8af7a5eb2aff43b2e9b8c2a9741e1d23219bde3274a409f8",
    "tracking":
        "148dd15300d976e8f6c32e5bef10e8a56d9865f917a0156893bfdf638c1686b3",
    "live": "19d8ea12ce9943c7efd30e38a64fd66e0016067675da5cf10962c81bdf70cda2",
}


@pytest.mark.parametrize("label", sorted(PHASE33_SHA256))
def test_phase_33_headers_are_byte_identical(label):
    source, _ = fm.model_source(*chip_smoke.generated_models("cpu")[label])
    assert hashlib.sha256(source.encode()).hexdigest() == \
        PHASE33_SHA256[label]
    assert "stdint" not in source and "fm_erfinv" not in source
