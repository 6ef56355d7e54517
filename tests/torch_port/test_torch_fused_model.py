"""The fused step's model generator (genjax_torch/ops/fused_model.py): the
CUDA header it writes from a model's torch form, compiled here with the
host ``g++`` (``__device__`` and ``__forceinline__`` defined away: the
header uses C math functions and IEEE division only) and held to the
torch callable on 4096 seeded inputs; its constants and structure; the
forms it refuses; and the fused filter with no hand-written header on the
CPU against the JAX package's fused filter (its Pallas kernel in
interpret mode) and against the Kalman log-likelihood.

Tolerances: the header against torch to 1e-5 relative + 1e-5 absolute,
as tests/torch_port/test_torch_fused_step.py holds the step (glibc's
``expf`` / ``tanhf`` / ``powf`` and torch's vectorized CPU versions
differ by an ulp, which the models amplify a little); the filters as
test_torch_slice.py's config-4 check and the JAX test's Kalman check."""

import math
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genjax_tpu.inference.pf import (
    fused_particle_filter as jax_fused_particle_filter,
)
from genjax_torch import entry as E
from genjax_torch.interop import key_from_numpy
from genjax_torch.ops import fused_model as fm
from genjax_torch.ops import fused_step as fs
from genjax_torch.core import random as R

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))
import chip_smoke  # noqa: E402

N = 4096
HARNESS = r"""
extern "C" void run_propagate(const float* x, const float* e, const float* p,
                              float* out, long n) {
  for (long i = 0; i < n; ++i) out[i] = fused_model::propagate(x[i], e[i], p);
}
extern "C" void run_loglik(const float* x, const float* y, const float* p,
                           float* out, long n) {
  for (long i = 0; i < n; ++i) out[i] = fused_model::loglik(x[i], y[i], p);
}
"""

_HALF = torch.tensor(0.5, dtype=torch.float64)   # a closed-over 0-d tensor


def _special():
    """Every selection op and both pow forms, with a closed Python float
    and a 0-d tensor."""
    k = 1.7

    def propagate(x, e):
        sel = torch.where(x > 0.1, torch.clamp(x, -1.0, 2.0),
                          torch.minimum(x, e))
        return (sel * torch.sigmoid(e) + k * torch.tanh(x) + 0.1 * x ** 3
                + torch.abs(x) ** 0.5 + torch.maximum(e, _HALF * x))

    def loglik(x, y):
        return (torch.where(x <= y, -torch.abs(y - x), -(x - y) ** 2)
                - torch.clamp(x, max=3.0) * _HALF)

    return propagate, loglik


MODELS = {
    "tracking": lambda: (E.tracking_propagate, E.tracking_loglik),
    "linear": lambda: E.linear_model(0.7, 0.5, 0.4),
    "sv": E.sv_model,
    "special": _special,
}


def _inputs(name: str):
    rng = np.random.default_rng(7)
    scale = {"tracking": 10.0, "sv": 1.0}.get(name, 2.0)
    x = (scale * rng.normal(size=N) + (E.SV_MU if name == "sv" else 0.0))
    e = rng.normal(size=N)
    y = {"tracking": 5.0, "sv": 1.5}.get(name, 2.0) * rng.normal(size=N)
    return (x.astype(np.float32), e.astype(np.float32),
            y.astype(np.float32))


def _host_build(source: str, tmp_path, opt: str = "-O2"):
    import ctypes

    header = tmp_path / "model.cuh"
    header.write_text(source)
    cpp = tmp_path / "harness.cpp"
    cpp.write_text(HARNESS)
    lib = tmp_path / "libmodel.so"
    subprocess.run(
        ["g++", "-std=c++17", opt, "-shared", "-fPIC", "-ffp-contract=off",
         "-D__device__=", "-D__forceinline__=inline", "-include",
         str(header), "-o", str(lib), str(cpp)],
        check=True, capture_output=True, text=True)
    so = ctypes.CDLL(str(lib))
    ptr = ctypes.c_void_p
    for fn in (so.run_propagate, so.run_loglik):
        fn.argtypes = [ptr, ptr, ptr, ptr, ctypes.c_long]
        fn.restype = None
    return so


def _run(fn, a, b, params):
    out = np.empty_like(a)
    p = np.asarray(params, np.float32)
    fn(a.ctypes.data, b.ctypes.data, p.ctypes.data, out.ctypes.data, len(a))
    return out


@pytest.mark.parametrize("name", list(MODELS))
def test_host_build_of_the_header_matches_torch(name, tmp_path):
    propagate, loglik = MODELS[name]()
    source, params = fm.model_source(propagate, loglik)
    assert "__fdividef" not in source and "__expf" not in source
    so = _host_build(source, tmp_path)
    x, e, y = _inputs(name)
    got_x = _run(so.run_propagate, x, e, params)
    want_x = propagate(torch.tensor(x), torch.tensor(e)).numpy()
    np.testing.assert_allclose(got_x, want_x, rtol=1e-5, atol=1e-5)
    got_l = _run(so.run_loglik, x, y, params)
    want_l = loglik(torch.tensor(x), torch.tensor(y)).numpy()
    np.testing.assert_allclose(got_l, want_l, rtol=1e-5, atol=1e-5)


def test_constants_go_to_params_not_source():
    """Other constants of the same lambdas give the same source and other
    params (a theta sweep reuses one library); another op gives another
    source."""
    src_a, par_a = fm.model_source(*E.linear_model(0.7, 0.5, 0.4))
    src_b, par_b = fm.model_source(*E.linear_model(0.9, 1.0, 0.3))
    assert src_a == src_b and par_a != par_b
    assert len(par_a) == int(src_a.split("kParams = ")[1].split(";")[0])
    src_c, _ = fm.model_source(*E.sv_model(0.95, 0.2, -1.0))
    assert src_c == fm.model_source(*E.sv_model())[0]
    prop, ll = E.linear_model(0.7, 0.5, 0.4)
    src_d, par_d = fm.model_source(lambda x, e: torch.tanh(prop(x, e)), ll)
    assert src_d != src_a and par_d == par_a


def test_params_in_graph_order_and_f32():
    """Python numbers and closed-over 0-d tensors (an f64 one read as
    f32) in graph order, propagate's first; an integer pow exponent stays
    in the text."""
    c = torch.tensor(0.1, dtype=torch.float64)
    src, params = fm.model_source(lambda x, e: c * x + 3 * e ** 2,
                                  lambda x, y: (y - x) ** 3 / 2.5)
    assert params == tuple(float(np.float32(v)) for v in (0.1, 3, 2.5))
    assert "p[0] * x" in src and "eps * eps" in src and "* p[2]" not in src
    assert "p[0..2) are propagate's" in src


def _sum(x, e):
    return x + e.sum()


def _noise(x, e):
    return x + torch.randn_like(x)


def _index(x, e):
    return x + e[0]


def _branch(x, e):
    return x if x > 0 else e


def _double(x, e):
    return x.double() + e


def _erf(x, e):
    return torch.erf(x) + e


_VECTOR = torch.arange(3.0)


def _vector_constant(x, e):
    return x + _VECTOR * e


@pytest.mark.parametrize("fn,names", [
    (_sum, "aten.sum"), (_noise, "aten.randn_like"), (_index, "aten.select"),
    (_branch, "aten._local_scalar_dense"), (_double, "torch.float64"),
    (_erf, "aten.erf"), (_vector_constant, "closed-over tensor"),
], ids=["reduction", "second_draw", "indexing", "python_branch",
        "f64_cast", "unlisted_op", "vector_constant"])
def test_unsupported_forms_raise_naming_op_and_callable(fn, names):
    with pytest.raises(ValueError) as err:
        fm.model_source(fn, E.tracking_loglik)
    assert names in str(err.value)
    assert fn.__name__ in str(err.value) and "propagate" in str(err.value)


@pytest.mark.parametrize("n_params", sorted(chip_smoke.GEN_LONG_LOOPS.values()))
def test_any_number_of_constants(n_params, tmp_path):
    """Models with 33 and 1100 float constants (1100 are more than a
    4 KB kernel parameter space holds; phase 34's long loops): each
    generates, ``params`` holds every constant in graph order (the
    loop's, then ``phi`` and 0.15, then loglik's -0.5), and its header's
    host build matches torch."""
    propagate, loglik = chip_smoke.long_loop_model(n_params)
    source, params = fm.model_source(propagate, loglik)
    cs = [0.25 + 0.25 * k / (n_params - 4) for k in range(n_params - 3)]
    assert params == tuple(float(np.float32(v))
                           for v in (*cs, 0.9, 0.15, -0.5))
    assert f"kParams = {n_params};" in source
    assert f"p[{n_params - 1}]" in source and f"p[{n_params}]" not in source
    so = _host_build(source, tmp_path, opt="-O1")
    x, e, y = _inputs("loop")
    got_x = _run(so.run_propagate, x, e, params)
    want_x = propagate(torch.tensor(x), torch.tensor(e)).numpy()
    np.testing.assert_allclose(got_x, want_x, rtol=1e-5, atol=1e-5)
    got_l = _run(so.run_loglik, x, y, params)
    want_l = loglik(torch.tensor(x), torch.tensor(y)).numpy()
    np.testing.assert_allclose(got_l, want_l, rtol=1e-5, atol=1e-5)


def test_many_constants_changed_reuse_the_header(tmp_path, monkeypatch):
    """The 1100-constant model with another ``phi`` is the same source,
    so the same header and library, with the new value in its slot of
    ``params`` and the other 1099 as they were."""
    monkeypatch.setattr(fm, "BUILD_DIR", str(tmp_path))
    n_params = chip_smoke.GEN_LONG_LOOPS["long_loop_1100"]
    model = fm.cuda_model(*chip_smoke.long_loop_model(n_params))
    other = fm.cuda_model(*chip_smoke.long_loop_model(n_params, phi=0.8))
    assert other.name == model.name
    assert len(other.params) == len(model.params) == n_params
    slot = n_params - 3
    assert model.params[slot] == float(np.float32(0.9))
    assert other.params[slot] == float(np.float32(0.8))
    assert (other.params[:slot] + other.params[slot + 1:]
            == model.params[:slot] + model.params[slot + 1:])
    assert os.listdir(os.path.join(str(tmp_path), "models")) == [
        model.name[4:] + ".cuh"]


def test_cuda_model_writes_its_header_once(tmp_path, monkeypatch):
    monkeypatch.setattr(fm, "BUILD_DIR", str(tmp_path))
    model = fm.cuda_model(*E.sv_model())
    again = fm.cuda_model(*E.sv_model(0.9, 0.3, 0.0))
    assert model.name == again.name and model.name.startswith("gen_")
    assert model.params != again.params
    path = fm.header_path(model.name)
    assert path == os.path.join(str(tmp_path), "models",
                                model.name[4:] + ".cuh")
    with open(path) as f:
        assert f.read() == fm.model_source(*E.sv_model())[0]
    assert os.listdir(os.path.dirname(path)) == [model.name[4:] + ".cuh"]


_THETA = 0.5


def _live(kind: str):
    """A model whose one constant ``propagate`` reads from a global, a
    nonlocal, a list or a 0-d tensor: ``(propagate, set_constant)``."""
    if kind == "global":
        def set_constant(v):
            global _THETA
            _THETA = v

        return (lambda x, e: _THETA * x + e), set_constant
    if kind == "nonlocal":
        theta = 0.5

        def set_constant(v):
            nonlocal theta
            theta = v

        return (lambda x, e: theta * x + e), set_constant
    if kind == "list":
        box = [0.5]
        return (lambda x, e: box[0] * x + e), lambda v: box.__setitem__(0, v)
    t = torch.tensor(0.5)
    return (lambda x, e: t * x + e), t.fill_


@pytest.mark.parametrize("kind", ["global", "nonlocal", "list", "tensor"])
def test_constants_are_read_at_each_generation(kind):
    """A constant changed between two generations (a theta sweep through
    one filter) reaches the second one's params, with the same source;
    nothing keeps the first value."""
    propagate, set_constant = _live(kind)
    try:
        first = fm.cuda_model(propagate, E.tracking_loglik)
        set_constant(0.25)
        second = fm.cuda_model(propagate, E.tracking_loglik)
    finally:
        set_constant(0.5)
    assert first.name == second.name
    assert first.params[0] == 0.5 and second.params[0] == 0.25
    assert first.params[1:] == second.params[1:]


def test_trace_follows_the_closures_device():
    """A model closing over a 0-d tensor off the CPU (on the card, in a
    card program) is traced on the ensemble's device, where it mixes with
    the inputs; on CPU inputs it could not be traced. The meta device
    stands for the card here."""
    t = torch.tensor(0.5, device="meta")

    def propagate(x, e):
        return t * x + e

    gm = fm._trace(propagate, "propagate", "meta")
    assert [n.op for n in gm.graph.nodes].count("get_attr") == 1
    with pytest.raises(ValueError, match="could not be traced"):
        fm._trace(propagate, "propagate", "cpu")


def test_step_without_a_cuda_model_on_the_cpu_is_plain():
    propagate, loglik = E.sv_model()
    x, _, _ = _inputs("sv")
    xs, lw = torch.tensor(x), torch.zeros(N)
    before = fs.fused_step.launches
    a = fs.fused_step(R.key(3), xs, lw, 0.4, propagate, loglik)
    b = fs.fused_step_plain(R.key(3), xs, lw, 0.4, propagate, loglik)
    assert all(torch.equal(u, v) for u, v in zip(a, b))
    assert fs.fused_step.launches == before


def _jax_sv(phi=E.SV_PHI, sigma=E.SV_SIGMA, mu=E.SV_MU):
    def propagate(x, e):
        return mu + phi * (x - mu) + sigma * e

    def loglik(x, y):
        return -0.5 * (jnp.log(2 * jnp.pi) + x + y * y * jnp.exp(-x))

    return propagate, loglik


def test_sv_filter_matches_jax_fused_filter():
    """The SV model through the port's fused filter (no CUDA form given)
    and the JAX package's fused filter (its Pallas kernel, interpret
    mode) at 8192 particles x 12 steps, each averaged over the same 32
    keys: the means within 0.25 and within 4 standard errors of their
    difference (test_torch_slice.py's config-4 check)."""
    n, t = 8192, 12
    ys = E.sv_observations(t, seed=3)
    sd0 = E.SV_SIGMA / math.sqrt(1 - E.SV_PHI ** 2)
    jpf = jax_fused_particle_filter(
        lambda k: E.SV_MU + sd0 * jax.random.normal(k, (n,)), *_jax_sv(),
        n, chunk_rows=8, interpret=True)
    jrun = jax.jit(lambda k: jpf(k, jnp.asarray(ys))[0].log_z)
    trun, work = E.build_sv(n, t, device="cpu", seed=3)
    assert work == n * t
    keys = [jax.random.key(s) for s in range(32)]
    zj = np.array([float(jrun(k)) for k in keys])
    zt = np.array([float(trun(key_from_numpy(np.asarray(
        jax.random.key_data(k))))) for k in keys])
    assert np.isfinite(zj).all() and np.isfinite(zt).all()
    diff = abs(zj.mean() - zt.mean())
    se = math.sqrt((zj.var(ddof=1) + zt.var(ddof=1)) / len(keys))
    assert diff < 0.25 and diff < 4 * se, (zj, zt)


def test_linear_lambdas_match_kalman():
    """The JAX test's linear-Gaussian lambdas with constants that
    ``linear.cuh`` does not carry (a = 0.7, q = 0.5, r = 0.4) through the
    fused filter: log Z within 0.1 of the Kalman value at 24576
    particles (tests/ops/test_fused_step.py:138)."""
    a, q, r = 0.7, 0.5, 0.4
    ys = E.linear_observations(15, 0, a, q, r)
    want = E.kalman_loglik(ys, a, q, r, p0=q)
    got = float(E.build_linear_fused(24576, ys, a, q, r, device="cpu",
                                     header=False)(R.key(314159)))
    assert abs(got - want) < 0.1
