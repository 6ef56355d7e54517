"""The time-travel debugger of the port
(``genjax_torch/core/compiler/interpreters/time_travel.py``, resumption
by re-execution) against the JAX package's on
``tests/utils/test_aux.py::TestTimeTravel``'s four cases: the frames,
their values, navigation, ``resume`` with and without a substituted
value, ``remix`` and a frame inside a ``@gen`` body."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

import genjax_torch as gt
import genjax_tpu as gj
from genjax_torch.core.compiler.interpreters import time_travel as tt
from genjax_torch.interop import key_from_numpy
from genjax_tpu.core.compiler.interpreters import time_travel as jt

KEY = jax.random.key(314159)


def _fn(lib):
    def fn(x):
        a = lib.rec(x * 2.0, name="a")
        b = lib.rec(a + 1.0, name="b")
        return b * 10.0

    return fn


def _f(x):
    return float(np.asarray(x))


def test_frames_and_navigation():
    want = jt.time_machine(_fn(jt))(3.0)
    got = tt.time_machine(_fn(tt))(torch.tensor(3.0))
    assert [f.tag for f in got.frames] == [f.tag for f in want.frames] \
        == ["a", "b"]
    assert _f(got.final) == _f(want.final) == 70.0
    for dbg in (want, got):
        assert _f(dbg.jump("a").frame.value) == 6.0
        assert _f(dbg.fwd().frame.value) == 7.0
        assert _f(dbg.bwd().frame.value) == 6.0
        assert _f(dbg.bwd().frame.value) == 6.0  # the cursor stops at 0


def test_resume():
    want = jt.time_machine(_fn(jt))(3.0).jump("b")
    got = tt.time_machine(_fn(tt))(torch.tensor(3.0)).jump("b")
    assert _f(got.resume()) == _f(want.resume()) == 70.0
    assert _f(got.resume(value=torch.tensor(0.0))) == _f(
        want.resume(value=jnp.asarray(0.0))) == 0.0
    # From the first frame, the rest of the program re-runs on the value.
    got.jump("a")
    want.jump("a")
    assert _f(got.resume(value=torch.tensor(1.0))) == _f(
        want.resume(value=jnp.asarray(1.0))) == 20.0


def test_remix():
    want = jt.time_machine(_fn(jt))(3.0).remix(5.0)
    got = tt.time_machine(_fn(tt))(torch.tensor(3.0)).remix(torch.tensor(5.0))
    assert _f(got.final) == _f(want.final) == 110.0
    assert [_f(f.value) for f in got.frames] == [
        _f(f.value) for f in want.frames] == [10.0, 11.0]


def test_with_gen_fn():
    def model(lib, rec):
        @lib.gen
        def m(mu):
            x = lib.normal(mu, 1.0) @ "x"
            return rec(x * 2.0, name="doubled")

        return m

    jm, tm = model(gj, jt.rec), model(gt, tt.rec)
    tkey = key_from_numpy(np.asarray(jax.random.key_data(KEY)))
    want = jt.time_machine(lambda mu: jm.simulate(KEY, (mu,))
                           .get_retval())(1.0)
    got = tt.time_machine(lambda mu: tm.simulate(tkey, (mu,))
                          .get_retval())(torch.tensor(1.0))
    assert got.frames[0].tag == want.frames[0].tag == "doubled"
    np.testing.assert_allclose(_f(got.final), _f(want.final), rtol=1e-6)
    # Resuming at the frame re-runs the body with the draw replayed.
    assert _f(got.resume(value=torch.tensor(4.0))) == 4.0
