"""The port's argument checks (``core/validate.py`` on every concrete GFI
method, ``core/argcheck.py`` in every combinator constructor) against the
JAX package's: the same bad input raises the same exception type, with
the same ``where`` prefix (the text before the first colon, or the
check's name), in both packages; good input passes; ``no_validation()``
turns the GFI checks off. A combinator's named arguments are ignored, as
the JAX package's ``IgnoreKwargs`` ignores them.

Tolerance: the draws of a call with ignored named arguments equal the
positional call's bit for bit in the port and the JAX package's to 1e-5
(the two packages' normals agree to a few ulp)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import genjax_torch as gt
import genjax_tpu as gj
from genjax_torch.core import random as R
from genjax_torch.core.validate import no_validation
from genjax_torch.interop import key_from_numpy
from genjax_tpu.core.validate import no_validation as jax_no_validation


def _tkey(k):
    return key_from_numpy(np.asarray(jax.random.key_data(k)))


def _model(lib):
    @lib.gen
    def model(mu):
        return lib.normal(mu, 1.0) @ "x"

    return model


def _keys(lib):
    return jax.random.key(0) if lib is gj else R.key(0)


def _zeros(lib, n):
    return jnp.zeros(n) if lib is gj else torch.zeros(n)


def _prefix(exc: Exception) -> str:
    return str(exc).split(":")[0].split(" must ")[0].split(" expects ")[0]


# Each case builds the failing call from a package (``lib``).
GFI_CASES = {
    "simulate_int_key": lambda lib: lib.normal.simulate(3, (0.0, 1.0)),
    "simulate_list_args": lambda lib: lib.normal.simulate(
        _keys(lib), [0.0, 1.0]),
    "fn_simulate_scalar_args": lambda lib: _model(lib).simulate(
        _keys(lib), 0.5),
    "assess_dict": lambda lib: lib.normal.assess({"x": 0.0}, (0.0, 1.0)),
    "fn_assess_list_args": lambda lib: _model(lib).assess(
        lib.C["x"].set(0.0), [0.5]),
    "generate_bad_key": lambda lib: _model(lib).generate(
        "key", lib.C["x"].set(0.0), (0.5,)),
    "generate_dict": lambda lib: _model(lib).generate(
        _keys(lib), {"x": 0.0}, (0.5,)),
    "generate_list_args": lambda lib: _model(lib).generate(
        _keys(lib), lib.C["x"].set(0.0), [0.5]),
    "vmap_simulate_list": lambda lib: lib.normal.vmap(in_axes=(0, None))
    .simulate(_keys(lib), [_zeros(lib, 3), 1.0]),
    "scan_simulate_float_key": lambda lib: lib.normal.vmap(
        in_axes=(0, None)).simulate(1.5, (_zeros(lib, 3), 1.0)),
}


def _edit_case(lib, what):
    m = _model(lib)
    tr = m.simulate(_keys(lib), (0.5,))
    req = lib.Update(lib.C["x"].set(0.0))
    if what == "key":
        return m.edit(7, tr, req, lib.Diff.no_change((0.5,)))
    return m.edit(_keys(lib), tr, req, [lib.Diff(0.5, lib.NoChange)])


GFI_CASES["edit_int_key"] = lambda lib: _edit_case(lib, "key")
GFI_CASES["edit_list_argdiffs"] = lambda lib: _edit_case(lib, "argdiffs")


def _raised(fn):
    with pytest.raises(Exception) as info:
        fn()
    return info.value


@pytest.mark.parametrize("case", sorted(GFI_CASES))
def test_gfi_checks_match_jax(case):
    ej, et = _raised(lambda: GFI_CASES[case](gj)), \
        _raised(lambda: GFI_CASES[case](gt))
    assert type(et) is type(ej) is TypeError, (ej, et)
    assert _prefix(et) == _prefix(ej), (str(ej), str(et))


CONSTRUCTOR_CASES = {
    "vmap_in_axes_str": lambda lib: lib.normal.vmap(in_axes="a"),
    "vmap_in_axes_float": lambda lib: lib.normal.vmap(in_axes=(0, 1.5)),
    "vmap_decorator_in_axes": lambda lib: lib.vmap(in_axes=[0, {"a": "b"}]),
    "repeat_zero": lambda lib: lib.normal.repeat(n=0),
    "repeat_bool": lambda lib: lib.normal.repeat(n=True),
    "repeat_decorator": lambda lib: lib.repeat(n=2.0),
    "iterate_negative": lambda lib: _model(lib).iterate(n=-1),
    "iterate_final_float": lambda lib: _model(lib).iterate_final(n=1.5),
    "switch_callable": lambda lib: lib.normal.switch(lambda x: x),
    "switch_empty": lambda lib: lib.switch(),
    "switch_decorator": lambda lib: lib.switch(lib.normal, 3),
    "mix_callable": lambda lib: lib.normal.mix("normal"),
    "mix_decorator": lambda lib: lib.mix(lib.normal, None),
    "or_else_callable": lambda lib: lib.normal.or_else(abs),
    "or_else_decorator": lambda lib: lib.or_else(1),
    "dimap_pre": lambda lib: lib.normal.dimap(pre=3),
    "dimap_post": lambda lib: lib.normal.dimap(post="f"),
    "contramap": lambda lib: lib.normal.contramap(2),
}


@pytest.mark.parametrize("case", sorted(CONSTRUCTOR_CASES))
def test_constructor_checks_match_jax(case):
    ej = _raised(lambda: CONSTRUCTOR_CASES[case](gj))
    et = _raised(lambda: CONSTRUCTOR_CASES[case](gt))
    assert type(et) is type(ej), (ej, et)
    assert _prefix(et) == _prefix(ej), (str(ej), str(et))


def test_good_input_passes():
    """Well-formed calls pass every check in the port, batched too."""
    m = _model(gt)
    tr = m.simulate(R.key(1), (0.5,))
    m.assess(tr.get_choices(), (0.5,))
    m.generate(R.key(2), gt.C["x"].set(0.1), (0.5,))
    m.edit(R.key(3), tr, gt.Update(gt.C["x"].set(0.2)),
           gt.Diff.no_change((0.5,)))
    keys = R.split(R.key(4), 3)
    trb = gt.normal.vmap(in_axes=(0, None)).simulate(
        keys, (torch.zeros(3, 2), 1.0))
    assert trb.get_score().shape == (3,)
    for make in (lambda: gt.normal.vmap(in_axes=(0, None)),
                 lambda: gt.normal.repeat(n=2), lambda: m.iterate(n=1),
                 lambda: m.switch(m), lambda: m.mix(m),
                 lambda: m.or_else(m), lambda: m.dimap(pre=lambda x: (x,)),
                 lambda: gt.vmap(in_axes={"a": None, "b": [0, 1]})):
        assert make() is not None


@pytest.mark.parametrize("case", ["simulate_list_args", "fn_assess_list_args",
                                  "generate_list_args", "edit_list_argdiffs"])
def test_no_validation_turns_the_checks_off(case):
    """Under ``no_validation()`` a list in place of the argument tuple
    reaches the method: in both packages it raises no check's error
    (the call runs, or fails downstream with another message)."""
    for lib, ctx in ((gj, jax_no_validation), (gt, no_validation)):
        with ctx():
            try:
                GFI_CASES[case](lib)
            except Exception as e:  # a downstream failure, not the check
                assert "must be a tuple" not in str(e), (lib, e)
    # Outside the context the check is back.
    with pytest.raises(TypeError, match="must be a tuple"):
        GFI_CASES[case](gt)


def test_no_validation_is_scoped_and_nests():
    from genjax_torch.core import validate

    assert validate._enabled
    with no_validation():
        assert not validate._enabled
        with no_validation():
            assert not validate._enabled
        assert not validate._enabled
        tr = gt.normal.simulate(R.key(0), [0.0, 1.0])
        assert torch.isfinite(tr.get_score())
    assert validate._enabled


@pytest.mark.parametrize("combinator", ["vmap", "repeat", "switch"])
def test_combinator_named_arguments_are_ignored(combinator):
    """Inside a ``@gen`` body a combinator called with named arguments
    runs on its positional ones (``IgnoreKwargs``), in both packages."""

    def body(lib):
        if combinator == "vmap":
            gf, args = lib.normal.vmap(in_axes=(0, None)), (
                jnp.arange(3.0) if lib is gj else torch.arange(3.0), 1.0)
        elif combinator == "repeat":
            gf, args = lib.normal.repeat(n=3), (0.5, 2.0)
        else:
            idx = jnp.array(1) if lib is gj else torch.tensor(1)
            gf, args = lib.normal.switch(lib.normal), (idx, (0.0, 1.0),
                                                       (3.0, 0.5))

        @lib.gen
        def named():
            return gf(*args, scale=2.0, unused="a") @ "v"

        @lib.gen
        def positional():
            return gf(*args) @ "v"

        return named, positional

    k = jax.random.key(9)
    nj, pj = body(gj)
    nt, pt = body(gt)
    vj = nj.simulate(k, ()).get_retval()
    vt = nt.simulate(_tkey(k), ()).get_retval()
    assert torch.equal(vt, pt.simulate(_tkey(k), ()).get_retval())
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(np.asarray(vj),
                               np.asarray(pj.simulate(k, ()).get_retval()),
                               rtol=0, atol=0)
    trt = nt.simulate(_tkey(k), ())
    s, _ = nt.assess(trt.get_choices(), ())
    np.testing.assert_allclose(s.numpy(), trt.get_score().numpy(),
                               rtol=1e-6, atol=1e-6)
    new, w, _, _ = trt.edit(_tkey(jax.random.key(10)),
                            gt.Regenerate(gt.Selection.all()))
    assert bool(torch.isfinite(w))
