"""Randomized GFI contract properties of the port over composed model
structures (counterpart of ``tests/gfi/test_contract_properties.py``):
nested ``@gen``, Scan, Vmap, Switch, Mask, or_else and mix, each with
discrete and continuous sites.

1. ``assess(get_choices())`` equals the simulate score;
2. ``generate`` under the full choices weighs the score;
3. ``project(all)`` equals the score;
4. an ``Update`` to the same choices weighs 0 and keeps the score;
5. the Regenerate prior-proposal identity: the weight is the score
   change less the selected sites' own density change, and an
   ``Update`` that puts the old values back lands on the old trace with
   the opposite score change.

The hypothesis sweeps draw the structure, the key and the argument; the
default examples keep the tier-1 run short, and the ``slow`` variants
sweep 10 times wider. The same identities run on a key batch of 5
executions (each structure's per-execution path: one Switch index, Mask
flag and mix component per execution), and over nested compositions.

Tolerance: 1e-5 relative and 1e-6 absolute on scores and weights (one
f32 computation against another of the same terms), 1e-5 absolute on a
weight that should be 0."""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import genjax_torch as g
from genjax_torch.core import random as R
from genjax_torch.gfi.requests import Regenerate, Update
from genjax_torch.gfi.selection import Selection

TOL = dict(rtol=1e-5, atol=1e-6)


def _np(x):
    return np.asarray(torch.as_tensor(x).detach(), np.float64)


def close(a, b, **kw):
    np.testing.assert_allclose(_np(a), _np(b), **(kw or TOL))


def _lift(args, batch):
    """``args`` for a key batch: every number becomes a per-execution
    tensor (the executions differ by a shift), every tensor is expanded;
    Python bools stay shared."""
    if not batch:
        return args
    shift = torch.linspace(-0.5, 0.5, batch[0])

    def lift(v):
        if isinstance(v, bool):
            return v
        if isinstance(v, float):
            return v + shift
        if isinstance(v, torch.Tensor):
            if v.dtype == torch.bool:
                return v.expand(batch + tuple(v.shape))
            return v.expand(batch + tuple(v.shape)).clone()
        if isinstance(v, tuple):
            return tuple(lift(x) for x in v)
        return v

    return lift(args)


def _make_model(structure: str, mu: float, batch: tuple = ()):
    @g.gen
    def leaf(shift):
        a = g.normal(shift, 1.0) @ "a"
        b = g.flip(0.3) @ "b"
        c = g.gamma(2.0, 2.0) @ "c"
        return a + torch.where(b, 1.0, 0.0) + c

    if structure == "nested":
        @g.gen
        def model(shift):
            x = leaf(shift) @ "inner"
            return g.normal(x, 0.5) @ "y"

        return model, _lift((mu,), batch)
    if structure == "scan":
        @g.gen
        def step(carry, x):
            z = g.normal(carry * 0.5, 1.0) @ "z"
            return z, z

        return step.scan(n=4), _lift((mu, torch.zeros(4)), batch)
    if structure == "vmap":
        return (leaf.vmap(in_axes=(0,)),
                _lift((mu + torch.arange(3.0),), batch))
    if structure == "mask":
        flag = mu > 0.0
        if batch:
            flag = torch.linspace(-1.0, 1.0, batch[0]) + mu > 0.0
        return leaf.mask(), (flag,) + _lift((mu,), batch)
    if structure == "or_else":
        @g.gen
        def other(shift):
            return g.gamma(2.0, 2.0) @ "c2"

        flag = mu > 0.0
        if batch:
            flag = torch.linspace(-1.0, 1.0, batch[0]) + mu > 0.0
        return leaf.or_else(other), (flag,) + _lift(((mu,), (mu,)), batch)
    if structure == "mix":
        @g.gen
        def c0(shift):
            return g.normal(shift, 1.0) @ "v"

        @g.gen
        def c1(shift):
            return g.normal(-shift, 2.0) @ "v"

        return c0.mix(c1), _lift((torch.log(torch.tensor([0.3, 0.7])),
                                  (mu,), (mu,)), batch)
    if structure == "switch":
        @g.gen
        def br0(shift):
            return g.normal(shift, 1.0) @ "v"

        @g.gen
        def br1(shift):
            return g.gamma(2.0, 2.0) @ "v"

        @g.gen
        def model(shift):
            idx = g.categorical(torch.log(torch.tensor([0.5, 0.5]))) @ "idx"
            return br0.switch(br1)(idx, (shift,), (shift,)) @ "sw"

        return model, _lift((mu,), batch)
    raise ValueError(structure)


STRUCTURES = ["nested", "scan", "vmap", "switch", "mask", "or_else", "mix"]


def _simulate_assess_generate_project(structure, seed, mu, batch=()):
    model, args = _make_model(structure, mu, batch)
    key = R.key(seed)
    if batch:
        key = R.split(key, batch[0])
    tr = model.simulate(key, args)
    score = tr.get_score()
    assert tuple(score.shape) == batch
    chm = tr.get_choices()
    assess_score, _ = model.assess(chm, args, batch=batch)
    close(assess_score, score)
    tr2, w = model.generate(R.fold_in(key, 1), chm, args)
    close(w, score)
    close(tr2.get_score(), score)
    close(tr.project(R.fold_in(key, 2), Selection.all()), score)


def _update_same_choices(structure, seed, batch=()):
    model, args = _make_model(structure, 0.5, batch)
    key = R.key(seed)
    if batch:
        key = R.split(key, batch[0])
    tr = model.simulate(key, args)
    new_tr, w, _, _ = tr.edit(R.fold_in(key, 1), Update(tr.get_choices()))
    close(w, torch.zeros(batch), atol=1e-5)
    close(new_tr.get_score(), tr.get_score(), rtol=1e-6)


REGENERATE_SELECTIONS = {
    "nested": Selection.at["inner", "a"],
    "scan": Selection.at[1, "z"],
    "vmap": Selection.at[0, "a"],
}


def _regenerate_and_restore(structure, seed, batch=()):
    model, args = _make_model(structure, 0.5, batch)
    key = R.key(seed)
    if batch:
        key = R.split(key, batch[0])
    tr = model.simulate(key, args)
    sel = REGENERATE_SELECTIONS[structure]
    mid, w_fwd, _, _ = tr.edit(R.fold_in(key, 1), Regenerate(sel))
    d_score = mid.get_score().double() - tr.get_score().double()
    pk = R.fold_in(key, 9)
    d_self = mid.project(pk, sel).double() - tr.project(pk, sel).double()
    close(w_fwd, d_score - d_self, rtol=1e-5, atol=1e-5)
    restore = tr.get_choices().filter(sel)
    back, w_back, _, _ = mid.edit(R.fold_in(key, 2), Update(restore))
    close(back.get_score(), tr.get_score(), rtol=1e-5)
    close(w_back, -d_score, rtol=1e-5, atol=1e-5)


class TestRandomizedContracts:
    @given(st.sampled_from(STRUCTURES), st.integers(0, 2**16),
           st.floats(-2.0, 2.0))
    @settings(max_examples=16, deadline=None)
    def test_simulate_assess_generate_project(self, structure, seed, mu):
        _simulate_assess_generate_project(structure, seed, mu)

    @given(st.sampled_from(STRUCTURES), st.integers(0, 2**16))
    @settings(max_examples=12, deadline=None)
    def test_update_same_choices_weight_zero(self, structure, seed):
        _update_same_choices(structure, seed)

    @given(st.sampled_from(sorted(REGENERATE_SELECTIONS)),
           st.integers(0, 2**16))
    @settings(max_examples=12, deadline=None)
    def test_regenerate_weight_and_update_restore(self, structure, seed):
        _regenerate_and_restore(structure, seed)


@pytest.mark.slow
class TestRandomizedContractsWide:
    """The sweeps above at 10 times the examples (left out of tier 1)."""

    @given(st.sampled_from(STRUCTURES), st.integers(0, 2**16),
           st.floats(-2.0, 2.0))
    @settings(max_examples=160, deadline=None)
    def test_simulate_assess_generate_project(self, structure, seed, mu):
        _simulate_assess_generate_project(structure, seed, mu)

    @given(st.sampled_from(STRUCTURES), st.integers(0, 2**16))
    @settings(max_examples=120, deadline=None)
    def test_update_same_choices_weight_zero(self, structure, seed):
        _update_same_choices(structure, seed)

    @given(st.sampled_from(sorted(REGENERATE_SELECTIONS)),
           st.integers(0, 2**16))
    @settings(max_examples=120, deadline=None)
    def test_regenerate_weight_and_update_restore(self, structure, seed):
        _regenerate_and_restore(structure, seed)


class TestBatchedContracts:
    """The identities on a key batch of 5 executions, per structure."""

    @pytest.mark.parametrize("structure", STRUCTURES)
    def test_simulate_assess_generate_project(self, structure):
        _simulate_assess_generate_project(structure, 11, 0.25, (5,))

    @pytest.mark.parametrize("structure", STRUCTURES)
    def test_update_same_choices_weight_zero(self, structure):
        _update_same_choices(structure, 12, (5,))

    @pytest.mark.parametrize("structure", sorted(REGENERATE_SELECTIONS))
    def test_regenerate_weight_and_update_restore(self, structure):
        _regenerate_and_restore(structure, 13, (5,))


class TestMaskedOffAssess:
    def test_simulate_assess_roundtrip_static_false(self):
        """A trace masked off by a Python False has no choices: assess
        scores 0 with a masked-off return value, and generate agrees."""

        @g.gen
        def inner(shift):
            return g.normal(shift, 1.0) @ "a"

        model = inner.mask()
        tr = model.simulate(R.key(0), (False, 0.5))
        assert float(tr.get_score()) == 0.0
        score, retval = model.assess(tr.get_choices(), (False, 0.5))
        assert float(score) == 0.0
        assert not bool(retval.flag)
        _, w = model.generate(R.key(1), tr.get_choices(), (False, 0.5))
        assert float(w) == 0.0


class TestNestedCompositionContracts:
    """The core identities over nested compositions: Scan of Switch (a
    per-step index), Vmap of Mask (a per-lane flag), repeat, Dimap, a
    mix inside Vmap and a three-deep nest."""

    def _make(self, structure):
        if structure == "scan_of_switch":
            @g.gen
            def b0(shift):
                return g.normal(shift, 1.0) @ "v"

            @g.gen
            def b1(shift):
                return g.normal(-shift, 2.0) @ "v"

            @g.gen
            def step(carry, x):
                idx = g.flip(0.4) @ "pick"
                out = b0.switch(b1)(idx.to(torch.int64), (carry,),
                                    (carry,)) @ "sw"
                return out * 0.5, out

            return step.scan(n=3), (0.5, torch.zeros(3))
        if structure == "vmap_of_mask":
            @g.gen
            def inner(shift):
                return g.normal(shift, 1.0) @ "a"

            return inner.mask().vmap(in_axes=(0, 0)), (
                torch.tensor([True, False, True]), torch.arange(3.0))
        if structure == "repeat":
            @g.gen
            def inner(shift):
                return g.normal(shift, 1.0) @ "a"

            return inner.repeat(n=4), (0.5,)
        if structure == "dimap":
            @g.gen
            def inner(shift):
                a = g.normal(shift, 1.0) @ "a"
                b = g.gamma(2.0, 2.0) @ "b"
                return a + b

            return inner.dimap(pre=lambda s: (s * 2.0,),
                               post=lambda args, r: r - 1.0), (0.25,)
        if structure == "vmap_of_mix":
            @g.gen
            def c0(shift):
                return g.normal(shift, 1.0) @ "v"

            @g.gen
            def c1(shift):
                return g.normal(-shift, 2.0) @ "w"

            logits = torch.log(torch.tensor([0.4, 0.6])).expand(3, 2)
            return c0.mix(c1).vmap(in_axes=(0, 0, 0)), (
                logits, (torch.arange(3.0),), (torch.arange(3.0),))
        if structure == "three_deep":
            @g.gen
            def leaf(s):
                return g.normal(s, 1.0) @ "x"

            @g.gen
            def mid(s):
                return leaf.or_else(leaf)(s > 0.0, (s,), (-s,)) @ "oe"

            @g.gen
            def top(s):
                a = mid(s) @ "m"
                return mid(a) @ "m2"

            return top.vmap(in_axes=(0,)), (torch.tensor([-1.0, 0.5]),)
        raise ValueError(structure)

    @pytest.mark.parametrize(
        "structure", ["scan_of_switch", "vmap_of_mask", "repeat", "dimap",
                      "vmap_of_mix", "three_deep"])
    def test_identities(self, structure):
        model, args = self._make(structure)
        for seed in range(3):
            key = R.key(seed * 13 + 5)
            tr = model.simulate(key, args)
            score = tr.get_score()
            chm = tr.get_choices()
            s2, _ = model.assess(chm, args)
            close(s2, score)
            _, w = model.generate(R.fold_in(key, 1), chm, args)
            close(w, score)
            _, wu, _, _ = tr.edit(R.fold_in(key, 2), Update(chm))
            close(wu, 0.0, atol=1e-5)


# -- the request cells: IndexRequest, StaticRequest mixes, DiffAnnotate ----

INDEX_CASES = {
    "vmap": (3, Selection.at["a"], lambda i: Selection.at[i, "a"]),
    "scan": (4, Selection.at["z"], lambda i: Selection.at[i, "z"]),
}


def _index_request(structure, seed, idx):
    """``IndexRequest(i, Regenerate)`` keeps the prior-proposal identity
    of the whole-trace request at lane or step ``i``, and an ``Update``
    that puts the old values back restores the score."""
    model, args = _make_model(structure, 0.5)
    _, sub_sel, global_sel = INDEX_CASES[structure]
    key = R.key(seed)
    tr = model.simulate(key, args)
    mid, w_fwd, _, _ = tr.edit(R.fold_in(key, 1),
                               g.IndexRequest(idx, Regenerate(sub_sel)))
    d_score = mid.get_score().double() - tr.get_score().double()
    pk = R.fold_in(key, 9)
    sel = global_sel(idx)
    d_self = mid.project(pk, sel).double() - tr.project(pk, sel).double()
    close(w_fwd, d_score - d_self, rtol=1e-5, atol=1e-5)
    back, w_back, _, _ = mid.edit(R.fold_in(key, 2),
                                  Update(tr.get_choices().filter(sel)))
    close(back.get_score(), tr.get_score(), rtol=1e-5)
    close(w_back, -d_score, rtol=1e-5, atol=1e-5)


def _index_request_per_execution(structure, seed):
    """A per-execution index on a key batch edits each execution as the
    int index edits it alone (1e-6)."""
    n, sub_sel, _ = INDEX_CASES[structure]
    model, args = _make_model(structure, 0.5, (5,))
    keys = R.split(R.key(seed), 5)
    ekeys = R.split(R.key(seed + 1), 5)
    idx = torch.tensor([0, n - 1, 1, n - 2, 0])
    tr = model.simulate(keys, args)
    new, w, _, _ = tr.edit(ekeys, g.IndexRequest(idx, Regenerate(sub_sel)))
    for p in range(5):
        one_model, one_args = _make_model(structure, 0.5 + (p - 2) * 0.25)
        one = one_model.simulate(keys[p], one_args)
        n1, w1, _, _ = one.edit(ekeys[p], g.IndexRequest(
            int(idx[p]), Regenerate(sub_sel)))
        close(w[p], w1, rtol=1e-6, atol=1e-6)
        close(new.get_score()[p], n1.get_score(), rtol=1e-6, atol=1e-6)


def _static_request_mix(seed):
    """A ``StaticRequest`` that regenerates one site and constrains
    another weighs the score change less the regenerated site's own
    density change; an ``Update`` with the old values restores."""
    model, args = _make_model("nested", 0.5)
    key = R.key(seed)
    tr = model.simulate(key, args)
    req = g.StaticRequest({"inner": g.StaticRequest({
        "a": Regenerate(Selection.all()),
        "c": Update(g.ChoiceMap.choice(torch.tensor(1.75)))})})
    mid, w, _, bwd = tr.edit(R.fold_in(key, 1), req)
    assert isinstance(bwd, g.StaticRequest)
    d_score = mid.get_score().double() - tr.get_score().double()
    sel = Selection.at["inner", "a"]
    pk = R.fold_in(key, 9)
    d_self = mid.project(pk, sel).double() - tr.project(pk, sel).double()
    close(w, d_score - d_self, rtol=1e-5, atol=1e-5)
    assert float(mid.get_choices()["inner", "c"]) == 1.75
    restore = tr.get_choices().filter(sel | Selection.at["inner", "c"])
    back, w_back, _, _ = mid.edit(R.fold_in(key, 2), Update(restore))
    close(back.get_score(), tr.get_score(), rtol=1e-5)
    close(w_back, -d_score, rtol=1e-5, atol=1e-5)


def _diff_annotate(structure, seed):
    """Marking unchanged arguments as changed is a sound coercion: the
    annotated ``Update`` of the same choices still weighs 0, and, where
    no branch index is among the arguments, an annotated empty
    ``Update`` keeps the score. (A Switch whose index is marked changed
    serves the index-change path, which draws the branch anew under a
    partial constraint, in both packages.)"""
    model, args = _make_model(structure, 0.5)
    key = R.key(seed)
    tr = model.simulate(key, args)
    ann = g.DiffAnnotate(Update(tr.get_choices()),
                         argdiff_fn=g.Diff.unknown_change)
    new, w, _, _ = tr.edit(R.fold_in(key, 1), ann)
    close(w, torch.zeros(()), atol=1e-5)
    close(new.get_score(), tr.get_score(), rtol=1e-6)
    if structure in ("switch", "or_else", "mix"):
        return
    ann = g.DiffAnnotate(Update(g.ChoiceMap.empty()),
                         argdiff_fn=g.Diff.unknown_change,
                         retdiff_fn=g.Diff.no_change)
    new, w, rd, _ = tr.edit(R.fold_in(key, 2), ann)
    close(w, torch.zeros(()), atol=1e-5)
    close(new.get_score(), tr.get_score(), rtol=1e-6)
    assert g.Diff.static_check_no_change(rd)


class TestRequestContracts:
    """The contract sweep's request cells (IndexRequest on Vmap and Scan,
    StaticRequest mixes, DiffAnnotate), each parametrised over seeds."""

    @pytest.mark.parametrize("seed", [0, 1, 2])
    @pytest.mark.parametrize("structure,idx", [("vmap", 0), ("vmap", 2),
                                               ("scan", 1), ("scan", 3)])
    def test_index_request(self, structure, idx, seed):
        _index_request(structure, seed, idx)

    @pytest.mark.parametrize("seed", [0, 1])
    @pytest.mark.parametrize("structure", sorted(INDEX_CASES))
    def test_index_request_per_execution(self, structure, seed):
        _index_request_per_execution(structure, seed)

    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_static_request_mix(self, seed):
        _static_request_mix(seed)

    @pytest.mark.parametrize("seed", [0, 1])
    @pytest.mark.parametrize("structure", STRUCTURES)
    def test_diff_annotate(self, structure, seed):
        _diff_annotate(structure, seed)
