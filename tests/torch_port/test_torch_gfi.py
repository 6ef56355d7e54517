"""The port's GFI data types and ``@gen`` language against the JAX
package: ChoiceMap / Selection / Mask cases mirrored from
tests/gfi/test_choice_maps.py, and ``assess`` scores / ``generate``
weights / ``simulate`` draws of two ``@gen`` models on the same choices
and key data. Scores agree to f32 precision (1e-5 relative: the two
packages' log, lgamma and log1p differ by an ulp); simulated normals to
a few ulp (see test_torch_random.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import genjax_torch as gt
import genjax_tpu as gj
from genjax_torch.gfi.choice_map import ChoiceMapNoValueAtAddress
from genjax_torch.interop import choice_map_from_numpy, key_from_numpy

C, ChoiceMap, Mask, Selection = gt.C, gt.ChoiceMap, gt.Mask, gt.Selection


class TestConstruction:
    def test_choice(self):
        chm = ChoiceMap.choice(42)
        assert chm.get_value() == 42 and chm.has_value()

    def test_entry_d_kw_builder(self):
        assert ChoiceMap.entry(3.0, "x", "y")["x", "y"] == 3.0
        assert ChoiceMap.entry(3.0, "x", "y")("x")("y").get_value() == 3.0
        chm = ChoiceMap.d({"x": 1, ("y", "z"): 2.0})
        assert chm["x"] == 1 and chm["y", "z"] == 2.0
        kw = ChoiceMap.kw(x=1.0, y=2.0)
        assert kw["x"] == 1.0 and kw["y"] == 2.0
        assert C["x", "y"].set(3.0)["x", "y"] == 3.0

    def test_at_update(self):
        chm = ChoiceMap.d({("x", "y"): 3.0, "z": 12.0})
        updated = chm.at["x", "y"].set(4.0)
        assert updated["x", "y"] == 4.0 and updated["z"] == 12.0

    def test_missing_contains_empty(self):
        chm = ChoiceMap.d({"x": 1})
        with pytest.raises(ChoiceMapNoValueAtAddress):
            chm["nope"]
        assert "x" in chm and "y" not in chm
        assert ChoiceMap.empty().static_is_empty()
        assert not chm.static_is_empty()


class TestMergeAndFilter:
    def test_or_and(self):
        a = ChoiceMap.d({"x": 1.0})
        b = ChoiceMap.d({"x": 2.0, "y": 3.0})
        assert (a | b)["x"] == 1.0 and (a | b)["y"] == 3.0
        both = a & b
        assert both["x"] == 2.0 and "y" not in both

    def test_filter(self):
        chm = ChoiceMap.d({"x": 1.0, "y": 2.0})
        f = chm.filter(Selection.at["x"])
        assert f["x"] == 1.0 and "y" not in f
        g = chm.filter(~Selection.at["x"])
        assert "x" not in g and g["y"] == 2.0

    def test_mask(self):
        chm = ChoiceMap.choice(42)
        assert chm.mask(True).get_value() == 42
        assert chm.mask(False).get_value() is None
        m = ChoiceMap.choice(torch.tensor(42.0)).mask(
            torch.tensor(True)).get_value()
        assert isinstance(m, Mask) and m.unmask() == 42.0
        off = ChoiceMap.choice(torch.tensor(5.0)).mask(torch.tensor(False))
        assert off.get_value().unmask(default=torch.tensor(-1.0)) == -1.0

    def test_filter_rejects_non_bool_flags(self):
        with pytest.raises(TypeError, match="boolean flag"):
            ChoiceMap.choice(1.0).filter(torch.tensor(1.0))

    def test_extend_and_selection(self):
        assert ChoiceMap.choice(42).extend("x")["x"] == 42
        sel = ChoiceMap.d({"x": 1.0}).get_selection()
        assert sel["x"] is True and not bool(sel["y"])


class TestSwitchAndIndexed:
    def test_switch(self):
        chm1 = ChoiceMap.d({"x": 1.0, "y": 2.0})
        chm2 = ChoiceMap.d({"x": 3.0, "y": 4.0})
        assert ChoiceMap.switch(1, [chm1, chm2])["x"] == 3.0
        out = ChoiceMap.switch(torch.tensor(1), [chm1, chm2])
        assert out["x"].unmask() == 3.0 and out["y"].unmask() == 4.0

    def test_scalar_dynamic_extend(self):
        chm = ChoiceMap.entry(5.0, torch.tensor(3))
        assert Mask.build(chm.get_submap(3).get_value()).unmask() == 5.0
        missing = chm.get_submap(2).get_value()
        assert missing is None or not bool(Mask.build(missing).flag)

    def test_full_slice_builder(self):
        xs = torch.arange(4.0)
        c = C[:].set({"x": xs})
        assert torch.equal(c[:, "x"], xs) and float(c[2, "x"]) == 2.0
        with pytest.raises(ValueError, match="full slice"):
            C[::2].set({"x": xs})

    def test_choice_dynamic_index_laws(self):
        arr = torch.arange(12.0).reshape(4, 3)
        chm = ChoiceMap.choice(arr)
        for i in range(4):
            assert torch.equal(chm.get_submap(i).get_value(), arr[i])
        assert torch.equal(chm.get_submap(torch.tensor(2)).get_value(), arr[2])
        assert ChoiceMap.choice(arr).get_submap("x").static_is_empty()
        a = ChoiceMap.choice(torch.arange(4.0))
        b = ChoiceMap.entry(torch.ones(4), torch.arange(4), "x")
        assert float((a | b).get_submap(2).get_value()) == 2.0
        sw = ChoiceMap.switch(torch.tensor(0),
                              [a, ChoiceMap.choice(-torch.arange(4.0))])
        v = sw.get_submap(3).get_value()
        assert float(v.unmask() if isinstance(v, Mask) else v) == 3.0
        with pytest.raises(ValueError, match="full slice"):
            a.get_submap(slice(0, 2))

    def test_split_path(self):
        chm = ChoiceMap.d({"a": 1.0, ("b", "c"): 2.0, ("b", "d", "e"): 3.0})
        for path, value in ((("a",), 1.0), (("b", "c"), 2.0),
                            (("b", "d", "e"), 3.0)):
            for i in range(len(path) + 1):
                sub = chm.get_submap(*path[:i])
                got = sub[path[i:]] if path[i:] else sub.get_value()
                assert got == value


class TestSelectionAndMask:
    def test_selection_algebra(self):
        s = Selection.at["x"] | Selection.at["y"]
        assert "x" in s and "y" in s and "z" not in s
        assert "x" not in ~Selection.at["x"]
        assert "x" not in Selection.at["x"].mask(False)
        assert bool(Selection.at["x"].mask(torch.tensor(True))["x"])

    def test_mask_or_xor(self):
        a = Mask(torch.tensor([1.0, 2.0]), torch.tensor([True, False]))
        b = Mask(torch.tensor([3.0, 4.0]), torch.tensor([False, True]))
        o = a | b
        assert o.value.tolist() == [1.0, 4.0] and o.flag.all()
        x = a ^ a
        assert not x.flag.any()


def _models(lib):
    @lib.gen
    def beta_bernoulli(a, b):
        p = lib.beta(a, b) @ "p"
        return lib.flip(p) @ "v"

    @lib.gen
    def chain(mu):
        x = lib.normal(mu, 1.0) @ "x"
        y = lib.normal(x, 0.5) @ "y"
        z = lib.normal(x + y, 2.0) @ "z"
        return z

    return beta_bernoulli, chain


BB_CHOICES = [{"p": 0.3, "v": True}, {"p": 0.9, "v": False},
              {"p": 0.01, "v": True}]
CHAIN_CHOICES = [{"x": 0.1, "y": -0.4, "z": 2.0},
                 {"x": 3.0, "y": 2.5, "z": -1.0}]


def _jax_chm(d):
    return gj.ChoiceMap.d({k: jnp.asarray(v) for k, v in d.items()})


def _torch_chm(d):
    return choice_map_from_numpy({k: np.asarray(v) for k, v in d.items()})


@pytest.mark.parametrize("which,choices,args", [
    (0, c, (2.0, 2.0)) for c in BB_CHOICES] + [
    (1, c, (0.5,)) for c in CHAIN_CHOICES])
def test_assess_and_generate_match_jax(which, choices, args):
    mj, mt = _models(gj)[which], _models(gt)[which]
    sj, _ = mj.assess(_jax_chm(choices), args)
    st, _ = mt.assess(_torch_chm(choices), args)
    np.testing.assert_allclose(float(st), float(sj), rtol=1e-5, atol=1e-6)
    k = jax.random.key(7)
    kt = key_from_numpy(np.asarray(jax.random.key_data(k)))
    first = next(iter(choices))
    for part in (choices, {first: choices[first]}):
        _, wj = mj.generate(k, _jax_chm(part), args)
        trt, wt = mt.generate(kt, _torch_chm(part), args)
        np.testing.assert_allclose(float(wt), float(wj), rtol=1e-5,
                                   atol=1e-6)
        if part is choices:
            # fully constrained: the trace's score is the assess score
            np.testing.assert_allclose(float(trt.get_score()), float(sj),
                                       rtol=1e-5, atol=1e-6)


def test_simulate_draws_match_jax():
    _, cj = _models(gj)
    _, ct = _models(gt)
    k = jax.random.key(3)
    trj = cj.simulate(k, (0.5,))
    trt = ct.simulate(key_from_numpy(np.asarray(jax.random.key_data(k))),
                      (0.5,))
    for a in ("x", "y", "z"):
        np.testing.assert_allclose(float(trt.get_choices()[a]),
                                   float(trj.get_choices()[a]), rtol=1e-5,
                                   atol=1e-6)
    np.testing.assert_allclose(float(trt.get_score()),
                               float(trj.get_score()), rtol=1e-5)


def test_batched_keys_run_independent_executions():
    _, ct = _models(gt)
    keys = gt.random.split(gt.random.key(0), 5)
    batched = ct.simulate(keys, (0.5,))
    assert batched.get_score().shape == (5,)
    for i in range(5):
        one = ct.simulate(keys[i], (0.5,))
        assert torch.equal(one.get_choices()["z"], batched.get_choices()["z"][i])
        assert torch.allclose(one.get_score(), batched.get_score()[i])
    # generate under a key batch: the weight is per execution
    _, w = ct.generate(keys, C["z"].set(1.0), (0.5,))
    assert w.shape == (5,)


def test_project_and_empty_trace_and_invalid_subset():
    _, ct = _models(gt)
    tr = ct.simulate(gt.random.key(1), (0.0,))
    w = tr.project(gt.random.key(2), Selection.at["x"])
    assert torch.allclose(w, tr.subtraces[0].get_score())
    zero = gt.empty_trace(ct, (0.0,))
    assert float(zero.get_choices()["x"]) == 0.0
    bad = C["x"].set(1.0) | C["tpyo"].set(2.0)
    assert bad.invalid_subset(ct, (0.0,))["tpyo"] == 2.0
    assert (C["x"].set(1.0) | C["y"].set(0.5)).invalid_subset(ct, (0.0,)) \
        is None


def test_language_errors():
    @gt.gen
    def reuse():
        gt.normal(0.0, 1.0) @ "x"
        gt.normal(0.0, 1.0) @ "x"

    with pytest.raises(gt.AddressReuse):
        reuse.simulate(gt.random.key(0), ())
    _, ct = _models(gt)
    with pytest.raises(gt.MissingAddress):
        ct.assess(C["x"].set(1.0), (0.0,))
    # The combinators and marginal are served now; marginal refuses a
    # selection that is not a Selection, as the JAX package does.
    assert isinstance(ct.switch(ct), gt.Switch)
    assert isinstance(ct.marginal(), gt.inference.Marginal)
    with pytest.raises(TypeError, match="expects a Selection"):
        ct.marginal(selection="x")
    with pytest.raises(RuntimeError, match="@gen"):
        gt.normal(0.0, 1.0) @ "x"


@pytest.mark.parametrize("n", [3, 4])
def test_indexed_lane_axis_follows_the_batch(n):
    """An ``Indexed`` node whose leaves carry a particle batch of 4 in
    front of the lane axis: the lane is read at the explicit position
    (batch rank, then lane), so with n = 4 lanes, the batch's own
    length, a lookup still equals the per-particle one, for an int, a
    0-d tensor and one lane per particle."""
    from genjax_torch.gfi.choice_map import Indexed

    v = torch.arange(4.0 * n).reshape(4, n)
    batched = Indexed(ChoiceMap.d({"x": v}), None, n, batch_rank=1)
    for lane in range(n):
        want = torch.stack([
            Indexed(ChoiceMap.d({"x": v[p]}), None, n)[lane, "x"]
            for p in range(4)])
        assert torch.equal(batched[lane, "x"], want)
        got = batched.get_submap(torch.tensor(lane))["x"]
        assert torch.equal(Mask.build(got).value, want)
    per = torch.tensor([n - 1, 0, 1, n - 1])
    got = batched.get_submap(per)["x"]
    assert torch.equal(Mask.build(got).value, v[torch.arange(4), per])
    # The same through a Vmap trace on a key batch of 4 particles.
    @gt.gen
    def lane(mu):
        return gt.normal(mu, 1.0) @ "x"

    keys = gt.random.split(gt.random.key(3), 4)
    mus = torch.arange(float(n)).expand(4, n)
    tr = lane.vmap().simulate(keys, (mus,))
    for i in range(n):
        per_particle = torch.stack([
            lane.vmap().simulate(keys[p], (mus[p],)).get_choices()[i, "x"]
            for p in range(4)])
        assert torch.equal(tr.get_choices()[i, "x"], per_particle)


def test_checked_unmask_and_staging_helpers():
    off = Mask(torch.tensor([1.0, 2.0]), torch.tensor([True, False]))
    assert torch.equal(off.unmask(), off.value)      # unchecked by default
    with pytest.raises(ValueError, match="flag False"):
        off.unmask(checked=True)
    a, b = {"x": torch.tensor([1.0, 2.0])}, {"x": torch.tensor([3.0, 4.0])}
    assert gt.tree_choose(1, [a, b]) is b
    picked = gt.tree_choose(torch.tensor([1, 0]), [a, b])
    assert picked["x"].tolist() == [3.0, 2.0]
    branches = [lambda v: v + 1.0, lambda v: {"y": v * 2.0}]
    args = [(torch.tensor(1.0),), (torch.tensor(5.0),)]
    outs = gt.multi_switch(1, branches, args)
    assert float(outs[0]) == 0.0 and float(outs[1]["y"]) == 10.0
    outs = gt.multi_switch(torch.tensor([0, 1]), branches,
                           [(torch.tensor([1.0, 1.0]),),
                            (torch.tensor([5.0, 5.0]),)])
    assert outs[0].tolist() == [2.0, 0.0]
    assert outs[1]["y"].tolist() == [0.0, 10.0]
