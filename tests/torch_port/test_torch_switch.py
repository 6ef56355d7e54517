"""The port's Switch, mix and or_else against the JAX package on the same
key data: simulate, assess, generate, project and edit with a Python-int
index and with one index per execution; the index-change edit weights
(the full-constraint Update equals the JAX package's, the partial one
follows the generate-weight rule where the JAX package returns the score
difference, the Regenerate weighs 0); the construction caches; the
``PerBranch`` support transforms; zero-length Scan; and
``Selection.leaf`` / ``Selection.idx_above``.

Tolerance: scores, weights and values to 1e-5 relative and 1e-5 absolute
(normals agree with JAX's to a few ulp); categorical draws exactly; the
MH posterior within 4 standard errors of the closed form."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats as st
import torch

import genjax_torch as gt
import genjax_tpu as gj
from genjax_torch.core import random as R
from genjax_torch.inference import transforms as tt
from genjax_torch.inference.requests.hmc import selection_gradient
from genjax_torch.interop import key_from_numpy
from genjax_tpu.inference import transforms as jtt

TOL = dict(rtol=1e-5, atol=1e-5)
KEY = jax.random.key(20261017)


def _tkey(k):
    return key_from_numpy(np.asarray(jax.random.key_data(k)))


def _np(x):
    if isinstance(x, (gt.Mask, gj.Mask)):
        x = x.value
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy().astype(np.float64)
    return np.asarray(x, np.float64)


def close(a, b, **kw):
    np.testing.assert_allclose(_np(a), _np(b), **(kw or TOL))


def _branches(lib):
    """Normal branches with different addresses, one with two sites."""

    @lib.gen
    def b0():
        return lib.normal(0.0, 1.0) @ "x"

    @lib.gen
    def b1():
        y = lib.normal(10.0, 2.0) @ "y"
        z = lib.normal(y, 0.5) @ "z"
        return y + z

    return b0, b1


def _switch(lib):
    return lib.switch(*_branches(lib))


INDICES = {
    "int0": (0, 0),
    "int1": (1, 1),
    "int_oob": (1, 7),  # the JAX package clamps only a traced index
    "tensor": (jnp.asarray(1), torch.tensor(1)),
}


@pytest.mark.parametrize("case", sorted(INDICES))
def test_simulate_assess_generate_project_match_jax(case):
    idx_j, idx_t = INDICES[case]
    sj, st_ = _switch(gj), _switch(gt)
    args_j, args_t = (idx_j, (), ()), (idx_t, (), ())
    trj = sj.simulate(KEY, args_j)
    trt = st_.simulate(_tkey(KEY), args_t)
    close(trt.get_score(), trj.get_score())
    close(trt.get_retval(), trj.get_retval())
    live = "x" if case == "int0" else "y"
    close(trt.get_choices()[live], trj.get_choices()[live])
    s, r = st_.assess(trt.get_choices(), args_t)
    close(s, trt.get_score())
    close(r, trt.get_retval())
    k2 = jax.random.fold_in(KEY, 2)
    _, wj = sj.generate(k2, trj.get_choices(), args_j)
    _, wt = st_.generate(_tkey(k2), trt.get_choices(), args_t)
    close(wt, wj)
    close(wt, trt.get_score())
    k3 = jax.random.fold_in(KEY, 3)
    sel_j = gj.Selection.at["y"] | gj.Selection.at["x"]
    sel_t = gt.Selection.at["y"] | gt.Selection.at["x"]
    close(trt.project(_tkey(k3), sel_t), trj.project(k3, sel_j))
    close(trt.project(_tkey(k3), gt.Selection.all()), trt.get_score())


def test_python_int_index_runs_one_branch():
    calls = []

    @gt.gen
    def b0():
        calls.append(0)
        return gt.normal(0.0, 1.0) @ "x"

    @gt.gen
    def b1():
        calls.append(1)
        return gt.normal(0.0, 1.0) @ "x"

    tr = gt.switch(b0, b1).simulate(R.key(0), (1, (), ()))
    assert calls == [1]
    assert tr.subtraces[0] is None
    calls.clear()
    gt.switch(b0, b1).simulate(R.key(0), (torch.tensor(1), (), ()))
    assert calls == [0, 1]


def test_per_execution_index_matches_jax_lane_by_lane():
    """A key batch of 6 with one index each (two out of range, which
    clamp) against ``jax.vmap`` of the unbatched call on the same keys."""
    sj, st_ = _switch(gj), _switch(gt)
    keys = jax.random.split(KEY, 6)
    idx = np.array([0, 1, 1, 0, 5, -1])
    trj = jax.vmap(lambda k, i: sj.simulate(k, (i, (), ())))(
        keys, jnp.asarray(idx))
    trt = st_.simulate(_tkey(keys), (torch.as_tensor(idx), (), ()))
    close(trt.get_score(), trj.get_score())
    close(trt.get_retval(), trj.get_retval())
    taken = np.clip(idx, 0, 1)
    x = trt.get_choices()["x"]
    assert isinstance(x, gt.Mask)
    np.testing.assert_array_equal(x.flag.numpy(), taken == 0)
    close(x.value[taken == 0], np.asarray(trj.get_choices()["x"].value)[
        taken == 0])
    s, _ = st_.assess(trt.get_choices(), (torch.as_tensor(idx), (), ()),
                      batch=(6,))
    close(s, trt.get_score())
    k2 = jax.random.fold_in(KEY, 5)
    pj = jax.vmap(lambda tr: tr.project(k2, gj.Selection.at["y"]))(trj)
    pt = trt.project(_tkey(k2).expand(6, 2), gt.Selection.at["y"])
    close(pt, pj)


def test_unchanged_index_update_matches_jax_and_round_trips():
    sj, st_ = _switch(gj), _switch(gt)
    trj = sj.simulate(KEY, (1, (), ()))
    trt = st_.simulate(_tkey(KEY), (1, (), ()))
    k = jax.random.fold_in(KEY, 1)
    nj, wj, _, bj = trj.update(k, gj.C["y"].set(11.0))
    nt, wt, _, bt = trt.update(_tkey(k), gt.C["y"].set(11.0))
    close(wt, wj)
    close(wt, nt.get_score() - trt.get_score())
    close(bt["y"], trj.get_choices()["y"])
    back, wb, _, _ = nt.update(_tkey(k), bt)
    close(wb, -wt)
    close(back.get_score(), trt.get_score())


def _index_change(lib, idx_new):
    return (lib.Diff(idx_new, lib.UnknownChange), lib.Diff((), lib.NoChange),
            lib.Diff((), lib.NoChange))


@pytest.mark.parametrize("per_execution", [False, True])
def test_index_change_update_full_constraint_equals_jax(per_execution):
    """From branch 0 to branch 1 with every new choice constrained: the
    weight is the score difference, in both packages."""
    sj, st_ = _switch(gj), _switch(gt)
    i0, i1 = ((torch.tensor(0), torch.tensor(1)) if per_execution
              else (0, 1))
    trj = sj.simulate(KEY, (0, (), ()))
    trt = st_.simulate(_tkey(KEY), (i0, (), ()))
    k = jax.random.fold_in(KEY, 1)
    full_j = gj.C["y"].set(9.5) | gj.C["z"].set(9.0)
    full_t = gt.C["y"].set(9.5) | gt.C["z"].set(9.0)
    nj, wj, _, _ = sj.edit(k, trj, gj.Update(full_j), _index_change(gj, 1))
    nt, wt, _, bwd = st_.edit(_tkey(k), trt, gt.Update(full_t),
                              _index_change(gt, i1))
    close(wt, wj)
    close(wt, nt.get_score() - trt.get_score())
    close(nt.get_score(), nj.get_score())
    # The backward request carries every old choice: replayed at the old
    # index it restores branch 0, with the opposite weight.
    back, wb, _, _ = st_.edit(_tkey(k), nt, bwd, _index_change(gt, i0))
    close(back.get_score(), trt.get_score())
    close(wb, -wt)


def test_index_change_update_partial_constraint_follows_generate_rule():
    """Only ``y`` constrained, ``z`` proposed from its prior: the weight
    is the new branch's ``generate`` weight minus the old score. The JAX
    package returns the score difference here instead, which counts the
    proposed ``z`` as if it were constrained (reference fault:
    ``genjax_tpu/lang/combinators/switch.py:276``); both packages build
    the same new trace."""
    sj, st_ = _switch(gj), _switch(gt)
    trj = sj.simulate(KEY, (0, (), ()))
    trt = st_.simulate(_tkey(KEY), (0, (), ()))
    k = jax.random.fold_in(KEY, 4)
    nj, wj, _, _ = sj.edit(k, trj, gj.Update(gj.C["y"].set(9.5)),
                           _index_change(gj, 1))
    nt, wt, _, _ = st_.edit(_tkey(k), trt, gt.Update(gt.C["y"].set(9.5)),
                            _index_change(gt, 1))
    close(nt.get_score(), nj.get_score())
    z = float(nt.get_choices()["z"])
    log_q_z = st.norm.logpdf(z, 9.5, 0.5)
    close(wt, float(nt.get_score()) - log_q_z - float(trt.get_score()))
    # The reference's value, the score difference, differs by log q(z).
    close(wj, float(nj.get_score()) - float(trj.get_score()))
    assert abs(float(wt) - float(wj)) > 1e-3


@pytest.mark.parametrize("per_execution", [False, True])
def test_index_change_regenerate_weighs_zero(per_execution):
    sj, st_ = _switch(gj), _switch(gt)
    i0, i1 = ((torch.tensor(0), torch.tensor(1)) if per_execution
              else (0, 1))
    trj = sj.simulate(KEY, (0, (), ()))
    trt = st_.simulate(_tkey(KEY), (i0, (), ()))
    k = jax.random.fold_in(KEY, 6)
    nj, wj, _, bj = sj.edit(k, trj, gj.Regenerate(gj.Selection.all()),
                            _index_change(gj, 1))
    nt, wt, _, bt = st_.edit(_tkey(k), trt, gt.Regenerate(gt.Selection.all()),
                             _index_change(gt, i1))
    assert float(wt) == 0.0 and float(wj) == 0.0
    assert isinstance(bt, gt.Regenerate)
    close(nt.get_score(), nj.get_score())
    close(nt.get_choices()["y"], nj.get_choices()["y"])


def _mix(lib):
    @lib.gen
    def c0(shift):
        return lib.normal(shift, 1.0) @ "v"

    @lib.gen
    def c1(shift):
        return lib.normal(-shift, 2.0) @ "v"

    @lib.gen
    def c2(shift):
        return lib.normal(shift, 0.5) @ "w"

    return lib.mix(c0, c1, c2)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_mix_matches_jax(seed):
    key = jax.random.fold_in(KEY, seed)
    mj, mt = _mix(gj), _mix(gt)
    logits = np.log(np.array([0.2, 0.5, 0.3], np.float32))
    args_j = (jnp.asarray(logits), (1.5,), (1.5,), (1.5,))
    args_t = (torch.as_tensor(logits), (1.5,), (1.5,), (1.5,))
    trj = mj.simulate(key, args_j)
    trt = mt.simulate(_tkey(key), args_t)
    comp = int(trt.get_choices()["mixture_component"])
    assert comp == int(trj.get_choices()["mixture_component"])
    close(trt.get_score(), trj.get_score())
    close(trt.get_retval(), trj.get_retval())
    s, _ = mt.assess(trt.get_choices(), args_t)
    close(s, trt.get_score())
    k2 = jax.random.fold_in(key, 9)
    obs_j = gj.C["mixture_branch", "v"].set(0.25)
    obs_t = gt.C["mixture_branch", "v"].set(0.25)
    gj_tr, wj = mj.generate(k2, obs_j, args_j)
    gt_tr, wt = mt.generate(_tkey(k2), obs_t, args_t)
    close(wt, wj)
    close(gt_tr.get_score(), gj_tr.get_score())


def test_construction_caches_keep_one_identity():
    """300 constructions over distinct component pairs, more than the
    JAX package's 256-entry cache holds before it clears (reference
    fault: ``mixture.py:50-51``, ``or_else.py:44-45``): the first pair
    still gets its first object back."""

    def leaf(i):
        @gt.gen
        def f():
            return gt.normal(float(i), 1.0) @ "x"
        return f

    a, b = leaf(0), leaf(1)
    first_mix, first_or = a.mix(b), a.or_else(b)
    others = [leaf(i + 2) for i in range(300)]
    for c in others:
        c.mix(b)
        c.or_else(b)
    assert a.mix(b) is first_mix
    assert a.or_else(b) is first_or
    assert gt.mix(a, b) is first_mix


@pytest.mark.parametrize("flag", [True, False, "tensor"])
def test_or_else_matches_jax(flag):
    def make(lib):
        @lib.gen
        def if_fn(s):
            return lib.normal(s, 1.0) @ "a"

        @lib.gen
        def else_fn(s):
            return lib.normal(100.0 + s, 1.0) @ "b"

        return if_fn.or_else(else_fn)

    fj = flag if flag != "tensor" else jnp.asarray([True, False, True])
    ft = flag if flag != "tensor" else torch.tensor([True, False, True])
    oj, ot = make(gj), make(gt)
    if flag == "tensor":
        keys = jax.random.split(KEY, 3)
        trj = jax.vmap(lambda k, f: oj.simulate(k, (f, (0.5,), (0.5,))))(
            keys, fj)
        s = torch.full((3,), 0.5)
        trt = ot.simulate(_tkey(keys), (ft, (s,), (s,)))
    else:
        trj = oj.simulate(KEY, (fj, (0.5,), (0.5,)))
        trt = ot.simulate(_tkey(KEY), (ft, (0.5,), (0.5,)))
    close(trt.get_score(), trj.get_score())
    close(trt.get_retval(), trj.get_retval())


def test_inline_mix_mh_matches_closed_form():
    """MH by ``Regenerate`` of an inline ``c0.mix(c1)(...) @ "m"`` over
    4096 chains targets the exact two-component posterior (the Δscore
    index-change rule of the JAX package before its repair showed a
    +0.10 bias here): the final component frequency within 4 standard
    errors."""

    @gt.gen
    def c0(shift):
        return gt.normal(shift, 1.0) @ "v"

    @gt.gen
    def c1(shift):
        return gt.normal(-shift, 2.0) @ "v"

    @gt.gen
    def model():
        out = c0.mix(c1)(torch.log(torch.tensor([0.3, 0.7])), (2.0,),
                         (2.0,)) @ "m"
        _ = gt.normal(out, 0.5) @ "y"

    y, n = 1.0, 4096
    lik0 = 0.3 * st.norm.pdf(y, 2.0, np.sqrt(1.25))
    lik1 = 0.7 * st.norm.pdf(y, -2.0, np.sqrt(4.25))
    p1 = lik1 / (lik0 + lik1)
    target = gt.inference.Target(model, (), gt.C["y"].set(y))
    tr, _ = gt.inference.batched_importance(
        target, R.split(R.key(0), n), gt.ChoiceMap.empty())
    keys = R.split(R.key(1), n)
    req = gt.Regenerate(gt.Selection.at["m"])
    for i in range(40):
        tr, _ = gt.inference.mh(R.fold_in(keys, i), tr, req)
    freq = float((tr.get_choices()["m", "mixture_component"] == 1)
                 .double().mean())
    assert abs(freq - p1) < 4 * np.sqrt(p1 * (1 - p1) / n), (freq, p1)


def test_scan_of_switch_per_step_index():
    """A Switch inside Scan with its index drawn each step: the trace's
    identities (assess, generate under its choices, the identity Update)
    on a key batch, and its score against the JAX package's."""

    def make(lib):
        b0, b1 = _branches(lib)

        @lib.gen
        def step(carry, _):
            pick = lib.flip(0.4) @ "pick"
            if lib is gj:
                idx = jnp.int32(pick)
            else:
                idx = pick.to(torch.int64)
            out = lib.switch(b0, b1)(idx, (), ()) @ "sw"
            return carry + out, out

        return step.scan(n=3)

    sj, st_ = make(gj), make(gt)
    keys = jax.random.split(KEY, 4)
    score_j = jax.vmap(lambda k: sj.simulate(k, (0.0, None)).get_score())(
        keys)
    trt = st_.simulate(_tkey(keys), (0.0, None))
    close(trt.get_score(), score_j)
    chm = trt.get_choices()
    s, _ = st_.assess(chm, (0.0, None), batch=(4,))
    close(s, trt.get_score())
    _, w = st_.generate(_tkey(keys), chm, (0.0, None))
    close(w, trt.get_score())
    _, wu, _, _ = trt.update(_tkey(keys), chm)
    close(wu, torch.zeros(4))


def _support_model(lib):
    @lib.gen
    def bn():
        return lib.normal(0.0, 1.0) @ "x"

    @lib.gen
    def bg():
        return lib.gamma(2.0, 1.0) @ "x"

    sw = lib.switch(bn, bg)

    @lib.gen
    def model(idx):
        x = sw(idx, (), ()) @ "sw"
        _ = lib.normal(x, 0.5) @ "y"

    return model


@pytest.mark.parametrize("idx", [0, 1])
def test_per_branch_transforms_round_trip_against_jax(idx):
    """``infer_transforms`` gives ``PerBranch((None, "positive"))`` for
    an address that is normal in one branch and gamma in the other; the
    unconstrain / constrain round trip restores the live leaf, keeps the
    score, and its log-Jacobian is the JAX package's on the same
    values."""
    mt, mj = _support_model(gt), _support_model(gj)
    trt = mt.simulate(R.key(3), (torch.tensor(idx),))
    t = tt.infer_transforms(trt)
    assert t[("sw", "x")] == tt.PerBranch((None, "positive"))
    chm = trt.get_choices()
    u = tt.unconstrain_choices(chm, t)
    x2, fldj = tt.constrain_choices(u, t)
    close(x2["sw", "x"].value, chm["sw", "x"].value)
    s, _ = mt.assess(x2, (torch.tensor(idx),))
    close(s, trt.get_score())
    x_live = chm["sw", "x"].value
    chm_j = (gj.ChoiceMap.switch(jnp.asarray(idx), [
        gj.C["x"].set(jnp.asarray(_np(x_live) if idx == 0 else 0.0,
                                  jnp.float32)),
        gj.C["x"].set(jnp.asarray(_np(x_live) if idx == 1 else 0.0,
                                  jnp.float32))]).extend("sw")
        | gj.C["y"].set(jnp.asarray(_np(chm["y"]), jnp.float32)))
    tj = {("sw", "x"): jtt.PerBranch((None, "positive"))}
    _, fldj_j = jtt.constrain_choices(jtt.unconstrain_choices(chm_j, tj), tj)
    close(fldj, fldj_j)
    if idx == 0:
        assert float(fldj) == 0.0


def test_per_branch_gradient_is_finite_in_untaken_lanes():
    """On a key batch with per-execution branches, the score's gradient
    through the round-tripped choices is finite in every lane: each
    branch scores only its own (in-support) values."""
    mt = _support_model(gt)
    idx = torch.tensor([0, 1, 1, 0])
    trt = mt.simulate(R.split(R.key(4), 4), (idx,))
    t = tt.infer_transforms(trt)
    vals, grads = selection_gradient(gt.Selection.at["sw"], trt, (idx,))
    for g in (grads.get_submap("sw", "x").get_value(),):
        g = g.value if isinstance(g, gt.Mask) else g
        assert bool(torch.isfinite(g).all())
    u = tt.unconstrain_choices(trt.get_choices(), t)
    assert all(bool(torch.isfinite(v).all()) for v in
               gt.core.pytree.tree_leaves(u) if v.is_floating_point())


def test_nested_switch_per_branch_levels_and_clamp():
    """PerBranch layers peel outer-first (the live normal leaf under a
    nested Switch keeps the identity), and an out-of-range index clamps
    in the transforms' gates as in the combinator."""

    @gt.gen
    def n0():
        return gt.normal(0.0, 1.0) @ "x"

    @gt.gen
    def n1():
        return gt.normal(1.0, 1.0) @ "x"

    @gt.gen
    def gm():
        return gt.gamma(2.0, 2.0) @ "x"

    @gt.gen
    def inner(i):
        return gt.switch(n0, n1)(i, (), ()) @ "isw"

    outer = gt.switch(inner, gm)

    @gt.gen
    def model(oi, ii):
        return outer(oi, (ii,), ()) @ "sw"

    tr = model.simulate(R.key(0), (torch.tensor(0), torch.tensor(1)))
    t = tt.infer_transforms(tr)
    u = tt.unconstrain_choices(tr.get_choices(), t)
    x2, fldj = tt.constrain_choices(u, t)
    assert float(fldj) == 0.0
    close(x2.get_submap("sw", "isw", "x").get_value().value,
          tr.get_choices().get_submap("sw", "isw", "x").get_value().value)
    tr = model.simulate(R.key(0), (torch.tensor(5), torch.tensor(0)))
    u = tt.unconstrain_choices(tr.get_choices(), t)
    x2, fldj = tt.constrain_choices(u, t)
    assert float(fldj) != 0.0
    close(x2.get_submap("sw", "x").get_value().value,
          tr.get_choices().get_submap("sw", "x").get_value().value)


def test_zero_length_scan():
    @gt.gen
    def step(state, sigma):
        new_x = gt.normal(state, sigma) @ "x"
        return new_x, new_x + 1

    xs = torch.arange(0, dtype=torch.float32)
    tr = step.scan(n=0).simulate(R.key(0), (2.0, xs))
    assert tr.get_choices().static_is_empty()
    assert float(tr.get_score()) == 0.0
    final, outs = tr.get_retval()
    assert final == 2.0 and outs.shape == (0,)
    _, w = step.scan().importance(R.key(1), tr.get_choices(), (2.0, xs))
    assert float(w) == 0.0
    s, (final, outs) = step.scan().assess(gt.ChoiceMap.empty(), (2.0, xs))
    assert float(s) == 0.0 and outs.shape == (0,)
    keys = R.split(R.key(2), 5)
    trb = step.scan(n=0).simulate(keys, (2.0, xs.expand(5, 0)))
    assert trb.get_score().shape == (5,)
    assert float(trb.project(keys, gt.Selection.all()).abs().sum()) == 0.0
    _, wu, _, _ = trb.update(keys, gt.ChoiceMap.empty())
    assert wu.shape == (5,) and float(wu.abs().sum()) == 0.0


def test_selection_leaf_and_idx_above():
    leaf = gt.Selection.leaf()
    assert leaf.check() is True and leaf("a").check() is False
    above = gt.Selection.idx_above(2)
    assert above("x").check() is False
    assert above(3).check() is True and above(2).check() is False
    flags = above(torch.arange(5)).check()
    np.testing.assert_array_equal(flags.numpy(), [0, 0, 0, 1, 1])
    per = gt.Selection.idx_above(torch.tensor([0, 3]))(2).check()
    np.testing.assert_array_equal(per.numpy(), [True, False])
    # As in the JAX package: Regenerate the later steps of a Scan.

    @gt.gen
    def walk(c, _):
        x = gt.normal(c, 1.0) @ "x"
        return x, x

    tr = walk.scan(n=5).simulate(R.key(0), (0.0, None))
    new, _, _, _ = tr.edit(R.key(1), gt.Regenerate(gt.Selection.idx_above(2)))
    old_x = torch.stack([tr.get_choices()[t, "x"] for t in range(5)])
    new_x = torch.stack([new.get_choices()[t, "x"] for t in range(5)])
    assert torch.equal(old_x[:3], new_x[:3])
    assert not bool((old_x[3:] == new_x[3:]).any())
