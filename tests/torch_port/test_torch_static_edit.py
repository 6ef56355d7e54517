"""Fine-grained ``@gen`` edits of the port (``lang/static_edit.py``),
the cases of the JAX package's ``tests/lang/test_static_edit.py``:

- the fine path equals the coarse one bit for bit (draws, weights,
  scores, discards), unbatched and on a key batch;
- the re-scoring counts (``static.edit_stats``): a mid-chain
  ``Regenerate`` re-scores at most 2 sites on the fine path and at least
  10 on the coarse one; an independent site's ``Update`` re-scores 1; a
  root ``Update`` re-scores the root and its dependents only;
- the fallback to the coarse path on a body that reads a changed
  tensor's value into Python, or whose changed value is a Python number;
- the MH sweep posterior and the review regressions;
- the port against the JAX package's weights at the same keys.

Tolerance: fine against coarse exactly; port against JAX to 1e-5
relative and 1e-5 absolute (the two packages' normals agree to a few
ulp); the MH posterior mean within 4 standard errors of 2/3."""

import jax
import numpy as np
import pytest
import torch

import genjax_torch as gt
import genjax_tpu as gj
import genjax_tpu.lang.static as jax_static
from genjax_torch import entry as E
from genjax_torch.core import random as R
from genjax_torch.gfi.choice_map import ChoiceMap
from genjax_torch.gfi.requests import Regenerate, Update
from genjax_torch.interop import key_from_numpy
from genjax_torch.lang import static

S = 20
TOL = dict(rtol=1e-5, atol=1e-5)


def _tkey(k):
    return key_from_numpy(np.asarray(jax.random.key_data(k)))


def _np(x):
    return np.asarray(x.detach().cpu() if isinstance(x, torch.Tensor) else x,
                      np.float64)


def close(a, b, **kw):
    np.testing.assert_allclose(_np(a), _np(b), **(kw or TOL))


def _chain(lib):
    @lib.gen
    def chain():
        x = lib.normal(0.0, 1.0) @ "x0"
        for i in range(1, S):
            x = lib.normal(x, 1.0) @ f"x{i}"
        return x

    return chain


def _hierarchical(lib):
    @lib.gen
    def hierarchical():
        mu = lib.normal(0.0, 1.0) @ "mu"
        a = lib.normal(mu, 1.0) @ "a"
        b = lib.normal(mu, 1.0) @ "b"
        c = lib.normal(0.0, 1.0) @ "c"  # independent of everything
        return a + b + c

    return hierarchical


@pytest.fixture
def flag_restored():
    yield
    static.FINE_GRAINED_EDITS = True


def _both_paths(fn, *args):
    """``fn`` on the fine path and on the coarse one, with the counts of
    each run."""
    out = {}
    for fine in (True, False):
        static.FINE_GRAINED_EDITS = fine
        static.edit_stats.reset()
        try:
            res = fn(*args)
        finally:
            static.FINE_GRAINED_EDITS = True
        out[fine] = (res, static.edit_stats.sites_rescored,
                     static.edit_stats.fine, static.edit_stats.coarse)
    return out[True], out[False]


def _bitwise(a, b):
    for x, y in zip(a, b):
        assert torch.equal(torch.as_tensor(x), torch.as_tensor(y)), (x, y)


def _key(batch, seed):
    return R.key(seed) if not batch else R.split(R.key(seed), batch)


@pytest.mark.usefixtures("flag_restored")
class TestEquivalence:
    @pytest.mark.parametrize("batch", [0, 4])
    def test_regenerate_bitwise_equal(self, batch):
        tr = _chain(gt).simulate(_key(batch, 0), ())

        def do(k):
            new_tr, w, _rd, _bwd = tr.edit(k, Regenerate(gt.S.at["x5"]))
            return new_tr.get_choices()["x7"], w, new_tr.get_score()

        (fine, n_f, f_f, _), (coarse, n_c, _, c_c) = _both_paths(
            do, _key(batch, 1))
        _bitwise(fine, coarse)
        assert (f_f, c_c) == (1, 1)
        assert n_f == 2 and n_c == S - 5

    @pytest.mark.parametrize("batch", [0, 4])
    def test_update_weight_and_discard_equal(self, batch):
        tr = _chain(gt).simulate(_key(batch, 0), ())
        v = torch.tensor(1.25)
        c = ChoiceMap.kw(x3=v.expand(batch) if batch else v)

        def do(k):
            new_tr, w, _rd, bwd = tr.edit(k, Update(c))
            return (new_tr.get_score(), w, bwd.constraint["x3"],
                    new_tr.get_choices()["x3"])

        (fine, n_f, f_f, _), (coarse, n_c, _, _) = _both_paths(
            do, _key(batch, 1))
        _bitwise(fine, coarse)
        assert f_f == 1 and n_f == 2 and n_c == S - 3

    def test_update_weight_identity(self):
        tr = _hierarchical(gt).simulate(R.key(0), ())
        new_tr, w, _rd, _ = tr.edit(R.key(1),
                                    Update(ChoiceMap.kw(mu=torch.tensor(0.7))))
        close(w, new_tr.get_score() - tr.get_score())

    @pytest.mark.parametrize("request_kind", ["update", "regenerate",
                                              "static"])
    def test_hierarchical_requests_bitwise(self, request_kind):
        tr = _hierarchical(gt).simulate(R.split(R.key(2), 3), ())
        reqs = {
            "update": Update(ChoiceMap.kw(mu=torch.full((3,), 0.2))),
            "regenerate": Regenerate(gt.S.at["b"] | gt.S.at["mu"]),
            "static": gt.StaticRequest({
                "a": Regenerate(gt.Selection.all()),
                "c": Update(ChoiceMap.choice(torch.full((3,), -0.5)))}),
        }

        def do(k):
            new_tr, w, rd, _ = tr.edit(k, reqs[request_kind])
            return (new_tr.get_score(), w, new_tr.get_retval(),
                    *[new_tr.get_choices()[a] for a in ("mu", "a", "b", "c")])

        (fine, _, f_f, _), (coarse, _, _, _) = _both_paths(
            do, R.split(R.key(3), 3))
        _bitwise(fine, coarse)
        assert f_f == 1

    def test_value_read_falls_back(self):
        @gt.gen
        def branchy():
            x = gt.normal(0.0, 1.0) @ "x"
            if bool(x > 0):   # a changed value read into Python
                y = gt.normal(x, 1.0) @ "y"
            else:
                y = gt.normal(5.0, 1.0) @ "y"
            return y

        tr = branchy.simulate(R.key(0), ())

        def do(k):
            new_tr, w, _, _ = tr.edit(k, Update(ChoiceMap.kw(
                x=torch.tensor(-0.3) if float(tr.get_choices()["x"]) > 0
                else torch.tensor(0.3))))
            return new_tr.get_score(), w, new_tr.get_choices()["y"]

        (fine, _, f_f, c_f), (coarse, _, _, _) = _both_paths(do, R.key(1))
        _bitwise(fine, coarse)
        # The fine attempt stopped at the read and the coarse path served.
        assert (f_f, c_f) == (0, 1)

    def test_python_number_value_falls_back(self):
        """A constraint given as a Python float makes a changed value no
        operation can tag: the edit is served on the coarse path."""
        tr = _chain(gt).simulate(R.key(0), ())
        static.edit_stats.reset()
        new_tr, w, _, _ = tr.edit(R.key(1), Update(ChoiceMap.kw(x3=1.25)))
        assert (static.edit_stats.fine, static.edit_stats.coarse) == (0, 1)
        close(w, new_tr.get_score() - tr.get_score())

    def test_unread_python_control_flow_stays_fine(self):
        """Control flow on an unchanged argument needs no fallback."""

        @gt.gen
        def m(mode, mu):
            if mode == "wide":
                return gt.normal(mu, 10.0) @ "x"
            return gt.normal(mu, 0.1) @ "x"

        tr = m.simulate(R.key(0), ("wide", torch.tensor(0.5)))
        static.edit_stats.reset()
        new_tr, _, _, _ = tr.edit(R.key(1), Regenerate(gt.Selection.all()),
                                  gt.Diff.no_change(("wide",
                                                     torch.tensor(0.5))))
        assert bool(torch.isfinite(new_tr.get_score()))
        assert static.edit_stats.fine == 1

    def test_in_place_operation_carries_the_change(self):
        """A body that writes a changed value into a buffer in place
        re-scores the site that reads the buffer."""

        @gt.gen
        def buf_model():
            x = gt.normal(0.0, 1.0) @ "x"
            buf = torch.zeros(2)
            buf[1] = x
            return gt.normal(buf.sum(), 1.0) @ "y"

        tr = buf_model.simulate(R.key(0), ())

        def do(k):
            new_tr, w, _, _ = tr.edit(k, Update(ChoiceMap.kw(
                x=torch.tensor(0.4))))
            return new_tr.get_score(), w

        (fine, n_f, f_f, _), (coarse, _, _, _) = _both_paths(do, R.key(1))
        _bitwise(fine, coarse)
        assert f_f == 1 and n_f == 2

    def test_changed_argument_reaches_only_its_sites(self):
        @gt.gen
        def two(mu, nu):
            a = gt.normal(mu, 1.0) @ "a"
            b = gt.normal(nu, 1.0) @ "b"
            return a + b

        args = (torch.tensor(0.1), torch.tensor(0.2))
        tr = two.simulate(R.key(0), args)
        new_args = (torch.tensor(0.1), torch.tensor(0.9))
        diffs = (gt.Diff(new_args[0], gt.NoChange),
                 gt.Diff(new_args[1], gt.UnknownChange))

        def do(k):
            new_tr, w, rd, _ = tr.edit(k, Update(ChoiceMap.empty()), diffs)
            return new_tr.get_score(), w

        (fine, n_f, _, _), (coarse, n_c, _, _) = _both_paths(do, R.key(1))
        _bitwise(fine, coarse)
        assert (n_f, n_c) == (1, 2)


@pytest.mark.usefixtures("flag_restored")
class TestAsymptotics:
    def test_midchain_regenerate_rescores_o1_sites(self):
        tr = _chain(gt).simulate(R.key(0), ())

        def edit_mid(k):
            return tr.edit(k, Regenerate(gt.S.at["x10"]))[1]

        (_, fine, _, _), (_, coarse, _, _) = _both_paths(edit_mid, R.key(1))
        assert coarse >= 10, coarse
        assert fine <= 2, fine

    def test_independent_site_update_rescores_one(self):
        tr = _hierarchical(gt).simulate(R.key(0), ())
        static.edit_stats.reset()
        tr.edit(R.key(1), Update(ChoiceMap.kw(c=torch.tensor(0.1))))
        assert static.edit_stats.sites_rescored == 1

    def test_root_update_rescores_dependents_not_independents(self):
        tr = _hierarchical(gt).simulate(R.key(0), ())
        static.edit_stats.reset()
        tr.edit(R.key(1), Update(ChoiceMap.kw(mu=torch.tensor(0.2))))
        # mu, a and b re-scored; c untouched.
        assert static.edit_stats.sites_rescored == 3


@pytest.mark.usefixtures("flag_restored")
class TestMHSweepPosterior:
    def test_mh_sweep_chain_posterior(self):
        """Single-site MH sweeps by fine-grained Regenerate edits keep the
        chain posterior: x0 ~ N(0, 1), x1 | x0 ~ N(x0, .5), y | x1 ~
        N(x1, .5) at y = 1 gives E[x0 | y] = 2/3, Var = 1/3."""
        n = 4096
        init, sweep = E.build_chain_mh_sweep(n, 2, 0.5, 0.5, 1.0,
                                             device="cpu")
        tr = init(R.key(0))
        static.edit_stats.reset()
        for i in range(60):
            tr, rescored, _ = sweep(R.fold_in(R.key(7), i), tr)
        assert rescored == [2, 2]
        assert static.edit_stats.coarse == 0
        x0 = tr.get_choices()["x0"]
        se = (1.0 / 3.0 / n) ** 0.5
        assert abs(float(x0.mean()) - 2.0 / 3.0) < 4 * se

    def test_sweep_fine_equals_coarse(self):
        init, sweep = E.build_chain_mh_sweep(64, 8, device="cpu")
        (fine, r_f, _, _), (coarse, r_c, _, _) = _both_paths(
            lambda: sweep(R.key(1), init(R.key(0))))
        _bitwise((fine[0].get_score(), fine[2]),
                 (coarse[0].get_score(), coarse[2]))
        assert fine[1] == [2] * 8
        assert coarse[1] == [9 - i for i in range(8)]


class TestEditReviewRegressions:
    def test_constant_retval_editable(self):
        @gt.gen
        def f(mu):
            x = gt.normal(mu, 1.0) @ "x"
            return (x, 3.0)

        tr = f.simulate(R.key(0), (0.5,))
        new_tr, w, _, _ = tr.edit(R.key(1), Regenerate(gt.Selection.at["x"]),
                                  gt.Diff.no_change((0.5,)))
        assert bool(torch.isfinite(new_tr.get_score()))
        assert new_tr.get_retval()[1] == 3.0

    def test_string_arg_body(self):
        @gt.gen
        def m(mode, mu):
            if mode == "wide":
                return gt.normal(mu, 10.0) @ "x"
            return gt.normal(mu, 0.1) @ "x"

        tr = m.simulate(R.key(0), ("wide", 0.5))
        new_tr, _, _, _ = tr.edit(R.key(1), Regenerate(gt.Selection.all()),
                                  gt.Diff.no_change(("wide", 0.5)))
        assert bool(torch.isfinite(new_tr.get_score()))


@pytest.mark.parametrize("jax_fine", [True, False], ids=["jax_fine",
                                                         "jax_coarse"])
@pytest.mark.parametrize("case", ["chain_regenerate", "chain_update",
                                  "root_update"])
def test_port_matches_jax_weights(case, jax_fine, monkeypatch):
    """The port's fine path against the JAX package's fine and coarse
    paths at the same keys."""
    monkeypatch.setattr(jax_static, "FINE_GRAINED_EDITS", jax_fine)
    k0, k1 = jax.random.key(0), jax.random.key(1)
    if case.startswith("chain"):
        mj, mt = _chain(gj), _chain(gt)
    else:
        mj, mt = _hierarchical(gj), _hierarchical(gt)
    trj, trt = mj.simulate(k0, ()), mt.simulate(_tkey(k0), ())
    if case == "chain_regenerate":
        rj, rt = gj.Regenerate(gj.S.at["x5"]), Regenerate(gt.S.at["x5"])
    elif case == "chain_update":
        rj = gj.Update(gj.ChoiceMap.kw(x3=1.25))
        rt = Update(ChoiceMap.kw(x3=torch.tensor(1.25)))
    else:
        rj = gj.Update(gj.ChoiceMap.kw(mu=0.2))
        rt = Update(ChoiceMap.kw(mu=torch.tensor(0.2)))
    static.edit_stats.reset()
    nj, wj, _, _ = trj.edit(k1, rj)
    nt, wt, _, _ = trt.edit(_tkey(k1), rt)
    assert static.edit_stats.fine == 1
    close(wt, wj)
    close(nt.get_score(), nj.get_score())
    for addr in (["x5", "x6", "x19"] if case.startswith("chain")
                 else ["mu", "a", "b", "c"]):
        close(nt.get_choices()[addr], nj.get_choices()[addr])
