"""The port's Vmap, repeat, Scan (with the combinators derived from
Scan), Dimap and MaskCombinator against the JAX package on the same key
data: simulate, assess, generate, project and edit (Update, Regenerate,
IndexRequest), a key batch against its executions one by one (also with
a body constant as long as the batch), and ``hmm_model``'s score against
``DiscreteHMM``'s joint.

Tolerance: scores, weights and values to 1e-5 relative and 1e-5 absolute
(normals agree with JAX's to a few ulp); a batch against its executions
to 1e-6; categorical draws exactly."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import genjax_torch as gt
import genjax_tpu as gj
from genjax_torch.core import random as R
from genjax_torch.interop import hmm_config_from_numpy, key_from_numpy
from genjax_torch.lang.distributions.discrete_hmm import joint_logpdf
from genjax_torch.models.hmm import hmm_model
from genjax_tpu.lang.distributions.discrete_hmm import (
    DiscreteHMMConfiguration as JaxHMMConfiguration,
)
from genjax_tpu.models.hmm import hmm_model as jax_hmm_model

TOL = dict(rtol=1e-5, atol=1e-5)
KEY = jax.random.key(314159)


def _tkey(k):
    return key_from_numpy(np.asarray(jax.random.key_data(k)))


def close(a, b, **kw):
    def f(x):
        return np.asarray(x.detach().cpu() if isinstance(x, torch.Tensor)
                          else x, np.float64)
    np.testing.assert_allclose(f(a), f(b), **(kw or TOL))


def _kernel(lib):
    @lib.gen
    def kernel(mu):
        return lib.normal(mu, 1.0) @ "x"

    return kernel


def _walk(lib):
    @lib.gen
    def walk_step(carry, _):
        x = lib.normal(carry, 1.0) @ "x"
        return x, carry

    return walk_step


def _drift(lib):
    @lib.gen
    def drift(carry, _):
        x = lib.normal(carry, 1.0) @ "x"
        return carry + x, x

    return drift


def _both(make, combine, args_j, args_t):
    gf_j, gf_t = combine(make(gj)), combine(make(gt))
    return (gf_j, gf_t, gf_j.simulate(KEY, args_j),
            gf_t.simulate(_tkey(KEY), args_t))


VMAP = (_kernel, lambda k: k.vmap(in_axes=0), (jnp.arange(4.0),),
        (torch.arange(4.0),))
REPEAT = (_kernel, lambda k: k.repeat(n=6), (0.0,), (0.0,))
SCAN = (_walk, lambda k: k.scan(n=5), (0.0, None), (0.0, None))
CASES = {"vmap": VMAP, "repeat": REPEAT, "scan": SCAN}


@pytest.mark.parametrize("name", list(CASES))
def test_simulate_assess_project_match_jax(name):
    make, combine, aj, at = CASES[name]
    gf_j, gf_t, trj, trt = _both(make, combine, aj, at)
    n = trt.n
    xs_j = np.array([trj.get_choices()[i, "x"] for i in range(n)])
    xs_t = torch.stack([trt.get_choices()[i, "x"] for i in range(n)])
    close(xs_t, xs_j)
    close(trt.get_score(), trj.get_score())
    sj, _ = gf_j.assess(trj.get_choices(), aj)
    st, _ = gf_t.assess(trt.get_choices(), at)
    close(st, sj)
    close(st, trt.get_score())
    pk = jax.random.key(3)
    for sel_j, sel_t in ((gj.S.at[1, "x"], gt.S.at[1, "x"]),
                         (gj.S.all(), gt.Selection.all())):
        close(trt.project(_tkey(pk), sel_t), trj.project(pk, sel_j))


@pytest.mark.parametrize("name", list(CASES))
def test_generate_and_edits_match_jax(name):
    make, combine, aj, at = CASES[name]
    gf_j, gf_t, trj, trt = _both(make, combine, aj, at)
    k = jax.random.key(5)
    trgj, wj = gf_j.generate(k, gj.C[2, "x"].set(1.5), aj)
    trgt, wt = gf_t.generate(_tkey(k), gt.C[2, "x"].set(1.5), at)
    close(wt, wj)
    close(trgt.get_score(), trgj.get_score())
    for i in range(trt.n):
        close(trgt.get_choices()[i, "x"], trgj.get_choices()[i, "x"])
    requests = [
        (gj.Update(gj.C[1, "x"].set(0.0)), gt.Update(gt.C[1, "x"].set(0.0))),
        (gj.Regenerate(gj.S.at[3, "x"]), gt.Regenerate(gt.S.at[3, "x"])),
        (gj.IndexRequest(1, gj.Update(gj.C["x"].set(2.0))),
         gt.IndexRequest(1, gt.Update(gt.C["x"].set(2.0)))),
        (gj.IndexRequest(2, gj.Regenerate(gj.S.at["x"])),
         gt.IndexRequest(2, gt.Regenerate(gt.S.at["x"]))),
    ]
    for rj, rt in requests:
        nj, wj, _, bj = trj.edit(k, rj)
        nt, wt, _, bt = trt.edit(_tkey(k), rt)
        close(wt, wj)
        close(nt.get_score(), nj.get_score())
        for i in range(trt.n):
            close(nt.get_choices()[i, "x"], nj.get_choices()[i, "x"])
        if isinstance(getattr(rt, "subrequest", rt), gt.Update):
            # An Update's weight is the change of score here, and its
            # backward request restores the old choices with weight -w.
            close(wt, nt.get_score() - trt.get_score())
            back, wb, _, _ = nt.edit(_tkey(k), bt)
            close(wb, -wt)
            for i in range(trt.n):
                close(back.get_choices()[i, "x"], trt.get_choices()[i, "x"])


@pytest.mark.parametrize("name", list(CASES))
def test_key_batch_is_per_execution(name):
    """Three executions on a key batch: every choice, score and edit
    weight equals the execution on its own key; the lanes or steps sit
    behind the batch axis."""
    make, combine, _, at = CASES[name]
    gf = combine(make(gt))
    keys = R.split(R.key(4), 3)
    ekeys = R.split(R.key(6), 3)

    def lifted(a):
        return a.expand((3,) + tuple(a.shape)) if isinstance(
            a, torch.Tensor) else a

    bat = tuple(lifted(a) for a in at)
    tr = gf.simulate(keys, bat)
    assert tr.get_score().shape == (3,)
    s, _ = gf.assess(tr.get_choices(), bat, batch=(3,))
    close(s, tr.get_score(), rtol=1e-6, atol=1e-6)
    req = gt.IndexRequest(1, gt.Regenerate(gt.S.at["x"]))
    new, w, _, _ = tr.edit(ekeys, req)
    for p in range(3):
        one = gf.simulate(keys[p], at)
        close(tr.get_score()[p], one.get_score(), rtol=1e-6, atol=1e-6)
        n1, w1, _, _ = one.edit(ekeys[p], req)
        close(w[p], w1, rtol=1e-6, atol=1e-6)
        for i in range(one.n):
            close(tr.get_choices()[i, "x"][p], one.get_choices()[i, "x"],
                  rtol=0, atol=0)
            close(new.get_choices()[i, "x"][p], n1.get_choices()[i, "x"],
                  rtol=1e-6, atol=1e-6)


def test_scan_index_request_errors_and_last_step():
    sc_t = _drift(gt).scan(n=5)
    sc_j = _drift(gj).scan(n=5)
    trt = sc_t.simulate(_tkey(KEY), (0.0, None))
    trj = sc_j.simulate(KEY, (0.0, None))
    k = jax.random.key(8)
    with pytest.raises(ValueError, match="carry changed past step"):
        trt.edit(_tkey(k), gt.IndexRequest(1, gt.Update(gt.C["x"].set(0.3))))
    with pytest.raises(IndexError, match="out of range"):
        trt.edit(_tkey(k), gt.IndexRequest(5, gt.Update(gt.C["x"].set(0.3))))
    # At the last two steps the changed carry reaches no step: the final
    # carry is repaired instead.
    for t in (3, 4):
        nj, wj, _, _ = trj.edit(k, gj.IndexRequest(
            t, gj.Update(gj.C["x"].set(0.3))))
        nt, wt, _, _ = trt.edit(_tkey(k), gt.IndexRequest(
            t, gt.Update(gt.C["x"].set(0.3))))
        close(wt, wj)
        close(nt.get_retval()[0], nj.get_retval()[0])
        close(nt.get_retval()[1], nj.get_retval()[1])
    # Changed arguments lower the index edit to the whole chain.
    nj, wj, _, _ = trj.edit(k, gj.IndexRequest(1, gj.Update(
        gj.C["x"].set(0.3))), gj.Diff.unknown_change((1.0, None)))
    nt, wt, _, _ = trt.edit(_tkey(k), gt.IndexRequest(1, gt.Update(
        gt.C["x"].set(0.3))), gt.Diff.unknown_change((1.0, None)))
    close(wt, wj)
    close(nt.get_score(), nj.get_score())


def test_scanned_inputs_and_derived_combinators_match_jax():
    def step(lib):
        @lib.gen
        def step(carry, x):
            y = lib.normal(carry + x, 1.0) @ "y"
            return y, y
        return step

    def add(lib):
        @lib.gen
        def add(acc, x):
            return lib.normal(acc + x, 1e-3) @ "s"
        return add

    def double(lib):
        @lib.gen
        def double_step(x):
            return lib.normal(x * 2.0, 1e-3) @ "x"
        return double_step

    def inc(lib):
        @lib.gen
        def inc(x):
            return lib.normal(x + 1.0, 1e-3) @ "x"
        return inc

    xs = np.arange(3.0, dtype=np.float32)
    flags = np.array([True, False, True, True, False])
    cases = [
        (lambda lib: step(lib).scan(), lambda xp: (0.0, xp.asarray(xs))),
        (lambda lib: add(lib).accumulate(), lambda xp: (0.0, xp.ones(4))),
        (lambda lib: add(lib).reduce(), lambda xp: (0.0, xp.asarray(xs))),
        (lambda lib: double(lib).iterate(n=3), lambda xp: (1.0,)),
        (lambda lib: double(lib).iterate_final(n=3), lambda xp: (1.0,)),
        (lambda lib: inc(lib).masked_iterate(),
         lambda xp: (0.0, xp.asarray(flags))),
        (lambda lib: inc(lib).masked_iterate_final(),
         lambda xp: (0.0, xp.asarray(flags))),
    ]
    for build, args in cases:
        gf_j, gf_t = build(gj), build(gt)
        trj = gf_j.simulate(KEY, args(jnp))
        trt = gf_t.simulate(_tkey(KEY), args(torch))
        close(trt.get_score(), trj.get_score())
        for a, b in zip(jax.tree_util.tree_leaves(trj.get_retval()),
                        [v for v in gt.core.pytree.tree_leaves(
                            trt.get_retval())]):
            close(b, a)
        sj, _ = gf_j.assess(trj.get_choices(), args(jnp))
        st, _ = gf_t.assess(trt.get_choices(), args(torch))
        close(st, sj)


def _hmm_configs(s=4, seed=0):
    rng = np.random.default_rng(seed)

    def log_softmax(a):
        a = a - a.max(-1, keepdims=True)
        return (a - np.log(np.exp(a).sum(-1, keepdims=True))).astype(
            np.float32)

    prior, trans, obs = (log_softmax(rng.normal(size=shape))
                         for shape in ((s,), (s, s), (s, s)))
    cj = JaxHMMConfiguration(jnp.asarray(prior), jnp.asarray(trans),
                             jnp.asarray(obs))
    return cj, hmm_config_from_numpy(prior, trans, obs)


def test_hmm_model_matches_jax_and_the_exact_joint():
    """``hmm_model`` through Scan: the same draws as the JAX package's on
    the same key, and the trace's score is ``DiscreteHMM``'s joint
    log P(z, x) of the sampled path, unbatched and on a key batch."""
    cj, ct = _hmm_configs()
    t_steps = 6
    mj, mt = jax_hmm_model(cj, t_steps), hmm_model(ct, t_steps)
    trj, trt = mj.simulate(KEY, ()), mt.simulate(_tkey(KEY), ())
    chj, cht = trj.get_choices(), trt.get_choices()
    for a in ("z0", "x0"):
        assert int(cht[a]) == int(chj[a])
    for part in ("z", "x"):
        assert np.array_equal(cht["chain", :, part].numpy(),
                              np.asarray(chj["chain", :, part]))
    close(trt.get_score(), trj.get_score())
    keys = R.split(R.key(9), 5)
    tr = mt.simulate(keys, ())
    ch = tr.get_choices()
    z = torch.cat([ch["z0"][:, None], ch["chain", :, "z"]], 1)
    x = torch.cat([ch["x0"][:, None], ch["chain", :, "x"]], 1)
    for p in range(5):
        close(tr.get_score()[p], joint_logpdf(ct, z[p], x[p]))
    s, _ = mt.assess(ch, (), batch=(5,))
    close(s, tr.get_score())


def test_hmm_model_constrained_generate_and_index_regenerate():
    """Phase 16 of the chip check at a small size: generate with the
    observations constrained weighs each path by the sum of its
    log-softmaxed emission logits, and ``IndexRequest(t, Regenerate(z))``
    satisfies w = Δscore − Δ(log-density of the regenerated site)."""
    from genjax_torch import entry as E

    generate, model, _, problem = E.build_hmm_model(4, 8, 64, device="cpu")
    tr, w = generate(R.key(1))
    ch = tr.get_choices()
    z = torch.cat([ch["z0"][:, None], ch["chain", :, "z"]], 1)
    obs = problem.observations
    emit = torch.log_softmax(problem.config.observation_logits, -1)
    close(w, emit[z, obs[None, :]].sum(-1))
    keys = R.split(R.key(2), 64)
    t = 3
    new, wr, _, _ = tr.edit(keys, gt.StaticRequest(
        {"chain": gt.IndexRequest(t, gt.Regenerate(gt.S.at["z"]))}))
    site_old = tr.get_subtrace("chain").inner.get_subtrace("z").get_score()
    site_new = new.get_subtrace("chain").inner.get_subtrace("z").get_score()
    close(wr, new.get_score() - tr.get_score()
          - (site_new[:, t] - site_old[:, t]))
    assert torch.equal(new.get_choices()["chain", :, "x"],
                       tr.get_choices()["chain", :, "x"])


def _const_model(name, length):
    """A body constant of ``length`` (``arange``), mapped by Vmap or
    scanned by Scan."""
    if name == "vmap":
        kernel = _kernel(gt)

        @gt.gen
        def outer():
            return kernel.vmap()(torch.arange(float(length))) @ "c"
    else:
        @gt.gen
        def step(carry, x):
            y = gt.normal(carry + x.sum(-1), 1.0) @ "x"
            return y, y

        @gt.gen
        def outer():
            xs = torch.arange(3.0 * length).reshape(length, 3)
            return step.scan()(0.0, xs) @ "c"

    return outer


@pytest.mark.parametrize("name", ["vmap", "scan"])
@pytest.mark.parametrize("k", [3, 4])
def test_body_constant_of_the_batch_length(name, k):
    """A constant of length 4 that a ``@gen`` body passes to Vmap or Scan,
    on a batch of 3 and of 4 executions: the batched run equals each
    execution on its own key (choices exactly, scores and an Update's
    weight to 1e-6), so a length equal to the batch's is not taken for
    it."""
    outer = _const_model(name, 4)
    keys = R.split(R.key(11), k)
    ekeys = R.split(R.key(12), k)
    tr = outer.simulate(keys, ())
    xs = tr.get_choices()["c", :, "x"]
    assert xs.shape == (k, 4)
    s, ret = outer.assess(tr.get_choices(), (), batch=(k,))
    close(s, tr.get_score(), rtol=1e-6, atol=1e-6)
    req = gt.Update(gt.C["c", 2, "x"].set(0.5))
    new, w, _, _ = tr.edit(ekeys, req)
    for p in range(k):
        one = outer.simulate(keys[p], ())
        close(xs[p], one.get_choices()["c", :, "x"], rtol=0, atol=0)
        close(tr.get_score()[p], one.get_score(), rtol=1e-6, atol=1e-6)
        n1, w1, _, _ = one.edit(ekeys[p], req)
        close(w[p], w1, rtol=1e-6, atol=1e-6)
        close(new.get_choices()["c", :, "x"][p], n1.get_choices()["c", :, "x"],
              rtol=1e-6, atol=1e-6)


def test_discrete_hmm_takes_lifted_parameters_back_to_one_copy():
    """A body hands ``DiscreteHMM`` its configuration lifted to the batch
    (zero-stride): the batched draws and scores equal each execution's
    own (exactly, 1e-6); parameters that differ across the batch give
    each execution its own problem's draws and scores (exactly, 1e-6)."""
    from genjax_torch.lang.distributions.discrete_hmm import discrete_hmm

    _, cfg = _hmm_configs(s=4, seed=1)
    obs = torch.tensor([0, 3, 1, 2, 2])

    @gt.gen
    def path():
        return discrete_hmm(cfg, obs) @ "z"

    keys = R.split(R.key(14), 4)
    tr = path.simulate(keys, ())
    assert tr.get_choices()["z"].shape == (4, 5)
    for p in range(4):
        one = path.simulate(keys[p], ())
        close(tr.get_choices()["z"][p], one.get_choices()["z"], rtol=0, atol=0)
        close(tr.get_score()[p], one.get_score(), rtol=1e-6, atol=1e-6)
    # Every other argument lifted, as a top-level batched call takes it.
    per_exec = type(cfg)(cfg.prior_logits.expand(4, 4).clone(),
                         cfg.transition_logits.expand(4, 4, 4),
                         cfg.observation_logits.expand(
                             (4,) + tuple(cfg.observation_logits.shape)))
    per_exec.prior_logits[1:] = torch.log_softmax(
        torch.arange(4.0) * 0.5, -1)
    tr = discrete_hmm.simulate(keys, (per_exec, obs.expand(4, 5)))
    for p in range(4):
        own = type(cfg)(per_exec.prior_logits[p], cfg.transition_logits,
                        cfg.observation_logits)
        one = discrete_hmm.simulate(keys[p], (own, obs))
        close(tr.get_retval()[p], one.get_retval(), rtol=0, atol=0)
        close(tr.get_score()[p], one.get_score(), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("length", [3, 4])
def test_batched_combinator_refuses_an_unlifted_tensor(length):
    """At the top of a batched call every tensor argument leads with the
    batch: Vmap and Scan refuse one that does not, whatever its length
    (at length 4 = the batch, the argument is one value per execution,
    with no axis left to map or scan)."""
    keys = R.split(R.key(0), 4)
    with pytest.raises(ValueError, match="batch"):
        _kernel(gt).vmap().simulate(keys, (torch.arange(float(length)),))
    with pytest.raises((ValueError, IndexError)):
        _walk(gt).scan().simulate(keys, (0.0, torch.zeros(length)))
    lifted = torch.arange(float(length)).expand(4, length)
    tr = _kernel(gt).vmap().simulate(keys, (lifted,))
    assert tr.get_choices()[:, "x"].shape == (4, length)


DIMAP = {
    "dimap": (lambda lib: _kernel(lib).dimap(pre=lambda a, b: (a + b,),
                                             post=lambda args, r: r * 2.0),
              (1.5, 2.0), (0.5, 2.0)),
    "map": (lambda lib: _kernel(lib).map(lambda r: r - 1.0), (1.5,), (0.5,)),
    "contramap": (lambda lib: _kernel(lib).contramap(lambda a, b: (a * b,)),
                  (1.5, 2.0), (0.5, 2.0)),
}


@pytest.mark.parametrize("name", list(DIMAP))
def test_dimap_matches_jax(name):
    """Dimap, map and contramap: simulate, assess, generate and an Update
    edit against the JAX package on the same key data (1e-5)."""
    build, args, new_args = DIMAP[name]
    gf_j, gf_t = build(gj), build(gt)
    trj, trt = gf_j.simulate(KEY, args), gf_t.simulate(_tkey(KEY), args)
    close(trt.get_retval(), trj.get_retval())
    close(trt.get_score(), trj.get_score())
    sj, rj = gf_j.assess(trj.get_choices(), args)
    st, rt = gf_t.assess(trt.get_choices(), args)
    close(st, sj)
    close(rt, rj)
    k = jax.random.key(5)
    (gj_tr, wj), (gt_tr, wt) = (gf_j.generate(k, gj.C["x"].set(0.3), args),
                                gf_t.generate(_tkey(k), gt.C["x"].set(0.3),
                                              args))
    close(wt, wj)
    close(gt_tr.get_retval(), gj_tr.get_retval())
    nj, wj, _, _ = trj.edit(k, gj.Update(gj.C["x"].set(-1.0)),
                            gj.Diff.unknown_change(new_args))
    nt, wt, _, _ = trt.edit(_tkey(k), gt.Update(gt.C["x"].set(-1.0)),
                            gt.Diff.unknown_change(new_args))
    close(wt, wj)
    close(nt.get_retval(), nj.get_retval())


@pytest.mark.parametrize("before", [True, False])
@pytest.mark.parametrize("after", [True, False])
def test_mask_combinator_matches_jax(before, after):
    """MaskCombinator: the gated score, assess and generate, and an edit
    from flag ``before`` to ``after`` with the JAX package's four-case
    weight (T→T the inner weight, T→F −old score, F→T +new score, F→F
    0), on the same key data (1e-5)."""
    gf_j, gf_t = _kernel(gj).mask(), _kernel(gt).mask()
    trj = gf_j.simulate(KEY, (before, 0.5))
    trt = gf_t.simulate(_tkey(KEY), (before, 0.5))
    close(trt.get_score(), trj.get_score())
    sj, _ = gf_j.assess(trj.get_choices(), (before, 0.5))
    st, _ = gf_t.assess(trt.get_choices(), (before, 0.5))
    close(st, sj)
    k = jax.random.key(6)
    _, wj = gf_j.generate(k, gj.C["x"].set(0.1), (before, 0.5))
    _, wt = gf_t.generate(_tkey(k), gt.C["x"].set(0.1), (before, 0.5))
    close(wt, wj)
    nj, wj, _, _ = trj.edit(k, gj.Update(gj.C["x"].set(1.0)),
                            (gj.Diff.unknown_change(after),
                             gj.Diff.no_change(0.5)))
    nt, wt, _, _ = trt.edit(_tkey(k), gt.Update(gt.C["x"].set(1.0)),
                            (gt.Diff.unknown_change(after),
                             gt.Diff.no_change(0.5)))
    close(wt, wj)
    close(nt.get_score(), nj.get_score())


@pytest.mark.parametrize("name", ["accumulate", "masked_iterate"])
def test_derived_combinators_on_a_key_batch(name):
    """``accumulate`` and ``masked_iterate`` on a batch of 3 executions
    (the accumulator prepended at the step axis, behind the batch): each
    execution equals its own run (1e-6)."""
    @gt.gen
    def add(acc, x):
        return gt.normal(acc + x, 1e-3) @ "s"

    @gt.gen
    def inc(x):
        return gt.normal(x + 1.0, 1e-3) @ "x"

    if name == "accumulate":
        gf, args = add.accumulate(), (0.0, torch.ones(4))
    else:
        gf, args = inc.masked_iterate(), (0.0, torch.tensor(
            [True, False, True, True]))
    keys = R.split(R.key(13), 3)
    lifted = tuple(a.expand((3,) + tuple(a.shape))
                   if isinstance(a, torch.Tensor) else a for a in args)
    tr = gf.simulate(keys, lifted)
    assert tr.get_retval().shape == (3, 5)
    for p in range(3):
        one = gf.simulate(keys[p], args)
        close(tr.get_retval()[p], one.get_retval(), rtol=1e-6, atol=1e-6)
        close(tr.get_score()[p], one.get_score(), rtol=1e-6, atol=1e-6)


def test_vmap_argument_validation():
    vm = _kernel(gt).vmap(in_axes=0)
    with pytest.raises(ValueError, match="axis size"):
        _kernel(gt).vmap(in_axes=None).simulate(R.key(0), (0.0,))

    @gt.gen
    def two(a, b):
        return gt.normal(a + b, 1.0) @ "x"

    with pytest.raises(ValueError, match="disagree"):
        two.vmap(in_axes=(0, 0)).simulate(R.key(0), (torch.zeros(4),
                                                     torch.zeros(5)))
    with pytest.raises(ValueError, match="out of bounds"):
        two.vmap(in_axes=(1, None)).simulate(R.key(0), (torch.zeros(4), 0.0))
    with pytest.raises(ValueError, match="entries for"):
        two.vmap(in_axes=(0,)).simulate(R.key(0), (torch.zeros(4),
                                                   torch.zeros(4)))
    tr = vm.simulate(R.key(0), (torch.zeros(8),))
    assert tr.get_choices().get_submap(3)["x"].ndim == 0
    assert tr.get_choices()[:, "x"].shape == (8,)
