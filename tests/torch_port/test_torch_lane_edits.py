"""Per-lane Vmap constraints and per-execution ``IndexRequest`` edits of
the port against the JAX package on the same key data.

- Every per-lane constraint form (an ``Indexed`` node with an index array
  and duplicate addresses, integer ``Static`` keys, ``Or``, ``Filtered``,
  ``Switch`` and masked nodes) through ``Vmap.generate``, ``assess`` and
  an ``Update`` edit, against the JAX package's ``Vmap``, which reads
  ``constraint.get_submap(i)`` per lane under ``jax.vmap``; and a key
  batch against its executions one by one.
- An ``IndexRequest`` with one index per execution on Vmap and on Scan
  (``Update`` and ``Regenerate`` sub-requests, indices in range, negative
  and past the end) against ``jax.vmap`` of the JAX edit with the index
  mapped; the backward request restores the trace.
- A JAX trace edited under ``jax.vmap`` carried across
  (``interop.lanes_from_numpy``) as an ``Update`` of the port's trace.

Tolerance: weights, scores and values to 1e-5 relative and 1e-5
absolute (the two packages' normals agree to a few ulp); a batch against
its executions to 1e-6."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import genjax_torch as gt
import genjax_tpu as gj
from genjax_torch.core import random as R
from genjax_torch.gfi.choice_map import lift_values
from genjax_torch.interop import key_from_numpy

TOL = dict(rtol=1e-5, atol=1e-5)
N = 5


def _tkey(k):
    return key_from_numpy(np.asarray(jax.random.key_data(k)))


def _np(x):
    return np.asarray(x.detach().cpu() if isinstance(x, torch.Tensor) else x,
                      np.float64)


def close(a, b, **kw):
    np.testing.assert_allclose(_np(a), _np(b), **(kw or TOL))


def _kernel(lib):
    @lib.gen
    def kernel(mu):
        x = lib.normal(mu, 1.0) @ "x"
        y = lib.normal(x, 0.5) @ "y"
        return x + y

    return kernel


def _walk(lib):
    @lib.gen
    def walk_step(carry, _):
        x = lib.normal(carry, 1.0) @ "x"
        return x, carry

    return walk_step


def _vals(lib, xs):
    return (jnp.asarray(xs, jnp.float32) if lib is gj
            else torch.tensor(xs, dtype=torch.float32))


def _constraint(lib, form):
    """One per-lane constraint form, built the same way in both
    packages."""
    c = lib.ChoiceMap
    if form == "index_array":
        return c.entry(_vals(lib, [1.5, -0.5, 0.25]), (
            jnp.array([3, 0, 3]) if lib is gj else torch.tensor([3, 0, 3])),
            "x")
    if form == "index_array_short":
        return c.entry(_vals(lib, [0.75, -1.0]), (
            jnp.array([4, 1]) if lib is gj else torch.tensor([4, 1])), "y")
    if form == "static_int":
        return lib.C[1, "x"].set(0.5) | lib.C[3, "y"].set(-0.25)
    if form == "canonical":
        return lib.C[:, "x"].set(_vals(lib, [0.1, 0.2, 0.3, 0.4, 0.5]))
    if form == "or":
        return (_constraint(lib, "index_array")
                | lib.C[0, "y"].set(2.0) | lib.C[3, "x"].set(9.0))
    if form == "filtered":
        sel = lib.Selection.at[3, "x"] | lib.Selection.at[0]
        return _constraint(lib, "or").filter(sel)
    if form == "masked":
        flag = jnp.array(False) if lib is gj else torch.tensor(False)
        return (_constraint(lib, "static_int").mask(flag)
                | lib.C[2, "x"].set(1.0))
    if form == "switch":
        idx = jnp.array(1) if lib is gj else torch.tensor(1)
        return c.switch(idx, [lib.C[0, "x"].set(3.0),
                              _constraint(lib, "index_array")])
    raise KeyError(form)


FORMS = ["index_array", "index_array_short", "static_int", "canonical", "or",
         "filtered", "masked", "switch"]


def _lane_values(tr, n=N):
    ch = tr.get_choices()
    return [(ch[i, "x"], ch[i, "y"]) for i in range(n)]


@pytest.mark.parametrize("form", FORMS)
def test_lane_constraint_forms_match_jax(form):
    vj, vt = _kernel(gj).vmap(), _kernel(gt).vmap()
    mus_j, mus_t = jnp.arange(float(N)), torch.arange(float(N))
    k = jax.random.key(11)
    cj, ct = _constraint(gj, form), _constraint(gt, form)
    trj, wj = vj.generate(k, cj, (mus_j,))
    trt, wt = vt.generate(_tkey(k), ct, (mus_t,))
    close(wt, wj)
    close(trt.get_score(), trj.get_score())
    for (xt, yt), (xj, yj) in zip(_lane_values(trt), _lane_values(trj)):
        close(xt, xj)
        close(yt, yj)
    # Update of a simulated trace with the same constraint.
    sk = jax.random.key(12)
    sj = vj.simulate(sk, (mus_j,))
    st = vt.simulate(_tkey(sk), (mus_t,))
    nj, uwj, _, bj = sj.edit(jax.random.key(13), gj.Update(cj))
    nt, uwt, _, bt = st.edit(_tkey(jax.random.key(13)), gt.Update(ct))
    close(uwt, uwj)
    close(nt.get_score(), nj.get_score())
    for (xt, yt), (xj, yj) in zip(_lane_values(nt), _lane_values(nj)):
        close(xt, xj)
        close(yt, yj)
    # The backward Update restores the simulated trace.
    back, bw, _, _ = nt.edit(_tkey(jax.random.key(14)), bt)
    close(bw, -uwt)
    for (xt, yt), (xo, yo) in zip(_lane_values(back), _lane_values(st)):
        close(xt, xo, rtol=0, atol=0)
        close(yt, yo, rtol=0, atol=0)


@pytest.mark.parametrize("form", ["index_array", "or", "filtered", "switch"])
def test_lane_constraint_assess_and_batch(form):
    """``assess`` reads a complete per-lane map through the same forms,
    and a key batch with the constraint lifted to it equals its
    executions one by one."""
    vt = _kernel(gt).vmap()
    mus = torch.arange(float(N))
    ct = _constraint(gt, form)
    keys = R.split(R.key(3), 3)
    tr, w = vt.generate(keys, lift_values(ct, (3,)),
                        (mus.expand(3, N),))
    for p in range(3):
        one, w1 = vt.generate(keys[p], ct, (mus,))
        close(w[p], w1, rtol=1e-6, atol=1e-6)
        for (xt, yt), (x1, y1) in zip(_lane_values(tr), _lane_values(one)):
            close(xt[p], x1, rtol=0, atol=0)
            close(yt[p], y1, rtol=0, atol=0)
    full = tr.get_choices()
    s, _ = vt.assess(full, (mus.expand(3, N),), batch=(3,))
    close(s, tr.get_score(), rtol=1e-6, atol=1e-6)


def _sub(lib, kind):
    if kind == "update":
        return lib.Update(lib.C["x"].set(0.625))
    return lib.Regenerate(lib.Selection.at["x"])


@pytest.mark.parametrize("kind", ["update", "regenerate"])
@pytest.mark.parametrize("idx", [[0, 3, 1, 4], [-1, 2, 5, -6]],
                         ids=["in_range", "out_of_range"])
def test_vmap_index_request_per_execution_matches_jax_vmap(kind, idx):
    vj, vt = _kernel(gj).vmap(), _kernel(gt).vmap()
    b = len(idx)
    keys_j = jax.random.split(jax.random.key(21), b)
    ekeys_j = jax.random.split(jax.random.key(22), b)
    mus_j = jnp.broadcast_to(jnp.arange(float(N)), (b, N))
    trj = jax.vmap(lambda k, m: vj.simulate(k, (m,)))(keys_j, mus_j)
    trt = vt.simulate(_tkey(keys_j), (torch.arange(float(N)).expand(b, N),))
    ij = jnp.asarray(idx)

    def one(k, tr, i):
        new, w, _, _ = tr.edit(k, gj.IndexRequest(i, _sub(gj, kind)))
        return new.get_choices()[:, "x"], new.get_choices()[:, "y"], w, \
            new.get_score()

    xj, yj, wj, sj = jax.vmap(one)(ekeys_j, trj, ij)
    it = torch.tensor(idx)
    nt, wt, _, bwd = trt.edit(_tkey(ekeys_j),
                              gt.IndexRequest(it, _sub(gt, kind)))
    close(wt, wj)
    close(nt.get_score(), sj)
    close(nt.get_choices()[:, "x"], xj)
    close(nt.get_choices()[:, "y"], yj)
    if kind == "update" and min(idx) >= 0 and max(idx) < N:
        back, bw, _, _ = nt.edit(_tkey(ekeys_j), bwd)
        close(bw, -wt)
        assert torch.equal(back.get_choices()[:, "x"],
                           trt.get_choices()[:, "x"])


@pytest.mark.parametrize("kind", ["update", "regenerate"])
@pytest.mark.parametrize("idx", [[0, 2, 3, 4], [-1, 5, 1, -5]],
                         ids=["in_range", "out_of_range"])
def test_scan_index_request_per_execution_matches_jax_vmap(kind, idx):
    sj, st = _walk(gj).scan(n=N), _walk(gt).scan(n=N)
    b = len(idx)
    keys_j = jax.random.split(jax.random.key(31), b)
    ekeys_j = jax.random.split(jax.random.key(32), b)
    trj = jax.vmap(lambda k: sj.simulate(k, (0.5, None)))(keys_j)
    trt = st.simulate(_tkey(keys_j), (0.5, None))
    ij = jnp.asarray(idx)

    def one(k, tr, i):
        new, w, _, _ = tr.edit(k, gj.IndexRequest(i, _sub(gj, kind)))
        final, outs = new.get_retval()
        return new.get_choices()[:, "x"], w, new.get_score(), final, outs

    xj, wj, scj, fj, oj = jax.vmap(one)(ekeys_j, trj, ij)
    nt, wt, _, bwd = trt.edit(_tkey(ekeys_j),
                              gt.IndexRequest(torch.tensor(idx),
                                              _sub(gt, kind)))
    close(wt, wj)
    close(nt.get_score(), scj)
    close(nt.get_choices()[:, "x"], xj)
    close(nt.get_retval()[0], fj)
    close(nt.get_retval()[1], oj)
    if min(idx) >= 0:
        # In range, each execution equals the int-indexed edit of its own
        # trace, and the backward request restores the trace.
        for p in range(b):
            one_tr = st.simulate(_tkey(keys_j[p]), (0.5, None))
            n1, w1, _, _ = one_tr.edit(_tkey(ekeys_j[p]), gt.IndexRequest(
                idx[p], _sub(gt, kind)))
            close(wt[p], w1, rtol=1e-6, atol=1e-6)
            close(nt.get_choices()[:, "x"][p], n1.get_choices()[:, "x"],
                  rtol=0, atol=0)
    if kind == "update" and min(idx) >= 0:
        back, bw, _, _ = nt.edit(_tkey(ekeys_j), bwd)
        close(bw, -wt)
        assert torch.equal(back.get_choices()[:, "x"],
                           trt.get_choices()[:, "x"])


@pytest.mark.parametrize("idx", [2, -1, 5, -6])
def test_vmap_zero_d_index_matches_jax(idx):
    """A 0-d index names the same lane in every execution; out of range it
    reads and writes as the JAX package's array indexing does (negative
    from the end, reads clamped, writes dropped)."""
    vj, vt = _kernel(gj).vmap(), _kernel(gt).vmap()
    b = 3
    keys_j = jax.random.split(jax.random.key(23), b)
    ekeys_j = jax.random.split(jax.random.key(24), b)
    mus_j = jnp.broadcast_to(jnp.arange(float(N)), (b, N))
    trj = jax.vmap(lambda k, m: vj.simulate(k, (m,)))(keys_j, mus_j)
    trt = vt.simulate(_tkey(keys_j), (torch.arange(float(N)).expand(b, N),))

    def one(k, tr):
        new, w, _, _ = tr.edit(k, gj.IndexRequest(idx, _sub(gj, "update")))
        return new.get_choices()[:, "x"], w

    xj, wj = jax.vmap(one)(ekeys_j, trj)
    nt, wt, _, _ = trt.edit(_tkey(ekeys_j),
                            gt.IndexRequest(idx, _sub(gt, "update")))
    close(wt, wj)
    close(nt.get_choices()[:, "x"], xj)


def test_scan_zero_d_index_out_of_range_raises():
    """A 0-d Scan index must lie in range, as the JAX repair's check
    requires."""
    st = _walk(gt).scan(n=N)
    trs = st.simulate(R.split(R.key(0), 3), (0.5, None))
    for idx in (N, -1, torch.tensor(N)):
        with pytest.raises(IndexError, match="out of range"):
            trs.edit(R.split(R.key(1), 3),
                     gt.IndexRequest(idx, _sub(gt, "update")))


def test_per_execution_index_shape_is_checked():
    vt = _kernel(gt).vmap()
    keys = R.split(R.key(0), 3)
    tr = vt.simulate(keys, (torch.arange(float(N)).expand(3, N),))
    with pytest.raises(ValueError, match="one index per execution"):
        tr.edit(R.split(R.key(1), 3),
                gt.IndexRequest(torch.tensor([0, 1]), _sub(gt, "update")))
    # Under changed arguments (a new initial carry per execution) a Scan
    # index per execution lowers to the whole-chain request at each
    # execution's own step, as ``jax.vmap`` of the JAX edit does; an
    # index out of range edits no step. The port's trace starts from the
    # JAX trace's choices (``lanes_from_numpy``), so the choices an edit
    # keeps or constrains are bit for bit JAX's; a regenerated one is a
    # fresh normal, a few ulp from JAX's draw (to 1e-5). Weights and
    # scores to 1e-5.
    from genjax_torch.interop import lanes_from_numpy

    sj, st = _walk(gj).scan(n=N), _walk(gt).scan(n=N)
    keys_j = jax.random.split(jax.random.key(0), 3)
    ekeys_j = jax.random.split(jax.random.key(1), 3)
    carry = np.asarray([1.0, -0.5, 2.0], np.float32)
    trj = jax.vmap(lambda k: sj.simulate(k, (0.5, None)))(keys_j)
    trs, _ = st.generate(_tkey(keys_j), lanes_from_numpy(
        {"x": np.asarray(trj.get_choices()[:, "x"])}, batch_rank=1),
        (0.5, None))
    close(trs.get_choices()[:, "x"], trj.get_choices()[:, "x"], rtol=0,
          atol=0)
    for kind in ("update", "regenerate"):
        for idx in ([0, 1, 2], [4, -1, 5]):
            def one(k, tr, i, c):
                new, w, _, _ = tr.edit(
                    k, gj.IndexRequest(i, _sub(gj, kind)),
                    gj.Diff.unknown_change((c, None)))
                return new.get_choices()[:, "x"], w, new.get_score()

            xj, wj, scj = jax.vmap(one)(ekeys_j, trj, jnp.asarray(idx),
                                        jnp.asarray(carry))
            nt, wt, _, _ = trs.edit(
                _tkey(ekeys_j),
                gt.IndexRequest(torch.tensor(idx), _sub(gt, kind)),
                gt.Diff.unknown_change((torch.tensor(carry), None)))
            edited = (np.arange(N)[None] == np.asarray(idx)[:, None])
            kept = ~edited if kind == "regenerate" else np.ones_like(edited)
            xt = _np(nt.get_choices()[:, "x"])
            np.testing.assert_array_equal(xt[kept], _np(xj)[kept])
            close(xt, xj)
            close(wt, wj)
            close(nt.get_score(), scj)
    with pytest.raises(ValueError, match="one index per execution"):
        trs.edit(_tkey(ekeys_j),
                 gt.IndexRequest(torch.tensor([0, 1]), _sub(gt, "update")),
                 gt.Diff.unknown_change((torch.tensor(carry), None)))


def test_jax_edited_lanes_carried_across():
    """A JAX Vmap trace edited per execution under ``jax.vmap`` carries
    its stacked choices across (``interop.lanes_from_numpy``): an
    ``Update`` of the port's trace to them lands on the JAX trace's
    choices and score, and weighs the score change."""
    from genjax_torch.interop import lanes_from_numpy

    vj, vt = _kernel(gj).vmap(), _kernel(gt).vmap()
    b = 3
    keys_j = jax.random.split(jax.random.key(41), b)
    mus_j = jnp.broadcast_to(jnp.arange(float(N)), (b, N))
    trj = jax.vmap(lambda k, m: vj.simulate(k, (m,)))(keys_j, mus_j)
    edited = jax.vmap(lambda k, tr, i: tr.edit(
        k, gj.IndexRequest(i, gj.Regenerate(gj.S.at["x"])))[0])(
        jax.random.split(jax.random.key(42), b), trj, jnp.asarray([0, 2, 4]))
    chm = lanes_from_numpy({
        "x": np.asarray(edited.get_choices()[:, "x"]),
        "y": np.asarray(edited.get_choices()[:, "y"])}, batch_rank=1)
    trt = vt.simulate(_tkey(keys_j), (torch.arange(float(N)).expand(b, N),))
    new, w, _, _ = trt.edit(_tkey(jax.random.split(jax.random.key(43), b)),
                            gt.Update(chm))
    close(new.get_choices()[:, "x"], edited.get_choices()[:, "x"],
          rtol=0, atol=0)
    close(new.get_score(), jax.vmap(lambda tr: tr.get_score())(edited))
    close(w, new.get_score() - trt.get_score())
