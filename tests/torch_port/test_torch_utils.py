"""The port's utilities against the JAX package's
(``genjax_torch/utils/``; ``tests/utils/test_failure.py`` and
``test_aux.py``), and the long tail of the core (``PythonicPytree``, the
``Pytree`` helpers, ``to_shape_fn`` / ``empty_value``, ``do_checkify``,
``compat`` and ``experimental``).

- Checkpoints: ``.npz`` round trips of a trace and a state dict, a
  ``.npz`` the JAX package wrote restored into the port, and a
  ``torch.distributed.checkpoint`` directory saved by a gloo world of 2
  restored in a world of 1 and continued bit for bit.
- Elastic recovery: each ``test_failure.py`` case that has a meaning for
  one rank (transient NaN, giving up, the hang deadline, the checkpoint
  cadence and resume point, a failing recovery, no failure) with the
  JAX test's expectations, the transient NaN's final state bit for bit
  the unfailed run's.
- ``pformat`` / ``render_html``: the JAX package's text for the same
  choice maps (the HTML with its CSS, sparkline and chips).
- ``Timed`` and ``profile_trace`` (a Chrome trace with events).
"""

import json
import os
import time
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import genjax_torch as gt
import genjax_tpu as gj
import torch_dist_bodies as B
from genjax_torch.core import random as R
from genjax_torch.interop import key_from_numpy
from genjax_torch.utils import (
    Timed,
    Watchdog,
    all_finite,
    mesh_place,
    pformat,
    profile_trace,
    render_html,
    restore_checkpoint,
    run_elastic,
    save_checkpoint,
)
from genjax_tpu.utils import pformat as j_pformat
from genjax_tpu.utils import render_html as j_render_html
from genjax_tpu.utils import save_checkpoint as j_save_checkpoint

KEY = jax.random.key(314159)


def _tkey(k):
    return key_from_numpy(np.asarray(jax.random.key_data(k)))


# -- checkpoints ----------------------------------------------------------


def _model(lib):
    @lib.gen
    def model(mu):
        return lib.normal(mu, 1.0) @ "x"

    return model


def test_npz_roundtrip_trace(tmp_path):
    model = _model(gt)
    tr = model.simulate(_tkey(KEY), (0.5,))
    path = str(tmp_path / "trace.npz")
    save_checkpoint(path, tr)
    restored = restore_checkpoint(path, model.get_zero_trace(0.5))
    assert torch.equal(restored.get_score(), tr.get_score())
    assert torch.equal(restored.get_choices()["x"], tr.get_choices()["x"])


def test_npz_written_by_jax_restores_into_the_port(tmp_path):
    """A trace and a state dict saved by the JAX package: the two trees
    flatten in the same order (a dict's keys sorted), so ``leaf_i`` lands
    on the same leaf."""
    jtr = _model(gj).simulate(KEY, (0.5,))
    j_save_checkpoint(str(tmp_path / "trace.npz"), jtr)
    tr = restore_checkpoint(str(tmp_path / "trace.npz"),
                            _model(gt).get_zero_trace(0.5))
    np.testing.assert_array_equal(tr.get_choices()["x"].numpy(),
                                  np.asarray(jtr.get_choices()["x"]))
    np.testing.assert_array_equal(tr.get_score().numpy(),
                                  np.asarray(jtr.get_score()))
    state = {"xs": jnp.arange(6.0), "lw": -jnp.ones(6), "logz": 1.5,
             "k": jnp.asarray(3, jnp.int32)}
    j_save_checkpoint(str(tmp_path / "state.npz"), state)
    like = {"logz": 0.0, "xs": torch.zeros(6), "k": torch.zeros((),
            dtype=torch.int64), "lw": torch.zeros(6)}
    got = restore_checkpoint(str(tmp_path / "state.npz"), like)
    assert list(got) == list(like)
    assert got["logz"] == 1.5 and got["k"].dtype == torch.int64
    np.testing.assert_array_equal(got["xs"].numpy(), np.arange(6.0))
    np.testing.assert_array_equal(got["lw"].numpy(), -np.ones(6))
    # And the port's file in the JAX package's layout: the same leaves.
    save_checkpoint(str(tmp_path / "port.npz"), got)
    with np.load(str(tmp_path / "port.npz")) as a, \
            np.load(str(tmp_path / "state.npz")) as b:
        assert sorted(a.files) == sorted(b.files)
        for f in a.files:
            np.testing.assert_array_equal(a[f], b[f])


def test_dcp_directory_roundtrip_without_a_group(tmp_path):
    state = {"xs": torch.arange(8.0), "logz": torch.tensor(1.5)}
    save_checkpoint(str(tmp_path / "ckpt"), state)
    got = restore_checkpoint(str(tmp_path / "ckpt"),
                             {"xs": torch.zeros(8), "logz": torch.zeros(())})
    assert torch.equal(got["xs"], state["xs"])
    assert float(got["logz"]) == 1.5


def test_dcp_world_of_2_restores_in_a_world_of_1(gloo_worlds, tmp_path):
    """A world of 2 runs 16 steps with a transient NaN at step 13 and DCP
    checkpoints (each rank its rows as a ``Shard(0)`` DTensor); a world of
    1 restores its step-8 checkpoint whole and goes on to step 16. Both
    end bit for bit where the unfailed world of 1 ends."""
    xs0 = np.random.default_rng(0).standard_normal(64).astype(np.float32)
    kd = np.asarray(jax.random.key_data(KEY))
    two = str(tmp_path / "two")
    got2 = gloo_worlds(2).run(B.elastic_dcp, kd, xs0, two, 16, True)
    assert got2[0]["events"] == [("nonfinite", 12, 8, 2)]
    want = gloo_worlds(1).run(B.elastic_dcp, kd, xs0, str(tmp_path / "one"),
                              16, False)[0]
    assert want["events"] == []
    for k in ("xs", "lw", "t"):
        np.testing.assert_array_equal(
            np.concatenate([r["state"][k].reshape(-1) for r in got2])[
                :want["state"][k].size], want["state"][k].reshape(-1))
    # The world of 2's last checkpoint is step 16; its step-8 one is gone,
    # so the world of 1 resumes from a fresh world-of-2 run cut at 8.
    cut = str(tmp_path / "cut")
    gloo_worlds(2).run(B.elastic_dcp, kd, xs0, cut, 8, False)
    resumed = gloo_worlds(1).run(B.elastic_dcp, kd, xs0, cut, 16, False,
                                 8)[0]
    for k in ("xs", "lw", "t"):
        np.testing.assert_array_equal(resumed["state"][k], want["state"][k])


# -- elastic recovery -------------------------------------------------------


def _step(i, state):
    """The JAX test's step: step-indexed noise, a NaN at global step 5
    while ``poison``."""
    xs, poison = state
    eps = R.normal(R.fold_in(_tkey(KEY), i), tuple(xs.shape))
    xs = 0.9 * xs + 0.1 * eps
    xs = xs + torch.where((torch.tensor(i) == 5) & (poison != 0.0),
                          torch.nan, 0.0)
    return xs, poison


def _oracle(n_steps, xs0, tmp_path):
    res = run_elastic(_step, (xs0, torch.zeros(())), n_steps,
                      ckpt_path=str(tmp_path / "oracle.npz"), chunk=4)
    assert res.events == []
    return res.state[0]


def test_all_finite_flags():
    assert bool(all_finite({"a": torch.ones(3), "b": 2.0}))
    assert not bool(all_finite((torch.ones(3), torch.tensor(torch.nan))))
    assert not bool(all_finite({"a": float("inf")}))
    assert bool(all_finite(torch.arange(3)))


def test_watchdog_expiry():
    with Watchdog(1e-9) as dog:
        time.sleep(0.01)
    assert dog.expired
    with Watchdog(60.0) as dog:
        pass
    assert not dog.expired


def test_transient_nan_recovers_bitwise(tmp_path):
    xs0 = R.normal(R.key(1), (64,))
    places = []

    def place(state, devs):
        places.append(len(devs))
        return state[0], torch.zeros(())  # the fault is gone

    res = run_elastic(_step, (xs0, torch.ones(())), 16,
                      ckpt_path=str(tmp_path / "ck.npz"), chunk=4,
                      max_retries=2, place=place)
    assert len(res.events) == 1
    ev = res.events[0]
    assert ev.kind == "nonfinite" and ev.step == 4 and ev.resumed_from == 4
    assert ev.n_devices == 1 and places == [1, 1]
    assert res.steps_run == 16
    assert torch.equal(res.state[0], _oracle(16, xs0, tmp_path))


def test_persistent_failure_gives_up(tmp_path):
    def bad_step(i, state):
        raise ValueError("chip on fire")

    with pytest.raises(RuntimeError, match="giving up"):
        run_elastic(bad_step, torch.ones(4), 8,
                    ckpt_path=str(tmp_path / "ck.npz"), chunk=4,
                    max_retries=2)


def test_hang_deadline_detected(tmp_path):
    with pytest.raises(RuntimeError, match="hang"):
        run_elastic(lambda i, s: s + 1.0, torch.ones(4), 8,
                    ckpt_path=str(tmp_path / "ck.npz"), chunk=4,
                    max_retries=1, deadline=1e-12)


def test_checkpoint_cadence_and_resume_point(tmp_path):
    """A fault at step 13 with checkpoints every 2 chunks (8 steps):
    recovery resumes from step 8, replaying 8..13."""
    xs0 = R.normal(R.key(3), (16,))

    def step13(i, state):
        xs, poison = state
        xs = xs * 1.001
        xs = xs + torch.where((torch.tensor(i) == 13) & (poison != 0.0),
                              torch.nan, 0.0)
        return xs, poison

    def place(state, devs):
        return state[0], torch.zeros(())

    res = run_elastic(step13, (xs0, torch.ones(())), 24,
                      ckpt_path=str(tmp_path / "ck.npz"), chunk=4,
                      checkpoint_every=2, max_retries=2, place=place)
    assert res.events[0].step == 12
    assert res.events[0].resumed_from == 8
    np.testing.assert_allclose(res.state[0].numpy(),
                               xs0.numpy() * 1.001 ** 24, rtol=1e-5)


def test_recovery_failure_counts_as_retry(tmp_path):
    calls = {"n": 0}

    def bad_place(state, devs):
        calls["n"] += 1
        raise OSError("checkpoint store unreachable")

    with pytest.raises(RuntimeError, match="giving up"):
        run_elastic(lambda i, s: s + torch.nan, torch.ones(4), 8,
                    ckpt_path=str(tmp_path / "ck.npz"), chunk=4,
                    max_retries=2, place=bad_place)
    assert calls["n"] >= 1


def test_no_failure_no_events(tmp_path):
    xs0 = torch.ones(8)
    res = run_elastic(lambda i, s: s * 2.0, xs0, 8,
                      ckpt_path=str(tmp_path / "ck.npz"), chunk=4)
    assert res.events == []
    assert torch.equal(res.state, xs0 * 2.0 ** 8)
    with pytest.raises(ValueError, match="multiple of chunk"):
        run_elastic(lambda i, s: s, xs0, 6,
                    ckpt_path=str(tmp_path / "ck.npz"), chunk=4)


def test_mesh_place_without_a_group():
    state = {"xs": torch.arange(8.0), "logz": torch.zeros(())}
    placed = mesh_place("particles")(state, [torch.device("cpu")])
    assert placed is state
    with pytest.raises(RuntimeError, match="min_devices"):
        mesh_place("particles", min_devices=9)(state, [0])


# -- rendering --------------------------------------------------------------


def _maps(lib):
    arr = jnp.ones(3) if lib is gj else torch.ones(3)
    lin = (jnp.linspace(-1.0, 1.0, 64) if lib is gj
           else torch.linspace(-1.0, 1.0, 64))
    return [lib.C["a"].set(1.0) | lib.C["b", "c"].set(arr),
            lib.C["outer", "inner"].set(2.0),
            lib.C["xs"].set(lin)]


def _switches(lib, choice_map, mask):
    def t(v):
        # Integer indices as int32 in both (the same trees).
        if lib is gj:
            return jnp.asarray(v)
        out = torch.tensor(v)
        return out.to(torch.int32) if out.dtype == torch.int64 else out

    b0, b1 = lib.C["x"].set(1.0), lib.C["y"].set(2.0)
    return [choice_map.Switch(t(1), (b0, b1)),
            choice_map.Switch(t([0, 1, 1, 1]), (b0, b1)),
            lib.C["m"].set(mask.Mask(t([0.0, 1.0, 2.0, 3.0]),
                                     t([True, False, True, True]))),
            lib.C["m"].set(mask.Mask(1.0, t(False)))]


def test_pformat_and_html_match_jax():
    from genjax_torch.gfi import choice_map as tcm
    from genjax_torch.gfi import mask as tmask
    from genjax_tpu.gfi import choice_map as jcm
    from genjax_tpu.gfi import mask as jmask

    got = _maps(gt) + _switches(gt, tcm, tmask)
    want = _maps(gj) + _switches(gj, jcm, jmask)
    for g, w in zip(got, want):
        assert pformat(g) == j_pformat(w)
        assert render_html(g) == j_render_html(w)
    s = pformat(got[3])
    assert "branch 1: ← active" in s and "branch 0: (inactive)" in s
    assert "(1/4 lanes)" in pformat(got[4])
    assert "active 3/4 lanes" in pformat(got[5])
    assert "INACTIVE" in pformat(got[6])
    assert "<svg" in render_html(got[2])


def test_pformat_trace_and_pretty():
    from genjax_torch.utils.pretty import pretty

    @gt.gen
    def model():
        x = gt.normal(0.0, 1.0) @ "x"
        return gt.normal(x, 1.0) @ "y"

    tr = model.simulate(R.key(0), ())
    s = pformat(tr)
    assert "'x'" in s and "'y'" in s and "score" in s
    assert tr.pformat() == s
    pretty()
    assert "<details" in tr._repr_html_() and "score" in tr._repr_html_()
    assert "<details" in gt.C["a"].set(1.0)._repr_html_()
    # A meta tensor renders by its shape and dtype, as a tracer does.
    assert "Tracer(8,)[float32]" in pformat(
        gt.C["x"].set(torch.empty(8, device="meta")))


# -- profiling --------------------------------------------------------------


def test_timed_records_the_wall():
    t = Timed(lambda x: (x * 2.0).sum())
    out = t(torch.ones(64))
    assert float(out) == 128.0
    assert t.last_s is not None and t.last_s >= 0.0


def test_profile_trace_writes_a_chrome_trace(tmp_path):
    d = str(tmp_path / "trace")
    with profile_trace(d) as prof:
        (torch.arange(8.0) + 1).sum()
    with open(os.path.join(d, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name", "").startswith("aten::") for e in events)
    assert len(prof.key_averages()) > 0


# -- the core's long tail ---------------------------------------------------


def test_pythonic_pytree_and_helpers():
    @gt.Pytree.dataclass
    class Pair(gt.PythonicPytree):
        a: torch.Tensor
        b: torch.Tensor

    p = Pair(torch.arange(3.0), torch.arange(3.0) * 2)
    assert len(p) == 3
    assert float(p[1].b) == 2.0
    assert [float(q.a) for q in p] == [0.0, 1.0, 2.0]
    assert len(p + p) == 6
    c = gt.Pytree.tree_const({"k": 3, "f": "x"})
    assert isinstance(c["k"], gt.Const)
    assert gt.Pytree.tree_const_unwrap(c) == {"k": 3, "f": "x"}

    @gt.Pytree.partial(torch.tensor(2.0))
    def scaled(s, x):
        return s * x

    assert isinstance(scaled, gt.Closure)
    assert float(scaled(torch.tensor(3.0))) == 6.0
    assert "<details" in p.render_html() and "float32[3]" in p.pformat()


def test_to_shape_fn_and_empty_value():
    def f(x, n=2):
        return {"y": x[:, None] * torch.ones(n), "s": x.sum(), "c": 1.0}

    shapes = gt.to_shape_fn(f)(torch.ones(4))
    assert shapes["y"].device.type == "meta"
    assert tuple(shapes["y"].shape) == (4, 2) and shapes["s"].shape == ()
    zeros = gt.empty_value(f, torch.ones(4), n=3)
    assert torch.equal(zeros["y"], torch.zeros(4, 3))
    assert zeros["c"].dtype == torch.float32
    from genjax_tpu.core.compiler.staging import empty_value as j_empty

    jz = j_empty(lambda x: {"y": x[:, None] * jnp.ones(3),
                                   "s": x.sum(), "c": 1.0}, jnp.ones(4))
    for k in jz:
        assert tuple(zeros[k].shape) == tuple(jz[k].shape)


def test_do_checkify_nests():
    from genjax_torch.gfi.mask import Mask

    m = Mask(torch.ones(2), torch.tensor(False))
    m.unmask()  # no check outside the context
    with gt.do_checkify():
        with pytest.raises(ValueError, match="unmask"):
            m.unmask()
        with gt.do_checkify():
            with pytest.raises(ValueError, match="unmask"):
                m.unmask()
        with pytest.raises(ValueError, match="unmask"):
            m.unmask()
    m.unmask()
    Mask(torch.ones(2), torch.tensor(True)).unmask(checked=True)


def test_compat_warning_text_matches_jax():
    import genjax_torch.experimental  # noqa: F401
    from genjax_torch.compat import implicit_logit_warning
    from genjax_tpu.compat import implicit_logit_warning as j_warning

    with warnings.catch_warnings(record=True) as got:
        warnings.simplefilter("always")
        implicit_logit_warning(gt.flip)(0.3)
    with warnings.catch_warnings(record=True) as want:
        warnings.simplefilter("always")
        j_warning(gj.flip)(0.3)
    assert got[0].category is DeprecationWarning
    assert str(got[0].message) == str(want[0].message)
    gen = implicit_logit_warning(gt.flip)(probs=0.5)
    assert abs(float(gen.args[0])) < 1e-7
    with pytest.raises(TypeError, match="exactly one"):
        implicit_logit_warning(gt.flip)(0.3, probs=0.5)
