"""Two faults of the port's choice maps that the documented programs
found, each held against the JAX package on the CPU:

- a lane of a Vmap over a Scan read every step: the Scan's ``Indexed``
  node kept counting the Vmap's lane axis among its batch axes after
  the lane was taken (cookbook 12, ``tr.get_choices()[1, 2, "x"]``);
- a constraint built step by step (``C["chain", t, "y"]`` merged with
  ``|``) could not filter a batched Scan trace: the one-step values
  lacked the lane axis of the per-lane flags (example 11,
  ``run_nuts`` on a Scan model);
- merging such one-step values took a lane-invariant value's batch axis
  for the lane axis where the batch and the lane count are equal: a
  value now takes its own flag's rank before the merge."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import genjax_torch as gt
import genjax_tpu as gj
from genjax_torch.core import random as R
from genjax_torch.gfi.mask import Mask
from genjax_torch.inference import Target
from genjax_torch.inference.smc import lift_target
from genjax_tpu.inference import Target as JTarget


def _walk(lib):
    @lib.gen
    def walk_step(prev, _):
        x = lib.normal(prev, 1.0) @ "x"
        return x, x

    return walk_step


@pytest.mark.parametrize("lane,step", [(0, 0), (1, 2), (2, 3)])
def test_vmap_of_scan_lane_then_step(lane, step):
    jfleet = _walk(gj).scan(n=4).vmap(in_axes=(0, None))
    tfleet = _walk(gt).scan(n=4).vmap(in_axes=(0, None))
    jtr = jfleet.simulate(jax.random.key(0), (jnp.zeros(3), None))
    ttr = tfleet.simulate(R.key(0), (torch.zeros(3), None))
    want = float(jtr.get_choices()[lane, step, "x"])
    got = ttr.get_choices()[lane, step, "x"]
    assert got.shape == ()
    assert float(got) == pytest.approx(want, rel=1e-5)
    lane_map = ttr.get_choices().get_submap(lane)
    np.testing.assert_allclose(
        lane_map[:, "x"].numpy(),
        np.asarray(jtr.get_choices()[lane, :, "x"]), rtol=1e-5)


def _scan_model(lib, T):
    @lib.gen
    def step(carry, _):
        s = lib.normal(0.0, 1.0) @ "s"
        _ = lib.normal(s, 1.0) @ "y"
        return carry, None

    @lib.gen
    def model():
        _ = step.scan(n=T)(0.0, None) @ "chain"

    return model


def test_stepwise_constraint_filters_a_batched_scan_trace():
    """Importance on a batch of 2 keys against ``jax.vmap`` of the JAX
    package's, then ``filter_to_unconstrained``: the same latent values,
    and no observation left."""
    T = 4
    jobs, tobs = gj.ChoiceMap.empty(), gt.ChoiceMap.empty()
    for t in range(T):
        jobs = jobs | gj.C["chain", t, "y"].set(1.0 + t)
        tobs = tobs | gt.C["chain", t, "y"].set(torch.tensor(1.0 + t))
    jt = JTarget(_scan_model(gj, T), (), jobs)
    # The constraint lifted to the batch, as run_nuts lifts it.
    tt = lift_target(Target(_scan_model(gt, T), (), tobs), 2, "cpu")
    keys = jax.random.split(jax.random.key(3), 2)
    jtrs, jws = jax.vmap(lambda k: jt.importance(k, gj.ChoiceMap.empty()))(
        keys)
    ttrs, tws = tt.importance(R.split(R.key(3), 2), gt.ChoiceMap.empty())
    np.testing.assert_allclose(tws.numpy(), np.asarray(jws), rtol=1e-5)
    latents = tt.filter_to_unconstrained(ttrs.get_choices())
    want = np.asarray(jtrs.get_choices()["chain", :, "s"])  # (2, T)
    got = np.stack([latents["chain", t, "s"].numpy() for t in range(T)],
                   axis=1)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    y = latents.get_submap("chain").get_submap(0).get_submap("y")
    assert y.static_is_empty() or not bool(
        torch.as_tensor(Mask.build(y.get_value()).flag).any())


def test_mask_merge_aligns_lane_invariant_values():
    """``Mask | Mask`` of a per-lane value (batch, lanes) and a
    lane-invariant one (batch,) broadcasts the second over the lanes."""
    per_lane = Mask(torch.arange(8.0).reshape(2, 4),
                    torch.tensor([[True, False, True, False]] * 2))
    invariant = Mask(torch.tensor([10.0, 20.0]),
                     torch.ones(1, 4, dtype=torch.bool))
    out = per_lane | invariant
    assert torch.equal(out.value, torch.tensor(
        [[0.0, 10.0, 2.0, 10.0], [4.0, 20.0, 6.0, 20.0]]))
    assert bool(out.flag.all())


def test_stepwise_values_read_by_lane_with_batch_equal_to_lanes():
    """Per-execution values of a step-by-step constraint read through a
    lane index behind the batch axis (the layout ``Indexed.filter`` gives),
    with 4 executions and 4 lanes, against ``jax.vmap`` over executions
    and lanes of the JAX package's read of one step."""
    T = B = 4
    ys = np.random.default_rng(0).normal(size=(B, T)).astype(np.float32)

    def jread(y, t):
        obs = gj.ChoiceMap.empty()
        for s in range(T):
            obs = obs | gj.C["chain", s, "y"].set(y[s])
        v = obs.get_submap("chain").get_submap(t).get_submap("y").get_value()
        return v.value if hasattr(v, "value") else v

    want = jax.vmap(lambda y: jax.vmap(lambda t: jread(y, t))(
        jnp.arange(T)))(jnp.asarray(ys))
    tobs = gt.ChoiceMap.empty()
    for s in range(T):
        tobs = tobs | gt.C["chain", s, "y"].set(torch.from_numpy(
            ys[:, s].copy()))
    got = tobs.get_submap("chain").get_submap(
        torch.arange(T).reshape(1, T)).get_submap("y").get_value()
    assert bool(torch.as_tensor(got.flag).all())
    np.testing.assert_array_equal(got.value.numpy(), np.asarray(want))


def test_mask_merge_with_batch_equal_to_lanes():
    """``Mask | Mask`` of a per-lane value (4, 4) and a lane-invariant
    one (4,) under a per-lane flag spreads the second over the lanes, not
    over the executions, against ``jax.vmap`` of the JAX package's merge
    over executions and lanes."""
    from genjax_tpu.gfi.mask import Mask as JMask

    per_lane = np.arange(16.0, dtype=np.float32).reshape(4, 4)
    invariant = np.array([10.0, 20.0, 30.0, 40.0], dtype=np.float32)
    lane_flag = np.array([True, False, True, False])
    want = jax.vmap(lambda p, c: jax.vmap(
        lambda pv, f: (JMask(pv, f) | JMask(c, jnp.bool_(True))).value)(
            p, jnp.asarray(lane_flag)))(jnp.asarray(per_lane),
                                        jnp.asarray(invariant))
    out = Mask(torch.from_numpy(per_lane),
               torch.from_numpy(lane_flag).reshape(1, 4).expand(4, 4)) | \
        Mask(torch.from_numpy(invariant), torch.ones(1, 4, dtype=torch.bool))
    np.testing.assert_array_equal(out.value.numpy(), np.asarray(want))
    assert bool(out.flag.all())
