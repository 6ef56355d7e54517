"""The benchmark's reference against the port's plain paths at tiny
sizes on the CPU: the frozen key layer draw for draw, the offspring
counts, the inputs, and whole filter calls of each driver judged within
rounding, with the lower-precision control and a broken record judged
wrong."""

import importlib
import math
import subprocess
import sys

import pytest
import torch

from portbench.lib import plugins
from portbench.reference import filters, threefry

KEYS = [0, 7, 2**31 + 5, 2**32 - 1]


@pytest.mark.parametrize("seed", KEYS)
def test_key_layer_draw_for_draw(seed):
    from genjax_torch.core import random as R

    k = threefry.seed_key(seed)
    assert torch.equal(k, R.key(seed))
    assert torch.equal(threefry.split(k, 3), R.split(k, 3))
    idx = torch.arange(5)
    assert torch.equal(threefry.fold_in(k[None, :], idx), R.fold_in(k, idx))
    assert torch.equal(threefry.bits(k, (2, 3)), R.bits(k, (2, 3)))
    assert torch.equal(threefry.uniform(k, (64,)).float(), R.uniform(k, (64,)))
    torch.testing.assert_close(threefry.normal(k, (64,)).float(),
                               R.normal(k, (64,)), rtol=2e-6, atol=2e-6)
    torch.testing.assert_close(threefry.gumbel(k, (64,)).float(),
                               R.gumbel(k, (64,)), rtol=2e-6, atol=2e-6)


def test_seed_key_takes_64_bits():
    k = threefry.seed_key(2**40 + 3)
    assert k.tolist() == [256, 3]
    with pytest.raises(ValueError):
        threefry.seed_key(-1)


def test_counter_normals_are_the_fused_steps():
    from genjax_torch.ops.fused_step import normal_from_counter

    k = threefry.seed_key(11)
    torch.testing.assert_close(threefry.counter_normal(k, 1000).float(),
                               normal_from_counter(k[0], k[1],
                                                   torch.arange(1000)),
                               rtol=2e-6, atol=2e-6)


@pytest.mark.parametrize("n", [1, 17, 4096])
def test_counts_are_the_plain_kernels(n):
    from genjax_torch.ops.cdf_counts import systematic_cumulative_plain

    k = threefry.seed_key(n)
    lw = 3.0 * threefry.normal(k, (n,)).float()
    ours = filters.systematic_counts(k, lw, n)
    theirs = systematic_cumulative_plain(k, lw, n)
    assert int((ours - theirs.long()).abs().max()) <= 1
    assert int(ours[-1]) == n and bool((torch.diff(ours) >= 0).all())


def test_reference_imports_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, '.');"
            "import portbench.reference.threefry, portbench.reference.filters;"
            "from portbench.lib import plugins;"
            "[plugins.module('configs', c) for c in "
            "('tracking-1d', 'hmm-circulant-64')];"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('genjax_torch', 'genjax_tpu', 'jax', 'jaxlib', 'flax')];"
            "print(bad); sys.exit(1 if bad else 0)")
    root = plugins.ROOT.rsplit("/", 1)[0]
    proc = subprocess.run([sys.executable, "-c", code], cwd=root,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


CELL = {"fused_pf": "tracking-1d", "batched_pf": "tracking-1d",
        "hmm_pf": "hmm-circulant-64"}


def _driver(name, n, **mix):
    cfg = plugins.data("configs", CELL[name])
    mix = dict({"driver": name, "particles": n, "data_seed": 3}, **mix)
    drv = plugins.module("drivers", name).Driver(cfg, mix,
                                                 torch.device("cpu"), 1)
    drv.setup()
    return drv


def _filter_call(name, n, state_dtype="float32"):
    drv = _driver(name, n, state_dtype=state_dtype)
    try:
        key = threefry.seed_key(4242)
        drv.record(True)
        kept = [(key, drv.keep(drv.call(key)))]
        return drv.judge(kept), drv, key, kept[0][1]
    finally:
        drv.release()


@pytest.mark.parametrize("name", sorted(CELL))
def test_filters_judged_within_rounding(name):
    rd, _, _, rec = _filter_call(name, 2048)
    assert rec.broken is None and rec.events
    assert rd["log_z_gap"] < 1e-3
    assert rd["weight_gap"] < 1e-4 and rd["state_gap"] < 1e-3
    assert rd["counts_gap"] <= 2


@pytest.mark.parametrize("name", sorted(CELL))
def test_bfloat16_reference_is_judged_wrong(name):
    _, drv, key, _ = _filter_call(name, 2048)
    rec = drv.control(key, torch.bfloat16)
    rd = drv.judge([(key, rec)])
    assert rd["log_z_gap"] > 1e-2 or rd["state_gap"] > 1e-2


@pytest.mark.parametrize("name", sorted(CELL))
def test_the_float64_reference_in_the_programs_place_is_exact(name):
    _, drv, key, _ = _filter_call(name, 1024)
    rd = drv.judge([(key, drv.control(key, torch.float64))])
    assert rd == {"log_z_gap": 0.0, "weight_gap": 0.0, "state_gap": 0.0,
                  "counts_gap": 0.0}


def test_programs_bfloat16_state_is_judged_wrong():
    rd, *_ = _filter_call("fused_pf", 2048, "bfloat16")
    assert rd["state_gap"] > 1e-3


def test_a_record_of_no_filter_call_fails():
    _, drv, key, rec = _filter_call("fused_pf", 512)
    rec.broken = "planted"
    assert all(v == math.inf for v in drv.judge([(key, rec)]).values())
    rec.broken, rec.log_zs = None, rec.log_zs[:-1]
    assert all(v == math.inf for v in drv.judge([(key, rec)]).values())


def test_drivers_release_the_port():
    import importlib

    pf = importlib.import_module("genjax_torch.inference.pf")
    before = pf.fused_step
    drv = _driver("fused_pf", 256)
    assert pf.fused_step is not before
    drv.release()
    assert pf.fused_step is before


def test_offspring_gap():
    xs = torch.tensor([0.5, -1.0, 2.0, 3.0])
    cc = torch.tensor([2, 2, 3, 4])
    post = filters.expand(xs, cc)
    assert filters.offspring_gap(xs, post, cc) == 0.0
    # One offspring moved to a neighbour: 1 on each.
    moved = torch.tensor([0.5, 0.5, 2.0, 2.0])
    assert filters.offspring_gap(xs, moved, cc) == 1.0
    # A value that no particle held, or another size: inf.
    assert filters.offspring_gap(xs, post + 1e-3, cc) == math.inf
    assert filters.offspring_gap(xs, post[:3], cc) == math.inf
    # A discrete state counts by its value.
    zs = torch.tensor([3, 1, 3, 1])
    assert filters.offspring_gap(zs, torch.tensor([3, 3, 1, 1]),
                                 torch.tensor([1, 2, 3, 4])) == 0.0


def test_resampling_keys_name_their_step():
    key = threefry.seed_key(77)
    _, k_res, _ = filters.filter_keys(key, 8)
    assert [filters.step_of_key(k_res[t], k_res) for t in range(8)] == \
        list(range(8))
    assert filters.step_of_key(key, k_res) is None


def test_observations_are_the_entry_points():
    from genjax_torch.entry import tracking_observations

    cfg = plugins.data("configs", "tracking-1d")
    obs = plugins.module("configs", "tracking-1d").inputs(
        cfg, {}, "cpu")["observations"]
    assert obs.dtype == torch.float32
    torch.testing.assert_close(obs, tracking_observations(cfg["steps"],
                                                          "cpu"),
                               rtol=1e-6, atol=1e-6)
