"""The work counts and the metric readers, against hand counts at small
shapes, on synthetic profiles (no device needed)."""

from types import SimpleNamespace

import pytest

from portbench.lib import peaks, plugins
from portbench.lib.profile import (DeviceProfile, busy_ns, idle_gaps,
                                   kernel_base)

TRACK = plugins.module("work", "tracking-1d")
HMM = plugins.module("work", "hmm-circulant-64")


def test_least_time_is_the_largest_bound():
    assert peaks.least_s(bytes_=3.35e12) == pytest.approx(1.0)
    assert peaks.least_s(product_flop=495e12) == pytest.approx(1.0)
    assert peaks.least_s(other_flop=67e12) == pytest.approx(1.0)
    assert peaks.least_s(bytes_=3.35e12, product_flop=2 * 495e12) == \
        pytest.approx(2.0)


def test_filter_counts_by_hand():
    # 2^20 particles: a step 16 bytes each, 16.8 MB.
    assert TRACK.fused_step_least_s(2**20) == pytest.approx(
        16 * 2**20 / 3.35e12)
    assert TRACK.cdf_counts_least_s(10) == pytest.approx(80 / 3.35e12)
    # 10 particles, 3 steps, 2 resamplings: 480 + 320 bytes.
    assert TRACK.call_least_s(10, 3, 2) == pytest.approx(800 / 3.35e12)
    assert HMM.call_least_s(10, 3, 2) == TRACK.call_least_s(10, 3, 2)
    assert HMM.cdf_counts_least_s(10) == TRACK.cdf_counts_least_s(10)


def test_kernel_names():
    assert kernel_base("void (anonymous namespace)::step<float>(long "
                       "const*, float const*)") == "step"
    assert kernel_base("(anonymous namespace)::emit(float const*)") == "emit"
    assert kernel_base("void at::native::vectorized_elementwise_kernel<2, "
                       "at::native::F<long> >(int)") == \
        "vectorized_elementwise_kernel"


def test_busy_union_and_gaps():
    ev = [("a", 0, 10), ("b", 5, 10), ("c", 30, 5)]
    assert busy_ns(ev) == 20
    gaps = idle_gaps(ev, 0, 40)
    assert gaps[0] == (15, 15, "c") and gaps[1] == (35, 5, "(end of window)")


def _ctx(events, **kw):
    prof = DeviceProfile(events=events, host=[("aten::x", 0, 100)],
                         wall_s=100e-9)
    ctx = SimpleNamespace(profile=prof, work=kw.pop("work", TRACK),
                          driver=SimpleNamespace(n=2**20), ops=None,
                          steps=32)
    for k, v in kw.items():
        setattr(ctx, k, v)
    return ctx


def test_roofline_readers():
    least = TRACK.fused_step_least_s(2**20)
    ns = int(round(least * 2e9))              # each launch at half its bound
    ctx = _ctx([("void (anonymous namespace)::step<float>(x)", 0, ns),
                ("void (anonymous namespace)::step<float>(x)", ns, ns),
                ("other", 2 * ns, 5)])
    read = plugins.module("metrics", "fused_step_roofline").read
    assert read(ctx) == pytest.approx(50.0, rel=1e-3)
    # The CDF kernel: two functions a launch; a lost event reads nothing.
    cdf = plugins.module("metrics", "cdf_counts_roofline").read
    ev = [("(anonymous namespace)::tile_partials(x)", 0, 1000),
          ("(anonymous namespace)::emit(x)", 1000, 1000)]
    ctx = _ctx(ev)
    assert cdf(ctx) == pytest.approx(
        100 * TRACK.cdf_counts_least_s(2**20) / 2e-6)
    assert cdf(_ctx(ev[:1])) is None
    assert cdf(_ctx([])) is None


def test_window_readers():
    w = SimpleNamespace(walls=[0.1] * 19 + [0.3], calls=20, span_s=2.2,
                        work=2.2e9, resamples=4.5)
    ctx = _ctx([], window=w, setup_s=3.0)
    assert plugins.module("metrics", "particle_steps_per_s").read(ctx) == \
        pytest.approx(1e9)
    assert plugins.module("metrics", "call_ms_p95").read(ctx) == \
        pytest.approx(110.0)
    mfu = plugins.module("metrics", "mfu.particle").read(ctx)
    assert mfu == pytest.approx(
        100 * 20 * TRACK.call_least_s(2**20, 32, 4.5) / 2.2)
    ctx.ops = {"core/random.py": 30, "inference/pf.py": 34}
    assert plugins.module("metrics", "dispatched_ops_per_step").read(ctx) \
        == pytest.approx(2.0)
    assert plugins.module("metrics", "random_ops_share").read(ctx) == \
        pytest.approx(100 * 30 / 64)
