"""chip_smoke.py's measuring helpers, on the CPU.

A profile on the card now and then holds no device event at all;
``profiled`` then takes it again and, if no try saw the device, falls
back to the calls' CUDA-event time with the device ops NaN, which the
JSON record prints as ``null``. Here no try can see a device, so the
fallback path runs, with ``cuda_ms`` and the synchronisation stubbed.

Phase 28's CPU-side helpers: the rank slices of its local-layout check
(``layout_slices``, ``layout_mismatches``, which must catch a rank-local
part whose bits depend on the slice), and the float64 offspring counts
with their tie count against f32 counts. Phase 30a's float64
forward-backward oracle against enumeration.

Phase 31 rehearsed whole on the CPU at small sizes
(``sharded_samplers_phase``): a gloo world of one in place of NCCL, the
card's memory and device-time readings stubbed, CDF "launches" counted at
the resampling call the kernel serves, and phases 21, 23 and 27's
unsharded runs as its references."""

import functools
import json
import math
import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))
import chip_smoke  # noqa: E402


@pytest.fixture
def one_thread():
    """One intra-op thread for a rehearsal of 2^12-element filters: the
    suite's workers share the host's cores, and such ops slow down
    tenfold when each worker takes them all."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_profiled_falls_back_to_cuda_events(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    monkeypatch.setattr(chip_smoke, "cuda_ms", lambda fn, reps: 1.25)
    calls = []
    wall, busy, per_kernel, ops, launch_ms = chip_smoke.profiled(
        lambda: calls.append(torch.ones(4).sum()), 2, tries=2)
    # One warm-up call, then two tries of two calls each.
    assert len(calls) == 5
    assert busy == 1.25 and per_kernel == {} and math.isnan(ops)
    assert wall >= 0.0 and launch_ms == 0.0
    out = capsys.readouterr().out
    assert "profile 1 of 2 saw no device time" in out
    assert "profile 2 of 2 saw no device time" in out


def test_finite_or_none_prints_null():
    record = {"a": math.nan, "b": [1.5, math.inf, (2, -math.inf)],
              "c": {"d": 3, "e": "x", "f": None}}
    assert json.loads(json.dumps(chip_smoke.finite_or_none(record))) == {
        "a": None, "b": [1.5, None, [2, None]],
        "c": {"d": 3, "e": "x", "f": None}}


def test_device_busy_falls_back_to_cuda_events(monkeypatch, capsys):
    """The light profile of the ~10^6-op runs (phase 22): no warm-up
    call, one call a try, the same fallback as ``profiled``."""
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    monkeypatch.setattr(chip_smoke, "cuda_ms", lambda fn, reps: 2.5)
    calls = []
    wall, busy, ops = chip_smoke.device_busy(
        lambda: calls.append(torch.ones(4).sum()), tries=2)
    assert len(calls) == 2
    assert busy == 2.5 and math.isnan(ops) and wall >= 0.0
    out = capsys.readouterr().out
    assert "profile 2 of 2 saw no device time" in out


def test_profiled_ops_retakes_a_profile_that_lost_events(monkeypatch):
    """A profile short of the expected device ops is taken again; the try
    with the most ops is returned when none reads the expected count, with
    every try's ops beside it."""
    seen = iter([1.9, 2.0])
    monkeypatch.setattr(chip_smoke, "profiled",
                        lambda fn, reps: (1.0, 0.5, {}, next(seen), 0.0))
    res, tries = chip_smoke.profiled_ops(lambda: None, 10, 2)
    assert res[3] == 2.0 and tries == [1.9, 2.0]
    seen = iter([1.9, math.nan, 1.8])
    res, tries = chip_smoke.profiled_ops(lambda: None, 10, 2)
    assert res[3] == 1.9 and tries[0] == 1.9 and tries[2] == 1.8
    assert len(tries) == 3 and math.isnan(tries[1])
    seen = iter([3.0, 3.0, 3.0])
    res, tries = chip_smoke.profiled_ops(lambda: None, 10, 2)
    assert res[3] == 3.0 and tries == [3.0, 3.0, 3.0]


def test_config5_closed_form_trajectory():
    """Phase 24's reference: every ELBO gradient of config 5 is 4 v, so
    the fit after n steps is v0 (1 − 4 lr)^n."""
    import numpy as np

    from genjax_torch import entry as E

    v0 = np.linspace(0.2, 0.8, 7)
    v = v0.copy()
    for _ in range(100):
        v = v - 1e-3 * 4.0 * v
    np.testing.assert_allclose(E.adev_vi_exact(v0, 100), v, rtol=1e-12)


def test_blr_exact_posterior_and_evidence():
    """Phases 26-27's reference: the conjugate posterior and evidence of
    config 10's regression, against the joint Gaussian of (w, y)."""
    import numpy as np
    from scipy import stats

    from genjax_torch import entry as E

    x, y = E.blr_data(48, 5, "cpu")
    got = E.blr_exact(x, y)
    xd, yd = x.double().numpy(), y.double().numpy()
    sxy = xd                                    # cov(y, w) = X
    syy = 0.0625 * np.eye(48) + xd @ xd.T
    mean = sxy.T @ np.linalg.solve(syy, yd)
    cov = np.eye(5) - sxy.T @ np.linalg.solve(syy, sxy)
    np.testing.assert_allclose(got["mean"], mean, rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(got["cov"], cov, rtol=1e-9, atol=1e-12)
    want = stats.multivariate_normal(np.zeros(48), syy).logpdf(yd)
    assert abs(got["log_z"] - want) < 1e-8


def test_tempered_exact_posterior_against_a_grid():
    """Phase 27's PT reference: config 6's conjugate posterior of mu,
    against a float64 grid of the prior times the likelihood."""
    import numpy as np

    from genjax_torch import entry as E

    ys = E.tempered_observations(64, "cpu").double().numpy()
    grid = np.linspace(0.5, 2.5, 200001)
    logp = (-0.5 * grid ** 2 / 9.0
            - 0.5 * ((ys[None, :] - grid[:, None]) ** 2).sum(1) / 0.64)
    w = np.exp(logp - logp.max())
    w /= w.sum()
    mean = (w * grid).sum()
    sd = np.sqrt((w * (grid - mean) ** 2).sum())
    got = E.tempered_exact_posterior(ys)
    assert abs(got["mean"] - mean) < 1e-8 and abs(got["sd"] - sd) < 1e-8


def test_phi_oracle_matches_the_port():
    """Phase 26's float64 pairwise oracle of SVGD's direction agrees with
    the port's Gram-form ``_rbf_phi`` on the CPU."""
    from genjax_torch.core import random
    from genjax_torch.inference.svgd import _rbf_phi

    xs = random.normal(random.key(40), (64, 6))
    gr = random.normal(random.key(41), (64, 6))
    oracle = chip_smoke._phi_oracle(xs, gr)
    rel = float((_rbf_phi(xs, gr).double() - oracle).abs().max()
                / oracle.abs().max())
    assert rel <= chip_smoke.C10_PHI_REL_BOUND


def test_layout_slices_cover_the_axis_in_rank_order():
    for d in (1, 2, 4, 8):
        sl = chip_smoke.layout_slices(64, d)
        assert len(sl) == d
        assert [i for s in sl for i in range(64)[s]] == list(range(64))


def test_layout_mismatches_pass_a_rowwise_part_and_catch_a_global_one():
    x = torch.randn(64, 3)
    rowwise = chip_smoke.layout_mismatches(lambda v: (v * 2.0, v.sum(1)), x)
    assert rowwise == {2: 0, 4: 0, 8: 0}
    # A part that reads its whole slice (here: its sum) is not its rows
    # of the one-rank result on any rank.
    whole = chip_smoke.layout_mismatches(
        lambda v: (v - v.sum(0, keepdim=True),), x)
    assert whole == {2: 2, 4: 4, 8: 8}


def test_layout_mismatches_of_the_block_partials():
    from genjax_torch.parallel import collectives as PC

    lw = 3.0 * torch.randn(1 << 12)
    m = lw.max()
    bad = chip_smoke.layout_mismatches(
        lambda v: (lambda w, s: (w, s.T))(*PC.block_partials(v, m, 64)), lw)
    assert bad == {2: 0, 4: 0, 8: 0}


def test_float64_counts_and_their_ties():
    from genjax_torch.core import random
    from genjax_torch.inference.smc import systematic_offspring_cumulative

    n = 1 << 14
    lw = 2.0 * random.normal(random.key(3), (n,))
    key = random.key(4)
    cc64 = chip_smoke.float64_counts(key, lw, n)
    assert int(cc64[-1]) == n and bool((torch.diff(cc64) >= 0).all())
    # The same draw in f32 (the plain CDF pipeline) lands on the float64
    # counts but at grid points between the two sums, each one off.
    cc = systematic_offspring_cumulative(key, lw, n)
    ties, largest = chip_smoke.count_ties(cc, cc64)
    assert ties <= n // 100 and largest <= 1
    assert chip_smoke.count_ties(cc64, cc64) == (0, 0)
    shifted = cc64.clone()
    shifted[5] += 2
    assert chip_smoke.count_ties(shifted, cc64) == (1, 2)


def test_smoothing_oracle_matches_enumeration():
    """Phase 30a's float64 forward-backward against the smoothing
    marginals by enumerating every path of a small HMM (1e-12)."""
    import itertools

    from genjax_torch.lang.distributions import DiscreteHMMConfiguration

    torch.manual_seed(0)
    s, t_len, p = 3, 4, 2
    cfg = DiscreteHMMConfiguration(
        torch.log_softmax(torch.randn(p, s), -1),
        torch.log_softmax(torch.randn(p, s, s), -1),
        torch.log_softmax(torch.randn(p, s, 2), -1))
    obs = torch.randint(0, 2, (p, t_len))
    got = chip_smoke._smoothing64(cfg, obs)
    for b in range(p):
        want = torch.zeros(t_len, s, dtype=torch.float64)
        for z in itertools.product(range(s), repeat=t_len):
            lp = (cfg.prior_logits[b, z[0]].double()
                  + sum(cfg.transition_logits[b, z[i], z[i + 1]].double()
                        for i in range(t_len - 1))
                  + sum(cfg.observation_logits[b, z[i], obs[b, i]].double()
                        for i in range(t_len)))
            for i in range(t_len):
                want[i, z[i]] += torch.exp(lp)
        want /= want.sum(-1, keepdim=True)
        assert torch.allclose(got[b], want, rtol=0, atol=1e-12)


def test_binomial_two_sided_tail_against_scipy():
    """Phase 30a's exact tail of the rare cells' summed counts against
    scipy's binomial cdf and survival function (1e-9 relative), down to
    tails far below 1e-16 and at probabilities 0 and 1."""
    from scipy import stats

    n = 200
    k = torch.tensor([0.0, 1.0, 3.0, 40.0, 100.0, 199.0, 200.0, 0.0, 200.0])
    p = torch.tensor([1e-3, 1e-20, 0.02, 0.2, 0.5, 0.999, 0.999, 0.0, 1.0])
    got = chip_smoke.binomial_two_sided_p(k, n, p)
    for ki, pi, gi in zip(k.tolist(), p.tolist(), got.tolist()):
        lower = stats.binom.cdf(ki, n, pi)
        upper = stats.binom.sf(ki - 1, n, pi)
        want = min(1.0, 2.0 * min(lower, upper))
        assert math.isclose(gi, want, rel_tol=1e-9, abs_tol=1e-300), (ki, pi)
    # A draw where the summed probability is 1e-20: far past 5 se.
    assert got[1] < chip_smoke.FIVE_SE_P < 1e-6


def test_log_matmul_bound_takes_the_split_tf32_rate():
    """The log-space product's bound is the larger of its bytes and its
    three TF32 products; the f32 FFMA time rides beside it."""
    b_ms, by, f32_ms = chip_smoke.lm_bound(63488, 128)
    assert by == "bytes" and math.isclose(
        b_ms, 12.0 * 63488 * 128 ** 2 / 3.35e12 * 1e3, rel_tol=1e-12)
    assert math.isclose(f32_ms, 2.0 * 63488 * 128 ** 3 / 67e12 * 1e3,
                        rel_tol=1e-12)
    b_ms, by, _ = chip_smoke.lm_bound(511, 1024)
    assert by == "operations" and math.isclose(
        b_ms, 3 * 2.0 * 511 * 1024 ** 3 / 495e12 * 1e3, rel_tol=1e-12)


def test_phase_31_rehearsal(monkeypatch, capsys):
    import genjax_torch.inference.smc as smc_mod
    from genjax_torch import entry as E
    from genjax_torch.core import random
    from genjax_torch.inference import particle_gibbs

    for name in ("synchronize", "reset_peak_memory_stats"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: None)
    for name in ("memory_allocated", "max_memory_allocated"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: 0)
    monkeypatch.setattr(chip_smoke, "device_busy",
                        lambda fn, tries=3: (fn(), (2.0, 1.0, 10.0))[1])
    monkeypatch.setattr(chip_smoke, "SHARDED_DEVICE", "cpu")
    monkeypatch.setattr(chip_smoke, "TRACE_KERNEL_CAT", "cpu_op")
    monkeypatch.setattr(chip_smoke, "SHARDED_SIZE", {
        "smc2": (32, 32, 12), "pt_timed": 3, "pt_profiled": 2,
        "elastic": (2048, 16, 4, 2, 13), "trace_pf": (1024, 4)})
    monkeypatch.setattr(chip_smoke, "PT_SIZE", (16, 4, 20, 10))
    monkeypatch.setattr(chip_smoke, "PGAS_SHARDED_SIZE", (4, 16, 8))
    # On the CPU no wrapper counts its launches: count the calls the CDF
    # kernel serves on the card.
    launches = {"cdf_counts": 0}
    plain = smc_mod.systematic_cumulative

    def counted(*args, **kwargs):
        launches["cdf_counts"] += 1
        return plain(*args, **kwargs)

    monkeypatch.setattr(smc_mod, "systematic_cumulative", counted)

    def counts():
        return {"cdf_counts": launches["cdf_counts"], "fused_step": 0,
                "log_matmul": 0, "expand_adaptive": 0}

    def zero_counts():
        launches["cdf_counts"] = 0

    dev = torch.device("cpu")
    n_theta, n_x, steps = chip_smoke.SHARDED_SIZE["smc2"]
    ladders, rungs, keep, burn = chip_smoke.PT_SIZE
    n_chains, n_part, sweeps = chip_smoke.PGAS_SHARDED_SIZE
    pgas = particle_gibbs(*E.pgas_model()[:3], n_part, sweeps,
                          trans_logpdf=E.pgas_model()[3])
    refs = {"smc2": E.build_smc2(n_theta, n_x, steps, device=dev)[0](
                random.key(1)),
            "pt": E.build_pt(ladders, rungs, keep, burn, device=dev)[0](
                random.key(1)),
            "pgas_paths": pgas(random.split(random.key(3), n_chains),
                               E.lgssm_observations(50, "cpu")).paths}
    # The rehearsal runs the phase's control flow at a tenth of a percent
    # of its size; the accuracy bounds hold at full size on the card.
    monkeypatch.setattr(chip_smoke, "SMC2_LOGZ_BOUND", math.inf)
    monkeypatch.setattr(chip_smoke, "SMC2_MOMENT_BOUND", math.inf)
    monkeypatch.setattr(chip_smoke, "ELASTIC_LOGZ_BOUND", math.inf)
    monkeypatch.setattr(chip_smoke, "SHARDED_MCSE_BOUND", math.inf)
    out = chip_smoke.sharded_samplers_phase(dev, "cpu", zero_counts, counts,
                                            refs)
    text = capsys.readouterr().out
    for part in ("31a", "31b", "31c", "31d", "31e"):
        assert f"[{part} " in text
    assert out["smc2"]["bitwise"] and out["pt"]["bitwise"]
    assert out["pgas"]["bitwise"]
    el = out["elastic"]
    assert [e["kind"] for e in el["events"]] == ["nonfinite"]
    assert el["events"][0]["resumed_from"] == 8
    assert el["clean_launches"]["cdf_counts"] >= 1
    assert out["trace"]["kernel_events"] >= 1
    assert not torch.distributed.is_initialized()
    json.dumps(chip_smoke.finite_or_none(out))


def test_phase_32_rehearsal(capsys):
    """Phase 32's pool and checks on the CPU with three programs (one at
    its REHEARSAL sizes): each held to its CPU reference, the closed
    form of ex01, the CDF kernel's calls counted (on the CPU no wrapper
    counts, so none is required), and the pool stopped."""
    names = ["ex01_beta_bernoulli_sir", "cb04_speed_gains",
             "ex12_particle_gibbs"]
    started = chip_smoke.start_examples(names, device="cpu")
    try:
        out = chip_smoke.examples_phase("cpu", started)
    finally:
        chip_smoke.stop_examples(started)
    text = capsys.readouterr().out
    assert set(out["programs"]) == set(names)
    for n in names:
        assert f"[32 {n}]" in text
    assert out["programs"]["ex12_particle_gibbs"]["sizes"] != "documented"
    assert out["programs"]["ex01_beta_bernoulli_sir"]["sizes"] \
        == "documented"
    json.dumps(chip_smoke.finite_or_none(out))


def test_phase_33_rehearsal(monkeypatch, capsys, tmp_path, one_thread):
    """Phase 33 on the CPU at 4096 particles x 32 steps: the fused filter
    on each generated model with its launches counted at the step the
    kernel serves (by the name of the CUDA form it would launch), CDF
    "launches" at the resampling call, the library check against a
    stand-in file, the timing stubbed. The accuracy bounds hold at 2^20
    on the card, not at 4096."""
    import genjax_torch.inference.smc as smc_mod
    from genjax_torch.inference import pf as pf_mod
    from genjax_torch.ops import _build, fused_model
    from genjax_torch.ops import fused_step as fs

    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(chip_smoke, "cuda_ms",
                        lambda fn, reps: (fn(), 1.0)[1])
    monkeypatch.setattr(chip_smoke, "profiled",
                        lambda fn, reps: (fn(), (2.0, 1.0, {}, 1.0, 0.1))[1])
    monkeypatch.setattr(chip_smoke, "GEN_SIZE", (4096, 32))
    monkeypatch.setattr(chip_smoke, "GEN_LINEAR_BOUND", math.inf)
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(fused_model, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(fs, "build", lambda name: None)
    launches = {"cdf_counts": 0, "fused_step": 0}
    by_model = {}
    cdf, step = smc_mod.systematic_cumulative, pf_mod.fused_step

    def counted_cdf(*args, **kwargs):
        launches["cdf_counts"] += 1
        return cdf(*args, **kwargs)

    @functools.lru_cache
    def generated(propagate, loglik):
        return fused_model.cuda_model(propagate, loglik)

    def counted_step(seeds, xs, lw, obs, propagate, loglik, *,
                     cuda_model=None, state_dtype=torch.float32):
        model = cuda_model or generated(propagate, loglik)
        launches["fused_step"] += 1
        by_model[model.name] = by_model.get(model.name, 0) + 1
        return step(seeds, xs, lw, obs, propagate, loglik,
                    cuda_model=cuda_model, state_dtype=state_dtype)

    monkeypatch.setattr(smc_mod, "systematic_cumulative", counted_cdf)
    monkeypatch.setattr(pf_mod, "fused_step", counted_step)
    monkeypatch.setattr(fs.fused_step, "launches_by_model", by_model)

    def counts():
        return {**launches, "log_matmul": 0, "expand_adaptive": 0}

    def zero_counts():
        launches.update(cdf_counts=0, fused_step=0)
        by_model.clear()

    gen = {k: fused_model.cuda_model(*fns)
           for k, fns in chip_smoke.generated_models("cpu").items()}
    for k in ("linear", "live"):
        (tmp_path / f"libfused_step_{gen[k].name}.so").write_bytes(b"")
    from genjax_torch.core import random

    dev = torch.device("cpu")
    inputs = (random.key_data(random.key(3)), random.normal(
        random.key(1), (4096,)), 0.3 * random.normal(random.key(2), (4096,)),
        torch.tensor(2.5))
    out = chip_smoke.generated_phase(dev, "cpu", zero_counts, counts, gen,
                                     inputs)
    text = capsys.readouterr().out
    for part in ("a sv key 7", "a sv]", "b linear", "c tracking.cuh",
                 "c tracking generated", "d live a,q,r=(0.7",
                 "d live a,q,r=(0.6", "timing"):
        assert f"[33 {part}" in text
    assert out["sv"]["launches"]["by_model"] == {gen["sv"].name: 32}
    assert out["tracking"]["header_launches"]["by_model"] == {"tracking": 32}
    assert math.isfinite(out["linear"]["other"]["log_z"])
    assert set(out["timing"]) == {"tracking.cuh", "gen_sv", "gen_linear",
                                  "gen_tracking", "gen_live"}
    assert out["live"]["launches"]["by_model"] == {gen["live"].name: 32}
    json.dumps(chip_smoke.finite_or_none(out))


def test_log_matmul_grad_check_rehearsal(monkeypatch, capsys):
    """Phase 8's gradient check on the CPU: the card's route (the
    Function around the launch, its forward the plain version here) in
    the parallel filter, counted at the filter's product."""
    import importlib

    from genjax_torch.ops import logmatmul as lm

    dhmm = importlib.import_module(
        "genjax_torch.lang.distributions.discrete_hmm")

    def kernel_route(x, y):
        lm.log_matmul.launches += 1
        return lm._LogMatmul.apply(x, y)

    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(dhmm, "log_matmul", kernel_route)
    out = chip_smoke.log_matmul_grad_check(torch.device("cpu"), "cpu")
    assert dhmm.log_matmul is kernel_route
    assert "[8 log_matmul gradient]" in capsys.readouterr().out
    assert out["filter_grad_err"] <= 1e-4


def test_phase_34_rehearsal(monkeypatch, capsys, tmp_path, one_thread):
    """Phase 34 on the CPU at 4096 particles x 32 steps, counted as phase
    33's rehearsal counts: each of ``GEN34_MODELS`` through the fused
    filter (its launches counted at the step the kernel serves, by the
    name of the CUDA form it would launch) against the general driver
    over its keys and one fused run of each of ``GEN_LONG_LOOPS``, the
    timing stubbed; and phase 4's comparison of each new header with its plain
    version (both plain on the CPU), the quantised model's step count
    included."""
    import genjax_torch.inference.smc as smc_mod
    from genjax_torch.core import random
    from genjax_torch.inference import pf as pf_mod
    from genjax_torch.ops import _build, fused_model
    from genjax_torch.ops import fused_step as fs

    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(chip_smoke, "cuda_ms",
                        lambda fn, reps: (fn(), 1.0)[1])
    monkeypatch.setattr(chip_smoke, "profiled",
                        lambda fn, reps: (fn(), (2.0, 1.0, {}, 1.0, 0.1))[1])
    monkeypatch.setattr(chip_smoke, "GEN_SIZE", (4096, 32))
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(fused_model, "BUILD_DIR", str(tmp_path))
    launches = {"cdf_counts": 0, "fused_step": 0}
    by_model = {}
    cdf, step = smc_mod.systematic_cumulative, pf_mod.fused_step

    def counted_cdf(*args, **kwargs):
        launches["cdf_counts"] += 1
        return cdf(*args, **kwargs)

    @functools.lru_cache
    def generated(propagate, loglik):
        return fused_model.cuda_model(propagate, loglik)

    def counted_step(seeds, xs, lw, obs, propagate, loglik, *,
                     cuda_model=None, state_dtype=torch.float32):
        model = cuda_model or generated(propagate, loglik)
        launches["fused_step"] += 1
        by_model[model.name] = by_model.get(model.name, 0) + 1
        return step(seeds, xs, lw, obs, propagate, loglik,
                    cuda_model=cuda_model, state_dtype=state_dtype)

    monkeypatch.setattr(smc_mod, "systematic_cumulative", counted_cdf)
    monkeypatch.setattr(pf_mod, "fused_step", counted_step)
    monkeypatch.setattr(fs.fused_step, "launches_by_model", by_model)

    def counts():
        return {**launches, "log_matmul": 0, "expand_adaptive": 0}

    def zero_counts():
        launches.update(cdf_counts=0, fused_step=0)
        by_model.clear()

    forms = chip_smoke.generated_models("cpu")
    models = (*chip_smoke.GEN34_MODELS, *chip_smoke.GEN_LONG_LOOPS)
    gen = {k: fused_model.cuda_model(*forms[k]) for k in models}
    assert {k: len(gen[k].params) for k in chip_smoke.GEN_LONG_LOOPS} == \
        chip_smoke.GEN_LONG_LOOPS
    dev = torch.device("cpu")
    inputs = (random.key_data(random.key(3)), random.normal(
        random.key(1), (4096,)), 0.3 * random.normal(random.key(2), (4096,)),
        torch.tensor(2.5))
    errs = {k: chip_smoke.fused_vs_plain(
        f"generated {k}", *forms[k], gen[k], inputs,
        steps=chip_smoke.quantised_steps if k == "quantised" else None,
        bound=chip_smoke.GEN34_BOUND) for k in gen}
    assert errs == {k: 0.0 for k in gen}
    out = chip_smoke.generated_ops_phase(dev, "cpu", zero_counts, counts,
                                         gen, inputs)
    text = capsys.readouterr().out
    assert "weights a step apart" in text
    assert text.count("1e-05 + 1e-05 |plain| on each f32 state") == \
        3 * len(models)
    for part in ("a dynamic_logit key 7", "a dynamic_logit]",
                 "b quantised key 0", "b quantised]", "c ops key 3",
                 "c ops]", "d lambert_w key 7", "d lambert_w]",
                 "e long_loop]", "e long_loop_1100]", "timing"):
        assert f"[34 {part}" in text
    assert "[34 d lambert_w] cpu: 81 float constants" in text
    assert "1100 float constants" in text
    for k in models:
        assert out[k]["launches"]["by_model"] == {gen[k].name: 32}
        assert out[k]["launches"]["cdf_counts"] >= 1
    for k in chip_smoke.GEN34_MODELS:
        assert len(out[k]["log_z_fused"]) == (
            chip_smoke.GEN34_OPS_KEYS if k == "ops" else chip_smoke.GEN34_KEYS)
    for k in chip_smoke.GEN_LONG_LOOPS:
        assert math.isfinite(out[k]["log_z"])
    assert set(out["timing"]) == {"tracking.cuh",
                                  *(f"gen_{k}" for k in models)}
    json.dumps(chip_smoke.finite_or_none(out))
