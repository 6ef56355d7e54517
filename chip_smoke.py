"""Drive the PyTorch port's main path once on one CUDA card, check it, and
time its kernels.

    python3 chip_smoke.py

Phases (each prints one line; any failure exits non-zero):
  1. card: name and power limit from nvidia-smi;
  2. build: the four CUDA C++ kernels (CDF->counts, log-matmul,
     expand_adaptive, and the fused step once per model header: the
     hand-written tracking and linear ones, and the ten that
     genjax_torch/ops/fused_model.py generates from the torch forms of
     phase 33's four models, the ops model (every op and value type the
     generator took after them), phase 34's three and the two long loops
     (33 and 1100 float constants)), from the sources in the checkout,
     into genjax_torch/_build/: fifteen nvcc processes, all started
     together, each generated model's nvcc seconds and float constants;
  3. the CDF->counts kernel against its plain version in five weight
     regimes at n = 1, 4097, 2^19, 2^20, a ragged size and 2^24 (more
     tiles than the card holds at once), and its device ops per call;
  4. the fused-step kernel: its threefry words bit for bit against
     core.random (through the library's second entry point), then against
     its plain version at 2^20, f32 and bf16 state, and at a ragged size,
     with tracking.cuh and with each generated header, the long loops'
     1100 constants read from the device included (the quantised
     model's lw may part at its grid's steps, where a few ulps of the new
     state move the rounding: counted, each at a step, at most
     GEN_STEP_MISMATCHES);
  5. SIR through entry() at K = 64 and K = 2^16;
  6. bench config 4 (2^20 particles x 32 steps) through build_pf and
     build_pf_fused, with each run's kernel launch counts, and the
     linear-Gaussian model against its exact Kalman log Z;
  7. timings: each kernel beside its plain version at 2^20 (the fused
     step held to one device op a call), and particle-steps/s of both
     config-4 drivers, with a profiled run's device-busy time, device ops
     and host time in kernel launches;
  8. the log-matmul kernel against its plain version: B = 8 at S = 128,
     512, 1024; ragged S = 100, 200; K = 101 (unaligned rows); scale-30
     normals; B = 70000 (past the grid's z extent); unbatched; strided
     operands; the parallel filter's own first-level operands (511,
     1024, 1024); an empty batch (no launch); the -1e30 input and an all
     -inf row; and its gradient (torch.autograd and torch.func) against
     autograd of the plain version at (8, 128, 128) and through the
     parallel filter at S = 128;
  9. the expand_adaptive kernel bit for bit against its plain version
     and repeat_interleave at 2^20, 2^20 + 37 and 2^24, in the JAX test
     file's regimes;
 10. the discrete-HMM parallel path at full width (circulant(1024, 1024),
     T = 1024): build_hmm_parallel's run, with the log-matmul launches
     held to the scan's combine count, the parallel filter against the
     sequential one, and the path's score against estimate_logpdf;
 11. bench config 3 (64 states x 64 steps x 2^19 particles) through
     build_hmm_smc, against the exact log marginal;
 12. expand_adaptive through its own entry point at 2^20;
 13. timings of the slice: each new kernel beside its plain version, its
     bounds and its library call at the main path's shapes, the CDF
     kernel at 2^19 and 2^20, expand_adaptive's device time beside
     repeat_interleave's at 2^20 and 2^24, the full-width parallel
     filter's wall time
     and how it splits between the log-matmul prologue and product, the
     scan's copies and the rest, and config 3's particle-steps/s with a
     profiled run's device-busy time;
 14. edits on the card: Distribution.edit and Fn.edit (Update,
     Regenerate, StaticRequest) on a 2^19 key batch of config 6's model,
     against the same code on the CPU on the same key data; the
     Regenerate weight identity and the backward requests' round trip;
 15. bench config 6 (tempered SMC, 2^19 particles x 16 rungs x 2 MH
     moves) through build_tempered_smc: log Z against the closed form,
     the acceptance, the CDF kernel's launches, particle-rung-moves/s, a
     profiled run's device ops, busy time and idle share, and the PyTorch
     ops a run dispatches, by the port's module that issued them;
 16. hmm_model through the Scan combinator at 64 states x 64 steps x 2^19
     particles: the constrained generate's weight against the emission
     log-probabilities summed by hand, assess against the simulate score,
     and an IndexRequest(t, Regenerate(z)) against the Regenerate
     identity;
 17. bench config 2 (NUTS on the conjugate regression, 2048 chains x 128
     points, max_depth 6) through build_nuts_regression, its draws cut
     to 200 warmup + 200 samples (of 1600): split R-hat, the posterior
     mean within 4 Monte Carlo standard errors of the closed form and
     its sd within 10 %; eff-samples/s, chain-leapfrogs/s, ms and host
     syncs a transition, a profiled short run's device-busy time, idle
     share and device ops, the ops dispatched by module, peak memory;
     and one transition on the card and on the CPU from the same keys;
 18. bench config 8 (NUTS on logistic regression, 1024 chains, N = 8192,
     D = 512, max_depth 5, 100 + 100) through build_nuts_logreg: split
     R-hat over the 512 coefficients, the sign-pattern separation, the
     distance to a float64 Newton MAP; chain-leapfrogs/s, the likelihood
     product's kernels and their time a leapfrog (two f32 GEMMs, TF32
     off), idle share and peak memory;
 19. SLDS-RBPF at 2^19 particles through build_slds_rbpf: at one regime
     (64 steps) against the float64 Kalman evidence; at two regimes and
     16 steps against slds_exact_log_marginal over its 65 536 paths (in
     float64); at two regimes and 64 steps (the path) against the same
     filter on the CPU from the same key, with the CDF kernel's launches
     held to the resamples its ESS history shows; particle-steps/s (the
     median of 3 runs), host syncs, a profiled run's device ops, busy
     time and idle share, peak memory;
 20. the Switch mixture through build_switch_mixture: ImportanceK SIR at
     2^20 particles and its systematic resample (the CDF kernel), and MH
     by Regenerate of the mixture over 2^19 chains x 64 steps, each
     against the closed-form posterior (component frequencies and the
     mean of m within 4 standard errors); an index-change Update with a
     full constraint on 2^16 executions on the card and on the CPU from
     the same key data; particles/s, chain-steps/s, idle share, device
     ops, peak memory;
 21. bench config 7 (SMC², 1024 x 1024 x 50, uncut) through build_smc2:
     log Z against the grid's log evidence, the posterior mean and sd of
     the coefficient within 0.06 of the grid's, card vs CPU on one key
     at 64 x 64 x 50 (and its first two steps row by row); inner
     particle-steps/s (median of 3 runs), rejuvenations and PMMH
     acceptance, host syncs, a profiled run's idle share and device ops,
     the ops dispatched by module;
 22. the trace-level particle filter (build_trace_pf, 2^18 x 50, futures
     refreshed) against the Kalman log-likelihood, and data-annealed SMC
     on the coins (build_data_smc, 2^19 x 32 flips, one Regenerate MH
     move of p a step) against the closed form: the CDF kernel's launches
     held to the resamples in each ESS history; particle-steps/s, a
     profiled run's idle share and device ops (summed from the raw
     device events: a run dispatches ~10^6 ops), peak memory;
 23. a Marginal's density by ImportanceK(2^16) behind ChangeTarget over
     64 keys against the exact 0.5; ChangeTarget from the prior to the
     observed target against the posterior mean 0.6; particle Gibbs with
     ancestor sampling (256 chains x 128 particles x 50 steps x 50
     sweeps) on config 7's data against the RTS smoother (4 MCSE);
 24. bench config 5 (ADEV VI, 65536 fits x 50 steps x 8 ELBO samples,
     cut from 100 steps) through build_adev_vi: every fit's first
     gradient against 4 v0, the final v against v0 (1 - 4e-3)^50, card
     vs CPU at 64 x 10;
 25. bench config 9 (ADEV VI of a 512 -> 1024 -> 1 tanh network on 8192
     points, 200 Adam steps (cut from 500), f32 with TF32 off) through
     build_bnn_vi: the first ADEV gradient against the hand-written
     reparameterized one, the two sites' noise uncorrelated, the -ELBO's
     fall over the fit;
 26. bench config 10 (SVGD, 4096 particles x 600 steps, 1024 x 64
     regression) through build_svgd against the exact posterior mean,
     and _rbf_phi at N = 512 against float64 pairs;
 27. parallel tempering (build_pt: config 6's model, 4096 ladders x 16
     rungs, 100 + 100 steps, cut from 200 + 200) within 4 MCSE of the
     closed form, and MAP with the Laplace approximation
     (build_map_laplace) on config 10's regression against its exact
     mean, covariance and evidence.
 28. the distributed layer (genjax_torch.parallel) over NCCL in a world of
     one, started by init_distributed through a file:// store and
     destroyed at the end: config 4 sharded at 2^20 x 32 (collectives on,
     against build_pf, the linear model against Kalman, zero ring trips,
     no collective of n elements; the gathered baseline with one CDF
     launch a resample); the rank-local parts at D = 2, 4, 8 shapes
     bitwise the one-rank rows (blocked CDF stats and offspring
     intervals at 2^20, the chain-group partials of 2048 chains, the HMM
     block summaries at S = 64, SVGD direction rows); ring_resample_step
     at 2^20 against the CDF kernel and float64 counts; sharded SIR at
     2^20 against ImportanceK; the time-sharded HMM at 64 x 16384 against
     forward_filter (and bitwise it at T = 1024, block = T); NUTS with
     mesh= bitwise mesh=None at 2048 chains; sharded SVGD at config 10.
     Each part prints its wall (median of 3), rate, collectives a step
     with their bytes, host syncs, device-busy time, idle share, device
     ops and peak memory.
 29. the distribution library: (a) each of the 48 distributions draws
     2^20 values from a key batch, held to its law (the empirical CDF at
     the JAX tests' values within 5 binomial standard errors of float64
     scipy, or the mean vector within 5 se of its closed form) and its
     declared support, its log-density on the card to the CPU port's
     (1e-5 relative, 1e-4 through a special function or a series), and
     poisson / binomial / multinomial integers to the CPU port's on
     2^16 keys, with draws/s of sample and logpdf and the rejection
     loops' trips and host syncs; (b) the gamma-Poisson SIR at 2^20
     (build_gamma_poisson_sir) within 0.01 of the posterior mean 3.5 and
     0.006 of log(6/128), its one resample one CDF launch; (c) NUTS on
     config 2's regression with sigma ~ half_normal(1) (build_scale_nuts,
     2048 chains, 200 + 100, transforms="auto"): split R-hat <= 1.01 and
     each mean within 4 MCSE of scale_nuts_exact.
 30. the per-execution slice: (a) 2048 exact-HMM problems (S = 128,
     T = 64, config 3's circulant structure) from sample_problem on a
     key batch, each with its own observations, then each with its own
     transition variance, through build_hmm_batch (DiscreteHMM's
     parallel filter and sampler): simulate and assess each launch the
     log-matmul kernel count_combines(63) times over every problem's
     pairs; log marginals within 1e-5 relative and live alphas within
     2e-5 of float64 sequential filtering; FFBS on 8 problems x 2^14
     draws within 5 se of float64 forward-backward; the kernel at the
     path's first-level shape (B x 31, 128, 128) beside its plain
     version, torch.bmm and its bounds; wall (median of 3), device-busy
     time, idle share and peak memory; (b) per-execution edits of
     hmm_model at phase 16's width (an IndexRequest with t drawn per
     execution, Update and Regenerate, and a Vmap Update at lanes named
     by an index array) against the CPU port on 2^10 executions from the
     same key data, and the backward request's round trip; (c) a
     single-site MH sweep over a 32-site normal chain at 2^19 chains on
     the fine and the coarse @gen edit paths (bitwise equal; sites
     re-scored a move; wall and dispatched ops a sweep), and the 2-site
     chain at 2^19 x 200 sweeps within 4 se of 2/3; (d) config 6's wall
     with the GFI argument checks on and under no_validation().
 31. the sharded samplers in an NCCL world of one: config 7 and PT bit
     for bit phases 21 and 27, PGAS at 256 x 128 x 50 x 20 sweeps bit for
     bit the unsharded sampler, config 4 under run_elastic, a trace.
 32. the 29 documented programs (genjax_torch/examples), started in a
     pool of worker processes before phase 14 and collected after phase
     31: each at its documented size (ex03, ex10, ex11, ex12, ex13, ex15
     at their REHEARSAL sizes), its results against the CPU's under the
     CPU tests' tolerances, ex01's and ex05's closed forms within 5 of
     their Monte Carlo sd, each resampling program's CDF launches > 0,
     and each program's wall. The pool's workers share the card and the
     host with phases 14-31, whose times are so contended (the record's
     "contended").
 33. the fused filter with no hand-written header (cuda_model=None: the
     CUDA form generated from the torch form) at config 4's width, 2^20 x
     32: the stochastic-volatility model over 8 keys against the general
     driver on the same model (4 se); the JAX test's linear-Gaussian
     lambdas with a, q, r = 0.7, 0.5, 0.4 against Kalman (0.1), and with
     other constants through the same library, unbuilt; the tracking
     model's torch form against tracking.cuh on one key (phase 6's
     0.25); the linear lambdas reading a from a 0-d tensor on the card
     and the rest from a list, changed between two runs of one filter,
     each run against its own Kalman (0.1) with one library. Each run:
     32 fused launches from the generated library, one CDF launch a
     resample, log Z, particle-steps/s; the trace a run costs. Then each
     generated kernel's time a call at 2^20 beside tracking.cuh's, in
     turns.
 34. generated models that need bool and int32 values, rounding and
     logaddexp, at config 4's width, 2^20 x 32, each over 8 keys against
     the general driver on the same model (4 se): (a) a dynamic logit
     model (AR(1) logits, binary observations, bernoulli.logpdf(y > 0.5,
     x)), (b) a quantised sensor (logistic.logpdf(y, 0.5 round(x / 0.5),
     0.3)), (c) the ops model (4 keys), (d) a heavy-tailed sensor
     (lambert_w_normal.logpdf(y, x, 0.5, 0.2): Halley's iterations
     unrolled, 81 float constants); (e) the long loops with 33 and 1100
     float constants, one fused run each. Each run: 32 fused launches
     from the generated library, one CDF launch a resample, log Z,
     particle-steps/s; then each new kernel's time a call at 2^20 beside
     tracking.cuh's, in turns.
Phases 24-27 each print the wall of a run (the median of 3), its rate,
a profiled short run's device-busy time, idle share and device ops a
step, and the peak device memory; none launches one of the four kernels,
as none reaches a Pallas kernel in the JAX package.
Each path's kernel launches are counted from 0 just before it runs. The
last three lines are the card's line, the kernels' JSON record and the
result line.
There is no CPU path: without a CUDA card the script fails.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


#: (phase, seconds since the script started) at each phase's start.
CLOCK: list = []
T_START = time.perf_counter()


def clock(phase: str) -> None:
    """Mark ``phase``'s start on the script's clock (the record's
    "clock_s"), so that each phase's share of the limit is on record."""
    at = time.perf_counter() - T_START
    CLOCK.append((phase, at))
    print(f"[clock] phase {phase} starts at {at:.1f} s", flush=True)


def fail(msg: str):
    raise SystemExit(f"chip_smoke: FAIL: {msg}")


def check(cond: bool, msg: str):
    if not cond:
        fail(msg)


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn()`` over ``reps`` calls, by CUDA events,
    after a warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def host_ms(fn, reps: int) -> float:
    """Host time of one call of ``fn`` (Python and launch, no sync), over
    ``reps`` calls after a warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    dt = (time.perf_counter() - t0) / reps * 1e3
    torch.cuda.synchronize()
    return dt


def _event_totals(prof) -> tuple:
    """What ``prof.key_averages()`` gives :func:`profiled`, summed straight
    from the raw events (``key_averages`` first parses every host and
    device event into a tree: tens of seconds for a run of 10^4-10^5
    ops): ``({device op name: (ns, count)}, host ns in kernel-launch
    calls)``. As there, an event the profiler marks hidden is left out,
    and an async one (ending on another thread) adds no time but
    counts."""
    from torch.autograd import DeviceType

    by, launch_ns = {}, 0
    for evt in prof.profiler.kineto_results.events():
        if getattr(evt, "is_hidden_event", lambda: False)():
            continue
        ns = 0 if (evt.is_async() or evt.start_thread_id()
                   != evt.end_thread_id()) else evt.duration_ns()
        if evt.device_type() == DeviceType.CUDA:
            t, n = by.get(evt.name(), (0, 0))
            by[evt.name()] = (t + ns, n + 1)
        elif "LaunchKernel" in evt.name():
            launch_ns += ns
    return by, launch_ns


def profiled(fn, reps: int, tries: int = 3):
    """Per call of ``fn`` under torch.profiler: ``(wall ms, device-busy
    ms, {kernel: ms}, device ops, host ms in kernel-launch calls)``.
    Device-busy is the summed time of the device ops the calls ran. Now
    and then a profile holds no device event at all (its device
    collection stopped early), so it is taken again, up to ``tries``
    times. If none saw the device, the device time is the calls' span
    by CUDA events instead, with no split by kernel and the device ops
    NaN (not measured). A profile that lost some device events is not
    told apart here (:func:`profiled_ops` is, where the ops a call are
    known)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for attempt in range(1, tries + 1):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3 / reps
        by, launch_ns = _event_totals(prof)
        per_kernel = {k: ns / 1e6 / reps for k, (ns, _) in by.items() if ns}
        ops = sum(n for ns, n in by.values() if ns)
        launch_ms = launch_ns / 1e6
        if per_kernel:
            return wall, sum(per_kernel.values()), per_kernel, ops / reps, \
                launch_ms / reps
        print(f"[profiler] profile {attempt} of {tries} saw no device time",
              flush=True)
    return wall, cuda_ms(fn, reps), {}, math.nan, launch_ms / reps


def profiled_ops(fn, reps: int, expected: int, tries: int = 3):
    """:func:`profiled`, retaken until its device ops a call read
    ``expected``: ``(profiled's result, every try's ops a call)``. The
    card's profiler now and then drops a few device events from a profile
    (once 19 of a two-launch kernel's 20) and never adds one, so the try
    with the most ops is returned; a check on it still fails for a design
    with more or fewer ops than ``expected``, and the tries' ops, printed
    in the phase line, tell a dropped event from a change of design."""
    best, seen = None, []
    for _ in range(tries):
        res = profiled(fn, reps)
        seen.append(res[3])
        if res[3] == expected:
            return res, seen
        if best is None or (res[3] == res[3] and not res[3] <= best[3]):
            best = res
    return best, seen


def device_busy(fn, tries: int = 3):
    """One call of ``fn`` under torch.profiler's device activity: ``(wall
    ms, device-busy ms, device ops)``, summed straight from the raw
    device events. For runs of about 10^6 ops, where building
    ``key_averages`` takes tens of minutes. No warm-up call: the caller
    has run ``fn`` before. An empty profile is retaken and, after
    ``tries``, the device time is the call's span by CUDA events, the
    ops NaN, as in :func:`profiled`."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    # Device activity only: the host's op events would double what the
    # profiler hands back (the CPU activity stands in where no card is).
    acts = ([ProfilerActivity.CUDA] if torch.cuda.is_available()
            else [ProfilerActivity.CPU])
    for attempt in range(1, tries + 1):
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        busy_ns, ops = 0, 0
        for evt in prof.profiler.kineto_results.events():
            if evt.device_type() == DeviceType.CUDA:
                busy_ns += evt.duration_ns()
                ops += 1
        if ops:
            return wall, busy_ns / 1e6, ops
        print(f"[profiler] profile {attempt} of {tries} saw no device time",
              flush=True)
    return wall, cuda_ms(fn, 1), math.nan


def finite_or_none(x):
    """``x`` with every float that is not finite replaced by None, so that
    a value not measured prints as JSON ``null``."""
    if isinstance(x, float):
        return x if math.isfinite(x) else None
    if isinstance(x, dict):
        return {k: finite_or_none(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [finite_or_none(v) for v in x]
    return x


def ops_by_module(fn) -> dict:
    """The PyTorch ops that one call of ``fn()`` dispatches, by the
    innermost ``genjax_torch`` module on the Python stack of each (the
    layer that issued it): ``{module: count}``, most first."""
    import collections

    from torch.utils._python_dispatch import TorchDispatchMode

    by = collections.Counter()

    class Count(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            f = sys._getframe(1)
            while f is not None and "genjax_torch" not in f.f_code.co_filename:
                f = f.f_back
            by["(outside)" if f is None else
               f.f_code.co_filename.split("genjax_torch" + os.sep)[-1]] += 1
            return func(*args, **(kwargs or {}))

    with Count():
        fn()
    return dict(by.most_common())


def matrix_products(fn) -> dict:
    """The matrix-product ops (``mm``, ``bmm``, ``matmul``, ...) that one
    call of ``fn()`` dispatches, backward included: ``{op: count}``."""
    import collections

    from torch.utils._python_dispatch import TorchDispatchMode

    by = collections.Counter()

    class Count(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            name = str(func.overloadpacket)
            if name.endswith(("mm", "matmul", "bmm", "addmv", "mv", "dot")):
                by[name] += 1
            return func(*args, **(kwargs or {}))

    with Count():
        fn()
    return dict(by)


def threefry_bits(lib, seeds, n: int):
    """The two threefry2x32 words the fused-step kernel draws for
    counters ``0..n-1`` (its own ``threefry2x32``, through the library's
    ``fused_step_threefry_bits``), as int64 ``(n, 2)``, so that they can
    be held bit for bit against ``core.random``."""
    import torch

    out = torch.empty((n, 2), dtype=torch.int32, device=seeds.device)
    err = lib.fused_step_threefry_bits(
        seeds.data_ptr(), out.data_ptr(), n,
        torch.cuda.current_stream(seeds.device).cuda_stream)
    check(err == 0, f"threefry probe launch failed: CUDA error {err}")
    return out.to(torch.int64) & 0xFFFFFFFF


#: Integer opcodes of the SASS (the ALU and integer multiply-add pipes).
INT_OPCODES = {"IADD3", "IADD", "IMAD", "LOP3", "LOP", "SHF", "SHL", "SHR",
               "LEA", "ISETP", "IMNMX", "SEL", "PRMT", "VIADD", "IABS",
               "POPC", "FLO"}


def sass_int_ops(library: str, kernel: str) -> int:
    """Integer instructions of the first kernel whose name holds
    ``kernel`` in ``library``'s SASS (cuobjdump beside nvcc)."""
    import os
    import re

    from genjax_torch.ops._build import _nvcc

    cuobjdump = os.path.join(os.path.dirname(_nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", library], capture_output=True,
                          text=True, check=True, timeout=120).stdout
    count, inside = 0, False
    for line in sass.splitlines():
        if "Function :" in line:
            if inside:
                break
            inside = kernel in line
            continue
        m = re.search(r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z0-9]+)",
                      line)
        if inside and m and m.group(1) in INT_OPCODES:
            count += 1
    check(count > 0, f"no integer instructions found for {kernel}")
    return count


#: The card's peaks that bound a kernel (NVIDIA H100 SXM data sheet, at
#: its 700 W limit): HBM3 bytes/s, and f32 operations/s outside the
#: tensor cores, against which every operation is counted; TF32
#: operations/s on the tensor cores (dense), the rate of log_matmul's
#: split-TF32 route. The integer pipe (64 lanes a clock an SM, half the
#: f32 rate) is read from the card itself in main().
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
TF32_OPS_PER_S = 495e12


def header_f32_ops(model: str) -> int:
    """f32 operations an element of a generated header's ``propagate`` and
    ``loglik`` takes at least: its lines that compute a float (one
    operation or more each; a fused ``a * b + c`` counts two, as the f32
    peak does)."""
    import re

    from genjax_torch.ops.fused_model import header_path

    with open(header_path(model)) as f:
        return sum(bool(re.match(r"\s*const float v\d+ = .*[-+*/(]", line))
                   for line in f)


def bound(n_bytes: float, n_ops: float):
    """The least time (ms) the card could take for work that must move
    ``n_bytes`` and do ``n_ops``, and which of the two bounds it."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def lm_bound(batch: int, s: int) -> tuple:
    """The least time (ms) of a (batch, s, s) log-space product, and what
    bounds it: each operand read and the result written once (12 bytes an
    entry), against the product as the kernel runs it, three TF32
    tensor-core products (split TF32). Also the f32 FFMA time of the
    product, for comparison."""
    flop = 2.0 * batch * s ** 3
    t_bytes = 12.0 * batch * s ** 2 / HBM_BYTES_PER_S * 1e3
    t_tc = 3.0 * flop / TF32_OPS_PER_S * 1e3
    by = "bytes" if t_bytes >= t_tc else "operations"
    return max(t_bytes, t_tc), by, flop / F32_OPS_PER_S * 1e3


#: The two-sided normal tail beyond 5 standard errors: the level at which
#: an exact count test stands beside the 5-se checks.
FIVE_SE_P = math.erfc(5.0 / math.sqrt(2.0))


def binomial_two_sided_p(k, n: int, p):
    """Exact two-sided binomial tails ``2 min(P(K <= k), P(K >= k))``,
    capped at 1, of counts ``k`` out of ``n`` draws at probabilities
    ``p`` (tensors of one shape), in float64 from the whole pmf, so that a
    tail of 1e-30 is not lost to a difference from 1."""
    import torch

    shape = k.shape
    k = k.double().reshape(-1, 1)
    p = p.double().reshape(-1, 1)
    j = torch.arange(n + 1, dtype=torch.float64, device=k.device)[None]
    log_pmf = (math.lgamma(n + 1.0) - torch.lgamma(j + 1.0)
               - torch.lgamma(n - j + 1.0)
               + torch.where(j == 0, 0.0, j * torch.log(p))
               + torch.where(j == n, 0.0, (n - j) * torch.log1p(-p)))
    pmf = log_pmf.exp()
    lower = (pmf * (j <= k)).sum(-1)
    upper = (pmf * (j >= k)).sum(-1)
    return torch.clamp(2.0 * torch.minimum(lower, upper), max=1.0).reshape(
        shape)


def scan_products(n: int) -> int:
    """Matrix products (batch entries, summed over its combines) that
    ``associative_scan`` makes for ``n`` elements."""
    if n < 2:
        return 0
    half = n // 2
    return half + scan_products(half) + (half - 1 if n % 2 == 0 else half)


def top(per_kernel: dict, k: int = 4) -> str:
    items = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:k]
    return "; ".join(f"{name[:48]} {ms:.4f} ms" for name, ms in items)


def lw_regime(regime: str, n: int, dev):
    import torch

    from genjax_torch.core import random

    k = random.key(5, device=dev)
    idx = torch.arange(n, device=dev)
    if regime == "uniform":
        return torch.zeros(n, device=dev)
    if regime == "mild":
        return random.normal(k, (n,))
    if regime == "skewed":
        return 4.0 * random.normal(k, (n,))
    if regime == "one_hot":
        return torch.where(idx == min(12345, n // 3), 0.0, -1e9)
    return torch.where(idx < 9, 8.0, -2.0)          # head_tail


def _close(a, b, scale=None):
    """``|a - b| <= 1e-5 (1 + |b|)``, plus ``1e-6 scale``: a weight that
    is the difference of two f32 sums of magnitude ``scale`` carries
    their rounding, which the two devices do in their own orders. Returns
    the worst ratio of the difference to the bound."""
    import torch

    a, b = a.double().cpu(), b.double().cpu()
    tol = 1e-5 * (1 + b.abs())
    if scale is not None:
        tol = tol + 1e-6 * scale.double().cpu()
    return float(((a - b).abs() / tol).max())


def float64_counts(key, lw, n: int):
    """The cumulative systematic offspring counts from a float64 prefix
    sum, unrounded to f32: ``ceil(n·F_i − u0)`` clipped to [0, n], the last
    entry ``n``."""
    import torch

    from genjax_torch.core import random

    cum = torch.cumsum(torch.exp(lw.double() - lw.double().max()), 0)
    u0 = random.uniform(key.to(lw.device), ()).double()
    out = torch.clamp(torch.ceil(cum * (n / cum[-1]) - u0), 0, n).long()
    out[-1] = n
    return out


def count_ties(cc, cc64) -> tuple:
    """``(ties, largest)``: the particles whose f32 cumulative count
    differs from the float64 one (a grid point between the two sums), and
    the largest difference in destinations."""
    diff = (cc.long() - cc64.long()).abs()
    return int((diff > 0).sum()), int(diff.max())


def layout_slices(n: int, d: int) -> list:
    """Rank ``r``'s slice ``[r·n/D, (r+1)·n/D)`` of an axis of ``n``, for
    every rank of a world of ``d``."""
    per = n // d
    return [slice(r * per, (r + 1) * per) for r in range(d)]


def layout_mismatches(fn, x, worlds=(2, 4, 8)) -> dict:
    """For each world size D: the ranks whose ``fn`` on their slice of
    ``x``'s leading axis is not, bit for bit, their rows of ``fn(x)``
    (each output's leading axis split D ways like the input's).
    ``{D: ranks that differ}``; all 0 is layout independence."""
    import torch

    whole = fn(x)
    out = {}
    for d in worlds:
        bad = 0
        for r, sl in enumerate(layout_slices(x.shape[0], d)):
            part = fn(x[sl])
            for w, p in zip(whole, part):
                rows = w.shape[0] // d
                if not torch.equal(w[r * rows:(r + 1) * rows], p):
                    bad += 1
                    break
        out[d] = bad
    return out


def edits_phase(dev, card: str, n: int = 1 << 19) -> dict:
    """Phase 14: config 6's model on a key batch of ``n``, edited on the
    card and on the CPU from the same key data."""
    import torch

    import genjax_torch as g
    from genjax_torch import entry as E
    from genjax_torch.core import random
    from genjax_torch.inference import Target, batched_importance

    def run(device):
        ys = E.tempered_observations(64, device=device)
        target = Target(E.tempered_model(64), (E.TEMPERED_SIGMA,),
                        g.C["ys"].set(ys))
        keys = random.fold_in(random.key(21, device=device),
                              torch.arange(n, device=device))
        ekeys = random.fold_in(random.key(22, device=device),
                               torch.arange(n, device=device))
        tr, w0 = batched_importance(target, keys, g.ChoiceMap.empty())
        mu = tr.get_choices()["mu"]
        new_mu = 0.5 * mu + 0.75
        out = {"w_generate": w0, "mu": mu}
        dist = tr.get_subtrace("mu")
        d_args = g.Diff.no_change(dist.get_args())
        d_new = g.Diff.unknown_change((0.5, 2.0))
        for name, (req, args) in {
            "dist_update": (g.Update(g.ChoiceMap.choice(new_mu)), d_args),
            "dist_update_new_args": (g.Update(g.ChoiceMap.empty()), d_new),
            "dist_regenerate": (g.Regenerate(g.Selection.all()), d_args),
            "dist_regenerate_new_args": (g.Regenerate(g.Selection.all()),
                                         d_new),
        }.items():
            new, w, _, _ = dist.get_gen_fn().edit(ekeys, dist, req, args)
            out[name] = (w, new.get_retval())
        for name, req in {
            "update": g.Update(g.C["mu"].set(new_mu)),
            "regenerate": g.Regenerate(g.Selection.at["mu"]),
            "static": g.StaticRequest({"mu": g.Regenerate(g.Selection.all()),
                                       "ys": g.Update(g.ChoiceMap.empty())}),
        }.items():
            new, w, _, bwd = tr.edit(ekeys, req)
            sites = [(new.get_subtrace(a).get_score(),
                      tr.get_subtrace(a).get_score()) for a in ("mu", "ys")]
            out[name] = (w, new.get_choices()["mu"])
            out[name + "_scale"] = sum(s.abs() + o.abs() for s, o in sites)
            if name == "regenerate":
                # w = Δscore - Δ(log-density of the regenerated site), in
                # float64 from the sites' scores.
                d_score = sum(s.double() - o.double() for s, o in sites)
                d_site = sites[0][0].double() - sites[0][1].double()
                out["identity"] = (w, d_score - d_site)
                # The reverse move lands on the old value: the Update that
                # puts it back weighs -Δscore, and less its site's density
                # change that is -w.
                back, wb, _, _ = new.edit(ekeys, g.Update(g.C["mu"].set(mu)))
                out["regen_back"] = (
                    wb.double() + d_site,  # = -(w) when restored
                    -w.double())
                out["regen_back_mu"] = back.get_choices()["mu"]
            if name == "update":
                back, wb, _, _ = new.edit(ekeys, bwd)
                out["update_back"] = (wb, -w)
                out["update_back_mu"] = back.get_choices()["mu"]
        return out

    t0 = time.perf_counter()
    on_card = run(dev)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    on_cpu = run(torch.device("cpu"))
    cpu_s = time.perf_counter() - t0
    worst = {}
    for name in ("w_generate", "mu"):
        worst[name] = _close(on_card[name], on_cpu[name])
    for name in ("dist_update", "dist_update_new_args", "dist_regenerate",
                 "dist_regenerate_new_args", "update", "regenerate",
                 "static"):
        (w_g, v_g), (w_c, v_c) = on_card[name], on_cpu[name]
        worst[name + " w"] = _close(w_g, w_c, on_cpu.get(name + "_scale"))
        worst[name + " value"] = _close(v_g, v_c)
        worst[name + " w plain"] = _close(w_g, w_c)
    for side in (on_card, on_cpu):
        w, want = side["identity"]
        worst["identity"] = max(worst.get("identity", 0.0),
                                _close(w, want, side["regenerate_scale"]))
        wb, want = side["regen_back"]
        worst["regenerate back"] = max(worst.get("regenerate back", 0.0),
                                       _close(wb, want,
                                              side["regenerate_scale"]))
        wb, want = side["update_back"]
        worst["update back"] = max(worst.get("update back", 0.0),
                                   _close(wb, want, side["update_scale"]))
        check(bool(torch.equal(side["update_back_mu"], side["mu"]))
              and bool(torch.equal(side["regen_back_mu"], side["mu"])),
              "edits: a backward request did not restore the old choices")
    bad = {k: v for k, v in worst.items() if v > 1.0 and "plain" not in k}
    check(not bad, f"edits: card vs CPU beyond the bound: {bad}")
    print(f"[14 edits] {card}: config 6's model at {n} particles on the card "
          f"({card_s:.2f} s) and the CPU ({cpu_s:.2f} s), same key data: "
          f"worst |card - cpu| / bound by check "
          f"{({k: round(v, 4) for k, v in worst.items()})} (bound 1e-5 "
          f"(1 + |w|), plus 1e-6 of the edited sites' score magnitudes "
          f"for a weight; 'plain' rows show the first term alone, not "
          f"held); Regenerate identity and both backward round trips hold",
          flush=True)
    return {k: v for k, v in worst.items()}


def hmm_phase(dev, card: str, n: int = 1 << 19, n_states: int = 64,
              n_steps: int = 64) -> None:
    """Phase 16: hmm_model through Scan at 64 x 64 x 2^19."""
    import torch

    import genjax_torch as g
    from genjax_torch import entry as E
    from genjax_torch.core import random

    generate, model, _, problem = E.build_hmm_model(n_states, n_steps, n,
                                                    device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    tr, w = generate(random.key(31, device=dev))
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    ch = tr.get_choices()
    z = torch.cat([ch["z0"][:, None], ch["chain", :, "z"]], 1)
    obs = problem.observations
    emit = torch.log_softmax(problem.config.observation_logits.double(), -1)
    hand = emit[z, obs[None, :]].sum(-1)
    gen_err = float(((w.double() - hand).abs() / (1 + hand.abs())).max())
    check(gen_err <= 1e-4, f"hmm generate: weight vs hand sum, rel {gen_err}")
    # IndexRequest(t, Regenerate(z)) inside the chain.
    t = n_steps // 2 - 1
    keys = random.split(random.key(32, device=dev), n)
    t0 = time.perf_counter()
    new, wr, _, _ = tr.edit(keys, g.StaticRequest(
        {"chain": g.IndexRequest(t, g.Regenerate(g.Selection.at["z"]))}))
    torch.cuda.synchronize()
    edit_s = time.perf_counter() - t0
    old_c, new_c = tr.get_subtrace("chain"), new.get_subtrace("chain")
    d_score = sum(
        (new_c.inner.get_subtrace(a).get_score().double()
         - old_c.inner.get_subtrace(a).get_score().double()).sum(-1)
        for a in ("z", "x"))
    d_site = (new_c.inner.get_subtrace("z").get_score()[:, t].double()
              - old_c.inner.get_subtrace("z").get_score()[:, t].double())
    id_err = _close(wr, d_score - d_site)
    check(id_err <= 1.0, f"hmm IndexRequest: Regenerate identity {id_err}")
    check(bool(torch.equal(new.get_choices()["chain", :, "x"],
                           ch["chain", :, "x"])),
          "hmm IndexRequest: the observations moved")
    moved = float((new.get_choices()["chain", :, "z"][:, t]
                   != ch["chain", :, "z"][:, t]).double().mean())
    peak_gen = torch.cuda.max_memory_allocated() / 1e9
    del tr, new, old_c, new_c, ch
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sim = model.simulate(random.split(random.key(33, device=dev), n), ())
    torch.cuda.synchronize()
    sim_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    score, _ = model.assess(sim.get_choices(), (), batch=(n,))
    torch.cuda.synchronize()
    assess_s = time.perf_counter() - t0
    as_err = _close(score, sim.get_score())
    check(as_err <= 1.0, f"hmm assess vs simulate score: {as_err}")
    peak_sim = torch.cuda.max_memory_allocated() / 1e9
    del sim, score
    print(f"[16 hmm_model] {card}: {n_states} states x {n_steps} steps x "
          f"{n} particles through Scan: "
          f"generate {gen_s:.2f} s (weight vs the hand sum of log-softmaxed "
          f"emissions, max rel {gen_err:.3g}, bound 1e-4); "
          f"IndexRequest({t}, Regenerate(z)) {edit_s:.2f} s (identity "
          f"{id_err:.3g} of its bound, z moved in {moved:.3f} of the "
          f"particles); simulate {sim_s:.2f} s, assess {assess_s:.2f} s "
          f"(vs the simulate score {as_err:.3g} of its bound); peak device "
          f"memory {peak_gen:.1f} GB (generate + edit), {peak_sim:.1f} GB "
          f"(simulate + assess)", flush=True)


def _regression_logdensity(device, n: int):
    """Config 2's log-density of ``(slope, icept)`` positions ``(n, 2)`` on
    ``device``, through ``assess`` of its model with lifted data."""
    import genjax_torch as g
    from genjax_torch import entry as E

    xs, ys = E.regression_data(device)
    model = E.regression_model()
    args = (xs.expand(n, -1),)
    obs = g.C["ys"].set(ys.expand(n, -1))

    def logdensity(z):
        chm = obs | g.C["slope"].set(z[..., 0]) | g.C["icept"].set(z[..., 1])
        return model.assess(chm, args, batch=(n,))[0]

    return logdensity


def nuts_regression_phase(dev, card: str, zero_counts, counts) -> dict:
    """Phase 17: bench config 2 at 2048 chains x 128 points, its samples
    cut from 1600 to 200."""
    import torch

    from genjax_torch import entry as E
    from genjax_torch.core import random
    from genjax_torch.inference import ess_autocorr, split_rhat
    from genjax_torch.inference.requests import nuts as N

    n_chains, depth, num_warmup, num_samples = 2048, 6, 200, 200
    run, target = E.build_nuts_regression(n_chains, num_warmup, num_samples,
                                          depth)
    check(target.args[0].is_cuda, "config 2: its data is not on the card")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    N.nuts_kernel.host_syncs = 0
    t0 = time.perf_counter()
    chms, infos = run(random.key(0, device=dev))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    syncs, launches = N.nuts_kernel.host_syncs, counts()
    peak = torch.cuda.max_memory_allocated() / 1e9
    check(not any(launches.values()),
          f"config 2 launched a kernel of another path: {launches}")
    mean, cov = E.regression_exact_posterior()
    sites = {}
    for i, addr in enumerate(("slope", "icept")):
        draws = chms[addr]
        check(tuple(draws.shape) == (n_chains, num_samples)
              and bool(torch.isfinite(draws).all()),
              f"config 2: {addr} draws of shape {tuple(draws.shape)}")
        rhat = float(split_rhat(draws))
        ess = float(ess_autocorr(draws))
        m, sd = float(draws.double().mean()), float(draws.double().std())
        mcse = sd / math.sqrt(ess)
        exact_sd = math.sqrt(cov[i, i])
        sites[addr] = {"mean": m, "exact_mean": float(mean[i]), "sd": sd,
                       "exact_sd": exact_sd, "rhat": rhat, "ess": ess,
                       "mcse": mcse}
        check(rhat <= 1.01, f"config 2: {addr} split R-hat {rhat}")
        check(abs(m - mean[i]) <= 4 * mcse,
              f"config 2: {addr} mean {m} vs closed form {mean[i]} "
              f"(4 MCSE = {4 * mcse})")
        check(abs(sd / exact_sd - 1) <= 0.10,
              f"config 2: {addr} sd {sd} vs closed form {exact_sd}")
    transitions = num_warmup + num_samples
    leapfrogs = float(infos.num_steps.double().sum())
    rate = {"eff_samples_per_s": sites["slope"]["ess"] / wall,
            "chain_leapfrogs_per_s": leapfrogs / wall,
            "ms_per_transition": wall / transitions * 1e3,
            "syncs_per_transition": syncs / transitions,
            "mean_tree_leapfrogs": leapfrogs / (n_chains * num_samples)}
    # A short run at full width under the profiler: device-busy time,
    # idle share and device ops a transition; the ops it dispatches by
    # the port's module that issued them.
    short, _ = E.build_nuts_regression(n_chains, 5, 5, depth)
    p_wall, busy, per_kernel, ops, _ = profiled(
        lambda: short(random.key(1, device=dev)), 1)
    once, _ = E.build_nuts_regression(n_chains, 1, 1, depth)
    mods = ops_by_module(lambda: once(random.key(2, device=dev)))
    # One transition on the card and on the CPU from the same key data
    # and start.
    keys = random.split(random.key(5), n_chains)
    z0 = (torch.tensor(mean, dtype=torch.float32)
          + 0.05 * random.normal(random.key(6), (n_chains, 2)))
    z_c, i_c = N.nuts_kernel(_regression_logdensity("cpu", n_chains), z0,
                             keys, 0.02, max_depth=depth)
    z_g, i_g = N.nuts_kernel(_regression_logdensity(dev, n_chains),
                             z0.to(dev), keys.to(dev), 0.02, max_depth=depth)
    same = (i_c.num_steps == i_g.num_steps.cpu()).numpy()
    z_err = float(((z_g.cpu() - z_c).abs()
                   / (1 + z_c.abs())).numpy()[same].max())
    check(same.mean() >= 0.9, f"config 2: card vs CPU num_steps agree on "
          f"{int(same.sum())} of {n_chains} chains")
    out = {"chains": n_chains, "points": 128, "max_depth": depth,
           "num_warmup": num_warmup, "num_samples": num_samples,
           "cut": f"samples {num_samples} of 1600", "wall_s": wall,
           **rate, "sites": sites, "profiled_transitions": 10,
           "profiled_wall_ms": p_wall, "device_busy_ms": busy,
           "idle_share": 1.0 - busy / p_wall,
           "device_ops_per_transition": ops / 10,
           "ops_by_module_per_transition": {k: v / 2 for k, v in
                                            mods.items()},
           "peak_gb": peak, "card_vs_cpu_num_steps_agree": int(same.sum()),
           "card_vs_cpu_z_rel_err": z_err}
    print(f"[17 config 2] {card}: NUTS {n_chains} chains x 128 points, "
          f"max_depth {depth}, {num_warmup} warmup + {num_samples} samples "
          f"(cut from 1600 samples to hold the script within its limit): wall "
          f"{wall:.2f} s, {rate['eff_samples_per_s']:.6g} eff-samples/s "
          f"(slope), {rate['chain_leapfrogs_per_s']:.6g} chain-leapfrogs/s "
          f"(sampling leapfrogs / whole wall), "
          f"{rate['ms_per_transition']:.3f} ms and "
          f"{rate['syncs_per_transition']:.2f} host syncs a transition, "
          f"{rate['mean_tree_leapfrogs']:.3f} leapfrogs a tree; "
          + "; ".join(f"{a}: mean {v['mean']:.6f} vs {v['exact_mean']:.6f} "
                      f"(4 MCSE {4 * v['mcse']:.3g}), sd {v['sd']:.5f} vs "
                      f"{v['exact_sd']:.5f}, R-hat {v['rhat']:.5f}, ESS "
                      f"{v['ess']:.6g}" for a, v in sites.items())
          + f"; profiled 5 + 5 transitions: wall {p_wall:.1f} ms, device "
          f"busy {busy:.2f} ms, idle share {out['idle_share']:.4f}, "
          f"{ops / 10:.0f} device ops a transition; {top(per_kernel, 4)}; "
          f"PyTorch ops dispatched a transition by module "
          f"{out['ops_by_module_per_transition']}; peak device memory "
          f"{peak:.2f} GB; one transition card vs CPU: num_steps agree on "
          f"{int(same.sum())} of {n_chains} chains, z max rel diff where "
          f"they agree {z_err:.3g}", flush=True)
    return out


def _newton_map(x, y, iters: int = 50):
    """The MAP of config 8's posterior in float64 numpy (Newton)."""
    import numpy as np

    beta = np.zeros(x.shape[1])
    for _ in range(iters):
        p = 1.0 / (1.0 + np.exp(-(x @ beta)))
        grad = x.T @ (y - p) - beta
        hess = x.T @ (x * (p * (1 - p))[:, None]) + np.eye(x.shape[1])
        step = np.linalg.solve(hess, grad)
        beta = beta + step
        if np.abs(step).max() < 1e-12:
            break
    return beta


def nuts_logreg_phase(dev, card: str, zero_counts, counts) -> dict:
    """Phase 18: bench config 8 at 1024 chains, N = 8192, D = 512."""
    import numpy as np
    import torch

    import genjax_torch as g
    from genjax_torch import entry as E
    from genjax_torch.core import random
    from genjax_torch.inference import split_rhat
    from genjax_torch.inference.requests import nuts as N

    n_chains, n, d, depth, warm, samp = 1024, 8192, 512, 5, 100, 100
    check(not torch.backends.cuda.matmul.allow_tf32,
          "config 8: TF32 matrix products are on")
    run, target, _ = E.build_nuts_logreg(n_chains, warm, samp, n, d, depth)
    x = target.args[0]
    check(x.is_cuda and tuple(x.shape) == (n, d),
          f"config 8: X of shape {tuple(x.shape)} on {x.device}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    N.nuts_kernel.host_syncs = 0
    t0 = time.perf_counter()
    chms, infos = run(random.key(2, device=dev))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    syncs, launches = N.nuts_kernel.host_syncs, counts()
    peak = torch.cuda.max_memory_allocated() / 1e9
    check(not any(launches.values()),
          f"config 8 launched a kernel of another path: {launches}")
    beta = chms["beta"]
    check(tuple(beta.shape) == (n_chains, samp, d)
          and bool(torch.isfinite(beta).all()),
          f"config 8: beta draws of shape {tuple(beta.shape)}")
    rhat = float(split_rhat(beta).max())
    post = beta.double().mean(dim=(0, 1)).cpu().numpy()
    sep = float(post[: d // 8].mean() - np.abs(post[d // 8:]).mean())
    y = target.constraint["y"].double().cpu().numpy()
    beta_map = _newton_map(x.double().cpu().numpy(), y)
    map_rel = float(np.linalg.norm(post - beta_map)
                    / np.linalg.norm(beta_map))
    check(rhat <= 1.05, f"config 8: max split R-hat {rhat}")
    check(sep > 0, f"config 8: posterior_sep {sep}")
    leapfrogs = float(infos.num_steps.double().sum())
    transitions = warm + samp
    # The likelihood product: one value-and-gradient (what a leapfrog
    # costs) under the profiler, its GEMMs by name.
    model = E.logreg_model(d)
    lifted = (x.expand(n_chains, -1, -1),)
    obs = g.C["y"].set(target.constraint["y"].expand(n_chains, -1))
    vg = N.value_and_grad(lambda z: model.assess(
        obs | g.C["beta"].set(z), lifted, batch=(n_chains,))[0])
    z = beta[:, -1].contiguous()
    reps = 20
    lf_wall, lf_busy, lf_kernels, _, _ = profiled(lambda: vg(z), reps)
    gemms = {k: v for k, v in lf_kernels.items() if "gemm" in k.lower()}
    gemm_ms = sum(gemms.values())
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            vg(z)
        torch.cuda.synchronize()
    # The profiler now and then misses a kernel, so the products are
    # counted where they are dispatched: one matrix product each way.
    gemm_launches = sum(e.count for e in prof.key_averages()
                        if e.device_type == DeviceType.CUDA
                        and "gemm" in e.key.lower()) / reps
    products = matrix_products(lambda: vg(z))
    check(products == {"aten.mm": 2}, f"config 8: one value and gradient "
          f"dispatched the products {products}, not one mm each way")
    # Two products of 2·N·D·chains operations each.
    gemm_bound, gemm_by = bound(4.0 * (n * d + 2 * n_chains * (n + d)),
                                2 * 2.0 * n * d * n_chains)
    short, _, _ = E.build_nuts_logreg(n_chains, 3, 3, n, d, depth)
    p_wall, busy, per_kernel, ops, _ = profiled(
        lambda: short(random.key(3, device=dev)), 1)
    out = {"chains": n_chains, "n": n, "d": d, "max_depth": depth,
           "num_warmup": warm, "num_samples": samp, "wall_s": wall,
           "chain_leapfrogs_per_s": leapfrogs / wall,
           "ms_per_transition": wall / transitions * 1e3,
           "syncs_per_transition": syncs / transitions,
           "mean_tree_leapfrogs": leapfrogs / (n_chains * samp),
           "max_rhat": rhat, "posterior_sep": sep,
           "map_rel_distance": map_rel,
           "leapfrog_value_and_grad_ms": lf_wall,
           "leapfrog_device_ms": lf_busy, "product_kernels_ms": gemms,
           "product_launches_per_leapfrog": gemm_launches,
           "products_dispatched_per_leapfrog": products,
           "product_ms_per_leapfrog": gemm_ms, "product_bound_ms": gemm_bound,
           "product_bound_by": gemm_by,
           "profiled_transitions": 6, "profiled_wall_ms": p_wall,
           "device_busy_ms": busy, "idle_share": 1.0 - busy / p_wall,
           "device_ops_per_transition": ops / 6, "peak_gb": peak}
    gemm_names = ", ".join(f"{k[:60]}: {v:.4f} ms" for k, v in gemms.items())
    print(f"[18 config 8] {card}: NUTS {n_chains} chains, X {n} x {d}, "
          f"max_depth {depth}, {warm} + {samp}: wall {wall:.2f} s, "
          f"{out['chain_leapfrogs_per_s']:.6g} chain-leapfrogs/s (sampling "
          f"leapfrogs / whole wall), {out['ms_per_transition']:.2f} ms and "
          f"{out['syncs_per_transition']:.2f} host syncs a transition, "
          f"{out['mean_tree_leapfrogs']:.3f} leapfrogs a tree; max split "
          f"R-hat {rhat:.4f} (bound 1.05), posterior_sep {sep:.4f}, "
          f"posterior mean vs float64 Newton MAP rel distance "
          f"{map_rel:.4f}; one leapfrog's value and gradient: wall "
          f"{lf_wall:.3f} ms, device {lf_busy:.4f} ms, the product's "
          f"kernels {{{gemm_names}}} ({gemm_launches} launches a call seen "
          f"by the profiler over {reps} calls; dispatched {products}) "
          f"= {gemm_ms:.4f} ms a leapfrog (bound {gemm_bound:.4f} ms by "
          f"{gemm_by}, f32 without TF32); profiled 3 + 3 transitions: wall "
          f"{p_wall:.1f} ms, device busy {busy:.2f} ms, idle share "
          f"{out['idle_share']:.4f}, {ops / 6:.0f} device ops a transition; "
          f"peak device memory {peak:.2f} GB", flush=True)
    return out


def _timed_runs(fn, n: int = 3) -> list:
    """Wall seconds of ``n`` calls, each ending in a synchronize."""
    import torch

    walls = []
    for i in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(i)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    return walls


def slds_phase(dev, card: str, zero_counts, counts) -> dict:
    """Phase 19: SLDS-RBPF at 2^19 particles: the exact checks at one
    regime and at 16 steps, then the 64-step path with its launches."""
    import torch

    from genjax_torch import entry as E
    from genjax_torch import models as M
    from genjax_torch.core import random

    n, n_steps = 1 << 19, 64
    # One regime: the filter is the Kalman filter. The SLDS observes y_0
    # against the x_0 prior; kalman_filter applies the dynamics before
    # its first observation, so y_0 is conditioned here and the rest
    # handed to it, in float64.
    run1, p1, ys1 = E.build_slds_rbpf(n, n_steps, n_regimes=1, device=dev)
    r1 = run1(random.key(1, device=dev))
    y = ys1.double().cpu()
    a, q, r = float(p1.a[0]), float(p1.q[0]), float(p1.r[0])
    s0 = p1.p0 + r
    k0 = p1.p0 / s0
    ll0 = -0.5 * (math.log(2 * math.pi * s0) + (float(y[0]) - p1.mu0) ** 2
                  / s0)
    kf, _ = M.kalman_filter(y[1:], a, q, r,
                            mu0=p1.mu0 + k0 * (float(y[0]) - p1.mu0),
                            p0=(1 - k0) * p1.p0)
    kalman = ll0 + float(kf)
    rel1 = abs(float(r1.log_z) - kalman) / abs(kalman)
    check(rel1 <= 1e-3, f"SLDS S=1: log Z {float(r1.log_z)} vs Kalman "
          f"{kalman} (rel {rel1})")
    # Two regimes, 16 steps: every one of the 2^16 regime paths.
    run16, p16, ys16 = E.build_slds_rbpf(n, 16, device=dev)
    p64 = M.SLDSParams(*(v.double() for v in p16[:5]))
    exact16 = float(M.slds_exact_log_marginal(p64, ys16))
    r16 = run16(random.key(2, device=dev))
    err16 = abs(float(r16.log_z) - exact16)
    check(err16 <= 0.02, f"SLDS T=16: log Z {float(r16.log_z)} vs exact "
          f"{exact16}")
    # The path: two regimes, 64 steps, its launches counted from 0.
    run, params, ys = E.build_slds_rbpf(n, n_steps, device=dev)
    key = random.key(3, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    zero_counts()
    M.slds_rbpf.host_syncs = 0
    res = run(key)
    torch.cuda.synchronize()
    launches, syncs = counts(), M.slds_rbpf.host_syncs
    peak = (torch.cuda.max_memory_allocated() - held) / 1e9
    logz = float(res.log_z)
    resamples = int((res.ess_history[:-1] < 0.5 * n).sum())
    check(math.isfinite(logz), "SLDS T=64: log Z not finite")
    check(resamples >= 1 and launches["cdf_counts"] == resamples,
          f"SLDS T=64: {launches['cdf_counts']} CDF launches for "
          f"{resamples} resamples in the ESS history")
    check(launches["fused_step"] == launches["log_matmul"]
          == launches["expand_adaptive"] == 0,
          f"SLDS launched another kernel: {launches}")
    check(syncs == n_steps - 1, f"SLDS: {syncs} host syncs")
    run_cpu, _, ys_cpu = E.build_slds_rbpf(n, n_steps, device="cpu")
    check(bool(torch.equal(ys_cpu, ys.cpu())), "SLDS: data differ by device")
    t0 = time.perf_counter()
    logz_cpu = float(run_cpu(key.cpu()).log_z)
    cpu_s = time.perf_counter() - t0
    check(abs(logz - logz_cpu) <= 0.05,
          f"SLDS T=64: card {logz} vs CPU {logz_cpu}")
    walls = _timed_runs(lambda i: run(random.key(10 + i, device=dev)))
    wall = sorted(walls)[1]
    rate = n * n_steps / wall
    p_wall, busy, per_kernel, ops, _ = profiled(
        lambda: run(random.key(20, device=dev)), 1)
    out = {"particles": n, "steps": n_steps, "log_z": logz,
           "log_z_cpu": logz_cpu, "cpu_s": cpu_s,
           "s1_log_z": float(r1.log_z), "s1_kalman": kalman, "s1_rel": rel1,
           "t16_log_z": float(r16.log_z), "t16_exact": exact16,
           "t16_err": err16, "resamples": resamples,
           "cdf_launches": launches["cdf_counts"], "host_syncs": syncs,
           "wall_ms": [w * 1e3 for w in walls],
           "particle_steps_per_s": rate, "profiled_wall_ms": p_wall,
           "device_busy_ms": busy, "idle_share": 1.0 - busy / p_wall,
           "device_ops": ops, "peak_gb": peak}
    print(f"[19 SLDS-RBPF] {card}: 2^19 particles; S=1 x 64 steps: log Z "
          f"{float(r1.log_z):.6f} vs float64 Kalman {kalman:.6f} (rel "
          f"{rel1:.3g}, bound 1e-3); S=2 x 16 steps: {float(r16.log_z):.6f} "
          f"vs exact {exact16:.6f} over 65536 paths (|err| {err16:.5f}, "
          f"bound 0.02); S=2 x 64 steps: card {logz:.6f} vs CPU "
          f"{logz_cpu:.6f} on the same key (|diff| {abs(logz - logz_cpu):.5f}, "
          f"bound 0.05; CPU {cpu_s:.2f} s); {resamples} resamples, "
          f"launches {launches}, {syncs} host syncs a run; wall per run "
          f"{[round(w * 1e3, 2) for w in walls]} ms (median {wall * 1e3:.2f} "
          f"ms), {rate:.6g} particle-steps/s; profiled run {p_wall:.2f} ms, "
          f"device busy {busy:.3f} ms, idle share {out['idle_share']:.4f}, "
          f"{ops:.0f} device ops; {top(per_kernel, 4)}; peak device memory "
          f"{peak:.3f} GB above what earlier phases hold", flush=True)
    return out


def _mixture_index_change(device, n: int):
    """An index-change Update with a full constraint on ``n`` executions
    of the Switch mixture: the traces of one key batch constrained to
    another's choices of ``m`` (component and branches). Returns the
    weight, the score change it should equal, and the scores' sum of
    magnitudes (the weight's f32 rounding scale)."""
    import torch

    import genjax_torch as g
    from genjax_torch import entry as E
    from genjax_torch.core import random
    from genjax_torch.inference.smc import batched_importance

    _, _, target = E.build_switch_mixture(n, n, 1, device=device)

    def keys(seed):
        return random.fold_in(random.key(seed, device=device),
                              torch.arange(n, device=device))

    tr, _ = batched_importance(target, keys(31), g.ChoiceMap.empty())
    other, _ = batched_importance(target, keys(32), g.ChoiceMap.empty())
    full = other.get_choices().filter(g.Selection.at["m"])
    new, w, _, _ = tr.edit(keys(33), g.Update(full))
    changed = (new.get_choices()["m", "mixture_component"]
               != tr.get_choices()["m", "mixture_component"])
    return (w, new.get_score() - tr.get_score(),
            new.get_score().abs() + tr.get_score().abs(), changed)


def mixture_phase(dev, card: str, zero_counts, counts) -> dict:
    """Phase 20: the Switch mixture through SIR at 2^20 and MH at 2^19
    chains, against the closed form; the index-change Update on the card
    and on the CPU."""
    import torch

    from genjax_torch import entry as E
    from genjax_torch.core import random

    n_part, n_chains, n_mh = 1 << 20, 1 << 19, 64
    from genjax_torch.ops.cdf_counts import systematic_cumulative

    sir, run_mh, _ = E.build_switch_mixture(n_part, n_chains, n_mh,
                                            device=dev)
    exact = E.switch_mixture_exact()
    probs = exact["probs"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    zero_counts()
    out_sir = sir(random.key(1, device=dev))
    torch.cuda.synchronize()
    sir_launches = counts()
    check(sir_launches["cdf_counts"] == 1,
          f"mixture SIR: {sir_launches['cdf_counts']} CDF launches for its "
          "one resample")
    # The statistics are held on exact arithmetic: the weighted estimate
    # (delta-method standard error) and the resample by float64 counts
    # on the same weights and key (the binomial error on top). The
    # kernel's counts are held to those float64 counts within 4
    # destinations, phase 3's bound: its f32 sums can hand a few
    # destinations across a tile boundary, which is visible only for a
    # component as rare as b0 (P ~ 1e-7).
    lw, k_res = out_sir["log_weights"], out_sir["resample_key"]
    comp_w = out_sir["weighted_comp"]
    cc_kernel = systematic_cumulative(k_res, lw, n_part).long()
    cum = torch.cumsum(torch.exp(lw.double() - lw.double().max()), 0)
    u0 = random.uniform(k_res, ()).double()
    cc_exact = torch.clamp(torch.ceil(cum * (n_part / cum[-1]) - u0), 0,
                           n_part).long()
    cc_exact[-1] = n_part
    cdf_dest = int((cc_kernel - cc_exact).abs().max())
    check(cdf_dest <= 4, f"mixture SIR: the CDF kernel's counts are "
          f"{cdf_dest} destinations from the float64 counts")

    def by_comp(cc):
        counts_ = torch.diff(cc, prepend=torch.zeros_like(cc[:1]))
        return [int(counts_[comp_w == b].sum()) for b in range(3)]

    n_kernel, n_exact = by_comp(cc_kernel), by_comp(cc_exact)
    w = torch.softmax(lw.double(), 0)
    freq_sir, freq_w, z_sir = [], [], []
    for b in range(3):
        got = float((out_sir["comp"] == b).double().mean())
        check(got * n_part == n_kernel[b], f"mixture SIR: the resampled "
              f"particles do not follow the kernel's counts ({b})")
        f = (comp_w == b).double()
        p_hat = float((w * f).sum())
        se_w = math.sqrt(float((w * w * (f - p_hat) ** 2).sum()))
        se = math.sqrt(se_w ** 2 + probs[b] * (1 - probs[b]) / n_part)
        check(abs(p_hat - probs[b]) <= 4 * se_w + 1e-12,
              f"mixture SIR: component {b} weighted estimate {p_hat} vs "
              f"{probs[b]} (se {se_w})")
        exact_freq = n_exact[b] / n_part
        check(abs(exact_freq - probs[b]) <= 4 * se + 1e-12,
              f"mixture SIR: component {b} resampled frequency "
              f"{exact_freq} vs {probs[b]} (se {se})")
        freq_sir.append(got)
        freq_w.append(p_hat)
        z_sir.append(float(abs(exact_freq - probs[b]) / max(se, 1e-12)))
    m_w = out_sir["weighted_m"].double()
    m_hat = float((w * m_w).sum())
    se_m = math.sqrt(float((w * w * (m_w - m_hat) ** 2).sum()))
    m_sir = float(out_sir["m"].double().mean())
    counts_exact = torch.diff(cc_exact, prepend=torch.zeros_like(cc_exact[:1]))
    m_exact_res = float((counts_exact.double() * m_w).sum()) / n_part
    check(abs(m_hat - exact["mean"]) <= 4 * se_m,
          f"mixture SIR: weighted mean of m {m_hat} vs {exact['mean']} "
          f"(se {se_m})")
    check(abs(m_exact_res - exact["mean"])
          <= 4 * math.sqrt(se_m ** 2 + exact["var"] / n_part),
          f"mixture SIR: resampled mean of m {m_exact_res} vs "
          f"{exact['mean']}")
    ess = float(1.0 / (w * w).sum())
    del out_sir
    zero_counts()
    comp, m, acc = run_mh(random.key(2, device=dev))
    torch.cuda.synchronize()
    mh_launches = counts()
    peak = (torch.cuda.max_memory_allocated() - held) / 1e9
    check(not any(mh_launches.values()),
          f"mixture MH launched a kernel: {mh_launches}")
    freq_mh, z_mh = [], []
    for b in range(3):
        se = math.sqrt(max(probs[b] * (1 - probs[b]), 1e-12) / n_chains)
        got = float((comp == b).double().mean())
        freq_mh.append(got)
        z_mh.append(float(abs(got - probs[b]) / se))
        check(abs(got - probs[b]) <= 4 * se,
              f"mixture MH: component {b} frequency {got} vs {probs[b]} "
              f"(se {se})")
    m_mh = float(m.double().mean())
    check(abs(m_mh - exact["mean"]) <= 4 * math.sqrt(exact["var"] / n_chains),
          f"mixture MH: mean of m {m_mh} vs {exact['mean']}")
    acc = float(acc)
    check(0.0 < acc < 1.0, f"mixture MH: acceptance {acc}")
    del comp, m
    # The index-change Update, card against CPU from the same key data.
    n_edit = 1 << 16
    w_g, d_g, scale_g, changed = _mixture_index_change(dev, n_edit)
    w_c, d_c, scale_c, _ = _mixture_index_change(torch.device("cpu"), n_edit)
    worst = {"card vs cpu": _close(w_g, w_c, scale_c),
             "card vs score change": _close(w_g, d_g, scale_g),
             "cpu vs score change": _close(w_c, d_c, scale_c)}
    check(all(v <= 1.0 for v in worst.values()),
          f"mixture index-change Update beyond the bound: {worst}")
    walls_sir = _timed_runs(lambda i: sir(random.key(10 + i, device=dev)))
    # One timed MH run: its median of 3 is on record (PR 7).
    walls_mh = _timed_runs(lambda i: run_mh(random.key(20 + i, device=dev)),
                           1)
    rate_sir = n_part / sorted(walls_sir)[1]
    rate_mh = n_chains * n_mh / walls_mh[0]
    sp_wall, sp_busy, sp_kernels, sp_ops, _ = profiled(
        lambda: sir(random.key(30, device=dev)), 1)
    _, short_mh, _ = E.build_switch_mixture(n_part, n_chains, 4, device=dev)
    mp_wall, mp_busy, mp_kernels, mp_ops, _ = profiled(
        lambda: short_mh(random.key(31, device=dev)), 1)
    out = {"particles": n_part, "chains": n_chains, "mh_steps": n_mh,
           "exact_probs": [float(p) for p in probs],
           "exact_mean": exact["mean"],
           "sir_freq": freq_sir, "sir_weighted_freq": freq_w,
           "sir_counts_kernel": n_kernel, "sir_counts_float64": n_exact,
           "cdf_max_dest_diff": cdf_dest, "sir_z": z_sir,
           "sir_weighted_mean_m": m_hat, "sir_mean_m": m_sir,
           "sir_ess": ess, "mh_freq": freq_mh, "mh_z": z_mh,
           "mh_mean_m": m_mh, "accept_rate": acc,
           "sir_launches": sir_launches, "mh_launches": mh_launches,
           "edit_worst": worst, "edit_index_changes": int(changed.sum()),
           "sir_wall_ms": [x * 1e3 for x in walls_sir],
           "mh_wall_ms": [x * 1e3 for x in walls_mh],
           "particles_per_s": rate_sir, "chain_steps_per_s": rate_mh,
           "sir_profiled_wall_ms": sp_wall, "sir_device_busy_ms": sp_busy,
           "sir_idle_share": 1.0 - sp_busy / sp_wall, "sir_device_ops": sp_ops,
           "mh4_profiled_wall_ms": mp_wall, "mh4_device_busy_ms": mp_busy,
           "mh_idle_share": 1.0 - mp_busy / mp_wall,
           "mh_device_ops_per_step": mp_ops / 4, "peak_gb": peak}
    print(f"[20 Switch mixture] {card}: closed form P(comp | y) "
          f"{[round(float(p), 6) for p in probs]}, E[m | y] {exact['mean']:.6f}; "
          f"SIR 2^20 (ESS {ess:.6g}): weighted frequencies "
          f"{[round(f, 6) for f in freq_w]}, resampled by float64 counts "
          f"{n_exact} ({[round(float(z), 2) for z in z_sir]} se from the closed "
          f"form), by the kernel {n_kernel} (its cumulative counts within "
          f"{cdf_dest} destinations of float64's); mean of m weighted "
          f"{m_hat:.6f}, resampled by float64 counts {m_exact_res:.6f}, by "
          f"the kernel {m_sir:.6f}; launches {sir_launches}; MH "
          f"2^19 "
          f"chains x {n_mh} steps: frequencies {[round(f, 6) for f in freq_mh]}"
          f" ({[round(float(z), 2) for z in z_mh]} se), mean of m {m_mh:.6f}, "
          f"acceptance {acc:.4f}, launches {mh_launches}; index-change "
          f"Update at 2^16 ({int(changed.sum())} executions change "
          f"component) worst |diff| / bound {worst}; SIR wall "
          f"{[round(x * 1e3, 2) for x in walls_sir]} ms, {rate_sir:.6g} "
          f"particles/s, profiled {sp_wall:.2f} ms, busy {sp_busy:.3f} ms, "
          f"idle {out['sir_idle_share']:.4f}, {sp_ops:.0f} device ops; MH "
          f"wall {[round(x * 1e3, 1) for x in walls_mh]} ms, {rate_mh:.6g} "
          f"chain-steps/s, 4 steps profiled {mp_wall:.2f} ms, busy "
          f"{mp_busy:.3f} ms, idle {out['mh_idle_share']:.4f}, "
          f"{mp_ops / 4:.0f} device ops a step; {top(mp_kernels, 3)}; peak "
          f"device memory {peak:.3f} GB above what earlier phases hold",
          flush=True)
    return out


#: Phase 21's bound on |log Z − the grid's log evidence| for config 7 at
#: 1024 × 1024 × 50. The JAX package's own spread over 8 keys on the CPU
#: (tools/jax_spread.py) is 0.381 at 64 × 64 and 0.243 at 128 × 128, so
#: about 1/sqrt(N_theta) with N_x scaled alike: 0.243 / sqrt(8) = 0.086
#: at 1024 × 1024, and 0.4 is 4.7 of that sd.
SMC2_LOGZ_BOUND = 0.4
#: Config 7's posterior moments of ``a`` against the grid's (the JAX
#: package's bound, tests/inference/test_smc2.py:61-62).
SMC2_MOMENT_BOUND = 0.06
#: Card vs CPU on one key at 64 × 64 × 50: the runs agree to rounding
#: until an f32 tie parts them, after which they are two estimates with
#: the 64 × 64 spread above (0.381 each): 1.6 is 3 sd of a difference.
SMC2_CARD_CPU_BOUND = 1.6
#: Phase 22: the trace PF's log Z at 2^18 × 50 (futures refreshed) vs the
#: Kalman log-likelihood. The JAX package's spread (tools/jax_spread.py)
#: at 2^18 over 8 keys is 0.0089; at 16384 over 40 keys it is 0.063
#: (the port's on the same keys alike), which is 0.016 at 2^18 by
#: 1/sqrt(particles): 8 keys read this heavy-tailed spread low, so the
#: bound is 0.075, 4.7 sd of the 40-key reading.
TRACE_PF_LOGZ_BOUND = 0.075
#: Data-annealed SMC on the coins (2^19 particles, 32 flips, one MH move
#: of p a step) vs the closed form. The JAX package's spread at 32 flips
#: over 8 keys (tools/jax_spread.py --flips 32 --eager) is 0.0223 at 4096
#: particles and 0.0092 at 32768, so about 0.0023 at 2^19; 0.015 is 6.5
#: sd, allowing for 8 keys reading a spread low.
DATA_SMC_LOGZ_BOUND = 0.015


def smc2_phase(dev, card: str, zero_counts, counts) -> dict:
    """Phase 21: bench config 7, SMC² at 1024 × 1024 × 50 uncut, against
    the exact grid posterior; card vs CPU on one key at 64 × 64 × 50."""
    import torch

    from genjax_torch import entry as E
    from genjax_torch.core import random
    from genjax_torch.inference.smc2 import smc2 as smc2_fn

    n_theta, n_x, n_steps = 1024, 1024, 50
    small = (64, 64, 50)
    run, oracle, _ = E.build_smc2(n_theta, n_x, n_steps, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    zero_counts()
    smc2_fn.host_syncs = 0
    t0 = time.perf_counter()
    res = run(random.key(1, device=dev))
    torch.cuda.synchronize()
    first_wall = time.perf_counter() - t0
    launches, syncs = counts(), smc2_fn.host_syncs
    peak = (torch.cuda.max_memory_allocated() - held) / 1e9
    logz = float(res.log_z)
    w = torch.softmax(res.log_weights.double(), 0)
    th = res.thetas.double()
    mean = float((w * th).sum())
    sd = math.sqrt(float((w * (th - mean) ** 2).sum()))
    acc = float(res.rejuv_accept)
    err = abs(logz - oracle["log_ev"])
    # SMC² reaches no Pallas kernel in the JAX package: its row resample
    # is plain XLA there and plain PyTorch here.
    check(not any(launches.values()), f"config 7 launched a kernel: "
          f"{launches}")
    check(math.isfinite(logz) and err <= SMC2_LOGZ_BOUND,
          f"config 7: log Z {logz} vs the grid's {oracle['log_ev']} (bound "
          f"{SMC2_LOGZ_BOUND})")
    check(abs(mean - oracle["mean"]) <= SMC2_MOMENT_BOUND
          and abs(sd - oracle["std"]) <= SMC2_MOMENT_BOUND,
          f"config 7: posterior of a {mean}, {sd} vs the grid's "
          f"{oracle['mean']}, {oracle['std']}")
    check(res.n_rejuvenations >= 1 and 0.0 < acc < 1.0,
          f"config 7: {res.n_rejuvenations} rejuvenations, acceptance {acc}")
    check(syncs == n_steps - 1, f"config 7: {syncs} host syncs")
    # Card (fused inner resample) vs CPU (sort) on one key: the whole run,
    # and its first two steps, whose rows agree to rounding.
    key = random.key(7)
    cmp = {}
    for t in (2, small[2]):
        on_card = E.build_smc2(small[0], small[1], t, device=dev)[0](
            key.to(dev))
        on_cpu = E.build_smc2(small[0], small[1], t, device="cpu")[0](key)
        cmp[t] = (on_card, on_cpu)
    card2, cpu2 = cmp[2]
    rows_off = int(((card2.log_weights.cpu() - cpu2.log_weights).abs()
                    > 1e-4 * cpu2.log_weights.abs().clamp(min=1.0)).sum())
    check(rows_off <= 1, f"config 7 T=2: {rows_off} θ-rows differ card vs "
          "CPU beyond 1e-4")
    lz_card, lz_cpu = (float(r.log_z) for r in cmp[small[2]])
    check(abs(lz_card - lz_cpu) <= SMC2_CARD_CPU_BOUND,
          f"config 7 small: card {lz_card} vs CPU {lz_cpu}")
    walls = [first_wall] + _timed_runs(
        lambda i: run(random.key(10 + i, device=dev)), 2)
    wall = sorted(walls)[1]
    rate = n_theta * n_x * n_steps / wall
    p_wall, busy, per_kernel, ops, _ = profiled(
        lambda: run(random.key(20, device=dev)), 1)
    mods = ops_by_module(lambda: run(random.key(21, device=dev)))
    out = {"n_theta": n_theta, "n_x": n_x, "steps": n_steps, "log_z": logz,
           "log_ev": oracle["log_ev"], "log_z_err": err,
           "theta_mean": mean, "theta_sd": sd, "grid_mean": oracle["mean"],
           "grid_sd": oracle["std"], "rejuvenations": res.n_rejuvenations,
           "rejuv_accept": acc, "host_syncs": syncs, "launches": launches,
           "small_card_log_z": lz_card, "small_cpu_log_z": lz_cpu,
           "t2_rows_off": rows_off, "wall_ms": [x * 1e3 for x in walls],
           "inner_particle_steps_per_s": rate, "profiled_wall_ms": p_wall,
           "device_busy_ms": busy, "idle_share": 1.0 - busy / p_wall,
           "device_ops": ops, "ops_by_module": mods, "peak_gb": peak,
           "_result": res}
    print(f"[21 config 7] {card}: SMC² {n_theta} x {n_x} x {n_steps}: log Z "
          f"{logz:.5f} vs the grid's {oracle['log_ev']:.5f} (|err| {err:.5f},"
          f" bound {SMC2_LOGZ_BOUND}); a | y: mean {mean:.5f} sd {sd:.5f} vs "
          f"{oracle['mean']:.5f} {oracle['std']:.5f} (bound 0.06); "
          f"{res.n_rejuvenations} rejuvenations, PMMH acceptance {acc:.4f}; "
          f"{syncs} host syncs a run; launches {launches}; card vs CPU on one "
          f"key at {small[0]} x {small[1]}: T=2 {rows_off} rows off, T="
          f"{small[2]} {lz_card:.5f} vs {lz_cpu:.5f} (bound "
          f"{SMC2_CARD_CPU_BOUND}); wall per run "
          f"{[round(x * 1e3, 1) for x in walls]} ms (median {wall * 1e3:.1f} "
          f"ms), {rate:.6g} inner particle-steps/s; profiled run {p_wall:.1f} "
          f"ms, device busy {busy:.3f} ms, idle share {out['idle_share']:.4f},"
          f" {ops:.0f} device ops; {top(per_kernel, 4)}; ops by module "
          f"{mods}; peak device memory {peak:.3f} GB above what earlier "
          f"phases hold", flush=True)
    return out


def trace_phase(dev, card: str, zero_counts, counts) -> dict:
    """Phase 22: the trace-level particle filter (config 7's LGSSM at
    a = 0.7 as a Scan model, futures refreshed) against the Kalman
    log-likelihood, and data-annealed SMC on the coins against the
    closed form; the CDF kernel once for each resample."""
    import torch

    from genjax_torch import entry as E
    from genjax_torch.core import random

    out = {}
    n_tpf, n_dsmc, n_flips = 1 << 18, 1 << 19, 32
    run, exact, ys = E.build_trace_pf(n_tpf, device=dev)
    n_steps = int(ys.shape[0])
    run_d, exact_d = E.build_data_smc(n_dsmc, n_flips, device=dev)
    for name, fn, n, steps, ex, bound in (
            ("trace_pf", run, n_tpf, n_steps, exact, TRACE_PF_LOGZ_BOUND),
            ("data_smc", run_d, n_dsmc, n_flips, exact_d,
             DATA_SMC_LOGZ_BOUND)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        zero_counts()
        t0 = time.perf_counter()
        res = fn(random.key(1, device=dev))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = counts()
        peak = (torch.cuda.max_memory_allocated() - held) / 1e9
        logz = float(res.log_z)
        resamples = int((res.ess_history < 0.5 * n).sum())
        check(resamples >= 1 and resamples == res.n_resamples
              and launches["cdf_counts"] == resamples,
              f"{name}: {launches['cdf_counts']} CDF launches for "
              f"{resamples} resamples in the ESS history")
        check(launches["fused_step"] == launches["log_matmul"]
              == launches["expand_adaptive"] == 0,
              f"{name} launched another kernel: {launches}")
        check(math.isfinite(logz) and abs(logz - ex) <= bound,
              f"{name}: log Z {logz} vs exact {ex} (bound {bound})")
        rate = n * steps / wall
        out[name] = {"particles": n, "steps": steps, "log_z": logz,
                     "exact_log_z": ex, "log_z_err": abs(logz - ex),
                     "resamples": resamples, "launches": launches,
                     "wall_ms": wall * 1e3,
                     "particle_steps_per_s": rate, "peak_gb": peak}
        if name == "data_smc":
            out[name]["accept_rate"] = float(res.accept_rate.mean())
        print(f"[22 {name}] {card}: {n} particles x {steps} steps: log Z "
              f"{logz:.5f} vs exact {ex:.5f} (|err| {abs(logz - ex):.5f}, "
              f"bound {bound}); {resamples} resamples, launches {launches}; "
              f"wall {wall * 1e3:.1f} ms, {rate:.6g} particle-steps/s; "
              f"peak device memory {peak:.3f} GB above what earlier phases "
              "hold", flush=True)
        del res
    # A run dispatches about 10^6 ops (the refresh's Regenerate of the
    # Scan, a 33-site body's edits). The data SMC's run is profiled from
    # the raw device events; the trace PF's profiled run (about 36 s) is
    # on record (PR 8).
    p_wall, busy, ops = device_busy(lambda: run_d(random.key(20, device=dev)))
    out["data_smc"].update({"profiled_wall_ms": p_wall,
                            "device_busy_ms": busy,
                            "idle_share": 1.0 - busy / p_wall,
                            "device_ops": ops})
    print(f"[22 data_smc profiled] {card}: profiled run {p_wall:.1f} ms, "
          f"device busy {busy:.3f} ms, idle share "
          f"{out['data_smc']['idle_share']:.4f}, {ops:.0f} device ops",
          flush=True)
    return out


#: Phase 23's PGAS (chains, particles, sweeps).
PGAS_SIZE = (256, 128, 50)
#: Phase 31c's PGAS: phase 23's chains and particles at 20 of its 100
#: sweeps, sharded and unsharded (bit for bit holds at any sweep count; the
#: smoothing means' MCSE bound holds at any count, the chains' means being
#: independent across chains).
PGAS_SHARDED_SIZE = (256, 128, 20)


def gensp_phase(dev, card: str) -> dict:
    """Phase 23: the GenSP methods and particle Gibbs on the card: a
    Marginal's density estimate with ImportanceK behind ChangeTarget,
    ChangeTarget from the prior to the posterior, and PGAS smoothing of
    config 7's data against the RTS smoother."""
    import torch

    import genjax_torch as g
    from genjax_torch import entry as E
    from genjax_torch import models as M
    from genjax_torch.core import random
    from genjax_torch.inference import (
        ChangeTarget, ImportanceK, Target, particle_gibbs)

    n_k, n_keys, n_prior = 1 << 16, 64, 1 << 20
    model = E.quickstart_model()
    # The Marginal of v (p marginalized) with ImportanceK(2^16), whose own
    # target observes v = False, so that ChangeTarget reweights each
    # particle to v = True. exp of the estimate is unbiased for P(v) = 0.5.
    alg = ImportanceK(Target(model, (2.0, 2.0), g.C["v"].set(False)),
                      k_particles=n_k)
    marg = model.marginal(selection=g.Selection.at["v"], algorithm=alg)
    t0 = time.perf_counter()
    est = marg.estimate_logpdf(random.split(random.key(1, device=dev),
                                            n_keys),
                               g.C["v"].set(True), 2.0, 2.0)
    dens = torch.exp(est.double())
    torch.cuda.synchronize()
    marg_s = time.perf_counter() - t0
    d_mean = float(dens.mean())
    d_se = float(dens.std()) / math.sqrt(n_keys)
    check(abs(d_mean - 0.5) <= 4 * d_se,
          f"Marginal: mean density {d_mean} vs 0.5 (se {d_se})")
    # ChangeTarget from the prior (nothing observed) to v = True.
    prior = Target(model, (2.0, 2.0), g.ChoiceMap.empty())
    post = Target(model, (2.0, 2.0), g.C["v"].set(True))
    col = ChangeTarget(ImportanceK(prior, k_particles=n_prior), post).run_smc(
        random.key(2, device=dev))
    w = torch.softmax(col.get_log_weights().double(), 0)
    p = col.get_particles().get_choices()["p"].double()
    p_mean = float((w * p).sum())
    p_se = math.sqrt(float((w * w * (p - p_mean) ** 2).sum()))
    check(abs(p_mean - 0.6) <= 4 * p_se,
          f"ChangeTarget: posterior mean {p_mean} vs 0.6 (se {p_se})")
    del col, w, p
    # PGAS on config 7's data at a = 0.7: chains x particles x sweeps.
    n_chains, n_part, n_sweeps = PGAS_SIZE
    ys = E.lgssm_observations(50, device=dev)
    a, q, r = E.SMC2_A, E.SMC2_Q, E.SMC2_R
    init_sampler, propagate, loglik, trans_logpdf = E.pgas_model()
    run = particle_gibbs(init_sampler, propagate, loglik, n_part, n_sweeps,
                         trans_logpdf=trans_logpdf)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = run(random.split(random.key(3, device=dev), n_chains), ys)
    torch.cuda.synchronize()
    pg_s = time.perf_counter() - t0
    burn = n_sweeps // 5
    per_chain = res.paths[:, burn:].double().mean(1).cpu()
    sm_mean = per_chain.mean(0)
    mcse = per_chain.std(0) / math.sqrt(n_chains)
    _, mus, _ = M.kalman_smoother(ys.double().cpu(), a, q, r, mu0=0.0,
                                  p0=0.0)
    z = (sm_mean - mus).abs() / mcse
    check(bool((z <= 4.0).all()), f"PGAS: smoothing means {float(z.max())} "
          "MCSE from the RTS smoother")
    steps = n_chains * n_part * int(ys.shape[0]) * n_sweeps
    out = {"marginal_keys": n_keys, "marginal_particles": n_k,
           "marginal_mean_density": d_mean, "marginal_se": d_se,
           "marginal_s": marg_s, "change_target_particles": n_prior,
           "change_target_mean": p_mean, "change_target_se": p_se,
           "pgas": {"chains": n_chains, "particles": n_part,
                    "sweeps": n_sweeps, "steps": int(ys.shape[0]),
                    "max_z": float(z.max()), "wall_s": pg_s,
                    "particle_steps_per_s": steps / pg_s}}
    print(f"[23 GenSP + particle Gibbs] {card}: Marginal(v) by ImportanceK "
          f"2^16 behind ChangeTarget, {n_keys} keys: mean exp(estimate) "
          f"{d_mean:.6f} vs 0.5 (se {d_se:.3g}, {marg_s:.2f} s); "
          f"ChangeTarget prior -> v=True at {n_prior}: mean p {p_mean:.5f} "
          f"vs 0.6 (se {p_se:.3g}); PGAS {n_chains} chains x {n_part} x 50 "
          f"steps x {n_sweeps} sweeps: smoothing means within "
          f"{float(z.max()):.2f} MCSE of the RTS smoother (bound 4), "
          f"{pg_s:.2f} s, {steps / pg_s:.6g} particle-steps/s", flush=True)
    return out



#: Phases 24-27's bounds, from the CPU readings of tools/vi_bounds.py
#: (PERF.md §2): config 5's first mean gradient against 4 v0 (the JAX
#: package reads 5.6e-7 and the port 4.8e-7 at 64 fits x 10 steps) and
#: its final v against v0 (1 − 4e-3)^100 (2.4e-7 and 2.0e-7 relative).
C5_FIRST_GRAD_BOUND = 1e-5
C5_FINAL_REL_BOUND = 1e-5
C5_CARD_CPU_BOUND = 1e-6
#: Config 9: the ADEV gradient against the hand-written reparameterized
#: gradient (relative to each parameter's largest entry); the two sites'
#: noise uncorrelated; the 16-sample −ELBO after 500 steps at most half
#: its value at step 0 (the port on the CPU at 64 -> 128 x 1024 and
#: 128 -> 256 x 2048 ends at 0.078 and 0.046 of it).
C9_GRAD_REL_BOUND = 1e-4
C9_CORR_BOUND = 0.05
C9_NEG_ELBO_FRACTION = 0.5
#: Config 10: max |ensemble mean − exact mean| (the JAX package at 4096 x
#: 600 on keys 12, 13, 14: 0.0027, 0.00064, 0.0017); _rbf_phi at N = 512
#: against float64 pairs, relative to the largest entry (the port on the
#: CPU: 1.6e-6).
C10_MEAN_BOUND = 0.01
C10_PHI_REL_BOUND = 1e-4
#: MAP / Laplace on config 10's regression against the closed form (the
#: JAX package at 1000 steps: MAP 4.4e-5, covariance 3.1e-9, log Z
#: 7.9e-6).
MAP_MEAN_BOUND = 1e-3
MAP_COV_BOUND = 1e-6
MAP_LOGZ_BOUND = 1e-3
#: The full widths of phases 24-27: config 5 (fits, steps, ELBO samples),
#: config 9 (din, dh, points, steps), config 10 (particles, steps, points,
#: dimensions), parallel tempering (ladders, rungs, kept steps, burn-in)
#: and MAP (points, dimensions, Adam steps).
C5_SIZE = (65536, 50, 8)
C9_SIZE = (512, 1024, 8192, 200)
C10_SIZE = (4096, 600, 1024, 64)
PT_SIZE = (4096, 16, 100, 100)
MAP_SIZE = (1024, 64, 1000)


def _no_kernel(launches: dict, what: str):
    """The JAX package reaches no Pallas kernel on these paths: the port
    launches none of its four either."""
    check(not any(launches.values()), f"{what} launched a kernel: "
          f"{launches}")


def _median_wall(first: float, fn, n: int = 3) -> tuple:
    walls = [first] + _timed_runs(fn, n - 1) if first is not None else \
        _timed_runs(fn, n)
    return walls, sorted(walls)[len(walls) // 2]


def adev_vi_phase(dev, card: str, zero_counts, counts) -> dict:
    """Phase 24: bench config 5, 65536 fits x 50 steps x 8 ELBO samples,
    against the closed-form trajectory; card vs CPU at 64 x 10."""
    import torch

    from genjax_torch import entry as E
    from genjax_torch.core import random

    fits, steps, samples = C5_SIZE
    run, v0 = E.build_adev_vi(fits, steps, samples, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    zero_counts()
    t0 = time.perf_counter()
    v, first = run(random.key(0, device=dev))
    torch.cuda.synchronize()
    full_wall = time.perf_counter() - t0
    launches = counts()
    peak = (torch.cuda.max_memory_allocated() - held) / 1e9
    _no_kernel(launches, "config 5")
    v0c = v0.double().cpu()
    exact = torch.tensor(E.adev_vi_exact(v0c.numpy(), steps))
    first_err = float((first.double().cpu() - 4.0 * v0c).abs().max())
    final_rel = float(((v.double().cpu() - exact).abs() / exact).max())
    check(first_err <= C5_FIRST_GRAD_BOUND,
          f"config 5: first gradient {first_err} from 4 v0")
    check(final_rel <= C5_FINAL_REL_BOUND,
          f"config 5: final v {final_rel} (relative) from the closed form")
    key = random.key(3)
    card_v, card_g = E.build_adev_vi(64, 10, samples, device=dev)[0](
        key.to(dev))
    cpu_v, cpu_g = E.build_adev_vi(64, 10, samples, device="cpu")[0](key)
    card_cpu = max(float((card_v.cpu() - cpu_v).abs().max()),
                   float((card_g.cpu() - cpu_g).abs().max()) * 1e-3)
    check(card_cpu <= C5_CARD_CPU_BOUND,
          f"config 5: card vs CPU at 64 x 10 differ by {card_cpu}")
    # The rate: a run of the same width cut to 10 steps (the work a step
    # does does not depend on the step), the median of 3.
    t_steps = min(10, steps)
    run_t = E.build_adev_vi(fits, t_steps, samples, device=dev)[0]
    walls, wall = _median_wall(None, lambda i: run_t(
        random.key(10 + i, device=dev)))
    rate = fits * t_steps / wall
    p_steps = 2
    run_p = E.build_adev_vi(fits, p_steps, samples, device=dev)[0]
    run_p(random.key(20, device=dev))
    p_wall, busy, ops = device_busy(lambda: run_p(random.key(21, device=dev)))
    out = {"fits": fits, "steps": steps, "elbo_samples": samples,
           "first_grad_err": first_err, "final_rel_err": final_rel,
           "card_cpu_diff": card_cpu, "launches": launches,
           "full_run_s": full_wall,
           "full_run_grad_steps_per_s": fits * steps / full_wall,
           "timed_steps": t_steps, "wall_ms": [w * 1e3 for w in walls],
           "grad_steps_per_s": rate, "profiled_wall_ms": p_wall,
           "device_busy_ms": busy, "idle_share": 1.0 - busy / p_wall,
           "device_ops_per_step": ops / p_steps, "peak_gb": peak}
    print(f"[24 config 5] {card}: ADEV VI {fits} fits x {steps} steps x "
          f"{samples} ELBO samples: first gradient max |g - 4 v0| "
          f"{first_err:.3g} (bound {C5_FIRST_GRAD_BOUND}); final v max rel "
          f"err {final_rel:.3g} vs v0 (1 - 4e-3)^{steps} (bound "
          f"{C5_FINAL_REL_BOUND}); card vs CPU at 64 x 10 {card_cpu:.3g} "
          f"(bound {C5_CARD_CPU_BOUND}); launches {launches}; full run "
          f"{full_wall:.2f} s ({fits * steps / full_wall:.6g} grad-steps/s); "
          f"{t_steps}-step runs {[round(w * 1e3, 1) for w in walls]} ms "
          f"(median {wall * 1e3:.1f} ms), {rate:.6g} grad-steps/s; profiled "
          f"{p_steps}-step run {p_wall:.1f} ms, device busy {busy:.3f} ms, "
          f"idle share {out['idle_share']:.4f}, "
          f"{out['device_ops_per_step']:.0f} device ops a step; peak device "
          f"memory {peak:.3f} GB above what earlier phases hold", flush=True)
    return out


def bnn_vi_phase(dev, card: str, zero_counts, counts) -> dict:
    """Phase 25: bench config 9, the 512 -> 1024 -> 1 tanh network on 8192
    points, 200 Adam steps of a 1-sample ELBO gradient, full f32."""
    import torch

    from genjax_torch import entry as E
    from genjax_torch.core import random

    din, dh, b, steps = C9_SIZE
    run, x, y, loss_grad = E.build_bnn_vi(din, dh, b, steps, device=dev)
    p0 = E.bnn_params0(din, dh, dev)
    key = random.key(7, device=dev)
    # The first step's gradient against the hand-written reparameterized
    # -ELBO's autograd gradient on the same noise.
    k0 = random.fold_in(key, 0)
    with E.full_f32_matmul():
        (dp,) = loss_grad(k0, (p0,))
        eps1, eps2 = E.bnn_noise(k0, din, dh)
        pp = {k: v.clone().requires_grad_() for k, v in p0.items()}
        want = torch.autograd.grad(E.bnn_neg_elbo(pp, eps1, eps2, x, y),
                                   list(pp.values()))
    grad_rel = max(float((dp[k] - w).abs().max() / w.abs().max())
                   for k, w in zip(pp, want))
    e1, e2 = eps1[0].double(), eps2.double()
    corr = float(((e1 - e1.mean()) * (e2 - e2.mean())).mean()
                 / (e1.std(unbiased=False) * e2.std(unbiased=False)))
    check(grad_rel <= C9_GRAD_REL_BOUND,
          f"config 9: ADEV gradient {grad_rel} (relative) from the "
          "reparameterized gradient")
    check(abs(corr) < C9_CORR_BOUND,
          f"config 9: corr(eps_w2, eps_W1[0]) = {corr}")
    ekey = random.key(11, device=dev)
    before = float(E.bnn_neg_elbo_estimate(ekey, p0, x, y))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    zero_counts()
    t0 = time.perf_counter()
    p = run(key)
    torch.cuda.synchronize()
    full_wall = time.perf_counter() - t0
    launches = counts()
    peak = (torch.cuda.max_memory_allocated() - held) / 1e9
    _no_kernel(launches, "config 9")
    after = float(E.bnn_neg_elbo_estimate(ekey, p, x, y))
    mu1 = float(p["mu1"].abs().mean())
    check(mu1 > 0.0, "config 9: mu1 did not move")
    check(math.isfinite(after) and after <= C9_NEG_ELBO_FRACTION * before,
          f"config 9: -ELBO {after} after {steps} steps vs {before} at 0")
    t_steps = min(50, steps)
    # One timed 50-step run: its median of 3 is on record (PR 9).
    walls, wall = _median_wall(None, lambda i: run(
        random.key(30 + i, device=dev), n=t_steps), 1)
    rate = t_steps / wall
    fwd = 2.0 * b * din * dh + 2.0 * b * dh
    share = 3.0 * fwd * rate / F32_OPS_PER_S
    p_steps = 5
    p_wall, busy, ops = device_busy(lambda: run(
        random.key(40, device=dev), n=p_steps))
    out = {"width": [din, dh, b], "steps": steps, "precision": "f32, TF32 off",
           "first_grad_rel_err": grad_rel, "noise_corr": corr,
           "neg_elbo_0": before, "neg_elbo_end": after, "mean_abs_mu1": mu1,
           "launches": launches, "full_run_s": full_wall,
           "full_run_grad_steps_per_s": steps / full_wall,
           "timed_steps": t_steps, "wall_ms": [w * 1e3 for w in walls],
           "grad_steps_per_s": rate, "f32_peak_share_3fwd": share,
           "profiled_wall_ms": p_wall, "device_busy_ms": busy,
           "idle_share": 1.0 - busy / p_wall,
           "device_ops_per_step": ops / p_steps, "peak_gb": peak}
    print(f"[25 config 9] {card}: BNN VI {din} -> {dh} -> 1 on {b} points, "
          f"{steps} Adam steps, f32 (TF32 off): first ADEV gradient vs the "
          f"hand-written one {grad_rel:.3g} rel (bound {C9_GRAD_REL_BOUND}); "
          f"corr(eps_w2, eps_W1[0]) {corr:.4f} (bound {C9_CORR_BOUND}); "
          f"16-sample -ELBO {before:.6g} -> {after:.6g} (bound "
          f"{C9_NEG_ELBO_FRACTION} of it), mean |mu1| {mu1:.5f}; launches "
          f"{launches}; full run {full_wall:.2f} s ({steps / full_wall:.4g} "
          f"grad-steps/s); {t_steps}-step runs "
          f"{[round(w * 1e3, 1) for w in walls]} ms (median "
          f"{wall * 1e3:.1f} ms), {rate:.5g} grad-steps/s, {share:.4f} of "
          f"the f32 peak over 3 x fwd flops; profiled {p_steps}-step run "
          f"{p_wall:.1f} ms, device busy {busy:.3f} ms, idle share "
          f"{out['idle_share']:.4f}, {out['device_ops_per_step']:.0f} device "
          f"ops a step; peak device memory {peak:.3f} GB above what earlier "
          f"phases hold", flush=True)
    return out


def _phi_oracle(xs, grads):
    """SVGD's direction in float64, pair by pair (through the pairwise
    differences, not the Gram form)."""
    import torch

    from genjax_torch.inference.svgd import _median

    x, g = xs.double(), grads.double()
    n = x.shape[0]
    d2 = ((x[:, None] - x[None]) ** 2).sum(-1)
    h = max(float(_median(d2)) / math.log(n + 1.0), 1e-6)
    k = torch.exp(-d2 / h)
    return (k @ g + (2.0 / h) * (k.sum(0)[:, None] * x - k @ x)) / n


def svgd_phase(dev, card: str, zero_counts, counts) -> dict:
    """Phase 26: bench config 10, SVGD with 4096 particles x 600 steps on
    the 1024 x 64 Bayesian linear regression, against its exact
    posterior mean; _rbf_phi against float64 pairs."""
    import torch

    from genjax_torch import entry as E
    from genjax_torch.core import random
    from genjax_torch.inference.svgd import _rbf_phi

    parts, steps, b, d = C10_SIZE
    run, _, exact = E.build_svgd(parts, steps, b, d, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    zero_counts()
    t0 = time.perf_counter()
    w = run(random.key(12, device=dev))
    torch.cuda.synchronize()
    first_wall = time.perf_counter() - t0
    launches = counts()
    peak = (torch.cuda.max_memory_allocated() - held) / 1e9
    _no_kernel(launches, "config 10")
    err = float((w.double().mean(0).cpu()
                 - torch.tensor(exact["mean"])).abs().max())
    check(err <= C10_MEAN_BOUND, f"config 10: ensemble mean {err} from the "
          "exact posterior mean")
    xs = random.normal(random.key(40, device=dev), (512, d))
    gr = random.normal(random.key(41, device=dev), (512, d))
    oracle = _phi_oracle(xs, gr)
    phi_rel = float((_rbf_phi(xs, gr).double() - oracle).abs().max()
                    / oracle.abs().max())
    check(phi_rel <= C10_PHI_REL_BOUND, f"config 10: _rbf_phi at N = 512 "
          f"{phi_rel} (relative) from float64 pairs")
    walls, wall = _median_wall(first_wall, lambda i: run(
        random.key(13 + i, device=dev)))
    rate = parts * steps / wall
    p_steps = 20
    run_p = E.build_svgd(parts, p_steps, b, d, device=dev)[0]
    run_p(random.key(20, device=dev))
    p_wall, busy, ops = device_busy(lambda: run_p(random.key(21, device=dev)))
    out = {"particles": parts, "steps": steps, "post_mean_err": err,
           "phi_rel_err_512": phi_rel, "launches": launches,
           "wall_ms": [x * 1e3 for x in walls],
           "particle_grad_steps_per_s": rate, "profiled_steps": p_steps,
           "profiled_wall_ms": p_wall, "device_busy_ms": busy,
           "idle_share": 1.0 - busy / p_wall,
           "device_ops_per_step": ops / p_steps, "peak_gb": peak}
    print(f"[26 config 10] {card}: SVGD {parts} particles x {steps} steps on "
          f"the {b} x {d} regression: max |ensemble mean - exact| {err:.5f} "
          f"(bound {C10_MEAN_BOUND}); _rbf_phi at N = 512 vs float64 pairs "
          f"{phi_rel:.3g} rel (bound {C10_PHI_REL_BOUND}); launches "
          f"{launches}; wall per run {[round(x * 1e3, 1) for x in walls]} ms "
          f"(median {wall * 1e3:.1f} ms), {rate:.6g} particle-grad-steps/s; "
          f"profiled {p_steps}-step run {p_wall:.1f} ms, device busy "
          f"{busy:.3f} ms, idle share {out['idle_share']:.4f}, "
          f"{out['device_ops_per_step']:.0f} device ops a step; peak device "
          f"memory {peak:.3f} GB above what earlier phases hold", flush=True)
    return out


def pt_map_phase(dev, card: str, zero_counts, counts) -> dict:
    """Phase 27: parallel tempering on config 6's conjugate model (4096
    ladders x 16 rungs, 200 burn-in + 200 steps) within 4 MCSE of the
    closed form; MAP and Laplace on config 10's regression against its
    exact posterior and evidence."""
    import numpy as np
    import torch

    from genjax_torch import entry as E
    from genjax_torch.core import random

    ladders, rungs, keep, burn = PT_SIZE
    run, exact = E.build_pt(ladders, rungs, keep, burn, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    zero_counts()
    t0 = time.perf_counter()
    res = run(random.key(1, device=dev))
    torch.cuda.synchronize()
    pt_wall = time.perf_counter() - t0
    launches = counts()
    peak = (torch.cuda.max_memory_allocated() - held) / 1e9
    _no_kernel(launches, "parallel tempering")
    s = res.samples.double().cpu()
    m = float(s.mean())
    mcse_m = float(s.mean(1).std() / math.sqrt(ladders))
    s2 = ((s - m) ** 2).mean(1)
    sd = math.sqrt(float(s2.mean()))
    mcse_sd = float(s2.std() / math.sqrt(ladders)) / (2 * sd)
    z_m = abs(m - exact["mean"]) / mcse_m
    z_sd = abs(sd - exact["sd"]) / mcse_sd
    check(z_m <= 4.0 and z_sd <= 4.0,
          f"PT: cold chain mean {m} sd {sd} vs {exact} ({z_m:.2f}, "
          f"{z_sd:.2f} MCSE)")
    swap = np.nanmean(res.swap_rate.double().cpu().numpy(), axis=0)
    accept = res.accept_rate.double().mean(0).cpu().numpy()
    check(bool(np.all(swap > 0.0)), f"PT: a rung pair never swapped: {swap}")
    t_steps = 20
    run_t = E.build_pt(ladders, rungs, t_steps, 0, device=dev)[0]
    walls, wall = _median_wall(None, lambda i: run_t(
        random.key(10 + i, device=dev)))
    rate = ladders * rungs * t_steps / wall
    p_steps = 4
    run_p = E.build_pt(ladders, rungs, p_steps, 0, device=dev)[0]
    run_p(random.key(20, device=dev))
    p_wall, busy, ops = device_busy(lambda: run_p(random.key(21, device=dev)))
    pt = {"ladders": ladders, "rungs": rungs, "steps": keep, "burn_in": burn,
          "mean": m, "sd": sd, "exact": exact, "mcse_mean": mcse_m,
          "mcse_sd": mcse_sd, "z_mean": z_m, "z_sd": z_sd,
          "swap_rate": swap.tolist(), "accept_rate": accept.tolist(),
          "launches": launches, "run_s": pt_wall, "timed_steps": t_steps,
          "wall_ms": [w * 1e3 for w in walls], "replica_steps_per_s": rate,
          "profiled_wall_ms": p_wall, "device_busy_ms": busy,
          "idle_share": 1.0 - busy / p_wall,
          "device_ops_per_step": ops / p_steps, "peak_gb": peak,
          "_result": res}
    print(f"[27 parallel tempering] {card}: config 6's model, {ladders} "
          f"ladders x {rungs} rungs, {burn} + {keep} steps: cold mean "
          f"{m:.5f} vs {exact['mean']:.5f} ({z_m:.2f} MCSE), sd {sd:.5f} vs "
          f"{exact['sd']:.5f} ({z_sd:.2f} MCSE; bound 4); swap acceptance by "
          f"pair {[round(float(v), 3) for v in swap]}; MH acceptance by rung "
          f"{[round(float(v), 3) for v in accept]}; launches {launches}; run "
          f"{pt_wall:.2f} s; {t_steps}-step runs "
          f"{[round(w * 1e3, 1) for w in walls]} ms (median "
          f"{wall * 1e3:.1f} ms), {rate:.6g} replica-steps/s; profiled "
          f"{p_steps}-step run {p_wall:.1f} ms, device busy {busy:.3f} ms, "
          f"idle share {pt['idle_share']:.4f}, "
          f"{pt['device_ops_per_step']:.0f} device ops a step; peak device "
          f"memory {peak:.3f} GB above what earlier phases hold", flush=True)

    map_b, map_d, map_steps = MAP_SIZE
    run_ml, exact_ml = E.build_map_laplace(map_b, map_d, map_steps,
                                           device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    zero_counts()
    t0 = time.perf_counter()
    mres, lap = run_ml(random.key(0, device=dev))
    torch.cuda.synchronize()
    ml_wall = time.perf_counter() - t0
    ml_launches = counts()
    ml_peak = (torch.cuda.max_memory_allocated() - held) / 1e9
    _no_kernel(ml_launches, "MAP / Laplace")
    map_err = float((mres.choices["w"].double().cpu()
                     - torch.tensor(exact_ml["mean"])).abs().max())
    cov_err = float((lap.cov.double().cpu()
                     - torch.tensor(exact_ml["cov"])).abs().max())
    logz_err = abs(float(lap.log_z) - exact_ml["log_z"])
    check(map_err <= MAP_MEAN_BOUND, f"MAP: {map_err} from the exact mean")
    check(cov_err <= MAP_COV_BOUND, f"Laplace: covariance {cov_err} from "
          "the exact one")
    check(logz_err <= MAP_LOGZ_BOUND, f"Laplace: log Z {float(lap.log_z)} "
          f"vs exact {exact_ml['log_z']}")
    ml_walls, ml_med = _median_wall(ml_wall, lambda i: run_ml(
        random.key(1 + i, device=dev)))
    p_wall, busy, ops = device_busy(lambda: run_ml(random.key(9, device=dev)))
    ml = {"steps": map_steps, "map_err": map_err, "cov_err": cov_err,
          "log_z": float(lap.log_z), "exact_log_z": exact_ml["log_z"],
          "log_z_err": logz_err, "launches": ml_launches,
          "wall_ms": [w * 1e3 for w in ml_walls],
          "adam_steps_per_s": map_steps / ml_med,
          "profiled_wall_ms": p_wall, "device_busy_ms": busy,
          "idle_share": 1.0 - busy / p_wall,
          "device_ops_per_step": ops / map_steps, "peak_gb": ml_peak}
    print(f"[27 MAP + Laplace] {card}: config 10's regression, "
          f"map_optimize(include_jacobian=True) {map_steps} Adam steps then "
          f"laplace_approximation: MAP {map_err:.3g} from the exact mean "
          f"(bound {MAP_MEAN_BOUND}), covariance {cov_err:.3g} (bound "
          f"{MAP_COV_BOUND}), log Z {float(lap.log_z):.6f} vs exact "
          f"{exact_ml['log_z']:.6f} (|err| {logz_err:.3g}, bound "
          f"{MAP_LOGZ_BOUND}); launches {ml_launches}; wall per run "
          f"{[round(w * 1e3, 1) for w in ml_walls]} ms (median "
          f"{ml_med * 1e3:.1f} ms), {map_steps / ml_med:.6g} Adam steps/s; "
          f"profiled run {p_wall:.1f} ms, device busy {busy:.3f} ms, idle "
          f"share {ml['idle_share']:.4f}, {ml['device_ops_per_step']:.0f} "
          f"device ops a step; peak device memory {ml_peak:.4f} GB",
          flush=True)
    return {"pt": pt, "map_laplace": ml}


#: Phase 28's sizes (a CPU rehearsal shrinks them): config 4 sharded
#: (particles, steps), the linear model's steps, the layout check's
#: weights and HMM steps, SIR's particles, the HMM (states, steps, the
#: bitwise case's steps), NUTS (chains, warmup, samples, depth), SVGD
#: (config 10's C10_SIZE).
DIST_SIZE = {"pf": (1 << 20, 32), "linear_steps": 15, "layout_n": 1 << 20,
             "layout_hmm_t": 16384, "sir": 1 << 20,
             "hmm": (64, 16384, 1024), "nuts": (2048, 10, 10, 6)}
#: Phase 28's bounds: the two config-4 drivers' 0.25 and the linear
#: model's 0.05 (phase 6), the CDF kernel's 4 destinations (phase 3),
#: SIR's log Z against ImportanceK's (1e-5 relative: the same particles,
#: another summation order), the HMM's log marginal (1e-6 relative) and
#: alphas (rtol 2e-5, atol 1e-4 where the filtering probability is above
#: e^-80, tests/parallel/test_seq.py:57-60).
DIST_PF_BOUND, DIST_KALMAN_BOUND, DIST_CDF_BOUND = 0.25, 0.05, 4
DIST_SIR_REL, DIST_HMM_REL = 1e-5, 1e-6


def _dist_measure(label: str, card: str, run, steps: int, work: float,
                  unit: str, zero_counts, counts, first=None,
                  phase: str = "28", runs: int = 3) -> dict:
    """Time ``run(i)`` (a whole run, synchronized) ``runs`` times, the first
    with the launch counters and the collective log set to 0 just before
    it, and profile one more run: the median wall, the rate (``work``
    per second), the collectives a step by op with their bytes, the host
    syncs a step (reads of the ring's counts and of the backward
    sampler's tables), device-busy time, idle share, device ops a step
    and the peak device memory above what is held before."""
    import torch

    from genjax_torch.parallel import comm

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    zero_counts()
    comm.reset()
    t0 = time.perf_counter()
    result = run(0)
    torch.cuda.synchronize()
    wall0 = time.perf_counter() - t0
    launches = counts()
    by_op = {k: {f: v[f] / steps for f in v} for k, v in comm.by_op().items()}
    syncs, trips = comm.host_syncs, comm.ring_trips
    max_elements = comm.max_elements()
    peak = (torch.cuda.max_memory_allocated() - held) / 1e9
    walls, wall = _median_wall(wall0, lambda i: run(i + 1), runs)
    p_wall, busy, ops = device_busy(lambda: run(9))
    out = {"result": result, "launches": launches, "wall_ms":
           [w * 1e3 for w in walls], "median_wall_ms": wall * 1e3,
           f"{unit}_per_s": work / wall, "collectives_per_step": by_op,
           "comm_host_syncs_per_step": syncs / steps, "ring_trips": trips,
           "max_collective_elements": max_elements,
           "profiled_wall_ms": p_wall, "device_busy_ms": busy,
           "idle_share": 1.0 - busy / p_wall,
           "device_ops_per_step": ops / steps, "peak_gb": peak}
    print(f"[{phase}{label}] {card}: wall per run "
          f"{[round(w * 1e3, 2) for w in walls]} ms (median "
          f"{wall * 1e3:.2f} ms), {work / wall:.6g} {unit}/s; collectives a "
          f"step {by_op}; ring trips {trips}; comm host syncs a step "
          f"{syncs / steps:.3f}; profiled run {p_wall:.1f} ms, device busy "
          f"{busy:.3f} ms, idle share {out['idle_share']:.4f}, "
          f"{ops / steps:.1f} device ops a step; peak device memory "
          f"{peak:.3f} GB; launches {launches}", flush=True)
    return out


def distributed_phase(dev, card: str, zero_counts, counts) -> dict:
    """Phase 28: the distributed layer over NCCL in a world of one (the
    one card), at full width: config 4 sharded (28a), the layout
    independence of the rank-local parts at D = 2, 4, 8 shapes (28b), the
    product resample at 2^20 against the CDF kernel and float64 counts
    (28c), sharded SIR (28d), the time-sharded HMM (28e), NUTS with
    ``mesh=`` (28f) and sharded SVGD (28g)."""
    import tempfile

    import torch
    import torch.distributed as dist

    import genjax_torch
    from genjax_torch import entry as E
    from genjax_torch import parallel as P
    from genjax_torch.core import random
    from genjax_torch.inference import warmup_chains
    from genjax_torch.inference import Target
    from genjax_torch.inference.adaptation import group_sums
    from genjax_torch.lang.distributions.discrete_hmm import (
        DiscreteHMMConfiguration,
        forward_filter,
    )
    from genjax_torch.ops import cdf_counts
    from genjax_torch.parallel import collectives as PC
    from genjax_torch.parallel.seq import block_summaries
    from genjax_torch.inference.svgd import _rbf_phi
    from genjax_torch.parallel.svgd import _phi_block

    store = tempfile.mkdtemp(prefix="genjax_nccl_")
    P.init_distributed(num_processes=1, init_method=f"file://{store}/store",
                       device="cuda")
    out = {}
    try:
        check(dist.get_backend() == "nccl", f"phase 28: the group's backend "
              f"is {dist.get_backend()}, not nccl")
        mesh = P.particle_mesh("cuda")
        print(f"[28 group] {card}: NCCL world of {dist.get_world_size()} "
              f"through a file:// store, mesh {mesh}", flush=True)

        # -- 28a. config 4 sharded -------------------------------------
        n, steps = DIST_SIZE["pf"]
        run_sh, work = E.build_sharded_pf(n, steps, device=dev)
        res = _dist_measure("a config 4 sharded", card, lambda i: float(
            run_sh(random.key(i, device=dev))), steps, work,
            "particle_steps", zero_counts, counts)
        ref_pf = float(E.build_pf(n, steps, device=dev)[0](
            random.key(0, device=dev)))
        lz = res["result"]
        check(math.isfinite(lz) and abs(lz - ref_pf) < DIST_PF_BOUND,
              f"28a: sharded log Z {lz} vs build_pf {ref_pf}")
        check(res["ring_trips"] == 0, f"28a: {res['ring_trips']} ring trips")
        check(res["max_collective_elements"] < n, "28a: a collective "
              f"carried {res['max_collective_elements']} elements")
        _no_kernel(res["launches"], "28a (the product path)")
        lin_steps = DIST_SIZE["linear_steps"]
        run_lin, _ = E.build_sharded_pf(n, lin_steps, model="linear",
                                        device=dev)
        lz_lin = float(run_lin(random.key(314159, device=dev)))
        want_lin = E.kalman_loglik(E.linear_observations(lin_steps))
        check(abs(lz_lin - want_lin) < DIST_KALMAN_BOUND,
              f"28a: linear log Z {lz_lin} vs Kalman {want_lin}")
        run_base, _ = E.build_sharded_pf(n, steps, use_collectives=False,
                                         device=dev)
        base = _dist_measure("a config 4 gathered baseline", card,
                             lambda i: float(run_base(random.key(
                                 i, device=dev))), steps, work,
                             "particle_steps", zero_counts, counts)
        resamples = int(round(base["collectives_per_step"].get(
            "all_gather/resample_weights", {"calls": 0})["calls"] * steps))
        check(base["launches"]["cdf_counts"] == resamples,
              f"28a baseline: {base['launches']['cdf_counts']} CDF launches "
              f"for {resamples} resamples")
        check(abs(base["result"] - lz) < DIST_PF_BOUND,
              f"28a baseline log Z {base['result']} vs {lz}")
        out["config_4_sharded"] = {**res, "build_pf_log_z": ref_pf,
                                   "linear_log_z": lz_lin,
                                   "kalman_log_z": want_lin,
                                   "baseline": base,
                                   "baseline_resamples": resamples}
        print(f"[28a config 4 sharded] {card}: {n} x {steps}: log Z {lz:.5f} "
              f"vs build_pf {ref_pf:.5f} (bound {DIST_PF_BOUND}); linear "
              f"{lz_lin:.5f} vs Kalman {want_lin:.5f} (bound "
              f"{DIST_KALMAN_BOUND}); ring trips {res['ring_trips']}, "
              f"largest collective {res['max_collective_elements']} "
              f"elements (n = {n}); baseline log Z {base['result']:.5f}, "
              f"{base['launches']['cdf_counts']} CDF launches for "
              f"{resamples} resamples", flush=True)

        # -- 28b. layout independence of the rank-local parts ----------
        t_layout = time.perf_counter()
        n_l = DIST_SIZE["layout_n"]
        lw = 3.0 * random.normal(random.key(21, device=dev), (n_l,))
        m = lw.max()
        b = PC._layout_free_block(n_l, 256)
        cdf_bad = layout_mismatches(
            lambda x: (lambda w, s: (w, s.T))(*PC.block_partials(x, m, b)),
            lw)
        within, stats = PC.block_partials(lw, m, b)
        seeds, bcum_excl, _, total_rep, _ = PC.combine_partials(stats)
        key = random.key(22, device=dev)
        starts1, ends1 = PC._blocked_counts(key, within, seeds, bcum_excl,
                                            total_rep, n_l, 1, 0)
        count_bad = {}
        for d in (2, 4, 8):
            bad = 0
            for r, sl in enumerate(layout_slices(n_l, d)):
                w_r, _ = PC.block_partials(lw[sl], m, b)
                s_r, e_r = PC._blocked_counts(key, w_r, seeds, bcum_excl,
                                              total_rep, n_l, d, r)
                bad += not (torch.equal(s_r, starts1[sl])
                            and torch.equal(e_r, ends1[sl]))
            count_bad[d] = bad
        chains = DIST_SIZE["nuts"][0]
        zs = random.normal(random.key(23, device=dev), (chains, 2))
        acc = random.uniform(random.key(24, device=dev), (chains,))
        gb = PC._layout_free_block(chains, 8)
        x = torch.cat([zs, acc[:, None]], 1)
        chain_bad = layout_mismatches(lambda v: (group_sums(v, gb),), x)
        s_hmm, t_lay = DIST_SIZE["hmm"][0], DIST_SIZE["layout_hmm_t"]
        config = DiscreteHMMConfiguration.circulant(s_hmm, s_hmm, device=dev)
        obs_ll = config.observation_logits[
            :, E.hmm_observations(s_hmm, t_lay, dev)].T.contiguous()
        hb = PC._layout_free_block(t_lay, 256)
        whole = block_summaries(config, obs_ll, hb, True)
        seq_bad = {}
        for d in (2, 4, 8):
            bad = 0
            for r, sl in enumerate(layout_slices(t_lay, d)):
                part = block_summaries(config, obs_ll[sl], hb, r == 0)
                rows = slice(r * whole[0].shape[0] // d,
                             (r + 1) * whole[0].shape[0] // d)
                bad += not (torch.equal(part[0], whole[0][rows])
                            and torch.equal(part[1], whole[1][rows]))
            seq_bad[d] = bad
        parts, _, _, dd = C10_SIZE
        xs = random.normal(random.key(27, device=dev), (parts, dd))
        grads = random.normal(random.key(28, device=dev), (parts, dd))
        svgd_bad = layout_mismatches(
            lambda x: (_phi_block(x, xs, grads, 256),), xs)
        for name, bad in (("block stats", cdf_bad), ("counts", count_bad),
                          ("chain partials", chain_bad),
                          ("seq summaries", seq_bad),
                          ("SVGD rows", svgd_bad)):
            check(not any(bad.values()), f"28b: {name} differ from the "
                  f"one-rank rows on ranks {bad}")
        out["layout"] = {"block_stats": cdf_bad, "counts": count_bad,
                         "chain_partials": chain_bad, "seq_summaries":
                         seq_bad, "svgd_rows": svgd_bad, "n": n_l, "block": b, "chains": chains,
                         "chain_group": gb, "hmm_steps": t_lay,
                         "hmm_block": hb,
                         "check_s": time.perf_counter() - t_layout}
        print(f"[28b layout] {card}: ranks differing from the one-rank rows "
              f"at D = 2, 4, 8: block stats of {n_l} weights (B = {b}) "
              f"{cdf_bad}, offspring intervals {count_bad}, chain-group "
              f"partials of {chains} x 2 (group {gb}) {chain_bad}, seq block "
              f"summaries S = {s_hmm}, T = {t_lay} (block {hb}) {seq_bad}, "
              f"SVGD direction rows of {parts} x {dd} {svgd_bad}; "
              f"the checks took {out['layout']['check_s']:.2f} s",
              flush=True)

        # -- 28c. the product resample at 2^20 --------------------------
        idx = torch.arange(n_l, dtype=torch.float32, device=dev)
        res = _dist_measure("c resample", card, lambda i: PC.ring_resample_step(
            key, lw, (idx,), mesh), 1, n_l, "particles", zero_counts, counts)
        (anc,), _, _ = res.pop("result")
        _no_kernel(res["launches"], "28c (the product path)")
        cc = torch.cumsum(torch.bincount(anc.long(), minlength=n_l), 0)
        kern = cdf_counts.systematic_cumulative(key, lw, n_l).long()
        cc64 = float64_counts(key, lw, n_l)
        to_kernel = int((cc - kern).abs().max())
        ties, largest = count_ties(cc, cc64)
        check(to_kernel <= DIST_CDF_BOUND, f"28c: ring counts {to_kernel} "
              f"destinations from the CDF kernel's")
        check(largest <= 1, f"28c: ring counts {largest} destinations from "
              "the float64 counts")
        out["resample"] = {**res, "n": n_l, "to_kernel": to_kernel,
                           "float64_ties": ties, "float64_largest": largest}
        print(f"[28c resample] {card}: ring_resample_step at {n_l}: counts "
              f"within {to_kernel} destinations of the CDF kernel's (bound "
              f"{DIST_CDF_BOUND}); against float64 counts {ties} f32 ties, "
              f"each {largest} destination", flush=True)

        # -- 28d. sharded SIR -------------------------------------------
        k = DIST_SIZE["sir"]
        sir, _ = E.build_sharded_sir(k, device=dev)
        res = _dist_measure("d SIR", card, lambda i: tuple(
            float(v) for v in sir(random.key(i, device=dev))), 1, k,
            "particles", zero_counts, counts)
        mean, logz = res["result"]
        ref_mean, ref_logz = (float(v) for v in E.entry(k, device=dev)[0](
            random.key(0, device=dev)))
        # Posterior sd of Beta(3, 2) is 0.2; the standard error of a
        # weighted mean is that over the root of the weights' ESS.
        target = Target(E.quickstart_model(), (2.0, 2.0),
                        genjax_torch.C["v"].set(True))
        col = P.sharded_importance(target, k, mesh)(
            random.split(random.key(0, device=dev))[1])
        ess = float(P.blocked_ess(col.get_log_weights(), mesh))
        se = 0.2 / math.sqrt(ess)
        check(abs(mean - 0.6) <= 4 * se, f"28d: mean {mean} vs 0.6 (se {se})")
        check(abs(logz - ref_logz) <= DIST_SIR_REL * abs(ref_logz),
              f"28d: log Z {logz} vs ImportanceK {ref_logz}")
        out["sir"] = {**res, "importance_k_log_z": ref_logz,
                      "importance_k_mean": ref_mean, "ess": ess, "se": se}
        print(f"[28d SIR] {card}: K = {k}: mean {mean:.6f} (0.6, 4 se "
              f"{4 * se:.3g}), log Z {logz:.7f} vs ImportanceK "
              f"{ref_logz:.7f} (rel {abs(logz - ref_logz) / abs(ref_logz):.3g}"
              f", bound {DIST_SIR_REL})", flush=True)

        # -- 28e. the time-sharded HMM ----------------------------------
        s_hmm, t_hmm, t_bit = DIST_SIZE["hmm"]
        run_h, (config, obs) = E.build_time_sharded_hmm(s_hmm, t_hmm,
                                                        device=dev)
        res = _dist_measure("e time-sharded HMM", card, lambda i: run_h(
            random.key(i, device=dev)), t_hmm, t_hmm, "steps", zero_counts,
            counts)
        alphas, lz_h, path = res.pop("result")
        t0 = time.perf_counter()
        a_ref, lz_ref = forward_filter(config, obs)
        torch.cuda.synchronize()
        seq_s = time.perf_counter() - t0
        rel = abs(float(lz_h) - float(lz_ref)) / abs(float(lz_ref))
        check(rel <= DIST_HMM_REL, f"28e: log marginal {float(lz_h)} vs "
              f"forward_filter {float(lz_ref)} ({rel} relative)")
        live = (a_ref - torch.logsumexp(a_ref, 1, keepdim=True)) > -80.0
        close = (alphas - a_ref).abs() <= 1e-4 + 2e-5 * a_ref.abs()
        check(bool(close[live].all()), "28e: alphas off where the filtering "
              "probability is above e^-80")
        check(path.shape == (t_hmm,) and bool(((path >= 0)
                                               & (path < s_hmm)).all()),
              "28e: the sampled path is out of range")
        run_b, (cfg_b, obs_b) = E.build_time_sharded_hmm(
            s_hmm, t_bit, block=t_bit, device=dev)
        a_b, lz_b, _ = run_b(random.key(3, device=dev))
        a_fb, lz_fb = forward_filter(cfg_b, obs_b)
        check(torch.equal(a_b, a_fb) and torch.equal(lz_b, lz_fb),
              f"28e: T = {t_bit}, block = T is not forward_filter's bits")
        out["hmm"] = {**res, "log_z": float(lz_h),
                      "forward_filter_log_z": float(lz_ref), "rel": rel,
                      "forward_filter_s": seq_s, "live_alphas":
                      int(live.sum())}
        print(f"[28e HMM] {card}: S = {s_hmm}, T = {t_hmm} (block "
              f"{PC._layout_free_block(t_hmm, 256)}): log marginal "
              f"{float(lz_h):.4f} vs forward_filter {float(lz_ref):.4f} "
              f"({rel:.3g} rel, bound {DIST_HMM_REL}), alphas within rtol "
              f"2e-5 / atol 1e-4 on {int(live.sum())} entries above e^-80; "
              f"the sequential filter took {seq_s:.2f} s; T = {t_bit} with "
              "block = T bitwise forward_filter", flush=True)

        # -- 28f. NUTS with mesh= ---------------------------------------
        chains, warm, samples, depth = DIST_SIZE["nuts"]
        chain_mesh = P.particle_mesh("cuda", "chains")
        run_m, _ = E.build_nuts_regression(chains, warm, samples, depth,
                                           device=dev, mesh=chain_mesh)
        run_n, _ = E.build_nuts_regression(chains, warm, samples, depth,
                                           device=dev)
        res = _dist_measure("f NUTS mesh=", card, lambda i: run_m(
            random.key(i, device=dev)), warm + samples,
            chains * (warm + samples), "chain_transitions", zero_counts,
            counts, runs=1)  # one timed run: the median of 3 is on record
        chm_m, _ = res.pop("result")
        chm_n, _ = run_n(random.key(0, device=dev))
        logd = _regression_logdensity(dev, chains)
        z0 = random.normal(random.key(25, device=dev), (chains, 2))
        w_m = warmup_chains(logd, z0, random.key(26, device=dev), warm, depth,
                            mesh=chain_mesh)
        w_n = warmup_chains(logd, z0, random.key(26, device=dev), warm, depth)
        same = all(torch.equal(chm_m[a], chm_n[a]) for a in ("slope", "icept"))
        same_w = all(torch.equal(a, b) for a, b in zip(w_m, w_n))
        check(same and same_w, f"28f: mesh= draws equal {same}, eps / mass "
              f"/ warm positions equal {same_w}")
        out["nuts"] = res
        print(f"[28f NUTS] {card}: {chains} chains x ({warm} + {samples}), "
              f"max_depth {depth}: draws, eps and mass with mesh= bitwise "
              "those of mesh=None", flush=True)

        # -- 28g. sharded SVGD ------------------------------------------
        parts, svgd_steps, bb, dd = C10_SIZE
        run_s, _, exact = E.build_sharded_svgd(parts, svgd_steps, bb, dd,
                                               device=dev)
        res = _dist_measure("g SVGD", card, lambda i: run_s(random.key(
            12 + i, device=dev)), svgd_steps, parts * svgd_steps,
            "particle_grad_steps", zero_counts, counts)
        w = res.pop("result")
        err = float((w.double().mean(0).cpu()
                     - torch.tensor(exact["mean"])).abs().max())
        check(err <= C10_MEAN_BOUND, f"28g: ensemble mean {err} from the "
              "exact posterior mean")
        # One sharded direction at full width on a cloud offset from 0
        # (where the repulsion's two sums cancel most digits) against the
        # same direction in float64.
        xs = random.normal(random.key(40, device=dev), (parts, dd)) + 3.0
        grads = random.normal(random.key(41, device=dev), (parts, dd))
        phi64 = _rbf_phi(xs.double(), grads.double(), 256)
        phi_rel = float((_phi_block(xs, xs, grads, 256).double() - phi64)
                        .abs().max() / phi64.abs().max())
        check(phi_rel <= C10_PHI_REL_BOUND, f"28g: the sharded direction "
              f"{phi_rel} (relative) from float64")
        out["svgd"] = {**res, "post_mean_err": err, "phi_rel_err": phi_rel}
        print(f"[28g SVGD] {card}: {parts} x {svgd_steps}: max |ensemble "
              f"mean - exact| {err:.5f} (bound {C10_MEAN_BOUND}); one "
              f"sharded direction on a cloud offset by 3 vs float64 "
              f"{phi_rel:.3g} rel (bound {C10_PHI_REL_BOUND})", flush=True)
    finally:
        dist.destroy_process_group()
    return out


# -- 29. the distribution library ---------------------------------------

#: Phase 29a's table, copied from the JAX package's tests (this script
#: imports nothing of it): name -> (parameters, test values, in the JAX
#: tests' CASES table). The 33 CASES rows are
#: tests/lang/test_distributions.py:27-72; bernoulli, flip, categorical,
#: dirichlet and the two multivariate normals :122-175; multinomial,
#: dirichlet_multinomial and beta_binomial :177-198; beta_quotient,
#: lambert_w_normal, power_spherical and von_mises_fisher
#: tests/lang/test_distributions_tail.py; half_student_t and
#: logit_normal, which no JAX test draws, take the parameters of its
#: support-metadata table (tests/lang/test_distributions.py:218-235).
#: A distribution outside CASES has its log-density compared at its
#: first 16 draws.
DIST_TABLE = {
    "normal": ((0.5, 2.0), [0.0, 1.0, -3.0], True),
    "cauchy": ((0.0, 1.5), [0.0, 2.0], True),
    "laplace": ((1.0, 2.0), [0.0, 3.0], True),
    "logistic": ((0.0, 1.0), [0.0, 1.0], True),
    "gumbel": ((0.5, 1.2), [0.0, 2.0], True),
    "student_t": ((4.0, 0.0, 1.0), [0.0, 1.5], True),
    "uniform": ((1.0, 3.0), [1.5, 2.5], True),
    "exponential": ((2.0,), [0.5, 2.0], True),
    "beta": ((2.0, 3.0), [0.3, 0.7], True),
    "gamma": ((2.0, 3.0), [0.5, 1.5], True),
    "inverse_gamma": ((3.0, 2.0), [0.5, 1.5], True),
    "chi2": ((3.0,), [1.0, 4.0], True),
    "chi": ((3.0,), [1.0, 2.0], True),
    "weibull": ((2.0, 1.5), [0.5, 2.0], True),
    "log_normal": ((0.0, 1.0), [0.5, 2.0], True),
    "half_normal": ((2.0,), [0.5, 3.0], True),
    "half_cauchy": ((0.0, 1.0), [0.5, 3.0], True),
    "truncated_normal": ((0.0, 1.0, -1.0, 2.0), [0.0, 1.0], True),
    "von_mises": ((0.0, 2.0), [0.0, 1.0], True),
    "inverse_gaussian": ((1.0, 2.0), [0.5, 1.5], True),
    "moyal": ((0.0, 1.0), [0.0, 2.0], True),
    "poisson": ((3.5,), [0, 2, 5], True),
    "geometric": ((0.3,), [0, 1, 5], True),
    "binomial": ((10.0, 0.4), [0, 4, 10], True),
    "negative_binomial": ((5.0, 0.4), [0, 3, 8], True),
    "skellam": ((2.0, 3.0), [-2, 0, 3], True),
    "zipf": ((2.5,), [1, 2, 5], True),
    "kumaraswamy": ((2.0, 3.0), [0.3, 0.6], True),
    "exp_gamma": ((2.0, 1.0), [-0.5, 0.5], True),
    "exp_inverse_gamma": ((2.0, 1.0), [-0.5, 0.5], True),
    "non_central_chi2": ((3.0, 2.0), [2.0, 5.0], True),
    "double_sided_maxwell": ((0.0, 1.0), [1.0, -1.5], True),
    "truncated_cauchy": ((0.0, 1.0, -2.0, 2.0), [0.0, 1.0], True),
    "bernoulli": ((math.log(0.3 / 0.7),), [0, 1], False),
    "flip": ((0.3,), [0, 1], False),
    "categorical": (([math.log(0.1), math.log(0.2), math.log(0.7)],),
                    [0, 1, 2], False),
    "dirichlet": (([2.0, 3.0, 4.0],), None, False),
    "mv_normal_diag": (([0.0, 1.0], [1.0, 2.0]), None, False),
    "mv_normal": (([0.0, 1.0], [[2.0, 0.5], [0.5, 1.0]]), None, False),
    "multinomial": ((10.0, [math.log(0.2), math.log(0.3), math.log(0.5)]),
                    None, False),
    "dirichlet_multinomial": ((10.0, [1.0, 2.0, 3.0]), None, False),
    "beta_binomial": ((10.0, 2.0, 3.0), [0, 4, 10], False),
    "beta_quotient": ((2.0, 3.0, 4.0, 3.0), None, False),
    "lambert_w_normal": ((0.0, 1.0, 0.3), [-1.0, 0.0, 1.5], False),
    "power_spherical": (([0.0, 0.0, 1.0], 10.0), None, False),
    "von_mises_fisher": (([0.0, 1.0, 0.0], 5.0), None, False),
    "half_student_t": ((3.0, 0.0, 1.0), [0.5, 2.0], False),
    "logit_normal": ((0.0, 1.0), [0.3, 0.7], False),
}
#: The log-densities that go through a special function or a series
#: (1e-4 relative card vs CPU; the rest 1e-5).
DIST_SPECIAL = {"non_central_chi2", "von_mises", "von_mises_fisher",
                "lambert_w_normal", "zipf", "beta_quotient"}
#: Draws per distribution on the card, keys for the integer samplers'
#: card-vs-CPU comparison, and the share of them that must agree.
DIST_DRAWS, DIST_INT_KEYS, DIST_INT_AGREE = 1 << 20, 1 << 16, 0.999
#: Phase 29b and 29c: the gamma-Poisson SIR and the scale-free NUTS.
GP_SIZE, GP_MEAN_BOUND, GP_LOGZ_BOUND = 1 << 20, 0.01, 0.006
SCALE_NUTS_SIZE = (2048, 200, 100, 6)


def _dist_cdf(name: str):
    """The float64 CDF of a univariate row of :data:`DIST_TABLE` (scipy
    or a closed form), or None for a vector-valued one."""
    import numpy as np
    import scipy.special as ssp
    import scipy.stats as sps

    frozen = {
        "normal": sps.norm(0.5, 2.0), "cauchy": sps.cauchy(0.0, 1.5),
        "laplace": sps.laplace(1.0, 2.0), "logistic": sps.logistic(0.0, 1.0),
        "gumbel": sps.gumbel_r(0.5, 1.2), "student_t": sps.t(4.0),
        "uniform": sps.uniform(1.0, 2.0), "exponential": sps.expon(scale=0.5),
        "beta": sps.beta(2.0, 3.0), "gamma": sps.gamma(2.0, scale=1 / 3.0),
        "inverse_gamma": sps.invgamma(3.0, scale=2.0), "chi2": sps.chi2(3.0),
        "chi": sps.chi(3.0), "weibull": sps.weibull_min(2.0, scale=1.5),
        "log_normal": sps.lognorm(1.0), "half_normal": sps.halfnorm(scale=2.0),
        "half_cauchy": sps.halfcauchy(0.0, 1.0),
        "truncated_normal": sps.truncnorm(-1.0, 2.0),
        "von_mises": sps.vonmises(2.0),
        "inverse_gaussian": sps.invgauss(0.5, scale=2.0), "moyal": sps.moyal(),
        "poisson": sps.poisson(3.5), "geometric": sps.geom(0.3, loc=-1),
        "binomial": sps.binom(10, 0.4), "negative_binomial": sps.nbinom(5, 0.6),
        "skellam": sps.skellam(2.0, 3.0), "zipf": sps.zipf(2.5),
        "non_central_chi2": sps.ncx2(3.0, 2.0),
        "beta_binomial": sps.betabinom(10, 2.0, 3.0),
    }
    if name in frozen:
        return frozen[name].cdf
    closed = {
        "kumaraswamy": lambda v: 1 - (1 - v ** 2) ** 3,
        "exp_gamma": lambda v: sps.gamma(2.0).cdf(np.exp(v)),
        "exp_inverse_gamma": lambda v: sps.gamma(2.0).sf(np.exp(-v)),
        "double_sided_maxwell": lambda v: 0.5 + 0.5 * np.sign(v)
        * sps.maxwell.cdf(abs(v)),
        "truncated_cauchy": lambda v: (np.arctan(v) + np.arctan(2.0))
        / (2 * np.arctan(2.0)),
        "bernoulli": lambda v: 0.7 if v < 1 else 1.0,
        "flip": lambda v: 0.7 if v < 1 else 1.0,
        "categorical": lambda v: [0.1, 0.3, 1.0][int(v)],
        "half_student_t": lambda v: 2 * sps.t(3.0).cdf(v) - 1,
        "logit_normal": lambda v: sps.norm.cdf(np.log(v / (1 - v))),
        "lambert_w_normal": lambda v: sps.norm.cdf(np.sign(v) * np.sqrt(
            np.real(ssp.lambertw(0.3 * v * v)) / 0.3)),
    }
    return closed.get(name)


def _dist_mean(name: str):
    """``(mean vector, its per-draw sd)`` of a vector-valued row of
    :data:`DIST_TABLE` (and of beta_quotient), in closed form."""
    import numpy as np

    if name == "dirichlet":
        a = np.array([2.0, 3.0, 4.0])
        m = a / a.sum()
        return m, np.sqrt(m * (1 - m) / (a.sum() + 1))
    if name == "mv_normal_diag":
        return np.array([0.0, 1.0]), np.array([1.0, 2.0])
    if name == "mv_normal":
        return np.array([0.0, 1.0]), np.sqrt([2.0, 1.0])
    if name == "multinomial":
        p = np.array([0.2, 0.3, 0.5])
        return 10 * p, np.sqrt(10 * p * (1 - p))
    if name == "dirichlet_multinomial":
        a = np.array([1.0, 2.0, 3.0])
        p, a0 = a / a.sum(), a.sum()
        return 10 * p, np.sqrt(10 * p * (1 - p) * (10 + a0) / (1 + a0))
    if name == "beta_quotient":
        # E[X] E[1/Y] with X ~ Beta(2, 3), Y ~ Beta(4, 3): 0.4 * 2, and
        # E[X²] E[1/Y²] = 0.2 * 5.
        return np.array([0.8]), np.array([math.sqrt(1.0 - 0.64)])
    if name in ("power_spherical", "von_mises_fisher"):
        # The mean direction times E[mu.x]; the sd is not closed, so the
        # draws' own is used (None).
        mu, conc = DIST_TABLE[name][0]
        et = (2 * (1.0 + conc) / (2.0 + conc) - 1 if name == "power_spherical"
              else 1 / math.tanh(conc) - 1 / conc)
        return et * np.asarray(mu), None
    return None


def _dist_args(args, device, n=None):
    """A row's parameters on ``device``: numbers stay numbers, lists
    become f32 tensors, lifted (zero strides) to ``n`` keys if given."""
    import torch

    out = []
    for a in args:
        if isinstance(a, list):
            t = torch.tensor(a, dtype=torch.float32, device=device)
            out.append(t.expand((n,) + tuple(t.shape)) if n else t)
        else:
            out.append(a)
    return out


def _rel_err(a, b) -> float:
    """Largest ``|a - b| / max(1, |b|)`` where b is finite (float64);
    inf if the two disagree on which entries are finite."""
    import torch

    a, b = a.double().cpu(), b.double().cpu()
    fin = torch.isfinite(b)
    if not torch.equal(torch.isfinite(a), fin) or not torch.equal(
            torch.isneginf(a), torch.isneginf(b)):
        return math.inf
    if not bool(fin.any()):
        return 0.0
    return float(((a - b).abs() / b.abs().clamp(min=1.0))[fin].max())


def _sync_wall(fn) -> tuple:
    """``(result, wall seconds)`` of one synchronized call."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def distributions_phase(dev, card: str, zero_counts, counts) -> dict:
    """Phase 29: the distribution library on the card (29a), the
    gamma-Poisson SIR at K = 2^20 (29b) and NUTS on the scale-free
    regression at 2048 x (200 + 100) (29c)."""
    import numpy as np
    import torch

    import genjax_torch as g
    from genjax_torch import entry as E
    from genjax_torch.core import random
    from genjax_torch.inference import ess_autocorr, split_rhat
    from genjax_torch.inference.requests import nuts as N
    from genjax_torch.inference.transforms import resolve_transforms

    # -- 29a: every distribution ----------------------------------------
    t_phase = time.perf_counter()
    n = DIST_DRAWS
    keys = random.split(random.key(29, device=dev), n)
    ikeys = random.split(random.key(30), DIST_INT_KEYS)
    rows, zero_counts_before = {}, counts()
    for name, (args, values, in_cases) in DIST_TABLE.items():
        row_t0 = time.perf_counter()
        d = getattr(g, name)
        args_dev = _dist_args(args, dev, n)
        x = d.sample(keys, *args_dev)
        random.loops.reset()
        x, t_sample = _sync_wall(lambda: d.sample(keys, *args_dev))
        trips, syncs = random.loops.trips, random.loops.host_syncs
        check(x.device == torch.device(dev) and x.shape[0] == n,
              f"29a {name}: draws of shape {tuple(x.shape)} on {x.device}")
        xf = x.double()
        # Moyal's inverse CDF is -inf at u = 0 (erfinv(1) = inf), one
        # draw in 2^23, as the JAX package's at the same key: a draw that
        # is not finite must sit at such a uniform.
        bad = ~torch.isfinite(xf)
        if name == "moyal":
            bad = bad & (random.uniform(keys, ()) != 0)
        n_inf = int((~torch.isfinite(xf)).sum())
        check(not bool(bad.any()), f"29a {name}: a draw not finite")
        # The support's closure: f32 rounding puts a draw on the edge now
        # and then, where the JAX package's sampler puts it at the same
        # key (exponential's -log1p(-u) is 0 at u = 0, one draw in 2^23);
        # such draws are counted and printed.
        spec = d.get_support(*args)
        edge = 0
        if spec == "positive":
            inside = bool((xf >= 0).all())
            edge = int((xf == 0).sum())
        elif spec == "unit_interval":
            inside = bool(((xf >= 0) & (xf <= 1)).all())
            edge = int(((xf == 0) | (xf == 1)).sum())
        elif spec == "simplex":
            inside = bool((xf >= 0).all()) and float(
                (xf.sum(-1) - 1).abs().max()) <= 1e-5
        elif isinstance(spec, tuple):
            inside = bool(((xf >= spec[0]) & (xf <= spec[1])).all())
            edge = int(((xf == spec[0]) | (xf == spec[1])).sum())
        else:
            inside = True
        if name in ("power_spherical", "von_mises_fisher"):
            inside = float((xf.norm(dim=-1) - 1).abs().max()) <= 1e-5
        check(inside, f"29a {name}: a draw outside its support {spec}")
        # The law: the empirical CDF at the test values (5 binomial se)
        # or the mean vector (5 se).
        cdf = _dist_cdf(name)
        worst = 0.0
        if cdf is not None and x.ndim == 1:
            for v in (values if values is not None else []):
                f = float(cdf(float(v)))
                emp = float((xf <= v).double().mean())
                se = math.sqrt(f * (1 - f) / n)
                z = abs(emp - f) / se if se > 0 else (0.0 if emp == f
                                                      else math.inf)
                worst = max(worst, z)
                check(abs(emp - f) <= 5 * se,
                      f"29a {name}: empirical CDF at {v} {emp} vs {f} "
                      f"(5 se = {5 * se:.3g})")
        else:
            mean, sd = _dist_mean(name)
            got = xf.reshape(n, -1).mean(0).cpu().numpy()
            sd = sd if sd is not None else xf.reshape(n, -1).std(
                0).cpu().numpy()
            z = np.abs(got - mean) / (np.asarray(sd) / math.sqrt(n))
            worst = float(z.max())
            check(worst <= 5, f"29a {name}: mean {got} vs {mean} ({worst:.2f}"
                  " se)")
        # The card's log-density against the CPU port's at the CASES
        # values, else at the first 16 draws.
        vals = (torch.tensor(values, dtype=torch.float32) if in_cases
                else x[:16].cpu())
        lp_dev = d.logpdf(vals.to(dev), *_dist_args(args, dev))
        lp_cpu = d.logpdf(vals, *_dist_args(args, "cpu"))
        lp_err = _rel_err(lp_dev, lp_cpu)
        tol = 1e-4 if name in DIST_SPECIAL else 1e-5
        check(lp_err <= tol, f"29a {name}: card log-density vs CPU "
              f"{lp_err:.3g} (bound {tol})")
        _, t_lp = _sync_wall(lambda: d.logpdf(x, *args_dev))
        _, t_lp = _sync_wall(lambda: d.logpdf(x, *args_dev))
        row = {"args": [a if not isinstance(a, list) else list(a)
                        for a in args],
               "values_from": "CASES" if in_cases else "first 16 draws",
               "dtype": str(x.dtype).replace("torch.", ""),
               "sample_draws_per_s": n / t_sample,
               "logpdf_per_s": n / t_lp, "sample_ms": t_sample * 1e3,
               "logpdf_ms": t_lp * 1e3, "loop_trips": trips,
               "host_syncs_per_draw": syncs / n, "host_syncs": syncs,
               "draws_on_support_edge": edge, "draws_not_finite": n_inf,
               "logpdf_card_vs_cpu": lp_err, "worst_se": worst}
        if name in ("poisson", "binomial", "multinomial"):
            a_cpu = _dist_args(args, "cpu", DIST_INT_KEYS)
            a_dev = _dist_args(args, dev, DIST_INT_KEYS)
            on_cpu = d.sample(ikeys, *a_cpu)
            on_dev = d.sample(ikeys.to(dev), *a_dev).cpu()
            same = (on_cpu == on_dev)
            same = same.reshape(DIST_INT_KEYS, -1).all(-1)
            agree = float(same.double().mean())
            row["card_vs_cpu_integers_agree"] = agree
            check(agree >= DIST_INT_AGREE, f"29a {name}: card and CPU "
                  f"integers agree on {agree} of {DIST_INT_KEYS} keys")
        row["row_s"] = time.perf_counter() - row_t0
        rows[name] = row
        print(f"[29a {name}] {card}: {row['row_s']:.2f} s for the row; "
              f"{row['dtype']} draws, sample "
              f"{row['sample_draws_per_s']:.6g} draws/s ({t_sample * 1e3:.3f} "
              f"ms for 2^20, {trips} loop trips, {syncs} host syncs, "
              f"{syncs / n:.3g} a draw), logpdf {row['logpdf_per_s']:.6g}/s; "
              f"{edge} on the support's edge, {n_inf} not finite; law "
              f"within {worst:.2f} se; "
              f"log-density card vs CPU "
              f"{lp_err:.3g} at {row['values_from']}"
              + (f"; integers card = CPU on "
                 f"{row['card_vs_cpu_integers_agree']:.6f} of 2^16 keys"
                 if "card_vs_cpu_integers_agree" in row else ""), flush=True)
    check(counts() == zero_counts_before,
          f"29a launched a kernel: {counts()} after {zero_counts_before}")
    t_29a = time.perf_counter() - t_phase
    print(f"[29a] {card}: 48 distributions in {t_29a:.1f} s", flush=True)

    # -- 29b: the gamma-Poisson SIR at 2^20 -------------------------------
    run = E.build_gamma_poisson_sir(GP_SIZE, device=dev)
    zero_counts()
    out, first = _sync_wall(lambda: run(random.key(1, device=dev)))
    gp_launches = counts()
    check(gp_launches["cdf_counts"] == 1 and sum(gp_launches.values()) == 1,
          f"29b: launches {gp_launches}, want one cdf_counts")
    mean, log_z = float(out["mean"]), float(out["log_z"])
    res = out["resampled"].get_particles().get_choices()["lam"]
    check(tuple(res.shape) == (GP_SIZE,) and bool((res > 0).all()),
          "29b: the resampled particles")
    check(abs(mean - E.GAMMA_POISSON_MEAN) <= GP_MEAN_BOUND,
          f"29b: posterior mean {mean} vs {E.GAMMA_POISSON_MEAN}")
    check(abs(log_z - E.GAMMA_POISSON_LOG_Z) <= GP_LOGZ_BOUND,
          f"29b: log Z {log_z} vs {E.GAMMA_POISSON_LOG_Z}")
    del out, res
    walls, wall = _median_wall(first, lambda i: run(random.key(2 + i,
                                                               device=dev)))
    p_wall, busy, per_kernel, ops, _ = profiled(
        lambda: run(random.key(9, device=dev)), 1)
    sir = {"particles": GP_SIZE, "mean": mean,
           "exact_mean": E.GAMMA_POISSON_MEAN, "log_z": log_z,
           "exact_log_z": E.GAMMA_POISSON_LOG_Z, "launches": gp_launches,
           "wall_ms": [w * 1e3 for w in walls], "median_wall_ms": wall * 1e3,
           "particles_per_s": GP_SIZE / wall, "profiled_wall_ms": p_wall,
           "device_busy_ms": busy, "idle_share": 1.0 - busy / p_wall,
           "device_ops": ops}
    print(f"[29b gamma-poisson SIR] {card}: K = 2^20: posterior mean "
          f"{mean:.6f} vs 3.5 (bound {GP_MEAN_BOUND}), log Z {log_z:.6f} vs "
          f"{E.GAMMA_POISSON_LOG_Z:.6f} (bound {GP_LOGZ_BOUND}); launches "
          f"{gp_launches}; wall {[round(w * 1e3, 3) for w in walls]} ms "
          f"(median {wall * 1e3:.3f} ms, {GP_SIZE / wall:.6g} particles/s); "
          f"profiled run {p_wall:.3f} ms, device busy {busy:.3f} ms, idle "
          f"share {sir['idle_share']:.4f}, {ops:.0f} device ops; "
          f"{top(per_kernel, 4)}", flush=True)

    # -- 29c: NUTS with the noise scale free ------------------------------
    n_chains, num_warmup, num_samples, depth = SCALE_NUTS_SIZE
    run, target = E.build_scale_nuts(n_chains, num_warmup, num_samples, depth,
                                     device=dev)
    transforms = resolve_transforms(target, "auto")
    check(transforms == {"sigma": "positive"},
          f"29c: infer_transforms gave {transforms}")
    exact = E.scale_nuts_exact(*target.args, target.constraint["ys"])
    zero_counts()
    N.nuts_kernel.host_syncs = 0
    (chms, infos), wall = _sync_wall(lambda: run(random.key(0, device=dev)))
    syncs, launches = N.nuts_kernel.host_syncs, counts()
    _no_kernel(launches, "29c")
    sites = {}
    for addr in ("sigma", "slope", "icept"):
        draws = chms[addr]
        check(tuple(draws.shape) == (n_chains, num_samples)
              and bool(torch.isfinite(draws).all()),
              f"29c: {addr} draws of shape {tuple(draws.shape)}")
        rhat, ess = float(split_rhat(draws)), float(ess_autocorr(draws))
        m, sd = float(draws.double().mean()), float(draws.double().std())
        mcse = sd / math.sqrt(ess)
        sites[addr] = {"mean": m, "exact_mean": exact[addr], "sd": sd,
                       "rhat": rhat, "ess": ess, "mcse": mcse}
        check(rhat <= 1.01, f"29c: {addr} split R-hat {rhat}")
        check(abs(m - exact[addr]) <= 4 * mcse,
              f"29c: {addr} mean {m} vs exact {exact[addr]} (4 MCSE = "
              f"{4 * mcse})")
    check(bool((chms["sigma"] > 0).all()), "29c: a sigma draw <= 0")
    transitions = num_warmup + num_samples
    short, _ = E.build_scale_nuts(n_chains, 2, 2, depth, device=dev)
    p_wall, busy, per_kernel, ops, _ = profiled(
        lambda: short(random.key(1, device=dev)), 1)
    nuts = {"chains": n_chains, "points": E.REGRESSION_POINTS,
            "max_depth": depth, "num_warmup": num_warmup,
            "num_samples": num_samples, "init_draws": E.SCALE_INIT_DRAWS,
            "transforms": transforms, "wall_s": wall,
            "eff_samples_per_s": sites["slope"]["ess"] / wall,
            "ms_per_transition": wall / transitions * 1e3,
            "syncs_per_transition": syncs / transitions,
            "mean_tree_leapfrogs": float(infos.num_steps.double().mean()),
            "sites": sites, "profiled_transitions": 4,
            "profiled_wall_ms": p_wall, "device_busy_ms": busy,
            "idle_share": 1.0 - busy / p_wall,
            "device_ops_per_transition": ops / 4}
    print(f"[29c scale NUTS] {card}: {n_chains} chains x 128 points, "
          f"max_depth {depth}, {num_warmup} + {num_samples}, sigma ~ "
          f"half_normal(1) by {transforms}: wall {wall:.2f} s, "
          f"{nuts['eff_samples_per_s']:.6g} eff-samples/s (slope), "
          f"{nuts['ms_per_transition']:.3f} ms and "
          f"{nuts['syncs_per_transition']:.2f} host syncs a transition, "
          f"{nuts['mean_tree_leapfrogs']:.3f} leapfrogs a tree; "
          + "; ".join(f"{a}: mean {v['mean']:.6f} vs {v['exact_mean']:.6f} "
                      f"(4 MCSE {4 * v['mcse']:.3g}), R-hat {v['rhat']:.5f}, "
                      f"ESS {v['ess']:.6g}" for a, v in sites.items())
          + f"; profiled 2 + 2 transitions: wall {p_wall:.1f} ms, device "
          f"busy {busy:.2f} ms, idle share {nuts['idle_share']:.4f}, "
          f"{ops / 4:.0f} device ops a transition; {top(per_kernel, 4)}",
          flush=True)
    t_all = time.perf_counter() - t_phase
    print(f"[29] {card}: phase 29 in {t_all:.1f} s (29a {t_29a:.1f} s)",
          flush=True)
    return {"distributions": rows, "distributions_s": t_29a,
            "phase_29_s": t_all, "gamma_poisson_sir": sir,
            "scale_nuts": nuts}


# -- 30. per-execution HMM problems, per-execution edits, fine edits -----

#: 30a: problems, states, steps (the JAX package's Pallas dispatch needs
#: S a multiple of 128); FFBS: problems, draws each, draws a call.
HMM_BATCH = (2048, 128, 64)
FFBS_SIZE = (8, 1 << 14, 1 << 11)
#: 30b: phase 16's width (states, steps, executions) and the CPU slice.
EDITS_SIZE = (64, 64, 1 << 19, 1 << 10)
#: 30b's Vmap part runs on the first this many executions.
VMAP_EXECUTIONS = 1 << 16
#: 30c: chains, sites; the 2-site model's chains and sweeps.
SWEEP_SIZE = (1 << 19, 32, 1 << 19, 200)
#: 30d: config 6 (particles, rungs, moves) timed with and without checks.
CHECKS_SIZE = (1 << 19, 16, 2)


def _smoothing64(config, obs):
    """Exact smoothing marginals ``P(z_t = s | x)`` of each problem by
    forward-backward in float64: ``(P, T, S)``."""
    import torch

    prior, trans, emit = (v.double() for v in (
        config.prior_logits, config.transition_logits,
        config.observation_logits))
    p, t_len = obs.shape
    ll = torch.gather(emit, 2, obs[:, None, :].expand(
        p, emit.shape[1], t_len)).transpose(1, 2)              # (P, T, S)
    la = [prior + ll[:, 0]]
    for t in range(1, t_len):
        la.append(torch.logsumexp(la[-1][:, :, None] + trans, 1) + ll[:, t])
    lb = [torch.zeros_like(la[0])]
    for t in range(t_len - 2, -1, -1):
        lb.append(torch.logsumexp(trans + (ll[:, t + 1] + lb[-1])[:, None, :],
                                  2))
    post = torch.stack(la, 1) + torch.stack(lb[::-1], 1)
    return torch.softmax(post, -1)


def hmm_batch_phase(dev, card: str, zero_counts, counts) -> dict:
    """Phase 30a: B exact-HMM problems from sample_problem on a key batch
    (each its own observations; then each its own transition variance)
    through DiscreteHMM's parallel filter, one log-matmul launch per scan
    level over every problem's pairs."""
    import torch

    from genjax_torch import entry as E
    from genjax_torch.core import random
    from genjax_torch.core.scan import count_combines
    from genjax_torch.lang.distributions.discrete_hmm import (
        DiscreteHMM,
        DiscreteHMMConfiguration,
        forward_filter,
        forward_filter_parallel,
        joint_logpdf,
    )
    from genjax_torch.ops import logmatmul as lm

    b, s, t_len = HMM_BATCH
    combines = count_combines(t_len - 1)
    hmm = DiscreteHMM(use_parallel_filter=True)
    out = {}
    for name, per_config in (("observations", False),
                             ("observations_and_config", True)):
        simulate, config, problems = E.build_hmm_batch(
            b, s, t_len, per_execution_config=per_config, device=dev)
        obs = problems.observations
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        tr = simulate(random.key(41, device=dev))
        torch.cuda.synchronize()
        sim_launches = counts()
        peak = torch.cuda.max_memory_allocated() / 1e9
        check(sim_launches["log_matmul"] == combines
              and sim_launches["cdf_counts"] == sim_launches["fused_step"]
              == sim_launches["expand_adaptive"] == 0,
              f"30a {name}: simulate launched {sim_launches}, want "
              f"{combines} log_matmul launches")
        z = tr.get_retval()
        check(tuple(z.shape) == (b, t_len) and int(z.min()) >= 0
              and int(z.max()) < s, f"30a {name}: paths {tuple(z.shape)}")
        zero_counts()
        score, _ = hmm.assess(tr.get_choices(), (config, obs), batch=(b,))
        torch.cuda.synchronize()
        check(counts()["log_matmul"] == combines,
              f"30a {name}: assess launched {counts()}")
        as_err = _close(score, tr.get_score())
        check(as_err <= 1.0, f"30a {name}: assess vs simulate {as_err}")
        # The parallel filter against float64 sequential filtering.
        a_par, m_par = forward_filter_parallel(config, obs)
        cfg64 = DiscreteHMMConfiguration(
            config.prior_logits.double(), config.transition_logits.double(),
            config.observation_logits.double())
        a64, m64 = forward_filter(cfg64, obs)
        m_rel = float(((m_par.double() - m64).abs() / m64.abs()).max())
        check(m_rel <= 1e-5, f"30a {name}: log marginal rel {m_rel}")
        live = (a64 - torch.logsumexp(a64, -1, keepdim=True)) > -80.0
        d_live = (a_par.double() - a64).abs()[live]
        a_rel = float((d_live / a64.abs()[live].clamp_min(1.0)).max())
        check(a_rel <= 2e-5, f"30a {name}: alphas rel {a_rel}")
        exact = joint_logpdf(cfg64, z, obs) - m64
        sc_err = _close(tr.get_score(), exact)
        check(sc_err <= 1.0, f"30a {name}: score vs exact {sc_err}")
        del a_par, a64, live, d_live, tr, score
        walls, med = _median_wall(None, lambda i: simulate(
            random.key(42 + i, device=dev)))
        wall, busy, ops = device_busy(lambda: simulate(
            random.key(45, device=dev)))
        out[name] = {"launches": sim_launches, "log_marginal_rel": m_rel,
                     "alpha_rel": a_rel, "assess_err": as_err,
                     "score_err": sc_err, "wall_ms": [w * 1e3 for w in walls],
                     "median_wall_ms": med * 1e3, "device_busy_ms": busy,
                     "idle_share": 1.0 - busy / wall, "device_ops": ops,
                     "peak_gb": peak, "problems_per_s": b / med}
        print(f"[30a hmm batch {name}] {card}: {b} problems x S={s} x "
              f"T={t_len}: simulate launches {sim_launches} (= "
              f"{combines} combines a filter), assess vs simulate "
              f"{as_err:.3g} of its bound; log marginal vs float64 "
              f"sequential max rel {m_rel:.3g} (bound 1e-5), live alphas "
              f"max rel {a_rel:.3g} (bound 2e-5), score vs float64 exact "
              f"{sc_err:.3g} of its bound; wall "
              f"{[round(w * 1e3, 2) for w in walls]} ms (median "
              f"{med * 1e3:.2f}), {b / med:.4g} problems/s; "
              f"profiled run {wall:.2f} ms, device busy {busy:.2f} ms, idle "
              f"share {1.0 - busy / wall:.4f}, {ops} device ops; peak device "
              f"memory {peak:.2f} GB", flush=True)
        if per_config:
            # FFBS on a few problems: draws' state frequencies against
            # float64 forward-backward, 5 standard errors.
            n_prob, n_draws, chunk = FFBS_SIZE
            sub = DiscreteHMMConfiguration(
                config.prior_logits[:n_prob],
                config.transition_logits[:n_prob],
                config.observation_logits[:n_prob])
            lifted = DiscreteHMMConfiguration(
                sub.prior_logits[:, None].expand(n_prob, chunk, s),
                sub.transition_logits[:, None].expand(n_prob, chunk, s, s),
                sub.observation_logits[:, None].expand(n_prob, chunk, s, s))
            o_sub = obs[:n_prob, None].expand(n_prob, chunk, t_len)
            hist = torch.zeros(n_prob, t_len, s, dtype=torch.float64,
                               device=dev)
            for c in range(n_draws // chunk):
                keys = random.split(random.key(1000 + c, device=dev),
                                    n_prob * chunk).reshape(n_prob, chunk, 2)
                _, zs = hmm.random_weighted(keys, lifted, o_sub)
                hist += torch.nn.functional.one_hot(zs, s).double().sum(1)
            freq = hist / n_draws
            exact_m = _smoothing64(sub, obs[:n_prob])
            # The normal approximation holds where a cell expects 10 draws
            # or more either way: 5 se there.
            held = ((exact_m * n_draws >= 10)
                    & ((1 - exact_m) * n_draws >= 10))
            se = torch.sqrt(exact_m * (1 - exact_m) / n_draws)
            z_abs = ((freq - exact_m).abs() / se)[held]
            worst = float(z_abs.max())
            check(worst <= 5.0, f"30a FFBS: smoothing marginals at {worst} se")
            # The other cells by exact binomial tails, a problem-step at a
            # time: the summed count of the cells that expect < 10 draws,
            # and that of the cells that expect < 10 misses, each against
            # its summed probability, at the 5-se level. A draw in a cell
            # of probability 0 fails on its own.
            low = (~held) & (exact_m * n_draws < 10)
            high = (~held) & ~low
            counts_ = hist
            groups = torch.stack([(counts_ * low).sum(-1),
                                  (counts_ * high).sum(-1)])
            probs = torch.stack([(exact_m * low).sum(-1),
                                 (exact_m * high).sum(-1)])
            tails = binomial_two_sided_p(groups, n_draws, probs)
            rare_p = float(tails.min())
            impossible = int(hist[exact_m == 0].sum())
            check(impossible == 0,
                  f"30a FFBS: {impossible} draws in states of probability 0")
            check(rare_p >= FIVE_SE_P,
                  f"30a FFBS: the rarer cells' counts at a two-sided tail of "
                  f"{rare_p} (bound {FIVE_SE_P:.3g})")
            tv = float(0.5 * (freq - exact_m).abs().sum(-1).max())
            out[name]["ffbs_worst_se"] = worst
            out[name]["ffbs_rare_min_p"] = rare_p
            out[name]["ffbs_zero_cells"] = int((exact_m == 0).sum())
            out[name]["ffbs_max_tv"] = tv
            print(f"[30a FFBS] {card}: {n_prob} problems x {n_draws} draws "
                  f"(parallel filter and sampler, {chunk} draws a call): "
                  f"state frequencies vs float64 forward-backward, worst "
                  f"{worst:.3f} se over the {int(held.sum())} cells that "
                  f"expect >= 10 draws either way (bound 5); the other "
                  f"{int((low | high).sum())} cells' summed counts a "
                  f"problem-step, {int(low.sum())} rare and {int(high.sum())}"
                  f" near-certain, by exact binomial tails: smallest "
                  f"two-sided tail {rare_p:.3g} (bound {FIVE_SE_P:.3g}); "
                  f"{impossible} draws in the {int((exact_m == 0).sum())} "
                  f"cells of probability 0; largest total variation a step "
                  f"{tv:.4g}", flush=True)
        if not per_config:
            # The kernel at the path's first-level shape: (B * pairs, S, S).
            ms = (config.transition_logits[:, None]
                  + torch.gather(config.observation_logits, 2,
                                 obs[:, None, :].expand(b, s, t_len))
                  .transpose(1, 2)[:, 1:, None, :])
            xa = ms[:, 0:-1:2].reshape(-1, s, s)
            yb = ms[:, 1::2].reshape(-1, s, s)
            del ms
            bb = xa.shape[0]
            t_lm = cuda_ms(lambda: lm.log_matmul(xa, yb), 5)
            t_plain = cuda_ms(lambda: lm.log_matmul_plain(xa, yb), 3)
            t_bmm = cuda_ms(lambda: torch.bmm(xa, yb), 5)
            _, dev_lm, per_kernel, _, _ = profiled(
                lambda: lm.log_matmul(xa, yb), 3)
            # One launch over every pair, held against the plain version
            # on all of them (in chunks, to keep its temporaries small),
            # at phase 8's tolerance.
            got = lm.log_matmul(xa, yb)
            err, chunk = 0.0, 8192
            for i in range(0, bb, chunk):
                want = lm.log_matmul_plain(xa[i:i + chunk], yb[i:i + chunk])
                diff = (got[i:i + chunk] - want).abs()
                check(bool((diff <= 1e-5 + 1e-5 * want.abs()).all()),
                      f"30a log_matmul ({bb}, {s}, {s}): pairs {i}-"
                      f"{i + chunk}: max |kernel - plain| "
                      f"{float(diff.max())}")
                err = max(err, float(diff.max()))
            del got, want, diff
            flop = 2.0 * bb * s ** 3
            b_ms, b_by, f32_ms = lm_bound(bb, s)
            bytes_ms = 12.0 * bb * s ** 2 / HBM_BYTES_PER_S * 1e3
            tc_ms = 3.0 * flop / TF32_OPS_PER_S * 1e3
            scratch_gb = lm.build().log_matmul_scratch_floats(
                bb, s, s, s) * 4 / 1e9
            out["kernel_row"] = {
                "ms": t_lm, "plain_ms": t_plain, "bmm_ms": t_bmm,
                "device_ms": dev_lm, "bound_ms": b_ms, "bound_by": b_by,
                "tc_bound_ms": tc_ms, "f32_bound_ms": f32_ms,
                "batch": bb, "max_abs_err": err,
                "scratch_gb": scratch_gb, "device_by_kernel": per_kernel}
            print(f"[30a log_matmul B={bb} S={s}] {card}: kernel {t_lm:.4f} "
                  f"ms by CUDA events (device {dev_lm} ms: "
                  f"{top(per_kernel, 3)}), plain {t_plain:.4f} ms, torch.bmm "
                  f"(product alone) {t_bmm:.4f} ms; bound {b_ms:.4f} ms "
                  f"({b_by}: {12.0 * bb * s ** 2:.4g} B at 3.35 TB/s "
                  f"{bytes_ms:.4f} ms, split TF32 3 x {flop:.4g} flop at 495 "
                  f"TFLOP/s {tc_ms:.4f} ms; f32 FFMA {f32_ms:.4f} ms); kernel "
                  f"at {b_ms / t_lm:.3f} of the bound; kernel / bmm "
                  f"{t_lm / t_bmm:.3f}; scratch {scratch_gb:.2f} GB; max "
                  f"|kernel - plain| {err:.3g} over all {bb} pairs (tol 1e-5 "
                  f"+ 1e-5 |plain|)", flush=True)
            del xa, yb
    return out


def _hmm_edit_run(model, constraint, keys, ekeys, t_idx, n_states,
                  obs_logits):
    """30b's edits of hmm_model on ``keys``: a per-execution IndexRequest
    (Update, then Regenerate) on the chain, its backward request, and a
    Vmap Update whose constraint names lanes by an index array."""
    import torch

    import genjax_torch as g
    from genjax_torch.gfi.choice_map import Indexed

    tr, _ = model.generate(keys, constraint, ())
    z_old = tr.get_choices()["chain", :, "z"]
    z_t = torch.take_along_dim(z_old, t_idx[:, None], 1)[:, 0]
    new_z = (z_t + 1) % n_states
    out = {}
    for name, sub in (("update", g.Update(g.C["z"].set(new_z))),
                      ("regenerate", g.Regenerate(g.Selection.at["z"]))):
        req = g.StaticRequest({"chain": g.IndexRequest(t_idx, sub)})
        new, w, _, bwd = tr.edit(ekeys, req)
        old_c, new_c = tr.get_subtrace("chain"), new.get_subtrace("chain")
        scale = sum((new_c.inner.get_subtrace(a).get_score().abs()
                     + old_c.inner.get_subtrace(a).get_score().abs()).sum(-1)
                    for a in ("z", "x"))
        out[name] = (w, new.get_choices()["chain", :, "z"], scale)
        del old_c, new_c
        if name == "update":
            back, wb, _, _ = new.edit(ekeys, bwd)
            out["back"] = (back.get_choices()["chain", :, "z"], z_old, wb, w)
            del back
        # At 2^19 a trace holds about 20 GB: keep one edited trace at a time.
        del new
    del tr
    out["z_old"] = z_old
    # A Vmap of the emission over the path's lanes, updated at lanes
    # named by an index array (a duplicate: the first entry wins), on the
    # first VMAP_EXECUTIONS executions: its categorical draws' Gumbel noise
    # (executions x lanes x states words) would not fit beside the rest at
    # 2^19.
    @g.gen
    def emit(z):
        return g.categorical(obs_logits[z]) @ "x"

    vm = emit.vmap()
    m = min(keys.shape[0], VMAP_EXECUTIONS)
    keys, ekeys, z_old = keys[:m], ekeys[:m], z_old[:m]
    vtr = vm.simulate(keys, (z_old,))
    n_lanes = z_old.shape[1]
    picked = [n_lanes // 12, n_lanes // 4, n_lanes // 4, 2 * n_lanes // 3]
    lanes = torch.tensor(picked, device=keys.device)
    vals = torch.stack([(z_old[:, i] * 7 + 3) % n_states for i in picked], 1)
    # Per-execution values: the lane axis follows the batch (rank 1).
    chm = Indexed(g.C["x"].set(vals), lanes, None, 1)
    vnew, vw, _, _ = vtr.edit(ekeys, g.Update(chm))
    out["vmap"] = (vw, vnew.get_choices()[:, "x"],
                   (vnew.get_score().abs() + vtr.get_score().abs()))
    return out


def lane_edits_phase(dev, card: str, zero_counts, counts) -> dict:
    """Phase 30b: per-execution edits of hmm_model at phase 16's width,
    against the CPU port on a slice of executions from the same key
    data."""
    import torch

    from genjax_torch import entry as E
    from genjax_torch.core import random

    n_states, n_steps, n, n_cpu = EDITS_SIZE
    _, model, constraint, problem = E.build_hmm_model(n_states, n_steps, n,
                                                      device=dev)
    keys = random.split(random.key(51, device=dev), n)
    ekeys = random.split(random.key(52, device=dev), n)
    t_idx = torch.randint(0, n_steps - 1, (n,), device=dev,
                          generator=torch.Generator(dev).manual_seed(53))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t0 = time.perf_counter()
    card_out = _hmm_edit_run(model, constraint, keys, ekeys, t_idx,
                             n_states, problem.config.observation_logits)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    _no_kernel(counts(), "30b")
    peak = torch.cuda.max_memory_allocated() / 1e9
    z_back, z_old, wb, w = card_out.pop("back")
    check(bool(torch.equal(z_back, z_old)),
          "30b: the backward request did not restore the path")
    back_err = _close(wb, -w)
    check(back_err <= 1.0, f"30b: backward weight {back_err}")
    _, model_c, constraint_c, problem_c = E.build_hmm_model(
        n_states, n_steps, n_cpu, device="cpu")
    t0 = time.perf_counter()
    cpu_out = _hmm_edit_run(model_c, constraint_c, keys[:n_cpu].cpu(),
                            ekeys[:n_cpu].cpu(), t_idx[:n_cpu].cpu(),
                            n_states, problem_c.config.observation_logits)
    cpu_s = time.perf_counter() - t0
    cpu_out.pop("back")
    # A categorical draw may flip between the devices where two Gumbel
    # maxima lie within an ulp: such rows (expected about 1e-6 a draw) are
    # counted and left out of the weight comparison.
    same = (card_out["z_old"][:n_cpu].cpu() == cpu_out["z_old"]).all(-1)
    for name in ("update", "regenerate", "vmap"):
        same &= (card_out[name][1][:n_cpu].cpu() == cpu_out[name][1]).all(-1)
    flipped = int((~same).sum())
    check(flipped <= max(1, n_cpu // 1000),
          f"30b: {flipped} of {n_cpu} executions drew other values on the "
          "card")
    worst = {}
    for name in ("update", "regenerate", "vmap"):
        (w_g, _, _), (w_c, _, sc) = card_out[name], cpu_out[name]
        worst[name + " w"] = _close(w_g[:n_cpu].cpu()[same], w_c[same],
                                    sc[same])
    bad = {k: v for k, v in worst.items() if v > 1.0}
    check(not bad, f"30b: card vs CPU beyond the bound: {bad}")
    moved = float((card_out["regenerate"][1] != z_old).any(1).double().mean())
    print(f"[30b lane edits] {card}: hmm_model {n_states} x {n_steps} x {n} "
          f"({card_s:.2f} s, peak device memory {peak:.1f} GB): "
          f"IndexRequest with t per execution (Update, Regenerate) and a "
          f"Vmap Update at lanes named by an index array with a duplicate; "
          f"card vs CPU on {n_cpu} "
          f"executions ({cpu_s:.2f} s): worst |card - cpu| / bound "
          f"{({k: round(v, 4) for k, v in worst.items()})} (1e-5 (1 + |w|) "
          f"plus 1e-6 of the edited sites' score magnitudes), values equal "
          f"in {n_cpu - flipped} of {n_cpu} executions; "
          f"the backward Update restores the path (weight {back_err:.3g} of "
          f"its bound); Regenerate moved z in {moved:.3f} of the executions",
          flush=True)
    return {"worst": worst, "card_s": card_s, "cpu_s": cpu_s, "peak_gb": peak,
            "backward_err": back_err}


def fine_edits_phase(dev, card: str, zero_counts, counts) -> dict:
    """Phase 30c: single-site MH sweeps over a 32-site normal chain on the
    fine and the coarse @gen edit paths from the same keys, and the
    2-site chain's posterior mean."""
    import torch

    from genjax_torch import entry as E
    from genjax_torch.core import random
    from genjax_torch.lang import static

    n, sites, n2, sweeps2 = SWEEP_SIZE
    init, sweep = E.build_chain_mh_sweep(n, sites, device=dev)
    res, walls, ops = {}, {}, {}
    tr0 = init(random.key(61, device=dev))
    zero_counts()
    for fine in (True, False):
        static.FINE_GRAINED_EDITS = fine
        try:
            static.edit_stats.reset()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tr, rescored, acc = sweep(random.key(62, device=dev), tr0)
            torch.cuda.synchronize()
            first = time.perf_counter() - t0
            res[fine] = (tr, rescored, acc, static.edit_stats.fine,
                         static.edit_stats.coarse)
            walls[fine] = first
            ops[fine] = sum(ops_by_module(lambda: sweep(
                random.key(62, device=dev), tr0)).values())
        finally:
            static.FINE_GRAINED_EDITS = True
    _no_kernel(counts(), "30c")
    (tr_f, r_f, a_f, nf, _), (tr_c, r_c, a_c, _, nc) = res[True], res[False]
    same = all(bool(torch.equal(tr_f.get_choices()[f"x{i}"],
                                tr_c.get_choices()[f"x{i}"]))
               for i in range(sites))
    check(same and bool(torch.equal(tr_f.get_score(), tr_c.get_score()))
          and bool(torch.equal(a_f, a_c)),
          "30c: the fine and coarse sweeps differ")
    check(nf == sites and nc == sites,
          f"30c: edits served fine {nf}, coarse {nc}")
    check(max(r_f[1:-1]) <= 2, f"30c: fine re-scored {r_f}")
    check(r_c == [sites - i + 1 for i in range(sites)],
          f"30c: coarse re-scored {r_c}")
    acc_rate = float(a_f.double().mean())
    # The 2-site model: E[x0 | y = 1] = 2/3, Var = 1/3.
    init2, sweep2 = E.build_chain_mh_sweep(n2, 2, 0.5, 0.5, 1.0, device=dev)
    tr2 = init2(random.key(64, device=dev))
    t0 = time.perf_counter()
    for i in range(sweeps2):
        tr2, _, _ = sweep2(random.fold_in(random.key(65, device=dev), i), tr2)
    torch.cuda.synchronize()
    s2 = time.perf_counter() - t0
    x0 = tr2.get_choices()["x0"].double()
    se = math.sqrt(1.0 / 3.0 / n2)
    m_err = abs(float(x0.mean()) - 2.0 / 3.0)
    check(m_err <= 4 * se, f"30c: 2-site mean of x0 off by {m_err} ({se} se)")
    print(f"[30c fine edits] {card}: MH sweep over a {sites}-site chain at "
          f"{n} chains: fine and coarse bitwise equal (draws, scores, "
          f"acceptances; acceptance {acc_rate:.4f}); sites re-scored a move "
          f"fine {r_f}, coarse {r_c}; wall a sweep fine "
          f"{walls[True] * 1e3:.1f} ms, coarse {walls[False] * 1e3:.1f} ms "
          f"(one sweep each); PyTorch ops dispatched a sweep fine "
          f"{ops[True]}, "
          f"coarse {ops[False]}; 2-site chain at {n2} x {sweeps2} sweeps "
          f"({s2:.2f} s): mean of x0 {float(x0.mean()):.5f} vs 2/3 "
          f"(|err| {m_err:.3g}, 4 se {4 * se:.3g})", flush=True)
    return {"rescored_fine": r_f, "rescored_coarse": r_c,
            "sweep_ms": {"fine": walls[True] * 1e3,
                         "coarse": walls[False] * 1e3},
            "ops_per_sweep": {"fine": ops[True], "coarse": ops[False]},
            "acceptance": acc_rate, "two_site_mean": float(x0.mean()),
            "two_site_err": m_err, "two_site_s": s2}


def checks_cost_phase(dev, card: str) -> dict:
    """Phase 30d: config 6 with the GFI argument checks on and under
    no_validation(), in turns (on, off, on, off, on, off), the median of
    3 each; the checks a run makes (counted through the module's
    check_args, which every wrapper calls) and one check's host time."""
    import torch

    from genjax_torch import entry as E
    from genjax_torch.core import random, validate
    from genjax_torch.gfi.choice_map import ChoiceMap

    n, temps, moves = CHECKS_SIZE
    run6, _ = E.build_tempered_smc(n, temps, moves, device=dev)
    run6(random.key(71, device=dev))
    walls = {"checks_on": [], "no_validation": []}
    for i in range(6):
        name = "checks_on" if i % 2 == 0 else "no_validation"
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if name == "no_validation":
            with validate.no_validation():
                run6(random.key(72 + i, device=dev))
        else:
            run6(random.key(72 + i, device=dev))
        torch.cuda.synchronize()
        walls[name].append(time.perf_counter() - t0)
    med = {k: sorted(v)[1] for k, v in walls.items()}
    calls = [0]
    orig = validate.check_args

    def counting(args, where):
        calls[0] += 1
        return orig(args, where)

    validate.check_args = counting
    try:
        run6(random.key(79, device=dev))
    finally:
        validate.check_args = orig
    key = random.key(0, device=dev)
    chm = ChoiceMap.empty()
    reps = 100000
    t0 = time.perf_counter()
    for _ in range(reps):
        validate.check_key(key, "w")
        validate.check_args((), "w")
        validate.check_choice_map(chm, "w")
    per_call = (time.perf_counter() - t0) / reps
    est = calls[0] * per_call
    d = med["checks_on"] - med["no_validation"]
    print(f"[30d checks] {card}: config 6 ({n} x {temps} x {moves}) in turns: "
          f"wall with checks {[round(w * 1e3, 2) for w in walls['checks_on']]}"
          f" ms, under no_validation() "
          f"{[round(w * 1e3, 2) for w in walls['no_validation']]} ms (medians "
          f"{med['checks_on'] * 1e3:.2f} / {med['no_validation'] * 1e3:.2f}, "
          f"difference {d * 1e3:.2f} ms); {calls[0]} checked GFI calls a "
          f"run, a call's three checks {per_call * 1e6:.3f} us on the host: "
          f"{est * 1e3:.3f} ms a run, {est / med['checks_on']:.5f} of its "
          f"wall", flush=True)
    return {"wall_ms": {k: [w * 1e3 for w in v] for k, v in walls.items()},
            "checked_calls": calls[0], "check_us": per_call * 1e6,
            "checks_ms_estimate": est * 1e3,
            "checks_share": est / med["checks_on"]}


def batched_slice_phase(dev, card: str, zero_counts, counts) -> dict:
    """Phase 30: 30a-30d."""
    import torch

    t0 = time.perf_counter()
    out = {"hmm_batch": hmm_batch_phase(dev, card, zero_counts, counts)}
    torch.cuda.empty_cache()
    t_a = time.perf_counter()
    out["lane_edits"] = lane_edits_phase(dev, card, zero_counts, counts)
    torch.cuda.empty_cache()
    t_b = time.perf_counter()
    out["fine_edits"] = fine_edits_phase(dev, card, zero_counts, counts)
    t_c = time.perf_counter()
    out["checks"] = checks_cost_phase(dev, card)
    t_d = time.perf_counter()
    out["phase_s"] = {"30a": t_a - t0, "30b": t_b - t_a, "30c": t_c - t_b,
                      "30d": t_d - t_c, "30": t_d - t0}
    print(f"[30] {card}: phase 30 in {t_d - t0:.1f} s (30a {t_a - t0:.1f}, "
          f"30b {t_b - t_a:.1f}, 30c {t_c - t_b:.1f}, 30d {t_d - t_c:.1f})",
          flush=True)
    return out


# -- 31. the sharded samplers, elastic recovery, profiling ---------------------

#: Phase 31's sizes (a CPU rehearsal shrinks them): config 7 sharded
#: (θ-particles, x-particles, steps); PT's timed and profiled step counts
#: (its run is PT_SIZE, phase 27's); config 4 under ``run_elastic``
#: (particles, steps, chunk, checkpoint cadence in chunks, the faulty
#: step). PGAS is PGAS_SHARDED_SIZE.
SHARDED_SIZE = {"smc2": (1024, 1024, 50), "pt_timed": 20, "pt_profiled": 4,
                "elastic": (1 << 20, 32, 4, 2, 13), "trace_pf": (1 << 20, 32)}
#: The group of phase 31: NCCL on the card (a CPU rehearsal takes gloo).
SHARDED_DEVICE = "cuda"
#: 31b and 31c: the cold chain's mean and the smoothing means in MCSE
#: units (phases 27 and 23's bound).
SHARDED_MCSE_BOUND = 4.0
#: The Chrome trace's category of a device kernel (31e).
TRACE_KERNEL_CAT = "kernel"
#: 31d: the elastic run's log Z against ``build_pf``'s on the same key
#: (config 4's driver bound, PERF.md §2).
ELASTIC_LOGZ_BOUND = 0.25


def _same(a, b) -> bool:
    """Bit for bit, NaN where NaN."""
    import torch

    a, b = torch.as_tensor(a), torch.as_tensor(b)
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.is_floating_point():
        return (torch.equal(torch.isnan(a), torch.isnan(b))
                and torch.equal(torch.nan_to_num(a), torch.nan_to_num(b)))
    return torch.equal(a, b)


def sharded_samplers_phase(dev, card: str, zero_counts, counts,
                           refs: dict) -> dict:
    """Phase 31, in an NCCL world of one opened and closed here: SMC² with
    its θ-lanes sharded (31a), PT with its rungs sharded (31b) and PGAS
    with its chains sharded (31c), each bit for bit the unsharded run of
    phases 21, 27 and 23 on the same key (``refs``); config 4 under
    ``run_elastic`` with DCP checkpoints and one injected NaN (31d); a
    ``profile_trace`` of ``build_pf`` (31e)."""
    import os
    import shutil
    import tempfile

    import torch
    import torch.distributed as dist

    from genjax_torch import entry as E
    from genjax_torch import models as M
    from genjax_torch import parallel as P
    from genjax_torch.core import random
    from genjax_torch.inference import particle_gibbs
    from genjax_torch.inference.smc2 import smc2 as smc2_fn
    from genjax_torch.utils import (
        profile_trace,
        restore_checkpoint,
        run_elastic,
        save_checkpoint,
    )

    t_start = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="genjax_31_")
    backend = "nccl" if SHARDED_DEVICE == "cuda" else "gloo"
    P.init_distributed(num_processes=1, init_method=f"file://{tmp}/store",
                       device=SHARDED_DEVICE)
    out = {}
    try:
        check(dist.get_backend() == backend, f"phase 31: the group's "
              f"backend is {dist.get_backend()}, not {backend}")
        mesh = P.particle_mesh(SHARDED_DEVICE)

        # -- 31a. config 7 with its θ-lanes sharded --------------------------
        n_theta, n_x, n_steps = SHARDED_SIZE["smc2"]
        run_a, oracle, _ = E.build_sharded_smc2(n_theta, n_x, n_steps,
                                                device=dev)
        smc2_fn.host_syncs = 0
        res = _dist_measure(
            "a sharded SMC²", card, lambda i: run_a(random.key(
                1 if i == 0 else 10 + i, device=dev)), n_steps,
            n_theta * n_x * n_steps, "inner_particle_steps", zero_counts,
            counts, phase="31")
        got, want = res.pop("result"), refs["smc2"]
        for f in ("thetas", "log_weights", "log_z", "ess_history",
                  "rejuv_accept"):
            check(_same(getattr(got, f), getattr(want, f)),
                  f"31a: {f} differs from build_smc2's on the same key")
        check(got.n_rejuvenations == want.n_rejuvenations,
              f"31a: {got.n_rejuvenations} rejuvenations, build_smc2 "
              f"{want.n_rejuvenations}")
        logz = float(got.log_z)
        w = torch.softmax(got.log_weights.double(), 0)
        th = got.thetas.double()
        mean = float((w * th).sum())
        sd = math.sqrt(float((w * (th - mean) ** 2).sum()))
        check(abs(logz - oracle["log_ev"]) <= SMC2_LOGZ_BOUND
              and abs(mean - oracle["mean"]) <= SMC2_MOMENT_BOUND
              and abs(sd - oracle["std"]) <= SMC2_MOMENT_BOUND,
              f"31a: log Z {logz}, a | y {mean} {sd} vs the grid's {oracle}")
        _no_kernel(res["launches"], "31a (sharded SMC²)")
        # Four runs (three timed, one profiled), n_steps - 1 ESS reads each.
        syncs = smc2_fn.host_syncs / 4
        check(syncs == n_steps - 1, f"31a: {syncs} ESS host syncs a run")
        out["smc2"] = {**res, "log_z": logz, "log_ev": oracle["log_ev"],
                       "theta_mean": mean, "theta_sd": sd,
                       "rejuvenations": got.n_rejuvenations,
                       "ess_host_syncs": syncs, "bitwise": True}
        print(f"[31a sharded SMC²] {card}: {n_theta} x {n_x} x {n_steps}, "
              f"world of {dist.get_world_size()}: bit for bit build_smc2 on "
              f"key 1 (θs, weights, log Z {logz:.5f}, ESS history, "
              f"acceptance, {got.n_rejuvenations} rejuvenations); grid "
              f"{oracle['log_ev']:.5f}; {syncs:.0f} ESS host syncs a run",
              flush=True)
        del got, res

        # -- 31b. parallel tempering with its rungs sharded ------------------
        ladders, rungs, keep, burn = PT_SIZE
        run_b, exact = E.build_sharded_pt(ladders, rungs, keep, burn,
                                          device=dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        zero_counts()
        P.comm.reset()
        t0 = time.perf_counter()
        got = run_b(random.key(1, device=dev))
        torch.cuda.synchronize()
        pt_wall = time.perf_counter() - t0
        launches = counts()
        by_op = {k: {f: v[f] / (keep + burn) for f in v}
                 for k, v in P.comm.by_op().items()}
        peak = (torch.cuda.max_memory_allocated() - held) / 1e9
        want = refs["pt"]
        for f in ("samples", "swap_rate", "accept_rate"):
            check(_same(getattr(got, f), getattr(want, f)),
                  f"31b: {f} differs from build_pt's on the same key")
        check(_same(got.traces.get_choices()["mu"],
                    want.traces.get_choices()["mu"]),
              "31b: the final replicas differ from build_pt's")
        _no_kernel(launches, "31b (sharded PT)")
        s = got.samples.double().cpu()
        m = float(s.mean())
        mcse_m = float(s.mean(1).std() / math.sqrt(ladders))
        z_m = abs(m - exact["mean"]) / mcse_m
        check(z_m <= SHARDED_MCSE_BOUND, f"31b: cold mean {m} vs {exact['mean']} ({z_m:.2f}"
              " MCSE)")
        t_steps, p_steps = SHARDED_SIZE["pt_timed"], SHARDED_SIZE[
            "pt_profiled"]
        run_t = E.build_sharded_pt(ladders, rungs, t_steps, 0, device=dev)[0]
        walls, wall = _median_wall(None, lambda i: run_t(
            random.key(10 + i, device=dev)))
        rate = ladders * rungs * t_steps / wall
        run_p = E.build_sharded_pt(ladders, rungs, p_steps, 0, device=dev)[0]
        run_p(random.key(20, device=dev))
        p_wall, busy, ops = device_busy(lambda: run_p(random.key(
            21, device=dev)))
        out["pt"] = {"ladders": ladders, "rungs": rungs, "steps": keep,
                     "burn_in": burn, "mean": m, "z_mean": z_m,
                     "bitwise": True, "launches": launches,
                     "run_s": pt_wall, "timed_steps": t_steps,
                     "wall_ms": [x * 1e3 for x in walls],
                     "replica_steps_per_s": rate,
                     "collectives_per_step": by_op,
                     "profiled_wall_ms": p_wall, "device_busy_ms": busy,
                     "idle_share": 1.0 - busy / p_wall,
                     "device_ops_per_step": ops / p_steps, "peak_gb": peak}
        print(f"[31b sharded PT] {card}: {ladders} ladders x {rungs} rungs, "
              f"{burn} + {keep} steps: bit for bit build_pt on key 1 "
              f"(samples, swap and MH rates, replicas); cold mean {m:.5f} "
              f"({z_m:.2f} MCSE); run {pt_wall:.2f} s; {t_steps}-step runs "
              f"{[round(x * 1e3, 1) for x in walls]} ms (median "
              f"{wall * 1e3:.1f} ms), {rate:.6g} replica-steps/s; profiled "
              f"{p_steps}-step run {p_wall:.1f} ms, device busy {busy:.3f} "
              f"ms, idle share {out['pt']['idle_share']:.4f}, "
              f"{ops / p_steps:.0f} device ops a step; collectives a step "
              f"{by_op}; peak {peak:.3f} GB", flush=True)
        del got

        # -- 31c. PGAS with its chains sharded -------------------------------
        n_chains, n_part, n_sweeps = PGAS_SHARDED_SIZE
        run_c, ys = E.build_sharded_pgibbs(n_chains, n_part, 50, n_sweeps,
                                           device=dev)
        want = refs.get("pgas_paths")
        if want is None:
            # The reference: the unsharded sampler at this size (phase
            # 23's code path, on phase 23's key).
            init_s, prop_s, ll_s, tl_s = E.pgas_model()
            want = particle_gibbs(init_s, prop_s, ll_s, n_part, n_sweeps,
                                  trans_logpdf=tl_s)(
                random.split(random.key(3, device=dev), n_chains), ys).paths
        zero_counts()
        P.comm.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = run_c(random.key(3, device=dev))
        torch.cuda.synchronize()
        pg_s = time.perf_counter() - t0
        launches = counts()
        check(_same(got.paths, want),
              "31c: the paths differ from the unsharded sampler's")
        _no_kernel(launches, "31c (sharded PGAS)")
        means = P.pooled_chain_means(got.paths, mesh,
                                     burn_in=n_sweeps // 5).cpu()
        _, mus, _ = M.kalman_smoother(ys.double().cpu(), E.SMC2_A, E.SMC2_Q,
                                      E.SMC2_R, mu0=0.0, p0=0.0)
        z = (means.mean(0) - mus).abs() / (means.std(0)
                                           / math.sqrt(n_chains))
        check(bool((z <= SHARDED_MCSE_BOUND).all()), f"31c: smoothing means "
              f"{float(z.max())} MCSE from the RTS smoother")
        steps_c = n_chains * n_part * int(ys.shape[0]) * n_sweeps
        out["pgas"] = {"chains": n_chains, "particles": n_part,
                       "sweeps": n_sweeps, "bitwise": True,
                       "max_z": float(z.max()), "wall_s": pg_s,
                       "particle_steps_per_s": steps_c / pg_s,
                       "collectives": P.comm.by_op(), "launches": launches}
        print(f"[31c sharded PGAS] {card}: {n_chains} chains x {n_part} x "
              f"{int(ys.shape[0])} steps x {n_sweeps} sweeps: bit for bit "
              f"the unsharded sampler's paths; smoothing means within "
              f"{float(z.max()):.2f}"
              f" MCSE of the RTS smoother; {pg_s:.2f} s, "
              f"{steps_c / pg_s:.6g} particle-steps/s", flush=True)
        del got

        # -- 31d. config 4 under run_elastic, DCP checkpoints ----------------
        n, steps, chunk, every, fault_at = SHARDED_SIZE["elastic"]
        make = E.build_elastic_pf(n, steps, device=dev)

        def place(st, devs):
            return {**st, "fault": torch.zeros_like(st["fault"])}

        step, state0, log_z_of = make(random.key(5, device=dev))
        zero_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        clean = run_elastic(step, state0, steps,
                            ckpt_path=os.path.join(tmp, "clean"),
                            chunk=chunk, checkpoint_every=every)
        torch.cuda.synchronize()
        clean_s = time.perf_counter() - t0
        clean_launches = counts()
        step_f, state_f, _ = make(random.key(5, device=dev),
                                  fault_at=fault_at)
        zero_counts()
        t0 = time.perf_counter()
        hurt = run_elastic(step_f, state_f, steps,
                           ckpt_path=os.path.join(tmp, "hurt"), chunk=chunk,
                           checkpoint_every=every, place=place)
        torch.cuda.synchronize()
        hurt_s = time.perf_counter() - t0
        hurt_launches = counts()
        kinds = [e.kind for e in hurt.events]
        resumed = chunk * every * ((fault_at // chunk * chunk)
                                   // (chunk * every))
        check(clean.events == [] and kinds == ["nonfinite"]
              and hurt.events[0].resumed_from == resumed,
              f"31d: events {clean.events} / {hurt.events}")
        for k in ("xs", "lw", "log_z"):
            check(_same(hurt.state[k], clean.state[k]),
                  f"31d: {k} after recovery differs from the clean run's")
        lz = float(log_z_of(clean.state))
        ref_pf = float(E.build_pf(n, steps, device=dev)[0](
            random.key(5, device=dev)))
        check(math.isfinite(lz) and abs(lz - ref_pf) <= ELASTIC_LOGZ_BOUND,
              f"31d: log Z {lz} vs build_pf {ref_pf}")
        check(clean_launches["cdf_counts"] >= 1
              and hurt_launches["cdf_counts"] >= 1,
              f"31d: CDF launches {clean_launches} / {hurt_launches}")
        ck = os.path.join(tmp, "timed")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        save_checkpoint(ck, clean.state)
        torch.cuda.synchronize()
        save_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        back = restore_checkpoint(ck, clean.state)
        torch.cuda.synchronize()
        restore_ms = (time.perf_counter() - t0) * 1e3
        check(all(_same(back[k], clean.state[k]) for k in back),
              "31d: the restored state differs")
        state_bytes = sum(v.numel() * v.element_size()
                          for v in clean.state.values())
        disk_bytes = sum(os.path.getsize(os.path.join(ck, f))
                         for f in os.listdir(ck))
        out["elastic"] = {
            "particles": n, "steps": steps, "chunk": chunk,
            "checkpoint_every": every, "fault_at": fault_at,
            "events": [vars(e) for e in hurt.events], "log_z": lz,
            "build_pf_log_z": ref_pf, "clean_s": clean_s, "hurt_s": hurt_s,
            "clean_launches": clean_launches,
            "hurt_launches": hurt_launches, "save_ms": save_ms,
            "restore_ms": restore_ms, "state_bytes": state_bytes,
            "checkpoint_disk_bytes": disk_bytes}
        print(f"[31d elastic config 4] {card}: {n} x {steps}, chunk {chunk}, "
              f"a DCP checkpoint every {every} chunks; a NaN at step "
              f"{fault_at}: events {kinds}, resumed from step "
              f"{hurt.events[0].resumed_from}, final state bit for bit the "
              f"clean run's; log Z {lz:.5f} vs build_pf {ref_pf:.5f} (bound "
              f"{ELASTIC_LOGZ_BOUND}); clean {clean_s:.2f} s, recovered "
              f"{hurt_s:.2f} s; CDF launches {clean_launches['cdf_counts']} / "
              f"{hurt_launches['cdf_counts']}; save {save_ms:.1f} ms, restore "
              f"{restore_ms:.1f} ms of {state_bytes} B ({disk_bytes} B on "
              f"disk)", flush=True)
        del clean, hurt, back

        # -- 31e. a Chrome trace of build_pf ---------------------------------
        n_pf, steps_pf = SHARDED_SIZE["trace_pf"]
        run_pf, _ = E.build_pf(n_pf, steps_pf, device=dev)
        run_pf(random.key(6, device=dev))
        for attempt in range(1, 4):
            d = os.path.join(tmp, f"trace{attempt}")
            with profile_trace(d):
                run_pf(random.key(7, device=dev))
            with open(os.path.join(d, "trace.json")) as f:
                events = json.load(f)["traceEvents"]
            kernels = sum(1 for e in events
                          if e.get("cat") == TRACE_KERNEL_CAT)
            if kernels:
                break
            print(f"[profiler] trace {attempt} of 3 holds no device kernel",
                  flush=True)
        check(kernels >= 1, "31e: no device kernel in three traces")
        out["trace"] = {"attempts": attempt, "events": len(events),
                        "kernel_events": kernels}
        print(f"[31e profile_trace] {card}: build_pf {n_pf} x {steps_pf}: "
              f"{len(events)} trace events, {kernels} device kernels "
              f"(try {attempt})", flush=True)
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
    out["phase_s"] = time.perf_counter() - t_start
    print(f"[31] {card}: phase 31 in {out['phase_s']:.1f} s", flush=True)
    return out


#: Phase 32: the documented programs of the JAX package, ported
#: (genjax_torch/examples), each at its documented size on the card but
#: for the six that define REHEARSAL sizes (ex03, ex10, ex11, ex12, ex13,
#: ex15): at their documented sizes they took 432-1389 s each on the card
#: (tools/examples_on_card.py), so they run at REHEARSAL here and against
#: the CPU's run at the same sizes. Each is bound by the host's issue of
#: small ops (one core), so a pool of worker processes runs them beside
#: phases 14-31 and phase 32 collects them after phase 31; the programs
#: that take longest go first.
EXAMPLE_WORKERS = 4
EXAMPLE_FIRST = ("ex12_particle_gibbs", "ex11_constrained_nuts",
                 "ex13_parameter_inference", "ex03_nuts_regression",
                 "ex15_svgd_and_slice", "ex10_state_space_vi",
                 "cb13_exact_oracles")
#: The programs whose path resamples through the CDF kernel: each must
#: launch it on the card.
EXAMPLE_RESAMPLERS = ("ex02_state_space_pf", "ex07_tempered_smc",
                      "ex08_trace_level_pf", "ex09_smc_samplers",
                      "ex13_parameter_inference", "cb09_h100_performance")
#: Checks whose card path carries a Not-fault the CPU's does not (the
#: card's reduction order, amplified by SMC²'s inner resampling or a NUTS
#: trajectory, or in a variance of 1500 log-weights): held to the CPU run
#: within the Monte Carlo bound of the tests (4 sqrt(2) sd of
#: examples/spread.json) where the test's own bound is tighter.
EXAMPLE_CARD_MC = {
    "ex13_parameter_inference": ("smc2_mean", "smc2_log_z", "smc2_accept"),
    "ex14_pod_scale_inference": ("nuts_mu_mean",),
    "cb10_ravi_stacks": ("var_prior", "var_ravi")}
#: The closed forms the JAX programs print without a stated tolerance:
#: each within 5 of the run's own Monte Carlo sd (spread.json).
EXAMPLE_EXACT = {"ex01_beta_bernoulli_sir": {"mean_true": 0.6,
                                             "mean_false": 0.4},
                 "ex05_sharded_smc": {"log_z": math.log(0.5)}}


def start_examples(names=None, device: str = "cuda") -> dict:
    """Start phase 32's pool (spawned workers, one intra-op thread each)
    and submit every program (or ``names``; a CPU rehearsal passes
    ``device="cpu"``)."""
    import concurrent.futures as cf
    import multiprocessing

    import torch

    from genjax_torch.examples import COOKBOOK, EXAMPLES, run_program
    from genjax_torch.examples.holding import rehearsal_sizes

    names = sorted(names or EXAMPLES + COOKBOOK,
                   key=lambda n: n not in EXAMPLE_FIRST)
    pool = cf.ProcessPoolExecutor(
        EXAMPLE_WORKERS, mp_context=multiprocessing.get_context("spawn"),
        initializer=torch.set_num_threads, initargs=(1,))
    t0 = time.perf_counter()
    return {"pool": pool, "t0": t0, "futures": {
        n: pool.submit(run_program, n, device, rehearsal_sizes(n))
        for n in names}}


def examples_phase(card: str, started: dict) -> dict:
    """Phase 32: wait for the pool, then hold each program's card results
    to its CPU reference under the tests' tolerances
    (``genjax_torch.examples.specs``), and the closed forms of
    EXAMPLE_EXACT; record each program's wall and launches."""
    from genjax_torch.examples import holding as H
    from genjax_torch.examples.specs import PROGRAMS

    t_wait = time.perf_counter()
    pool, futures = started["pool"], started["futures"]
    try:
        runs = {n: f.result() for n, f in futures.items()}
    finally:
        pool.shutdown(wait=True, cancel_futures=True)
    waited = time.perf_counter() - t_wait
    pool_s = time.perf_counter() - started["t0"]
    ref, spread = H.reference(), H.spread()
    out = {}
    for name, run in runs.items():
        res, prog = run["result"], PROGRAMS[name]
        check(H.finite_tree(res), f"32 {name}: a result is not finite")
        try:
            H.check_current(name, ref[name])
        except AssertionError as e:
            fail(f"32 {name}: {e}")
        sizes = H.rehearsal_sizes(name)
        cpu = ref[name]["result"] if sizes is None else \
            ref[name]["rehearsal"]["result"]
        # A rehearsal's Monte Carlo spread is its own (fewer draws).
        try:
            worst = H.hold_to_port(
                prog, res, cpu, name if sizes is None else
                name + "@rehearsal", EXAMPLE_CARD_MC.get(name, ()))
        except AssertionError as e:
            fail(f"32 {name}: the card against the CPU: {e}")
        for key, value in EXAMPLE_EXACT.get(name, {}).items():
            sd = spread[name][key]["sd"]
            check(abs(res[key] - value) <= 5 * sd, f"32 {name}: {key} "
                  f"{res[key]} vs the closed form {value} (5 sd = {5 * sd})")
        launches = run["launches"]
        if name in EXAMPLE_RESAMPLERS:
            check(launches["cdf_counts"] > 0,
                  f"32 {name}: resamples but never launched the CDF kernel")
        out[name] = {"wall_s": run["wall_s"], "launches": launches,
                     "sizes": "documented" if sizes is None else sizes,
                     "worst_bound_share": worst, "result": res}
        print(f"[32 {name}] {card}: "
              f"{'documented size' if sizes is None else sizes}: wall "
              f"{run['wall_s']:.2f} s, launches {launches}, card vs CPU "
              f"within {worst:.3f} of the bound", flush=True)
    cdf = sum(o["launches"]["cdf_counts"] for o in out.values())
    print(f"[32] {card}: {len(out)} programs in a pool of {EXAMPLE_WORKERS} "
          f"workers beside phases 14-31: {pool_s:.1f} s from the pool's "
          f"start, {waited:.1f} s waited after phase 31; sum of walls "
          f"{sum(o['wall_s'] for o in out.values()):.1f} s; CDF launches "
          f"{cdf}", flush=True)
    return {"programs": out, "pool_s": pool_s, "waited_s": waited,
            "workers": EXAMPLE_WORKERS, "cdf_launches": cdf}


def stop_examples(started: dict) -> None:
    """Stop phase 32's pool and every worker it started (a failed phase
    must not wait for the programs still running)."""
    pool = started["pool"]
    for proc in list((getattr(pool, "_processes", None) or {}).values()):
        if proc.is_alive():
            proc.terminate()
    pool.shutdown(wait=True, cancel_futures=True)


def log_matmul_grad_check(dev, card: str) -> dict:
    """Phase 8's gradient checks of the log-matmul kernel's path."""
    import torch

    from genjax_torch import entry as E
    from genjax_torch.core import random
    from genjax_torch.lang.distributions.discrete_hmm import (
        forward_filter_parallel)
    from genjax_torch.ops import logmatmul as lm

    # The kernel's gradient (the backward of its autograd Function)
    # against autograd of the plain version on the same operands and
    # cotangent: through torch.autograd.grad and torch.func.grad at (8,
    # 128, 128), 1e-5 relative + 1e-5 absolute as the forward (both take
    # the same products; only the order of a few sums differs); and
    # d log p / d transition_logits through the parallel filter at S =
    # 128, T = 256 against the same filter with the plain version swapped
    # in, 1e-4 relative + 1e-4 absolute: each scan level's inputs carry
    # the kernel's forward error of up to 1e-5 into the next level's
    # exponentials.
    x8, y8, g8 = (2.0 * random.normal(k, (8, 128, 128)) for k in
                  random.split(random.key(61, device=dev), 3).unbind(-2))
    xr, yr = x8.clone().requires_grad_(), y8.clone().requires_grad_()
    out8 = lm.log_matmul(xr, yr)
    check(out8.grad_fn is not None,
          "log_matmul: the kernel's result carries no gradient")
    grads = {"autograd": torch.autograd.grad(out8, (xr, yr), g8),
             "func": torch.func.grad(
                 lambda a, b: (lm.log_matmul(a, b) * g8).sum(),
                 argnums=(0, 1))(x8, y8)}
    xp, yp = x8.clone().requires_grad_(), y8.clone().requires_grad_()
    want8 = torch.autograd.grad(lm.log_matmul_plain(xp, yp), (xp, yp), g8)
    lm_grad_err = {}
    for how, got in grads.items():
        err = max(float(((a - b).abs() - 1e-5 * b.abs()).max())
                  for a, b in zip(got, want8))
        check(err <= 1e-5, f"log_matmul gradient ({how}) at (8, 128, 128): "
              f"|kernel's - plain's| - 1e-5 |plain's| = {err}")
        lm_grad_err[how] = err
    dhmm = sys.modules["genjax_torch.lang.distributions.discrete_hmm"]
    _, problem_g = E.build_hmm_parallel(128, 256, device=dev)
    cfg_g, obs_g = problem_g.config, problem_g.observations

    def filter_grad():
        tr = cfg_g.transition_logits.clone().requires_grad_()
        c = type(cfg_g)(cfg_g.prior_logits, tr, cfg_g.observation_logits)
        return torch.autograd.grad(forward_filter_parallel(c, obs_g)[1],
                                   tr)[0]

    before = lm.log_matmul.launches
    g_kernel = filter_grad()
    check(lm.log_matmul.launches > before,
          "log_matmul: the filter's gradient run launched no kernel")
    kernel_path = dhmm.log_matmul
    dhmm.log_matmul = lm.log_matmul_plain
    try:
        g_plain = filter_grad()
    finally:
        dhmm.log_matmul = kernel_path
    torch.cuda.synchronize()
    filter_gerr = float(((g_kernel - g_plain).abs()
                         - 1e-4 * g_plain.abs()).max())
    check(bool(torch.isfinite(g_kernel).all()) and filter_gerr <= 1e-4,
          f"log_matmul: the parallel filter's gradient, |kernel path's - "
          f"plain's| - 1e-4 |plain's| = {filter_gerr}")
    print(f"[8 log_matmul gradient] (8, 128, 128): autograd and torch.func "
          f"of the kernel path against autograd of plain, max |diff| - "
          f"1e-5 |plain| = {lm_grad_err} (bound 1e-5); the parallel "
          f"filter's d log p / d transition_logits at S = 128, T = 256: "
          f"max |diff| - 1e-4 |plain| = {filter_gerr:.3g} (bound 1e-4), "
          f"max |grad| {float(g_plain.abs().max()):.4g}", flush=True)
    return {"grad_err_8x128": lm_grad_err, "filter_grad_err": filter_gerr}


# xs/lw: the kernel's sqrt/log1p/cos are the card's libdevice, its
# exp the approximate instruction, not torch's, and tracking.cuh's
# divisions the fast ones, so an element may move by a few ulp,
# amplified by the model (x^2 / 20, then a square): xs to 1e-3 and lw
# to 1e-2 absolute, on values of order 10 and 100. The generated
# models are held to the same bounds.
def fused_vs_plain(label, propagate, loglik, model, step_inputs,
                   steps=None, bound=None) -> float:
    """Phase 4: the fused-step kernel with ``model`` against its plain
    version on ``step_inputs`` (the key's words, 2^20 states and
    log-weights, the observation): one step at 2^20 in f32 and bf16 state
    and at a ragged size; the largest f32 error. The bounds are
    1e-3 on the states and 1e-2 on the log-weights, or, given
    ``bound = (atol, rtol)``, ``atol + rtol |plain|`` on each f32 state
    and each log-weight. ``steps(x_new)``, where given, marks the new
    states at a step of ``loglik`` (a rounding): there the two may part
    by a step, each such weight counted and the count held to
    ``GEN_STEP_MISMATCHES``; the rest to the bounds."""
    import torch

    from genjax_torch.ops import fused_step as fs

    seeds, xs0, lw0, obs = step_inputs
    n = xs0.shape[0]
    f32_err = 0.0
    atol, rtol = (None, None) if bound is None else bound
    for dtype, tol, size in ((torch.float32, 1e-3, n),
                             (torch.bfloat16, 1e-3, n),
                             (torch.float32, 1e-3, 1_000_003)):
        xs, lw_s = xs0[:size].to(dtype), lw0[:size]
        out_k, again = (fs.fused_step(
            seeds, xs, lw_s, obs, propagate, loglik, cuda_model=model,
            state_dtype=dtype) for _ in range(2))
        out_p = fs.fused_step_plain(seeds, xs, lw_s, obs, propagate,
                                    loglik, state_dtype=dtype)
        torch.cuda.synchronize()
        check(all(bool(torch.equal(a, b)) for a, b in zip(out_k, again)),
              f"fused_step {label} {dtype} n={size}: two calls differ")
        check(out_k[0].dtype == dtype and out_k[1].dtype == torch.float32,
              f"fused_step {label} output dtypes")
        x_err = float((out_k[0].float() - out_p[0].float()).abs().max())
        lw_diff = (out_k[1] - out_p[1]).abs()
        lw_tol = (tol * 10 if bound is None
                  else atol + rtol * out_p[1].abs())
        parted, moved = "", 0.0
        if steps is not None:
            apart = lw_diff > lw_tol
            eps = fs.normal_from_counter(seeds[0], seeds[1], torch.arange(
                xs.shape[0], dtype=torch.int64, device=xs.device))
            at_step = steps(propagate(xs.float(), eps))
            n_apart = int(apart.sum())
            check(bool((at_step | ~apart).all()) and
                  n_apart <= GEN_STEP_MISMATCHES,
                  f"fused_step {label} {dtype} n={size}: {n_apart} weights "
                  f"apart, {int((apart & ~at_step).sum())} off a step")
            # What the parted weights may move log Z and the ESS by.
            moved = float((torch.exp(out_p[1] - out_p[2])
                           * torch.expm1(2 * lw_diff))[apart].sum())
            lw_diff = torch.where(apart, 0.0, lw_diff)
            parted = (f"; {n_apart} weights a step apart (each at a "
                      f"step; bound {GEN_STEP_MISMATCHES})")
        lw_err = float(lw_diff.max())
        # bf16 state: one rounding of x_new either side of a tie.
        if dtype != torch.float32:
            x_ok = x_err <= 0.0625
        elif bound is None:
            x_ok = x_err <= tol
        else:
            x_ok = bool(((out_k[0] - out_p[0]).abs()
                         <= atol + rtol * out_p[0].abs()).all())
        check(x_ok, f"fused_step {label} {dtype} xs err {x_err}")
        check(bool((lw_diff <= lw_tol).all()),
              f"fused_step {label} {dtype} lw err {lw_err}")
        lse_err = abs(float(out_k[2] - out_p[2]))
        ess_rel = abs(float(out_k[3] - out_p[3])) / float(out_p[3])
        lse_tol = 1e-4 + moved
        check(lse_err < lse_tol,
              f"fused_step {label} {dtype} lse err {lse_err}")
        check(ess_rel < lse_tol,
              f"fused_step {label} {dtype} ess rel err {ess_rel}")
        if dtype == torch.float32:
            f32_err = max(f32_err, x_err, lw_err)
        bounds = ("" if bound is None else
                  f" (bound {atol:g} + {rtol:g} |plain| on each f32 state "
                  f"and log-weight)")
        print(f"[4 fused_step {label} {str(dtype)[6:]} n={size}] "
              f"|dx|={x_err:.3g} |dlw|={lw_err:.3g} |dlse|={lse_err:.3g} "
              f"ess rel={ess_rel:.3g}{bounds}; two calls equal bit for "
              f"bit{parted}", flush=True)
    return f32_err


#: Phase 33: models with no hand-written CUDA header through the public
#: fused filter, ``cuda_model`` left None, at config 4's width (particles,
#: steps): the stochastic-volatility model (Kim, Shephard and Chib 1998)
#: over ``GEN_SV_KEYS`` keys against the general driver on the same model;
#: the JAX test's linear-Gaussian lambdas with constants ``linear.cuh``
#: does not carry, against Kalman, and again with ``GEN_LINEAR_OTHER`` (the
#: same source: no build); the tracking model's torch form beside
#: ``tracking.cuh`` on one key; the linear lambdas with constants read
#: live (:func:`live_linear`), changed between two runs of one filter.
GEN_SIZE = (1 << 20, 32)
GEN_SV_KEYS = 8
GEN_LINEAR = (0.7, 0.5, 0.4)
GEN_LINEAR_OTHER = (0.6, 0.8, 0.25)
#: The JAX test's Kalman bound (tests/ops/test_fused_step.py:138) and
#: phase 6's bound between two config-4 filters.
GEN_LINEAR_BOUND = 0.1
GEN_TRACKING_BOUND = 0.25


def live_linear(dev):
    """The linear-Gaussian lambdas reading ``a`` from a 0-d tensor on
    ``dev`` (set in place) and the rest from a list (rebound), set to
    ``GEN_LINEAR``: ``(propagate, loglik, set_constants)``."""
    import torch

    a_t = torch.zeros((), device=dev)
    rest = [0.0, 1.0, 0.0]

    def propagate(x, e):
        return a_t * x + rest[0] * e

    def loglik(x, y):
        return -0.5 * (y - x) ** 2 / rest[1] - rest[2]

    def set_constants(a, q, r):
        a_t.fill_(a)
        rest[:] = [math.sqrt(q), r, 0.5 * math.log(2 * math.pi * r)]

    set_constants(*GEN_LINEAR)
    return propagate, loglik, set_constants


#: The generated models by phase: phase 33's four, and the three whose
#: headers need the ops and value types taken after them (phase 34 runs
#: all three through the fused filter; phase 4 holds each to its plain
#: version).
GEN33_MODELS = ("sv", "linear", "tracking", "live")
GEN34_MODELS = ("ops", "dynamic_logit", "quantised", "lambert_w")
#: Phase 34 (e): models whose float constants the launch reads from the
#: device, more than a classic 4 KB kernel parameter space would hold at
#: 1100: label -> constants (:func:`long_loop_model`), one fused run each
#: (the 1100-step trace takes seconds a run); phase 4 holds their headers
#: to ``GEN34_BOUND``.
GEN_LONG_LOOPS = {"long_loop": 33, "long_loop_1100": 1100}
#: Phase 34: keys a model, fused against the general driver; the ops
#: model's run traces ~150 ops (~0.8 s on the card's host), so it takes
#: fewer.
GEN34_KEYS = 8
GEN34_OPS_KEYS = 4
#: Phase 4: the quantised model's weights that may part from the plain
#: version's at a step of its grid (a new state within a few ulps of a
#: half step rounds the other way there: at 2^20 normal states about one
#: is expected), and how near a step such a state lies, in grid units.
GEN_STEP_MISMATCHES = 16
GEN_STEP_WIDTH = 1e-4
#: Phase 4's bound on the headers of ``GEN34_MODELS`` and
#: ``GEN_LONG_LOOPS``, ``(atol, rtol)``
#: on each state and log-weight: their states are not amplified as the
#: tracking model's are (which the default bounds serve), so an op's
#: term that is wrong on the card shows above its ulps.
GEN34_BOUND = (1e-5, 1e-5)


def quantised_steps(x_new):
    """The new states at a step of the quantised model's rounding."""
    import torch

    from genjax_torch import entry as E

    u = x_new / E.QUANT_STEP
    return (u - torch.floor(u) - 0.5).abs() < GEN_STEP_WIDTH


def ops_model(dev):
    """Phase 2's ``ops`` model: ``(propagate, loglik)`` using every op and
    value type of the generator's table that phase 33's models do not,
    once. Its rounding, integer and bool ops read the state ``x`` in
    ``propagate`` and the observation ``y`` in ``loglik``, which the
    kernel and its plain version read exactly; what the draw or
    ``loglik``'s ``x`` (the new state) reaches is continuous, as these
    are a few ulps apart between the two (the card's math library; nvcc
    contracts ``a * b + c``, torch does not), so phase 4 holds it to
    ``GEN34_BOUND``. ``loglik``'s terms count at full size (they do not
    feed back into the state, which ``propagate`` keeps near 0 by
    scaling its own by 0.01), but for the integer ones, each whole step
    of which moves it by 1e-3 and 1e-9 x 2^31 (an out-of-range f32 ->
    int32 cast and a NaN's, whose value depends on the device). Its bit
    ops read the exponent, not a low bit: as a filter's dynamics, a model that
    branched on the state's last bit would be another model under each
    rounding, with another log Z. Its divisors with a rounding mode are
    powers of 2, as torch on the card divides by a scalar through its
    reciprocal."""
    import torch
    import torch.nn.functional as F

    flag = torch.tensor(True, device=dev)
    seven = torch.tensor(7, dtype=torch.int32, device=dev)

    def propagate(x, e):
        i = torch.floor(x * 4.0).to(torch.int32)
        bits = x.view(torch.int32)
        k = (i * 5 - 3 + i.abs()) ^ ~i
        k = ((k << 3) >> 2) | ((bits >> 23) & 1)
        k = torch.clamp(torch.maximum(k, -k), max=64) + seven
        k = (k << (i & 3)) >> (i & 1)
        k = torch.where(k > 40, (k.sign() * k ** 2) & 63, torch.minimum(k, i))
        mant = ((bits & 0x007FFFFF) | 0x3F800000).view(torch.float32)
        odd = (torch.isnan(x) | torch.isinf(x)
               | torch.isposinf(x) ^ torch.isneginf(x))
        flags = ~odd & (torch.signbit(x) | (k > 20)) & flag
        flags = torch.logical_xor(flags, torch.logical_and(
            x.bool(), torch.logical_not(k.bool())))
        flags = torch.logical_or(flags, i == 2)
        picked = torch.where(flags, k.to(torch.float32), mant + flags.int())
        t = torch.tanh(x)
        rounded = (torch.round(x * 2.0) + torch.ceil(x) - torch.trunc(x)
                   + torch.frac(x) + torch.sign(x)
                   + torch.remainder(x, 0.75) + torch.fmod(x, 0.5)
                   + torch.floor_divide(x, 0.5)
                   + torch.div(x, 0.25, rounding_mode="trunc")
                   + torch.heaviside(x, e) + torch.ldexp(t, (i & 3) - 2))
        smooth = (torch.tan(t) + torch.erfinv(t * 0.875) + torch.exp2(t)
                  + torch.log2(x.abs() + 1.0) + torch.log10(t + 2.0)
                  + torch.logit(torch.sigmoid(x), eps=1e-3) + torch.sinc(x)
                  + torch.deg2rad(x) + torch.rad2deg(t)
                  + F.softplus(x, beta=2.0, threshold=10.0)
                  + F.logsigmoid(x) + F.silu(x) + F.mish(x)
                  + F.gelu(x, approximate="tanh") + F.relu6(x)
                  + F.hardtanh(x) + F.leaky_relu(x) + F.relu(x)
                  + F.hardsigmoid(x) + F.hardswish(x)
                  + torch.special.entr(torch.sigmoid(x)))
        return 0.5 * x + 0.3 * e + 0.01 * (picked + rounded + smooth)

    def loglik(x, y):
        yi = y.to(torch.int32)
        # f32 -> int32 out of range and of a NaN: what torch's cast gives
        # on the device the model runs on (the header follows it there).
        wide = ((y * 1e10).to(torch.int32).to(torch.float32)
                + torch.sqrt(-1.0 - y.abs()).to(torch.int32).to(
                    torch.float32))
        yk = (y.view(torch.int32) >> 20) - (yi * yi)
        shift = torch.where(yi > 1, torch.full_like(yi, 3), yi.abs() & 1)
        grid = torch.where(yk != 0, (yk << shift).to(torch.float32),
                           torch.zeros_like(y))
        smooth = (torch.hypot(x, y) + torch.copysign(x, y)
                  + torch.nextafter(x, y) + torch.fmax(x, y)
                  + torch.fmin(x, torch.zeros_like(x))
                  + torch.xlogy(x * x, y.abs() + torch.ones_like(y))
                  + torch.special.xlog1py(x, y * y)
                  + torch.logaddexp(x, y) + torch.logaddexp2(x, -y)
                  + torch.lerp(x, y, 0.25) + torch.full((1,), 0.5,
                                                        device=x.device)
                  + torch.scalar_tensor(0.125, device=x.device))
        return -0.5 * (x - y) ** 2 + 1e-3 * grid + 1e-9 * wide + smooth

    return propagate, loglik


def long_loop_model(n_params: int, phi: float = 0.9):
    """A model with ``n_params`` float constants, each read once, as a
    Python loop unrolled over them gives: ``propagate`` runs its draw
    through ``n_params - 3`` steps ``v = v c_k + eps``, each step its own
    ``c_k`` in [0.25, 0.5] (so an early step's rounding shrinks in the
    later ones), and returns ``phi x + 0.15 v``; ``loglik`` is
    ``-0.5 (y - x)^2``. ``(propagate, loglik)``."""
    cs = [0.25 + 0.25 * k / (n_params - 4) for k in range(n_params - 3)]

    def propagate(x, e):
        v = e
        for c in cs:
            v = v * c + e
        return phi * x + 0.15 * v

    def loglik(x, y):
        return -0.5 * (y - x) ** 2

    return propagate, loglik


def generated_models(dev) -> dict:
    """The torch forms of the generated models, by label: ``(propagate,
    loglik)``: phase 33's (``GEN33_MODELS``), the ops model and phase
    34's three (``GEN34_MODELS``) and the long loops
    (``GEN_LONG_LOOPS``)."""
    from genjax_torch import entry as E

    return {"sv": E.sv_model(), "linear": E.linear_model(*GEN_LINEAR),
            "tracking": (E.tracking_propagate, E.tracking_loglik),
            "live": live_linear(dev)[:2], "ops": ops_model(dev),
            "dynamic_logit": E.dynamic_logit_model(),
            "quantised": E.quantised_model(),
            "lambert_w": E.lambert_w_model(),
            **{k: long_loop_model(c) for k, c in GEN_LONG_LOOPS.items()}}


class FusedRuns:
    """Runs of fused filters in a phase, each counted from 0: its log Z,
    wall and launches, held to ``t`` fused launches from its model's
    library and one CDF launch a resample (counted at
    ``pf.resample_tree``), no other kernel; with the phase's line for
    each."""

    def __init__(self, phase: str, card: str, zero_counts, counts, n, t):
        from genjax_torch.inference import pf as pf_mod

        self.phase, self.card, self.n, self.t = phase, card, n, t
        self.zero_counts, self.counts = zero_counts, counts
        self.pf, self.resamples = pf_mod, [0]
        self.resample_tree = pf_mod.resample_tree

    def __enter__(self):
        def counted_resample(*args, **kwargs):
            self.resamples[0] += 1
            return self.resample_tree(*args, **kwargs)

        self.pf.resample_tree = counted_resample
        return self

    def __exit__(self, *exc):
        self.pf.resample_tree = self.resample_tree

    def run(self, label, run, key, model_name):
        """One run of a fused filter: ``(log Z, wall s, launches)``."""
        import torch

        from genjax_torch.ops import fused_step as fs

        self.zero_counts()
        self.resamples[0] = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        z = float(run(key))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = {**self.counts(),
               "by_model": dict(fs.fused_step.launches_by_model),
               "resamples": self.resamples[0]}
        tag = f"phase {self.phase} {label}"
        check(math.isfinite(z), f"{tag}: log Z {z}")
        check(got["by_model"] == {model_name: self.t},
              f"{tag}: fused launches {got['by_model']}, not "
              f"{self.t} from {model_name}")
        check(got["cdf_counts"] == got["resamples"] >= 1,
              f"{tag}: {got['cdf_counts']} CDF launches for "
              f"{got['resamples']} resamples")
        check(got["log_matmul"] == got["expand_adaptive"] == 0,
              f"{tag}: another kernel ran: {got}")
        return z, wall, got

    def line(self, label, z, wall, got, extra=""):
        print(f"[{self.phase} {label}] {self.card}: {self.n} x {self.t}: "
              f"log Z {z:.5f}; fused launches {got['by_model']}; CDF "
              f"launches {got['cdf_counts']} ({got['resamples']} "
              f"resamples); {self.n * self.t / wall:.4g} particle-steps/s "
              f"(wall {wall * 1e3:.2f} ms){extra}", flush=True)

    def against_general(self, label, run_f, run_g, model_name, keys,
                        seed: int, dev) -> dict:
        """``keys`` runs of a fused filter beside the general driver on
        the same model and keys (which launches no fused step): the means
        of log Z within 4 standard errors."""
        from genjax_torch.core import random

        z_f, z_g, rates = [], [], []
        for i in range(keys):
            key = random.key(seed + i, device=dev)
            z, wall, got = self.run(label, run_f, key, model_name)
            self.line(f"{label} key {i}", z, wall, got)
            z_f.append(z)
            rates.append(self.n * self.t / wall)
            self.zero_counts()
            z_g.append(float(run_g(key)))
            check(self.counts()["fused_step"] == 0,
                  f"phase {self.phase} {label}: the general driver "
                  f"launched the fused step")

        def mean_var(v):
            m = sum(v) / len(v)
            return m, sum((z - m) ** 2 for z in v) / (len(v) - 1)

        (m_f, v_f), (m_g, v_g) = mean_var(z_f), mean_var(z_g)
        diff = abs(m_f - m_g)
        se = math.sqrt((v_f + v_g) / keys)
        check(diff <= 4 * se, f"phase {self.phase} {label}: mean log Z "
              f"fused {m_f} vs general {m_g} (4 se = {4 * se})")
        return {"log_z_fused": z_f, "log_z_general": z_g, "se": se,
                "diff": diff, "particle_steps_per_s":
                    sorted(rates)[len(rates) // 2],
                "rates": sorted(rates), "launches": got}


def time_generated(card: str, phase: str, variants: dict,
                   step_inputs: tuple) -> dict:
    """Each variant's fused step a call at 2^20 (``variants``: label ->
    ``(propagate, loglik, CudaModel)``): CUDA events (the best of 3
    rounds of 200 calls, the variants in turns) and the device time of a
    profiled run, beside the plain version's."""
    from genjax_torch.ops import fused_step as fs

    seeds, xs, lw, obs = step_inputs

    def call(v):
        prop, ll, model = variants[v]
        return lambda: fs.fused_step(seeds, xs, lw, obs, prop, ll,
                                     cuda_model=model)

    order = list(variants)
    ms = {v: math.inf for v in order}
    for rnd in range(3):
        for v in (order if rnd % 2 == 0 else order[::-1]):
            ms[v] = min(ms[v], cuda_ms(call(v), 200))
    timing = {}
    for v in order:
        prop, ll, _ = variants[v]
        # One launch a call: a profile short of it lost device events
        # (tools/profile_drops.py), and its time a call is not measured.
        (_, dev_ms, _, ops, _), tries = profiled_ops(call(v), 50, 1)
        plain = cuda_ms(lambda: fs.fused_step_plain(seeds, xs, lw, obs,
                                                    prop, ll), 20)
        timing[v] = {"ms": ms[v],
                     "device_ms": dev_ms if ops == 1 else math.nan,
                     "plain_ms": plain, "device_ops_per_call": ops,
                     "device_ops_tries": tries}
    print(f"[{phase} timing] {card}: fused step a call at 2^20, f32 state, "
          f"CUDA events (best of 3 x 200 calls, in turns) and profiled "
          f"device time: " + "; ".join(
              f"{v} {timing[v]['ms']:.5f} ms events, "
              f"{timing[v]['device_ms']} ms device, plain "
              f"{timing[v]['plain_ms']:.4f} ms" for v in order), flush=True)
    return timing


def generated_phase(dev, card: str, zero_counts, counts, gen: dict,
                    step_inputs: tuple) -> dict:
    """Phase 33: the fused filter with the CUDA forms generated from the
    torch forms (``gen``: label -> CudaModel, built in phase 2), each run
    counted from 0: 32 fused launches from the model's generated library
    and one CDF launch a resample; and each generated kernel's time a
    call at 2^20 beside ``tracking.cuh``'s, in turns."""
    import torch

    from genjax_torch import entry as E
    from genjax_torch.core import random
    from genjax_torch.inference import pf as pf_mod
    from genjax_torch.ops import fused_model, fused_step as fs
    from genjax_torch.ops._build import BUILD_DIR

    def stamp(model):
        return os.stat(os.path.join(
            BUILD_DIR, f"libfused_step_{model.name}.so")).st_mtime_ns

    t_phase = time.perf_counter()
    n, t = GEN_SIZE
    out = {}
    torch_forms = generated_models(dev)
    with FusedRuns("33", card, zero_counts, counts, n, t) as runs:
        one_run, line = runs.run, runs.line
        # (a) stochastic volatility, fused (generated) vs the general
        # driver on the same model, over the same keys.
        run_f, work = E.build_sv(n, t, device=dev)
        run_g, _ = E.build_sv(n, t, fused=False, device=dev)
        run_f(random.key(99, device=dev))          # warm-up
        t0 = time.perf_counter()
        fused_model.cuda_model(*E.sv_model(), dev)
        generate_ms = (time.perf_counter() - t0) * 1e3
        sv = runs.against_general("a sv", run_f, run_g, gen["sv"].name,
                                  GEN_SV_KEYS, 100, dev)
        m_f = sum(sv["log_z_fused"]) / GEN_SV_KEYS
        m_g = sum(sv["log_z_general"]) / GEN_SV_KEYS
        print(f"[33 a sv] {card}: mean log Z over {GEN_SV_KEYS} keys fused "
              f"(generated) {m_f:.5f} vs general driver {m_g:.5f}: |diff| "
              f"{sv['diff']:.3g}, 4 se "
              f"{4 * sv['se']:.3g}; particle-steps/s {sv['rates']}; each "
              f"run traces the model, {generate_ms:.2f} ms", flush=True)
        out["sv"] = {k: sv[k] for k in ("log_z_fused", "log_z_general",
                                        "se", "particle_steps_per_s",
                                        "launches")}
        out["sv"]["generate_ms"] = generate_ms
        # (b) the linear lambdas against Kalman; then other constants:
        # the same source, so the same library, and no build.
        a, q, r = GEN_LINEAR
        ys = E.linear_observations(t, 0, a, q, r)
        want = E.kalman_loglik(ys, a, q, r, p0=q)
        run_b = E.build_linear_fused(n, ys, a, q, r, device=dev,
                                     header=False)
        run_b(random.key(99, device=dev))
        z, wall, got = one_run("linear", run_b, random.key(314159, device=dev),
                               gen["linear"].name)
        check(abs(z - want) < GEN_LINEAR_BOUND,
              f"phase 33 linear: log Z {z} vs Kalman {want}")
        line("b linear", z, wall, got, f"; Kalman {want:.5f}, |err| "
             f"{abs(z - want):.4g} (bound {GEN_LINEAR_BOUND})")
        built = stamp(gen["linear"])
        a2, q2, r2 = GEN_LINEAR_OTHER
        t0 = time.perf_counter()
        other = fused_model.cuda_model(*E.linear_model(a2, q2, r2), dev)
        fs.build(other.name)
        regen_s = time.perf_counter() - t0
        check(other.name == gen["linear"].name
              and other.params != gen["linear"].params,
              "phase 33 linear: other constants changed the source")
        ys2 = E.linear_observations(t, 1, a2, q2, r2)
        want2 = E.kalman_loglik(ys2, a2, q2, r2, p0=q2)
        run_b2 = E.build_linear_fused(n, ys2, a2, q2, r2, device=dev,
                                      header=False)
        run_b2(random.key(99, device=dev))
        z2, wall2, got2 = one_run("linear other", run_b2,
                                  random.key(314160, device=dev), other.name)
        check(stamp(gen["linear"]) == built,
              "phase 33 linear: other constants rebuilt the library")
        check(abs(z2 - want2) < GEN_LINEAR_BOUND,
              f"phase 33 linear other: log Z {z2} vs Kalman {want2}")
        line(f"b linear a,q,r={GEN_LINEAR_OTHER}", z2, wall2, got2,
             f"; Kalman {want2:.5f}, |err| {abs(z2 - want2):.4g}; the "
             f"same library (unchanged on disk), generated and loaded in "
             f"{regen_s:.3f} s, no nvcc")
        out["linear"] = {"log_z": z, "kalman": want, "launches": got,
                         "other": {"abc": GEN_LINEAR_OTHER, "log_z": z2,
                                   "kalman": want2, "regen_s": regen_s}}

        # (c) the tracking model's torch form, generated, beside
        # tracking.cuh on the same key.
        run_hand, _ = E.build_pf_fused(n, t, device=dev)
        pf_gen = pf_mod.fused_particle_filter(
            lambda k: random.normal(k, (n,)), *torch_forms["tracking"], n)
        ys_c = E.tracking_observations(t, dev)

        def run_gen(key):
            return pf_gen(key, ys_c)[0].log_z

        run_gen(random.key(99, device=dev))
        key = random.key(0, device=dev)
        z_h, wall_h, got_h = one_run("tracking.cuh", run_hand, key,
                                     E.TRACKING_CUDA.name)
        z_t, wall_t, got_t = one_run("tracking generated", run_gen, key,
                                     gen["tracking"].name)
        check(abs(z_t - z_h) < GEN_TRACKING_BOUND,
              f"phase 33 tracking: generated {z_t} vs tracking.cuh {z_h}")
        line("c tracking.cuh", z_h, wall_h, got_h)
        line("c tracking generated", z_t, wall_t, got_t,
             f"; |log Z - tracking.cuh's| {abs(z_t - z_h):.3g} (bound "
             f"{GEN_TRACKING_BOUND})")
        out["tracking"] = {"log_z": z_t, "log_z_header": z_h,
                           "launches": got_t, "header_launches": got_h}

        # (d) constants the callables read, changed between two runs of
        # one filter: each run generates the model anew, so each is held
        # to its own Kalman, through the library phase 2 built.
        prop, ll, set_constants = live_linear(dev)
        pf_live = pf_mod.fused_particle_filter(
            lambda k: torch.zeros(n, device=k.device), prop, ll, n)
        built = stamp(gen["live"])
        out["live"] = {}
        for i, abc in enumerate((GEN_LINEAR, GEN_LINEAR_OTHER)):
            set_constants(*abc)
            ys = E.linear_observations(t, 2 + i, *abc)
            want = E.kalman_loglik(ys, *abc, p0=abc[1])
            obs = torch.as_tensor(ys, device=dev)
            z, wall, got = one_run(
                f"live {abc}", lambda key: pf_live(key, obs)[0].log_z,
                random.key(271828 + i, device=dev), gen["live"].name)
            check(abs(z - want) < GEN_LINEAR_BOUND,
                  f"phase 33 live a,q,r={abc}: log Z {z} vs Kalman {want}")
            line(f"d live a,q,r={abc}", z, wall, got,
                 f"; Kalman {want:.5f}, |err| {abs(z - want):.4g}")
            out["live"][str(abc)] = {"log_z": z, "kalman": want}
            out["live"]["launches"] = got
        check(stamp(gen["live"]) == built,
              "phase 33 live: new constants rebuilt the library")

    # Each generated kernel a call at 2^20 beside tracking.cuh's, in turns.
    out["timing"] = time_generated(card, "33", {
        "tracking.cuh": (*torch_forms["tracking"], E.TRACKING_CUDA),
        **{f"gen_{k}": (*torch_forms[k], gen[k]) for k in GEN33_MODELS}},
        step_inputs)
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"[33] {card}: phase 33 in {out['phase_s']:.1f} s", flush=True)
    return out


#: Phase 34 (e): the long loops' readings, from the linear-Gaussian
#: model nearest theirs (x' = 0.9 x + 0.15 v, v about 1.9 eps; unit
#: observation noise), and their ensembles' start N(0, sd^2).
GEN_LONG_LINEAR = (0.9, 0.08, 1.0)
GEN_LONG_SD = 0.65


def generated_ops_phase(dev, card: str, zero_counts, counts, gen: dict,
                        step_inputs: tuple) -> dict:
    """Phase 34: the models whose generated headers need bool and int32
    values, rounding and ``logaddexp``, and the heavy-tailed sensor whose
    ``lambert_w_normal`` density unrolls to 81 float constants
    (``GEN34_MODELS``, built in phase 2), through the fused filter at
    config 4's width, each over ``GEN34_KEYS`` keys (the ops model
    ``GEN34_OPS_KEYS``) against the general driver on the same model;
    then one fused run of each long loop (``GEN_LONG_LOOPS``); each run
    counted from 0; then each new kernel's time a call at 2^20 beside
    ``tracking.cuh``'s, in turns."""
    from genjax_torch import entry as E
    from genjax_torch.core import random

    t_phase = time.perf_counter()
    n, t = GEN_SIZE
    forms = generated_models(dev)
    ops_ys = E.quantised_observations(t, seed=1)
    long_ys = E.linear_observations(t, 3, *GEN_LONG_LINEAR)
    builders = {  # in this order: (a) to (d)
        "dynamic_logit": ("a", lambda fused: E.build_dynamic_logit(
            n, t, fused=fused, device=dev)),
        "quantised": ("b", lambda fused: E.build_quantised(
            n, t, fused=fused, device=dev)),
        "ops": ("c", lambda fused: E._build_scalar_filter(
            forms["ops"], 0.0, 1.0, ops_ys, n, fused, dev)),
        "lambert_w": ("d", lambda fused: E.build_lambert_w(
            n, t, fused=fused, device=dev)),
    }
    out = {}
    with FusedRuns("34", card, zero_counts, counts, n, t) as runs:
        for seed, (k, (tag, build)) in enumerate(builders.items()):
            run_f, _ = build(True)
            run_g, _ = build(False)
            keys = GEN34_OPS_KEYS if k == "ops" else GEN34_KEYS
            res = runs.against_general(f"{tag} {k}", run_f, run_g,
                                       gen[k].name, keys, 200 + 100 * seed,
                                       dev)
            m_f = sum(res["log_z_fused"]) / keys
            m_g = sum(res["log_z_general"]) / keys
            print(f"[34 {tag} {k}] {card}: {len(gen[k].params)} float "
                  f"constants; mean log Z over {keys} "
                  f"keys fused (generated) {m_f:.5f} vs general driver "
                  f"{m_g:.5f}: |diff| {res['diff']:.3g}, 4 se "
                  f"{4 * res['se']:.3g}; particle-steps/s {res['rates']}",
                  flush=True)
            out[k] = res
        for seed, k in enumerate(GEN_LONG_LOOPS):
            run_f, _ = E._build_scalar_filter(forms[k], 0.0, GEN_LONG_SD,
                                              long_ys, n, True, dev)
            z, wall, got = runs.run(f"e {k}", run_f,
                                    random.key(700 + seed, device=dev),
                                    gen[k].name)
            runs.line(f"e {k}", z, wall, got,
                      f"; {len(gen[k].params)} float constants")
            out[k] = {"log_z": z, "wall_s": wall, "launches": got}
    out["timing"] = time_generated(card, "34", {
        "tracking.cuh": (E.tracking_propagate, E.tracking_loglik,
                         E.TRACKING_CUDA),
        **{f"gen_{k}": (*forms[k], gen[k])
           for k in (*GEN34_MODELS, *GEN_LONG_LOOPS)}},
        step_inputs)
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"[34] {card}: phase 34 in {out['phase_s']:.1f} s", flush=True)
    return out


def main() -> int:
    started: dict = {}
    try:
        return _main(started)
    finally:
        if started:
            stop_examples(started)


def _main(started: dict) -> int:
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device: this script runs only on the card")
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from concurrent.futures import ThreadPoolExecutor

    import genjax_torch
    from genjax_torch import entry as E
    from genjax_torch.core import random
    from genjax_torch.core.scan import associative_scan, count_combines
    from genjax_torch.inference import ImportanceK, Target
    from genjax_torch.lang.distributions.discrete_hmm import (
        DiscreteHMM, forward_filter, forward_filter_parallel)
    from genjax_torch.ops import (cdf_counts, expand_adaptive as ea,
                                  fused_model, fused_step as fs,
                                  logmatmul as lm)
    from genjax_torch.ops._build import BUILD_DIR

    check("jax" not in sys.modules, "the port imported jax")
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"[1 card] {card}; python {sys.version.split()[0]}, torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}", flush=True)

    clock("2")
    # -- 2. build ---------------------------------------------------------
    # The fused step's libraries: one per hand-written header and one per
    # header generated from phase 33's torch forms.
    t0 = time.perf_counter()
    gen = {k: fused_model.cuda_model(*fns, dev)
           for k, fns in generated_models(dev).items()}
    gen_s = time.perf_counter() - t0

    def timed_build(model):
        t_b = time.perf_counter()
        fs.build(model)
        return time.perf_counter() - t_b

    builds = [cdf_counts.build, lm.build, ea.build,
              *(lambda m=m: timed_build(m.name)
                for m in (E.TRACKING_CUDA, E.LINEAR_CUDA, *gen.values()))]
    with ThreadPoolExecutor(len(builds)) as pool:
        jobs = [pool.submit(b) for b in builds]
        build_s = [job.result() for job in jobs]
    gen_nvcc_s = dict(zip(gen, build_s[5:]))
    nvcc_s = time.perf_counter() - t0
    probe = torch.zeros(4096, device=dev)
    cdf_counts.systematic_cumulative(random.key(1, device=dev), probe, 4096)
    fs.fused_step(random.key(1, device=dev), probe, probe, 0.0,
                  E.tracking_propagate, E.tracking_loglik,
                  cuda_model=E.TRACKING_CUDA)
    torch.cuda.synchronize()
    print(f"[2 build] cdf_counts, logmatmul, expand_adaptive, fused_step x "
          f"(tracking, linear, generated {', '.join(gen)}): {len(builds)} "
          f"nvcc sm_90a in parallel, {nvcc_s:.1f} s (the generated headers "
          f"traced and written in {gen_s:.2f} s; nvcc a generated model, "
          f"in the pool: {gen_nvcc_s}; float constants: "
          f"{ {k: len(m.params) for k, m in gen.items()} }); launched in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    largest = max(gen, key=lambda k: len(gen[k].params))
    print(f"[clock] phase 2: nvcc of the largest header, {largest} "
          f"({len(gen[largest].params)} float constants, read from the "
          f"device): {gen_nvcc_s[largest]:.1f} s in the pool; the build "
          f"done at {time.perf_counter() - T_START:.1f} s", flush=True)

    clock("3")
    # -- 3. cdf kernel vs plain --------------------------------------------
    # The plain version's f32 cumsum drifts by ulps of a total that grows
    # with n: at 2^24 it lands about a dozen destinations from the exact
    # counts, while the kernel sums in double across tiles. There the
    # kernel is held to the float64 counts instead, within the same 4.
    cdf_err, big_n = 0, 1 << 24
    big_err = {"kernel - float64": 0, "plain - float64": 0,
               "kernel - plain": 0}
    cdf_sizes = (1, 4097, 1 << 18, 1 << 19, 1 << 20, 1_000_003, big_n)
    for n in cdf_sizes:
        for regime in ("uniform", "mild", "skewed", "one_hot", "head_tail"):
            lw = lw_regime(regime, n, dev)
            key = random.key(5, device=dev)
            cc = cdf_counts.systematic_cumulative(key, lw, n).long()
            ref = cdf_counts.systematic_cumulative_plain(key, lw, n).long()
            torch.cuda.synchronize()
            counts = torch.diff(cc, prepend=torch.zeros(1, dtype=torch.long,
                                                        device=dev))
            check(int(cc[-1]) == n, f"cdf {regime} n={n}: last != n")
            check(bool((counts >= 0).all()), f"cdf {regime} n={n}: decreasing")
            check(int(counts.sum()) == n, f"cdf {regime} n={n}: sum != n")
            err = int((cc - ref).abs().max())
            if n == big_n:
                ex = float64_counts(key, lw, n)
                for name, diff in (("kernel - float64", cc - ex),
                                   ("plain - float64", ref - ex),
                                   ("kernel - plain", cc - ref)):
                    big_err[name] = max(big_err[name],
                                        int(diff.abs().max()))
                check(big_err["kernel - float64"] <= 4,
                      f"cdf {regime} n={n}: {big_err['kernel - float64']} "
                      f"dests from the float64 counts")
                continue
            check(err <= 4, f"cdf {regime} n={n}: {err} dests from plain")
            cdf_err = max(cdf_err, err)
    # u0 is drawn inside the kernel: with 2^20 equal weights and one
    # destination, the index where the count turns 1 reads u0 to 2^-20,
    # and every operand is exact, so kernel and plain agree bit for bit.
    n = 1 << 20
    flat = torch.zeros(n, device=dev)
    for seed in (3, 4, 5):
        key = random.key(seed, device=dev)
        cc = cdf_counts.systematic_cumulative(key, flat, 1)
        ref = cdf_counts.systematic_cumulative_plain(key, flat, 1)
        check(bool(torch.equal(cc, ref)), f"cdf u0 differs (seed {seed})")
    # The design's device operations per call: the two launches, and no
    # torch reduction before them.
    cdf_ops, cdf_tries = {}, {}
    for n in (1 << 19, 1 << 20):
        lw = random.normal(random.key(7, device=dev), (n,))
        key = random.key(8, device=dev)
        (_, _, _, cdf_ops[n], _), cdf_tries[n] = profiled_ops(
            lambda: cdf_counts.systematic_cumulative(key, lw, n), 10, 2)
        check(cdf_ops[n] == 2,
              f"cdf n={n}: {cdf_ops[n]} device ops per call, not 2")
    sizes = ", ".join(map(str, cdf_sizes))
    print(f"[3 cdf_counts] invariants exact at n = {sizes} in 5 regimes;"
          f" max |kernel - plain| = {cdf_err} dests below 2^24 (bound 4); "
          f"at 2^24, max dests {big_err} (bound 4 on kernel - float64); "
          f"in-kernel u0 equals the plain draw; device ops per call "
          f"{cdf_ops} (design: 2; each profile's: {cdf_tries})", flush=True)

    clock("4")
    # -- 4. fused step vs plain --------------------------------------------
    n = 1 << 20
    seeds = random.key_data(random.fold_in(random.key(314159, device=dev), 3))
    bits = threefry_bits(fs.build(E.TRACKING_CUDA.name), seeds, n)
    ctr = torch.arange(n, dtype=torch.int64, device=dev)
    b0, b1 = random.threefry2x32(seeds[0], seeds[1], ctr,
                                 torch.zeros_like(ctr))
    check(bool((bits[:, 0] == b0).all() & (bits[:, 1] == b1).all()),
          "fused_step threefry words differ from core.random")
    u_k = (bits >> 8).to(torch.float32) * (1.0 / (1 << 24))
    u_p = torch.stack([(b0 >> 8).to(torch.float32),
                       (b1 >> 8).to(torch.float32)], 1) * (1.0 / (1 << 24))
    check(bool((u_k == u_p).all()), "fused_step uniforms differ")
    xs0 = random.normal(random.key(1, device=dev), (n,))
    lw0 = random.normal(random.key(2, device=dev), (n,)) * 0.3
    obs = torch.tensor(2.5, device=dev)
    step_inputs = (seeds, xs0, lw0, obs)
    fused_err = fused_vs_plain("tracking.cuh", E.tracking_propagate,
                               E.tracking_loglik, E.TRACKING_CUDA,
                               step_inputs)
    print("[4 fused_step] threefry words and uniforms bitwise core.random's "
          "at 2^20", flush=True)
    gen_fns = generated_models(dev)
    gen_step_err = {k: fused_vs_plain(
        f"generated {k}", *gen_fns[k], gen[k], step_inputs,
        steps=quantised_steps if k == "quantised" else None,
        bound=(GEN34_BOUND if k in GEN34_MODELS or k in GEN_LONG_LOOPS
               else None)) for k in gen}
    wide = torch.tensor([3e9, -3e9, float("nan")], device=dev)
    print(f"[4 fused_step generated ops] f32 -> int32 of 3e9, -3e9, NaN on "
          f"the card: torch's cast {wide.to(torch.int32).tolist()}, "
          f"on the CPU {wide.cpu().to(torch.int32).tolist()}; the ops "
          f"header's loglik casts an observation out of range and a NaN, "
          f"held to the card's plain version above", flush=True)

    # -- main path: launch counts from here ---------------------------------
    def counts():
        return {"cdf_counts": cdf_counts.systematic_cumulative.launches,
                "fused_step": fs.fused_step.launches,
                "log_matmul": lm.log_matmul.launches,
                "expand_adaptive": ea.expand_adaptive.launches}

    def zero_counts():
        cdf_counts.systematic_cumulative.launches = 0
        fs.fused_step.launches = 0
        fs.fused_step.launches_by_model.clear()
        lm.log_matmul.launches = 0
        ea.expand_adaptive.launches = 0

    zero_counts()

    clock("5")
    # -- 5. SIR through entry() --------------------------------------------
    for k in (64, 1 << 16):
        sir_step, (key,) = E.entry(k_particles=k, device=dev)
        mean, logz = sir_step(key)
        torch.cuda.synchronize()
        # Standard errors from the particles themselves: the
        # self-normalized mean's sqrt(sum w^2 (p - mean)^2), and the
        # delta-method sd(W) / (sqrt(K) mean(W)) of log Z-hat.
        target = Target(E.quickstart_model(), (2.0, 2.0),
                        genjax_torch.C["v"].set(True))
        col = ImportanceK(target, k_particles=k).run_smc(key)
        w = torch.softmax(col.get_log_weights(), 0)
        ps = col.get_particles().get_choices()["p"]
        se_mean = float(torch.sqrt(torch.sum(w * w * (ps - mean) ** 2)))
        big_w = torch.exp(col.get_log_weights().double())
        se_logz = float(big_w.std() / (math.sqrt(k) * big_w.mean()))
        mean, logz = float(mean), float(logz)
        check(math.isfinite(mean) and math.isfinite(logz), "SIR not finite")
        check(abs(mean - 0.6) <= 4 * se_mean,
              f"SIR K={k}: mean {mean} vs 0.6 (se {se_mean})")
        check(abs(logz - math.log(0.5)) <= 4 * se_logz,
              f"SIR K={k}: log Z {logz} vs log 0.5 (se {se_logz})")
        print(f"[5 SIR K={k}] mean={mean:.5f} (0.6, se {se_mean:.2g}) "
              f"logZ={logz:.5f} (log 0.5 = {math.log(0.5):.5f}, "
              f"se {se_logz:.2g})", flush=True)

    clock("6")
    # -- 6. config 4 at 2^20 x 32 -------------------------------------------
    n_part, n_steps = 1 << 20, 32
    run_pf, work = E.build_pf(n_part, n_steps, device=dev)
    run_fused, _ = E.build_pf_fused(n_part, n_steps, device=dev)
    key = random.key(0, device=dev)
    logz, by_run = {}, {}
    for name, run in (("build_pf_fused", run_fused), ("build_pf", run_pf)):
        before = counts()
        logz[name] = float(run(key))
        by_run[name] = {k: v - before[k] for k, v in counts().items()}
        check(math.isfinite(logz[name]), f"config 4 {name}: log Z not finite")
        check(by_run[name]["cdf_counts"] >= 1,
              f"config 4 {name}: the CDF kernel never ran")
    # Launches of the main path: SIR and one run of each driver.
    launches = counts()
    check(launches["log_matmul"] == 0 and launches["expand_adaptive"] == 0,
          f"config 4 launched a kernel of another path: {launches}")
    check(by_run["build_pf_fused"]["fused_step"] == n_steps,
          f"build_pf_fused launched the fused step "
          f"{by_run['build_pf_fused']['fused_step']} times, not {n_steps}")
    # The general driver propagates in plain torch: no fused step.
    check(by_run["build_pf"]["fused_step"] == 0,
          "build_pf launched the fused step")
    # Different normal streams: the two estimates agree statistically.
    # 0.25 is the JAX package's bound at 8192 particles x 12 steps
    # (tests/ops/test_fused_step.py:174); at 2^20 particles it is loose.
    check(abs(logz["build_pf"] - logz["build_pf_fused"]) < 0.25,
          f"config 4: log Z {logz}")
    ys = E.linear_observations()
    want = E.kalman_loglik(ys)
    logz_lin = float(E.build_linear_fused(n_part, ys, device=dev)(
        random.key(314159, device=dev)))
    check(abs(logz_lin - want) < 0.05,
          f"linear model log Z {logz_lin} vs Kalman {want}")
    print(f"[6 config 4] 2^20 x 32: log Z build_pf={logz['build_pf']:.4f} "
          f"build_pf_fused={logz['build_pf_fused']:.4f}; launches per run "
          f"{by_run}; main path (SIR + both runs) {launches}; linear log "
          f"Z={logz_lin:.4f} (Kalman {want:.4f})", flush=True)

    clock("7")
    # -- 7. timings ----------------------------------------------------------
    lw = random.normal(random.key(7, device=dev), (n_part,))
    key = random.key(8, device=dev)
    cdf_ms = cuda_ms(lambda: cdf_counts.systematic_cumulative(key, lw, n_part),
                     50)
    cdf_plain_ms = cuda_ms(
        lambda: cdf_counts.systematic_cumulative_plain(key, lw, n_part), 50)
    xs = xs0.clone()

    def fused_call():
        return fs.fused_step(seeds, xs, lw0, obs, E.tracking_propagate,
                             E.tracking_loglik, cuda_model=E.TRACKING_CUDA)

    # Events time follows the host where the host is the slower side: the
    # best of three rounds, and each wrapper's host time a call beside it
    # (the CDF wrapper, unchanged since PR 3, as this host's yardstick).
    fused_ms = min(cuda_ms(fused_call, 200) for _ in range(3))
    fused_host = host_ms(fused_call, 200)
    cdf_host = host_ms(
        lambda: cdf_counts.systematic_cumulative(key, lw, n_part), 200)
    fused_plain_ms = cuda_ms(lambda: fs.fused_step_plain(
        seeds, xs, lw0, obs, E.tracking_propagate, E.tracking_loglik), 20)
    busy, ops_per_call = {}, {}
    for name, fn, reps in (
        ("cdf_counts", lambda: cdf_counts.systematic_cumulative(key, lw,
                                                                n_part), 50),
        ("cdf_counts_plain", lambda: cdf_counts.systematic_cumulative_plain(
            key, lw, n_part), 20),
        ("fused_step", fused_call, 50),
        ("fused_step_plain", lambda: fs.fused_step_plain(
            seeds, xs, lw0, obs, E.tracking_propagate, E.tracking_loglik),
         20),
    ):
        if name == "fused_step":
            res, tries = profiled_ops(fn, reps, 1)
        else:
            res, tries = profiled(fn, reps), None
        _, busy[name], per_kernel, ops_per_call[name], _ = res
        print(f"[7 profile {name}] {card}: device busy "
              f"{round(busy[name], 5)}"
              f" ms per call, {ops_per_call[name]:.0f} device ops a call"
              f"{f' (each profile: {tries})' if tries else ''}; "
              f"{top(per_kernel)}", flush=True)
    check(ops_per_call["fused_step"] == 1,
          f"fused_step: {ops_per_call['fused_step']} device ops a call, not 1")
    print(f"[7 kernels] {card}: cdf_counts {cdf_ms:.4f} ms (plain "
          f"{cdf_plain_ms:.4f} ms); "
          f"fused_step {fused_ms:.4f} ms events (best of 3 x 200 calls), "
          f"{busy['fused_step']} ms device, {ops_per_call['fused_step']:.0f} "
          f"device op a call (plain {fused_plain_ms:.4f} ms) at 2^20, CUDA "
          f"events per call; host time a call: fused_step {fused_host:.4f} "
          f"ms, cdf_counts {cdf_host:.4f} ms", flush=True)
    rates = {}
    for name, run in (("build_pf", run_pf), ("build_pf_fused", run_fused)):
        run(random.key(1, device=dev))
        torch.cuda.synchronize()
        reps = 3
        t0 = time.perf_counter()
        for i in range(reps):
            run(random.key(10 + i, device=dev))
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) / reps
        rates[name] = work / dt
        wall, dbusy, per_kernel, ops, launch_ms = profiled(
            lambda: run(random.key(20, device=dev)), 1)
        idle = 1.0 - dbusy / wall
        print(f"[7 {name}] {card}: {dt * 1e3:.2f} ms per 2^20 x 32 run, "
              f"{rates[name]:.4g} particle-steps/s; profiled run "
              f"{wall:.2f} ms, device busy {dbusy} ms, idle share {idle}, "
              f"{ops:.0f} device ops, {launch_ms:.2f} ms of host time in "
              f"kernel-launch calls; {top(per_kernel, 6)}", flush=True)

    clock("8")
    # -- 8. log_matmul vs plain ---------------------------------------------
    # Tolerance: 1e-5 relative and absolute, the JAX test's
    # (tests/ops/test_logmatmul.py): the kernel and cuBLAS may sum the f32
    # product in other orders, and exp/log are the card's own in both.
    def lm_pair(shape, seed, scale=2.0, shape_y=None):
        ka, kb = random.split(random.key(seed, device=dev)).unbind(-2)
        return (scale * random.normal(ka, shape),
                scale * random.normal(kb, shape_y or shape))

    def lm_check(x, y, label):
        got, want = lm.log_matmul(x, y), lm.log_matmul_plain(x, y)
        torch.cuda.synchronize()
        check(got.shape == want.shape, f"log_matmul {label}: shape")
        diff = (got - want).abs()
        check(bool((diff <= 1e-5 + 1e-5 * want.abs()).all()),
              f"log_matmul {label}: max |kernel - plain| {float(diff.max())}")
        return float(diff.max())

    lm_err = 0.0
    for seed, shape in enumerate(((8, 128, 128), (8, 512, 512),
                                  (8, 1024, 1024), (8, 100, 100),
                                  (8, 200, 200), (128, 128), (100, 100))):
        lm_err = max(lm_err, lm_check(*lm_pair(shape, 40 + seed), shape))
    ms_, _ = lm_pair((9, 256, 256), 50)
    lm_err = max(lm_err, lm_check(ms_[0:-1:2], ms_[1::2], "strided"))
    # K = 101: rows of 404 bytes, not 16-byte aligned (the kernel's
    # planes pad them); scale 30: exponentials down to the subnormals,
    # which the split's 2^32 operand scale keeps off the tensor cores.
    lm_err = max(lm_err, lm_check(*lm_pair((8, 64, 101), 48, 2.0,
                                           (8, 101, 80)), "K=101"))
    lm_err = max(lm_err, lm_check(*lm_pair((8, 256, 256), 49, 30.0),
                                  "scale 30"))
    # More batch entries than a grid's z extent (65535): blocks loop.
    lm_err = max(lm_err, lm_check(*lm_pair((70000, 8, 8), 47), "B=70000"))
    # The parallel filter's first scan level at full width (phase 10's
    # problem): Ms[0:-1:2] x Ms[1::2], read in place.
    s_hmm, t_hmm = 1024, 1024
    run_par, problem = E.build_hmm_parallel(s_hmm, t_hmm, device=dev)
    config, hmm_obs = problem.config, problem.observations
    obs_ll = config.observation_logits[:, hmm_obs].T.contiguous()
    ms_full = config.transition_logits[None] + obs_ll[1:, None, :]
    lm_err = max(lm_err, lm_check(ms_full[0:-1:2], ms_full[1::2],
                                  "path (511, 1024, 1024)"))
    del ms_full
    before = lm.log_matmul.launches
    empty = lm.log_matmul(ms_[:0], ms_[:0])
    check(empty.shape == (0, 256, 256) and lm.log_matmul.launches == before,
          "log_matmul: an empty batch launched")
    big = torch.full((8, 8), -1e30, device=dev)
    out = lm.log_matmul(big, torch.zeros(8, 8, device=dev))
    check(bool(torch.all(torch.isfinite(out) | (out < -1e29))),
          "log_matmul: the -1e30 input")
    lm_check(big, torch.zeros(8, 8, device=dev), "-1e30")
    xi = torch.zeros(4, 4, device=dev)
    xi[1] = -math.inf
    got = lm.log_matmul(xi, torch.zeros(4, 4, device=dev))
    want = lm.log_matmul_plain(xi, torch.zeros(4, 4, device=dev))
    check(bool(torch.equal(torch.isnan(got), torch.isnan(want))
               & torch.isnan(got[1]).all()), "log_matmul: an all -inf row")
    lm_grad = log_matmul_grad_check(dev, card)
    print(f"[8 log_matmul] B=8 at S=128/512/1024, ragged S=100/200, "
          f"K=101, scale 30, B=70000, unbatched, strided, the path's (511, "
          f"1024, 1024): max |kernel - plain| = {lm_err:.3g} (tol 1e-5 + "
          f"1e-5 |plain|); empty batch, no launch; -1e30 finite; an all "
          f"-inf row NaN as in plain", flush=True)

    clock("9")
    # -- 9. expand_adaptive vs plain and repeat_interleave ------------------
    def expand_case(name, n):
        """``(counts_cum, leaf)`` of a case of
        tests/ops/test_expand_adaptive.py at ``n``."""
        idx = torch.arange(n, device=dev)
        leaf = random.normal(random.key(1, device=dev), (n,))
        if name in ("block_boundary", "degenerate_tail"):
            c = torch.zeros(n, dtype=torch.int32, device=dev)
            if name == "block_boundary":        # scaled by n / 1024
                u = n // 1024
                c[0], c[511 * u], c[512 * u] = 300 * u, 212 * u, n - 512 * u
            else:
                g = n // 128
                c[0] = n - (g - 1)
                c[128 * torch.arange(1, g, device=dev)] = 1
            return torch.cumsum(c, 0, dtype=torch.int32), idx.float()
        normal = random.normal(random.key(23, device=dev), (n,))
        lw = {"uniform": torch.zeros(n, device=dev), "mild": normal,
              "skewed": 3.0 * normal, "int32": 2.0 * normal,
              "one_hot": torch.where(idx == 389 * (n // 1024), 0.0, -1e9),
              "two_far": torch.where((idx == 3) | (idx == n - 2), 0.0, -1e9),
              "head_tail": torch.where(idx < 8, 10.0, -2.0)}[name]
        if name == "int32":
            leaf = (random.bits(random.key(2, device=dev), (n,))
                    & 0xFFFFFFFF).to(torch.int32)
        return cdf_counts.systematic_cumulative(
            random.key(23, device=dev), lw, n), leaf

    cases = ("uniform", "mild", "skewed", "one_hot", "two_far", "head_tail",
             "int32", "block_boundary", "degenerate_tail")
    ea_sizes = (1 << 20, (1 << 20) + 37, 1 << 24)
    for n in ea_sizes:
        for name in cases:
            cc, leaf = expand_case(name, n)
            got = ea.expand_adaptive(leaf, cc, n).view(torch.int32)
            plain = ea.expand_adaptive_plain(leaf, cc, n).view(torch.int32)
            rep = torch.repeat_interleave(leaf, torch.diff(
                cc, prepend=cc.new_zeros(1)), output_size=n).view(torch.int32)
            torch.cuda.synchronize()
            check(bool(torch.equal(got, plain))
                  and bool(torch.equal(got, rep)),
                  f"expand_adaptive {name} n={n}: not bitwise the plain "
                  f"version and repeat_interleave")
    n = 1 << 20
    print(f"[9 expand_adaptive] bitwise equal to its plain version and to "
          f"repeat_interleave at n = {', '.join(map(str, ea_sizes))} in "
          f"{len(cases)} cases each: {', '.join(cases)}", flush=True)

    clock("10")
    # -- 10. HMM parallel path at full width --------------------------------
    # circulant(1024, 1024), T = 1024: the top of the TPU kernel's range.
    # Ms alone is (T-1) S^2 4 bytes = 4.3 GB; the scan's levels and the
    # parallel backward sampler's (T-1, S, S) tables are of that size too.
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    z, score, logm_seq = run_par(random.key(7, device=dev))
    torch.cuda.synchronize()
    hmm_launches = counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    combines = count_combines(t_hmm - 1)
    check(hmm_launches["log_matmul"] == combines,
          f"HMM path: {hmm_launches['log_matmul']} log_matmul launches, the "
          f"scan of {t_hmm - 1} makes {combines} non-empty combines")
    check(hmm_launches["cdf_counts"] == hmm_launches["fused_step"]
          == hmm_launches["expand_adaptive"] == 0,
          f"HMM path launched another kernel: {hmm_launches}")
    before = lm.log_matmul.launches
    a_par, m_par = forward_filter_parallel(config, hmm_obs)
    a_seq, m_seq = forward_filter(config, hmm_obs)
    torch.cuda.synchronize()
    check(lm.log_matmul.launches - before == combines,
          "forward_filter_parallel: launches differ from the combine count")
    # Alphas where the filtering probability is above e^-80: below it the
    # max-shift product (the JAX kernel's own formula) is floored where
    # exp underflows in f32, in the JAX package as here. 2e-5 relative, the
    # JAX test's bound between its two filters.
    live = (a_seq - torch.logsumexp(a_seq, -1, keepdim=True)) > -80.0
    d_live = (a_par - a_seq).abs()[live]
    check(bool((d_live <= 2e-5 * a_seq.abs()[live]).all()),
          f"parallel vs sequential alphas: max diff {float(d_live.max())}")
    m_rel = abs(float(m_par) - float(m_seq)) / abs(float(m_seq))
    check(m_rel < 1e-5, f"parallel vs sequential log marginal: rel {m_rel}")
    check(float(m_seq) == float(logm_seq), "sequential filter not repeatable")
    est = DiscreteHMM(use_parallel_filter=True).estimate_logpdf(
        random.key(7, device=dev), z, config, hmm_obs)
    score, est = float(score), float(est)
    check(z.shape == (t_hmm,) and int(z.min()) >= 0
          and int(z.max()) < s_hmm, "HMM path: z out of range")
    check(math.isfinite(score) and abs(score - est) <= 1e-5 * abs(est),
          f"HMM path: score {score} vs estimate_logpdf {est}")
    print(f"[10 hmm parallel] {card}: S={s_hmm} T={t_hmm}: log_matmul "
          f"launches {hmm_launches['log_matmul']} (= {combines} combines); "
          f"alphas "
          f"within 2e-5 rel at the {int(live.sum())} live of {live.numel()} "
          f"entries, max |diff| {float(d_live.max()):.3g}; log marginal "
          f"par {float(m_par):.4f} seq {float(m_seq):.4f} (rel {m_rel:.3g}); "
          f"score {score:.4f} vs estimate_logpdf {est:.4f}; peak device "
          f"memory {peak_gb:.2f} GB", flush=True)
    del a_par, a_seq, d_live, live

    clock("11")
    # -- 11. config 3: HMM SMC at 64 x 64 x 2^19 ---------------------------
    run3, work3, exact3 = E.build_hmm_smc(device=dev)
    zero_counts()
    logz3 = [float(run3(random.key(0, device=dev)))]
    c3_launches = counts()
    check(c3_launches["cdf_counts"] >= 1, "config 3: the CDF kernel never ran")
    check(c3_launches["fused_step"] == c3_launches["log_matmul"]
          == c3_launches["expand_adaptive"] == 0,
          f"config 3 launched another kernel: {c3_launches}")
    logz3 += [float(run3(random.key(i, device=dev))) for i in (1, 2, 3)]
    # Bound: one run's log Z has an sd of ~0.13 at 2^10 particles on the
    # small problem (CPU tests); at 2^19 that scales to well under 0.03,
    # so 0.1 is over 3 sd even on this 8x larger problem.
    err3 = [abs(v - exact3) for v in logz3]
    check(all(math.isfinite(v) for v in logz3) and max(err3) < 0.1,
          f"config 3: log Z {logz3} vs exact {exact3}")
    sd3 = float(torch.tensor(logz3, dtype=torch.float64).std())
    print(f"[11 config 3] 64 x 64 x 2^19: log Z {[round(v, 4) for v in logz3]}"
          f" (keys 0-3; sd {sd3:.4f}) vs exact {exact3:.4f}: max |err| "
          f"{max(err3):.4f} (bound 0.1); launches {c3_launches}", flush=True)

    clock("12")
    # -- 12. expand_adaptive through its entry point -----------------------
    cc = cdf_counts.systematic_cumulative(
        random.key(12, device=dev),
        random.normal(random.key(11, device=dev), (n,)), n)
    leaf = random.normal(random.key(13, device=dev), (n,))
    torch.cuda.synchronize()
    zero_counts()
    out = ea.expand_adaptive(leaf, cc, n)
    torch.cuda.synchronize()
    ea_launches = counts()
    check(ea_launches == {"cdf_counts": 0, "fused_step": 0, "log_matmul": 0,
                          "expand_adaptive": 1},
          f"expand_adaptive entry point: launches {ea_launches}")
    counts_n = torch.diff(cc, prepend=cc.new_zeros(1))
    check(bool(torch.equal(out.view(torch.int32), torch.repeat_interleave(
        leaf, counts_n, output_size=n).view(torch.int32))),
        "expand_adaptive entry point: not repeat_interleave")
    print(f"[12 expand_adaptive] entry point at 2^20: launches {ea_launches}",
          flush=True)

    clock("13")
    # -- 13. timings of the slice ------------------------------------------
    # log_matmul at the first scan level's batch, B = (T-1) // 2 = 511: at
    # S = 1024 on the path's own operands Ms[0:-1:2], Ms[1::2]; at S = 128
    # and 512 on normals. torch.bmm times the f32 product alone.
    lm_rows = {}
    obs_ll = config.observation_logits[:, hmm_obs].T.contiguous()
    ms_full = config.transition_logits[None] + obs_ll[1:, None, :]
    for s_dim, reps in ((128, 20), (512, 10), (1024, 3)):
        if s_dim == s_hmm:
            xa, yb = ms_full[0:-1:2], ms_full[1::2]
        else:
            xa, yb = lm_pair(((t_hmm - 1) // 2, s_dim, s_dim), s_dim, 1.0)
        b_dim = xa.shape[0]
        t_lm = cuda_ms(lambda: lm.log_matmul(xa, yb), reps)
        t_plain = cuda_ms(lambda: lm.log_matmul_plain(xa, yb), reps)
        t_bmm = cuda_ms(lambda: torch.bmm(xa, yb), reps)
        _, dev_lm, per_kernel, _, _ = profiled(
            lambda: lm.log_matmul(xa, yb), reps)
        flop = 2.0 * b_dim * s_dim ** 3
        # The bound of the product as the kernel runs it (split TF32);
        # the f32 FFMA time beside it.
        b_ms, b_by, f32_ms = lm_bound(b_dim, s_dim)
        tc_ms = 3.0 * flop / TF32_OPS_PER_S * 1e3
        lm_rows[s_dim] = {"ms": t_lm, "plain_ms": t_plain, "bmm_ms": t_bmm,
                          "device_ms": dev_lm, "bound_ms": b_ms,
                          "bound_by": b_by, "tc_bound_ms": tc_ms,
                          "f32_bound_ms": f32_ms,
                          "batch": b_dim, "device_by_kernel": per_kernel}
        print(f"[13 log_matmul B={b_dim} S={s_dim}] {card}: kernel "
              f"{t_lm:.4f} ms (device {dev_lm} ms: {top(per_kernel, 3)}), "
              f"plain {t_plain:.4f} ms, torch.bmm (product alone) "
              f"{t_bmm:.4f} ms; bound {b_ms:.4f} ms ({b_by}: "
              f"{12.0 * b_dim * s_dim ** 2:.4g} B at 3.35 TB/s, split TF32 "
              f"3 x {flop:.4g} flop at 495 TFLOP/s {tc_ms:.4f} ms); f32 FFMA "
              f"{f32_ms:.4f} ms at 67 TFLOP/s; kernel at {b_ms / t_lm:.3f} "
              f"of the bound and {f32_ms / t_lm:.3f} of the f32 FFMA time; "
              f"kernel / bmm {t_lm / t_bmm:.3f}", flush=True)
    del ms_full, xa, yb

    ea_ms = cuda_ms(lambda: ea.expand_adaptive(leaf, cc, n), 50)
    ea_plain_ms = cuda_ms(lambda: ea.expand_adaptive_plain(leaf, cc, n), 50)
    # The library call gets the per-source counts ready made (phase 12's
    # counts_n), so that only repeat_interleave itself is timed.
    ea_lib_ms = cuda_ms(lambda: torch.repeat_interleave(
        leaf, counts_n, output_size=n), 50)
    _, ea_dev, per_kernel, _, _ = profiled(
        lambda: ea.expand_adaptive(leaf, cc, n), 50)
    _, ea_lib_dev, _, _, _ = profiled(lambda: torch.repeat_interleave(
        leaf, counts_n, output_size=n), 50)
    ea_bound, ea_by = bound(12.0 * n, 2.0 * 20 * n)
    print(f"[13 expand_adaptive n=2^20] {card}: kernel {ea_ms:.4f} ms "
          f"(device {ea_dev} ms: {top(per_kernel, 2)}), plain "
          f"{ea_plain_ms:.4f} ms, repeat_interleave (counts given) "
          f"{ea_lib_ms:.4f} ms (device {ea_lib_dev} ms); bound "
          f"{ea_bound:.5f} ms ({ea_by}: {12 * n} B); kernel at "
          f"{ea_bound / ea_dev:.3f} of its bound", flush=True)
    # At 2^24 the 201 MB no longer fit the 50 MB L2.
    n_big = 1 << 24
    cc_big = cdf_counts.systematic_cumulative(
        random.key(12, device=dev),
        random.normal(random.key(11, device=dev), (n_big,)), n_big)
    leaf_big = random.normal(random.key(13, device=dev), (n_big,))
    counts_big = torch.diff(cc_big, prepend=cc_big.new_zeros(1))
    _, ea_big_dev, _, _, _ = profiled(
        lambda: ea.expand_adaptive(leaf_big, cc_big, n_big), 10)
    _, ea_big_lib, _, _, _ = profiled(lambda: torch.repeat_interleave(
        leaf_big, counts_big, output_size=n_big), 10)
    ea_big_bound, _ = bound(12.0 * n_big, 0.0)
    del cc_big, leaf_big, counts_big
    print(f"[13 expand_adaptive n=2^24] {card}: kernel device {ea_big_dev} "
          f"ms, repeat_interleave device {ea_big_lib} ms; bound "
          f"{ea_big_bound:.5f} ms (bytes: {12 * n_big} B); kernel at "
          f"{ea_big_bound / ea_big_dev:.3f} of its bound", flush=True)

    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        forward_filter_parallel(config, hmm_obs)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    t0 = time.perf_counter()
    run_par(random.key(8, device=dev))
    torch.cuda.synchronize()
    path_ms = (time.perf_counter() - t0) * 1e3
    filt_flop = 2.0 * s_hmm ** 3 * scan_products(t_hmm - 1)
    filt_bound, _ = bound(0.0, filt_flop)
    filt_tc_bound = 3.0 * filt_flop / TF32_OPS_PER_S * 1e3
    print(f"[13 hmm parallel S={s_hmm} T={t_hmm}] {card}: "
          f"forward_filter_parallel {[round(w, 2) for w in walls]} ms wall "
          f"(3 runs; {scan_products(t_hmm - 1)} products of {s_hmm}^2, "
          f"bound {filt_bound:.2f} ms at the f32 peak, {filt_tc_bound:.2f} "
          f"ms in split TF32); build_hmm_parallel's run (filter + parallel "
          f"FFBS) {path_ms:.2f} ms", flush=True)

    # Where the parallel filter's wall goes, from one profiled run: the
    # log-matmul kernel's prologue and product launches, the scan's
    # cat / _interleave copies, and the rest (the operators' build and
    # the final logsumexp over (T-1, S, S), which is also timed alone).
    f_wall, f_busy, per_kernel, f_ops, f_launch = profiled(
        lambda: forward_filter_parallel(config, hmm_obs), 1)
    split = {"prologue": 0.0, "product": 0.0, "scan copies": 0.0,
             "other": 0.0}
    for name, ms in per_kernel.items():
        part = ("prologue" if "prologue" in name else
                "product" if "product" in name else
                "scan copies" if "Cat" in name or "copy" in name.lower()
                else "other")
        split[part] += ms
    ms_full = config.transition_logits[None] + obs_ll[1:, None, :]
    prefix = associative_scan(lm.log_matmul, ms_full)
    alpha0 = config.prior_logits + obs_ll[0]
    lse_ms = cuda_ms(lambda: torch.logsumexp(
        alpha0[None, :, None] + prefix, dim=1), 3)
    del ms_full, prefix
    print(f"[13 hmm parallel split] {card}: profiled run {f_wall:.2f} ms "
          f"wall, device busy {f_busy} ms, {f_ops:.0f} device ops, "
          f"{f_launch:.2f} ms of host time in kernel-launch calls; device "
          f"ms by part {({k: round(v, 4) for k, v in split.items()})}; the "
          f"final logsumexp alone {lse_ms:.4f} ms (events); "
          f"{top(per_kernel, 6)}", flush=True)

    # The CDF kernel at config 3's and config 4's sizes.
    cdf_rows = {}
    for n_c in (1 << 19, 1 << 20):
        lw_c = random.normal(random.key(7, device=dev), (n_c,))
        key_c = random.key(8, device=dev)
        t_c = cuda_ms(lambda: cdf_counts.systematic_cumulative(
            key_c, lw_c, n_c), 100)
        _, dev_c, per_kernel, ops_c, _ = profiled(
            lambda: cdf_counts.systematic_cumulative(key_c, lw_c, n_c), 50)
        b_c, by_c = bound(8.0 * n_c, 10.0 * n_c)
        cdf_rows[n_c] = {"ms": t_c, "device_ms": dev_c, "bound_ms": b_c,
                         "device_ops": ops_c}
        print(f"[13 cdf_counts n={n_c}] {card}: {t_c:.5f} ms events, "
              f"device {dev_c} ms ({top(per_kernel, 2)}), {ops_c:.0f} "
              f"device ops a call; bound {b_c:.5f} ms ({by_c}: 8 B an "
              f"element), {12.0 * n_c / HBM_BYTES_PER_S * 1e3:.5f} ms for "
              f"this design's 12 B (for comparison, not from this run: the "
              f"five-launch kernel it replaced took 0.02088 ms of device "
              f"time at 2^20 plus the torch max, PERF.md section 6)",
              flush=True)

    run3(random.key(4, device=dev))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(3):
        run3(random.key(5 + i, device=dev))
    torch.cuda.synchronize()
    dt3 = (time.perf_counter() - t0) / 3
    rates["build_hmm_smc"] = work3 / dt3
    wall, dbusy, per_kernel, ops, launch_ms = profiled(
        lambda: run3(random.key(9, device=dev)), 1)
    idle = 1.0 - dbusy / wall
    print(f"[13 build_hmm_smc] {card}: {dt3 * 1e3:.2f} ms per 64 x 64 x 2^19 "
          f"run, {rates['build_hmm_smc']:.4g} particle-steps/s; profiled run "
          f"{wall:.2f} ms, device busy {dbusy} ms, idle share {idle}, "
          f"{ops:.0f} device ops, {launch_ms:.2f} ms of host time in "
          f"kernel-launch calls; {top(per_kernel, 6)}", flush=True)

    # Bounds of the two kernels of the first slice at 2^20: the CDF kernel
    # must read the log-weights and write the counts (8 B a particle, ~10
    # f32 operations); the fused step must read and write the state and
    # the weights (16 B a particle), and run threefry's integer
    # instructions, counted in the SASS of the library's one-counter
    # threefry kernel, on the integer pipe: 64 lanes a clock on each SM at
    # the card's top SM clock.
    cdf_bound, cdf_by = bound(8.0 * n_part, 10.0 * n_part)
    int_ops = sass_int_ops(os.path.join(BUILD_DIR, "libfused_step_"
                                        f"{E.TRACKING_CUDA.name}.so"),
                           "threefry_bits")
    sm_clock_hz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True, timeout=60).stdout.split()[0]) * 1e6
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    int_ops_per_s = 64.0 * n_sm * sm_clock_hz
    fused_bytes_ms = 16.0 * n_part / HBM_BYTES_PER_S * 1e3
    fused_int_ms = int_ops * n_part / int_ops_per_s * 1e3
    fused_bound, fused_by = ((fused_bytes_ms, "bytes")
                             if fused_bytes_ms >= fused_int_ms
                             else (fused_int_ms, "operations"))
    # The same step at 2^22 (four times the blocks): what it adds over
    # 2^20 is the rate of the elementwise work, what 2^20 costs beyond a
    # quarter of it the fixed tail (the statistics and the last block's
    # fold).
    n_4 = 4 * n_part
    xs_4 = random.normal(random.key(1, device=dev), (n_4,))
    lw_4 = random.normal(random.key(2, device=dev), (n_4,)) * 0.3
    _, fused_dev_4, _, _, _ = profiled(lambda: fs.fused_step(
        seeds, xs_4, lw_4, obs, E.tracking_propagate, E.tracking_loglik,
        cuda_model=E.TRACKING_CUDA), 50)
    del xs_4, lw_4
    per_2_20 = (fused_dev_4 - busy["fused_step"]) / 3
    print(f"[13 fused_step n=2^22] {card}: device {fused_dev_4} ms; "
          f"{per_2_20:.5f} ms for each further 2^20, so 2^20 costs "
          f"{busy['fused_step'] - per_2_20:.5f} ms beyond its elementwise "
          f"rate", flush=True)
    print(f"[13 fused_step bound] {card}: bytes {fused_bytes_ms:.5f} ms "
          f"({16 * n_part} B); integer pipe {fused_int_ms:.5f} ms ({int_ops} "
          f"integer instructions a counter in the threefry kernel's SASS, at "
          f"64 lanes x {n_sm} SMs x {sm_clock_hz / 1e9:.3f} GHz); device "
          f"{busy['fused_step']} ms is {fused_bound / busy['fused_step']:.3f} "
          f"of the larger", flush=True)
    # -- 32 (started). the documented programs, beside phases 14-31 --------
    started.update(start_examples())
    print(f"[32 started] {card}: {EXAMPLE_WORKERS} worker processes run the "
          "documented programs on this card and host from here to phase 31: "
          "the walls, rates, idle shares and profiles of phases 14-31 are "
          "contended", flush=True)

    clock("14")
    # -- 14. edits on the card against the CPU ------------------------------
    c6_edit = edits_phase(dev, card)

    clock("15")
    # -- 15. config 6: tempered SMC at 2^19 x 16 x 2 ------------------------
    run6, exact6 = E.build_tempered_smc(device=dev)
    zero_counts()
    res6 = run6(random.key(1, device=dev))
    torch.cuda.synchronize()
    c6_launches = counts()
    logz6, acc6 = float(res6.log_z), float(res6.accept_rate.mean())
    check(c6_launches["cdf_counts"] >= 1,
          "config 6: the CDF kernel never ran")
    check(c6_launches["fused_step"] == c6_launches["log_matmul"]
          == c6_launches["expand_adaptive"] == 0,
          f"config 6 launched another kernel: {c6_launches}")
    check(math.isfinite(logz6) and abs(logz6 - exact6) <= 0.02,
          f"config 6: log Z {logz6} vs closed form {exact6}")
    check(0.0 < acc6 < 1.0, f"config 6: mean acceptance {acc6}")
    ys6 = res6.traces.get_choices()["ys"]
    check(ys6.stride(0) == 0, "config 6: the observations were copied")
    del res6
    prm = (1 << 19) * 16 * 2
    walls6 = []
    for i in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run6(random.key(2 + i, device=dev))
        torch.cuda.synchronize()
        walls6.append(time.perf_counter() - t0)
    dt6 = sorted(walls6)[1]
    rates["build_tempered_smc"] = prm / dt6
    torch.cuda.reset_peak_memory_stats()
    wall, dbusy, per_kernel, ops, launch_ms = profiled(
        lambda: run6(random.key(9, device=dev)), 1)
    peak6 = torch.cuda.max_memory_allocated() / 1e9
    idle6 = 1.0 - dbusy / wall
    mods6 = ops_by_module(lambda: run6(random.key(10, device=dev)))
    torch.cuda.synchronize()
    print(f"[15 config 6] {card}: 2^19 x 16 rungs x 2 moves: log Z "
          f"{logz6:.5f} vs closed form {exact6:.5f} (|err| "
          f"{abs(logz6 - exact6):.5f}, bound 0.02); mean acceptance "
          f"{acc6:.4f}; launches {c6_launches}; wall per run "
          f"{[round(w * 1e3, 2) for w in walls6]} ms (median "
          f"{dt6 * 1e3:.2f} ms), {rates['build_tempered_smc']:.4g} "
          f"particle-rung-moves/s; profiled run {wall:.2f} ms, device busy "
          f"{dbusy} ms, idle share {idle6}, {ops:.0f} device ops, "
          f"{launch_ms:.2f} ms of host time in kernel-launch calls, peak "
          f"device memory {peak6:.2f} GB; {top(per_kernel, 6)}; PyTorch ops "
          f"dispatched a run by the module that issued them {mods6}",
          flush=True)

    clock("16")
    # -- 16. hmm_model through Scan at 64 x 64 x 2^19 -----------------------
    hmm_phase(dev, card)

    clock("17")
    # -- 17-18. gradient MCMC: configs 2 and 8 ------------------------------
    nuts = {"config_2": nuts_regression_phase(dev, card, zero_counts, counts)}
    clock("18")
    nuts["config_8"] = nuts_logreg_phase(dev, card, zero_counts, counts)

    clock("19")
    # -- 19-20. the switch-and-models slice ---------------------------------
    slds = slds_phase(dev, card, zero_counts, counts)
    clock("20")
    mixture = mixture_phase(dev, card, zero_counts, counts)

    clock("21")
    # -- 21-23. the particle-samplers slice ---------------------------------
    config7 = smc2_phase(dev, card, zero_counts, counts)
    clock("22")
    trace_level = trace_phase(dev, card, zero_counts, counts)
    clock("23")
    gensp = gensp_phase(dev, card)

    clock("24")
    # -- 24-27. ADEV and VI, SVGD, parallel tempering, MAP / Laplace -------
    config5 = adev_vi_phase(dev, card, zero_counts, counts)
    clock("25")
    config9 = bnn_vi_phase(dev, card, zero_counts, counts)
    clock("26")
    config10 = svgd_phase(dev, card, zero_counts, counts)
    clock("27")
    pt_map = pt_map_phase(dev, card, zero_counts, counts)

    clock("28")
    # -- 28. the distributed layer over NCCL -------------------------------
    dist28 = distributed_phase(dev, card, zero_counts, counts)
    base28 = dist28["config_4_sharded"]["baseline"]["launches"]

    clock("29")
    # -- 29. the distribution library, the gamma-Poisson SIR, scale NUTS --
    dist29 = distributions_phase(dev, card, zero_counts, counts)
    gp29 = dist29["gamma_poisson_sir"]["launches"]

    clock("30")
    # -- 30. per-execution HMM problems and edits, fine-grained edits ------
    slice30 = batched_slice_phase(dev, card, zero_counts, counts)

    clock("31")
    # -- 31. sharded SMC², PT and PGAS; elastic recovery; profile_trace ----
    shard31 = sharded_samplers_phase(dev, card, zero_counts, counts, {
        "smc2": config7.pop("_result"), "pt": pt_map["pt"].pop("_result")})
    el31 = shard31["elastic"]

    clock("32")
    # -- 32. the documented programs on the card ----------------------------
    ex32 = examples_phase(card, started)

    clock("33")
    # -- 33. models with no hand-written header, fused at config 4's width -
    gen33 = generated_phase(dev, card, zero_counts, counts, gen,
                            step_inputs)

    clock("34")
    # -- 34. generated models with bool and int32 values, fused ------------
    gen34 = generated_ops_phase(dev, card, zero_counts, counts, gen,
                                step_inputs)
    clock("end")
    ex32_launches = {k: sum(o["launches"][k]
                            for o in ex32["programs"].values())
                     for k in ("fused_step", "log_matmul", "expand_adaptive")}
    cdf31 = (el31["clean_launches"]["cdf_counts"]
             + el31["hurt_launches"]["cdf_counts"])
    hb30 = slice30["hmm_batch"]
    lm_batch = sum(hb30[k]["launches"]["log_matmul"]
                   for k in ("observations", "observations_and_config"))
    row30 = hb30.pop("kernel_row")
    lm_rows[f"{HMM_BATCH[1]}x{row30['batch']}"] = row30

    lm_main = lm_rows[s_hmm]
    record = {"kernels": [
        {"name": "cdf_counts", "route": "cuda",
         "source": "genjax_torch/csrc/cdf_counts.cu",
         "replaces": "genjax_tpu/ops/cdf_counts.py:175",
         "launches": (launches["cdf_counts"] + c3_launches["cdf_counts"]
                      + c6_launches["cdf_counts"] + slds["cdf_launches"]
                      + mixture["sir_launches"]["cdf_counts"]
                      + trace_level["trace_pf"]["launches"]["cdf_counts"]
                      + trace_level["data_smc"]["launches"]["cdf_counts"]
                      + base28["cdf_counts"] + gp29["cdf_counts"]
                      + cdf31 + ex32["cdf_launches"]),
         "launches_by_run": {
             **{k: v["cdf_counts"] for k, v in by_run.items()},
             "config_4_path": launches["cdf_counts"],
             "build_hmm_smc": c3_launches["cdf_counts"],
             "build_tempered_smc": c6_launches["cdf_counts"],
             "build_slds_rbpf": slds["cdf_launches"],
             "build_switch_mixture_sir": mixture["sir_launches"][
                 "cdf_counts"],
             "build_smc2": config7["launches"]["cdf_counts"],
             "build_trace_pf": trace_level["trace_pf"]["launches"][
                 "cdf_counts"],
             "build_data_smc": trace_level["data_smc"]["launches"][
                 "cdf_counts"],
             "build_sharded_pf_baseline": base28["cdf_counts"],
             "build_gamma_poisson_sir": gp29["cdf_counts"],
             "build_elastic_pf": cdf31,
             "documented_programs": {
                 n: o["launches"]["cdf_counts"]
                 for n, o in ex32["programs"].items()}},
         "max_abs_err": cdf_err,
         "ms": cdf_ms, "plain_ms": cdf_plain_ms,
         "bound_ms": cdf_bound, "bound_by": cdf_by, "library_ms": None,
         "device_ms": busy["cdf_counts"], "host_ms": cdf_host,
         "plain_device_ms": busy["cdf_counts_plain"],
         "device_ops_per_call": cdf_ops[n_part], "by_size": cdf_rows},
        {"name": "fused_step", "route": "cuda",
         "source": "genjax_torch/csrc/fused_step.cu",
         "models": ["genjax_torch/csrc/models/tracking.cuh",
                    "genjax_torch/csrc/models/linear.cuh"],
         "replaces": "genjax_tpu/ops/fused_step.py:215",
         "launches": launches["fused_step"] + ex32_launches["fused_step"],
         "launches_by_run": {
             **{k: v["fused_step"] for k, v in by_run.items()},
             "documented_programs": ex32_launches["fused_step"]},
         "max_abs_err": fused_err,
         "ms": fused_ms, "plain_ms": fused_plain_ms,
         "bound_ms": fused_bound, "bound_by": fused_by, "library_ms": None,
         "bytes_bound_ms": fused_bytes_ms, "int32_bound_ms": fused_int_ms,
         "int32_ops_per_element": int_ops,
         "device_ms": busy["fused_step"], "host_ms": fused_host,
         "device_ops_per_call": ops_per_call["fused_step"],
         "by_size": {n_4: {"device_ms": fused_dev_4}},
         "plain_device_ms": busy["fused_step_plain"]},
        *({"name": f"fused_step[generated {k}]", "route": "cuda",
           "source": "genjax_torch/csrc/fused_step.cu",
           "models": [f"generated by genjax_torch/ops/fused_model.py from "
                      f"chip_smoke.generated_models(dev)['{k}']"],
           "replaces": "genjax_tpu/ops/fused_step.py:215",
           "launches": gen_out[k]["launches"]["by_model"][gen[k].name],
           "max_abs_err": gen_step_err[k],
           "ms": gen_out["timing"][f"gen_{k}"]["ms"],
           "plain_ms": gen_out["timing"][f"gen_{k}"]["plain_ms"],
           **dict(zip(("bound_ms", "bound_by"), max(
               (fused_bound, fused_by),
               (header_f32_ops(gen[k].name) * n_part / F32_OPS_PER_S * 1e3,
                "operations")))),
           "f32_ops_per_element": header_f32_ops(gen[k].name),
           "library_ms": None,
           "device_ms": gen_out["timing"][f"gen_{k}"]["device_ms"],
           "nvcc_s": gen_nvcc_s[k], "n_params": len(gen[k].params),
           "phase": 33 if k in GEN33_MODELS else 34}
          for k in gen
          for gen_out in ((gen33 if k in GEN33_MODELS else gen34),)),
        {"name": "log_matmul", "route": "cuda",
         "source": "genjax_torch/csrc/logmatmul.cu",
         "replaces": "genjax_tpu/ops/logmatmul.py:61",
         "launches": (hmm_launches["log_matmul"] + lm_batch
                      + ex32_launches["log_matmul"]),
         "launches_by_run": {"build_hmm_parallel": hmm_launches[
             "log_matmul"], "build_hmm_batch": lm_batch,
             "documented_programs": ex32_launches["log_matmul"]},
         "max_abs_err": max(lm_err, row30["max_abs_err"]),
         "ms": lm_main["ms"], "plain_ms": lm_main["plain_ms"],
         "bound_ms": lm_main["bound_ms"], "bound_by": lm_main["bound_by"],
         "tc_bound_ms": lm_main["tc_bound_ms"],
         "f32_bound_ms": lm_main["f32_bound_ms"],
         "library_ms": None, "product_only_bmm_ms": lm_main["bmm_ms"],
         "gradient": lm_grad,
         "device_ms": lm_main["device_ms"],
         "shape": [lm_main["batch"], s_hmm, s_hmm],
         "by_size": lm_rows},
        {"name": "expand_adaptive", "route": "cuda",
         "source": "genjax_torch/csrc/expand_adaptive.cu",
         "replaces": "genjax_tpu/ops/expand_adaptive.py:223",
         "launches": (ea_launches["expand_adaptive"]
                      + ex32_launches["expand_adaptive"]),
         "launches_by_run": {"expand_adaptive": ea_launches[
             "expand_adaptive"],
             "documented_programs": ex32_launches["expand_adaptive"]},
         "max_abs_err": 0,
         "ms": ea_ms, "plain_ms": ea_plain_ms,
         "bound_ms": ea_bound, "bound_by": ea_by, "library_ms": ea_lib_ms,
         "device_ms": ea_dev, "library_device_ms": ea_lib_dev,
         "by_size": {n_big: {"device_ms": ea_big_dev,
                             "library_device_ms": ea_big_lib,
                             "bound_ms": ea_big_bound}}},
    ], "particle_steps_per_s": rates,
        "config_6": {"log_z": logz6, "exact_log_z": exact6,
                     "accept_rate": acc6, "wall_ms": [w * 1e3 for w in walls6],
                     "particle_rung_moves_per_s": rates["build_tempered_smc"],
                     "device_busy_ms": dbusy, "idle_share": idle6,
                     "peak_gb": peak6, "ops_by_module": mods6},
        "edits": c6_edit, "nuts": nuts, "slds_rbpf": slds,
        "switch_mixture": mixture, "config_7": config7,
        "trace_level": trace_level, "gensp": gensp, "config_5": config5,
        "config_9": config9, "config_10": config10,
        "parallel_tempering": pt_map["pt"],
        "map_laplace": pt_map["map_laplace"], "distributed": dist28,
        **dist29, "batched_slice": slice30, "sharded_samplers": shard31,
        "documented_programs": ex32, "generated_models": gen33,
        "generated_ops_models": gen34,
        "clock_s": dict(CLOCK),
        "contended": {"phases": list(range(14, 32)), "by": (
            f"phase 32's pool of {EXAMPLE_WORKERS} worker processes on the "
            "same card and host"), "what": "walls, rates, idle shares and "
            "profiles; checks and launch counts are not affected"}}
    print(card, flush=True)
    print(json.dumps(finite_or_none(record)), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
