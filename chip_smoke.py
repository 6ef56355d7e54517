"""Drive the PyTorch port's main path once on one CUDA card, check it, and
time its kernels.

    python3 chip_smoke.py

Phases (each prints one line; any failure exits non-zero):
  1. card: name and power limit from nvidia-smi;
  2. build: the CDF->counts kernel (nvcc) and the fused-step kernel
     (Triton), from the sources in the checkout, into genjax_torch/_build/;
  3. the CDF->counts kernel against its plain version at 2^20 and at a
     ragged size, in five weight regimes;
  4. the fused-step kernel against its plain version at 2^20, f32 and
     bf16 state;
  5. SIR through entry() at K = 64 and K = 2^16;
  6. bench config 4 (2^20 particles x 32 steps) through build_pf and
     build_pf_fused, with each run's kernel launch counts, and the
     linear-Gaussian model against its exact Kalman log Z;
  7. timings: each kernel beside its plain version at 2^20, and
     particle-steps/s of both config-4 drivers, with a profiled run's
     device-busy time, device ops and host time in kernel launches.
The last two lines are the kernels' JSON record and the result line.
There is no CPU path: without a CUDA card the script fails.
"""

from __future__ import annotations

import json
import math
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


def profiled(fn, reps: int):
    """Per call of ``fn`` under torch.profiler: ``(wall ms, device-busy
    ms, {kernel: ms}, device ops, host ms in kernel-launch calls)``.
    Device-busy is the summed time of the device ops the calls ran
    (``None`` where the profiler saw no device time)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / reps
    per_kernel, ops, launch_ms = {}, 0, 0.0
    for evt in prof.key_averages():
        if evt.device_type == DeviceType.CUDA and evt.self_device_time_total:
            per_kernel[evt.key] = evt.self_device_time_total / 1e3 / reps
            ops += evt.count
        elif "LaunchKernel" in evt.key:
            launch_ms += evt.cpu_time_total / 1e3
    busy = sum(per_kernel.values()) if per_kernel else None
    return wall, busy, per_kernel, ops / reps, launch_ms / reps


# Names the probe's body resolves when Triton compiles it; bound by
# threefry_bits(), after the card check, because triton imports only there.
tl = _threefry2x32 = None


def _threefry_bits_kernel(seed_ptr, out_ptr, n, BLOCK: tl.constexpr):
    pid = tl.program_id(0)
    offs = pid * BLOCK + tl.arange(0, BLOCK)
    mask = offs < n
    k0 = tl.load(seed_ptr).to(tl.uint32)
    k1 = tl.load(seed_ptr + 1).to(tl.uint32)
    ctr = offs.to(tl.uint32)
    b0, b1 = _threefry2x32(k0, k1, ctr, tl.zeros_like(ctr))
    tl.store(out_ptr + offs * 2, b0.to(tl.int64), mask=mask)
    tl.store(out_ptr + offs * 2 + 1, b1.to(tl.int64), mask=mask)


def threefry_bits(seeds, n: int, block: int = 1024):
    """The two threefry2x32 words the fused-step kernel draws for
    counters ``0..n-1`` (its own ``_threefry2x32``), as int64 ``(n, 2)``,
    so that they can be held bit for bit against ``core.random``."""
    global tl, _threefry2x32
    import torch
    import triton
    import triton.language as tl
    from genjax_torch.ops._fused_step_triton import _threefry2x32

    out = torch.empty((n, 2), dtype=torch.int64, device=seeds.device)
    triton.jit(_threefry_bits_kernel)[(triton.cdiv(n, block),)](
        seeds, out, n, BLOCK=block)
    return out


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
        return torch.where(idx == 12345, 0.0, -1e9)
    return torch.where(idx < 9, 8.0, -2.0)          # head_tail


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device: this script runs only on the card")
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    import genjax_torch
    from genjax_torch import entry as E
    from genjax_torch import triton_models as TM
    from genjax_torch.core import random
    from genjax_torch.inference import ImportanceK, Target
    from genjax_torch.ops import cdf_counts, fused_step as fs

    check("jax" not in sys.modules, "the port imported jax")
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"[1 card] {card}; python {sys.version.split()[0]}, torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}", flush=True)

    # -- 2. build ---------------------------------------------------------
    t0 = time.perf_counter()
    cdf_counts.build()
    probe = torch.zeros(4096, device=dev)
    cdf_counts.systematic_cumulative(random.key(1, device=dev), probe, 4096)
    fs.fused_step(random.key(1, device=dev), probe, probe, 0.0,
                  E.tracking_propagate, E.tracking_loglik,
                  propagate_triton=TM.tracking_propagate,
                  loglik_triton=TM.tracking_loglik)
    torch.cuda.synchronize()
    print(f"[2 build] cdf_counts (nvcc sm_90a) + fused_step (triton) built "
          f"and launched in {time.perf_counter() - t0:.1f} s", flush=True)

    # -- 3. cdf kernel vs plain --------------------------------------------
    cdf_err = 0
    for n in (1 << 20, 1_000_003):
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
    print(f"[3 cdf_counts] invariants exact at n=2^20 and n=1000003 in 5 "
          f"regimes; max |kernel - plain| = {cdf_err} dests (bound 4); "
          f"in-kernel u0 equals the plain draw", flush=True)

    # -- 4. fused step vs plain --------------------------------------------
    n = 1 << 20
    seeds = random.key_data(random.fold_in(random.key(314159, device=dev), 3))
    bits = threefry_bits(seeds, n)
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
    fused_err = 0.0
    # xs/lw: the kernel's sqrt/log1p/cos/exp are the card's own libdevice
    # and approximate instructions, not torch's, so an element may move by
    # a few ulp, amplified by the model (x^2 / 20, then a square): xs to
    # 1e-3 and lw to 1e-2 absolute, on values of order 10 and 100.
    for dtype, tol in ((torch.float32, 1e-3), (torch.bfloat16, 1e-3)):
        xs = xs0.to(dtype)
        out_k = fs.fused_step(seeds, xs, lw0, obs, E.tracking_propagate,
                              E.tracking_loglik,
                              propagate_triton=TM.tracking_propagate,
                              loglik_triton=TM.tracking_loglik,
                              state_dtype=dtype)
        out_p = fs.fused_step_plain(seeds, xs, lw0, obs, E.tracking_propagate,
                                    E.tracking_loglik, state_dtype=dtype)
        torch.cuda.synchronize()
        check(out_k[0].dtype == dtype and out_k[1].dtype == torch.float32,
              "fused_step output dtypes")
        x_err = float((out_k[0].float() - out_p[0].float()).abs().max())
        lw_err = float((out_k[1] - out_p[1]).abs().max())
        # bf16 state: one rounding of x_new either side of a tie.
        x_tol = tol if dtype == torch.float32 else 0.0625
        check(x_err <= x_tol, f"fused_step {dtype} xs err {x_err}")
        check(lw_err <= tol * 10, f"fused_step {dtype} lw err {lw_err}")
        lse_err = abs(float(out_k[2] - out_p[2]))
        ess_rel = abs(float(out_k[3] - out_p[3])) / float(out_p[3])
        check(lse_err < 1e-4, f"fused_step {dtype} lse err {lse_err}")
        check(ess_rel < 1e-4, f"fused_step {dtype} ess rel err {ess_rel}")
        if dtype == torch.float32:
            fused_err = max(x_err, lw_err)
        print(f"[4 fused_step {str(dtype)[6:]}] bits+uniforms bitwise at "
              f"2^20; |dx|={x_err:.3g} |dlw|={lw_err:.3g} "
              f"|dlse|={lse_err:.3g} ess rel={ess_rel:.3g}", flush=True)

    # -- main path: launch counts from here ---------------------------------
    cdf_counts.systematic_cumulative.launches = 0
    fs.fused_step.launches = 0

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

    # -- 6. config 4 at 2^20 x 32 -------------------------------------------
    def counts():
        return {"cdf_counts": cdf_counts.systematic_cumulative.launches,
                "fused_step": fs.fused_step.launches}

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

    # -- 7. timings ----------------------------------------------------------
    lw = random.normal(random.key(7, device=dev), (n_part,))
    key = random.key(8, device=dev)
    cdf_ms = cuda_ms(lambda: cdf_counts.systematic_cumulative(key, lw, n_part),
                     50)
    cdf_plain_ms = cuda_ms(
        lambda: cdf_counts.systematic_cumulative_plain(key, lw, n_part), 50)
    xs = xs0.clone()
    fused_ms = cuda_ms(lambda: fs.fused_step(
        seeds, xs, lw0, obs, E.tracking_propagate, E.tracking_loglik,
        propagate_triton=TM.tracking_propagate,
        loglik_triton=TM.tracking_loglik), 50)
    fused_plain_ms = cuda_ms(lambda: fs.fused_step_plain(
        seeds, xs, lw0, obs, E.tracking_propagate, E.tracking_loglik), 20)
    busy = {}
    for name, fn, reps in (
        ("cdf_counts", lambda: cdf_counts.systematic_cumulative(key, lw,
                                                                n_part), 50),
        ("cdf_counts_plain", lambda: cdf_counts.systematic_cumulative_plain(
            key, lw, n_part), 20),
        ("fused_step", lambda: fs.fused_step(
            seeds, xs, lw0, obs, E.tracking_propagate, E.tracking_loglik,
            propagate_triton=TM.tracking_propagate,
            loglik_triton=TM.tracking_loglik), 50),
        ("fused_step_plain", lambda: fs.fused_step_plain(
            seeds, xs, lw0, obs, E.tracking_propagate, E.tracking_loglik),
         20),
    ):
        _, busy[name], per_kernel, _, _ = profiled(fn, reps)
        print(f"[7 profile {name}] {card}: device busy "
              f"{busy[name] if busy[name] is None else round(busy[name], 5)}"
              f" ms per call; {top(per_kernel)}", flush=True)
    print(f"[7 kernels] {card}: cdf_counts {cdf_ms:.4f} ms (plain "
          f"{cdf_plain_ms:.4f} ms); fused_step {fused_ms:.4f} ms (plain "
          f"{fused_plain_ms:.4f} ms) at 2^20, CUDA events per call", flush=True)
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
        idle = None if dbusy is None else 1.0 - dbusy / wall
        print(f"[7 {name}] {card}: {dt * 1e3:.2f} ms per 2^20 x 32 run, "
              f"{rates[name]:.4g} particle-steps/s; profiled run "
              f"{wall:.2f} ms, device busy {dbusy} ms, idle share {idle}, "
              f"{ops:.0f} device ops, {launch_ms:.2f} ms of host time in "
              f"kernel-launch calls; {top(per_kernel, 6)}", flush=True)

    record = {"kernels": [
        {"name": "cdf_counts", "route": "cuda",
         "source": "genjax_torch/csrc/cdf_counts.cu",
         "replaces": "genjax_tpu/ops/cdf_counts.py:175",
         "launches": launches["cdf_counts"],
         "launches_by_run": {k: v["cdf_counts"] for k, v in by_run.items()},
         "max_abs_err": cdf_err,
         "ms": cdf_ms, "plain_ms": cdf_plain_ms,
         "device_ms": busy["cdf_counts"],
         "plain_device_ms": busy["cdf_counts_plain"]},
        {"name": "fused_step", "route": "triton",
         "source": "genjax_torch/ops/_fused_step_triton.py",
         "replaces": "genjax_tpu/ops/fused_step.py:215",
         "launches": launches["fused_step"],
         "launches_by_run": {k: v["fused_step"] for k, v in by_run.items()},
         "max_abs_err": fused_err,
         "ms": fused_ms, "plain_ms": fused_plain_ms,
         "device_ms": busy["fused_step"],
         "plain_device_ms": busy["fused_step_plain"]},
    ], "particle_steps_per_s": rates}
    print(card, flush=True)
    print(json.dumps(record), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
