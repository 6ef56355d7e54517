"""The port's benchmark: one run of one cell.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. A cell (``BENCHMARK.json``'s ``workloads``,
and ``portbench/workloads/<cell>.json`` for its limits) names a
configuration (``portbench/configs/<config>.json`` with its plain
reference ``<config>.py``) and a traffic mix (``portbench/traffic/<mix>
.json``: the sizes and settings of the load, and the driver that puts
it on the port, ``portbench/drivers/<driver>.py``). Everything is found
by name: a new cell is new files.

A run sets up (imports, the port's kernel libraries built or loaded,
inputs made from the seed, the cell's shapes warmed up), then calls the
port one call after another for ``--seconds`` (closed loop, each call
ending in ``torch.cuda.synchronize()``). The calls the judge reads are
drawn from the seed before the window opens, among its first
``checked_within``; after each of them, what it kept is moved to the
host, with the window's clock stopped, and once the last is off the
card the device's memory peak is taken afresh, so that the peak is the
port's and not the harness's. With ``--trace 1`` it then profiles a few
more calls and counts what one call dispatches, and reads the cell's
per-layer metrics (``metrics/<name>.py``); with ``--trace 0`` it
reports the end-to-end metrics. Once the window has closed and the
port's state is freed, a reference written in plain PyTorch
(``reference/``, ``configs/<config>.py``) judges the drawn calls;
``correct`` holds when every number it reads is within its limit
(:func:`verdict`). The last line of standard output is the result.

It exits with another code than 0 and prints no result when there is no
CUDA device (or fewer than the cell needs), when the port cannot be
imported, and when JAX or the JAX package is loaded at the end.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import random  # noqa: E402
import sys  # noqa: E402
from statistics import fmean  # noqa: E402
from types import SimpleNamespace  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

#: Top-level module names that no run may hold once its window closed.
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "genjax_tpu"})
#: Keys drawn for the window's calls (a call takes the next one).
MAX_CALLS = 1 << 15
#: Profiles of the traced calls taken before a metric that found nothing
#: to read is left out.
TRACE_TRIES = 3


def forbidden_modules(names=None) -> list:
    """The forbidden top-level names among ``names`` (default: the loaded
    modules), each compared whole: ``genjax_torch`` is not
    ``genjax_tpu``."""
    names = sys.modules if names is None else names
    return sorted({m.split(".")[0] for m in names} & FORBIDDEN)


def set_cache_dirs(root: str):
    """Fixed build and kernel-cache directories inside the checkout (the
    port builds its own libraries into ``genjax_torch/_build/``)."""
    cache = os.path.join(root, ".portbench_cache")
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = os.path.join(cache, sub)


def _say(*parts):
    print(*parts, file=sys.stderr, flush=True)


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def load(cell_name: str, overrides: dict | None = None):
    """``(bench, cell, spec, cfg, mix)`` of a cell, found by name, or
    None where ``BENCHMARK.json`` has no such cell."""
    from portbench.lib import plugins

    bench = plugins.manifest(ROOT)
    cells = {w["name"]: w for w in bench["workloads"]}
    if cell_name not in cells:
        return None
    cell = cells[cell_name]
    spec = plugins.data("workloads", cell["name"])
    cfg = plugins.data("configs", cell["config"])
    mix = dict(plugins.data("traffic", cell["traffic"]), **(overrides or {}))
    return bench, cell, spec, cfg, mix


def check_device(cell, require_cuda: bool) -> bool:
    import torch

    if not require_cuda:
        return True
    if not torch.cuda.is_available():
        _say("no CUDA device: the benchmark measures the card")
        return False
    if torch.cuda.device_count() < cell["chips"]:
        _say(f"{cell['chips']} chips asked, "
             f"{torch.cuda.device_count()} present")
        return False
    return True


def device_of(device: str):
    import torch

    dev = torch.device(device, 0) if device == "cuda" else torch.device(device)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    return dev, sync


def prepare(cfg, mix, device: str, seed: int):
    """The cell's driver (``drivers/<mix's driver>.py``) set up:
    ``(driver, dev, sync)``."""
    from portbench.lib import plugins

    dev, sync = device_of(device)
    driver = plugins.module("drivers", mix["driver"]).Driver(cfg, mix, dev,
                                                             seed)
    driver.setup()
    return driver, dev, sync


def call_keys(seed: int, count: int, dev):
    """The calls' keys: ``fold_in(key(seed), i)`` for ``i < count``."""
    import torch

    from portbench.reference import threefry

    return threefry.fold_in(threefry.seed_key(seed)[None, :],
                            torch.arange(count)).to(dev)


def checked_calls(seed: int, mix) -> list:
    """The window's calls that the judge reads, drawn from the seed
    before the window opens: ``checked_calls`` of its first
    ``checked_within``."""
    within = int(mix.get("checked_within", 8))
    k = min(int(mix.get("checked_calls", 2)), within)
    return sorted(random.Random(seed).sample(range(within), k))


def verdict(readings: dict, limits: dict, failed: int = 0):
    """``(correct, checks)``: every reading within its limit (a reading
    with no limit, or one that is not a number, fails), no call failed,
    and something was read. ``checks`` gives each number beside its
    limit."""
    checks, correct = {}, failed == 0 and bool(readings)
    for name, value in readings.items():
        limit = limits.get(name)
        ok = limit is not None and value <= limit
        correct = correct and ok
        checks[name] = {"value": value if math.isfinite(value) else None,
                        "limit": limit}
    checks["failed_calls"] = {"value": failed, "limit": 0}
    return correct, checks


def run(argv=None, *, require_cuda: bool = True, device: str = "cuda",
        overrides: dict | None = None):
    """One run. Returns ``(exit code, result or None)`` and prints the
    result's line. ``require_cuda``, ``device`` and ``overrides`` (traffic
    keys) serve the benchmark's own tests on the CPU."""
    args = parse(argv)
    set_cache_dirs(ROOT)
    loaded = load(args.workload, overrides)
    if loaded is None:
        _say(f"no cell {args.workload!r} in BENCHMARK.json")
        return 2, None
    bench, cell, spec, cfg, mix = loaded

    import torch

    _say(f"[setup] torch imported {time.perf_counter() - T0:.3f}")
    torch.set_num_threads(1)
    if not check_device(cell, require_cuda):
        return 2, None
    try:
        import genjax_torch  # noqa: F401
    except ImportError as err:
        _say(f"the port does not import here: {err}")
        return 2, None

    _say(f"[setup] port imported {time.perf_counter() - T0:.3f}")
    driver, dev, sync = prepare(cfg, mix, device, args.seed)
    _say(f"[setup] built {time.perf_counter() - T0:.3f}")
    try:
        return _measure(args, bench, cell, spec, cfg, mix, driver, dev, sync)
    finally:
        driver.release()


def _measure(args, bench, cell, spec, cfg, mix, driver, dev, sync):
    """Warm-up, the window, the traced calls and the judge of one run."""
    import torch

    from portbench.lib import plugins, profile

    warm = int(mix.get("warmup_calls", 2))
    table = call_keys(args.seed, MAX_CALLS + warm, dev)
    for j in range(warm):
        driver.call(table[MAX_CALLS + j])
        sync()
        _say(f"[setup] warm-up call {j} {time.perf_counter() - T0:.3f}")
    setup_s = time.perf_counter() - T0
    _say(f"setup_s {setup_s!r}")

    # -- the window ------------------------------------------------------
    checked = checked_calls(args.seed, mix)
    kept, walls, failed, paused = [], [], 0, 0.0
    gc.collect()
    start = time.perf_counter()
    while True:
        i = len(walls)
        if i >= MAX_CALLS:
            raise RuntimeError("the window outran its keys")
        driver.record(i in checked)
        t0 = time.perf_counter()
        out = driver.call(table[i])
        sync()
        t1 = time.perf_counter()
        walls.append(t1 - t0)
        failed += int(driver.failed(out))
        if i in checked:
            kept.append((table[i].cpu(), driver.keep(out)))
        del out
        if i in checked:
            if i == checked[-1] and dev.type == "cuda":
                torch.cuda.reset_peak_memory_stats(dev)
            paused += time.perf_counter() - t1
        if time.perf_counter() - start - paused >= args.seconds \
                and i >= checked[-1]:
            break
    span_s = time.perf_counter() - start - paused
    window = SimpleNamespace(walls=walls, calls=len(walls), span_s=span_s,
                             work=driver.work * len(walls),
                             resamples=fmean(len(r.events) for _, r in kept))
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    _say(f"[window] {len(walls)} calls in {span_s:.3f} s, the judged calls "
         f"{checked} kept in {paused:.3f} s off the clock")

    ctx = SimpleNamespace(cell=cell["name"], cfg=cfg, mix=mix,
                          work=plugins.module("work", cell["config"]),
                          window=window, setup_s=setup_s, driver=driver,
                          profile=None, ops=None, steps=driver.steps)
    section = "per_layer" if args.trace else "end_to_end"
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": (torch.cuda.get_device_name(dev)
                            if dev.type == "cuda" else "cpu"),
                   "count": cell["chips"], "memory_peak_bytes": int(peak)}
    breakdown = None
    if args.trace:
        n_next = [len(walls)]

        def one_call():
            driver.record(False)
            driver.call(table[n_next[0]])
            n_next[0] += 1

        ctx.ops = profile.ops_by_module(lambda: (one_call(), sync()))
        n_prof = int(mix.get("trace_calls", 3))
        # A profile that lost device events leaves a kernel's metric
        # unread: take it again, as a profile that saw none is.
        for _ in range(TRACE_TRIES):
            ctx.profile = profile.profile_calls(one_call, n_prof, sync)
            metrics = read_metrics(bench, section, cell, ctx)
            if len(metrics) == len(plugins.cell_metrics(bench, section,
                                                        cell["name"])):
                break
            _say("[profiler] a metric found nothing to read: profiling again")
        device_info["busy_s"] = profile.busy_ns(ctx.profile.events) / 1e9
        device_info["window_s"] = ctx.profile.wall_s
        breakdown = _breakdown(ctx.profile, profile)
    else:
        metrics = read_metrics(bench, section, cell, ctx)

    # -- the judge -------------------------------------------------------
    driver.release()
    del ctx
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_judge = time.perf_counter()
    readings = driver.judge(kept)
    _say(f"[judge] {len(kept)} calls in "
         f"{time.perf_counter() - t_judge:.3f} s")

    found = forbidden_modules()
    if found:
        _say("forbidden modules loaded: " + ", ".join(found))
        return 3, None
    correct, checks = verdict(readings, spec["limits"], failed)
    result = {"correct": correct, "attempted": len(walls), "failed": failed,
              "metrics": metrics, "device": device_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    for name, c in checks.items():
        _say(f"check {name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0, result


def read_metrics(bench, section: str, cell, ctx) -> dict:
    """The cell's metrics of ``section`` that their readers found."""
    from portbench.lib import plugins

    out = {}
    for m in plugins.cell_metrics(bench, section, cell["name"]):
        value = plugins.module("metrics", m["name"]).read(ctx)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def _breakdown(prof, profile) -> dict:
    """The device ops that took most time over the profiled calls, by
    kernel, and the longest idle stretches of the device, each labelled
    by the host op running when it began and the device op that ended
    it."""
    by = {}
    for name, _, d in prof.events:
        by[name] = by.get(name, 0) + d
    ops = sorted(by.items(), key=lambda kv: -kv[1])[:10]
    start, stop = prof.span_ns()
    gaps = profile.idle_gaps(prof.events, start, stop)[:10]
    return {"device_ops": [[n[:160], ns / 1e9] for n, ns in ops],
            "idle_gaps": [[(profile.host_op_at(prof.host, s) + " -> "
                            + nxt)[:160], ln / 1e9] for s, ln, nxt in gaps]}


def main(argv=None) -> int:
    code, _ = run(argv)
    return code


if __name__ == "__main__":
    sys.exit(main())
