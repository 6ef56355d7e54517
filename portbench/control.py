"""Readings from which a cell's limits are set, and the proof that they
hold the control and the planted faults out, at the cell's own size on
the card, in one process:

    python3 portbench/control.py --workload <cell> --seeds 101,102,... \\
        --control-seeds 201,202,203 [--faults state,half,altered] \\
        [--calls 2]

For each of ``--seeds`` it runs ``--calls`` calls of the port on that
seed's keys, as a run's window does, and has the reference judge them
(the lower readings: sound runs). For each of ``--control-seeds`` it puts
the reference in the program's place one precision down (bfloat16) and
has the same judge read it (the upper readings); where the program has
such a path of its own (the cell's ``program_control`` in
``workloads/<cell>.json``: traffic keys that switch it on, as a
bfloat16 state), it runs the program so on the same seeds. For each
fault of ``--faults`` (``lib/faults.py``) and each control seed it runs
one call of the port with the fault planted underneath. Every reading goes
through the limit check of a run (``run.verdict``, the cell's limits in
``workloads/<cell>.json``) and is printed with its ``correct``: sound
runs have to come out correct, the control and each fault not. Prints
one JSON line of every reading. The runs of the benchmark do not run it.
"""

from __future__ import annotations

import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

from portbench import run as bench_run  # noqa: E402


def _seeds(text: str) -> list:
    return [int(s) for s in text.split(",") if s]


def _judged(readings: dict, limits: dict) -> dict:
    correct, _ = bench_run.verdict(readings, limits)
    return dict(readings, correct=correct)


def program_readings(cfg, mix, limits, device, seeds, calls):
    """Each seed's ``calls`` calls, kept as a run's judged calls are."""
    driver, dev, sync = bench_run.prepare(cfg, mix, device, seeds[0])
    try:
        return _program_readings(driver, dev, sync, limits, seeds, calls)
    finally:
        driver.release()


def _program_readings(driver, dev, sync, limits, seeds, calls):
    out = []
    for seed in seeds:
        keys = bench_run.call_keys(seed, calls, dev)
        kept = []
        for i in range(calls):
            driver.record(True)
            res = driver.call(keys[i])
            sync()
            if driver.failed(res):
                out.append({"seed": seed, "correct": False,
                            "failed_call": i})
                break
            kept.append((keys[i].cpu(), driver.keep(res)))
        else:
            out.append(dict(_judged(driver.judge(kept), limits), seed=seed))
    return out


def control_readings(cfg, mix, limits, device, seeds):
    """The reference in bfloat16 in the program's place, one call a
    seed."""
    import torch

    from portbench.lib import plugins

    dev, _ = bench_run.device_of(device)
    driver = plugins.module("drivers", mix["driver"]).Driver(cfg, mix, dev,
                                                             seeds[0])
    out = []
    for seed in seeds:
        key = bench_run.call_keys(seed, 1, dev)[0]
        rec = driver.control(key, torch.bfloat16)
        out.append(dict(_judged(driver.judge([(key.cpu(), rec)]), limits),
                        seed=seed))
    return out


def fault_readings(cfg, mix, limits, device, faults, seeds):
    """One call a seed of the port with each fault planted beneath it."""
    from portbench.lib import faults as planted

    out = []
    for fault in faults:
        undo = planted.plant(fault)
        try:
            for r in program_readings(cfg, mix, limits, device, seeds, 1):
                out.append(dict(r, fault=fault))
        finally:
            undo()
    return out


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", required=True)
    p.add_argument("--faults", default="")
    p.add_argument("--calls", type=int, default=2)
    p.add_argument("--device", default="cuda")
    p.add_argument("--particles", type=int, default=0,
                   help="a smaller ensemble (rehearsals on the CPU)")
    args = p.parse_args(argv)
    bench_run.set_cache_dirs(bench_run.ROOT)
    _, cell, spec, cfg, mix = bench_run.load(args.workload)
    if args.particles:
        mix["particles"] = args.particles
    limits = spec["limits"]
    result = {"cell": cell["name"], "limits": limits,
              "program": program_readings(cfg, mix, limits, args.device,
                                          _seeds(args.seeds), args.calls),
              "control": control_readings(cfg, mix, limits, args.device,
                                          _seeds(args.control_seeds))}
    if spec.get("program_control"):
        result["program_control"] = program_readings(
            cfg, dict(mix, **spec["program_control"]), limits, args.device,
            _seeds(args.control_seeds), args.calls)
    faults = [f for f in args.faults.split(",") if f]
    if faults:
        result["faults"] = fault_readings(cfg, mix, limits, args.device,
                                          faults,
                                          _seeds(args.control_seeds))
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
