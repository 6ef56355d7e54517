"""Time an entry point of the port from a given checkout on the CUDA
card: SIR through ``entry()`` (``--path sir``, K = ``--k``) or config 6
through ``build_tempered_smc()`` (``--path tempered``, 2^19 x 16 x 2).
It reports the wall time of one call (host clock around a call that ends
in a sync; the median and the spread over ``--reps`` calls), a profiled
call's device ops and busy time, and the PyTorch ops one call
dispatches.

    python3 tools/time_entry.py --repo DIR [--path sir] [--k 65536] [--reps 30]

Prints one JSON line. To hold two trees against each other, run it on
each, one after another on the same card: parent, change, change, parent.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--repo", required=True)
    ap.add_argument("--path", choices=("sir", "tempered"), default="sir")
    ap.add_argument("--k", type=int, default=1 << 16)
    ap.add_argument("--reps", type=int, default=30)
    opt = ap.parse_args()
    sys.path.insert(0, os.path.abspath(opt.repo))

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from torch.utils._python_dispatch import TorchDispatchMode

    from genjax_torch import entry as E

    if not torch.cuda.is_available():
        raise SystemExit("time_entry: no CUDA device")
    dev = torch.device("cuda", 0)
    if opt.path == "sir":
        sir_step, (key,) = E.entry(k_particles=opt.k, device=dev)
        run = sir_step
    else:
        tempered, _ = E.build_tempered_smc(device=dev)
        key = E.random.key(0, device=dev)

        def run(k):
            res = tempered(k)
            return res.accept_rate.mean(), res.log_z

    def call():
        out = run(key)
        torch.cuda.synchronize()
        return out

    mean, logz = call()
    walls = []
    for _ in range(opt.reps):
        t0 = time.perf_counter()
        call()
        walls.append((time.perf_counter() - t0) * 1e3)

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        call()
    ops, busy = 0, 0.0
    for evt in prof.key_averages():
        if evt.device_type == DeviceType.CUDA and evt.self_device_time_total:
            ops += evt.count
            busy += evt.self_device_time_total / 1e3

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Count.n += 1
            return func(*args, **(kwargs or {}))

    with Count():
        call()
    print(json.dumps({
        "repo": opt.repo, "path": opt.path,
        "k": opt.k if opt.path == "sir" else 1 << 19, "reps": opt.reps,
        "wall_ms_median": statistics.median(walls),
        "wall_ms_min": min(walls), "wall_ms_max": max(walls),
        "device_ops": ops, "device_busy_ms": busy,
        "dispatched_ops": Count.n,
        # SIR: the posterior mean and log Z; config 6: the mean
        # acceptance and log Z.
        "outputs": [float(mean), float(logz)],
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
