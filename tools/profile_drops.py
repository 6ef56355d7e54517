"""Count the device events torch.profiler loses on the CUDA card: profile
the fused step (tracking.cuh at 2^20, 50 calls) as chip_smoke.py's
phase 33 does, ``--profiles`` times, each after 200 calls timed by CUDA
events, and hold each profile's device kernels against the host's
kernel-launch calls and ``key_averages()``.

    python3 tools/profile_drops.py [--profiles 80]

Prints a line for each profile that saw fewer than 50 kernels, then one
JSON line: how many profiles saw each (kernels, launches,
key_averages' device ops).
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--profiles", type=int, default=80)
    args = parser.parse_args()

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke
    from genjax_torch import entry as E
    from genjax_torch.core import random
    from genjax_torch.ops import fused_step as fs

    if not torch.cuda.is_available():
        raise SystemExit("profile_drops: no CUDA device")
    dev, n, calls = torch.device("cuda", 0), 1 << 20, 50
    fs.build(E.TRACKING_CUDA.name)
    seeds = random.key_data(random.fold_in(random.key(314159, device=dev),
                                           3))
    xs = random.normal(random.key(1, device=dev), (n,))
    lw = random.normal(random.key(2, device=dev), (n,)) * 0.3
    obs = torch.tensor(2.5, device=dev)

    def step():
        return fs.fused_step(seeds, xs, lw, obs, E.tracking_propagate,
                             E.tracking_loglik, cuda_model=E.TRACKING_CUDA)

    seen = collections.Counter()
    for i in range(args.profiles):
        chip_smoke.cuda_ms(step, 200)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                step()
            torch.cuda.synchronize()
        events = list(prof.profiler.kineto_results.events())
        kernels = sum(e.device_type() == DeviceType.CUDA for e in events)
        launches = sum("LaunchKernel" in e.name() for e in events)
        averaged = sum(e.count for e in prof.key_averages()
                       if e.device_type == DeviceType.CUDA
                       and e.self_device_time_total)
        seen[(kernels, launches, averaged)] += 1
        if kernels < calls:
            print(f"profile {i}: {kernels} kernels, {launches} launches, "
                  f"key_averages {averaged}", flush=True)
    print(json.dumps({"card": chip_smoke.card_line(), "calls": calls,
                      "profiles": [{"kernels": k, "launches": la,
                                    "key_averages": a, "count": c}
                                   for (k, la, a), c in seen.items()]}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
