"""Run every ported documented program (``genjax_torch/examples``) on the
CUDA card at its documented size, in a pool of worker processes, and
report each one's wall, kernel launches and results.

    python3 tools/examples_on_card.py [--workers 4] [--rehearsal] [--out F]
                                      [--only ex10,ex11]

Prints the card's ``nvidia-smi`` line, one line a program as it ends, the
pool's total wall, and writes everything to ``--out`` (a JSON file).
``--rehearsal`` runs the programs that define ``REHEARSAL`` sizes at
those sizes instead; ``--only`` runs only the named programs. The
programs run beside each other (one intra-op thread a worker), so a wall
is the program's under the others' load."""

import argparse
import concurrent.futures as cf
import json
import multiprocessing
import os
import subprocess
import sys
import time
import traceback

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def one(name: str, rehearsal: bool) -> dict:
    import importlib

    import torch

    torch.set_num_threads(1)
    from genjax_torch.examples import module_name, run_program

    sizes = getattr(importlib.import_module(module_name(name)), "REHEARSAL",
                    None) if rehearsal else None
    t = time.perf_counter()
    try:
        out = run_program(name, device="cuda", sizes=sizes)
        out["ok"] = True
    except Exception:
        out = {"ok": False, "error": traceback.format_exc()[-3000:]}
    out["sizes"] = sizes or "documented"
    out["proc_wall_s"] = time.perf_counter() - t
    return out


def main() -> int:
    sys.path.insert(0, REPO)
    ap = argparse.ArgumentParser()
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--rehearsal", action="store_true")
    ap.add_argument("--out", default="examples_on_card.json")
    ap.add_argument("--only", default="")
    args = ap.parse_args()
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout,
        flush=True)
    from genjax_torch.examples import COOKBOOK, EXAMPLES
    from genjax_torch.ops import cdf_counts, expand_adaptive, logmatmul

    # Build the kernels once, before the workers load them.
    cdf_counts.build()
    expand_adaptive.build()
    logmatmul.build()
    first = ("ex12_particle_gibbs", "ex11_constrained_nuts",
             "ex13_parameter_inference", "ex03_nuts_regression",
             "ex15_svgd_and_slice", "ex10_state_space_vi")
    names = sorted(EXAMPLES + COOKBOOK, key=lambda n: n not in first)
    if args.only:
        only = args.only.split(",")
        names = [n for n in names if n in only or n.split("_")[0] in only]
    res = {}
    t0 = time.perf_counter()
    ctx = multiprocessing.get_context("spawn")
    with cf.ProcessPoolExecutor(args.workers, mp_context=ctx) as pool:
        futs = {pool.submit(one, n, args.rehearsal): n for n in names}
        for f in cf.as_completed(futs):
            n = futs[f]
            r = res[n] = f.result()
            print(n, r["ok"], r["sizes"], round(r.get("wall_s", -1), 2),
                  r.get("launches"),
                  json.dumps(r.get("result"), default=str)[:400],
                  r.get("error", ""), flush=True)
    total = time.perf_counter() - t0
    print("pool wall", total, flush=True)
    with open(args.out, "w") as fh:
        json.dump({"programs": res, "pool_wall_s": total,
                   "workers": args.workers}, fh, default=str, indent=1)
    return 0 if all(r["ok"] for r in res.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
