"""Run every ported documented program (``genjax_torch/examples``) on the
CPU at its documented size and record the results as the reference that
the CPU tests hold the JAX programs against and that ``chip_smoke.py``
phase 32 holds the card's runs against.

    python tools/examples_reference.py [--jobs 4] [--only ex03,cb13]

Writes ``genjax_torch/examples/cpu_reference.json``: for each program its
``main(device="cpu")`` dict, its wall on this host's clock, the port's
source files it loaded and their SHA-256 (a test refuses a reference
once one of them changed); for a program with ``REHEARSAL`` sizes, also
the run at those sizes (``rehearsal``). ``--only`` reruns some programs
and keeps the others' entries. Each program runs in a fresh process of
its own, with two intra-op threads."""

import argparse
import concurrent.futures as cf
import json
import math
import multiprocessing
import pathlib
import sys

REPO = pathlib.Path(__file__).resolve().parents[1]
OUT = REPO / "genjax_torch" / "examples" / "cpu_reference.json"


def _finite(x):
    if isinstance(x, float) and not math.isfinite(x):
        return repr(x)
    if isinstance(x, dict):
        return {k: _finite(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_finite(v) for v in x]
    return x


def _one(name: str) -> dict:
    import torch

    torch.set_num_threads(2)
    from genjax_torch.examples import holding, run_program

    out = run_program(name, device="cpu")
    entry = {"result": _finite(out["result"]), "wall_s": out["wall_s"]}
    sizes = holding.rehearsal_sizes(name)
    if sizes is not None:
        small = run_program(name, device="cpu", sizes=sizes)
        entry["rehearsal"] = {"sizes": sizes,
                              "result": _finite(small["result"]),
                              "wall_s": small["wall_s"]}
    entry["sources"] = holding.loaded_sources()
    entry["source_sha256"] = holding.sources_sha(entry["sources"])
    return entry


def main() -> int:
    sys.path.insert(0, str(REPO))
    from genjax_torch.examples import COOKBOOK, EXAMPLES

    ap = argparse.ArgumentParser()
    ap.add_argument("--jobs", type=int, default=4)
    ap.add_argument("--only", default="")
    args = ap.parse_args()
    names = list(EXAMPLES) + list(COOKBOOK)
    if args.only:
        names = [n for n in names if n.split("_")[0] in args.only.split(",")
                 or n in args.only.split(",")]
    ref = json.loads(OUT.read_text()) if OUT.exists() else {}
    ctx = multiprocessing.get_context("spawn")
    with cf.ProcessPoolExecutor(args.jobs, mp_context=ctx,
                                max_tasks_per_child=1) as pool:
        futures = {pool.submit(_one, n): n for n in names}
        for fut in cf.as_completed(futures):
            name = futures[fut]
            ref[name] = fut.result()
            print(f"{name}: {ref[name]['wall_s']:.1f} s", flush=True)
    ordered = {n: ref[n] for n in list(EXAMPLES) + list(COOKBOOK) if n in ref}
    OUT.write_text(json.dumps(ordered, indent=1, sort_keys=False) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
