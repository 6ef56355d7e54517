"""The Monte Carlo spread of the ported documented programs' results,
for the tolerances of ``tests/torch_port/test_torch_examples_*.py``.

    python tools/examples_spread.py --programs ex02 --keep 9 --seeds 8

Runs each program's ``main(device="cpu")`` again on ``--seeds`` other
keys: every key the run makes with ``core.random.key(seed)`` becomes
``key(seed + 7919 * s)`` for s = 1, 2, ... (the program's sizes
unchanged), except the seeds listed in ``--keep`` (the keys that make a
program's data, so that only its inference draws change), and records,
for each numeric result, the sample sd over the seeds. A seed whose run
fails one of the program's own assertions is counted in ``failed`` and
left out. ``--sizes`` overrides a program's ``SIZES`` (JSON);
``--rehearsal`` runs at the program's ``REHEARSAL`` sizes and records
the spread under ``<program>@rehearsal``. Merges
into ``genjax_torch/examples/spread.json``: ``{program: {result key:
{"sd": ..., "mean": ..., "seeds": n, "failed": m, "kept": [...]}}}``."""

import argparse
import concurrent.futures as cf
import json
import multiprocessing
import pathlib
import statistics
import sys

REPO = pathlib.Path(__file__).resolve().parents[1]
OUT = REPO / "genjax_torch" / "examples" / "spread.json"


def _flat(prefix, v, out):
    if isinstance(v, bool):
        return
    if isinstance(v, (int, float)):
        out[prefix] = float(v)
    elif isinstance(v, (list, tuple)):
        for i, x in enumerate(v):
            _flat(f"{prefix}[{i}]", x, out)


def _run(name: str, s: int, sizes: dict, keep: tuple) -> dict | None:
    import torch

    torch.set_num_threads(2)
    from genjax_torch.core import random
    from genjax_torch.examples import run_program

    key = random.key
    random.key = lambda seed, device=None: key(
        int(seed) + (0 if int(seed) in keep else 7919 * s), device)
    try:
        res = run_program(name, "cpu", sizes or None)["result"]
    except AssertionError:
        return None
    finally:
        random.key = key
    out = {}
    for k, v in res.items():
        _flat(k, v, out)
    return out


def main() -> int:
    sys.path.insert(0, str(REPO))
    from genjax_torch.examples import COOKBOOK, EXAMPLES

    ap = argparse.ArgumentParser()
    ap.add_argument("--programs", required=True)
    ap.add_argument("--seeds", type=int, default=8)
    ap.add_argument("--jobs", type=int, default=4)
    ap.add_argument("--sizes", default="{}")
    ap.add_argument("--keep", default="")
    ap.add_argument("--rehearsal", action="store_true")
    args = ap.parse_args()
    wanted = args.programs.split(",")
    names = [n for n in list(EXAMPLES) + list(COOKBOOK)
             if n.split("_")[0] in wanted or n in wanted]
    sizes = json.loads(args.sizes)
    keep = tuple(int(k) for k in args.keep.split(",") if k)
    spread = {}
    ctx = multiprocessing.get_context("spawn")
    with cf.ProcessPoolExecutor(args.jobs, mp_context=ctx) as pool:
        for name in names:
            if args.rehearsal:
                import importlib

                from genjax_torch.examples import module_name

                sizes = importlib.import_module(module_name(name)).REHEARSAL
            every = list(pool.map(_run, [name] * args.seeds,
                                  range(1, args.seeds + 1),
                                  [sizes] * args.seeds,
                                  [keep] * args.seeds))
            runs = [r for r in every if r is not None]
            name = name + ("@rehearsal" if args.rehearsal else "")
            spread[name] = {
                k: {"sd": statistics.stdev([r[k] for r in runs]),
                    "mean": statistics.fmean([r[k] for r in runs]),
                    "seeds": len(runs), "failed": len(every) - len(runs),
                    "kept": list(keep)}
                for k in runs[0]}
            print(name, json.dumps(spread[name]), flush=True)
            # Merge into the file as it is now (another run may have
            # written other programs meanwhile).
            merged = json.loads(OUT.read_text()) if OUT.exists() else {}
            merged[name] = spread[name]
            OUT.write_text(json.dumps(merged, indent=1) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
