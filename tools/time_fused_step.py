"""Time the fused filter step's kernel from a given checkout on the CUDA
card, at 2^20 particles in f32 state: ``tracking.cuh``'s and each header
that the checkout's generator writes for ``chip_smoke.generated_models``.
For each it reports the float constants, the nvcc seconds of its library
(all built at once, as chip_smoke.py's phase 2 builds them), and its time
a call as phases 33-34 take it (``chip_smoke.time_generated``: CUDA events,
the best of 3 rounds of 200 calls with the models in turns, and the
device time of a profiled run) beside the plain version's. ``--check``
first holds each kernel to its plain version as phase 4 does
(``chip_smoke.fused_vs_plain``). ``--sass tracking.cuh,long_loop_1100``
writes the SASS of those models' f32 step kernels to ``chiprun_out/``
and counts its instructions: global loads, constant-bank reads, local
memory (register spills) and the kernel's code bytes, beside ptxas's
resource line for it (registers, stack, local memory).

    python3 tools/time_fused_step.py --repo DIR [--check]
        [--sass tracking.cuh,...] [--models tracking.cuh,sv,...]

Prints one JSON line. To hold two trees against each other, run it on
each, one after another on the same card: parent, change, change, parent.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor


def step_sass(library: str, out_path: str) -> dict:
    """The SASS of the library's first f32 step kernel, written to
    ``out_path``, with its instructions counted by opcode family and its
    code bytes (16 an instruction)."""
    from genjax_torch.ops._build import _nvcc

    cuobjdump = os.path.join(os.path.dirname(_nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", library], capture_output=True,
                          text=True, check=True, timeout=120).stdout
    usage = subprocess.run([cuobjdump, "-res-usage", library],
                           capture_output=True, text=True, check=True,
                           timeout=120).stdout.splitlines()
    resources = next((usage[i + 1].strip() for i, line in enumerate(usage)
                      if "stepIfE" in line and i + 1 < len(usage)), None)
    body, inside = [], False
    for line in sass.splitlines():
        if "Function :" in line:
            if inside:
                break
            inside = "step" in line and "IfE" in line    # step<float>
        if inside:
            body.append(line)
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    with open(out_path, "w") as f:
        f.write("\n".join(body) + "\n")
    ops = [m.group(1) for m in (re.search(
        r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z0-9.]+)", line)
        for line in body) if m]
    return {"instructions": len(ops), "code_bytes": 16 * len(ops),
            "global_loads": sum(o.startswith("LDG") for o in ops),
            "local_memory": sum(o.startswith(("LDL", "STL")) for o in ops),
            "uniform_constant_loads": sum(o.startswith("ULDC") for o in ops),
            "constant_loads": sum(o.startswith("LDC") for o in ops),
            "constant_bank_operands": sum("c[0x0]" in line for line in body),
            "resources": resources}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--repo", required=True)
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--sass", default="")
    ap.add_argument("--models", default="")
    opt = ap.parse_args()
    repo = os.path.abspath(opt.repo)
    sys.path.insert(0, repo)

    import torch

    import chip_smoke as cs
    from genjax_torch import entry as E
    from genjax_torch.core import random
    from genjax_torch.ops import fused_model, fused_step as fs

    if not torch.cuda.is_available():
        raise SystemExit("time_fused_step: no CUDA device")
    dev = torch.device("cuda", 0)
    card = cs.card_line()
    forms = cs.generated_models(dev)
    wanted = [m for m in opt.models.split(",") if m] or [
        "tracking.cuh", *forms]
    gen = {k: fused_model.cuda_model(*forms[k], dev)
           for k in wanted if k in forms}

    def timed_build(name):
        t0 = time.perf_counter()
        fs.build(name)
        return time.perf_counter() - t0

    names = {"tracking.cuh": E.TRACKING_CUDA.name,
             **{k: m.name for k, m in gen.items()}}
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(names)) as pool:
        jobs = {k: pool.submit(timed_build, n) for k, n in names.items()}
        nvcc_s = {k: job.result() for k, job in jobs.items()}
    build_s = time.perf_counter() - t0

    n = 1 << 20
    seeds = random.key_data(random.fold_in(random.key(314159, device=dev),
                                           3))
    xs0 = random.normal(random.key(1, device=dev), (n,))
    lw0 = random.normal(random.key(2, device=dev), (n,)) * 0.3
    step_inputs = (seeds, xs0, lw0, torch.tensor(2.5, device=dev))
    bounded = (*getattr(cs, "GEN34_MODELS", ()),
               *getattr(cs, "GEN_LONG_LOOPS", ()))
    errors = {}
    if opt.check:
        errors["tracking.cuh"] = cs.fused_vs_plain(
            "tracking.cuh", E.tracking_propagate, E.tracking_loglik,
            E.TRACKING_CUDA, step_inputs)
        for k, model in gen.items():
            errors[k] = cs.fused_vs_plain(
                f"generated {k}", *forms[k], model, step_inputs,
                steps=cs.quantised_steps if k == "quantised" else None,
                bound=cs.GEN34_BOUND if k in bounded else None)
    timing = cs.time_generated(card, "tool", {
        "tracking.cuh": (E.tracking_propagate, E.tracking_loglik,
                         E.TRACKING_CUDA),
        **{f"gen_{k}": (*forms[k], m) for k, m in gen.items()}},
        step_inputs)
    from genjax_torch.ops._build import BUILD_DIR

    tag = os.path.basename(repo.rstrip("/")) or "repo"
    sass = {k: step_sass(
        os.path.join(BUILD_DIR, f"libfused_step_{names[k]}.so"),
        os.path.join(os.getcwd(), "chiprun_out",
                     f"fused_step_{k}_{tag}.sass"))
        for k in opt.sass.split(",") if k}
    print(json.dumps(cs.finite_or_none({
        "repo": repo, "card": card, "build_s": build_s,
        "models": {k: {"n_params": len(gen[k].params) if k in gen
                       else len(E.TRACKING_CUDA.params),
                       "nvcc_s": nvcc_s[k], "max_abs_err": errors.get(k),
                       **timing["tracking.cuh" if k == "tracking.cuh"
                                else f"gen_{k}"]}
                   for k in names},
        "sass": sass})), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
