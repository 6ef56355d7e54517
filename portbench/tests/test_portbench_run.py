"""Whole runs of the harness on the CPU at small sizes, past its look
for a card: a sound run comes out correct, and a run with the timed path
broken underneath comes out not correct, once for each fault the cell
can have (a step that returns its state unchanged; half of the ensemble
or batch left out, the mean taken over the rest; an answer altered
where it is produced). The cells have one chip, so no exchange between
chips can be left out. Also the JAX check by whole top-level names, and
the refusals that print no result."""

"""Whole runs of the harness on the CPU at small sizes, past its look
for a card: a sound run comes out correct, and a run with the timed path
broken underneath comes out not correct, once for each fault the cell
can have (``lib/faults.py``: a step that returns its state unchanged;
half of the ensemble left out, the mean taken over the rest; an answer
altered where it is produced). The cells have one chip, so no exchange
between chips can be left out. Also the JAX check by whole top-level
names, the limit check, and the refusals that print no result."""

import json
import math
import os
import subprocess
import sys

import pytest
import torch

from portbench import run as bench_run
from portbench.lib import faults

SMALL = {"tracking.fused": {"particles": 4096},
         "tracking.general": {"particles": 4096},
         "hmm.smc": {"particles": 4096}}


def manifest():
    with open(os.path.join(bench_run.ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def cpu_run(cell, seed=2**31 + 17, trace=0):
    code, res = bench_run.run(["--workload", cell, "--seed", str(seed),
                               "--seconds", "0.2", "--trace", str(trace)],
                              require_cuda=False, device="cpu",
                              overrides=SMALL[cell])
    assert code == 0
    return res


def test_every_cell_is_tried():
    assert set(SMALL) == {w["name"] for w in manifest()["workloads"]}


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_sound_run_is_correct(cell, capsys):
    res = cpu_run(cell)
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(line)["correct"] is True
    assert list(json.loads(line))[-1] == "checks"
    want = {m["name"] for m in manifest()["end_to_end"]
            if cell in m.get("workloads", [cell])}
    assert set(res["metrics"]) == want


def test_traced_run_reports_on_the_cpu_what_it_can():
    res = cpu_run("tracking.fused", trace=1)
    assert res["correct"]
    assert "dispatched_ops_per_step" in res["metrics"]
    # No device events on the CPU: the device's metrics are left out.
    assert "fused_step_roofline" not in res["metrics"]


def test_judged_calls_are_drawn_before_the_window():
    mix = {"checked_calls": 2, "checked_within": 8}
    a = bench_run.checked_calls(2**31 + 17, mix)
    assert a == bench_run.checked_calls(2**31 + 17, mix)
    assert len(a) == 2 and all(0 <= i < 8 for i in a) and a == sorted(a)
    seen = {tuple(bench_run.checked_calls(s, mix)) for s in range(50)}
    assert len(seen) > 10


def test_verdict_holds_every_number_to_its_limit():
    limits = {"a": 1.0, "b": 2.0}
    assert bench_run.verdict({"a": 0.5, "b": 2.0}, limits)[0]
    assert not bench_run.verdict({"a": 1.5, "b": 0.0}, limits)[0]
    assert not bench_run.verdict({"a": math.nan}, limits)[0]
    assert not bench_run.verdict({"a": math.inf}, limits)[0]
    assert not bench_run.verdict({"c": 0.0}, limits)[0]
    assert not bench_run.verdict({}, limits)[0]
    assert not bench_run.verdict({"a": 0.5}, limits, failed=1)[0]
    checks = bench_run.verdict({"a": math.inf}, limits)[1]
    assert checks["a"] == {"value": None, "limit": 1.0}
    assert checks["failed_calls"] == {"value": 0, "limit": 0}


# -- faults underneath the timed path -------------------------------------


@pytest.mark.parametrize("cell,fault", [(c, f) for c in sorted(SMALL)
                                        for f in faults.FAULTS])
def test_broken_path_is_not_correct(cell, fault):
    undo = faults.plant(fault)
    try:
        res = cpu_run(cell)
    finally:
        undo()
    assert res["correct"] is False, res["checks"]


def test_faults_leave_the_port_as_it_was():
    import importlib

    pf = importlib.import_module("genjax_torch.inference.pf")
    before = (pf.fused_step, pf.particle_filter, pf._lse, pf._lse_ess)
    for fault in faults.FAULTS:
        faults.plant(fault)()
    assert (pf.fused_step, pf.particle_filter, pf._lse,
            pf._lse_ess) == before


# -- the JAX check and the refusals ---------------------------------------


@pytest.mark.parametrize("names,found", [
    (["genjax_torch", "genjax_torch.core.random", "torch"], []),
    (["jax.numpy"], ["jax"]),
    (["genjax_tpu.core"], ["genjax_tpu"]),
    (["jaxlib.xla_client", "flax"], ["flax", "jaxlib"]),
    (["jaxtyping", "genjax_tpu_extra"], []),
])
def test_forbidden_by_whole_top_level_name(names, found):
    assert bench_run.forbidden_modules(names) == found


def test_jax_loaded_means_no_result(monkeypatch, capsys):
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    code, res = bench_run.run(["--workload", "tracking.fused", "--seed",
                               "3", "--seconds", "0.1"], require_cuda=False,
                              device="cpu", overrides=SMALL["tracking.fused"])
    assert code != 0 and res is None
    assert capsys.readouterr().out == ""


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    proc = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "tracking.fused",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=bench_run.ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and proc.stdout == ""


def test_alone_in_a_directory_no_result(tmp_path):
    import shutil

    shutil.copy(os.path.join(bench_run.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(bench_run.ROOT, "portbench"),
                    tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = dict(os.environ, PYTHONPATH="")
    proc = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "tracking.fused",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300, env=env)
    assert proc.returncode != 0 and proc.stdout == ""


@pytest.mark.chip
def test_a_cell_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    code, res = bench_run.run(["--workload", "tracking.fused", "--seed",
                               "5", "--seconds", "1", "--trace", "1"],
                              overrides={"particles": 2**20})
    assert code == 0 and res["correct"], res["checks"]
    assert res["device"]["busy_s"] > 0
