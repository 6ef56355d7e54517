"""``BENCHMARK.json`` against the rules of its format, and every part a
cell names found by name under ``portbench/``."""

import json
import os
import re

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
BENCH = os.path.join(ROOT, "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def bench():
    with open(BENCH) as f:
        return json.load(f)


def test_top_level_keys():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert os.path.getsize(BENCH) <= 64 * 1024
    assert 1 <= b["run_seconds"] <= 51 and isinstance(b["run_seconds"], int)
    assert 1 <= len(b["paths"]) <= 16
    for p in b["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p)
        assert not p.startswith("/") and ".." not in p.split("/")
        assert not p.endswith("_torch")
    assert len(b["command"]) <= 32
    for word in b["command"]:
        assert 1 <= len(word) <= 200 and "\n" not in word and "\t" not in word


def test_entries_have_just_their_keys():
    b = bench()
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert 1 <= len(c["why"]) <= 200 and "\n" not in c["why"]
        assert 1 <= len(c["source"]) <= 200
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0 < m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end",
                                     "per_layer"])
def test_names_and_units(section):
    names = [e["name"] for e in bench()[section]]
    assert len(names) == len(set(names))
    for e in bench()[section]:
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")


def test_every_part_exists():
    b = bench()
    configs = {c["name"]: c for c in b["configs"]}
    for c in configs.values():
        assert c["file"] == f"portbench/configs/{c['name']}.json"
        assert os.path.exists(os.path.join(ROOT, c["file"]))
        assert os.path.exists(os.path.join(ROOT, "portbench", "configs",
                                           c["name"] + ".py"))
        assert os.path.exists(os.path.join(ROOT, "portbench", "work",
                                           c["name"] + ".py"))
        with open(os.path.join(ROOT, c["file"])) as f:
            assert json.load(f)["reduced"] == c["reduced"]
    used = set()
    for w in b["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["config"] in configs
        used.add(w["config"])
        traffic = os.path.join(ROOT, "portbench", "traffic",
                               w["traffic"] + ".json")
        with open(traffic) as f:
            driver = json.load(f)["driver"]
        assert NAME.match(driver)
        assert os.path.exists(os.path.join(ROOT, "portbench", "drivers",
                                           driver + ".py"))
        with open(os.path.join(ROOT, "portbench", "workloads",
                               w["name"] + ".json")) as f:
            assert json.load(f)["limits"]
    assert used == set(configs)
    pairs = [(w["config"], w["traffic"]) for w in b["workloads"]]
    assert len(pairs) == len(set(pairs))
    for m in b["end_to_end"] + b["per_layer"]:
        assert os.path.exists(os.path.join(ROOT, "portbench", "metrics",
                                           m["name"] + ".py")), m["name"]


def _reports(b, metric, cell):
    return "workloads" not in metric or cell in metric["workloads"]


def test_every_cell_reports_enough():
    b = bench()
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for w in b["workloads"]:
        own = [m for m in b["end_to_end"] if _reports(b, m, w["name"])]
        assert "setup_s" in [m["name"] for m in own] and len(own) >= 2
        assert any(_reports(b, m, w["name"]) for m in b["per_layer"])


def test_moves_names_a_metric_each_cell_reports():
    b = bench()
    e2e = {m["name"]: m for m in b["end_to_end"]}
    cells = [w["name"] for w in b["workloads"]]
    for m in b["per_layer"]:
        assert m["moves"] in e2e
        for cell in m.get("workloads", cells):
            assert cell in cells
            assert _reports(b, e2e[m["moves"]], cell), (m["name"], cell)


def test_layers_are_named_alike():
    b = bench()
    for m in b["per_layer"]:
        assert 1 <= len(m["layer"]) <= 200 and "\n" not in m["layer"]


def test_run_seconds_fits_the_check():
    b = bench()
    cells = 24
    runs = 2 + 14 * cells
    need = runs * (b["run_seconds"] + 60) + cells * 2 * 90 + 1200
    assert need <= 43200


def test_four_chip_cells_are_few():
    b = bench()
    four = sum(w["chips"] == 4 for w in b["workloads"])
    assert four <= max(1, len(b["workloads"]) // 4)


def test_the_harness_names_no_part_of_a_cell():
    """A cell is added by adding files: the shared harness names no
    cell, configuration, traffic mix, driver or metric of its own."""
    b = bench()
    names = ({w["name"] for w in b["workloads"]}
             | {w["traffic"] for w in b["workloads"]}
             | {c["name"] for c in b["configs"]}
             | {m["name"] for m in b["end_to_end"] + b["per_layer"]})
    for w in b["workloads"]:
        with open(os.path.join(ROOT, "portbench", "traffic",
                               w["traffic"] + ".json")) as f:
            names.add(json.load(f)["driver"])
    shared = [os.path.join("portbench", "run.py"),
              os.path.join("portbench", "control.py")]
    lib = os.path.join(ROOT, "portbench", "lib")
    shared += [os.path.join("portbench", "lib", f) for f in os.listdir(lib)
               if f.endswith(".py") and f != "faults.py"]
    for path in shared:
        with open(os.path.join(ROOT, path)) as f:
            text = f.read()
        for name in names:
            assert not re.search(rf"[\"'`]{re.escape(name)}[\"'`]", text), \
                (path, name)
