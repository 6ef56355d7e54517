"""Finding a cell's parts by name: ``workloads/<cell>.json``,
``configs/<config>.json`` and its reference ``configs/<config>.py``,
``traffic/<mix>.json`` and the driver it names, ``drivers/<driver>.py``,
``work/<config>.py`` and ``metrics/<metric>.py``,
all under the benchmark's folder. A name may hold dots and dashes, so a
module is loaded from its path."""

from __future__ import annotations

import importlib.util
import json
import os

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_loaded = {}


def path(kind: str, name: str, ext: str) -> str:
    if not name or "/" in name or name.startswith("."):
        raise ValueError(f"bad {kind} name {name!r}")
    return os.path.join(ROOT, kind, name + ext)


def data(kind: str, name: str) -> dict:
    with open(path(kind, name, ".json")) as f:
        return json.load(f)


def module(kind: str, name: str):
    p = path(kind, name, ".py")
    if p not in _loaded:
        spec = importlib.util.spec_from_file_location(
            f"portbench_{kind}_{name}".replace(".", "_").replace("-", "_"), p)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _loaded[p] = mod
    return _loaded[p]


def manifest(root: str | None = None) -> dict:
    """``BENCHMARK.json`` at the repository's root."""
    root = root or os.path.dirname(ROOT)
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def cell_metrics(bench: dict, section: str, cell: str) -> list:
    """The metrics of ``section`` that ``cell`` reports."""
    return [m for m in bench[section]
            if "workloads" not in m or cell in m["workloads"]]


def port_object(ref: str):
    """The port's object that ``ref`` (``"package.module:name"``, as a
    configuration's ``port`` block names it) denotes."""
    mod, _, attr = ref.partition(":")
    if not mod.startswith("genjax_torch") or not attr:
        raise ValueError(f"not a name of the port: {ref!r}")
    obj = importlib.import_module(mod)
    for part in attr.split("."):
        obj = getattr(obj, part)
    return obj


def patch(module, name: str, new):
    """Set ``module.name`` to ``new``; returns the undo."""
    old = getattr(module, name)
    setattr(module, name, new)
    return lambda: setattr(module, name, old)
