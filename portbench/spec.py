"""Finds a cell's pieces by the names in ``BENCHMARK.json``.

Nothing here names a cell, a configuration, a traffic mix or a metric:
each lives in a file of its own, found by its name.

* ``BENCHMARK.json`` (the root of the checkout): the cell's configuration
  and traffic names, its chips, and the metrics it reports;
* ``portbench/configs/<config>.json``: the deployment's sizes;
* ``portbench/traffic/<traffic>.json``: the entry adapter, the
  ``FilterConfig`` fields and the update mix;
* ``portbench/cells/<cell>.json``: how the cell's output is checked and
  the limit of each compared number;
* ``portbench/entries/<entry>.py``, ``portbench/metrics/<metric>.py``,
  ``portbench/counts/<kernel>.py``, ``portbench/reference/<name>.py``,
  ``portbench/generators/<kind>.py``, ``portbench/pairs/<name>.py``:
  modules loaded from their file.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    check: dict
    end_to_end: list  # [(name, unit)] this cell reports with --trace 0
    per_layer: list  # [(name, unit)] this cell reports with --trace 1


def _reports(metric: dict, cell: str, e2e_of_cell: set) -> bool:
    """A per-layer metric with ``workloads`` is reported in those cells;
    one without, in every cell that reports the metric it ``moves``."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric["moves"] in e2e_of_cell


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(root: Path, name: str) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json`` with its files."""
    bench = load_json(root / "BENCHMARK.json")
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(has {sorted(work)})")
    w = work[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = load_json(root / conf["file"])
    config["name"] = w["config"]
    traffic = load_json(HERE / "traffic" / f"{w['traffic']}.json")
    traffic["name"] = w["traffic"]
    check = load_json(HERE / "cells" / f"{name}.json")
    e2e = [(m["name"], m["unit"]) for m in bench["end_to_end"]
           if name in m.get("workloads", [name])]
    names = {n for n, _ in e2e}
    per = [(m["name"], m["unit"]) for m in bench["per_layer"]
           if _reports(m, name, names)]
    return Cell(name=name, chips=int(w["chips"]), config=config,
                traffic=traffic, check=check, end_to_end=e2e, per_layer=per)


def load_module(kind: str, name: str):
    """``portbench/<kind>/<name>.py`` as a module (names may hold dots)."""
    path = HERE / kind / f"{name}.py"
    if not path.exists():
        raise FileNotFoundError(f"no {kind} module {path}")
    key = f"portbench.{kind}.{name}"
    if key in sys.modules:
        return sys.modules[key]
    spec = importlib.util.spec_from_file_location(key, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[key] = mod
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str):
    """The reader of per-layer metric ``name``: ``metrics/<name>.py``, or,
    for a quantity split by the cells that report it (``<metric>.<part>``,
    each part moving another end-to-end metric), ``metrics/<metric>.py``
    where the part has no reader of its own."""
    if (HERE / "metrics" / f"{name}.py").exists() or "." not in name:
        return load_module("metrics", name)
    return load_module("metrics", name.split(".", 1)[0])
