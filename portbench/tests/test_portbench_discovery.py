"""A configuration of a new kind (its generator), a traffic mix with a
new pair counter, a cell and a per-layer metric added as new files plus
``BENCHMARK.json`` entries are found and run with no file edited; the
import guard; the command's refusals."""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from portbench import guard

from conftest import ROOT

NEW_METRIC = '''"""update_span_pct: percent of the window inside updates."""


def read(ctx):
    span = sum(e - b for b, e in ctx.trace.updates)
    return 100.0 * span / (ctx.trace.window_s * 1e6)
'''


NEW_GENERATOR = '''"""Generator of kind grid_north: the grid's, with
every ob in the northern hemisphere."""

from portbench import spec

_grid = spec.load_module("generators", "grid")
CHOICES = _grid.CHOICES
prior = _grid.prior


def make(config, seed, device):
    obs = {**config["obs"], "lat_range": [0.0, 85.0]}
    return _grid.make({**config, "obs": obs}, seed, device)
'''

NEW_PAIRS = '''"""Pair counter tiny_pairs: the EnSRF's, counted alike."""

from portbench import spec


def count(inputs, fields):
    return spec.load_module("pairs", "ensrf").count(inputs, fields)
'''


def _digests(root):
    return {p: hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted((root / "portbench").rglob("*"))
            if p.is_file() and "__pycache__" not in p.parts}


def _copy(tmp_path):
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    return tmp_path


def test_new_files_are_found_with_no_edit(tmp_path):
    root = _copy(tmp_path)
    before = _digests(root)
    pb = root / "portbench"
    tiny = json.loads((pb / "configs" / "grid1024.json").read_text())
    tiny.update(ny=16, nx=32, nmems=8, kind="grid_north")
    tiny["obs"] = {**tiny["obs"], "count": 100}
    (pb / "configs" / "tiny.json").write_text(json.dumps(tiny))
    (pb / "generators" / "grid_north.py").write_text(NEW_GENERATOR)
    traffic = json.loads((pb / "traffic" / "api-fast.json").read_text())
    traffic["pairs"] = "tiny_pairs"
    (pb / "traffic" / "tiny-api.json").write_text(json.dumps(traffic))
    (pb / "pairs" / "tiny_pairs.py").write_text(NEW_PAIRS)
    (pb / "cells" / "tiny-fast.json").write_text(
        (pb / "cells" / "grid1024-fast.json").read_text())
    (pb / "metrics" / "update_span_pct.py").write_text(NEW_METRIC)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny", "source": "a test",
                             "file": "portbench/configs/tiny.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "tiny-fast", "config": "tiny",
                               "traffic": "tiny-api", "chips": 1,
                               "why": "a test"})
    rate = "obs_pts_per_s.host_paced"
    for m in bench["end_to_end"]:
        if m["name"] in (rate, "update_p90_ms"):
            m["workloads"].append("tiny-fast")
    bench["per_layer"].append({"name": "update_span_pct", "unit": "%",
                               "better": "higher", "source": "program_span",
                               "layer": "harness", "moves": rate,
                               "workloads": ["tiny-fast"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    after = _digests(root)
    assert all(after[p] == d for p, d in before.items())

    code = f"""
import json, sys, time
from pathlib import Path
sys.path[:0] = [{str(root)!r}, {str(ROOT)!r}]
from portbench import generate, harness, spec
assert spec.__file__.startswith({str(root)!r})
cell = spec.load_cell(Path({str(root)!r}), "tiny-fast")
assert cell.config["ny"] == 16 and cell.traffic["name"] == "tiny-api"
assert ("update_span_pct", "%") in cell.per_layer
r = harness.run(Path({str(root)!r}), "tiny-fast", 3, 0.2, True, "cpu",
                time.perf_counter(), fields={{"tail_panel": 64}})
assert r["correct"], r["checks"]
assert "portbench.generators.grid_north" in sys.modules
assert "portbench.pairs.tiny_pairs" in sys.modules
inputs = generate.make_inputs(cell.config, cell.traffic, 3, "cpu")
assert float(inputs.ob_lat.min()) >= 0.0
print(json.dumps(r["metrics"]))
"""
    res = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    metrics = json.loads(res.stdout.strip().splitlines()[-1])
    assert 0.0 < metrics["update_span_pct"]["value"] <= 100.0


def test_guard_names_whole_top_level_names():
    assert guard.forbidden_modules(["efa_xray_tpu_torch.ops", "numpy",
                                    "jaxtyping", "flaxen"]) == []
    assert guard.forbidden_modules(["efa_xray_tpu.ops.x", "jax.numpy",
                                    "flax"]) == ["efa_xray_tpu", "flax",
                                                 "jax"]


def _guard_after(imports: str):
    code = ("import sys; sys.path.insert(0, '.');" + imports +
            ";from portbench import guard; print(guard.forbidden_modules())")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    return res.stdout.strip().splitlines()[-1]


def test_guard_passes_on_the_harness_and_fails_on_the_jax_package():
    harness_imports = (
        "from portbench import harness, spec, calibrate;"
        "[spec.load_module(k, n) for k, n in (('entries', 'api'),"
        " ('entries', 'flat'), ('reference', 'ensrf_serial'))];"
        "[spec.load_module('metrics', p.stem) for p in"
        " sorted((spec.HERE / 'metrics').glob('*.py'))];"
        "[spec.load_module(k, p.stem) for k in ('counts', 'generators',"
        " 'pairs') for p in sorted((spec.HERE / k).glob('*.py'))]")
    assert _guard_after(harness_imports) == "[]"
    assert "efa_xray_tpu" in _guard_after(harness_imports +
                                          ";import efa_xray_tpu")


def test_command_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("the refusal is that of a machine without a card")
    cmd = [sys.executable, "portbench/run.py", "--workload", "grid1024-fast",
           "--seed", "1", "--seconds", "1", "--trace", "0"]
    res = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode != 0 and res.stdout == ""


def test_command_fails_without_the_program(tmp_path):
    """A directory holding only BENCHMARK.json and the benchmark's files
    has no program to run: the run fails and prints no result."""
    root = _copy(tmp_path)
    code = ("import sys, time; from pathlib import Path; sys.path[0] = '.';"
            "from portbench import harness;"
            "harness.run(Path('.'), 'grid1024-fast', 1, 0.1, False, 'cpu',"
            " time.perf_counter())")
    res = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode != 0 and res.stdout == ""
    assert "efa_xray_tpu_torch" in res.stderr
