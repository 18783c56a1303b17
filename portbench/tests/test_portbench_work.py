"""The work counts against brute-force pair enumeration, the traffic
generator's determinism, and its refusal of what it does not implement."""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from portbench import generate, peaks, spec, work
from portbench.tests import oracle_numpy as oracle

from conftest import FLAT_SMALL, GRID_SMALL, ROOT


def _pairs(inputs):
    return spec.load_module("pairs", "ensrf").count(inputs,
                                                     {"tail_panel": 128})


def _brute_pairs(rlat, rlon, olat, olon, radius):
    """(ob, row) pairs within reach, per ob: the great-circle distance
    under twice the halfwidth, where Gaspari-Cohn's support ends (its
    polynomial rounds to either sign just inside that edge, so the
    distance, not the weight's sign, defines the pair)."""
    d = oracle.haversine_np(olat[:, None], olon[:, None], rlat[None, :],
                            rlon[None, :])
    return (d < 2.0 * radius).sum(1)


def test_reach_counts_match_brute_force():
    rng = np.random.default_rng(5)
    rlat, rlon = rng.uniform(-88, 88, 3000), rng.uniform(0, 360, 3000)
    olat, olon = rng.uniform(-85, 85, 50), rng.uniform(0, 360, 50)
    t = lambda a: torch.tensor(a)
    got = work.reach_counts(t(rlat), t(rlon), t(olat), t(olon),
                            torch.full((50,), 2000.0), chunk_elems=10_000)
    want = _brute_pairs(rlat, rlon, olat, olon, 2000.0)
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("cell", ["pod1e7-flat", "grid1024-exact"])
def test_pairs_split_by_panel(cell):
    c = spec.load_cell(ROOT, cell)
    cfg = {**c.config, **(FLAT_SMALL if "pod" in cell else GRID_SMALL)}
    inp = generate.make_inputs(cfg, c.traffic, 7, "cpu")
    p = _pairs(inp)
    olat, olon = inp.ob_lat.numpy(), inp.ob_lon.numpy()
    rlat, rlon = inp.row_lat.double().numpy(), inp.row_lon.double().numpy()
    obs_pairs = _brute_pairs(olat, olon, olat, olon, 2000.0).sum()
    in_panel = sum(_brute_pairs(olat[s:s + 128], olon[s:s + 128],
                                olat[s:s + 128], olon[s:s + 128],
                                2000.0).sum() for s in range(0, 300, 128))
    assert p["panel_pairs"] == in_panel
    assert p["tail_pairs"] == obs_pairs - in_panel
    body = _brute_pairs(rlat, rlon, olat, olon, 2000.0).sum()
    assert abs(p["body_pairs"] - body) <= 1e-6 * body + 2
    assert p["panel_sizes"] == [128, 128, 44]
    b1 = spec.load_module("counts", "B1")
    ops, nbytes = b1.ops_bytes(p)
    assert ops == in_panel * (4 * 16 + 24)
    assert peaks.bound_s(ops, nbytes) > 0


def _same(a, b):
    return all(torch.equal(getattr(a, k), getattr(b, k)) for k in
               ("row_lat", "row_lon", "ob_lat", "ob_lon", "values"))


@pytest.mark.parametrize("cell", ["pod1e7-flat", "grid1024-fast"])
def test_traffic_is_the_seeds(cell):
    c = spec.load_cell(ROOT, cell)
    cfg = {**c.config, **(FLAT_SMALL if "pod" in cell else GRID_SMALL)}
    seed = 2**31 + 12345
    a = generate.make_inputs(cfg, c.traffic, seed, "cpu")
    b = generate.make_inputs(cfg, c.traffic, seed, "cpu")
    other = generate.make_inputs(cfg, c.traffic, seed + 1, "cpu")
    assert _same(a, b)
    assert not torch.equal(a.values, other.values)
    assert not torch.equal(a.ob_lon, other.ob_lon)
    pa, pb = a.prior(), b.prior()
    pa = pa if isinstance(pa, tuple) else (pa,)
    pb = pb if isinstance(pb, tuple) else (pb,)
    assert all(torch.equal(x, y) for x, y in zip(pa, pb))
    # The same work for every seed: pairs within reach agree closely.
    n1 = _pairs(a)["body_pairs"]
    n2 = _pairs(other)["body_pairs"]
    assert abs(n1 - n2) <= 0.02 * n1


@pytest.mark.parametrize("cell,where,key,value", [
    ("pod1e7-flat", "config", "row_order", "random"),
    ("pod1e7-flat", "config", "obs.placement", "clustered"),
    ("pod1e7-flat", "config", "obs.order", "random"),
    ("pod1e7-flat", "config", "dtype", "float64"),
    ("pod1e7-flat", "config", "localization", "Boxcar"),
    ("pod1e7-flat", "traffic", "network", "fresh"),
    ("grid1024-exact", "config", "obs.placement", "state_rows"),
])
def test_unimplemented_selectors_are_refused(cell, where, key, value):
    c = spec.load_cell(ROOT, cell)
    small = FLAT_SMALL if "pod" in cell else GRID_SMALL
    cfg = json.loads(json.dumps({**c.config, **small}))
    traffic = json.loads(json.dumps(c.traffic))
    d = cfg if where == "config" else traffic
    *path, last = key.split(".")
    for part in path:
        d = d[part]
    d[last] = value
    with pytest.raises(ValueError, match="not implemented"):
        generate.make_inputs(cfg, traffic, 1, "cpu")
