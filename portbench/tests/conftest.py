"""CPU tests of the port's benchmark (``python -m pytest portbench/tests``
from the root of the repository); tests marked ``card`` run only where a
CUDA device is present and skip elsewhere."""

from __future__ import annotations

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# Small sizes of each configuration for runs on the CPU.
GRID_SMALL = dict(ny=24, nx=48, nmems=16, obs={
    "count": 300, "placement": "random", "lat_range": [-85.0, 85.0],
    "lon_range": [0.0, 360.0], "error_var": 1.0, "radius_km": 2000.0})
FLAT_SMALL = dict(nstate=8000, nmems=16, obs={
    "count": 300, "placement": "state_rows", "order": "hilbert",
    "error_var": 1.0, "radius_km": 2000.0})
SMALL = {"grid1024-exact": GRID_SMALL, "grid1024-fast": GRID_SMALL,
         "pod1e7-flat": FLAT_SMALL}
# Panels of 128 obs, so that a small run has several.
SMALL_FIELDS = {"tail_panel": 128}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA device; skips without one")


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: this test runs on the card")
    return torch.device("cuda:0")
