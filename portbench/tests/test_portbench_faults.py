"""A whole run on the CPU, past the harness's look for a card, at a
small size: a sound run comes out correct, and a run whose timed path is
broken underneath comes out not correct, once for each fault a cell can
have (one card: no exchange between chips to leave out).  The limits are
the cells' own."""

from __future__ import annotations

import time

import pytest
import torch

from efa_xray_tpu_torch.assimilation.ensrf import KernelRoute
from portbench import harness, spec

from conftest import ROOT, SMALL, SMALL_FIELDS

CELLS = ("grid1024-exact", "pod1e7-flat", "grid1024-fast")
_solve = KernelRoute.solve


def _unchanged(self, body_mean, body_perts, *args, **kw):
    """An update that returns the state it was given."""
    bm0, bp0 = body_mean.clone(), body_perts.clone()
    _, _, tm, tp, diags = _solve(self, body_mean, body_perts, *args, **kw)
    return bm0, bp0, tm, tp, diags


def _half_batch(self, bm, bp, tm, tp, lat, lon, obs, **kw):
    """Every other ob left out."""
    keep = torch.ones_like(obs.assim)
    keep[1::2] = False
    return _solve(self, bm, bp, tm, tp, lat, lon,
                  obs._replace(assim=obs.assim & keep), **kw)


def _altered(self, *args, **kw):
    """One answer altered where it is produced: one state row's mean."""
    bm, bp, tm, tp, diags = _solve(self, *args, **kw)
    bm[bm.shape[0] // 2] += 0.5
    return bm, bp, tm, tp, diags


def _run(cell, seed=11):
    return harness.run(ROOT, cell, seed, 0.3, False, "cpu",
                       time.perf_counter(), size=SMALL[cell],
                       fields=SMALL_FIELDS)


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    r = _run(cell)
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] >= 1
    # Every end-to-end metric of the cell, and no other, is reported.
    want = {n for n, _ in spec.load_cell(ROOT, cell).end_to_end}
    assert set(r["metrics"]) == want


@pytest.mark.parametrize("fault", [_unchanged, _half_batch, _altered],
                         ids=["state_unchanged", "half_batch", "altered"])
@pytest.mark.parametrize("cell", CELLS)
def test_fault_is_not_correct(cell, fault, monkeypatch):
    monkeypatch.setattr(KernelRoute, "solve", fault)
    r = _run(cell)
    assert not r["correct"], r["checks"]
