"""On the card, at each cell's own size: the control (the program with
the precision path the cell's file names under ``control``, TF32 in the
body kernels) comes out not correct on three seeds, and the program
itself correct on the same seeds.  Skips without a CUDA device.

    python -m pytest portbench/tests -m card
"""

from __future__ import annotations

import time

import pytest

from portbench import harness, spec

from conftest import ROOT

CELLS = ("grid1024-exact", "pod1e7-flat", "grid1024-fast")
SEEDS = (2**31 + 7, 2**31 + 8, 2**31 + 9)


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_where_the_program_passes(cell, cuda_device):
    control = spec.load_cell(ROOT, cell).check["control"]
    for seed in SEEDS:
        sound = harness.run(ROOT, cell, seed, 2.0, False, cuda_device,
                            time.perf_counter())
        assert sound["correct"], (seed, sound["checks"])
        ctl = harness.run(ROOT, cell, seed, 2.0, False, cuda_device,
                          time.perf_counter(), fields=control)
        assert not ctl["correct"], (seed, ctl["checks"])
