"""On the card, at the cell's own size: ``letkf-c7``'s control (the plain
reference computed in a precision below float32, TF32 products as the
cell's file names under ``control``, and bf16 products) comes out not
correct on three seeds, and the program itself correct on the same seeds.
Skips without a CUDA device.

    python -m pytest portbench/tests -m card
"""

from __future__ import annotations

import time

import pytest

from portbench import harness, spec

from conftest import ROOT

CELL = "letkf-c7"
SEEDS = (2**31 + 17, 2**31 + 18, 2**31 + 19)


@pytest.mark.card
@pytest.mark.parametrize("products", ["cell", "bf16"])
def test_control_fails_where_the_program_passes(products, cuda_device):
    control = (spec.load_cell(ROOT, CELL).check["control"]
               if products == "cell" else {"reference_products": products})
    for seed in SEEDS:
        sound = harness.run(ROOT, CELL, seed, 2.0, False, cuda_device,
                            time.perf_counter())
        assert sound["correct"], (seed, sound["checks"])
        ctl = harness.run(ROOT, CELL, seed, 2.0, False, cuda_device,
                          time.perf_counter(), fields=control)
        assert not ctl["correct"], (seed, ctl["checks"])
