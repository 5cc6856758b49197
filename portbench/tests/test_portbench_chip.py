"""On the card, at each cell's own size: the lower-precision control reads
``correct: false`` on three seeds, and a short run of the program reads
true.  Marked ``chip``; each test skips where torch sees no card."""

import pytest

from portbench_small import CELLS

SEEDS = (2718281828, 3141592653, 1618033988)


@pytest.mark.chip
@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("seed", SEEDS)
def test_lower_precision_control_fails_at_the_cells_size(cell, seed, cuda):
    from portbench.harness import run_cell

    res, rows = run_cell(cell, seed, 0.0, device=cuda, control="lower")
    assert not res["correct"], rows


@pytest.mark.chip
@pytest.mark.parametrize("cell", CELLS)
def test_short_run_is_correct_at_the_cells_size(cell, cuda):
    from portbench.harness import run_cell

    res, rows = run_cell(cell, SEEDS[0], 2.0, device=cuda)
    assert res["correct"], rows
    assert res["metrics"]["toas_per_s"]["value"] > 0
