"""The cells on the card at small sizes, through the kernels (``-m card``
on the card's machine; skipped where there is no card)."""

import pytest

from portbench import run
from test_portbench_correct import CELLS, SEED, small


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_cell_is_correct_on_the_card(cell):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    got = run.run_cell(cell, SEED, 0.5, True, device="cuda",
                       overrides=small(cell))
    assert got["correct"], got["checks"]
    assert got["device"]["busy_s"] > 0
