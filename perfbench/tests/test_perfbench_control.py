"""The control fails and the program passes, on the card at each cell's own
size: the reference computed in TF32, one step of precision below the
configurations' fp32, put in the program's place, must fail at least one of
the cell's limits on every seed; the program's own outputs, read in the same
process, must meet all of them. Needs a CUDA card (`-m cuda`); skips here."""
import pytest
import torch

from perfbench.control import readings
from perfbench.harness import Cell

SEEDS = (2**31 + 101, 2**32 + 7, 2**34 + 3)
CELLS = ["qp2-photos-b10", "a800gen16-generate-b8"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails_and_the_program_passes(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the cells run at their own size on the card")
    limits = Cell.named(cell).config["limits"]
    for seed in SEEDS:
        out = readings(cell, seed, 10.0)
        over = {n: v for n, v in out["control"].items() if v > limits.get(n, 0)}
        assert over, out
        assert all(v <= limits.get(n, 0) for n, v in out["program"].items()), out
