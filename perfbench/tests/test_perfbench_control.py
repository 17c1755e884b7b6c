"""The control comes out not correct: the plain reference computed in the
nearest precision below the configuration's (fp8 under bf16, TF32 under
float32) put in the program's place.  On the CPU at a small size, and on
the card (``cuda``) at each cell's own size on three seeds, beside the
program's own reading, which passes."""

import pytest

import readings
from core.bench import load_benchmark
from tiny_cells import SECONDS, small_cell

CELLS = [w["name"] for w in load_benchmark()["workloads"]]


def _numbers(cell, seed, control, device):
    out = readings.reading(cell, seed, control, device)["checks"]
    return out, cell.traffic["limits"]


@pytest.mark.parametrize("name", CELLS)
def test_control_fails_at_a_small_size(name):
    cell = small_cell(name)
    cell.bench["run_seconds"] = SECONDS.get(name, 1.0)
    prog, limits = _numbers(cell, 3, False, "cpu")
    assert all(prog[k] <= limits[k] for k in prog)
    cell = small_cell(name)
    cell.bench["run_seconds"] = SECONDS.get(name, 1.0)
    ctl, limits = _numbers(cell, 3, True, "cpu")
    assert any(ctl[k] > limits[k] for k in ctl)


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_at_the_cells_size(name, card):
    from core.bench import Cell

    for seed in (101, 102, 103):
        prog, limits = _numbers(Cell(name), seed, False, card)
        assert all(prog[k] <= limits[k] for k in prog)
        ctl, limits = _numbers(Cell(name), seed, True, card)
        assert any(ctl[k] > limits[k] for k in ctl)
