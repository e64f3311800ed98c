"""The control: the reference one precision below the configuration's, put
in the program's place, must come out not correct. On the CPU at the tiny
size; on the card (marked `cuda`, skipped without one) at each cell's own
size on three seeds."""

import pytest

from portbench import harness
from portbench.tests.conftest import tiny_cell


def _fails(cell, readings):
    limits = cell.config["correctness"]["limits"]
    return [name for name in limits if not readings[name] <= limits[name]]


@pytest.mark.parametrize("kind", ["knee", "train"])
def test_control_not_correct_tiny(kind, cpu_threads):
    cell = tiny_cell(kind, seed=2**31 + 501)
    assert _fails(cell, harness.driver(cell.config).control(cell))


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["knee_w24.stream", "train_w24.recipe"])
def test_control_not_correct_on_card(workload):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the control runs at the cell's own size")
    bench = harness.load_benchmark()
    cell = harness.make_cell(bench, workload, 0, 0.0, False, 0.0)
    cell.device = harness.require_cards(cell.chips)
    for seed in (2**31 + 11, 2**31 + 12, 2**31 + 13):
        cell.seed = seed
        assert _fails(cell, harness.driver(cell.config).control(cell)), seed
