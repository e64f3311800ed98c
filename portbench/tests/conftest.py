"""Shared fixtures of the benchmark's own tests: tiny CPU cells built from
`tiny_*.json` beside this file, run through the harness without a card."""

import json
import time
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent


def tiny_cell(kind: str, seed: int = 2**31 + 77, seconds: float = 0.0, trace: bool = False):
    import torch

    from portbench import harness

    bench = harness.load_benchmark()
    name = {"knee": "knee_w24.stream", "train": "train_w24.recipe"}[kind]
    cell = harness.make_cell(bench, name, seed, seconds, trace, time.perf_counter())
    cell.config = json.loads((HERE / f"tiny_{kind}.json").read_text())
    cell.traffic = json.loads((HERE / {"knee": "tiny_stream.json", "train": "tiny_recipe.json"}[kind]).read_text())
    cell.device = torch.device("cpu")
    return cell


@pytest.fixture
def cpu_threads():
    import torch

    old = torch.get_num_threads()
    torch.set_num_threads(min(4, old))
    yield
    torch.set_num_threads(old)
