"""A tiny CPU run of each cell through the harness: the result line's shape,
and `correct` true on the sound program."""

import json

import pytest

from portbench import harness
from portbench.tests.conftest import tiny_cell


@pytest.mark.parametrize("kind", ["knee", "train"])
def test_result_line_shape(kind, cpu_threads):
    cell = tiny_cell(kind)
    line = harness.run_cell(cell)
    keys = list(json.loads(json.dumps(line)))
    assert keys[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert keys[-1] == "checks"
    assert line["correct"] is True, line["checks"]
    assert line["attempted"] >= 1 and line["failed"] == 0
    assert "setup_s" in line["metrics"]
    assert set(line["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    for name, c in line["checks"].items():
        assert c["value"] <= c["limit"], name
