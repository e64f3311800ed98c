"""The timed path broken underneath a tiny CPU run: `correct` must come out
false for each fault a cell can have. The knee cell: an answer altered
where it is produced (the segmentation's logits, the network's map, the
thickness) and a deep conv of the segmenter reading its taps the wrong way round. The training cell: a step that leaves its state unchanged,
and half of the batch left out with the mean taken over the rest."""

import pytest

from portbench import harness
from portbench.drivers import knee, train
from portbench.tests.conftest import tiny_cell


def _failed(line):
    return {name for name, c in line["checks"].items() if not c["value"] <= c["limit"]}


@pytest.mark.parametrize("fault,check", [("segment_altered", "seg_gap"), ("tap_swapped", "seg_gap"),
                                         ("map_altered", "disp_mean_gap_mm")],
                         ids=["segment", "deep_tap", "register"])
def test_knee_answer_altered(fault, check, cpu_threads):
    line = harness.run_cell(tiny_cell("knee"), fault=knee.FAULTS[fault])
    assert line["correct"] is False
    assert check in _failed(line)


def test_knee_thickness_altered(cpu_threads, monkeypatch):
    from oai_analysis_2_tpu_torch.engine import pipeline

    orig = pipeline.get_thickness_meshes

    def altered(*a, **k):
        out = orig(*a, **k)
        for inner, _outer in out:
            inner.point_data = inner.point_data * 1.2
        return out

    def fault(pipe):
        monkeypatch.setattr(pipeline, "get_thickness_meshes", altered)

    line = harness.run_cell(tiny_cell("knee"), fault=fault)
    assert line["correct"] is False
    assert "thickness_quantile_gap_mm" in _failed(line)


@pytest.mark.parametrize("fault,check", [("state_unchanged", "change_norm_gap"), ("half_batch", "loss_gap")],
                         ids=["unchanged", "half_batch"])
def test_train_step_broken(fault, check, cpu_threads):
    line = harness.run_cell(tiny_cell("train"), fault=train.FAULTS[fault])
    assert line["correct"] is False
    assert check in _failed(line)
