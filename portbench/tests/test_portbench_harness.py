"""The harness finds every configuration, traffic mix and metric by name,
and BENCHMARK.json keeps to the contract's shapes."""

import json
import re
from pathlib import Path

import numpy as np
import pytest

from portbench import harness

ROOT = Path(__file__).resolve().parents[2]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def bench():
    return harness.load_benchmark()


def test_every_cell_finds_its_files(bench):
    for w in bench["workloads"]:
        cell = harness.make_cell(bench, w["name"], 1, 1.0, False, 0.0)
        assert cell.config["name"] == w["config"]
        assert harness.driver(cell.config).run
        assert cell.end_to_end and cell.per_layer
        assert any(m["name"] == "setup_s" for m in cell.end_to_end)


def test_every_metric_has_a_reader_that_reads_nothing_from_nothing(bench):
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert (ROOT / "portbench" / "metrics" / f"{m['name']}.py").is_file(), m["name"]
        assert harness.read_metrics([m], {}) == {}


def test_contract_shapes(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    names = [c["name"] for c in bench["configs"]] + [w["name"] for w in bench["workloads"]]
    names += [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    e2e = {m["name"] for m in bench["end_to_end"]}
    for m in bench["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"]
    for c in bench["configs"]:
        assert (ROOT / c["file"]).is_file() and c["file"].startswith("portbench/")
        assert all(NAME.match(k) for k in c["reduced"])
    for w in bench["workloads"]:
        assert w["chips"] == 1 and 1 <= len(w["why"]) <= 200
        assert (ROOT / "portbench" / "traffic" / f"{w['traffic']}.json").is_file()
    assert len(json.dumps(bench)) < 64 * 1024


def test_missing_card_gives_no_result(monkeypatch, capsys):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = harness.main(["--workload", "knee_w24.stream", "--seed", "1", "--seconds", "1", "--trace", "0"])
    out = capsys.readouterr()
    assert rc != 0 and out.out.strip() == ""


@pytest.mark.parametrize("key,value", [("thickness.iterations", 100), ("thickness.kmeans_iterations", 20),
                                       ("registration.finetune.image_dtype", "float32")],
                         ids=["smoothing", "kmeans", "finetune_images"])
def test_a_setting_the_program_does_not_run_gives_no_result(key, value, cpu_threads):
    from portbench.tests.conftest import tiny_cell

    cell = tiny_cell("knee")
    node = cell.config
    *path, last = key.split(".")
    for part in path:
        node = node[part]
    node[last] = value
    with pytest.raises(harness.NoResult, match=key):
        harness.run_cell(cell)


def test_segmenter_weights_dense_around_a_threshold_path():
    import torch

    from portbench.drivers import knee

    cfg = harness.make_cell(harness.load_benchmark(), "knee_w24.stream", 1, 1.0, False, 0.0).config
    spec, wcfg = cfg["segmenter"]["unet"], cfg["segmenter"]["weights"]
    a = knee.segmenter_weights(spec, wcfg, 2**31 + 5, torch.device("cpu"))
    b = knee.segmenter_weights(spec, wcfg, 2**31 + 5, torch.device("cpu"))
    c = knee.segmenter_weights(spec, wcfg, 2**31 + 6, torch.device("cpu"))
    assert all((a[n]["kernel"] == b[n]["kernel"]).all() for n in a)
    assert not (a["dec0a"]["kernel"] == c["dec0a"]["kernel"]).all()
    # every block but the head dense off the threshold channel, on every tap
    for name, leaves in a.items():
        k = leaves["kernel"][..., 1:] if name != "head" else leaves["kernel"][..., 1:, :]
        assert (k != 0).mean() > 0.99, name
    centre = np.zeros((3, 3, 3), np.float32)
    centre[1, 1, 1] = 1.0
    assert (a["enc0a"]["kernel"][..., 0, 0] == centre).all()
    assert (a["head"]["kernel"][0, 0, 0, 0] == wcfg["gain"]).all()
