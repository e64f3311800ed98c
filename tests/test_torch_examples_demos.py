"""The port's NIfTI demo modules (`oai_analysis_2_tpu_torch/examples/
segmentation_demo.py`, `thickness_demo.py`, `cohort_demo.py`) against the
unchanged JAX scripts in `examples/`, on the CPU.

They run on the release tree of `test_torch_release.py` (written under
`tmp_path`, `OAI_TPU_DATA_DIR` pointing at it, downloads refused); each JAX
script is loaded from its file with `sys.argv` set and its stdout
captured. The tolerances are stated per test. The phantom full demo is
`test_torch_full_demo.py`'s.
"""

import importlib.util
import json
import re
import shutil
import sys
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

from oai_analysis_2_tpu_torch.core.nifti import read_nifti
from oai_analysis_2_tpu_torch.examples import cohort_demo as TCohortDemo
from oai_analysis_2_tpu_torch.examples import segmentation_demo as TSegDemo
from oai_analysis_2_tpu_torch.examples import thickness_demo as TThickDemo
from oai_analysis_2_tpu_torch.mesh.types import Mesh
from test_torch_release import SHAPE, env, release  # noqa: F401

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]


def run_jax(name, argv, monkeypatch, capsys):
    """The JAX script `examples/<name>.py` on `argv`: its printed lines."""
    spec = importlib.util.spec_from_file_location(f"jax_example_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    capsys.readouterr()
    monkeypatch.setattr(sys, "argv", [f"examples/{name}.py", *map(str, argv)])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        mod.main()
    return capsys.readouterr().out.strip().splitlines()


def run_port(mod, argv, capsys):
    capsys.readouterr()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        got = mod.main([str(a) for a in argv], device="cpu")
    return got, capsys.readouterr().out.strip().splitlines()


def seg_counts(lines):
    return {line.split()[0]: int(line.split()[-1]) for line in lines if "voxels > 0.5:" in line}


def test_segmentation_demo_matches_jax(env, tmp_path, monkeypatch, capsys):
    """The voxel counts above 0.5 within 0.5 % of the JAX script's (both
    segment in bf16; the threshold UNet's maps agree within 2e-2,
    test_torch_release.py); the two maps written and read back."""
    knee = env / "knee.nii.gz"
    want = run_jax("segmentation_demo", [knee, tmp_path / "jax"], monkeypatch, capsys)
    got, lines = run_port(TSegDemo, [knee, tmp_path / "port"], capsys)
    assert lines[0].startswith(f"segmented {SHAPE} in ") and want[0].startswith(f"segmented {SHAPE} in ")
    assert lines[-1] == f"wrote {tmp_path / 'port'}"
    j, p = seg_counts(want), seg_counts(lines)
    assert set(p) == {"FC", "TC"} and p == {"FC": got["fc_voxels"], "TC": got["tc_voxels"]}
    for t in ("FC", "TC"):
        assert p[t] > 0 and abs(p[t] - j[t]) <= 0.005 * j[t], (t, p[t], j[t])
        back = read_nifti(tmp_path / "port" / f"{t}_probmap.nii.gz", device="cpu")
        assert tuple(back.shape) == SHAPE and int((back.data > 0.5).sum()) == p[t]


def test_thickness_demo_matches_jax(env, tmp_path, monkeypatch, capsys):
    """On one FC probability map (the JAX segmentation demo's): inner and
    outer sizes within 0.5 %, mean thickness within 1 % of the JAX
    script's (phase 8's mesh tolerances), the same files and npz keys."""
    seg = tmp_path / "seg"
    run_jax("segmentation_demo", [env / "knee.nii.gz", seg], monkeypatch, capsys)
    prob = seg / "FC_probmap.nii.gz"
    want = run_jax("thickness_demo", [prob, "FC", tmp_path / "jax"], monkeypatch, capsys)
    got, lines = run_port(TThickDemo, [prob, "FC", tmp_path / "port"], capsys)
    nums = [[float(v) for v in re.findall(r"(?<![A-Za-z\d.])\d+(?:\.\d+)?", line)] for line in (want[0], want[1])]
    (j_in, j_mean, _), (j_out,) = nums
    assert got["inner_points"] > 0 and abs(got["inner_points"] - j_in) <= 0.005 * j_in
    assert abs(got["outer_points"] - j_out) <= 0.005 * j_out
    assert got["inner_mean_thickness"] == pytest.approx(j_mean, rel=0.01)
    assert lines[0] == (f"inner: {got['inner_points']} pts, thickness mean {got['inner_mean_thickness']:.3f} "
                        f"max {got['inner_max_thickness']:.3f}")
    for d in ("jax", "port"):
        assert {p.name for p in (tmp_path / d).iterdir()} == {
            "FC_inner_thickness.vtk", "FC_outer_thickness.vtk", "FC_thickness_2d.npz"}
    with np.load(tmp_path / "port" / "FC_thickness_2d.npz") as zp, np.load(tmp_path / "jax" / "FC_thickness_2d.npz") as zj:
        assert zp.files == zj.files == ["x", "y", "thickness"]
        assert len(zp["thickness"]) == got["inner_points"]


def test_cohort_demo_matches_jax(env, tmp_path, monkeypatch, capsys):
    """Two copies of the knee: both scripts finish both (no failure, no
    retry), write the same files, and the port's knees' inner meshes lie
    within phase 8's tolerances of the JAX script's."""
    knees = tmp_path / "knees"
    knees.mkdir()
    for name in ("a.nii.gz", "b.nii.gz"):
        shutil.copy(env / "knee.nii.gz", knees / name)
    run_jax("cohort_demo", [knees, tmp_path / "jax"], monkeypatch, capsys)
    got, lines = run_port(TCohortDemo, [knees, tmp_path / "port"], capsys)
    assert lines[-1].startswith("cohort summary: {")
    assert got == {"done": 2}
    manifest = tmp_path / "port" / "manifest.json"
    records = [json.loads(line) for shard in manifest.parent.glob("manifest.json.h*.jsonl")
               for line in shard.read_text().splitlines() if line.strip()]
    assert records and not [r for r in records if r["status"] in ("failed", "retry")]
    names = {p.name for p in (tmp_path / "port").iterdir() if p.suffix == ".vtk"}
    assert names == {p.name for p in (tmp_path / "jax").iterdir() if p.suffix == ".vtk"}
    assert names == {f"{k}_{t}_{s}.vtk" for k in ("a", "b") for t in ("FC", "TC") for s in ("inner", "outer")}
    for name in sorted(names):
        if "inner" not in name:
            continue
        jm, pm = Mesh.load_vtk(tmp_path / "jax" / name), Mesh.load_vtk(tmp_path / "port" / name)
        assert pm.n_points > 0 and abs(pm.n_points - jm.n_points) <= 0.005 * jm.n_points, name
        assert float(np.mean(pm.point_data)) == pytest.approx(float(np.mean(jm.point_data)), rel=0.01), name
