"""`tools/port_instance_spread.py`: the one-ulp perturbation of the
validator's phantom changes rounding only, reaches the unchanged JAX script
and the port's `validate_registration.main` alike, and both packages'
spread runs work end to end (16x32x32, a few steps)."""

import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest

from oai_analysis_2_tpu_torch.examples import validate_registration as TV

ROOT = Path(__file__).resolve().parents[1]
SMALL = ["16", "32", "32", "--net-grid", "16,32,32", "--inst-steps", "2,2,2"]


def load_tool():
    spec = importlib.util.spec_from_file_location("port_instance_spread", ROOT / "tools" / "port_instance_spread.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("share", [0.01, 0.05])
def test_ulp_perturb_moves_each_chosen_voxel_by_one_ulp(share):
    vol, _ = TV.phantom((16, 32, 32))
    got = TV.ulp_perturb(vol, share=share, seed=3)
    assert got.dtype == np.float32 and got.shape == vol.shape
    moved = got != vol
    assert moved.sum() == round(share * vol.size)
    # adjacent f32 values: one step from the old value reaches the new one
    assert np.array_equal(np.nextafter(vol[moved], got[moved]), got[moved])
    assert (got[moved] > vol[moved]).any() and (got[moved] < vol[moved]).any()
    assert np.array_equal(got[~moved], vol[~moved])
    np.testing.assert_array_equal(vol, TV.phantom((16, 32, 32))[0])  # the input is left as it was


def test_ulp_perturb_seeds():
    vol, _ = TV.phantom((16, 32, 32))
    a, b = TV.ulp_perturb(vol, seed=1), TV.ulp_perturb(vol, seed=1)
    c = TV.ulp_perturb(vol, seed=2)
    assert np.array_equal(a, b)
    assert not np.array_equal(a != vol, c != vol)


def test_port_main_and_jax_wrapper_perturb_the_same_phantom(monkeypatch):
    """The voxels the port's `main(perturb=...)` registers are the ones the
    tool's wrapper gives the JAX script's first `image_from_array`."""
    import oai_analysis_2_tpu.core.image as jimage

    seen = {}
    make = jimage.image_from_array

    def record(data, *args, **kwargs):
        seen.setdefault("jax", np.asarray(data))
        return make(data, *args, **kwargs)

    monkeypatch.setattr(jimage, "image_from_array", record)
    wrapped = {}

    def port_image(data, *args, **kwargs):
        wrapped.setdefault("port", np.asarray(data).copy())
        return real_port(data, *args, **kwargs)

    real_port = TV.image_from_array
    monkeypatch.setattr(TV, "image_from_array", port_image)
    TV.main(SMALL, device="cpu", perturb=(5, 0.01))
    tool = load_tool()
    tool.jax_run(SMALL, (5, 0.01))
    vol, _ = TV.phantom((16, 32, 32))
    assert np.array_equal(wrapped["port"], seen["jax"])
    assert np.array_equal(seen["jax"], TV.ulp_perturb(vol, share=0.01, seed=5))


def test_plan_and_band():
    tool = load_tool()
    assert tool.plan(8, [2, 1]) == [(0, 2), (0, 1), (1, 2), (2, 2), (3, 2), (4, 2), (5, 2), (6, 2)]
    assert tool.plan(1, [2, 1]) == [(0, 2)]
    b = tool.band([1.0, 2.0, 3.0])
    assert b == {"n": 3, "min": 1.0, "max": 3.0, "mean": 2.0, "std": 1.0}


def test_spread_runs_both_packages(tmp_path, capsys):
    """Two runs a package (the unperturbed phantom and seed 1) at
    16x32x32: each run's errors, the bands, and the JSON written."""
    tool = load_tool()
    out = tmp_path / "spread.json"
    report = tool.main(["--runs", "2", "--workers", "4", "--threads", "1", "--out", str(out), "--", *SMALL])
    assert json.loads(out.read_text()) == json.loads(json.dumps(report))
    runs = report["runs"]
    assert sorted((r["package"], r["seed"]) for r in runs) == [("jax", 0), ("jax", 1), ("port", 0), ("port", 1)]
    for r in runs:
        assert all(np.isfinite(r[k]) and r[k] > 0 for k in ("err_mean_mm", "err_median_mm", "err_p95_mm"))
    for p in ("jax", "port", "combined"):
        b = report["bands"][p]
        assert b["min"] <= b["mean"] <= b["max"] and b["std"] >= 0
    # two steps a scale from the identity: one ulp at 1 % of the voxels
    # moves each package's result by rounding only (lr 1.2 on this grid is
    # chaotic over longer runs, so the packages are held apart only loosely)
    by = {(r["package"], r["seed"]): r["err_mean_mm"] for r in runs}
    assert abs(by["jax", 1] - by["jax", 0]) < 2e-3 and abs(by["port", 1] - by["port", 0]) < 2e-3
    assert abs(by["jax", 0] - by["port", 0]) < 0.1 * by["jax", 0]


def test_trace_holds_the_cpu_against_itself(tmp_path):
    """`tools/port_instance_trace.py --card cpu`: the "card" run is the CPU
    run, so every loss gap and every hand-off gap is 0, while the
    perturbed CPU run (seed 1) opens a gap; the report's parts present."""
    spec = importlib.util.spec_from_file_location("port_instance_trace", ROOT / "tools" / "port_instance_trace.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    steps = ["16", "32", "32", "--net-grid", "16,32,32", "--inst-steps", "4,4,4"]
    report = tool.main(["--card", "cpu", "--cpu-seeds", "0,1", "--threads", "2", "--handoff",
                        "4x8x8:0,2;16x32x32:1", "--out", str(tmp_path / "trace.json"), "--", *steps])
    assert json.loads((tmp_path / "trace.json").read_text())["runs"] == report["runs"]
    card, cpu0, cpu1 = report["runs"]
    assert card["err_mean_mm"] == cpu0["err_mean_mm"] and cpu1["seed"] == 1
    assert report["losses"]["card"] == report["losses"]["cpu_seed0"] != report["losses"]["cpu_seed1"]
    assert sorted(report["rel_loss_gap_at_steps"]) == ["16x32x32", "4x8x8", "8x16x16"]
    assert all(g == 0.0 for scale in report["rel_loss_gap_at_steps"].values() for g in scale["card"].values())
    assert any(g > 0.0 for scale in report["rel_loss_gap_at_steps"].values() for g in scale["cpu_seed1"].values())
    assert report["card_first_step_beyond_10x_envelope"] is None
    assert sorted(report["handoff"]) == ["16x32x32@1", "4x8x8@0", "4x8x8@2"]
    for h in report["handoff"].values():
        assert all(h[k] == {"max_rel": 0.0, "over_1e-3": 0} for k in ("sim_ab", "sim_ba", "gicon", "diffusion"))
        assert h["maps_max_abs"] == 0.0 and h["cells_differ"] == 0 and h["steps_off_by_a_quarter"] == 0
        assert h["adam_alone_max_abs_in_steps"] == 0.0 and h["steps"] > 0
    assert report["handoff"]["4x8x8@2"]["t"] == 2


def test_lr_sweep_summary():
    """Per lr, each package's band and whether its runs agree within 1e-3
    mm; the gap of the means against both spreads, and the lowest lr at
    which it exceeds both."""
    tool = load_tool()
    runs = [{"package": p, "lr": lr, "err_mean_mm": v}
            for lr, vals in ((0.1, {"jax": [1.0, 1.0004], "port": [1.0002, 1.0001]}),
                             (1.2, {"jax": [1.0, 1.01], "port": [1.1, 1.12]}))
            for p, vs in vals.items() for v in vs]
    got = tool.lr_sweep(runs, ["jax", "port"], [0.1, 1.2])
    low, high = got["per_lr"]["0.1"], got["per_lr"]["1.2"]
    assert low["deterministic"] == {"jax": True, "port": True} and low["agree_within_tol"]
    assert not low["gap_exceeds_spreads"]
    assert high["deterministic"] == {"jax": False, "port": False} and "agree_within_tol" not in high
    assert high["gap_exceeds_spreads"] and got["gap_opens_at_lr"] == 1.2
    assert abs(high["gap_mm"] - 0.105) < 1e-9


def test_port_with_all_of_jaxs_parts_is_jax_stepwise(tmp_path):
    """`port+step+images+pyramid+finish` (the port's run with JAX's step,
    grid images, pyramid and finish) lands on `jax_steps`'s error: nothing
    else in the port's run moves it. Within 1e-6 mm, since each package
    reads the error off its maps with its own pipeline (on the same maps
    the two reads agree to 3e-7 mm). 16x32x32, two steps a scale, the
    phantom moved to another base."""
    tool = load_tool()
    report = tool.main(["--packages", "jax_steps,port+step+images+pyramid+finish", "--runs", "1", "--workers", "2",
                        "--threads", "1", "--base", "3", "--out", str(tmp_path / "parts.json"), "--", *SMALL])
    by = {r["package"]: r for r in report["runs"]}
    assert by["jax_steps"]["base"] == 3
    assert abs(by["jax_steps"]["err_mean_mm"] - by["port+step+images+pyramid+finish"]["err_mean_mm"]) <= 1e-6


def test_unknown_packages_are_refused():
    tool = load_tool()
    for bad in ("port+adam", "jax+step", "torch"):
        with pytest.raises(SystemExit, match="unknown packages"):
            tool.main(["--packages", bad, "--runs", "1", "--", *SMALL])
