"""The port's registration validators (`oai_analysis_2_tpu_torch/examples/
validate_registration.py`, `validate_registration_cross.py`) against the
unchanged JAX scripts in `examples/`, on the CPU.

Each JAX script is loaded from its file with `sys.argv` set, its stdout
captured; the port's `main(argv, device="cpu")` runs on the same
arguments, and the numbers both print are compared with the tolerance
stated per case. The sizes are small (16x32x32 volumes and grids), the
instance path takes few steps (Adam at lr 1.2 is chaotic on such grids
over long runs). Also: the port's `jacobian_stats` and `random_phantom`
against the JAX package's, and the six example modules' imports and
device default.
"""

import ast
import dataclasses
import importlib.util
import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from oai_analysis_2_tpu.models import gradicon as JG
from oai_analysis_2_tpu.models.synthetic import random_phantom as jphantom
from oai_analysis_2_tpu_torch.examples import validate_registration as TV
from oai_analysis_2_tpu_torch.examples import validate_registration_cross as TX
from oai_analysis_2_tpu_torch.models.synthetic import random_phantom as tphantom

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ("validate_registration", "validate_registration_cross", "full_demo", "segmentation_demo",
            "thickness_demo", "cohort_demo")
SMALL = ("16", "32", "32", "--net-grid", "16,32,32")
# a printed number (not the digits of a name such as "p95")
NUMBER = re.compile(r"(?<![A-Za-z\d.])-?\d+(?:\.\d+)?")


def load_script(name):
    """The JAX package's example script `examples/<name>.py` as a module."""
    spec = importlib.util.spec_from_file_location(f"jax_example_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_jax(name, argv, monkeypatch, capsys):
    """The JAX script's printed lines on `argv`."""
    capsys.readouterr()
    monkeypatch.setattr(sys, "argv", [f"examples/{name}.py", *argv])
    load_script(name).main()
    return capsys.readouterr().out.strip().splitlines()


def run_port(mod, argv, capsys, **kw):
    capsys.readouterr()
    got = mod.main(list(argv), device="cpu", **kw)
    return got, capsys.readouterr().out.strip().splitlines()


def numbers(line):
    return [float(v) for v in NUMBER.findall(line)]


def without_seconds(line):
    return re.sub(r"\d+\.\d+s\b", "<s>", line)


def compare(jax_lines, port_lines, atols):
    """The first lines equal but for the seconds; on each later line the
    printed numbers within the line's absolute tolerances (one per number)."""
    assert len(jax_lines) == len(port_lines) == len(atols) + 1
    assert without_seconds(port_lines[0]) == without_seconds(jax_lines[0])
    for j, p, tol in zip(jax_lines[1:], port_lines[1:], atols):
        assert NUMBER.sub("#", p) == NUMBER.sub("#", j)
        gaps = np.abs(np.subtract(numbers(p), numbers(j)))
        assert (gaps <= np.asarray(tol)).all(), f"{p!r} against {j!r}: gaps {gaps.tolist()}"


# validate_registration's printed numbers, per line: MSE before, after (5
# decimals), their ratio (%, 2 decimals); the GT amplitude, the error's
# mean, median and p95 (mm, 3 decimals). The network, alone or with two
# fine-tuning steps (lr 0.15), agrees to every printed digit. Four instance
# steps at lr 1.2 from the identity turn rounding into whole near-sign Adam
# steps at a few voxels: gaps of up to 1e-5 in MSE, 0.14 % in the ratio and
# 0.022 mm in the error were seen, so 3e-5, 0.3 % and 0.04 mm.
EXACT_VALIDATE = [[0, 0, 0], [0, 0, 0, 0]]
VALIDATE_CASES = {
    "network0": (SMALL + ("--network", "0"), EXACT_VALIDATE),
    "network2": (SMALL + ("--network", "2"), EXACT_VALIDATE),
    "instance": (SMALL + ("--inst-scales", "2,1", "--inst-steps", "2,2"), [[0, 3e-5, 0.3], [0, 0.04, 0.04, 0.04]]),
}


@pytest.mark.parametrize("case", list(VALIDATE_CASES))
def test_validate_registration_matches_jax(case, monkeypatch, capsys):
    argv, atols = VALIDATE_CASES[case]
    want = run_jax("validate_registration", argv, monkeypatch, capsys)
    got, lines = run_port(TV, argv, capsys)
    compare(want, lines, atols)
    assert got["shape"] == (16, 32, 32) and got["grid"] == (16, 32, 32)
    assert got["err_mean_mm"] == pytest.approx(numbers(lines[2])[1], abs=5e-4)
    assert got["mse_ratio"] == pytest.approx(got["mse_after"] / got["mse_before"])


def test_validate_registration_parse():
    """The JAX script's argument rules: the count after --network (per scale
    with commas, which must match --ft-scales), grid dims anywhere."""
    a = TV.parse_args(["--network", "5,6", "--ft-scales", "4,2", "8", "16", "16", "--ft-lr", "0.3"])
    assert a["use_network"] and a["finetune"] == [5, 6] and a["ft_scales"] == (4, 2)
    assert a["shape"] == (8, 16, 16) and a["ft_lr"] == 0.3 and a["net_grid"] is None
    a = TV.parse_args(["--network", "--weights", "w.npz", "--early-stop", "0.01", "--gicon-grad", "exact"])
    assert a["finetune"] == 10 and a["weights_path"] == "w.npz" and a["early_stop"] == 0.01
    assert a["gicon_grad"] == "exact" and a["shape"] == (80, 192, 192)
    a = TV.parse_args([])
    assert not a["use_network"] and a["inst_scales"] == (4, 2, 1) and a["inst_steps"] == (80, 60, 40)
    with pytest.raises(SystemExit):
        TV.parse_args(["--network", "5,6"])


@dataclasses.dataclass(frozen=True)
class SmallConfig(JG.GradICONConfig):
    grid_shape: tuple = (16, 32, 32)


# validate_registration_cross's printed numbers, per line: MSE before,
# after (5 decimals), their ratio (%, 1 decimal), LNCC (4 decimals); the
# inverse consistency's mean, median, p95 (vox, 3 decimals); the
# Jacobian's median, p1, p99 (3 decimals) and folded share (%, 2
# decimals). The network alone agrees to every printed digit; two
# fine-tuning steps at the instance lr (1.2) moved the inverse consistency
# by up to 0.002 vox and the Jacobian's p99 by 0.022, so 0.005 and 0.05.
CROSS_CASES = {
    "network0": (("--network", "0"), [[0, 0, 0, 0], [0, 0, 0], [0, 0, 0, 0]]),
    "network2": (("--network", "2"), [[0, 2e-5, 0.1, 2e-4], [5e-3, 5e-3, 5e-3], [5e-3, 5e-3, 0.05, 0.05]]),
}


@pytest.mark.parametrize("case", list(CROSS_CASES))
def test_validate_registration_cross_matches_jax(case, monkeypatch, capsys):
    argv, atols = CROSS_CASES[case]
    monkeypatch.setattr(JG, "GradICONConfig", SmallConfig)
    want = run_jax("validate_registration_cross", argv, monkeypatch, capsys)
    got, lines = run_port(TX, argv, capsys, shape=(16, 32, 32))
    compare(want, lines, atols)
    assert got["folded"] == pytest.approx(numbers(lines[3])[-1] / 100, abs=5e-5)


def test_validate_registration_cross_instance_runs(capsys):
    """Instance mode (4, 2, 1 x 80, 60, 40 steps at lr 1.2): chaotic on a
    16x32x32 grid in both packages, so the port alone: the JAX script's
    lines, finite numbers, a better image match and the same folded share
    as the Jacobian it returns."""
    got, lines = run_port(TX, [], capsys, shape=(16, 32, 32))
    assert lines[0].startswith("mode instance; registration ") and lines[0].endswith(" on grid (16, 32, 32)")
    assert [NUMBER.sub("#", line) for line in lines[1:]] == [
        "image MSE: before # -> after # (#%); LNCC-loss after #",
        "inverse consistency |phi_AB o phi_BA - id| (vox, interior): mean # median # p95 #",
        "Jacobian det: median # [p1 #, p99 #], folded #%",
    ]
    assert all(np.isfinite(v) for v in got.values() if isinstance(v, float))
    assert got["mse_after"] < got["mse_before"] and 0.0 <= got["folded"] < 1.0


def test_jacobian_stats_bit_equal():
    """The port's copy against the JAX script's on a fixed smooth map."""
    shape = (9, 12, 10)
    rng = np.random.default_rng(3)
    ident = np.stack(np.meshgrid(*[np.linspace(0, 1, n, dtype=np.float32) for n in shape], indexing="ij"), -1)
    phi = (ident + 0.02 * rng.normal(size=ident.shape)).astype(np.float32)
    want = load_script("validate_registration_cross").jacobian_stats(phi, shape)
    np.testing.assert_array_equal(TX.jacobian_stats(phi, shape), want)
    np.testing.assert_array_equal(TX.jacobian_stats(torch.as_tensor(phi), shape), want)
    assert want.shape == (5, 8, 6)


def test_random_phantom_consumes_the_generator_as_jax():
    """Two draws from one seed equal the JAX package's, and the generator is
    left in the same state."""
    rt, rj = np.random.default_rng(2024), np.random.default_rng(2024)
    for _ in range(2):
        np.testing.assert_array_equal(tphantom(rt, (16, 32, 32)), jphantom(rj, (16, 32, 32)))
    assert rt.integers(0, 2**62) == rj.integers(0, 2**62)


def imports_of(path):
    names = set()
    for node in ast.walk(ast.parse(Path(path).read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module)
    return names


def test_example_modules_import_nothing_of_jax():
    """No import of jax, of the JAX package or of the root examples/ in any
    example module's source, nor in a fresh process that imports them all."""
    banned = ("jax", "jaxlib", "oai_analysis_2_tpu", "examples")
    for name in EXAMPLES:
        mods = imports_of(ROOT / "oai_analysis_2_tpu_torch" / "examples" / f"{name}.py")
        assert not {m for m in mods if m.split(".")[0] in banned}, name
    code = (
        "import sys, json, importlib\n"
        f"for name in {EXAMPLES!r}: importlib.import_module('oai_analysis_2_tpu_torch.examples.' + name)\n"
        f"print(json.dumps(sorted(m for m in sys.modules if m.split('.')[0] in {banned!r})))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_examples_run_as_modules_and_default_to_the_card():
    """`python -m` reaches each module's main, which with no device asks for
    the card and raises here (no CUDA) before it reads or writes a file."""
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a machine without CUDA")
    code = (
        "import runpy, sys, json\n"
        "out = {}\n"
        f"for name, argv in {[(n, a) for n, a in zip(EXAMPLES, ([], [], ['phantom', 'no_dir'], ['knee.nii.gz', 'no_dir'], ['p.nii.gz', 'FC', 'no_dir'], ['no_dir']))]!r}:\n"
        "    sys.argv = [name] + argv\n"
        "    try:\n"
        "        runpy.run_module('oai_analysis_2_tpu_torch.examples.' + name, run_name='__main__')\n"
        "        out[name] = 'ran'\n"
        "    except RuntimeError as e:\n"
        "        out[name] = str(e)\n"
        "print(json.dumps(out))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert set(got) == set(EXAMPLES)
    for name, msg in got.items():
        assert "CUDA is not available" in msg, (name, msg)
