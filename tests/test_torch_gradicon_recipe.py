"""The w24 GradICON recipe's warm-restart cycles on the CPU.

(a) `tools/port_train_w24_cycles.run_cycles` at width 4 on a 16x32x32
grid, a pool of 4, three cycles of 3 steps: the first cycle writes the
checkpoint, the second (lr 0.5, which wrecks the network) writes nothing,
the third starts from the first cycle's checkpoint on disk, not from the
second's last weights; `.best` never rises; the final file is read by the
JAX package's `load_gradicon_checkpoint`. The tool's gates fire on a cycle
that does not resume and on a checkpoint that does not reload bit-equal.

(b) Both packages' trainer scripts (`examples/train_gradicon_synthetic.py`
with `sys.argv` set, and the port's module) run two cycles of 4 steps at
width 2 on a 16x32x32 grid (bf16, sup 1.0 / sim 0.1, pool 4, low-res 2x4x4,
peak lr 3e-4 in both cycles, so JAX compiles each function once) from the
same weights: JAX's `init(PRNGKey(0))` (zero heads) written to an npz and
passed as `GRADICON_RESUME`; the second cycle resumes from each package's
own checkpoint with its own sidecar as `GRADICON_BEST`. Tolerances, set
from measured gaps (in brackets) with margin: the losses a step within
1e-4 relative (1.7e-6 to 3.8e-6: bf16 convs summed in another order); the
sidecars' evals within 5e-4 vox (2e-5 to 4.3e-5) and the printed evals
within 1e-3 (they carry 3 decimals); the checkpointed weights through
their moves from the initial weights, since Adam moves an element whose
gradient is near zero by about lr with a sign that rounding picks: over
the whole model the two moves' cosine at least 0.9 (0.956 to 0.975) and
their norms within 5 % (0.991 to 0.996), each head's move (the heads take
the large, consistent gradients from the first step on) a cosine of at
least 0.99 (0.9955 or more).
"""

import importlib.util
import io
import os
import re
import sys
from contextlib import redirect_stdout
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from oai_analysis_2_tpu.models import gradicon as JG
from oai_analysis_2_tpu.models import synthetic as JSyn
from oai_analysis_2_tpu.utils.checkpoint import save_checkpoint as jsave_checkpoint
from oai_analysis_2_tpu_torch.examples import train_gradicon_synthetic as trainer
from oai_analysis_2_tpu_torch.utils.checkpoint import flatten_tree

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
GRID = (16, 32, 32)
SMALL = dict(width=4, grid=GRID, validators=(0,), shipped=False, validate_shape=GRID)


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def tool():
    return _load("port_train_w24_cycles", ROOT / "tools" / "port_train_w24_cycles.py")


def _flat(params_list):
    return {k: np.asarray(v) for k, v in flatten_tree({f"stage{i}": p for i, p in enumerate(params_list)}).items()}


def test_run_cycles_hand_off(tool, tmp_path, monkeypatch):
    monkeypatch.setenv("GRADICON_SEED", "7")  # an ambient variable the recipe must not see, restored after
    starts, saved = [], []
    real_main = trainer.main

    def main(argv, device):
        summary = real_main(argv, device=device)
        starts.append(summary["start_params"])
        saved.append(summary["checkpoint_params"])
        return summary

    monkeypatch.setattr(trainer, "main", main)
    out = tmp_path / "w24" / "gradicon.npz"
    report = tool.run_cycles(out, steps_per_cycle=3, lrs=(3e-4, 0.5, 3e-4), pool=4, device="cpu", **SMALL)
    cycles = report["cycles"]
    assert [c["checkpoint_written"] for c in cycles] == [True, False, False]
    assert [c["resumed_from"] for c in cycles] == [None, str(out.resolve()), str(out.resolve())]
    bests = [c["best_after"] for c in cycles]
    assert bests == sorted(bests, reverse=True) and report["best_eval_vox"] == bests[-1]
    assert cycles[1]["eval"][2][0] > 5 * bests[0]  # lr 0.5 wrecked the second cycle's weights
    # the third cycle started from the first cycle's checkpoint, not the second cycle's last weights
    first = _flat(saved[0])
    for key, v in _flat(starts[2]).items():
        np.testing.assert_array_equal(v, first[key])
    assert all(c["reload_eval_vox"] == pytest.approx(c["best_after"], abs=1e-6) for c in cycles)
    assert all(c["launches_per_step"] == {k: 0 for k in c["launches_per_step"]} for c in cycles)
    jparams, jmeta = JG.load_gradicon_checkpoint(out)
    assert jmeta == {"stage_width": 4, "grid_shape": GRID, "scales": (4, 2, 1)}
    for key, v in _flat(jparams).items():
        np.testing.assert_array_equal(v, first[key])
    v = report["validators"]["trained_network0"]
    assert np.isfinite(list(v.values())).all() and set(v) >= {"err_mean_mm", "ice_mean_vox", "fold_fraction_ab"}
    assert os.environ["GRADICON_SEED"] == "7" and "GRADICON_LR" not in os.environ


@pytest.mark.parametrize("fault", ["no_resume", "checkpoint_differs"])
def test_run_cycles_gates(tool, tmp_path, monkeypatch, fault):
    """A second cycle that starts from other weights than the file on disk,
    or a checkpoint that is not the weights it claims, stops the run."""
    if fault == "no_resume":
        real = trainer.load_gradicon_params
        monkeypatch.setattr(trainer, "load_gradicon_params",
                            lambda path: [{**p, "head": {**p["head"], "bias": p["head"]["bias"] + 1e-3}}
                                          for p in real(path)])
        message = "did not start from the checkpoint on disk"
    else:
        real = trainer.save_checkpoint

        def save(state, *args, **kw):
            state = dict(state, params={k: {**p, "head": {**p["head"], "bias": p["head"]["bias"] + 1e-3}}
                                        for k, p in state["params"].items()})
            return real(state, *args, **kw)

        monkeypatch.setattr(trainer, "save_checkpoint", save)
        message = "does not reload bit-equal"
    with pytest.raises(tool.RecipeFault, match=message):
        tool.run_cycles(tmp_path / "g.npz", steps_per_cycle=2, lrs=(3e-4, 3e-4), pool=2, device="cpu",
                        **dict(SMALL, width=2))


def test_run_cycles_refuses_the_shipped_file(tool):
    from oai_analysis_2_tpu_torch.models.gradicon import default_gradicon_weights_path

    with pytest.raises(ValueError, match="shipped weights"):
        tool.run_cycles(default_gradicon_weights_path(), device="cpu", **SMALL)


# ---- (b) both packages' trainer scripts -------------------------------------------

B_STEPS = 4
B_LRS = (3e-4, 3e-4)
B_WIDTH = 2
EVAL_LINE = re.compile(r"step (\d+): eval recovery error ([\d.]+) vox")


@pytest.fixture(scope="module")
def both_trainers(tmp_path_factory):
    """Each package's two cycles: losses a step, printed evals and the
    sidecar after each cycle, whether it wrote, and the final checkpoint."""
    root = tmp_path_factory.mktemp("recipe")
    cfg = JG.GradICONConfig(grid_shape=GRID, stage_width=B_WIDTH)
    init = JG.GradICON(cfg).init(jax.random.PRNGKey(0))
    jsave_checkpoint({"params": {f"stage{i}": p for i, p in enumerate(init)}, "epoch": -1, "stage_width": B_WIDTH,
                      "grid_shape": list(GRID), "scales": list(cfg.scales)},
                     is_best=False, path=root, name="init.npz")
    jscript = _load("jax_train_gradicon_synthetic", ROOT / "examples" / "train_gradicon_synthetic.py")
    real_step = JSyn.make_augmented_train_step
    jax_losses = []

    def recording_step(*a, **kw):
        step = real_step(*a, **kw)

        def run(*args):
            out = step(*args)
            jax_losses.append(float(out[2][0]))
            return out

        return run

    runs = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JSyn, "make_augmented_train_step", recording_step)
        for k, v in dict(GRADICON_WIDTH=str(B_WIDTH), GRADICON_GRID=",".join(map(str, GRID)), GRADICON_POOL="4",
                         GRADICON_LOWRES="2,4,4", GRADICON_SUP_W="1.0", GRADICON_SIM_W="0.1").items():
            mp.setenv(k, v)
        for pkg in ("jax", "port"):
            out = root / pkg / "gradicon.npz"
            sidecar = out.parent / "gradicon.npz.best"
            runs[pkg] = []
            for c, lr in enumerate(B_LRS):
                mp.setenv("GRADICON_LR", str(lr))
                mp.setenv("GRADICON_RESUME", str(root / "init.npz") if c == 0 else str(out))
                mp.setenv("GRADICON_BEST", sidecar.read_text() if c else "inf")
                stamp = out.stat().st_mtime_ns if out.exists() else None
                if pkg == "jax":
                    jax_losses.clear()
                    mp.setattr(sys, "argv", ["examples/train_gradicon_synthetic.py", str(B_STEPS), "2", str(out)])
                    lines = _printed(jscript.main)
                    losses = list(jax_losses)
                else:
                    summary = {}
                    lines = _printed(lambda: summary.update(trainer.main([str(B_STEPS), "2", str(out)], device="cpu")))
                    losses = summary["losses"]
                evals = {int(m.group(1)): float(m.group(2)) for m in map(EVAL_LINE.search, lines) if m}
                runs[pkg].append(dict(losses=losses, evals=evals, best=float(sidecar.read_text()),
                                      written=out.stat().st_mtime_ns != stamp))
            runs[pkg + "_params"] = _flat(JG.load_gradicon_checkpoint(out)[0])
    runs["init"] = _flat(init)
    return runs


def _printed(fn) -> list:
    """The lines `fn()` prints."""
    buf = io.StringIO()
    with redirect_stdout(buf):
        fn()
    return buf.getvalue().splitlines()


@pytest.mark.parametrize("cycle", [0, 1])
def test_trainer_cycles_match_jax(both_trainers, cycle):
    j, p = both_trainers["jax"][cycle], both_trainers["port"][cycle]
    assert len(j["losses"]) == len(p["losses"]) == B_STEPS
    np.testing.assert_allclose(p["losses"], j["losses"], rtol=1e-4)
    assert j["written"] and p["written"]  # both cycles improve on these pairs, in both packages
    assert p["best"] == pytest.approx(j["best"], abs=5e-4)
    assert p["evals"].keys() == j["evals"].keys() == {B_STEPS - 1}
    assert p["evals"][B_STEPS - 1] == pytest.approx(j["evals"][B_STEPS - 1], abs=1e-3)


def test_trainer_checkpoints_match_jax(both_trainers):
    init, jp, pp = both_trainers["init"], both_trainers["jax_params"], both_trainers["port_params"]
    assert jp.keys() == pp.keys() == init.keys()
    keys = sorted(init)
    dj = np.concatenate([(jp[k] - init[k]).ravel() for k in keys])
    dp = np.concatenate([(pp[k] - init[k]).ravel() for k in keys])
    assert float(dj @ dp) / float(np.linalg.norm(dj) * np.linalg.norm(dp)) >= 0.9
    assert float(np.linalg.norm(dp) / np.linalg.norm(dj)) == pytest.approx(1.0, abs=0.05)
    for k in (k for k in keys if "/head/" in k):
        mj, mp = (jp[k] - init[k]).ravel(), (pp[k] - init[k]).ravel()
        assert float(mj @ mp) / float(np.linalg.norm(mj) * np.linalg.norm(mp)) >= 0.99, k
