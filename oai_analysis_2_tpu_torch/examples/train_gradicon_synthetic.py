"""Train GradICON registration weights on synthetic phantoms (port of
`examples/train_gradicon_synthetic.py`).

Random pairs of procedurally generated knee-like phantoms
(`models/synthetic.py`), each volume warped by a random smooth low-res
field, train the bf16 network with the self-supervised GradICON loss plus,
for pairs of one phantom, the known-correspondence supervision
(`make_augmented_train_step`), under Adam with a global-norm clip of 1.0
and a warmup-cosine schedule. Progress is a known-deformation recovery
eval on a held-out phantom (the f32 network, the serving dtype); the best
checkpoint is written in the JAX package's format with `stage_width`,
`grid_shape` and `scales`, plus a `.best` sidecar holding its error.

Usage (on the card):
    python -m oai_analysis_2_tpu_torch.examples.train_gradicon_synthetic [steps] [batch] [out.npz]

Environment: GRADICON_WIDTH (16), GRADICON_GRID (48,96,96), GRADICON_RESUME
(a checkpoint to continue from), GRADICON_SUP_W (0.3), GRADICON_SIM_W (1.0),
GRADICON_LR (peak, 5e-4), GRADICON_POOL (96 phantoms), GRADICON_SEED (42),
GRADICON_LOWRES (6,12,12), GRADICON_SAME (0.7), GRADICON_AMP (0.05 or a
ramp a:b), GRADICON_TRANS (0.04 or a:b), GRADICON_BEST (inf: the error to
beat before a checkpoint is written). The default output is the git-ignored
`build/gradicon/gradicon.npz` (the JAX script writes the package's shipped
weights file by default; the port never writes into the JAX package).
"""

import os
import sys
import time
from pathlib import Path

import numpy as np
import torch

from oai_analysis_2_tpu_torch.core.device import resolve_device, synchronize
from oai_analysis_2_tpu_torch.models.gradicon import (
    GradICON,
    GradICONConfig,
    identity_map,
    load_gradicon_params,
    warp,
)
from oai_analysis_2_tpu_torch.models.synthetic import (
    make_augmented_train_step,
    make_phantom_pool,
    random_lowres_field,
    random_phantom,
)
from oai_analysis_2_tpu_torch.utils import optim
from oai_analysis_2_tpu_torch.utils.checkpoint import save_checkpoint

DEFAULT_OUT = Path(__file__).resolve().parents[2] / "build" / "gradicon" / "gradicon.npz"


def build_eval_pair(shape, seed=12345):
    """Held-out phantom and a known smooth deformation (normalized units,
    about 5 voxels of amplitude)."""
    rng = np.random.default_rng(seed)
    fixed = random_phantom(rng, shape)
    d, h, w = shape
    z, y, x = np.meshgrid(
        np.linspace(0, 1, d, dtype=np.float32),
        np.linspace(0, 1, h, dtype=np.float32),
        np.linspace(0, 1, w, dtype=np.float32),
        indexing="ij",
    )
    amp = 0.05
    g = np.stack(
        [
            amp * np.sin(3.1 * y + 0.7) * np.cos(2.3 * x),
            amp * np.cos(2.9 * z) * np.sin(3.7 * x + 1.1),
            amp * np.sin(2.1 * z + 0.4) * np.cos(3.3 * y),
        ],
        axis=-1,
    ).astype(np.float32)
    return fixed, g


def make_eval(cfg: GradICONConfig, device):
    """`eval_err(model)` -> (error in voxels inside the anatomy, over all
    voxels) of the f32 network with `model`'s weights on the known
    deformation: forward_map(moving, fixed) should be id + g."""
    shape = cfg.grid_shape
    fixed_np, g_np = build_eval_pair(shape)
    fixed = torch.as_tensor(fixed_np, device=device)
    g = torch.as_tensor(g_np, device=device)
    eval_model = GradICON(cfg, device=device)
    ident = identity_map(shape, device)
    moving = warp(fixed, ident + g)
    scale_vox = torch.as_tensor([s - 1.0 for s in shape], dtype=torch.float32, device=device)
    mask = (moving > 0.5).to(torch.float32)

    def eval_err(model: GradICON):
        with torch.no_grad():
            eval_model.load_state_dict(model.state_dict())
            psi = eval_model.forward_map(moving, fixed)
            e = torch.sqrt(torch.sum(((psi - ident - g) * scale_vox) ** 2, dim=-1))
            return float(torch.sum(e * mask) / torch.sum(mask)), float(torch.mean(e))

    return eval_err


def _ramp(spec: str, frac: float) -> float:
    """'a:b' -> linear ramp a -> b over training; plain 'a' -> constant."""
    parts = [float(v) for v in spec.split(":")]
    return parts[0] if len(parts) == 1 else parts[0] + (parts[1] - parts[0]) * frac


def main(argv=None, device=None) -> dict:
    """Train as the module's docstring says; returns a summary (per-step
    seconds with the card synchronized at each step end, the losses, the
    eval errors by step, the best error, the checkpoint path, the resumed
    path, and as stage-params lists the weights training started from and
    those the last checkpoint written holds)."""
    argv = sys.argv[1:] if argv is None else list(argv)
    steps = int(argv[0]) if len(argv) > 0 else 3000
    batch = int(argv[1]) if len(argv) > 1 else 2
    out_path = Path(argv[2]) if len(argv) > 2 else DEFAULT_OUT
    dev = resolve_device(device)

    width = int(os.environ.get("GRADICON_WIDTH", "16"))
    grid = tuple(int(v) for v in os.environ.get("GRADICON_GRID", "48,96,96").split(","))
    cfg = GradICONConfig(grid_shape=grid, stage_width=width)
    shape = cfg.grid_shape
    print(f"config: grid {shape} width {width}", flush=True)
    model = GradICON(cfg, compute_dtype=torch.bfloat16, device=dev).init(torch.Generator().manual_seed(0))
    resume = os.environ.get("GRADICON_RESUME")
    if resume:
        model.load_params(load_gradicon_params(resume))
        print(f"resumed from {resume}", flush=True)
    start_params = model.params_list()

    sup_w = float(os.environ.get("GRADICON_SUP_W", "0.3"))
    sim_w = float(os.environ.get("GRADICON_SIM_W", "1.0"))
    peak_lr = float(os.environ.get("GRADICON_LR", "5e-4"))
    print(f"hyperparams: sup_w {sup_w} sim_w {sim_w} peak_lr {peak_lr}", flush=True)
    sched = optim.warmup_cosine_decay_schedule(
        init_value=0.0, peak_value=peak_lr, warmup_steps=min(100, steps // 10 + 1), decay_steps=steps, end_value=2e-5,
    )
    opt = optim.adam(list(model.parameters()), sched, clip_norm=1.0)
    step = make_augmented_train_step(model, opt, sup_weight=sup_w, sim_weight=sim_w)

    print("generating phantom pool...", flush=True)
    pool = make_phantom_pool(int(os.environ.get("GRADICON_POOL", "96")), shape, seed=7)
    pool_dev = torch.as_tensor(pool, device=dev)
    eval_err = make_eval(cfg, dev)

    rng = np.random.default_rng(int(os.environ.get("GRADICON_SEED", "42")))
    lowres = tuple(int(v) for v in os.environ.get("GRADICON_LOWRES", "6,12,12").split(","))
    same_frac = float(os.environ.get("GRADICON_SAME", "0.7"))
    amp_spec = os.environ.get("GRADICON_AMP", "0.05")
    trans_spec = os.environ.get("GRADICON_TRANS", "0.04")

    def sample_batch(step_i):
        frac = step_i / max(steps - 1, 1)
        amp = _ramp(amp_spec, frac)
        trans = _ramp(trans_spec, frac)
        ia = rng.integers(0, len(pool), batch)
        same = rng.random(batch) < same_frac  # known-correspondence pairs
        ib = np.where(same, ia, rng.integers(0, len(pool), batch))
        ua = np.stack([random_lowres_field(rng, lowres, amplitude=amp, translation=trans) for _ in range(batch)])
        ub = np.stack([random_lowres_field(rng, lowres, amplitude=amp, translation=trans) for _ in range(batch)])
        return (
            pool_dev[torch.as_tensor(ia, device=dev)],
            pool_dev[torch.as_tensor(ib, device=dev)],
            torch.as_tensor(ua, device=dev),
            torch.as_tensor(ub, device=dev),
            torch.as_tensor((same | (ia == ib)).astype(np.float32), device=dev),
        )

    # never overwrite a better checkpoint of an earlier cycle (warm restarts)
    best = float(os.environ.get("GRADICON_BEST", "inf"))
    out_path.parent.mkdir(parents=True, exist_ok=True)
    summary = {"step_seconds": [], "losses": [], "eval": {}, "checkpoint": None, "resumed_from": resume,
               "start_params": start_params, "checkpoint_params": None}
    t0 = time.time()
    for i in range(steps):
        t_step = time.perf_counter()
        loss, sim, reg, sup = step(*sample_batch(i))
        synchronize(dev)
        summary["step_seconds"].append(time.perf_counter() - t_step)
        summary["losses"].append(float(loss))
        if i % 25 == 0:
            print(f"step {i}: loss {float(loss):.4f} sim {float(sim):.4f} reg {float(reg):.4f} "
                  f"sup {float(sup):.3f} ({time.time() - t0:.0f}s)", flush=True)
        if i % 125 == 124 or i == steps - 1:
            e_mask, e_all = eval_err(model)
            summary["eval"][i] = (e_mask, e_all)
            print(f"step {i}: eval recovery error {e_mask:.3f} vox (anatomy) {e_all:.3f} vox (all)", flush=True)
            if e_mask < best:
                best = e_mask
                saved = model.params_list()
                save_checkpoint(
                    {
                        "params": {f"stage{k}": p for k, p in enumerate(saved)},
                        "epoch": i,
                        "stage_width": width,
                        "grid_shape": list(shape),
                        "scales": list(cfg.scales),
                    },
                    is_best=False,
                    path=out_path.parent,
                    name=out_path.name,
                )
                # the best-error sidecar lets a warm-restart cycle resume the
                # tracker (GRADICON_BEST=$(cat out.best))
                (out_path.parent / (out_path.name + ".best")).write_text(f"{best:.6f}")
                summary["checkpoint"] = str(out_path)
                summary["checkpoint_params"] = saved
                print(f"  saved {out_path} (best {best:.3f} vox)", flush=True)
    print(f"done in {time.time() - t0:.0f}s; best eval {best:.3f} vox")
    summary["best"] = best
    summary["model"] = model
    return summary


if __name__ == "__main__":
    main()
