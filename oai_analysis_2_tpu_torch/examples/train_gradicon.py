"""Train a GradICON registration network on knee pairs (port of
`examples/train_gradicon.py`): random pairs of preprocessed NIfTI knees on
the registration grid, LNCC + gradient-inverse-consistency loss, Adam
(5e-5), a checkpoint every 500 steps in the JAX package's format.

Usage (on the card):
    python -m oai_analysis_2_tpu_torch.examples.train_gradicon <dir_with_nii_gz> <ckpt_dir> [steps]
"""

import sys
from pathlib import Path

import numpy as np
import torch

from oai_analysis_2_tpu_torch.core.device import resolve_device
from oai_analysis_2_tpu_torch.core.nifti import read_nifti
from oai_analysis_2_tpu_torch.engine.registration import _net_grid_reference
from oai_analysis_2_tpu_torch.models.gradicon import GradICON, GradICONConfig, make_gradicon_train_step
from oai_analysis_2_tpu_torch.ops.intensity import percentile_window
from oai_analysis_2_tpu_torch.ops.resample import resample_image
from oai_analysis_2_tpu_torch.utils import optim
from oai_analysis_2_tpu_torch.utils.checkpoint import save_checkpoint


def main(argv=None, device=None) -> Path:
    """Train as the module's docstring says; returns the checkpoint path."""
    argv = sys.argv[1:] if argv is None else list(argv)
    data_dir = Path(argv[0])
    ckpt_dir = Path(argv[1])
    steps = int(argv[2]) if len(argv) > 2 else 2000
    dev = resolve_device(device)

    cfg = GradICONConfig()
    model = GradICON(cfg, compute_dtype=torch.bfloat16, device=dev).init(torch.Generator().manual_seed(0))
    step = make_gradicon_train_step(model, optim.adam(list(model.parameters()), 5e-5))

    # every volume onto the registration grid once
    volumes = []
    for p in sorted(data_dir.glob("*.nii.gz")):
        img = percentile_window(read_nifti(p, device=dev))
        grid = _net_grid_reference(img, cfg.grid_shape)
        volumes.append(resample_image(img, grid).data.to(torch.float32))
    if len(volumes) < 2:
        raise SystemExit("need at least 2 volumes to sample pairs")
    volumes = torch.stack(volumes)
    print(f"{len(volumes)} volumes on grid {cfg.grid_shape}")

    rng = np.random.default_rng(0)
    out = ckpt_dir / "gradicon.npz"
    for i in range(steps):
        ia, ib = rng.choice(len(volumes), 2, replace=False)
        loss = step(volumes[ia][None], volumes[ib][None])
        if i % 50 == 0:
            print(f"step {i}: loss {float(loss):.4f}")
        if i % 500 == 499 or i == steps - 1:
            save_checkpoint({"params": {f"stage{k}": p for k, p in enumerate(model.params_list())}, "epoch": i},
                            is_best=False, path=ckpt_dir, name=out.name)
    print("done; checkpoint at", out)
    return out


if __name__ == "__main__":
    main()
