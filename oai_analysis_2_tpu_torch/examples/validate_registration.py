"""Known-deformation registration check (port of
`examples/validate_registration.py`).

Builds a DESS-sized phantom knee, deforms it with a known smooth
displacement field to make the moving volume, registers the pair, and
reports the error of the recovered field inside the anatomy (mm) and the
image-match improvement.

Usage (on the card):
    python -m oai_analysis_2_tpu_torch.examples.validate_registration [vol_z vol_y vol_x]
        [--network [finetune_steps | s1,s2,...]] [--net-grid Z,Y,X]
        [--ft-scales S1,S2,...] [--ft-lr LR] [--weights PATH]
        [--inst-scales S1,...] [--inst-steps N1,...] [--gicon-grad MODE]
        [--early-stop TOL]

`--network` registers with the GradICON weights (the shipped ones, or
`--weights PATH`, whose recorded `stage_width` / `grid_shape` / `scales`
configure the network) plus the given fine-tuning steps per scale (10 by
default); without it, instance optimization from the identity
(`--inst-scales`, `--inst-steps`: 4,2,1 x 80,60,40). `--net-grid`
overrides the registration grid. The arguments, their defaults and the
printed lines are the JAX script's; `main` also returns the printed
numbers.
"""

import dataclasses
import sys
import time

import numpy as np
import torch

from oai_analysis_2_tpu_torch.core.device import resolve_device, synchronize
from oai_analysis_2_tpu_torch.core.image import image_from_array, physical_grid
from oai_analysis_2_tpu_torch.engine.registration import register_pair
from oai_analysis_2_tpu_torch.models.gradicon import GradICON, GradICONConfig, load_gradicon_checkpoint
from oai_analysis_2_tpu_torch.ops.resample import DisplacementField, resample_image, sample_displacement

SPACING = (0.36, 0.36, 0.7)
GT_AMPLITUDE_MM = 2.5


def _take(argv, flag, convert, default):
    """`flag VALUE` removed from `argv`, VALUE converted; `default` if absent."""
    if flag not in argv:
        return default
    i = argv.index(flag)
    value = convert(argv[i + 1])
    del argv[i : i + 2]
    return value


def _ints(spec):
    return tuple(int(v) for v in spec.split(","))


def parse_args(argv) -> dict:
    """The JAX script's parse: the fine-tuning count is the argument after
    `--network` ("20" or per-scale "10,10"), whether or not grid dims were
    given."""
    argv = list(argv)
    use_network = "--network" in argv
    finetune = 10
    if use_network:
        i = argv.index("--network")
        if i + 1 < len(argv) and argv[i + 1].replace(",", "").isdigit():
            parts = [v for v in argv.pop(i + 1).split(",") if v]
            finetune = [int(v) for v in parts] if len(parts) > 1 else int(parts[0])
        argv.remove("--network")
    ft_scales = _take(argv, "--ft-scales", _ints, (2,))
    ft_lr = _take(argv, "--ft-lr", float, 0.15)
    if isinstance(finetune, list) and len(finetune) != len(ft_scales):
        raise SystemExit(
            f"--network gave {len(finetune)} per-scale step counts but "
            f"--ft-scales has {len(ft_scales)} scales"
        )
    inst_steps = _take(argv, "--inst-steps", _ints, (80, 60, 40))
    inst_scales = _take(argv, "--inst-scales", _ints, (4, 2, 1))
    gicon_grad = _take(argv, "--gicon-grad", str, None)  # None: the package default
    early_stop = _take(argv, "--early-stop", float, None)  # None: fixed step counts
    weights_path = _take(argv, "--weights", str, None)
    net_grid = _take(argv, "--net-grid", _ints, None)
    args = [a for a in argv if not a.startswith("--")]
    shape = tuple(int(a) for a in args[:3]) if len(args) >= 3 else (80, 192, 192)
    return dict(use_network=use_network, finetune=finetune, ft_scales=ft_scales, ft_lr=ft_lr,
                inst_steps=inst_steps, inst_scales=inst_scales, gicon_grad=gicon_grad,
                early_stop=early_stop, weights_path=weights_path, net_grid=net_grid, shape=shape)


def phantom(shape):
    """(volume, shell): two shells and texture from `default_rng(0)`, and the
    shell alone (the anatomy mask is `shell > 0.5`)."""
    rng = np.random.default_rng(0)
    z, y, x = np.meshgrid(*[np.arange(s, dtype=np.float32) for s in shape], indexing="ij")
    c = (shape[0] * 0.5, shape[1] * 0.55, shape[2] * 0.5)
    rr = np.sqrt(((z - c[0]) * 2.4) ** 2 + (y - c[1]) ** 2 + (x - c[2]) ** 2)
    r0 = shape[1] * 0.16
    shell = np.clip(1.0 - np.abs(rr - r0) / 3.0, 0, 1) * (y < c[1])
    vol = (shell * 0.8 + rng.uniform(0, 0.2, shape)).astype(np.float32)
    return vol, shell


def ground_truth(pts: np.ndarray, amp: float = GT_AMPLITUDE_MM) -> np.ndarray:
    """The known displacement (mm) at physical points (..., 3) xyz:
    low-frequency sinusoids of amplitude `amp`."""
    return np.stack(
        [
            amp * np.sin(pts[..., 1] / 25.0) * np.cos(pts[..., 2] / 30.0),
            amp * np.cos(pts[..., 0] / 25.0) * np.sin(pts[..., 2] / 35.0),
            amp * np.sin(pts[..., 0] / 30.0) * np.cos(pts[..., 1] / 25.0),
        ],
        axis=-1,
    ).astype(np.float32)


def main(argv=None, device=None) -> dict:
    """Run as the module's docstring says; returns the printed numbers
    (seconds with the card synchronized, the image MSE before and after,
    the field error's mean, median and p95 in mm) and the mode."""
    a = parse_args(sys.argv[1:] if argv is None else argv)
    dev = resolve_device(device)
    shape = a["shape"]
    vol, shell = phantom(shape)
    fixed = image_from_array(vol, spacing=SPACING, device=dev)

    pts_t = physical_grid(shape, fixed.origin, fixed.spacing, fixed.direction)
    pts = pts_t.cpu().numpy()
    gt = ground_truth(pts)
    gt_field = DisplacementField(field=torch.as_tensor(gt, device=dev), origin=fixed.origin,
                                 spacing=fixed.spacing, direction=fixed.direction)
    # moving(x) = fixed(x + gt(x)): the pullback through the known field
    moving = resample_image(fixed, fixed, displacement=gt_field)

    synchronize(dev)
    t0 = time.time()
    if a["use_network"]:
        params, meta = load_gradicon_checkpoint(a["weights_path"])
        # a candidate checkpoint carries its architecture; the grid stays
        # overridable (the stages are fully convolutional)
        fields = {f.name for f in dataclasses.fields(GradICONConfig)}
        kw = {k: v for k, v in meta.items() if k in fields}
        if a["net_grid"]:
            kw["grid_shape"] = a["net_grid"]
        cfg = GradICONConfig(**kw)
        phi_ab, _ = register_pair(
            fixed, moving, model=GradICON(cfg, device=dev), params=params, config=cfg,
            finetune_steps=a["finetune"], finetune_scales=a["ft_scales"], finetune_lr=a["ft_lr"],
            gicon_grad=a["gicon_grad"], early_stop=a["early_stop"],
        )
    else:
        cfg = GradICONConfig(grid_shape=a["net_grid"]) if a["net_grid"] else GradICONConfig()
        phi_ab, _ = register_pair(
            fixed, moving, config=cfg, instance_scales=a["inst_scales"], instance_steps=a["inst_steps"],
            gicon_grad=a["gicon_grad"], early_stop=a["early_stop"],
        )
    synchronize(dev)
    dt = time.time() - t0

    # phi_ab maps moving-grid points into fixed space: a perfect result warps
    # `fixed` onto `moving`'s grid exactly as the known field did
    with torch.no_grad():
        recovered = resample_image(fixed, moving, displacement=phi_ab)
        est = sample_displacement(phi_ab, pts_t).cpu().numpy()
    fixed_np, moving_np, recovered_np = fixed.numpy(), moving.numpy(), recovered.numpy()
    before = float(np.mean((fixed_np - moving_np) ** 2))
    after = float(np.mean((recovered_np - moving_np) ** 2))

    # the field error where anatomy exists (moving and fixed share a grid)
    mask = shell > 0.5
    err = np.linalg.norm(est[mask] - gt[mask], axis=-1)
    finetune, ft_scales, ft_lr = a["finetune"], a["ft_scales"], a["ft_lr"]
    gicon_grad, early_stop = a["gicon_grad"], a["early_stop"]
    mode = (
        f"network+ft{finetune}@scales{ft_scales}lr{ft_lr}" if a["use_network"] else "instance"
    ) + (f"+gicon:{gicon_grad}" if gicon_grad else "") + (
        f"+es{early_stop}" if early_stop is not None else ""
    )
    amp = GT_AMPLITUDE_MM
    print(f"vol {shape}; net grid {cfg.grid_shape}; registration ({mode}) {dt:.1f}s")
    print(f"image MSE: before {before:.5f} -> after {after:.5f} ({after / before:.2%})")
    print(f"field error in anatomy (mm, GT amplitude {amp}): "
          f"mean {err.mean():.3f}  median {np.median(err):.3f}  p95 {np.percentile(err, 95):.3f}")
    return {
        "mode": mode, "shape": shape, "grid": tuple(cfg.grid_shape), "seconds": dt,
        "mse_before": before, "mse_after": after, "mse_ratio": after / before,
        "err_mean_mm": float(err.mean()), "err_median_mm": float(np.median(err)),
        "err_p95_mm": float(np.percentile(err, 95)),
    }


if __name__ == "__main__":
    main()
