"""Cross-anatomy registration check: two different phantoms (port of
`examples/validate_registration_cross.py`).

Registration of a knee to the atlas is cross-subject: no ground-truth
field exists. This reports the metrics that need none: the image match
(MSE before and after, LNCC after), the inverse consistency
|phi_AB o phi_BA - id| in voxels (interior `[4:-4]`), and the Jacobian
determinant's median, 1st and 99th percentiles and folded fraction
(det J <= 0, interior `[2:-2]`).

Usage (on the card):
    python -m oai_analysis_2_tpu_torch.examples.validate_registration_cross [--network] [ft_steps]

With `--network`: the shipped GradICON weights, then `ft_steps` (10 by
default) instance-optimization steps at scale 2 from the network's maps;
without it, instance optimization at scales 4, 2, 1 with 80, 60, 40 steps.
The grid is `GradICONConfig().grid_shape`, as in the JAX script.
"""

import sys
import time

import numpy as np
import torch

from oai_analysis_2_tpu_torch.core.device import resolve_device, synchronize
from oai_analysis_2_tpu_torch.core.image import image_from_array
from oai_analysis_2_tpu_torch.engine.registration import _net_grid_reference
from oai_analysis_2_tpu_torch.models.gradicon import (
    GradICON,
    GradICONConfig,
    compose,
    identity_map,
    lncc,
    load_gradicon_checkpoint,
    register_pair_instance,
    warp,
)
from oai_analysis_2_tpu_torch.models.synthetic import random_phantom
from oai_analysis_2_tpu_torch.ops.resample import resample_image


def jacobian_stats(phi, shape):
    """det(J) over the interior `[2:-2]`; phi normalized coords (D,H,W,3)."""
    if isinstance(phi, torch.Tensor):
        phi = phi.detach().cpu().numpy()
    scale = np.asarray(shape, np.float32) - 1.0
    pv = np.asarray(phi) * scale  # voxel units
    grads = [np.gradient(pv, axis=axis) for axis in range(3)]  # d pv / d x_axis (voxel steps)
    j = np.stack(grads, axis=-1)  # (D,H,W,3 comp,3 axis)
    return np.linalg.det(j[2:-2, 2:-2, 2:-2])


def main(argv=None, device=None, shape=None) -> dict:
    """Run as the module's docstring says; returns the printed numbers.
    `shape` (tests only) replaces `GradICONConfig().grid_shape`."""
    argv = sys.argv[1:] if argv is None else list(argv)
    dev = resolve_device(device)
    use_network = "--network" in argv
    args = [a for a in argv if not a.startswith("--")]
    finetune = int(args[0]) if args else 10

    cfg = GradICONConfig()
    shape = tuple(cfg.grid_shape if shape is None else shape)
    rng = np.random.default_rng(2024)
    a_np = random_phantom(rng, shape)
    b_np = random_phantom(rng, shape)
    spacing = (0.36 * 4, 0.36 * 4, 0.7 * 3.33)  # the production physical extent
    img_a = image_from_array(a_np, spacing=spacing, device=dev)
    img_b = image_from_array(b_np, spacing=spacing, device=dev)

    mode = f"network+ft{finetune}" if use_network else "instance"
    if use_network:
        params, meta = load_gradicon_checkpoint()
        # the JAX network reads its width from the parameters; the port's
        # modules are built at the checkpoint's recorded width
        net_cfg = GradICONConfig(grid_shape=shape, stage_width=meta.get("stage_width", cfg.stage_width))
        model = GradICON(net_cfg, device=dev)
        model.load_params(params)

    synchronize(dev)
    t0 = time.time()
    # the normalized-map internals, for map-level metrics
    a = resample_image(img_a, _net_grid_reference(img_a, shape)).data.to(torch.float32)
    b = resample_image(img_b, _net_grid_reference(img_b, shape)).data.to(torch.float32)
    if use_network:
        with torch.no_grad():
            nmap_ab, nmap_ba = model.both_maps(a, b)
        if finetune:
            nmap_ab, nmap_ba = register_pair_instance(
                a, b, scales=(2,), steps_per_scale=finetune, init_ab=nmap_ab, init_ba=nmap_ba,
            )
    else:
        nmap_ab, nmap_ba = register_pair_instance(a, b, scales=(4, 2, 1), steps_per_scale=(80, 60, 40))
    synchronize(dev)
    dt = time.time() - t0

    with torch.no_grad():
        warped_b = warp(b, nmap_ab)
        mse_before = float(torch.mean((a - b) ** 2))
        mse_after = float(torch.mean((a - warped_b) ** 2))
        lncc_after = float(lncc(a, warped_b))
        ic = compose(nmap_ab, nmap_ba) - identity_map(shape, dev)
        scale = torch.as_tensor([s - 1.0 for s in shape], dtype=torch.float32, device=dev)
        ic_vox = torch.sqrt(torch.sum((ic * scale) ** 2, dim=-1)).cpu().numpy()
    interior = ic_vox[4:-4, 4:-4, 4:-4]
    det = jacobian_stats(nmap_ab, shape)

    out = {
        "mode": mode, "shape": shape, "seconds": dt,
        "mse_before": mse_before, "mse_after": mse_after, "mse_ratio": mse_after / mse_before,
        "lncc_after": lncc_after,
        "ic_mean_vox": float(interior.mean()), "ic_median_vox": float(np.median(interior)),
        "ic_p95_vox": float(np.percentile(interior, 95)),
        "jac_median": float(np.median(det)), "jac_p1": float(np.percentile(det, 1)),
        "jac_p99": float(np.percentile(det, 99)), "folded": float((det <= 0).mean()),
    }
    print(f"mode {mode}; registration {dt:.1f}s on grid {shape}")
    print(f"image MSE: before {mse_before:.5f} -> after {mse_after:.5f} "
          f"({mse_after / mse_before:.1%}); LNCC-loss after {lncc_after:.4f}")
    print(f"inverse consistency |phi_AB o phi_BA - id| (vox, interior): "
          f"mean {out['ic_mean_vox']:.3f} median {out['ic_median_vox']:.3f} "
          f"p95 {out['ic_p95_vox']:.3f}")
    print(f"Jacobian det: median {out['jac_median']:.3f} "
          f"[p1 {out['jac_p1']:.3f}, p99 {out['jac_p99']:.3f}], "
          f"folded {out['folded']:.2%}")
    return out


if __name__ == "__main__":
    main()
