"""The plain reference and the comparisons that decide `correct`.

Plain PyTorch, NumPy and SciPy only: nothing here imports the program, JAX
or the JAX package. The reference is given what the benchmark made (the
knee, the atlas, the weights; the shipped GradICON weights are read from
their file) and works out everything else again. Where a stage is judged
from the program's own output of the stage before (the warp from the
program's maps and field, the thickness from its warped maps), the
comparison follows the program step by step; the first stages, segment
and register, are judged from the benchmark's inputs alone.

`knee_outputs` is the same pipeline run in the precisions the caller
names: the control puts it in the program's place one precision below the
configuration's.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict

import numpy as np
import torch

from portbench.reference import knee as K
from portbench.reference import thickness as T
from portbench.reference.ops import Precision

ROOT = Path(__file__).resolve().parents[2]
QUANTILES = np.linspace(0.01, 0.99, 99)


def _device_tree(params, device):
    return {b: {k: torch.as_tensor(np.asarray(v), device=device) for k, v in leaves.items()}
            for b, leaves in params.items()}


def gradicon_stages(cfg: dict, device):
    return [_device_tree(p, device) for p in K.load_gradicon(ROOT / cfg["registration"]["weights_file"])]


def knee_outputs(cfg: dict, knee: torch.Tensor, atlas: torch.Tensor, seg_params, precisions: Dict[str, str],
                 stages=None) -> dict:
    """The pipeline's outputs for one knee, each stage in the named precision
    (keys segment, register, warp, thickness), in the layout the driver
    gives the program's."""
    dev = knee.device
    sp = cfg["spacing_xyz"]
    stages = gradicon_stages(cfg, dev) if stages is None else stages
    pre = K.percentile_window(knee, *cfg["preprocess"]["percentiles"])
    maps = K.segment(pre, _device_tree(seg_params, dev), cfg, Precision(precisions["segment"]))
    disp, net = K.register(pre, atlas, sp, stages, cfg["registration"], Precision(precisions["register"]))
    warped = K.warp_maps(maps, disp, sp, Precision(precisions["warp"]))
    th = cfg["thickness"]
    inner = {kind: T.thickness(warped[c], sp, kind, th, Precision(precisions["thickness"]))
             for c, kind in enumerate(("FC", "TC"))}
    return {"maps": [maps[0], maps[1]], "net": net, "disp": disp, "warped": [warped[0], warped[1]], "inner": inner}


def judge_knee(cfg: dict, knee: torch.Tensor, atlas: torch.Tensor, out: dict, seg_params, stages=None) -> dict:
    """The numbers compared for one knee, each the worst over FC and TC:
    seg_gap, the largest gap of a probability map against the reference's
    from the same knee; net_gap_mm, the largest gap of the network's two
    maps before the fine-tuning (mm; a map wrong in any one region); of the
    displacement field after it (mm), disp_gap_mm, its largest gap, and
    disp_mean_gap_mm, its mean gap;
    warp_gap, of the warped maps against the reference's warp of `out`'s
    maps by `out`'s field; and of the inner meshes against the reference's
    thickness stage on `out`'s warped maps, thickness_points_gap, the
    relative gap of their point counts, and thickness_quantile_gap_mm, the
    largest gap between the 1st to 99th percentiles of the thickness."""
    dev = knee.device
    sp = cfg["spacing_xyz"]
    f32 = Precision("float32")
    prec = cfg["segmenter"]["compute_dtype"]
    stages = gradicon_stages(cfg, dev) if stages is None else stages
    with torch.no_grad():
        pre = K.percentile_window(knee, *cfg["preprocess"]["percentiles"])
        maps = K.segment(pre, _device_tree(seg_params, dev), cfg, Precision(prec))
        seg_gap = max(float((out["maps"][c].float() - maps[c]).abs().max()) for c in range(2))
        del maps
    disp, net = K.register(pre, atlas, sp, stages, cfg["registration"], Precision(cfg["registration"]["compute_dtype"]))
    net_gap = max(float((K.map_mm(p.float(), pre.shape, sp) - K.map_mm(r, pre.shape, sp)).abs().max())
                  for p, r in zip(out["net"], net))
    dgap = (out["disp"].float() - disp).abs()
    disp_gap, disp_mean = float(dgap.max()), float(dgap.mean())
    with torch.no_grad():
        warped = K.warp_maps(torch.stack([m.float() for m in out["maps"]]), out["disp"].float(), sp,
                             Precision(cfg["warp_dtype"]))
        warp_gap = max(float((out["warped"][c].float() - warped[c]).abs().max()) for c in range(2))
        del warped
    pts_gap = q_gap = 0.0
    for c, kind in enumerate(("FC", "TC")):
        _iv, th_ref = T.thickness(out["warped"][c].float(), sp, kind, cfg["thickness"], f32)
        _pv, th_prog = out["inner"][kind]
        n_ref, n_prog = len(th_ref), len(th_prog)
        pts_gap = max(pts_gap, abs(n_prog - n_ref) / max(n_ref, 1))
        if n_ref and n_prog:
            q_gap = max(q_gap, float(np.max(np.abs(np.quantile(th_prog, QUANTILES) - np.quantile(th_ref, QUANTILES)))))
        elif n_ref != n_prog:
            q_gap = float("inf")
    return {"seg_gap": seg_gap, "net_gap_mm": net_gap, "disp_gap_mm": disp_gap, "disp_mean_gap_mm": disp_mean,
            "warp_gap": warp_gap,
            "thickness_points_gap": pts_gap, "thickness_quantile_gap_mm": q_gap}
