"""Plain reference of one knee through the configuration `oai_knee_w24`:
the percentile window, the tiled segmentation UNet, the GradICON network
and its per-pair fine-tuning, the displacement field, and the warp of the
probability maps onto the atlas. Grids are axis-aligned with origin 0, as
the benchmark makes them; volumes are indexed [z, y, x] and spacings are
given x, y, z.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from portbench.reference import ops
from portbench.reference.ops import Precision


def percentile_window(x: torch.Tensor, lo_p: float, hi_p: float) -> torch.Tensor:
    """Linear interpolation between order statistics at p / 100 * (n - 1),
    then the window [lo, hi] -> [0, 1] with clamping."""
    flat = torch.sort(x.reshape(-1).to(torch.float64)).values
    n = flat.numel()
    vals = []
    for p in (lo_p, hi_p):
        pos = p / 100.0 * (n - 1)
        i, j = int(np.floor(pos)), int(np.ceil(pos))
        f = pos - i
        vals.append(float(flat[i]) * (1 - f) + float(flat[j]) * f)
    lo, hi = vals
    return torch.clamp((x.to(torch.float32) - lo) / max(hi - lo, 1e-20), 0.0, 1.0)


def segment(pre: torch.Tensor, params, cfg: dict, prec: Precision) -> torch.Tensor:
    """(2, D, H, W) probability maps: reflect-padded tiles of the stated
    tile size, the UNet on each, the tiles' central regions assembled, a
    boundary margin zeroed (the overlap (cx, cy, cz) given x, y, z, applied
    as margins (cz, cx, cy) on z, y, x)."""
    seg = cfg["segmenter"]
    tile = tuple(seg["tile_zyx"])
    ox, oy, oz = seg["overlap_xyz"]
    ov = (oz, oy, ox)
    eff = tuple(t - 2 * o for t, o in zip(tile, ov))
    shape = tuple(pre.shape)
    grid = tuple(-(-s // e) for s, e in zip(shape, eff))
    total = tuple(e * g + 2 * o for e, g, o in zip(eff, grid, ov))
    padded = pre
    for axis, (o, t, s) in enumerate(zip(ov, total, shape)):
        idx = np.pad(np.arange(s), (o, t - s - o), mode="reflect")
        padded = padded.index_select(axis, torch.as_tensor(idx, device=pre.device))
    canvas = torch.zeros((2,) + tuple(e * g for e, g in zip(eff, grid)), device=pre.device)
    spec = seg["unet"]
    with torch.no_grad():
        for i in range(grid[0]):
            for j in range(grid[1]):
                for k in range(grid[2]):
                    z0, y0, x0 = i * eff[0], j * eff[1], k * eff[2]
                    t = padded[z0 : z0 + tile[0], y0 : y0 + tile[1], x0 : x0 + tile[2]]
                    logits = ops.unet_forward(params, spec["enc"], spec["dec"], t[None, ..., None], prec)[0]
                    probs = torch.sigmoid(logits)[ov[0] : tile[0] - ov[0], ov[1] : tile[1] - ov[1],
                                                  ov[2] : tile[2] - ov[2]]
                    canvas[:, z0 : z0 + eff[0], y0 : y0 + eff[1], x0 : x0 + eff[2]] = probs.permute(3, 0, 1, 2)
                    del logits, probs
    out = canvas[:, : shape[0], : shape[1], : shape[2]]
    mask = torch.zeros(shape, device=pre.device)
    mask[oz : shape[0] - oz, ox : shape[1] - ox, oy : shape[2] - oy] = 1
    return out * mask


def _physical_to_index(spacing_src_xyz, pts_zyx_mm):
    """Physical z, y, x millimetres -> continuous z, y, x indices of a grid
    with origin 0 and the given spacing."""
    sp = torch.as_tensor(list(spacing_src_xyz)[::-1], dtype=torch.float32, device=pts_zyx_mm.device)
    return pts_zyx_mm / sp


def _grid_mm(shape, spacing_xyz, device):
    """(D, H, W, 3) z, y, x millimetres of every voxel of a grid at origin 0."""
    axes = [torch.arange(n, dtype=torch.float32, device=device) * float(s)
            for n, s in zip(shape, list(spacing_xyz)[::-1])]
    zz, yy, xx = torch.meshgrid(*axes, indexing="ij")
    return torch.stack([zz, yy, xx], dim=-1)


def reg_spacing(image_shape, spacing_xyz, grid_shape):
    """x, y, z spacing of the registration grid spanning the image's extent."""
    src = np.asarray(image_shape, np.float64)
    dst = np.asarray(grid_shape, np.float64)
    return tuple((np.asarray(spacing_xyz, np.float64)[::-1] * (src - 1.0) / (dst - 1.0))[::-1])


def resample_to_grid(vol, spacing_xyz, grid_shape):
    """`vol` trilinearly resampled onto the registration grid over its extent."""
    gsp = reg_spacing(vol.shape, spacing_xyz, grid_shape)
    pts = _grid_mm(grid_shape, gsp, vol.device)
    return ops.gather(vol, _physical_to_index(spacing_xyz, pts), 0.0, z_first=True)


def load_gradicon(path) -> List[Dict[str, Dict[str, torch.Tensor]]]:
    """The stage-params list of a GradICON weights file (one raw read)."""
    stages: Dict[int, dict] = {}
    with np.load(path, allow_pickle=False) as z:
        for key in z.files:
            parts = key.split("/")
            if parts[0] != "params":
                continue
            node = stages.setdefault(int(parts[1][len("stage"):]), {})
            node.setdefault(parts[2], {})[parts[3]] = np.asarray(z[key])
    return [stages[i] for i in range(len(stages))]


def stage_spec(width: int):
    w = width
    return ([[w, 2 * w], [2 * w, 4 * w], [4 * w, 8 * w]], [[8 * w, 4 * w, 4 * w], [4 * w, 2 * w, 2 * w]])


def forward_map(stages, reg: dict, a, b, prec: Precision):
    """phi with b(phi(x)) ~= a(x): per stage, coarse to fine, a UNet on the
    pooled pair predicts an increment tanh(u) * scale that refines phi by
    composition."""
    enc, dec = stage_spec(reg["stage_width"])
    shape = tuple(a.shape)
    ident = ops.identity(shape, a.device)
    phi = ident
    for params, scale in zip(stages, reg["scales"]):
        a_s, b_s = ops.pyramid(a, scale), ops.pyramid(ops.warp(b, phi), scale)
        u = ops.unet_forward(params, enc, dec, torch.stack([a_s, b_s], dim=-1)[None], prec)[0]
        u = torch.tanh(u) * reg["displacement_scale"]
        if tuple(u.shape[:3]) != shape:
            u = ops.resize_field(u, shape)
        phi = ops.compose(phi, ident + u)
    return phi


def finetune(a, b, phi_ab, phi_ba, reg: dict, prec: Precision):
    """Per-pair refinement from the network's maps: at each fine-tuning
    scale, Adam on displacement increments of both directions against LNCC
    + MSE similarity of the images warped in the stated image type, the
    GradICON penalty (alternating, or exact through both maps) and a
    diffusion term; the refined maps
    resized back to the full grid."""
    ft = reg["finetune"]
    full = tuple(a.shape)
    img_prec = Precision(ft["image_dtype"])
    sim = ops.similarity(ft["similarity"], reg["lncc_window"], ft["mse_weight"])
    penalty = {"alternating": ops.gradicon_penalty_alternating, "exact": ops.gradicon_penalty}[ft["gicon_grad"]]
    for scale in ft["scales"]:
        a_s, b_s = ops.pyramid(a, scale), ops.pyramid(b, scale)
        shape_s = tuple(a_s.shape)
        with torch.no_grad():
            base_ab, base_ba = ops.resize_field(phi_ab, shape_s), ops.resize_field(phi_ba, shape_s)
        ident = ops.identity(shape_s, a.device, linspace=True)
        a16, b16 = img_prec.r(a_s), img_prec.r(b_s)
        u_ab = torch.zeros(shape_s + (3,), device=a.device, requires_grad=True)
        u_ba = torch.zeros(shape_s + (3,), device=a.device, requires_grad=True)
        opt = ops.Adam([u_ab, u_ba], lr=ft["lr"] / float(max(shape_s)))

        def maps():
            return ops.compose(base_ab, ident + u_ab), ops.compose(base_ba, ident + u_ba)

        for _ in range(ft["steps"]):
            with torch.enable_grad(), prec.products():
                pab, pba = maps()
                loss = (sim(a_s, ops.warp(b16, pab)) + sim(b_s, ops.warp(a16, pba))
                        + ft["lambda_reg"] * penalty(pab, pba)
                        + ft["diffusion_weight"] * (ops.diffusion_penalty(pab) + ops.diffusion_penalty(pba)))
                grads = torch.autograd.grad(loss, [u_ab, u_ba])
            opt.step(list(grads))
        with torch.no_grad():
            pab, pba = maps()
            phi_ab, phi_ba = ops.resize_field(pab, full), ops.resize_field(pba, full)
    return phi_ab, phi_ba


def register(pre, atlas, spacing_xyz, stages, reg: dict, prec: Precision):
    """The displacement field (grid D, H, W, 3; x, y, z millimetres on the
    atlas's registration grid) that pulls knee-grid data onto the atlas, and
    the network's two maps (phi_AB, phi_BA) before the fine-tuning."""
    grid = tuple(reg["grid_shape"])
    a = resample_to_grid(pre, spacing_xyz, grid)
    b = resample_to_grid(atlas, spacing_xyz, grid)
    with torch.no_grad():
        phi_ab = forward_map(stages, reg, a, b, prec)
        phi_ba = forward_map(stages, reg, b, a, prec)
    net = (phi_ab, phi_ba)
    if reg["finetune"]["steps"]:
        phi_ab, phi_ba = finetune(a, b, phi_ab, phi_ba, reg, prec)
    # phi_BA (atlas-grid coordinates -> knee-grid coordinates) as millimetres
    gsp = reg_spacing(pre.shape, spacing_xyz, grid)
    sp_zyx = torch.as_tensor(list(gsp)[::-1], dtype=torch.float32, device=pre.device)
    vox = torch.as_tensor([s - 1.0 for s in grid], dtype=torch.float32, device=pre.device)
    ident = ops.identity(grid, pre.device)
    disp_zyx = (phi_ba.detach() * vox - ident * vox) * sp_zyx
    return disp_zyx.flip(-1), net


def map_mm(phi, image_shape, spacing_xyz):
    """A map's coordinates (normalized z, y, x on the registration grid) in
    millimetres of the grid spanning the image."""
    grid = tuple(phi.shape[:3])
    gsp = reg_spacing(image_shape, spacing_xyz, grid)
    scale = [(n - 1.0) * s for n, s in zip(grid, list(gsp)[::-1])]
    return phi * torch.as_tensor(scale, dtype=torch.float32, device=phi.device)


def warp_maps(maps: torch.Tensor, disp_xyz: torch.Tensor, spacing_xyz, prec: Precision) -> torch.Tensor:
    """(C, D, H, W) maps on the knee grid pulled onto the atlas grid (the same
    grid here) through the displacement field: each voxel's point plus the
    field interpolated there, sampled trilinearly in the maps, zero outside.
    The maps are gathered in the precision's type."""
    shape = tuple(maps.shape[1:])
    grid = tuple(disp_xyz.shape[:3])
    gsp = reg_spacing(shape, spacing_xyz, grid)
    pts = _grid_mm(shape, spacing_xyz, maps.device)
    fidx = pts / torch.as_tensor(list(gsp)[::-1], dtype=torch.float32, device=maps.device)
    pts = pts + ops.gather(disp_xyz.flip(-1), fidx, 0.0)
    idx = _physical_to_index(spacing_xyz, pts)
    stacked = prec.r(maps.permute(1, 2, 3, 0))
    return ops.gather(stacked, idx, 0.0, z_first=True).permute(3, 0, 1, 2)
