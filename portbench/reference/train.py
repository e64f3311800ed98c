"""Plain reference of the GradICON training step of `gradicon_w24_train`:
the warp augmentation, the network's maps in both directions, the LNCC
similarity, the GradICON penalty, the known-correspondence supervision,
the mean over the batch's pairs, the global-norm clip and Adam.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from portbench.reference import ops
from portbench.reference.knee import stage_spec
from portbench.reference.ops import Precision


def forward_map(stages, model: dict, a, b, prec: Precision):
    enc, dec = stage_spec(model["stage_width"])
    shape = tuple(a.shape)
    ident = ops.identity(shape, a.device)
    phi = ident
    for params, scale in zip(stages, model["scales"]):
        a_s, b_s = ops.pyramid(a, scale), ops.pyramid(ops.warp(b, phi), scale)
        u = ops.unet_forward(params, enc, dec, torch.stack([a_s, b_s], dim=-1)[None], prec)[0]
        u = torch.tanh(u) * model["displacement_scale"]
        if tuple(u.shape[:3]) != shape:
            u = ops.resize_field(u, shape)
        phi = ops.compose(phi, ident + u)
    return phi


def pair_loss(stages, cfg: dict, va, vb, ua_low, ub_low, same, prec: Precision):
    """sim_weight * sim + lambda_reg * reg + same * sup_weight * sup of one
    pair: each volume warped by its low-resolution field, the network's maps
    both ways, sup the composition residual against the known fields in
    voxels squared."""
    m = cfg["model"]
    shape = tuple(va.shape)
    ident = ops.identity(shape, va.device)
    ua = ident + ops.resize_field(ua_low, shape)
    ub = ident + ops.resize_field(ub_low, shape)
    a, b = ops.warp(va, ua), ops.warp(vb, ub)
    phi_ab = forward_map(stages, m, a, b, prec)
    phi_ba = forward_map(stages, m, b, a, prec)
    sim_fn = ops.similarity(m["similarity"], m["lncc_window"], m.get("mse_weight", 10.0))
    sim = sim_fn(a, ops.warp(b, phi_ab)) + sim_fn(b, ops.warp(a, phi_ba))
    reg = ops.gradicon_penalty(phi_ab, phi_ba)
    scale = torch.as_tensor([s - 1.0 for s in shape], device=va.device)
    res_ab = (ops.compose(ub, phi_ab) - ua) * scale
    res_ba = (ops.compose(ua, phi_ba) - ub) * scale
    sup = 0.5 * (torch.mean(torch.sum(res_ab * res_ab, -1)) + torch.mean(torch.sum(res_ba * res_ba, -1)))
    return cfg["sim_weight"] * sim + m["lambda_reg"] * reg + same * cfg["sup_weight"] * sup


def follow(cfg: dict, init: List[Dict[str, Dict[str, torch.Tensor]]], batches, prec: Precision):
    """Runs the steps of `batches` (each (vol_a, vol_b, ua, ub, same)) from
    the initial weights; returns the losses (batch means, before each
    update), the first step's gradients as Adam takes them (after the clip),
    and the weights after the last step, each leaf in `init`'s order."""
    leaves = [(i, b, k) for i, st in enumerate(init) for b in sorted(st) for k in sorted(st[b])]
    params = [init[i][b][k].detach().clone().requires_grad_(True) for i, b, k in leaves]
    stages = [dict() for _ in init]
    for (i, b, k), p in zip(leaves, params):
        stages[i].setdefault(b, {})[k] = p
    o = cfg["optimizer"]
    opt = ops.Adam(params, lr=o["lr"], b1=o["b1"], b2=o["b2"], eps=o["eps"], clip=o["clip_norm"])
    losses, first_grads = [], None
    for va, vb, ua, ub, same in batches:
        n = va.shape[0]
        grads = [torch.zeros_like(p) for p in params]
        total = 0.0
        for j in range(n):
            with torch.enable_grad(), prec.products():
                loss = pair_loss(stages, cfg, va[j], vb[j], ua[j], ub[j], same[j], prec)
                g = torch.autograd.grad(loss / n, params, allow_unused=True)
            grads = [acc if gi is None else acc + gi for acc, gi in zip(grads, g)]
            total += float(loss.detach())
        losses.append(total / n)
        taken = opt.step(grads)
        if first_grads is None:
            first_grads = [t.detach().clone() for t in taken]
    return {"leaves": leaves, "losses": losses, "first_grads": first_grads,
            "weights": [p.detach() for p in params]}
