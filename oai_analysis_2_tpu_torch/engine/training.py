"""Segmentation training (port of `oai_analysis_2_tpu/engine/training.py`):
per-class sigmoid Dice + BCE, a train step and a single-card loop.

The step differentiates every leaf of the model (JAX's `make_train_step`
differentiates the whole params tree; on a batch-norm spec that includes
the running mean and var, which the inference-mode forward reads, so Adam
trains them too). The UNet's convs run the hand-written kernels under
autograd (`ops.cuda_conv.conv3d_train`).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F

from oai_analysis_2_tpu_torch.utils.checkpoint import carry_params, export_params
from oai_analysis_2_tpu_torch.utils import optim


def dice_bce_loss(logits: torch.Tensor, labels: torch.Tensor, class_weights: Optional[torch.Tensor] = None,
                  eps: float = 1e-5) -> torch.Tensor:
    """Multi-label Dice + BCE (training.py:22-38). logits / labels: (N, D,
    H, W, C), labels in {0, 1} per class channel. The BCE is Optax's
    `sigmoid_binary_cross_entropy`, -y log_sigmoid(x) - (1 - y)
    log_sigmoid(-x)."""
    labels = labels.to(torch.float32)
    probs = torch.sigmoid(logits)
    axes = (1, 2, 3)
    inter = torch.sum(probs * labels, axes)
    denom = torch.sum(probs, axes) + torch.sum(labels, axes)
    dice = 1.0 - (2.0 * inter + eps) / (denom + eps)  # (N, C)
    bce = -labels * F.logsigmoid(logits) - (1.0 - labels) * F.logsigmoid(-logits)
    per_class = dice + torch.mean(bce, axes)
    if class_weights is not None:
        per_class = per_class * class_weights[None, :]
    return torch.mean(per_class)


def _device(model: torch.nn.Module) -> torch.device:
    return next(model.parameters()).device


def make_train_step(model: torch.nn.Module, optimizer: optim.Optimizer, loss_fn: Callable = dice_bce_loss) -> Callable:
    """`step(images, labels)` -> the loss before the update (0-d): one
    optimizer update of `loss_fn(model(images), labels)` (training.py:41-61).
    images / labels are NDHWC arrays or tensors, moved to the model's
    device. `optimizer` is a `utils.optim` optimizer over the leaves to
    train, whose gradients this turns on."""
    dev = _device(model)

    def step(images, labels) -> torch.Tensor:
        images = torch.as_tensor(images, dtype=torch.float32, device=dev)
        labels = torch.as_tensor(labels, device=dev)
        optimizer.zero_grad()
        with torch.enable_grad():
            loss = loss_fn(model(images), labels)
            loss.backward()
        optimizer.step()
        return loss.detach()

    optimizer.require_grad()
    return step


def train_segmentation(
    model: torch.nn.Module,
    data_iter,
    num_steps: int,
    learning_rate: float = 1e-3,
    params: Optional[dict] = None,
    generator: Optional[torch.Generator] = None,
    log_every: int = 50,
    callback=None,
):
    """Single-card training loop (training.py:64-88): `params` (a JAX-layout
    tree) is carried onto the model, else the model draws its init from
    `generator` (None: seeded with 0); then `num_steps` Adam steps on the
    batches of `data_iter` (images NDHWC, multi-hot labels NDHWC). Returns
    JAX's triple: (the trained params as a numpy tree, the optimizer,
    the losses as floats); the model holds the trained weights."""
    if params is None:
        model.init(generator)
    else:
        carry_params(model, params)
    optimizer = optim.adam(list(model.parameters()), learning_rate)
    step = make_train_step(model, optimizer)
    losses = []
    for i in range(num_steps):
        images, labels = next(data_iter)
        losses.append(float(step(images, labels)))
        if callback and (i % log_every == 0 or i == num_steps - 1):
            callback(i, losses[-1])
    return export_params(model), optimizer, losses
