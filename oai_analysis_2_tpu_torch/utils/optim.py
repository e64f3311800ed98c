"""The Optax pieces of the JAX package's training recipes, written out for
PyTorch: Adam with Optax's defaults and update order, Optax's
`clip_by_global_norm` formula and `warmup_cosine_decay_schedule`.

`adam(params, learning_rate, clip_norm=None)` is
Optax's `chain(clip_by_global_norm(clip_norm), adam(learning_rate))`
bound to a list of leaves (JAX's `opt.init(params)`): each `step` clips the
gradients in place, sets the learning rate from the schedule at the update
count before the increment (Optax's `scale_by_learning_rate` state, so the
first update uses the schedule's value at 0), and runs `torch.optim.Adam`,
whose update m_hat / (sqrt(v_hat) + eps) is Optax's.

`batch_step` runs one update of a loss averaged over a batch whose items
run one after another (the JAX steps' `jax.vmap`).
"""

from __future__ import annotations

import math
from typing import Callable, List, Optional, Sequence, Union

import torch

Schedule = Callable[[int], float]


def warmup_cosine_decay_schedule(
    init_value: float,
    peak_value: float,
    warmup_steps: int,
    decay_steps: int,
    end_value: float = 0.0,
    exponent: float = 1.0,
) -> Schedule:
    """Optax's schedule: linear from `init_value` to `peak_value` over
    `warmup_steps` updates, then cosine decay to `end_value` at
    `decay_steps` (the warmup included), constant after."""
    if decay_steps - warmup_steps <= 0:
        raise ValueError(f"the cosine decay needs decay_steps > warmup_steps, got {decay_steps}, {warmup_steps}")
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value

    def schedule(count: int) -> float:
        if count < warmup_steps:
            frac = 1.0 - min(max(count, 0), warmup_steps) / warmup_steps
            return (init_value - peak_value) * frac + peak_value
        t = min(count - warmup_steps, decay_steps - warmup_steps)
        cosine = 0.5 * (1.0 + math.cos(math.pi * t / (decay_steps - warmup_steps)))
        return peak_value * ((1.0 - alpha) * cosine**exponent + alpha)

    return schedule


def clip_by_global_norm_(params: Sequence[torch.Tensor], max_norm: float) -> torch.Tensor:
    """Optax's `clip_by_global_norm` on the parameters' gradients, in place
    and without a host read: g stays where norm < max_norm, else becomes
    (g / norm) * max_norm (not `torch.nn.utils.clip_grad_norm_`, whose
    max_norm / (norm + 1e-6) differs). Returns the norm before clipping."""
    grads = [p.grad for p in params if p.grad is not None]
    norm = torch.sqrt(sum(torch.sum(g.to(torch.float32) ** 2) for g in grads))  # Optax's global_norm
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, (g / norm.to(g.dtype)) * max_norm))
    return norm


class Optimizer:
    """Adam over `params` with an optional global-norm clip before it; see
    the module docstring. `count` is Optax's update count."""

    def __init__(self, params: Sequence[torch.Tensor], learning_rate: Union[float, Schedule],
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8, clip_norm: Optional[float] = None):
        self.params: List[torch.Tensor] = list(params)
        self.schedule = learning_rate if callable(learning_rate) else (lambda count: learning_rate)
        self.clip_norm = clip_norm
        self.count = 0
        self.adam = torch.optim.Adam(self.params, lr=self.schedule(0), betas=(b1, b2), eps=eps)

    def require_grad(self) -> None:
        """Turn gradients on for the leaves this optimizer updates."""
        for p in self.params:
            p.requires_grad_(True)

    def zero_grad(self) -> None:
        self.adam.zero_grad(set_to_none=True)

    def step(self) -> None:
        """One update. A leaf that the loss did not reach gets a zero
        gradient, as `jax.grad` gives it (its moments still decay)."""
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if self.clip_norm is not None:
            clip_by_global_norm_(self.params, self.clip_norm)
        for group in self.adam.param_groups:
            group["lr"] = float(self.schedule(self.count))
        self.adam.step()
        self.count += 1


def adam(params: Sequence[torch.Tensor], learning_rate: Union[float, Schedule], b1: float = 0.9,
         b2: float = 0.999, eps: float = 1e-8, clip_norm: Optional[float] = None) -> Optimizer:
    """Optax's `adam(learning_rate, b1, b2, eps)` (after
    `clip_by_global_norm(clip_norm)` if given), bound to `params`."""
    return Optimizer(params, learning_rate, b1, b2, eps, clip_norm)


def batch_step(optimizer: Optimizer, fn: Callable, batch: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """One update of the batch mean of `fn(*item)` -> (loss, aux tuple) over
    the items of `batch` (tensors indexed on dim 0 together): each item's
    backward adds loss / N to the gradients. Returns the means of the loss
    and of each aux value, detached (0-d tensors)."""
    n = int(batch[0].shape[0])
    optimizer.zero_grad()
    sums = None
    with torch.enable_grad():
        for i in range(n):
            loss, aux = fn(*(t[i] for t in batch))
            (loss / n).backward()
            vals = [loss.detach()] + [a.detach() for a in aux]
            sums = vals if sums is None else [s + v for s, v in zip(sums, vals)]
    optimizer.step()
    return [s / n for s in sums]
