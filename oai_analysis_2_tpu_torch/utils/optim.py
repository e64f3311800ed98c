"""The Optax pieces of the JAX package's training recipes, written out for
PyTorch: Adam with Optax's defaults and update order, Optax's
`clip_by_global_norm` formula and `warmup_cosine_decay_schedule`.

`adam(params, learning_rate, clip_norm=None)` is
Optax's `chain(clip_by_global_norm(clip_norm), adam(learning_rate))`
bound to a list of leaves (JAX's `opt.init(params)`): each `step` clips the
gradients in place, sets the learning rate from the schedule at the update
count before the increment (Optax's `scale_by_learning_rate` state, so the
first update uses the schedule's value at 0), and runs `Adam`, Optax's
update m_hat / (sqrt(v_hat) + eps) with Optax's f32 bias corrections.

`batch_step` runs one update of a loss averaged over a batch whose items
run one after another (the JAX steps' `jax.vmap`).
"""

from __future__ import annotations

import math
from typing import Callable, List, Optional, Sequence, Union

import numpy as np
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


def bias_correction(decay: float, count: int) -> float:
    """Optax's `1 - decay**count` as XLA rounds it: `decay` rounded to f32,
    its power rounded once to f32, the difference in f32.

    `torch.optim.Adam` takes it in double from the decimal decay, while
    its moments decay by the f32 decay (0.999 in f32 is 0.99900001287):
    at the counts of an instance run its v_hat comes out 1.3e-5 small and
    each step 6.4e-6 long against Optax's."""
    d = np.float32(decay)
    return float(np.float32(1.0) - np.float32(np.float64(d) ** int(count)))


class Adam(torch.optim.Optimizer):
    """Optax's `adam(lr, b1, b2, eps)` (`scale_by_adam`, then
    `scale_by_learning_rate`) as a torch optimizer:
    mu = (1 - b1) g + b1 mu, nu = (1 - b2) g^2 + b2 nu, the bias
    corrections of `bias_correction`, and
    p += -lr (mu / bc1) / (sqrt(nu / bc2) + eps), in the parameters' dtype.
    The state takes `torch.optim.Adam`'s keys (`step`, `exp_avg`,
    `exp_avg_sq`)."""

    def __init__(self, params, lr: float, betas=(0.9, 0.999), eps: float = 1e-8):
        super().__init__(params, dict(lr=lr, betas=tuple(betas), eps=eps))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            b1, b2 = group["betas"]
            for p in params:
                state = self.state[p]
                if not state:
                    state["step"] = torch.tensor(0.0)
                    state["exp_avg"] = torch.zeros_like(p, memory_format=torch.preserve_format)
                    state["exp_avg_sq"] = torch.zeros_like(p, memory_format=torch.preserve_format)
                state["step"] += 1
            count = int(self.state[params[0]]["step"])
            grads = [p.grad for p in params]
            mu = [self.state[p]["exp_avg"] for p in params]
            nu = [self.state[p]["exp_avg_sq"] for p in params]
            torch._foreach_mul_(mu, b1)
            torch._foreach_add_(mu, grads, alpha=1 - b1)
            torch._foreach_mul_(nu, b2)
            torch._foreach_addcmul_(nu, grads, grads, value=1 - b2)
            denom = torch._foreach_div(nu, bias_correction(b2, count))
            torch._foreach_sqrt_(denom)
            torch._foreach_add_(denom, group["eps"])
            update = torch._foreach_div(mu, bias_correction(b1, count))
            torch._foreach_div_(update, denom)
            torch._foreach_add_(params, update, alpha=-group["lr"])
        return None


class Optimizer:
    """Adam over `params` with an optional global-norm clip before it; see
    the module docstring. `count` is Optax's update count."""

    def __init__(self, params: Sequence[torch.Tensor], learning_rate: Union[float, Schedule],
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8, clip_norm: Optional[float] = None):
        self.params: List[torch.Tensor] = list(params)
        self.schedule = learning_rate if callable(learning_rate) else (lambda count: learning_rate)
        self.clip_norm = clip_norm
        self.count = 0
        self.adam = Adam(self.params, lr=self.schedule(0), betas=(b1, b2), eps=eps)

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
