"""GradICON registration: the network's forward pass, the losses and
instance optimization (port of `oai_analysis_2_tpu/models/gradicon.py`).

Transforms live on a fixed registration grid in normalized [0, 1]^3
coordinates (z, y, x order); a map phi (D, H, W, 3) is the pullback
B_warped(x) = B(phi(x)). Stage k (coarse to fine) predicts an increment u
with a small f32 UNet and refines phi <- phi o (id + u).

Instance optimization (`register_pair_instance`) needs no network
gradient: it optimizes raw per-voxel displacement fields with Adam, and
gradients flow only through the trilinear gathers, the LNCC box sums and
the penalties. Fine-tuning runs the network once without gradient and then
the same loop from its maps. Network training (`GradICON.init`,
`GradICON.loss`, `make_gradicon_train_step`) runs the stage UNets' convs
under autograd (`ops.cuda_conv.conv3d_train`), in the model's
`compute_dtype` (bf16 in the JAX training recipe, f32 for serving).
"""

from __future__ import annotations

import dataclasses
import functools
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from oai_analysis_2_tpu_torch.core.device import resolve_device
from oai_analysis_2_tpu_torch.models.unet3d import UNet3D, UNetSpec
from oai_analysis_2_tpu_torch.ops.resample import _trilinear_gather, clip_ties
from oai_analysis_2_tpu_torch.utils.checkpoint import carry_params, export_params, load_checkpoint
from oai_analysis_2_tpu_torch.utils.optim import Adam, batch_step


def _grid(axes, device) -> torch.Tensor:
    zz, yy, xx = torch.meshgrid(*(torch.as_tensor(v, device=device) for v in axes), indexing="ij")
    return torch.stack([zz, yy, xx], dim=-1)


def identity_map(shape_zyx, device=None) -> torch.Tensor:
    """(D, H, W, 3) normalized coordinates of every voxel, rounded as
    `jnp.linspace` rounds them on the CPU: i * f32(1 / (n - 1)), the last
    one exactly 1. Cached per shape and device (`clear_instance_cache`):
    the loss reads it every step, and a tensor copied to the card from the
    host waits for the stream. Read-only."""
    return _identity_map_cached(tuple(int(s) for s in shape_zyx), torch.device("cpu" if device is None else device))


@functools.lru_cache(maxsize=32)
def _identity_map_cached(shape_zyx, device) -> torch.Tensor:
    def axis(n):
        v = np.arange(n, dtype=np.float32) * (np.float32(1.0) / np.float32(max(n - 1, 1)))
        v[-1] = 1.0 if n > 1 else 0.0
        return v

    return _grid([axis(s) for s in shape_zyx], device)


def identity_map_np(shape_zyx, device=None) -> torch.Tensor:
    """The identity map as `_identity_map_np` rounds it (linspace in float64,
    rounded once to f32): the base that instance optimization adds its
    displacement to. It differs from `identity_map` by one f32 ulp at some
    voxels, which decides where sample points land exactly on a node."""
    return _grid([np.linspace(0.0, 1.0, int(s), dtype=np.float32) for s in shape_zyx], device)


def _to_index(phi: torch.Tensor, shape_zyx) -> torch.Tensor:
    return phi * _index_scale(tuple(int(s) for s in shape_zyx), phi.device)


@functools.lru_cache(maxsize=64)
def _index_scale(shape_zyx, device) -> torch.Tensor:
    """(3,) f32 [D - 1, H - 1, W - 1] on `device`, made once per shape."""
    return torch.as_tensor([s - 1.0 for s in shape_zyx], dtype=torch.float32, device=device)


def warp(volume: torch.Tensor, phi: torch.Tensor) -> torch.Tensor:
    """Pullback-warp a (D,H,W) volume: out(x) = volume(phi(x)). Outside -> 0."""
    return _trilinear_gather(volume, _to_index(phi, volume.shape), 0.0)


def compose(phi_outer: torch.Tensor, phi_inner: torch.Tensor) -> torch.Tensor:
    """(phi_outer o phi_inner)(x), inner points clipped to the unit cube
    (with `jnp.clip`'s tie gradient)."""
    pts = clip_ties(phi_inner, 0.0, 1.0)
    return _trilinear_gather(phi_outer, _to_index(pts, phi_outer.shape[:3]), 0.0)


def downsample2x(volume: torch.Tensor) -> torch.Tensor:
    """2x average-pool of a (D,H,W) volume (VALID)."""
    d, h, w = (s // 2 for s in volume.shape)
    v = volume[: 2 * d, : 2 * h, : 2 * w].reshape(d, 2, h, 2, w, 2)
    return v.sum(dim=(1, 3, 5)) * 0.125


def resize_field(phi: torch.Tensor, shape_zyx) -> torch.Tensor:
    """Trilinear resize of a (D,H,W,3) normalized-coordinate field."""
    ident = identity_map(shape_zyx, phi.device)
    return _trilinear_gather(phi, _to_index(ident, phi.shape[:3]), 0.0)


def map_quality_stats(phi_ab: torch.Tensor, phi_ba: torch.Tensor) -> dict:
    """Inverse-consistency error (voxels, grid interior) and folded-Jacobian
    fractions (port of gradicon.py:195-235); values are 0-d tensors."""
    shape = phi_ab.shape[:3]
    vox = _index_scale(tuple(shape), phi_ab.device)
    comp = compose(phi_ab, phi_ba)
    ice = (comp - identity_map(shape, phi_ab.device)) * vox
    ice_n = torch.sqrt(torch.sum(ice[2:-2, 2:-2, 2:-2] ** 2, dim=-1))

    def fold_fraction(phi):
        crop = (slice(0, shape[0] - 1), slice(0, shape[1] - 1), slice(0, shape[2] - 1))
        cols = [(torch.diff(phi, dim=j) * vox)[crop] for j in range(3)]
        det = torch.linalg.det(torch.stack(cols, dim=-1))
        return torch.mean((det <= 0.0).to(torch.float32))

    return {
        "ice_mean_vox": torch.mean(ice_n),
        "ice_max_vox": torch.max(ice_n),
        "fold_fraction_ab": fold_fraction(phi_ab),
        "fold_fraction_ba": fold_fraction(phi_ba),
    }


# ---------------------------------------------------------------------------
# Losses (gradicon.py:111-192, :238-246)
# ---------------------------------------------------------------------------


def _box_sum(x: torch.Tensor, win: int) -> torch.Tensor:
    """Box-filter sum over the last three dims, one axis at a time, with
    `lax.reduce_window`'s SAME zero padding: (win - 1) // 2 before, the
    rest after."""
    lo = (win - 1) // 2
    nd = x.dim()
    for axis in range(nd - 3, nd):
        pad = [0, 0] * (nd - 1 - axis) + [lo, win - 1 - lo]
        x = F.pad(x, pad).unfold(axis, win, 1).sum(-1)
    return x


def _box_mean(x: torch.Tensor, win: int) -> torch.Tensor:
    """Box-filter mean over a (D,H,W) volume, SAME padding."""
    return _box_sum(x, win) / _box_sum(torch.ones_like(x), win)


def lncc(a: torch.Tensor, b: torch.Tensor, win: int = 5, eps: float = 1e-5) -> torch.Tensor:
    """1 - mean local normalized cross-correlation over `win`^3 boxes; the
    five window sums are taken together as one stacked tensor."""
    cnt = _box_sum(torch.ones_like(a), win)
    sums = _box_sum(torch.stack([a, b, a * a, b * b, a * b]), win)
    mu_a, mu_b = sums[0] / cnt, sums[1] / cnt
    var_a = sums[2] / cnt - mu_a * mu_a
    var_b = sums[3] / cnt - mu_b * mu_b
    cov = sums[4] / cnt - mu_a * mu_b
    cc = (cov * cov) / (var_a * var_b + eps)
    return 1.0 - torch.mean(cc)


def make_similarity(kind: str = "lncc", lncc_window: int = 5, mse_weight: float = 10.0):
    """"lncc", "lncc+mse" (LNCC plus a weighted intensity term, the instance
    path's default) or "mse"."""

    def sim(a, b_warped):
        total = 0.0
        if "lncc" in kind:
            total = total + lncc(a, b_warped, lncc_window)
        if "mse" in kind:
            total = total + mse_weight * torch.mean((a - b_warped) ** 2)
        return total

    return sim


def gradicon_penalty(phi_ab: torch.Tensor, phi_ba: torch.Tensor) -> torch.Tensor:
    """|| d/dx (phi_AB o phi_BA) - I ||^2 via forward differences."""
    comp = compose(phi_ab, phi_ba)
    shape = comp.shape[:3]
    eye = torch.eye(3, dtype=comp.dtype, device=comp.device)
    total = 0.0
    for axis in range(3):
        h = 1.0 / (shape[axis] - 1)
        d = torch.diff(comp, dim=axis) / h
        total = total + torch.mean(torch.sum((d - eye[axis]) ** 2, dim=-1))
    return total


def gradicon_penalty_alternating(phi_ab: torch.Tensor, phi_ba: torch.Tensor) -> torch.Tensor:
    """The penalty evaluated in both composition orders with the outer field
    detached in each: every field gets its gradient through its role as the
    inner map (gathers only, no scatter-add into the outer field)."""
    return 0.5 * (gradicon_penalty(phi_ab.detach(), phi_ba) + gradicon_penalty(phi_ba.detach(), phi_ab))


def diffusion_penalty(phi: torch.Tensor) -> torch.Tensor:
    """Smoothness of the displacement u = phi - id (first differences)."""
    u = phi - identity_map(phi.shape[:3], phi.device)
    total = 0.0
    for axis in range(3):
        h = 1.0 / (phi.shape[axis] - 1)
        d = torch.diff(u, dim=axis) / h
        total = total + torch.mean(torch.sum(d * d, dim=-1))
    return total


# ---------------------------------------------------------------------------
# The multiscale network
# ---------------------------------------------------------------------------


def _stage_spec(width: int = 16) -> UNetSpec:
    """A compact 3-level UNet: 2 image channels in, 3 displacement channels out."""
    w = width
    return UNetSpec(
        name="reg_stage",
        enc=((w, 2 * w), (2 * w, 4 * w), (4 * w, 8 * w)),
        dec=((8 * w, 4 * w, 4 * w), (4 * w, 2 * w, 2 * w)),
        in_channels=2,
        n_classes=3,
        bias=True,
        batchnorm=False,
    )


@dataclasses.dataclass(frozen=True)
class GradICONConfig:
    """The network's architecture and grid, and the training loss's weights
    (gradicon.py:268-282)."""

    grid_shape: Tuple[int, int, int] = (48, 96, 96)  # z, y, x
    scales: Tuple[int, ...] = (4, 2, 1)  # coarse-to-fine downsample factors
    stage_width: int = 16
    lncc_window: int = 5
    lambda_reg: float = 1.5
    displacement_scale: float = 0.2
    similarity: str = "lncc"
    mse_weight: float = 10.0


class GradICON(nn.Module):
    """Multiscale two-step registration network, one UNet per scale, in
    `compute_dtype` (f32 params and accumulation either way)."""

    def __init__(self, config: GradICONConfig = GradICONConfig(), compute_dtype=torch.float32, device=None):
        super().__init__()
        self.config = config
        dev = resolve_device(device)
        self.stages = nn.ModuleList(
            UNet3D(_stage_spec(config.stage_width), compute_dtype, dev) for _ in config.scales
        )
        # the stage UNets start at zero (an identity map); `register_pair`
        # refuses a model whose weights were never loaded or drawn
        self.loaded = False

    def load_params(self, params_list: List[dict]) -> None:
        """Carry a JAX stage-params list onto the stage UNets."""
        carry_params(self, {"stages": {str(i): p for i, p in enumerate(params_list)}})
        self.loaded = True

    def params_list(self) -> List[dict]:
        """The stage-params list as numpy trees (what `load_params` takes and
        a checkpoint stores under `params/stage{i}`)."""
        return [export_params(stage) for stage in self.stages]

    @torch.no_grad()
    def init(self, generator: Optional[torch.Generator] = None, zero_heads: bool = True) -> "GradICON":
        """Draw every stage's UNet init from `generator` (port of
        gradicon.py:295-309). zero_heads: zero the displacement heads, so
        the untrained network is the identity transform."""
        gen = torch.Generator().manual_seed(0) if generator is None else generator
        for stage in self.stages:
            stage.init(gen)
            if zero_heads:
                stage.head.kernel.zero_()
                stage.head.bias.zero_()
        self.loaded = True
        return self

    def _stage_increment(self, stage: UNet3D, a_s, b_warp_s):
        net_in = torch.stack([a_s, b_warp_s], dim=-1)[None]
        u = stage(net_in)[0]
        return torch.tanh(u) * self.config.displacement_scale

    def forward_map(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """phi s.t. b(phi(x)) ~= a(x): the pullback warping B onto A's grid."""
        full_shape = tuple(a.shape)
        ident = identity_map(full_shape, a.device)
        phi = ident
        for stage, scale in zip(self.stages, self.config.scales):
            a_s, b_s = pyramid(a, scale), pyramid(warp(b, phi), scale)
            u = self._stage_increment(stage, a_s, b_s)
            if tuple(u.shape[:3]) != full_shape:
                u = resize_field(u, full_shape)
            phi = compose(phi, ident + u)
        return phi

    def both_maps(self, a: torch.Tensor, b: torch.Tensor):
        return self.forward_map(a, b), self.forward_map(b, a)

    def loss(self, a: torch.Tensor, b: torch.Tensor):
        """(sim + lambda_reg * reg, (sim, reg, phi_ab, phi_ba)) for one pair
        of (D, H, W) volumes (gradicon.py:341-347)."""
        cfg = self.config
        sim_fn = make_similarity(cfg.similarity, cfg.lncc_window, cfg.mse_weight)
        phi_ab, phi_ba = self.both_maps(a, b)
        sim = sim_fn(a, warp(b, phi_ab)) + sim_fn(b, warp(a, phi_ba))
        reg = gradicon_penalty(phi_ab, phi_ba)
        return sim + cfg.lambda_reg * reg, (sim, reg, phi_ab, phi_ba)


def make_gradicon_train_step(model: GradICON, optimizer):
    """A GradICON training step over a batch of pairs (port of
    gradicon.py:390-414): `step(a, b)` with a, b (N, D, H, W) runs one
    optimizer update of the mean loss over the pairs and returns it (0-d).
    The pairs run one after another (JAX's vmap), each backward adding its
    share, loss / N, to the gradients. `optimizer` is a `utils.optim`
    optimizer over the model's parameters, whose gradients this turns on."""
    def one(a1, b1):
        total, _ = model.loss(a1, b1)
        return total, ()

    def step(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return batch_step(optimizer, one, (a, b))[0]

    optimizer.require_grad()
    return step


def default_gradicon_weights_path() -> Path:
    """The JAX package's shipped weights file, read as data by path."""
    return Path(__file__).resolve().parents[2] / "oai_analysis_2_tpu" / "weights" / "gradicon.npz"


def load_gradicon_params(path=None) -> List[dict]:
    """The stage-params list of a native GradICON checkpoint (port of
    `oai_analysis_2_tpu/models/gradicon.py:359-363`)."""
    params, _ = load_gradicon_checkpoint(path)
    return params


def load_gradicon_checkpoint(path=None) -> Tuple[List[dict], dict]:
    """(stage-params list as numpy trees, architecture metadata)."""
    state = load_checkpoint(default_gradicon_weights_path() if path is None else path)
    stages = state["params"]
    meta = {}
    if "stage_width" in state:
        meta["stage_width"] = int(state["stage_width"])
    if "grid_shape" in state:
        meta["grid_shape"] = tuple(int(v) for v in state["grid_shape"])
    if "scales" in state:
        meta["scales"] = tuple(int(v) for v in state["scales"])
    return [stages[f"stage{i}"] for i in range(len(stages))], meta


# ---------------------------------------------------------------------------
# Instance optimization (gradicon.py:418-723)
# ---------------------------------------------------------------------------

INSTANCE_DEFAULT_LR = 1.2  # voxels of the current scale per Adam step
INSTANCE_DEFAULT_SIMILARITY = "lncc+mse"
# "alternating": GradICON gradients through the inner maps only
# (gradicon_penalty_alternating); "exact": through both composition roles,
# which scatter-adds into the outer field
INSTANCE_DEFAULT_GICON_GRAD = "alternating"

# the early stop's EMA smoothing of per-step loss drops (gradicon.py:616)
_EMA_BETA = np.float32(0.85)


def pyramid(volume: torch.Tensor, scale: int) -> torch.Tensor:
    """`volume` average-pooled down by `scale` (a power of two)."""
    for _ in range(int.bit_length(int(scale)) - 1):
        volume = downsample2x(volume)
    return volume


class InstanceScale:
    """One scale of instance optimization: displacement increments u_ab and
    u_ba on the scale's grid, zero at the start, that refine the base maps
    as base o (id + u); Adam on LNCC(+MSE) similarity, the GradICON penalty
    and a diffusion term (gradicon.py:561-589). The images are warped in
    bf16 with f32 weights; statistics, penalties and fields stay f32."""

    def __init__(self, base_ab, base_ba, a_s, b_s, lr: float = INSTANCE_DEFAULT_LR,
                 lncc_window: int = 5, similarity: str = INSTANCE_DEFAULT_SIMILARITY,
                 lambda_reg: float = 0.5, diffusion_weight: float = 0.3,
                 gicon_grad: str = INSTANCE_DEFAULT_GICON_GRAD):
        if gicon_grad not in ("exact", "alternating"):
            raise ValueError(f"gicon_grad must be 'exact' or 'alternating', got {gicon_grad!r}")
        shape_s = tuple(a_s.shape)
        dev = a_s.device
        self.base_ab, self.base_ba = base_ab.detach(), base_ba.detach()
        self.a_s, self.b_s = a_s.detach().float(), b_s.detach().float()
        self.a16, self.b16 = self.a_s.to(torch.bfloat16), self.b_s.to(torch.bfloat16)
        self.ident = identity_map_np(shape_s, dev)
        self.sim = make_similarity(similarity, lncc_window)
        self.penalty = gradicon_penalty if gicon_grad == "exact" else gradicon_penalty_alternating
        self.lambda_reg, self.diffusion_weight = lambda_reg, diffusion_weight
        self.u_ab = torch.zeros(shape_s + (3,), dtype=torch.float32, device=dev, requires_grad=True)
        self.u_ba = torch.zeros(shape_s + (3,), dtype=torch.float32, device=dev, requires_grad=True)
        # optax.adam, in normalized units
        self.optimizer = Adam([self.u_ab, self.u_ba], lr=lr / float(max(shape_s)), betas=(0.9, 0.999), eps=1e-8)

    def maps(self):
        return compose(self.base_ab, self.ident + self.u_ab), compose(self.base_ba, self.ident + self.u_ba)

    def loss(self) -> torch.Tensor:
        pab, pba = self.maps()
        wb = warp(self.b16, pab).float()
        wa = warp(self.a16, pba).float()
        sim = self.sim(self.a_s, wb) + self.sim(self.b_s, wa)
        reg = self.penalty(pab, pba)
        smooth = diffusion_penalty(pab) + diffusion_penalty(pba)
        return sim + self.lambda_reg * reg + self.diffusion_weight * smooth

    def step(self) -> torch.Tensor:
        """One Adam step; returns the loss before it (0-d, on the device)."""
        with torch.enable_grad():
            self.optimizer.zero_grad(set_to_none=True)
            loss = self.loss()
            loss.backward()
            self.optimizer.step()
        return loss.detach()

    def finish(self, full_shape):
        """The refined maps resized to the full grid."""
        with torch.no_grad():
            pab, pba = self.maps()
            return resize_field(pab, full_shape), resize_field(pba, full_shape)


def run_scale(problem: InstanceScale, n_steps: int, early_stop: Optional[float] = None,
              verbose: bool = False) -> int:
    """Run up to `n_steps` Adam steps; returns the steps taken.

    early_stop: stop once the EMA of positive per-step loss drops falls to
    `early_stop` x its peak, after at least max(6, n_steps // 4) + 1 steps
    (gradicon.py:607-646). The loss is read on the host each step and the
    criterion kept in f32, as the JAX package's device loop keeps it, so
    the same losses give the same step count. Without early_stop nothing
    is read back."""
    min_steps = max(6, n_steps // 4)
    last_l = ema = peak = np.float32(0.0)
    tol = np.float32(early_stop) if early_stop is not None else None
    for i in range(n_steps):
        loss = problem.step()
        if verbose and i % 20 == 0:
            print(f"scale shape {tuple(problem.a_s.shape)} step {i}: loss {float(loss):.4f}")
        if tol is None:
            continue
        loss = np.float32(float(loss))
        drop = max(np.float32(0.0) if i == 0 else np.float32(last_l - loss), np.float32(0.0))
        ema = drop if i <= 1 else np.float32(_EMA_BETA * ema + np.float32(1.0 - 0.85) * drop)
        peak = max(peak, ema)
        last_l = loss
        if i >= min_steps and not ema > tol * peak:
            if verbose:
                print(f"scale shape {tuple(problem.a_s.shape)}: early stop at step {i + 1}")
            return i + 1
    return n_steps


def register_pair_instance(
    a: torch.Tensor,
    b: torch.Tensor,
    scales: Sequence[int] = (8, 4, 2),
    steps_per_scale=60,
    lr: float = INSTANCE_DEFAULT_LR,
    lncc_window: int = 5,
    lambda_reg: float = 0.5,
    diffusion_weight: float = 0.3,
    similarity: str = INSTANCE_DEFAULT_SIMILARITY,
    verbose: bool = False,
    init_ab: Optional[torch.Tensor] = None,
    init_ba: Optional[torch.Tensor] = None,
    gicon_grad: str = INSTANCE_DEFAULT_GICON_GRAD,
    early_stop: Optional[float] = None,
):
    """Symmetric multiscale instance-optimization registration (port of
    gradicon.py:429-517): per scale, coarse to fine, Adam on displacement
    increments of both directions (`InstanceScale`), each scale starting
    from the previous maps resized to it. `steps_per_scale` is an int or
    one count per scale; `lr` is in voxels of the current scale per step.
    init_ab / init_ba: full-grid maps to start from (fine-tuning a
    network's prediction). Returns (phi_ab, phi_ba) on a's grid; b(phi_ab(x)) ~= a(x)."""
    if isinstance(steps_per_scale, int):
        steps_per_scale = [steps_per_scale] * len(scales)
    full_shape = tuple(a.shape)
    ident_full = identity_map(full_shape, a.device)
    phi_ab = ident_full if init_ab is None else init_ab.detach()
    phi_ba = ident_full if init_ba is None else init_ba.detach()
    for scale, n_steps in zip(scales, steps_per_scale):
        a_s, b_s = pyramid(a, scale), pyramid(b, scale)
        shape_s = tuple(a_s.shape)
        with torch.no_grad():
            base_ab, base_ba = resize_field(phi_ab, shape_s), resize_field(phi_ba, shape_s)
        problem = InstanceScale(base_ab, base_ba, a_s, b_s, lr=lr, lncc_window=lncc_window,
                                similarity=similarity, lambda_reg=lambda_reg,
                                diffusion_weight=diffusion_weight, gicon_grad=gicon_grad)
        taken = run_scale(problem, int(n_steps), early_stop, verbose)
        if verbose and early_stop is not None:
            print(f"scale {scale}: {taken}/{int(n_steps)} steps")
        phi_ab, phi_ba = problem.finish(full_shape)
    return phi_ab, phi_ba


def clear_instance_cache() -> None:
    """Drop the cached identity maps and index scales (one per shape and
    device; the JAX package drops its memoized per-scale programs here) and
    release what PyTorch's caching allocator holds on the card."""
    _identity_map_cached.cache_clear()
    _index_scale.cache_clear()
    if torch.cuda.is_initialized():
        torch.cuda.empty_cache()
