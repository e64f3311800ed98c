"""Physical-space trilinear resampling and displacement-field warping
(port of `oai_analysis_2_tpu/ops/resample.py`).

Semantics are the JAX package's (ITK's): an output voxel's physical point
is pulled back through the transform and converted to a continuous index
of the moving image; points outside the buffer (with an inclusive 1e-3
tolerance) give `outside_value`; a displacement field maps x -> x + d(x)
with d trilinearly interpolated on its own grid and zero outside it. The
gather is written out explicitly (`F.grid_sample` clamps and tests the
boundary differently).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from oai_analysis_2_tpu_torch.core.image import Image, physical_grid


@dataclasses.dataclass(frozen=True)
class DisplacementField:
    """(D, H, W, 3) xyz physical displacement vectors on a [z, y, x] grid."""

    field: torch.Tensor
    origin: torch.Tensor
    spacing: torch.Tensor
    direction: torch.Tensor

    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(self.field.shape[:3])

    def as_image_grid(self) -> Image:
        return Image(data=self.field[..., 0], origin=self.origin, spacing=self.spacing,
                     direction=self.direction)


def _lerp(a: torch.Tensor, b: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    return a * (1 - f) + b * f


class _ClipTies(torch.autograd.Function):
    """`torch.clamp(x, lo, hi)` whose gradient is halved where x equals a
    bound. JAX's `jnp.clip` is a max then a min, and each splits a tie's
    gradient in two; `torch.clamp` passes all of it. Instance optimization
    starts every scale at u = 0, where sample points sit exactly on grid
    nodes, so the first step's gradient depends on this."""

    @staticmethod
    def forward(ctx, x, lo: float, hi: float):
        ctx.save_for_backward(x)
        ctx.bounds = (lo, hi)
        return torch.clamp(x, lo, hi)

    @staticmethod
    def backward(ctx, grad):
        (x,) = ctx.saved_tensors
        lo, hi = ctx.bounds
        inside = ((x > lo) & (x < hi)).to(grad.dtype)
        ties = ((x == lo) | (x == hi)).to(grad.dtype)
        return grad * (inside + 0.5 * ties), None, None


def clip_ties(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """clamp with JAX's tie gradient (`_ClipTies`)."""
    return _ClipTies.apply(x, lo, hi)


def _trilinear_gather(
    volume: torch.Tensor, idx_zyx: torch.Tensor, outside_value: float, z_first: bool = False
) -> torch.Tensor:
    """Trilinear sample of a (D,H,W) or (D,H,W,C) volume at continuous
    (..., 3) z,y,x indices (port of resample.py:81-165): inclusive 1e-3
    inside test, clamped taps, flat 1-D gathers, and JAX's gradient with
    respect to the indices (the fractional weights' clip halves it at a
    tie, `clip_ties`).

    z_first=True interpolates along z, then y, then x — the order of the
    JAX package's packed-neighbourhood gather (`pack=True`, :127-135), which
    its fused warp programs use; the default order (x, then y, then z) is
    that of its unpacked gather, used by the registration transforms. The
    TPU's packed layout itself (one 32-byte row per point) is not copied."""
    d, h, w = volume.shape[:3]
    z, y, x = idx_zyx[..., 0], idx_zyx[..., 1], idx_zyx[..., 2]
    eps = 1e-3
    inside = (
        (z >= -eps) & (z <= d - 1.0 + eps)
        & (y >= -eps) & (y <= h - 1.0 + eps)
        & (x >= -eps) & (x <= w - 1.0 + eps)
    )
    z0 = torch.clamp(torch.floor(z), 0, d - 1).to(torch.int64)
    y0 = torch.clamp(torch.floor(y), 0, h - 1).to(torch.int64)
    x0 = torch.clamp(torch.floor(x), 0, w - 1).to(torch.int64)
    z1 = torch.clamp(z0 + 1, max=d - 1)
    y1 = torch.clamp(y0 + 1, max=h - 1)
    x1 = torch.clamp(x0 + 1, max=w - 1)
    fz = clip_ties(z - z0.to(z.dtype), 0.0, 1.0)
    fy = clip_ties(y - y0.to(y.dtype), 0.0, 1.0)
    fx = clip_ties(x - x0.to(x.dtype), 0.0, 1.0)

    flat = volume.reshape((d * h * w,) + tuple(volume.shape[3:]))

    def gather(zi, yi, xi):
        return flat[(zi * h + yi) * w + xi]

    if volume.dim() == 4:
        fz, fy, fx, inside = fz[..., None], fy[..., None], fx[..., None], inside[..., None]

    if z_first:
        c00 = _lerp(gather(z0, y0, x0), gather(z1, y0, x0), fz)
        c01 = _lerp(gather(z0, y0, x1), gather(z1, y0, x1), fz)
        c10 = _lerp(gather(z0, y1, x0), gather(z1, y1, x0), fz)
        c11 = _lerp(gather(z0, y1, x1), gather(z1, y1, x1), fz)
        out = _lerp(_lerp(c00, c10, fy), _lerp(c01, c11, fy), fx)
    else:
        c00 = _lerp(gather(z0, y0, x0), gather(z0, y0, x1), fx)
        c01 = _lerp(gather(z0, y1, x0), gather(z0, y1, x1), fx)
        c10 = _lerp(gather(z1, y0, x0), gather(z1, y0, x1), fx)
        c11 = _lerp(gather(z1, y1, x0), gather(z1, y1, x1), fx)
        out = _lerp(_lerp(c00, c01, fy), _lerp(c10, c11, fy), fz)
    # a Python scalar, not a tensor: a 0-d tensor made on the host would be
    # copied to the card, which waits for the stream on every call
    return torch.where(inside, out, outside_value)


def sample_at_physical_points(image: Image, points_xyz: torch.Tensor, outside_value: float = 0.0) -> torch.Tensor:
    """Trilinearly sample an Image at physical points (..., 3) xyz."""
    idx_zyx = image.physical_to_indices(points_xyz).flip(-1)
    return _trilinear_gather(image.data, idx_zyx, outside_value)


def sample_displacement(disp: DisplacementField, points_xyz: torch.Tensor) -> torch.Tensor:
    """Interpolate the displacement field at physical points; zero outside."""
    idx_zyx = disp.as_image_grid().physical_to_indices(points_xyz).flip(-1)
    return _trilinear_gather(disp.field, idx_zyx, 0.0)


def _interp_matrix(n_out: int, a: float, b: float, n_in: int, eps: float = 1e-3) -> np.ndarray:
    """(n_out, n_in) 1-D linear-interpolation weights for idx(i) = a*i + b;
    rows outside [-eps, n_in-1+eps] are zero (copy of resample.py:197-211)."""
    idx = a * np.arange(n_out, dtype=np.float64) + b
    inside = (idx >= -eps) & (idx <= n_in - 1 + eps)
    i0 = np.clip(np.floor(idx), 0, n_in - 1).astype(np.int64)
    i1 = np.minimum(i0 + 1, n_in - 1)
    f = np.clip(idx - i0, 0.0, 1.0)
    w = np.zeros((n_out, n_in), np.float32)
    rows = np.arange(n_out)
    np.add.at(w, (rows, i0), (1.0 - f) * inside)
    np.add.at(w, (rows, i1), f * inside)
    return w


def _separable_resize_weights(disp: DisplacementField, reference: Image):
    """Per-axis (z, y, x) interpolation matrices mapping the field grid onto
    `reference`'s grid, or None when the index map is not axis-aligned."""

    def np64(t):
        return t.detach().cpu().numpy().astype(np.float64)

    m_ref = np64(reference.direction) * np64(reference.spacing)[None, :]
    m_fld = np64(disp.direction) * np64(disp.spacing)[None, :]
    try:
        m_fld_inv = np.linalg.inv(m_fld)
    except np.linalg.LinAlgError:
        return None
    a = m_fld_inv @ m_ref
    b = m_fld_inv @ (np64(reference.origin) - np64(disp.origin))
    diag = np.diag(a)
    if not np.allclose(a, np.diag(diag), atol=1e-9 + 1e-6 * np.abs(diag).max()):
        return None
    shp_ref, shp_fld = reference.shape, disp.shape
    dev = disp.field.device
    return tuple(
        torch.as_tensor(_interp_matrix(shp_ref[ax], diag[c], b[c], shp_fld[ax]), device=dev)
        for ax, c in ((0, 2), (1, 1), (2, 0))
    )


def _upsample_field_separable(field: torch.Tensor, wz, wy, wx) -> torch.Tensor:
    """(Df,Hf,Wf,3) -> (Dr,Hr,Wr,3) trilinear resize as three f32 products."""
    out = torch.einsum("zj,jklc->zklc", wz, field)
    out = torch.einsum("yk,zklc->zylc", wy, out)
    return torch.einsum("xl,zylc->zyxc", wx, out)


def _warp_stacked(stacked, moving: Image, reference: Image,
                  displacement: Optional[DisplacementField], outside_value: float):
    """One (D,H,W,C) stack warped onto `reference`'s grid."""
    pts = physical_grid(reference.shape, reference.origin, reference.spacing, reference.direction)
    if displacement is not None:
        weights = _separable_resize_weights(displacement, reference)
        if weights is not None:
            pts = pts + _upsample_field_separable(displacement.field, *weights)
        else:
            pts = pts + sample_displacement(displacement, pts)
    idx_zyx = moving.physical_to_indices(pts).flip(-1)
    return _trilinear_gather(stacked, idx_zyx, outside_value, z_first=True)


def resample_image(
    moving: Image,
    reference: Image,
    displacement: Optional[DisplacementField] = None,
    outside_value: float = 0.0,
) -> Image:
    """Pull `moving` back onto `reference`'s grid, optionally through a
    displacement transform."""
    warped = _warp_stacked(moving.data[..., None], moving, reference, displacement, outside_value)
    return Image(data=warped[..., 0].to(moving.dtype), origin=reference.origin,
                 spacing=reference.spacing, direction=reference.direction)


def resample_with_displacement(moving: Image, displacement: DisplacementField, reference: Image) -> Image:
    """`resample_image` in the reference's deform_probmap argument order."""
    return resample_image(moving, reference, displacement)


def resample_images(
    movings,
    reference: Image,
    displacement: Optional[DisplacementField] = None,
    outside_value: float = 0.0,
    compute_dtype=None,
):
    """Warp several same-grid volumes in one pass (sources gathered as
    channels). compute_dtype=torch.bfloat16 gathers the source voxels in
    bf16 (indices, weights and blending stay f32 for f32 fields, as in the
    JAX package); outputs are cast back to each input's dtype."""
    first = movings[0]
    stacked = torch.stack([m.data for m in movings], dim=-1)
    if compute_dtype is not None:
        stacked = stacked.to(compute_dtype)
    warped = _warp_stacked(stacked, first, reference, displacement, outside_value)
    return [
        Image(data=warped[..., c].to(movings[c].dtype), origin=reference.origin,
              spacing=reference.spacing, direction=reference.direction)
        for c in range(len(movings))
    ]
