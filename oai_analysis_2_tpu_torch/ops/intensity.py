"""Intensity windowing, normalisation and comparison (port of
`oai_analysis_2_tpu/ops/intensity.py:17-64`)."""

from __future__ import annotations

import numpy as np
import torch

from oai_analysis_2_tpu_torch.core.image import Image


def intensity_window(image: Image, window_min, window_max, out_min=0.0, out_max=1.0) -> Image:
    """Linear window/level rescale with clamping (ITK IntensityWindowingImageFilter)."""
    x = image.data.to(torch.float32)
    wmin = torch.as_tensor(window_min, dtype=torch.float32, device=x.device)
    wmax = torch.as_tensor(window_max, dtype=torch.float32, device=x.device)
    scale = (out_max - out_min) / torch.clamp(wmax - wmin, min=1e-20)
    y = (x - wmin) * scale + out_min
    y = torch.clamp(y, min(out_min, out_max), max(out_min, out_max))
    return image.with_data(y)


def _percentiles(x: torch.Tensor, percs) -> list:
    """`jnp.percentile`'s linear interpolation, from ONE sort.

    `torch.quantile` refuses inputs this large (a 160x384x384 volume), so the
    order statistics come from `torch.sort`. The position q*(n-1) is formed
    in float32 as JAX forms it, so the interpolation weights agree."""
    flat = torch.sort(x.reshape(-1)).values
    n = flat.numel()
    out = []
    for p in percs:
        pos = np.float32(np.float32(p) / np.float32(100.0)) * np.float32(n - 1)
        lo = int(np.clip(np.floor(pos), 0, n - 1))
        hi = int(np.clip(np.ceil(pos), 0, n - 1))
        w_hi = np.float32(pos - np.floor(pos))
        w_lo = np.float32(1.0) - w_hi
        out.append(flat[lo] * float(w_lo) + flat[hi] * float(w_hi))
    return out


def percentile_window(
    image: Image,
    window_min_perc: float = 0.1,
    window_max_perc: float = 99.9,
    out_min: float = 0.0,
    out_max: float = 1.0,
) -> Image:
    """The reference's `image_normalize`: percentile window -> [out_min, out_max]."""
    lo, hi = _percentiles(image.data.to(torch.float32), (window_min_perc, window_max_perc))
    return intensity_window(image, lo, hi, out_min, out_max)


def normalize_image(image: Image) -> Image:
    """Zero-mean unit-variance (ITK NormalizeImageFilter; population std)."""
    x = image.data.to(torch.float32)
    return image.with_data((x - x.mean()) / torch.clamp(x.std(correction=0), min=1e-20))


def comparison_sum(a: Image, b: Image) -> torch.Tensor:
    """Summed absolute voxel difference, the reference's regression metric."""
    return (a.data.to(torch.float32) - b.data.to(torch.float32)).abs().sum()


def checkerboard(a: Image, b: Image, pattern=(4, 4, 4)) -> Image:
    """Alternate blocks of two images (ITK CheckerBoardImageFilter);
    `pattern` counts blocks along x, y, z."""
    d, h, w = a.data.shape
    dev = a.data.device
    pz, py, px = pattern[2], pattern[1], pattern[0]
    zi = (torch.arange(d, device=dev) * pz // max(d, 1)) % 2
    yi = (torch.arange(h, device=dev) * py // max(h, 1)) % 2
    xi = (torch.arange(w, device=dev) * px // max(w, 1)) % 2
    mask = (zi[:, None, None] + yi[None, :, None] + xi[None, None, :]) % 2
    return a.with_data(torch.where(mask == 0, a.data, b.data.to(a.data.dtype)))
