"""Intensity windowing, normalisation and comparison (port of
`oai_analysis_2_tpu/ops/intensity.py:17-64`)."""

from __future__ import annotations

from fractions import Fraction

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


def _round_f32(x: Fraction) -> np.float32:
    """`x` rounded once to float32, to nearest with ties to even (`float`
    rounds to float64 first, so the neighbours are checked)."""
    best = np.float32(float(x))
    for g in (np.nextafter(best, np.float32(-np.inf)), np.nextafter(best, np.float32(np.inf))):
        dg, db = abs(Fraction(float(g)) - x), abs(Fraction(float(best)) - x)
        if dg < db or (dg == db and int(g.view(np.int32)) % 2 == 0):
            best = g
    return best


def _fma32(a, b, c) -> np.float32:
    """float32 `a * b + c` with one rounding, as a fused multiply-add."""
    if not all(np.isfinite(v) for v in (a, b, c)):
        return np.float32(np.float32(a) * np.float32(b) + np.float32(c))
    return _round_f32(Fraction(float(a)) * Fraction(float(b)) + Fraction(float(c)))


def _percentiles(x: torch.Tensor, percs, folded: bool = False) -> list:
    """`jnp.percentile(x, p)` for each p, bit for bit, from ONE sort.

    `torch.quantile` refuses inputs this large (a 160x384x384 volume), so the
    order statistics come from `torch.sort`; the rest is float32 host
    arithmetic in the order XLA's CPU build of `_quantile` (JAX 0.9, `linear`)
    runs it. n - 1 is formed in float32 from float32(n) (it rounds above
    2^24). With p a runtime scalar (`jnp.percentile` called on its own, as
    `percentile_window` calls it) XLA rewrites `p / 100 * (n - 1)` as
    `p * ((n - 1) * 0.01)`, the constant rounded to float32 first, and the
    result is `fma(hi, w_hi, lo * w_lo)`. With p a constant of the caller's
    program (`folded`, the knee batch's window) the position is folded in
    source order, `(p / 100) * (n - 1)`, and the result is
    `fma(lo, w_lo, hi * w_hi)`. On the phantom's 2,949,120 voxels the two
    positions differ by one ulp (0.25 of an index) at p = 99.9. Any NaN
    makes every percentile NaN, as JAX's."""
    flat = torch.sort(x.reshape(-1)).values
    n = flat.numel()
    f32 = np.float32
    nm1 = f32(f32(n) - f32(1))
    rows = []
    for p in percs:
        q = f32(p)
        pos = f32(f32(q / f32(100)) * nm1) if folded else f32(q * f32(nm1 * f32(0.01)))
        w_hi = f32(pos - np.floor(pos))
        w_lo = f32(f32(1) - w_hi)
        i, j = (min(max(int(v), 0), n - 1) for v in (np.floor(pos), np.ceil(pos)))
        rows.append((i, j, w_lo, w_hi))
    # the order statistics and the largest element (NaN sorts last) in one read
    idx = [k for i, j, _, _ in rows for k in (i, j)] + [n - 1]
    stats = flat[torch.tensor(idx, device=flat.device)].tolist()
    if np.isnan(stats[-1]):
        return [float("nan")] * len(rows)
    out = []
    for k, (_, _, w_lo, w_hi) in enumerate(rows):
        a, b = f32(stats[2 * k]), f32(stats[2 * k + 1])
        v = _fma32(a, w_lo, f32(b * w_hi)) if folded else _fma32(b, w_hi, f32(a * w_lo))
        out.append(float(v))
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
