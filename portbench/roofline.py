"""The yardstick's arithmetic: the card's published peaks, the bound rule,
and the operations and bytes of every kernel the benchmark reads, computed
from shapes alone.

Peaks are NVIDIA's data sheet for one H100 SXM, dense rates at the full
700 W limit: 989 TFLOP/s in bf16 on the tensor cores, 67 TFLOP/s in f32
outside them, 3.35 TB/s of HBM. The bound of a piece of work is the larger
of its operations over the peak of its type and its bytes over the HBM
rate; each input byte is counted read once and each output byte written
once. A roofline share is the bound over the measured device time.

The counts are of the work the model needs at the configuration's shapes
and types, not of what a kernel happens to do, so they stay put when a
later change puts another kernel in.
"""

from __future__ import annotations

import statistics
import subprocess
from typing import Dict, Iterable, List, Tuple

HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
F32_FLOPS = 67e12
PEAK_FLOPS = {"bfloat16": BF16_FLOPS, "float32": F32_FLOPS}
ESIZE = {"bfloat16": 2, "float32": 4}

# The least f32 operations a point-triangle pair needs in the distance
# kernel's inner loop, an FMA counted as 2 and every other add, multiply,
# min or compare as 1: q = a - p 3; the plane's t = q.n 5 and t * t / n.n 2;
# d2 = q.m2 and d3 = q.m3 5 each, d1 = n.n - d2 - d3 2; the inside test 3;
# edge ab 17 (u.w 5, saturated t 1, r = u + t w 6, r.r 5), edges bc and ca
# 20 each; the nearest edge 2; the running minimum 1. Total 85.
DIST_OPS_PER_PAIR = 85


def card_line() -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    lines = out.stdout.strip().splitlines()
    return lines[0] if lines else f"nvidia-smi gave nothing (exit {out.returncode})"


def bound_seconds(flops: float, nbytes: float, dtype: str) -> float:
    """The least time the card could take: operations over the type's peak
    or bytes over HBM, whichever is larger."""
    return max(flops / PEAK_FLOPS[dtype], nbytes / HBM_BYTES_PER_S)


def conv3x3_work(voxels: int, cin: int, cout: int, dtype: str, out_dtype: str = None, bias: bool = True):
    """(flops, bytes) of one SAME 3x3x3 conv over `voxels` output voxels:
    x, weights and bias read once, the output written once."""
    e = ESIZE[dtype]
    eo = ESIZE[out_dtype or dtype]
    flops = 2.0 * 27 * cin * cout * voxels
    nbytes = voxels * cin * e + 27 * cin * cout * e + (cout * 4 if bias else 0) + voxels * cout * eo
    return flops, nbytes


def pointwise_work(voxels: int, cin: int, cout: int) -> float:
    """Operations of a (voxels, cin) @ (cin, cout) product (the k2s2 upconv
    counts cout as 8 Cout, the 1x1x1 head as n_classes)."""
    return 2.0 * voxels * cin * cout


def distance_work(n_points: int, n_triangles: int) -> Tuple[float, float]:
    """(flops, bytes) of the exact distance of n_points points to a mesh of
    n_triangles triangles: points (12 B) and triangles (36 B) read once, one
    f32 distance written a point."""
    flops = float(DIST_OPS_PER_PAIR) * n_points * n_triangles
    nbytes = n_points * 12.0 + n_triangles * 36.0 + n_points * 4.0
    return flops, nbytes


# ---------------------------------------------------------------------------
# The convs of a UNet spec, as the benchmark's configuration files give it
# ---------------------------------------------------------------------------


def unet_convs(enc: List[List[int]], dec: List[List[int]], in_channels: int) -> List[Tuple[str, int, int, int]]:
    """(name, level, Cin, Cout) of each 3x3x3 conv of a UNet: level l runs at
    the input's size over 2**l along each axis."""
    convs = []
    cin = in_channels
    for li, (ca, cb) in enumerate(enc):
        convs += [(f"enc{li}a", li, cin, ca), (f"enc{li}b", li, ca, cb)]
        cin = cb
    for li, (cu, c1, c2) in enumerate(dec):
        level = len(enc) - 2 - li
        skip = enc[level][1]
        convs += [(f"dec{li}a", level, cu + skip, c1), (f"dec{li}b", level, c1, c2)]
    return convs


def unet_pointwise(enc, dec, n_classes: int) -> List[Tuple[str, int, int, int]]:
    """(name, level of the input, Cin, Cout) of the k2s2 upconvs (Cout as
    8 x their channels, at the coarser level's voxels) and the head."""
    out = []
    cur = enc[-1][1]
    for li, (cu, _c1, c2) in enumerate(dec):
        out.append((f"dec{li}up", len(enc) - 1 - li, cur, 8 * cu))
        cur = c2
    out.append(("head", 0, dec[-1][2], n_classes))
    return out


def level_voxels(shape: Iterable[int], level: int) -> int:
    v = 1
    for s in shape:
        v *= int(s) // (2 ** level)
    return v


def sm90_takes(cin: int, cout: int) -> bool:
    """Which bf16 convs the sm90 kernel (csrc/conv3d_sm90.cu) was written for:
    Cin a multiple of 16 and Cout of 64."""
    return cin % 16 == 0 and cout % 64 == 0


def sm90n_takes(cin: int, cout: int) -> bool:
    """Which bf16 convs the sm90n kernel (csrc/conv3d_sm90n.cu) was written
    for: Cin a multiple of 8 that sm90 does not take, Cin 1 left to cin1."""
    return cin % 8 == 0 and not sm90_takes(cin, cout)


def sum_work(items) -> Dict[str, float]:
    """{"flops", "bytes", "bound_s"} summed over (flops, bytes, dtype) items."""
    flops = nbytes = bound = 0.0
    for f, b, dt in items:
        flops += f
        nbytes += b
        bound += bound_seconds(f, b, dt)
    return {"flops": flops, "bytes": nbytes, "bound_s": bound}


def spread_summary(xs) -> dict:
    """Quartiles and the two halves' means of a run's item seconds, for the
    run's log: how far a run's pace moves inside its window."""
    if len(xs) < 4:
        return {"n": len(xs)}
    q = statistics.quantiles(xs, n=4)
    h = len(xs) // 2
    return {"n": len(xs), "q1": round(q[0], 4), "median": round(q[1], 4), "q3": round(q[2], 4),
            "first_half": round(statistics.fmean(xs[:h]), 4), "second_half": round(statistics.fmean(xs[h:]), 4)}
