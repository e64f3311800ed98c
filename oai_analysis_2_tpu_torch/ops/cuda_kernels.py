"""Exact point-to-triangle distance: the wrapper of the Hopper kernel
`csrc/point_triangle.cu` and its plain PyTorch version.

Replaces the TPU kernel `_dist_kernel` (`oai_analysis_2_tpu/ops/
pallas_kernels.py:34-91`, launched by `_distance_pallas` and wrapped by
`point_triangle_distance_pallas_async`). For each point: the minimum over
all triangles of the exact squared distance (plane distance when the
projection falls inside by triple-product signs, else the nearest clamped
edge), then one square root here. What bounds the kernel on the card and
what its design does about it is written at the top of the CUDA source.

`point_triangle_min_d2` takes the plain version ONLY for tensors on the
CPU. A CUDA tensor launches the kernel or raises;
`point_triangle_min_d2.launches` counts the launches. Under it,
`point_triangle_launch` is the uncounted launcher; only a measurement calls
it with build="was", the kernel's predecessor (`csrc/point_triangle_was.cu`).
"""

from __future__ import annotations

import ctypes

import torch

_TINY = 1e-30
_INF_BITS = 0x7F800000  # +inf as float32 bits
_TARGET_BLOCKS = 8 * 132  # the "was" build's split: several blocks per SM of an H100


def _pair_d2(p: torch.Tensor, tri: torch.Tensor) -> torch.Tensor:
    """(P, 3) points x (T, 9) triangles -> (P, T) squared distances, with the
    TPU kernel's operation order (pallas_kernels.py:41-82)."""
    px, py, pz = (p[:, i : i + 1] for i in range(3))
    ax, ay, az, bx, by, bz, cx, cy, cz = (tri[:, i][None, :] for i in range(9))
    abx, aby, abz = bx - ax, by - ay, bz - az
    acx, acy, acz = cx - ax, cy - ay, cz - az
    nx = aby * acz - abz * acy
    ny = abz * acx - abx * acz
    nz = abx * acy - aby * acx
    nn = nx * nx + ny * ny + nz * nz

    apx, apy, apz = px - ax, py - ay, pz - az
    t = apx * nx + apy * ny + apz * nz
    plane_d2 = (t * t) / torch.clamp(nn, min=_TINY)

    bpx, bpy, bpz = bx - px, by - py, bz - pz
    cpx, cpy, cpz = cx - px, cy - py, cz - pz
    qx, qy, qz = -apx, -apy, -apz
    d1 = (bpy * cpz - bpz * cpy) * nx + (bpz * cpx - bpx * cpz) * ny + (bpx * cpy - bpy * cpx) * nz
    d2 = (cpy * qz - cpz * qy) * nx + (cpz * qx - cpx * qz) * ny + (cpx * qy - cpy * qx) * nz
    d3 = (qy * bpz - qz * bpy) * nx + (qz * bpx - qx * bpz) * ny + (qx * bpy - qy * bpx) * nz
    inside = (d1 >= 0) & (d2 >= 0) & (d3 >= 0) & (nn > _TINY)

    def seg_d2(ux, uy, uz, vx, vy, vz):
        wx, wy, wz = vx - ux, vy - uy, vz - uz
        ww = torch.clamp(wx * wx + wy * wy + wz * wz, min=_TINY)
        tt = torch.clamp(((px - ux) * wx + (py - uy) * wy + (pz - uz) * wz) / ww, 0.0, 1.0)
        dx = px - (ux + tt * wx)
        dy = py - (uy + tt * wy)
        dz = pz - (uz + tt * wz)
        return dx * dx + dy * dy + dz * dz

    edge = torch.minimum(
        seg_d2(ax, ay, az, bx, by, bz),
        torch.minimum(seg_d2(bx, by, bz, cx, cy, cz), seg_d2(cx, cy, cz, ax, ay, az)),
    )
    return torch.where(inside, plane_d2, edge)


def point_triangle_min_d2_reference(
    points: torch.Tensor, tris: torch.Tensor, point_chunk: int = 512, tri_chunk: int = 2048
) -> torch.Tensor:
    """Plain PyTorch version: (P, 3) f32 points, (T, 9) f32 triangles ->
    (P,) minimum squared distances, in (point_chunk x tri_chunk) tiles."""
    out = torch.full((points.shape[0],), float("inf"), dtype=torch.float32, device=points.device)
    for p0 in range(0, points.shape[0], point_chunk):
        p = points[p0 : p0 + point_chunk]
        best = out[p0 : p0 + point_chunk]
        for t0 in range(0, tris.shape[0], tri_chunk):
            best = torch.minimum(best, _pair_d2(p, tris[t0 : t0 + tri_chunk]).amin(dim=1))
        out[p0 : p0 + point_chunk] = best
    return out


BUILDS = {
    # build: (library, C function, points per block where the wrapper
    # chooses the triangle split, None where the kernel's launcher does)
    "fma": ("point_triangle", "point_triangle_min_d2", None),
    "was": ("point_triangle_was", "point_triangle_min_d2_was", 128),
}


def point_triangle_launch(points: torch.Tensor, tris: torch.Tensor, *, build: str = "fma") -> torch.Tensor:
    """Launch one build of the distance kernel on CUDA tensors, uncounted:
    `point_triangle_min_d2` calls it with the "fma" build (csrc/
    point_triangle.cu) and counts the launch. Called directly with
    build="was", it times the build that kernel replaced
    (csrc/point_triangle_was.cu)."""
    if build not in BUILDS:
        raise ValueError(f"point_triangle: unknown build {build!r}")
    for name, t, cols in (("points", points, 3), ("tris", tris, 9)):
        if t.dtype != torch.float32 or t.dim() != 2 or t.shape[1] != cols:
            raise TypeError(f"point_triangle: {name} must be f32 (N, {cols}), got {t.dtype} {tuple(t.shape)}")
        if t.device != points.device or not t.is_contiguous():
            raise ValueError(f"point_triangle: {name} must be contiguous on {points.device}")
        if t.shape[0] >= 2**31 // 9:
            raise ValueError(f"point_triangle: too many {name}")
    if points.device.type != "cuda":
        raise ValueError(f"point_triangle: unsupported device {points.device}")
    from oai_analysis_2_tpu_torch.ops.cuda_build import load_library

    lib_name, fn_name, per_block = BUILDS[build]
    fn = getattr(load_library(lib_name), fn_name)
    n_pts, n_tris = points.shape[0], tris.shape[0]
    bits = torch.full((n_pts,), _INF_BITS, dtype=torch.int32, device=points.device)
    args = [points.data_ptr(), tris.data_ptr(), n_pts, n_tris]
    if per_block is not None:
        args.append(max(1, -(-_TARGET_BLOCKS // max(1, -(-n_pts // per_block)))))
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * (len(args) - 2) + [ctypes.c_void_p] * 2
    fn.restype = ctypes.c_int
    with torch.cuda.device(points.device):
        stream = torch.cuda.current_stream(points.device).cuda_stream
        err = fn(*args, bits.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"point_triangle: {build} kernel launch failed with CUDA error {err}")
    return bits.view(torch.float32)


def point_triangle_min_d2(points: torch.Tensor, tris: torch.Tensor) -> torch.Tensor:
    """(P, 3) f32 points, (T, 9) f32 triangles (a, b, c corners, xyz each)
    -> (P,) minimum squared point-to-triangle distances."""
    if points.device.type == "cpu":
        return point_triangle_min_d2_reference(points, tris)
    out = point_triangle_launch(points, tris)
    point_triangle_min_d2.launches += 1
    return out


point_triangle_min_d2.launches = 0


def point_triangle_distance(points: torch.Tensor, tris: torch.Tensor) -> torch.Tensor:
    """(P,) unsigned distances: the square root taken outside the kernel."""
    return torch.sqrt(point_triangle_min_d2(points, tris))
