// Exact point-to-triangle-mesh squared distance: the first Hopper port of
// the TPU kernel `_dist_kernel` in oai_analysis_2_tpu/ops/pallas_kernels.py
// :34-91 (launched by `_distance_pallas`, :103-118), kept as the "was"
// build that csrc/point_triangle.cu replaced. The pipeline never launches
// it: only the uncounted `cuda_kernels.point_triangle_launch(...,
// build="was")` does, so that a measurement can time it beside its
// successor in the same process.
//
// For each point, the minimum over all triangles of the exact squared
// distance: the plane distance when the point's projection falls inside
// the triangle (triple-product signs against the normal), else the nearest
// of the three clamped edge distances. The per-pair arithmetic is the
// Pallas kernel's, operation for operation, with its 1e-30 guards. The
// square root is taken by the wrapper.
//
// Design. One thread per point, its coordinates and running minimum in
// registers; a block of 128 points streams the triangle list through shared
// memory in tiles of 256, each tile stored structure-of-arrays together
// with the per-triangle quantities every pair would recompute identically
// (normal, squared normal, the three guarded squared edge lengths). The
// TPU's sequential grid carried the minimum across triangle tiles in VMEM;
// blocks here run in no order, so the triangle list is also split across
// blocks (blockIdx.y) and the splits combine with atomicMin on the float's
// bit pattern, which orders like the value for the non-negative squared
// distances. Ragged ends are masked: no 1e8 padding, no bucketing.
//
// What bounds it on an H100. About 150 f32 operations per point-triangle
// pair and a few bytes per point: compute-bound on the CUDA cores (67
// TFLOP/s f32 peak). The split keeps several blocks per SM at production
// mesh sizes (~32k points per side).
//
// Numerics: built with --fmad=false (see ops/cuda_build.py) so each
// multiply and add rounds separately, as in the plain PyTorch version.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int TP = 128;  // points per block (one per thread)
constexpr int TT = 256;  // triangles per shared-memory tile
constexpr float TINY = 1e-30f;

__device__ __forceinline__ float seg_d2(float px, float py, float pz, float ux, float uy, float uz,
                                        float vx, float vy, float vz, float ww) {
  const float wx = vx - ux, wy = vy - uy, wz = vz - uz;
  const float tt =
      fminf(fmaxf(((px - ux) * wx + (py - uy) * wy + (pz - uz) * wz) / ww, 0.0f), 1.0f);
  const float dx = px - (ux + tt * wx);
  const float dy = py - (uy + tt * wy);
  const float dz = pz - (uz + tt * wz);
  return dx * dx + dy * dy + dz * dz;
}

__global__ void __launch_bounds__(TP)
    point_triangle_min_d2_kernel(const float* __restrict__ pts, const float* __restrict__ tris,
                                 int n_pts, int n_tris, int tris_per_split,
                                 unsigned int* __restrict__ out_bits) {
  __shared__ float s[16][TT];
  const int i = blockIdx.x * TP + threadIdx.x;
  const bool live = i < n_pts;
  float px = 0.0f, py = 0.0f, pz = 0.0f;
  if (live) {
    px = pts[3LL * i + 0];
    py = pts[3LL * i + 1];
    pz = pts[3LL * i + 2];
  }
  const int t_begin = blockIdx.y * tris_per_split;
  const int t_end = min(n_tris, t_begin + tris_per_split);
  float best = INFINITY;

  for (int t0 = t_begin; t0 < t_end; t0 += TT) {
    const int n = min(TT, t_end - t0);
    __syncthreads();
    for (int j = threadIdx.x; j < n; j += TP) {
      const float* t = tris + 9LL * (t0 + j);
      const float ax = t[0], ay = t[1], az = t[2];
      const float bx = t[3], by = t[4], bz = t[5];
      const float cx = t[6], cy = t[7], cz = t[8];
      const float abx = bx - ax, aby = by - ay, abz = bz - az;
      const float acx = cx - ax, acy = cy - ay, acz = cz - az;
      const float nx = aby * acz - abz * acy;
      const float ny = abz * acx - abx * acz;
      const float nz = abx * acy - aby * acx;
      const float bcx = cx - bx, bcy = cy - by, bcz = cz - bz;
      const float cax = ax - cx, cay = ay - cy, caz = az - cz;
      s[0][j] = ax;
      s[1][j] = ay;
      s[2][j] = az;
      s[3][j] = bx;
      s[4][j] = by;
      s[5][j] = bz;
      s[6][j] = cx;
      s[7][j] = cy;
      s[8][j] = cz;
      s[9][j] = nx;
      s[10][j] = ny;
      s[11][j] = nz;
      s[12][j] = nx * nx + ny * ny + nz * nz;
      s[13][j] = fmaxf(abx * abx + aby * aby + abz * abz, TINY);
      s[14][j] = fmaxf(bcx * bcx + bcy * bcy + bcz * bcz, TINY);
      s[15][j] = fmaxf(cax * cax + cay * cay + caz * caz, TINY);
    }
    __syncthreads();
    if (!live) continue;
    for (int j = 0; j < n; ++j) {
      const float ax = s[0][j], ay = s[1][j], az = s[2][j];
      const float bx = s[3][j], by = s[4][j], bz = s[5][j];
      const float cx = s[6][j], cy = s[7][j], cz = s[8][j];
      const float nx = s[9][j], ny = s[10][j], nz = s[11][j], nn = s[12][j];

      const float apx = px - ax, apy = py - ay, apz = pz - az;
      const float t = apx * nx + apy * ny + apz * nz;
      const float plane_d2 = (t * t) / fmaxf(nn, TINY);

      const float bpx = bx - px, bpy = by - py, bpz = bz - pz;
      const float cpx = cx - px, cpy = cy - py, cpz = cz - pz;
      const float qx = -apx, qy = -apy, qz = -apz;  // a - p
      const float d1 = (bpy * cpz - bpz * cpy) * nx + (bpz * cpx - bpx * cpz) * ny +
                       (bpx * cpy - bpy * cpx) * nz;
      const float d2 = (cpy * qz - cpz * qy) * nx + (cpz * qx - cpx * qz) * ny +
                       (cpx * qy - cpy * qx) * nz;
      const float d3 = (qy * bpz - qz * bpy) * nx + (qz * bpx - qx * bpz) * ny +
                       (qx * bpy - qy * bpx) * nz;
      const bool inside = (d1 >= 0.0f) && (d2 >= 0.0f) && (d3 >= 0.0f) && (nn > TINY);

      const float edge = fminf(seg_d2(px, py, pz, ax, ay, az, bx, by, bz, s[13][j]),
                               fminf(seg_d2(px, py, pz, bx, by, bz, cx, cy, cz, s[14][j]),
                                     seg_d2(px, py, pz, cx, cy, cz, ax, ay, az, s[15][j])));
      best = fminf(best, inside ? plane_d2 : edge);
    }
  }
  if (live) atomicMin(out_bits + i, __float_as_uint(best));
}

}  // namespace

// out_bits: n_pts words holding +inf (0x7f800000) on entry; on exit the
// bit patterns of the minimum squared distances. n_splits: how many blocks
// share one point tile's triangle list.
extern "C" int point_triangle_min_d2_was(const void* pts, const void* tris, int n_pts, int n_tris,
                                         int n_splits, void* out_bits, void* stream) {
  if (n_pts == 0 || n_tris == 0) return 0;
  if (n_splits < 1) n_splits = 1;
  const int per = ((n_tris + n_splits - 1) / n_splits + TT - 1) / TT * TT;
  const int splits = (n_tris + per - 1) / per;
  const dim3 grid((unsigned)((n_pts + TP - 1) / TP), (unsigned)splits);
  point_triangle_min_d2_kernel<<<grid, TP, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pts), static_cast<const float*>(tris), n_pts, n_tris, per,
      static_cast<unsigned int*>(out_bits));
  return (int)cudaGetLastError();
}
