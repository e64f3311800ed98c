// Exact point-to-triangle-mesh squared distance: the Hopper port of the TPU
// kernel `_dist_kernel` in oai_analysis_2_tpu/ops/pallas_kernels.py:34-91
// (launched by `_distance_pallas`, :103-118).
//
// For each point, the minimum over all triangles of the exact squared
// distance: the plane distance when the point's projection falls inside
// the triangle (triple-product signs against the normal, and a normal with
// n.n > 1e-30), else the nearest of the three clamped edge distances, each
// edge's squared length guarded by 1e-30. The square root is taken by the
// wrapper.
//
// What bounds it on an H100. The work is a few dozen f32 operations for
// each of P x T point-triangle pairs against 12 bytes a point and 36 a
// triangle: compute-bound on the CUDA cores (67 TFLOP/s, one warp
// instruction a clock per scheduler). So the design takes every operation
// that does not depend on the point out of the pair loop.
//
// Design. When a tile of 256 triangles is staged in shared memory, each
// triangle becomes a record of 7 float4: vertex a, the edges ab, ac, bc,
// the normal n = ab x ac, the in-plane edge normals m2 = (a - c) x n and
// m3 = (b - a) x n, the reciprocals of the guarded squared edge lengths
// (negated where the pair loop wants them negated), 1 / n.n, and n.n itself
// (-1 for a degenerate normal, whose m2 = m3 = 0). With q = a - p the
// triple products are d2 = ((c-p) x (a-p)).n = q.m2 and
// d3 = ((a-p) x (b-p)).n = q.m3, and d1 = n.n - d2 - d3 (the three sum to
// n.n for any p): the same quantities as the TPU kernel's, in another
// rounding. Each edge's clamped parameter is one multiply with saturation,
// and the inside test picks plane or edge by predication, not a branch: 58
// f32 instructions (85 operations, an FMA counted as 2) a pair.
// Each thread holds 4 points, so every record read from shared memory
// (broadcast: all lanes read the same triangle) serves 4 pairs. Blocks of
// 512 threads: the compiler then keeps the loop in 56 registers, and more
// warps fit on an SM than at 128 threads (72 registers). The
// TPU's sequential grid carried the minimum across triangle tiles in VMEM;
// blocks here run in no order, so the triangle list is split across blocks
// (blockIdx.y) and the splits combine with atomicMin on the float's bit
// pattern, which orders like the value for the non-negative squared
// distances. Built with FMA contraction (the default).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int TP = 512;        // threads per block
constexpr int PPT = 4;         // points per thread
constexpr int BP = TP * PPT;   // points per block
constexpr int TT = 256;        // triangles per shared-memory tile
constexpr int REC = 7;         // float4 per triangle record
constexpr float TINY = 1e-30f;

__device__ __forceinline__ float dot3(float ax, float ay, float az, float bx, float by, float bz) {
  return fmaf(ax, bx, fmaf(ay, by, az * bz));
}

// |u + t w|^2 with t = saturate(u.w * s): the squared distance to an edge
// from u = (edge start - p), w = edge direction, s = -1 / |w|^2 (or
// +1 / |w|^2 with w reversed by the caller's sign of t below)
__device__ __forceinline__ float edge_d2(float ux, float uy, float uz, float wx, float wy, float wz,
                                         float s, float sign) {
  const float t = sign * __saturatef(dot3(ux, uy, uz, wx, wy, wz) * s);
  const float rx = fmaf(t, wx, ux), ry = fmaf(t, wy, uy), rz = fmaf(t, wz, uz);
  return dot3(rx, ry, rz, rx, ry, rz);
}

// d_min >= 0 (the projection falls inside) ? plane : edge, as one select:
// written as a C select, the compiler branches around the edge distances,
// which every lane computes anyway almost always
__device__ __forceinline__ float inside_select(float d_min, float plane, float edge) {
  float out;
  asm("{\n\t.reg .pred p;\n\tsetp.ge.f32 p, %1, 0f00000000;\n\tselp.f32 %0, %2, %3, p;\n\t}"
      : "=f"(out)
      : "f"(d_min), "f"(plane), "f"(edge));
  return out;
}

__global__ void __launch_bounds__(TP)
    point_triangle_min_d2_fma_kernel(const float* __restrict__ pts, const float* __restrict__ tris,
                                     int n_pts, int n_tris, int tris_per_split,
                                     unsigned int* __restrict__ out_bits) {
  __shared__ float4 rec[REC][TT];
  float px[PPT], py[PPT], pz[PPT], best[PPT];
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const int i = blockIdx.x * BP + k * TP + threadIdx.x;
    const bool live = i < n_pts;
    px[k] = live ? pts[3LL * i + 0] : 0.0f;
    py[k] = live ? pts[3LL * i + 1] : 0.0f;
    pz[k] = live ? pts[3LL * i + 2] : 0.0f;
    best[k] = INFINITY;
  }
  const int t_begin = blockIdx.y * tris_per_split;
  const int t_end = min(n_tris, t_begin + tris_per_split);

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
      const float bcx = cx - bx, bcy = cy - by, bcz = cz - bz;
      const float nx = aby * acz - abz * acy;
      const float ny = abz * acx - abx * acz;
      const float nz = abx * acy - aby * acx;
      const float nn = nx * nx + ny * ny + nz * nz;
      const bool flat = !(nn > TINY);
      // m2 = (a - c) x n = n x ac, m3 = (b - a) x n = ab x n; zero when flat
      const float m2x = flat ? 0.0f : ny * acz - nz * acy;
      const float m2y = flat ? 0.0f : nz * acx - nx * acz;
      const float m2z = flat ? 0.0f : nx * acy - ny * acx;
      const float m3x = flat ? 0.0f : aby * nz - abz * ny;
      const float m3y = flat ? 0.0f : abz * nx - abx * nz;
      const float m3z = flat ? 0.0f : abx * ny - aby * nx;
      const float inv_ab = 1.0f / fmaxf(abx * abx + aby * aby + abz * abz, TINY);
      const float inv_bc = 1.0f / fmaxf(bcx * bcx + bcy * bcy + bcz * bcz, TINY);
      const float inv_ca = 1.0f / fmaxf(acx * acx + acy * acy + acz * acz, TINY);
      rec[0][j] = make_float4(ax, ay, az, flat ? -1.0f : nn);
      rec[1][j] = make_float4(nx, ny, nz, flat ? 0.0f : 1.0f / nn);
      rec[2][j] = make_float4(m2x, m2y, m2z, -inv_ab);
      rec[3][j] = make_float4(m3x, m3y, m3z, -inv_bc);
      rec[4][j] = make_float4(abx, aby, abz, inv_ca);
      rec[5][j] = make_float4(acx, acy, acz, 0.0f);
      rec[6][j] = make_float4(bcx, bcy, bcz, 0.0f);
    }
    __syncthreads();
#pragma unroll 1
    for (int j = 0; j < n; ++j) {
      const float4 r0 = rec[0][j], r1 = rec[1][j], r2 = rec[2][j], r3 = rec[3][j];
      const float4 r4 = rec[4][j], r5 = rec[5][j], r6 = rec[6][j];
#pragma unroll
      for (int k = 0; k < PPT; ++k) {
        // q = a - p; the plane distance and the triple products
        const float qx = r0.x - px[k], qy = r0.y - py[k], qz = r0.z - pz[k];
        const float t = dot3(qx, qy, qz, r1.x, r1.y, r1.z);
        const float plane = t * t * r1.w;
        const float d2 = dot3(qx, qy, qz, r2.x, r2.y, r2.z);
        const float d3 = dot3(qx, qy, qz, r3.x, r3.y, r3.z);
        const float d1 = r0.w - d2 - d3;
        // edges: from a along ab (u = a - p), from b along bc (u = b - p),
        // from c back to a (u = c - p, w = ac, t taken with the opposite sign)
        const float e_ab = edge_d2(qx, qy, qz, r4.x, r4.y, r4.z, r2.w, 1.0f);
        const float e_bc = edge_d2(qx + r4.x, qy + r4.y, qz + r4.z, r6.x, r6.y, r6.z, r3.w, 1.0f);
        const float e_ca = edge_d2(qx + r5.x, qy + r5.y, qz + r5.z, r5.x, r5.y, r5.z, r4.w, -1.0f);
        const float edge = fminf(e_ab, fminf(e_bc, e_ca));
        best[k] = fminf(best[k], inside_select(fminf(d1, fminf(d2, d3)), plane, edge));
      }
    }
  }
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const int i = blockIdx.x * BP + k * TP + threadIdx.x;
    if (i < n_pts) atomicMin(out_bits + i, __float_as_uint(best[k]));
  }
}

}  // namespace

// out_bits: n_pts words holding +inf (0x7f800000) on entry; on exit the
// bit patterns of the minimum squared distances. Each block holds BP = 2048
// points; the triangle list is split across as many blocks as fill the
// card's resident block slots once (in whole tiles), so that no second,
// mostly empty wave of blocks follows the first.
extern "C" int point_triangle_min_d2(const void* pts, const void* tris, int n_pts, int n_tris,
                                     void* out_bits, void* stream) {
  if (n_pts == 0 || n_tris == 0) return 0;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, point_triangle_min_d2_fma_kernel, TP, 0);
  if (e != cudaSuccess) return (int)e;
  const int point_blocks = (n_pts + BP - 1) / BP;
  const int n_splits = max(1, sms * per_sm / point_blocks);
  const int per = ((n_tris + n_splits - 1) / n_splits + TT - 1) / TT * TT;
  const int splits = (n_tris + per - 1) / per;
  const dim3 grid((unsigned)point_blocks, (unsigned)splits);
  point_triangle_min_d2_fma_kernel<<<grid, TP, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pts), static_cast<const float*>(tris), n_pts, n_tris, per,
      static_cast<unsigned int*>(out_bits));
  return (int)cudaGetLastError();
}
