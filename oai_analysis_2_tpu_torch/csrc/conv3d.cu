// 3x3x3, stride-1, SAME convolution over NDHWC activations with DHWIO
// weights: the Hopper port of the TPU kernel `_kernel` /
// `conv3d_zstack` in oai_analysis_2_tpu/ops/pallas_conv.py:100-243.
//
// Contract (conv3d_zstack's): out = cast(relu?(conv(x, w) + bias)), with
// the bias added, the ReLU applied and the single output cast done in the
// epilogue on the f32 accumulator. Two builds:
//   * conv3d_bf16: bf16 operands, f32 accumulation on the tensor cores
//     (wmma 16x16x16), output bf16 or f32;
//   * conv3d_f32: f32 operands, f32 accumulation on the CUDA cores (no
//     TF32), output f32 or bf16 -- the GradICON stage UNets need it.
// Any Cin >= 1 and Cout >= 1: ragged K (27*Cin) and N (Cout) are masked.
//
// Design. An implicit GEMM: M = B*D*H*W output voxels, N = Cout,
// K = 27*Cin in the DHWIO row order (tap-major, then input channel), so a
// weight tile is a plain 2-D tile of the DHWIO array. Each block owns a
// 64-voxel x 64-channel output tile, decodes its voxels' (b, z, y, x) once
// into shared memory, and walks K in chunks: it gathers the input tile
// (each K column is one tap's channel of the voxel's neighbour; the SAME
// halo is a masked load, no padded copy) and the weight tile into shared
// memory, then multiplies from there. The TPU design (kz taps stacked on
// N, ky taps on K, a z halo recomputed) answered Mosaic's (8,128) rule and
// 16 MB of VMEM; none of that applies here.
//
// What bounds it on an H100. The segment UNet's full-resolution convs do
// 2*27*Cin*Cout FLOP per voxel against 2*(Cin+Cout) bytes, far above the
// card's ~295 FLOP/byte bf16 ridge: the tensor cores bound it (989 TFLOP/s
// bf16). This first kernel is single-buffered (load, sync, multiply) and
// uses wmma, not TMA and wgmma, so it reaches a fraction of that; the
// pipelined TMA/wgmma form is later work. The f32 build runs on the CUDA
// cores (67 TFLOP/s peak).
//
// Plain C interface for ctypes: pointers and the stream as void*, each
// function returns cudaGetLastError() of its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int BM = 64;  // output voxels per block
constexpr int BN = 64;  // output channels per block

struct Geo {
  int B, D, H, W, Cin, Cout;
  long long M;  // B*D*H*W
  int K;        // 27*Cin
};

struct RowInfo {
  int b, z, y, x;  // b < 0: row past the end of M
};

__device__ __forceinline__ void decode_rows(const Geo& g, long long m0, RowInfo* rows) {
  for (int r = threadIdx.x; r < BM; r += blockDim.x) {
    const long long m = m0 + r;
    RowInfo ri;
    if (m < g.M) {
      long long t = m;
      ri.x = (int)(t % g.W);
      t /= g.W;
      ri.y = (int)(t % g.H);
      t /= g.H;
      ri.z = (int)(t % g.D);
      ri.b = (int)(t / g.D);
    } else {
      ri.b = -1;
      ri.z = ri.y = ri.x = 0;
    }
    rows[r] = ri;
  }
}

// Offset of input element (row voxel, K column k) and whether it is inside
// the volume: column k = tap * Cin + ci, tap = (kz * 3 + ky) * 3 + kx,
// neighbour = voxel + (kz, ky, kx) - 1 (cross-correlation, SAME padding).
__device__ __forceinline__ long long in_offset(const Geo& g, const RowInfo& ri, int k, bool& ok) {
  const int tap = k / g.Cin;
  const int ci = k - tap * g.Cin;
  const int zz = ri.z + tap / 9 - 1;
  const int yy = ri.y + (tap / 3) % 3 - 1;
  const int xx = ri.x + tap % 3 - 1;
  ok = ri.b >= 0 && k < g.K && (unsigned)zz < (unsigned)g.D && (unsigned)yy < (unsigned)g.H &&
       (unsigned)xx < (unsigned)g.W;
  return ((((long long)ri.b * g.D + zz) * g.H + yy) * g.W + xx) * g.Cin + ci;
}

__device__ __forceinline__ void store_out(void* out, long long idx, float v, int out_bf16) {
  if (out_bf16)
    static_cast<__nv_bfloat16*>(out)[idx] = __float2bfloat16(v);
  else
    static_cast<float*>(out)[idx] = v;
}

// ---- bf16 build: 4 warps, each a 32x32 quarter of the tile as 2x2 wmma
// fragments; VA / VB = elements per global load of the A / B tile (8 when
// Cin / Cout are multiples of 8 and the pointers 16-byte aligned, else 1).
template <int VA, int VB>
__global__ void __launch_bounds__(128) conv3d_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                                                          const __nv_bfloat16* __restrict__ w,
                                                          const float* __restrict__ bias,
                                                          void* __restrict__ out, Geo g, int relu,
                                                          int out_bf16) {
  constexpr int BK = 32;
  constexpr int LDA = BK + 8;
  constexpr int LDB = BN + 8;
  constexpr int LDC = BN + 4;
  __shared__ __align__(128) __nv_bfloat16 As[BM * LDA];
  __shared__ __align__(128) __nv_bfloat16 Bs[BK * LDB];
  __shared__ __align__(128) float Cs[BM * LDC];
  __shared__ RowInfo rows[BM];

  const long long m0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int wm = warp / 2, wn = warp % 2;
  const __nv_bfloat16 zero = __float2bfloat16(0.0f);

  decode_rows(g, m0, rows);
  __syncthreads();

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  for (int k0 = 0; k0 < g.K; k0 += BK) {
    for (int e = tid; e < BM * BK / VA; e += 128) {
      const int r = e / (BK / VA);
      const int kv = (e % (BK / VA)) * VA;
      bool ok;
      const long long off = in_offset(g, rows[r], k0 + kv, ok);
      __nv_bfloat16* dst = &As[r * LDA + kv];
      if (VA == 8) {
        uint4 v = make_uint4(0, 0, 0, 0);
        if (ok) v = *reinterpret_cast<const uint4*>(x + off);
        *reinterpret_cast<uint4*>(dst) = v;
      } else {
        dst[0] = ok ? x[off] : zero;
      }
    }
    for (int e = tid; e < BK * BN / VB; e += 128) {
      const int kr = e / (BN / VB);
      const int nv = (e % (BN / VB)) * VB;
      const int k = k0 + kr, n = n0 + nv;
      const bool ok = k < g.K && n < g.Cout;
      __nv_bfloat16* dst = &Bs[kr * LDB + nv];
      if (VB == 8) {
        uint4 v = make_uint4(0, 0, 0, 0);
        if (ok) v = *reinterpret_cast<const uint4*>(w + (long long)k * g.Cout + n);
        *reinterpret_cast<uint4*>(dst) = v;
      } else {
        dst[0] = ok ? w[(long long)k * g.Cout + n] : zero;
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) wmma::load_matrix_sync(a[i], &As[(wm * 32 + i * 16) * LDA + kk], LDA);
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::load_matrix_sync(b[j], &Bs[kk * LDB + wn * 32 + j * 16], LDB);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(&Cs[(wm * 32 + i * 16) * LDC + wn * 32 + j * 16], acc[i][j], LDC,
                              wmma::mem_row_major);
  __syncthreads();
  for (int e = tid; e < BM * BN; e += 128) {
    const int r = e / BN, c = e % BN;
    const long long m = m0 + r;
    const int n = n0 + c;
    if (m < g.M && n < g.Cout) {
      float v = Cs[r * LDC + c];
      if (bias) v += bias[n];
      if (relu) v = fmaxf(v, 0.0f);
      store_out(out, m * g.Cout + n, v, out_bf16);
    }
  }
}

// ---- f32 build: 256 threads, each a 4x4 block of the 64x64 tile (outer
// products from shared memory, the A tile stored transposed so each
// thread reads its 4 voxels as one float4); VA / VB = 4 or 1.
template <int VA, int VB>
__global__ void __launch_bounds__(256) conv3d_f32_kernel(const float* __restrict__ x,
                                                         const float* __restrict__ w,
                                                         const float* __restrict__ bias,
                                                         void* __restrict__ out, Geo g, int relu,
                                                         int out_bf16) {
  constexpr int BK = 16;
  __shared__ __align__(16) float As[BK][BM + 4];
  __shared__ __align__(16) float Bs[BK][BN + 4];
  __shared__ RowInfo rows[BM];

  const long long m0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;

  decode_rows(g, m0, rows);
  __syncthreads();

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < g.K; k0 += BK) {
    for (int e = tid; e < BM * BK / VA; e += 256) {
      const int r = e / (BK / VA);
      const int kv = (e % (BK / VA)) * VA;
      bool ok;
      const long long off = in_offset(g, rows[r], k0 + kv, ok);
      if (VA == 4) {
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (ok) v = *reinterpret_cast<const float4*>(x + off);
        As[kv + 0][r] = v.x;
        As[kv + 1][r] = v.y;
        As[kv + 2][r] = v.z;
        As[kv + 3][r] = v.w;
      } else {
        As[kv][r] = ok ? x[off] : 0.0f;
      }
    }
    for (int e = tid; e < BK * BN / VB; e += 256) {
      const int kr = e / (BN / VB);
      const int nv = (e % (BN / VB)) * VB;
      const int k = k0 + kr, n = n0 + nv;
      const bool ok = k < g.K && n < g.Cout;
      if (VB == 4) {
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (ok) v = *reinterpret_cast<const float4*>(w + (long long)k * g.Cout + n);
        *reinterpret_cast<float4*>(&Bs[kr][nv]) = v;
      } else {
        Bs[kr][nv] = ok ? w[(long long)k * g.Cout + n] : 0.0f;
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long m = m0 + ty * 4 + i;
    if (m >= g.M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n >= g.Cout) continue;
      float v = acc[i][j];
      if (bias) v += bias[n];
      if (relu) v = fmaxf(v, 0.0f);
      store_out(out, m * g.Cout + n, v, out_bf16);
    }
  }
}

Geo make_geo(int B, int D, int H, int W, int Cin, int Cout) {
  Geo g;
  g.B = B;
  g.D = D;
  g.H = H;
  g.W = W;
  g.Cin = Cin;
  g.Cout = Cout;
  g.M = (long long)B * D * H * W;
  g.K = 27 * Cin;
  return g;
}

dim3 make_grid(const Geo& g) {
  return dim3((unsigned)((g.M + BM - 1) / BM), (unsigned)((g.Cout + BN - 1) / BN));
}

}  // namespace

// vec_ok: the wrapper's word that every pointer is 16-byte aligned.
extern "C" int conv3d_bf16(const void* x, const void* w, const void* bias, void* out, int B, int D,
                           int H, int W, int Cin, int Cout, int relu, int out_bf16, int vec_ok,
                           void* stream) {
  const Geo g = make_geo(B, D, H, W, Cin, Cout);
  if (g.M == 0) return 0;
  const dim3 grid = make_grid(g);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* xp = static_cast<const __nv_bfloat16*>(x);
  const auto* wp = static_cast<const __nv_bfloat16*>(w);
  const auto* bp = static_cast<const float*>(bias);
  const bool va = vec_ok && Cin % 8 == 0, vb = vec_ok && Cout % 8 == 0;
  if (va && vb)
    conv3d_bf16_kernel<8, 8><<<grid, 128, 0, s>>>(xp, wp, bp, out, g, relu, out_bf16);
  else if (va)
    conv3d_bf16_kernel<8, 1><<<grid, 128, 0, s>>>(xp, wp, bp, out, g, relu, out_bf16);
  else if (vb)
    conv3d_bf16_kernel<1, 8><<<grid, 128, 0, s>>>(xp, wp, bp, out, g, relu, out_bf16);
  else
    conv3d_bf16_kernel<1, 1><<<grid, 128, 0, s>>>(xp, wp, bp, out, g, relu, out_bf16);
  return (int)cudaGetLastError();
}

extern "C" int conv3d_f32(const void* x, const void* w, const void* bias, void* out, int B, int D,
                          int H, int W, int Cin, int Cout, int relu, int out_bf16, int vec_ok,
                          void* stream) {
  const Geo g = make_geo(B, D, H, W, Cin, Cout);
  if (g.M == 0) return 0;
  const dim3 grid = make_grid(g);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* xp = static_cast<const float*>(x);
  const auto* wp = static_cast<const float*>(w);
  const auto* bp = static_cast<const float*>(bias);
  const bool va = vec_ok && Cin % 4 == 0, vb = vec_ok && Cout % 4 == 0;
  if (va && vb)
    conv3d_f32_kernel<4, 4><<<grid, 256, 0, s>>>(xp, wp, bp, out, g, relu, out_bf16);
  else if (va)
    conv3d_f32_kernel<4, 1><<<grid, 256, 0, s>>>(xp, wp, bp, out, g, relu, out_bf16);
  else if (vb)
    conv3d_f32_kernel<1, 4><<<grid, 256, 0, s>>>(xp, wp, bp, out, g, relu, out_bf16);
  else
    conv3d_f32_kernel<1, 1><<<grid, 256, 0, s>>>(xp, wp, bp, out, g, relu, out_bf16);
  return (int)cudaGetLastError();
}
