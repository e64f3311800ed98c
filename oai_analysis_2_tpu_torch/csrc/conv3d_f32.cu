// 3x3x3, stride-1, SAME convolution over NDHWC f32 activations with DHWIO
// f32 weights, accumulated in f32 on the CUDA cores (no TF32): the Hopper
// port of the TPU kernel `_kernel` / `conv3d_zstack` in
// oai_analysis_2_tpu/ops/pallas_conv.py:100-243 for the GradICON stage
// UNets, which run in f32.
//
// Contract (conv3d_zstack's): out = cast(relu?(conv(x, w) + bias)), bias,
// ReLU and the one output cast (f32 or bf16) applied to the f32
// accumulator in the epilogue. Any Cin >= 1 and Cout >= 1.
//
// What bounds it on an H100. The GradICON convs do 2*27*Cin*Cout FLOP per
// voxel against 4*(Cin+Cout) bytes: far above the ridge, so the f32 rate
// of the CUDA cores bounds them (67 TFLOP/s, 128 FFMA a clock per SM).
// Reaching it takes an instruction stream that is nearly all FFMA.
//
// Design. An implicit GEMM: M = B*D*H*W voxels, N = Cout, K = 27*Cin in the
// DHWIO order (taps outer, channels inner), walked in steps of BK = 16 K
// columns; a B tile is 16 rows of the (K, Cout) weight matrix. Each thread
// owns an 8 x 8 register tile (8 voxels strided by BM/8, 8 neighbouring
// channels), so 4 K columns cost 8 LDS.128 of A and 8 of B for 256 FFMA. A
// is kept voxel-major with a row pitch of 20 floats (4 times an odd
// number), and a warp is 8 voxels x 4 channel groups of threads (16 x 2 at
// BN = 48, 32 x 1 at BN = 24): an A read touches 8 neighbouring rows in 8
// distinct bank quads, a B read 4 channel groups in 4, each address
// broadcast to the lanes that share it, so both take one shared-memory
// wavefront at BN = 96. The block tile is BM x BN = 12288 outputs
// (192 threads) with BN in {24, 48, 96} chosen by the wrapper
// (`cuda_conv.f32_tile`), so Cout = 24, 48, 96 and 192 compute no masked
// lane. Where that leaves fewer than two blocks per SM the wrapper halves
// BM (96 threads), and where even that leaves SMs short of warps it splits
// K inside the block: KS groups of threads take every KS-th step, and
// their sums meet in shared memory before the epilogue.
//
// Loads are cp.async copies into a ring of 3 stages that overlaps with the
// FFMAs of the stage before. A thread always copies the same K column (or
// 4-column quad) of the same rows, so per step it finds its column's tap
// and channel once, and each row then costs an add of the row stride, one
// bit test of the row's 27-bit mask of in-volume taps (decoded once per
// block) and the copy; no integer division per gathered element. A copy
// whose neighbour lies outside the volume (the SAME halo) or whose column
// lies past K is a zero-fill (src-size 0).
//
// Plain C interface for ctypes: pointers and the stream as void*; returns
// cudaGetLastError() of its launch, or -2 for a tile it was not built for.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NST = 3;  // cp.async ring depth
constexpr int BK = 16;  // K columns per step
constexpr int LDA = BK + 4;

struct Geo {
  int D, H, W, Cin, Cout, K;
  long long M;  // B*D*H*W
};

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src), "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ float lane(const float4& v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

template <int BN, int BM, int KS>
struct Tile {
  static constexpr int MT = BM / 8;  // threads along M
  static constexpr int NT = BN / 8;  // threads along N
  static constexpr int GT = MT * NT;  // threads of one K group
  // a warp is LM x LN threads (8 x 4 where NT allows): its A reads touch
  // LM rows, its B reads LN channel groups
  static constexpr int LN = NT % 4 == 0 ? 4 : NT % 2 == 0 ? 2 : 1;
  static constexpr int LM = 32 / LN;
  static constexpr int WM = MT / LM;  // warps along M
  static constexpr int THREADS = KS * GT;
  static constexpr int A_FLOATS = BM * LDA;
  static constexpr int STAGE_FLOATS = A_FLOATS + BK * BN;
  static constexpr int RING_FLOATS = KS * NST * STAGE_FLOATS;
  static constexpr size_t SMEM = (size_t)RING_FLOATS * 4 + (size_t)BM * 4;
  static_assert(MT % LM == 0, "whole warps along M");
  static_assert(GT % BK == 0 && GT % BN == 0, "each thread copies fixed columns");
  static_assert((KS - 1) * BM * BN <= RING_FLOATS, "the K groups' sums fit in the ring");
  static_assert(SMEM <= 232448, "shared memory of one block");
};

// The ring slots of step s: A (BM rows of LDA floats), then B (BK x BN).
// Copies K columns [s * BK, s * BK + BK) of the implicit A and of w.
template <int BN, int BM, int KS>
__device__ __forceinline__ void load_step(float* As, const float* __restrict__ x,
                                          const float* __restrict__ w, const unsigned* rmask,
                                          const Geo& g, long long m0, int n0, int s, int lt,
                                          int vec_a, int vec_b) {
  using T = Tile<BN, BM, KS>;
  float* Bs = As + T::A_FLOATS;
  const int k0 = s * BK;
  if (vec_a) {
    // quad q = lt % 4 of rows lt / 4 + i * GT / 4
    constexpr int RPP = T::GT / 4;
    const int q = lt % 4, r0 = lt / 4;
    const int k = k0 + 4 * q;
    const bool kok = k < g.K;
    const int tap = kok ? k / g.Cin : 0;
    const int ci = k - tap * g.Cin;
    const long long toff = (long long)((tap / 9 - 1) * g.H + (tap / 3) % 3 - 1) * g.W + tap % 3 - 1;
    const float* src = x + (m0 + r0 + toff) * g.Cin + ci;
    float* dst = As + r0 * LDA + 4 * q;
#pragma unroll
    for (int i = 0; i < (BM + RPP - 1) / RPP; ++i) {
      const int r = r0 + i * RPP;
      if (BM % RPP == 0 || r < BM) {
        const bool ok = kok && ((rmask[r] >> tap) & 1u);
        cp_async16(dst + i * RPP * LDA, ok ? src + (long long)i * RPP * g.Cin : x, ok);
      }
    }
  } else {
    // column c = lt % BK of rows lt / BK + i * GT / BK
    constexpr int RPP = T::GT / BK;
    const int c = lt % BK, r0 = lt / BK;
    const int k = k0 + c;
    const bool kok = k < g.K;
    const int tap = kok ? k / g.Cin : 0;
    const int ci = k - tap * g.Cin;
    const long long toff = (long long)((tap / 9 - 1) * g.H + (tap / 3) % 3 - 1) * g.W + tap % 3 - 1;
    const float* src = x + (m0 + r0 + toff) * g.Cin + ci;
    float* dst = As + r0 * LDA + c;
#pragma unroll 4
    for (int i = 0; i < (BM + RPP - 1) / RPP; ++i) {
      const int r = r0 + i * RPP;
      if (BM % RPP == 0 || r < BM) {
        const bool ok = kok && ((rmask[r] >> tap) & 1u);
        cp_async4(dst + i * RPP * LDA, ok ? src + (long long)i * RPP * g.Cin : x, ok);
      }
    }
  }
  if (vec_b) {
    // quad n4 = lt % (BN / 4) of rows lt / (BN / 4) + i * GT / (BN / 4)
    constexpr int RPP = T::GT / (BN / 4);
    const int n = 4 * (lt % (BN / 4)), kr0 = lt / (BN / 4);
    const bool nok = n0 + n < g.Cout;
#pragma unroll
    for (int i = 0; i < (BK + RPP - 1) / RPP; ++i) {
      const int kr = kr0 + i * RPP;
      if (kr < BK) {
        const bool ok = nok && k0 + kr < g.K;
        cp_async16(Bs + kr * BN + n, ok ? w + (long long)(k0 + kr) * g.Cout + n0 + n : w, ok);
      }
    }
  } else {
    constexpr int RPP = T::GT / BN;
    const int n = lt % BN, kr0 = lt / BN;
    const bool nok = n0 + n < g.Cout;
#pragma unroll
    for (int i = 0; i < BK / RPP; ++i) {
      const int kr = kr0 + i * RPP;
      const bool ok = nok && k0 + kr < g.K;
      cp_async4(Bs + kr * BN + n, ok ? w + (long long)(k0 + kr) * g.Cout + n0 + n : w, ok);
    }
  }
}

template <int BN, int BM, int KS>
__global__ void __launch_bounds__(Tile<BN, BM, KS>::THREADS, 384 / Tile<BN, BM, KS>::THREADS)
    conv3d_f32_ring_kernel(const float* __restrict__ x, const float* __restrict__ w,
                           const float* __restrict__ bias, void* __restrict__ out, Geo g, int relu,
                           int out_bf16, int vec_a, int vec_b, int vec_out, int compute_only) {
  using T = Tile<BN, BM, KS>;
  constexpr int MT = T::MT, GT = T::GT;
  extern __shared__ __align__(16) float smem[];
  unsigned* rmask = reinterpret_cast<unsigned*>(smem + T::RING_FLOATS);

  const int tid = threadIdx.x;
  const int grp = tid / GT, lt = tid % GT;  // K group, thread within it
  const int wp = lt / 32, ln = lt % 32;
  const int tm = (wp % T::WM) * T::LM + ln % T::LM, tn = (wp / T::WM) * T::LN + ln / T::LM;
  const long long m0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;

  // each row's in-volume taps, bit (kz * 3 + ky) * 3 + kx
  for (int r = tid; r < BM; r += T::THREADS) {
    const long long m = m0 + r;
    unsigned mask = 0;
    if (m < g.M) {
      const int xx = (int)(m % g.W);
      const int yy = (int)((m / g.W) % g.H);
      const int zz = (int)((m / ((long long)g.H * g.W)) % g.D);
      const unsigned zm = (zz > 0 ? 1u : 0u) | 2u | (zz < g.D - 1 ? 4u : 0u);
      const unsigned ym = (yy > 0 ? 1u : 0u) | 2u | (yy < g.H - 1 ? 4u : 0u);
      const unsigned xm = (xx > 0 ? 1u : 0u) | 2u | (xx < g.W - 1 ? 4u : 0u);
#pragma unroll
      for (int t = 0; t < 27; ++t)
        if ((zm >> (t / 9)) & (ym >> ((t / 3) % 3)) & (xm >> (t % 3)) & 1u) mask |= 1u << t;
    }
    rmask[r] = mask;
  }
  __syncthreads();

  // group grp takes steps grp, grp + KS, ...: round r is step r * KS + grp
  const int steps = (g.K + BK - 1) / BK;
  const int rounds = (steps + KS - 1) / KS;
  float* ring = smem + grp * NST * T::STAGE_FLOATS;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

#pragma unroll
  for (int r = 0; r < NST - 1; ++r) {
    const int s = r * KS + grp;
    if (r < rounds && s < steps && !compute_only)
      load_step<BN, BM, KS>(ring + r * T::STAGE_FLOATS, x, w, rmask, g, m0, n0, s, lt, vec_a, vec_b);
    cp_async_commit();
  }

  for (int r = 0; r < rounds; ++r) {
    cp_async_wait<NST - 2>();
    __syncthreads();  // round r has landed for every thread; slot (r-1) % NST is free
    const int next = r + NST - 1, s_next = next * KS + grp;
    if (next < rounds && s_next < steps && !compute_only)
      load_step<BN, BM, KS>(ring + (next % NST) * T::STAGE_FLOATS, x, w, rmask, g, m0, n0, s_next, lt,
                            vec_a, vec_b);
    cp_async_commit();
    if (r * KS + grp >= steps) continue;

    const float* As = ring + (r % NST) * T::STAGE_FLOATS + tm * LDA;
    const float* Bs = ring + (r % NST) * T::STAGE_FLOATS + T::A_FLOATS + tn * 8;
#pragma unroll 1
    for (int kk = 0; kk < BK; kk += 4) {
      float4 a[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) a[i] = *reinterpret_cast<const float4*>(As + i * MT * LDA + kk);
#pragma unroll
      for (int k4 = 0; k4 < 4; ++k4) {
        const float4 b0 = *reinterpret_cast<const float4*>(Bs + (kk + k4) * BN);
        const float4 b1 = *reinterpret_cast<const float4*>(Bs + (kk + k4) * BN + 4);
        const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
        // rows in turn, channels forth on even rows and back on odd ones:
        // consecutive FFMAs then share a B operand at each row change
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float av = lane(a[i], k4);
#pragma unroll
          for (int jj = 0; jj < 8; ++jj) {
            const int j = (i & 1) ? 7 - jj : jj;
            acc[i][j] = fmaf(av, bv[j], acc[i][j]);
          }
        }
      }
    }
  }
  cp_async_wait<0>();

  if (KS > 1) {
    // the K groups' partial sums meet in group 0 (the ring is free now)
    __syncthreads();
    if (grp > 0) {
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) smem[((grp - 1) * 64 + i * 8 + j) * GT + lt] = acc[i][j];
    }
    __syncthreads();
    if (grp > 0) return;
    for (int o = 0; o < KS - 1; ++o)
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] += smem[(o * 64 + i * 8 + j) * GT + lt];
  }

  const int nb = n0 + tn * 8;
  float bv[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) bv[j] = (bias && nb + j < g.Cout) ? bias[nb + j] : 0.0f;
  const bool full_n = nb + 8 <= g.Cout;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const long long m = m0 + tm + i * MT;
    if (m >= g.M) continue;
    float v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      v[j] = acc[i][j] + bv[j];
      if (relu) v[j] = fmaxf(v[j], 0.0f);
    }
    const long long o = m * g.Cout + nb;
    if (out_bf16) {
      __nv_bfloat16* p = static_cast<__nv_bfloat16*>(out) + o;
      if (vec_out && full_n) {
        __align__(16) __nv_bfloat16 h[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) h[j] = __float2bfloat16(v[j]);
        *reinterpret_cast<uint4*>(p) = *reinterpret_cast<const uint4*>(h);
      } else {
        for (int j = 0; j < 8; ++j)
          if (nb + j < g.Cout) p[j] = __float2bfloat16(v[j]);
      }
    } else {
      float* p = static_cast<float*>(out) + o;
      if (vec_out && full_n) {
        *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
        *reinterpret_cast<float4*>(p + 4) = make_float4(v[4], v[5], v[6], v[7]);
      } else {
        for (int j = 0; j < 8; ++j)
          if (nb + j < g.Cout) p[j] = v[j];
      }
    }
  }
}

template <int BN, int BM, int KS>
int launch(const float* x, const float* w, const float* bias, void* out, const Geo& g, int relu,
           int out_bf16, int vec_a, int vec_b, int vec_out, int compute_only, cudaStream_t s) {
  using T = Tile<BN, BM, KS>;
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(conv3d_f32_ring_kernel<BN, BM, KS>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)T::SMEM);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  const dim3 grid((unsigned)((g.M + BM - 1) / BM), (unsigned)((g.Cout + BN - 1) / BN));
  conv3d_f32_ring_kernel<BN, BM, KS><<<grid, T::THREADS, T::SMEM, s>>>(x, w, bias, out, g, relu, out_bf16,
                                                                        vec_a, vec_b, vec_out, compute_only);
  return (int)cudaGetLastError();
}

}  // namespace

// bm, bn, ks: the tile the wrapper chose (cuda_conv.f32_tile): bn in {24,
// 48, 96}, bm * bn = 12288 (ks = 1) or 6144 (ks = 1, 2 or 4; 1 or 2 at
// bn = 24). vec_ok: the wrapper's word that every pointer is 16-byte
// aligned. compute_only (a measurement): no copies, the ring's contents
// multiplied as they are, the output written with whatever that gives.
extern "C" int conv3d_f32(const void* x, const void* w, const void* bias, void* out, int B, int D,
                          int H, int W, int Cin, int Cout, int relu, int out_bf16, int bm, int bn,
                          int ks, int vec_ok, int compute_only, void* stream) {
  Geo g;
  g.D = D;
  g.H = H;
  g.W = W;
  g.Cin = Cin;
  g.Cout = Cout;
  g.K = 27 * Cin;
  g.M = (long long)B * D * H * W;
  if (g.M == 0) return 0;
  const auto* xp = static_cast<const float*>(x);
  const auto* wp = static_cast<const float*>(w);
  const auto* bp = static_cast<const float*>(bias);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int va = vec_ok && Cin % 4 == 0, vb = vec_ok && Cout % 4 == 0;
  const int vo = vec_ok && Cout % (out_bf16 ? 8 : 4) == 0;
#define CONV3D_F32_TILE(BN_, BM_, KS_)     \
  if (bn == BN_ && bm == BM_ && ks == KS_) \
    return launch<BN_, BM_, KS_>(xp, wp, bp, out, g, relu, out_bf16, va, vb, vo, compute_only, s);
  CONV3D_F32_TILE(96, 128, 1)
  CONV3D_F32_TILE(96, 64, 1)
  CONV3D_F32_TILE(96, 64, 2)
  CONV3D_F32_TILE(96, 64, 4)
  CONV3D_F32_TILE(48, 256, 1)
  CONV3D_F32_TILE(48, 128, 1)
  CONV3D_F32_TILE(48, 128, 2)
  CONV3D_F32_TILE(48, 128, 4)
  CONV3D_F32_TILE(24, 512, 1)
  CONV3D_F32_TILE(24, 256, 1)
  CONV3D_F32_TILE(24, 256, 2)
#undef CONV3D_F32_TILE
  return -2;
}
