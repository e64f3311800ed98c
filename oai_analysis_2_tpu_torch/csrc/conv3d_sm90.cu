// 3x3x3, stride-1, SAME convolution, bf16 operands, f32 accumulation, for
// Hopper (sm_90a): TMA loads into a ring of shared-memory stages, wgmma on
// two consumer warpgroups, one producer warp, mbarriers between them.
//
// Replaces the TPU kernel `_kernel` / `conv3d_zstack`
// (oai_analysis_2_tpu/ops/pallas_conv.py:100, called at :227) for bf16
// input with Cin % 16 == 0 and Cout % 64 == 0: every conv of the segment
// UNet except the first (Cin = 1), which stays on conv3d.cu's wmma build.
// Contract, conv3d_zstack's: out = cast(relu?(conv(x, w) + bias)), bias,
// ReLU and the one output cast applied to the f32 accumulator. Input NDHWC;
// the weights come re-laid out by the wrapper from DHWIO (3,3,3,Cin,Cout)
// to (27, Cout, Cin), tap-major and K-major, so that a weight tile is the
// K-major B operand of wgmma as it stands.
//
// What bounds it on an H100. A conv does 2*27*Cin*Cout FLOP per voxel
// against 2*(Cin + Cout) bytes of device memory: at the segment UNet's
// full resolution (Cin 32-192, Cout 64) that is 860-2600 FLOP per byte,
// far above the ~295 FLOP/byte bf16 ridge, so the tensor cores (989
// TFLOP/s) bound it. Device memory is not the limit; L2 can be. An
// implicit GEMM that loads the A operand once per tap reads every input
// voxel 27 times from L2, and with N = Cout = 64 that is only 64 FLOP per
// byte of L2 traffic, too little to keep the tensor cores fed.
//
// Design.
//   * Implicit GEMM: M = output voxels, N = Cout, K = 27 taps x Cin. A
//     block owns one z plane, an 8 (y) x BX (x) box of voxels (M = 8 BX)
//     and BN output channels.
//   * A by TMA over a 5-D tensor map of the activation whose dims are, from
//     the innermost, {C, Y, X, Z, B} (y before x: the strides need not
//     grow). The box {BKC, 8, BX + 2, 1, 1} lands in shared memory as rows
//     of BKC channels ordered x-major, 8 rows (one x column of 8 y's) per
//     swizzle atom. One load per (channel chunk, dz, dy) carries the x halo;
//     the three dx taps are the same tile read from an offset of dx whole
//     atoms, so A's L2 traffic is (BX + 2) / (3 BX) of the per-tap scheme
//     (about 2.8x less). TMA zero-fills out-of-range x and y, including
//     negative coordinates: that is the SAME halo, with no padded copy, no
//     masks and no index arithmetic per element. Taps whose z plane is
//     outside the volume are skipped.
//   * B by TMA over the (27, Cout, Cin) weights, box {BKC, BN, 3}: the
//     three dx taps of one (dz, dy) in one load.
//   * One stage = that A box and that B box; a ring of STAGES stages, a
//     full and an empty mbarrier each. The producer warp keeps the ring
//     loaded; each consumer warpgroup runs m64nBNk16 wgmma from shared
//     memory on its 64 x MW rows, keeps one stage's wgmma group in flight
//     and releases the stage before it.
//   * Swizzle: BKC = 64, 32 or 16 channels a chunk (128, 64 or 32 B rows,
//     the matching TMA and wgmma swizzle), so Cin = 32 (enc0b) takes 32-
//     channel chunks and no tap straddles a chunk.
//   * Epilogue from registers: bias, ReLU, one cast, stores masked to the
//     volume (boxes do not divide 416, 208, 104, 52 evenly).
//   * A wait on an mbarrier that does not complete within seconds traps,
//     so a fault in the pipeline ends the kernel with an error instead of
//     hanging the card.
//   * A loads-only build of the same kernel (`loads_only` in the C
//     interface) runs the producer and the ring as they are, while the
//     consumers release each stage as soon as it lands and do no wgmma and
//     no stores. Its time is what the load pipeline alone (L2 to shared
//     memory through TMA, at this ring depth) takes for the call; set
//     beside the full kernel's time it says whether loads or the tensor
//     cores hold the kernel back. It is a measurement, not a route.
//
// Plain C interface for ctypes: pointers and the stream as void*; returns
// cudaGetLastError() of the launch, or -(1000 + CUresult) when a tensor map
// cannot be encoded, or -1 when libcuda has no cuTensorMapEncodeTiled.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kConsumers = 2;                        // consumer warpgroups
constexpr int kThreads = kConsumers * 128 + 32;      // + one producer warp
constexpr int kSmemBudget = 225 * 1024;              // of the 227 KB a block may use

constexpr int round_up(int v, int m) { return (v + m - 1) / m * m; }

template <int BKC_, int BN_, int MW_>
struct Cfg {
  static constexpr int BKC = BKC_;                   // input channels per chunk
  static constexpr int BN = BN_;                     // output channels per block
  static constexpr int MW = MW_;                     // m64 tiles per consumer warpgroup
  static constexpr int SWZ = BKC * 2;                // bytes per shared-memory row
  static constexpr int BM = kConsumers * MW * 64;    // output voxels per block
  static constexpr int BX = BM / 8;                  // x extent of the block's box
  static constexpr int A_BYTES = (BX + 2) * 8 * SWZ; // one (chunk, dz, dy) box, x halo included
  static constexpr int B_BYTES = 3 * BN * SWZ;       // the three dx taps' weights
  static constexpr int A_PAD = round_up(A_BYTES, 1024);
  static constexpr int B_PAD = round_up(B_BYTES, 1024);
  static constexpr int STAGE = A_PAD + B_PAD;
  static constexpr int STAGES = (kSmemBudget - 2048) / STAGE < 4 ? (kSmemBudget - 2048) / STAGE : 4;
  static constexpr int SMEM = 1024 /* alignment slack */ + STAGES * STAGE + 2 * STAGES * 8;
  static_assert(STAGES >= 2, "a stage does not fit twice in shared memory");
  static_assert(SMEM <= 232448, "shared memory");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// Wait until the phase of `bar` with parity `parity` has completed; trap
// after 20 s, which no legitimate wait comes near.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint64_t t0 = 0;
  for (uint32_t spin = 0;; ++spin) {
    uint32_t done;
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if ((spin & 0x3FF) == 0x3FF) {
      const uint64_t now = global_ns();
      if (t0 == 0) t0 = now;
      else if (now - t0 > 20000000000ull) __trap();
    }
  }
}

__device__ __forceinline__ void tma_load_5d(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0, int c1,
                                            int c2, int c3, int c4) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6, %7}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(c4)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// wgmma shared-memory matrix descriptor of a K-major tile with SWZ-byte
// rows and the matching swizzle: 8-row groups SWZ * 8 bytes apart (SBO),
// leading offset unused for swizzled K-major tiles (1 by convention).
template <int SWZ>
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  constexpr uint64_t layout = SWZ == 128 ? 1 : (SWZ == 64 ? 2 : 3);
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>((8 * SWZ) >> 4) << 32) | (layout << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma instructions
template <int R>
__device__ __forceinline__ void fence_regs(float* d) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define F8(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
              "+f"(d[i + 6]), "+f"(d[i + 7])

// D (64 x N, f32, registers) += A (64 x 16, bf16, shared) * B (16 x N, bf16, shared), both K-major
template <int N>
__device__ __forceinline__ void wgmma_bf16(float* d, uint64_t a, uint64_t b);

template <>
__device__ __forceinline__ void wgmma_bf16<64>(float* d, uint64_t a, uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, "
      "%21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : F8(0), F8(8), F8(16), F8(24)
      : "l"(a), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_bf16<128>(float* d, uint64_t a, uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, "
      "%21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, "
      "%59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : F8(0), F8(8), F8(16), F8(24), F8(32), F8(40), F8(48), F8(56)
      : "l"(a), "l"(b), "r"(1));
}

#undef F8

struct Geo {
  int D, H, W, Cin, Cout;
  int tiles_x, n_tiles;
};

template <class C, bool kLoadsOnly>
__global__ void __launch_bounds__(kThreads, 1)
    conv3d_sm90_kernel(const __grid_constant__ CUtensorMap tm_x, const __grid_constant__ CUtensorMap tm_w,
                       const float* __restrict__ bias, void* __restrict__ out, Geo g, int relu, int out_bf16) {
  extern __shared__ uint8_t smem_raw[];
  // swizzled TMA tiles want 1024-byte alignment
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t bars = base + C::STAGES * C::STAGE;  // full[STAGES], then empty[STAGES]

  const int n_tile = blockIdx.x % g.n_tiles;
  const int t = blockIdx.x / g.n_tiles;
  const int x0 = (t % g.tiles_x) * C::BX;
  const int y0 = (t / g.tiles_x) * 8;
  const int n0 = n_tile * C::BN;
  const int z = blockIdx.y;
  const int b = blockIdx.z;
  // taps whose input plane lies outside the volume contribute zero: skipped
  const int dz_lo = z == 0 ? 1 : 0;
  const int dz_hi = z == g.D - 1 ? 1 : 2;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(bars + 8 * s, 1);                                  // the producer's arrive + bytes
      mbar_init(bars + 8 * (C::STAGES + s), kConsumers * 4);       // one arrive per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kConsumers * 4) {
    // ---- producer: one thread keeps the ring loaded
    if (lane == 0) {
      int it = 0;
      for (int c0 = 0; c0 < g.Cin; c0 += C::BKC)
        for (int dz = dz_lo; dz <= dz_hi; ++dz)
          for (int dy = 0; dy < 3; ++dy, ++it) {
            const int slot = it % C::STAGES;
            const uint32_t round = it / C::STAGES;
            const uint32_t full = bars + 8 * slot;
            mbar_wait(bars + 8 * (C::STAGES + slot), (round & 1) ^ 1);
            mbar_arrive_expect_tx(full, C::A_BYTES + C::B_BYTES);
            const uint32_t a_dst = base + slot * C::STAGE;
            tma_load_5d(a_dst, &tm_x, full, c0, y0 + dy - 1, x0 - 1, z + dz - 1, b);
            tma_load_3d(a_dst + C::A_PAD, &tm_w, full, c0, n0, (dz * 3 + dy) * 3);
          }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns rows [wg * MW * 64, (wg + 1) * MW * 64)
  const int wg = warp / 4;
  float acc[C::MW][C::BN / 2];
#pragma unroll
  for (int mi = 0; mi < C::MW; ++mi)
#pragma unroll
    for (int i = 0; i < C::BN / 2; ++i) acc[mi][i] = 0.0f;

  int it = 0;
  int prev_slot = -1;
  for (int c0 = 0; c0 < g.Cin; c0 += C::BKC)
    for (int dz = dz_lo; dz <= dz_hi; ++dz)
      for (int dy = 0; dy < 3; ++dy, ++it) {
        const int slot = it % C::STAGES;
        mbar_wait(bars + 8 * slot, (it / C::STAGES) & 1);
        __syncwarp();  // wgmma is .aligned: the warp leaves the wait together
        if constexpr (kLoadsOnly) {
          if (lane == 0) mbar_arrive(bars + 8 * (C::STAGES + slot));
          continue;
        }
        const uint32_t a_base = base + slot * C::STAGE;
        const uint32_t b_base = a_base + C::A_PAD;
#pragma unroll
        for (int mi = 0; mi < C::MW; ++mi) fence_regs<C::BN / 2>(acc[mi]);
        wgmma_fence();
#pragma unroll
        for (int dx = 0; dx < 3; ++dx)
#pragma unroll
          for (int kk = 0; kk < C::BKC / 16; ++kk) {
            const uint64_t db = smem_desc<C::SWZ>(b_base + dx * C::BN * C::SWZ + kk * 32);
#pragma unroll
            for (int mi = 0; mi < C::MW; ++mi) {
              // output x columns [8 (wg MW + mi), +8) read box columns shifted by dx
              const int col = (wg * C::MW + mi) * 8 + dx;
              const uint64_t da = smem_desc<C::SWZ>(a_base + col * 8 * C::SWZ + kk * 32);
              wgmma_bf16<C::BN>(acc[mi], da, db);
            }
          }
        wgmma_commit();
#pragma unroll
        for (int mi = 0; mi < C::MW; ++mi) fence_regs<C::BN / 2>(acc[mi]);
        if (prev_slot >= 0) {
          wgmma_wait<1>();  // the previous stage's products are done: release it
          if (lane == 0) mbar_arrive(bars + 8 * (C::STAGES + prev_slot));
        }
        prev_slot = slot;
      }
  if constexpr (kLoadsOnly) return;
  wgmma_wait<0>();
#pragma unroll
  for (int mi = 0; mi < C::MW; ++mi) fence_regs<C::BN / 2>(acc[mi]);

  // ---- epilogue from registers. Accumulator layout of m64nNk16: warp w of
  // the warpgroup holds rows 16w + lane/4 (+8); register 4j + 2h + e holds
  // column 8j + 2 (lane % 4) + e of row 16w + lane/4 + 8h. Row r of m64 tile
  // mi is box voxel (x = 8 (wg MW + mi) + r / 8, y = r % 8).
  const int wq = warp % 4;
#pragma unroll
  for (int mi = 0; mi < C::MW; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int x = x0 + (wg * C::MW + mi) * 8 + 2 * wq + h;
      const int y = y0 + lane / 4;
      if (x >= g.W || y >= g.H) continue;
      const long long row = (((long long)b * g.D + z) * g.H + y) * g.W + x;
      const long long o = row * g.Cout + n0 + 2 * (lane % 4);
#pragma unroll
      for (int j = 0; j < C::BN / 8; ++j) {
        float v0 = acc[mi][4 * j + 2 * h];
        float v1 = acc[mi][4 * j + 2 * h + 1];
        if (bias) {
          v0 += bias[n0 + 8 * j + 2 * (lane % 4)];
          v1 += bias[n0 + 8 * j + 2 * (lane % 4) + 1];
        }
        if (relu) {
          v0 = fmaxf(v0, 0.0f);
          v1 = fmaxf(v1, 0.0f);
        }
        if (out_bf16)
          *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(out) + o + 8 * j) =
              __floats2bfloat162_rn(v0, v1);
        else
          *reinterpret_cast<float2*>(static_cast<float*>(out) + o + 8 * j) = make_float2(v0, v1);
      }
    }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the libcuda that the runtime already loaded,
// so this library needs no link-time libcuda
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

CUtensorMapSwizzle swizzle_for(int row_bytes) {
  return row_bytes == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                          : (row_bytes == 64 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_32B);
}

template <class C>
int launch(const void* x, const void* wt, const float* bias, void* out, int B, int D, int H, int W, int Cin,
           int Cout, int relu, int out_bf16, int loads_only, cudaStream_t stream) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return -1;
  const cuuint64_t e = 2;  // bytes per bf16
  const cuuint32_t ones[5] = {1, 1, 1, 1, 1};

  // activation: dims {C, Y, X, Z, B}, box {BKC, 8, BX + 2, 1, 1}
  CUtensorMap tm_x;
  const cuuint64_t x_dims[5] = {(cuuint64_t)Cin, (cuuint64_t)H, (cuuint64_t)W, (cuuint64_t)D, (cuuint64_t)B};
  const cuuint64_t x_strides[4] = {(cuuint64_t)W * Cin * e, (cuuint64_t)Cin * e, (cuuint64_t)H * W * Cin * e,
                                   (cuuint64_t)D * H * W * Cin * e};
  const cuuint32_t x_box[5] = {(cuuint32_t)C::BKC, 8, (cuuint32_t)(C::BX + 2), 1, 1};
  CUresult r = encode(&tm_x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 5, const_cast<void*>(x), x_dims, x_strides, x_box,
                      ones, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle_for(C::SWZ), CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return -(1000 + (int)r);

  // weights (27, Cout, Cin): dims {Cin, Cout, 27}, box {BKC, BN, 3}
  CUtensorMap tm_w;
  const cuuint64_t w_dims[3] = {(cuuint64_t)Cin, (cuuint64_t)Cout, 27};
  const cuuint64_t w_strides[2] = {(cuuint64_t)Cin * e, (cuuint64_t)Cout * Cin * e};
  const cuuint32_t w_box[3] = {(cuuint32_t)C::BKC, (cuuint32_t)C::BN, 3};
  r = encode(&tm_w, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(wt), w_dims, w_strides, w_box, ones,
             CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle_for(C::SWZ), CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return -(1000 + (int)r);

  Geo g;
  g.D = D;
  g.H = H;
  g.W = W;
  g.Cin = Cin;
  g.Cout = Cout;
  g.tiles_x = (W + C::BX - 1) / C::BX;
  g.n_tiles = Cout / C::BN;
  const int tiles_y = (H + 7) / 8;
  const dim3 grid((unsigned)(g.n_tiles * g.tiles_x * tiles_y), (unsigned)D, (unsigned)B);
  auto kernel = loads_only ? conv3d_sm90_kernel<C, true> : conv3d_sm90_kernel<C, false>;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  kernel<<<grid, kThreads, C::SMEM, stream>>>(tm_x, tm_w, bias, out, g, relu, out_bf16);
  return (int)cudaGetLastError();
}

template <int BKC>
int dispatch_n(const void* x, const void* wt, const float* bias, void* out, int B, int D, int H, int W, int Cin,
               int Cout, int relu, int out_bf16, int lo, cudaStream_t s) {
  if (Cout % 128 == 0)
    return launch<Cfg<BKC, 128, 1>>(x, wt, bias, out, B, D, H, W, Cin, Cout, relu, out_bf16, lo, s);
  return launch<Cfg<BKC, 64, 2>>(x, wt, bias, out, B, D, H, W, Cin, Cout, relu, out_bf16, lo, s);
}

}  // namespace

// x (B, D, H, W, Cin) bf16; wt (27, Cout, Cin) bf16; bias (Cout,) f32 or
// null; out (B, D, H, W, Cout) bf16 (out_bf16) or f32. Needs Cin % 16 == 0,
// Cout % 64 == 0 and 16-byte-aligned x and wt (the wrapper checks).
// loads_only != 0 launches the loads-only build: out is left unwritten.
extern "C" int conv3d_sm90(const void* x, const void* wt, const void* bias, void* out, int B, int D, int H, int W,
                           int Cin, int Cout, int relu, int out_bf16, int loads_only, void* stream) {
  if (Cin % 16 != 0 || Cout % 64 != 0) return (int)cudaErrorInvalidValue;
  if ((long long)B * D * H * W == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* bp = static_cast<const float*>(bias);
  if (Cin % 64 == 0) return dispatch_n<64>(x, wt, bp, out, B, D, H, W, Cin, Cout, relu, out_bf16, loads_only, s);
  if (Cin % 32 == 0) return dispatch_n<32>(x, wt, bp, out, B, D, H, W, Cin, Cout, relu, out_bf16, loads_only, s);
  return dispatch_n<16>(x, wt, bp, out, B, D, H, W, Cin, Cout, relu, out_bf16, loads_only, s);
}
