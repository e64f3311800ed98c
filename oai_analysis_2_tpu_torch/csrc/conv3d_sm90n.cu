// 3x3x3, stride-1, SAME convolution, bf16 operands, f32 accumulation, for
// Hopper (sm_90a), at narrow and ragged channel counts: TMA loads into a
// ring of shared-memory stages, wgmma m64nNk16 with N the output width
// rounded up to 8, two consumer warpgroups, one producer warp, mbarriers
// between them.
//
// Replaces the TPU kernel `_kernel` / `conv3d_zstack`
// (oai_analysis_2_tpu/ops/pallas_conv.py:100, called at :227) for bf16
// input with Cin % 8 == 0 at every shape that conv3d_sm90.cu (Cin % 16 == 0
// and Cout % 64 == 0) and conv3d_cin1.cu (Cin == 1) do not take: the
// GradICON stage convs (Cout 24, 48, 96, 144, 288, and 2 for the first
// conv's data gradient) and the segment UNet's enc0b data gradient
// (64 -> 32). Before it these ran on conv3d.cu's wmma build, which keeps
// only Cin % 8 != 0. Contract, conv3d_zstack's: out = cast(relu?(conv(x, w)
// + bias)), bias, ReLU and the one output cast applied to the f32
// accumulator. Input NDHWC; the weights come re-laid out by the wrapper
// from DHWIO (3,3,3,Cin,Cout) to (27, Cout, Cin), tap-major and K-major,
// the B operand of wgmma as it stands.
//
// What bounds it on an H100. At these widths a conv does 2*27*Cin*Cout
// FLOP per voxel against 2*(Cin + Cout) bytes of device memory, 400-2600
// FLOP per byte above Cout 24: the tensor cores (989 TFLOP/s) bound it,
// and device memory only at Cout 2. What holds a kernel back here is what
// feeds the tensor cores: with N = Cout small, every A byte brought from
// L2 to shared memory serves only N multiply-adds, and wgmma's shared-
// memory reads of A take about as long as its products below N = 64.
//
// Design (conv3d_sm90.cu's structure, generalised in N and K):
//   * Implicit GEMM: M = output voxels, N = Cout, K = 27 taps x Cin. A
//     block owns one z plane, an 8 (y) x BX (x) box of voxels (M = 8 BX,
//     BX = 16 MW for MW m64 tiles per consumer) and BN output channels.
//   * A by TMA over a 5-D tensor map of the activation, dims {C, Y, X, Z,
//     B} from the innermost, box {BKC, 8, BX + 2, 1, 1}: one load per
//     (channel chunk, dz, dy) carries the x halo, and the three dx taps
//     read the same tile from an offset of dx whole swizzle atoms. TMA's
//     zero fill of out-of-range coordinates is the SAME halo (x, y) and,
//     past Cin, the padding of a ragged last chunk: Cin = 24 runs as two
//     16-channel chunks whose channels 24..31 land as zeros, in the
//     activation box and in the weight box alike. Cin % 8 == 0 is what
//     keeps the activation's global strides multiples of 16 bytes, as TMA
//     requires. Taps whose z plane is outside the volume are skipped.
//   * B by TMA over the (27, Cout, Cin) weights, box {BKC, BN, 3}: the
//     three dx taps of one (dz, dy) in one load. Rows past Cout (Cout 2 in
//     an N = 8 tile, the last of Cout 1000's six 192-wide tiles) land as
//     zeros.
//   * N: m64nNk16 for N in {8, 24, 32, 48, 64, 96, 144, 192}. Cout <= 192
//     runs as one n-tile of the smallest N >= Cout; wider Cout splits into
//     equal tiles (288 = 2 x 144). The wrapper (`cuda_conv.sm90n_tile`)
//     chooses N, the n-tiles, BKC (the widest of 64, 32 and 16 channels
//     that pads K by at most 15 %: TMA moves 64- and 128-byte rows faster
//     than 32-byte ones, so Cin 24 and 144 take 32, Cin 288 takes 64) and
//     MW (1 to 3 up to N = 64, 1 or 2 at N = 96, 1 above: the accumulator
//     holds MW * N / 2 of the 168 registers a thread of a 288-thread block
//     may have, and spills above 96), whichever MW takes the fewest waves
//     of one block per SM weighted by the block's work, so that the
//     GradICON stage grids (W = 96, 48, 24) split into whole boxes.
//   * A ring of up to 8 stages (as many as fit in 225 KB), a full and an
//     empty mbarrier each. The producer warp keeps the ring loaded; each
//     consumer warpgroup runs wgmma from shared memory on its 64 x MW rows,
//     keeps one stage's wgmma group in flight and releases the stage
//     before it.
//   * Epilogue from registers: bias, ReLU, one cast; stores masked to the
//     volume and to channels < Cout. Where Cout % 8 == 0 every store is 16
//     bytes (the four lanes that share an output row swap their column
//     pairs with shuffles first); otherwise one element at a time.
//   * A wait on an mbarrier that does not complete within seconds traps,
//     so a fault in the pipeline ends the kernel with an error instead of
//     hanging the card.
//   * Loads only (`loads_only` in the C interface, a run-time flag): the
//     producer and the ring as they are, while the consumers release each
//     stage as soon as it lands and do no wgmma and no stores. Beside the
//     full kernel's time it says whether the loads or the tensor cores hold
//     the kernel back. A measurement, not a route.
//
// Plain C interface for ctypes: pointers and the stream as void*; returns
// cudaGetLastError() of the launch, or -(1000 + CUresult) when a tensor map
// cannot be encoded, -1 when libcuda has no cuTensorMapEncodeTiled, -2 for
// a tile this library was not built for.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kConsumers = 2;                        // consumer warpgroups
constexpr int kThreads = kConsumers * 128 + 32;      // + one producer warp
constexpr int kSmemBudget = 225 * 1024;              // of the 227 KB a block may use
constexpr int kMaxStages = 8;

constexpr int round_up(int v, int m) { return (v + m - 1) / m * m; }

template <int BKC_, int BN_, int MW_>
struct Cfg {
  static constexpr int BKC = BKC_;                   // input channels per chunk
  static constexpr int BN = BN_;                     // output channels per n-tile (wgmma N)
  static constexpr int MW = MW_;                     // m64 tiles per consumer warpgroup
  static constexpr int SWZ = BKC * 2;                // bytes per shared-memory row
  static constexpr int BM = kConsumers * MW * 64;    // output voxels per block
  static constexpr int BX = BM / 8;                  // x extent of the block's box
  static constexpr int A_BYTES = (BX + 2) * 8 * SWZ; // one (chunk, dz, dy) box, x halo included
  static constexpr int B_BYTES = 3 * BN * SWZ;       // the three dx taps' weights
  static constexpr int A_PAD = round_up(A_BYTES, 1024);
  static constexpr int B_PAD = round_up(B_BYTES, 1024);
  static constexpr int STAGE = A_PAD + B_PAD;
  static constexpr int FIT = (kSmemBudget - 2048) / STAGE;
  static constexpr int STAGES = FIT < kMaxStages ? FIT : kMaxStages;
  static constexpr int SMEM = 1024 /* alignment slack */ + STAGES * STAGE + 2 * STAGES * 8;
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

#define F4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])

// D (64 x N, f32, registers) += A (64 x 16, bf16, shared) * B (16 x N, bf16,
// shared), both K-major; one specialisation per N the kernel is built for
template <int N>
__device__ __forceinline__ void wgmma_bf16(float* d, uint64_t a, uint64_t b);

template <>
__device__ __forceinline__ void wgmma_bf16<8>(float* d, uint64_t a, uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3"
      "}, %4, %5, p, 1, 1, 0, 0;\n"
      "}\n"
      : F4(0)
      : "l"(a), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_bf16<24>(float* d, uint64_t a, uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %14, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n24k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11"
      "}, %12, %13, p, 1, 1, 0, 0;\n"
      "}\n"
      : F4(0), F4(4), F4(8)
      : "l"(a), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_bf16<32>(float* d, uint64_t a, uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n"
      "}\n"
      : F4(0), F4(4), F4(8), F4(12)
      : "l"(a), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_bf16<48>(float* d, uint64_t a, uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %26, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, "
      "%21, %22, %23"
      "}, %24, %25, p, 1, 1, 0, 0;\n"
      "}\n"
      : F4(0), F4(4), F4(8), F4(12), F4(16), F4(20)
      : "l"(a), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_bf16<64>(float* d, uint64_t a, uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, "
      "%21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : F4(0), F4(4), F4(8), F4(12), F4(16), F4(20), F4(24), F4(28)
      : "l"(a), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_bf16<96>(float* d, uint64_t a, uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, "
      "%21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47"
      "}, %48, %49, p, 1, 1, 0, 0;\n"
      "}\n"
      : F4(0), F4(4), F4(8), F4(12), F4(16), F4(20), F4(24), F4(28), F4(32), F4(36), F4(40), F4(44)
      : "l"(a), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_bf16<144>(float* d, uint64_t a, uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %74, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n144k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, "
      "%21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, "
      "%59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71"
      "}, %72, %73, p, 1, 1, 0, 0;\n"
      "}\n"
      : F4(0), F4(4), F4(8), F4(12), F4(16), F4(20), F4(24), F4(28), F4(32), F4(36), F4(40), F4(44), 
        F4(48), F4(52), F4(56), F4(60), F4(64), F4(68)
      : "l"(a), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_bf16<192>(float* d, uint64_t a, uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, "
      "%21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, "
      "%59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, "
      "%78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
      "}, %96, %97, p, 1, 1, 0, 0;\n"
      "}\n"
      : F4(0), F4(4), F4(8), F4(12), F4(16), F4(20), F4(24), F4(28), F4(32), F4(36), F4(40), F4(44), 
        F4(48), F4(52), F4(56), F4(60), F4(64), F4(68), F4(72), F4(76), F4(80), F4(84), F4(88), F4(92)
      : "l"(a), "l"(b), "r"(1));
}

#undef F4

struct Geo {
  int D, H, W, Cin, Cout;
  int tiles_x, n_tiles;
};

__device__ __forceinline__ uint32_t pack_bf16(float a, float b) {
  __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<uint32_t*>(&v);
}

// one of four compile-time values by a run-time index, without local memory
__device__ __forceinline__ uint32_t pick4(int i, uint32_t a, uint32_t b, uint32_t c, uint32_t d) {
  return i == 0 ? a : (i == 1 ? b : (i == 2 ? c : d));
}

template <class C>
__global__ void __launch_bounds__(kThreads, 1)
    conv3d_sm90n_kernel(const __grid_constant__ CUtensorMap tm_x, const __grid_constant__ CUtensorMap tm_w,
                        const float* __restrict__ bias, void* __restrict__ out, Geo g, int relu, int out_bf16,
                        int loads_only) {
  constexpr int G = C::BN / 8;  // 8-column groups of the accumulator
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
    // ---- producer: one thread keeps the ring loaded. Both boxes count in
    // full, zero-filled parts included.
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
        if (loads_only) {
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
  if (loads_only) return;
  wgmma_wait<0>();
#pragma unroll
  for (int mi = 0; mi < C::MW; ++mi) fence_regs<C::BN / 2>(acc[mi]);

  // ---- epilogue from registers. Accumulator layout of m64nNk16: warp w of
  // the warpgroup holds rows 16w + lane/4 (+8); register 4j + 2h + e holds
  // column 8j + 2 (lane % 4) + e of row 16w + lane/4 + 8h. Row r of m64 tile
  // mi is box voxel (x = 8 (wg MW + mi) + r / 8, y = r % 8).
  const int q = lane % 4;
#pragma unroll
  for (int j = 0; j < G; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = n0 + 8 * j + 2 * q + e;
      const float bv = (bias != nullptr && c < g.Cout) ? bias[c] : 0.0f;
#pragma unroll
      for (int mi = 0; mi < C::MW; ++mi)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float v = acc[mi][4 * j + 2 * h + e] + bv;
          acc[mi][4 * j + 2 * h + e] = relu ? fmaxf(v, 0.0f) : v;
        }
    }

  const int wq = warp % 4;
  const bool vec = g.Cout % 8 == 0;
#pragma unroll
  for (int mi = 0; mi < C::MW; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int x = x0 + (wg * C::MW + mi) * 8 + 2 * wq + h;
      const int y = y0 + lane / 4;
      const bool inside = x < g.W && y < g.H;
      const long long row = (((long long)b * g.D + z) * g.H + y) * g.W + x;
      // value e of column pair j of this row (0 past the tile)
#define V(j, e) ((j) < G ? acc[mi][4 * (j) + 2 * h + (e)] : 0.0f)
      if (vec && out_bf16) {
        // 16 bytes a store: lane q stores 8-column groups j = 4 t + q, each
        // lane's column pair of group j read from its lane by shuffle (in
        // round r lane q reads lane (q + r) % 4, which sends group
        // 4 t + (its q - r) % 4)
        __nv_bfloat16* o = static_cast<__nv_bfloat16*>(out) + row * g.Cout;
#pragma unroll
        for (int t4 = 0; t4 < (G + 3) / 4; ++t4) {
          uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const uint32_t send = pick4((q - r) & 3, pack_bf16(V(4 * t4, 0), V(4 * t4, 1)),
                                        pack_bf16(V(4 * t4 + 1, 0), V(4 * t4 + 1, 1)),
                                        pack_bf16(V(4 * t4 + 2, 0), V(4 * t4 + 2, 1)),
                                        pack_bf16(V(4 * t4 + 3, 0), V(4 * t4 + 3, 1)));
            const uint32_t got = __shfl_sync(0xffffffffu, send, (lane & ~3) | ((q + r) & 3));
            const int pos = (q + r) & 3;
#pragma unroll
            for (int p = 0; p < 4; ++p) w[p] = pos == p ? got : w[p];
          }
          const int j = 4 * t4 + q;
          const int c = n0 + 8 * j;
          if (inside && j < G && c < g.Cout) *reinterpret_cast<uint4*>(o + c) = make_uint4(w[0], w[1], w[2], w[3]);
        }
      } else if (vec) {
        // 16 bytes a store: lanes q and q ^ 1 swap a column pair, then the
        // even lane stores 4 columns of group jp, the odd lane 4 of jp + 1
        float* o = static_cast<float*>(out) + row * g.Cout;
        const bool odd = q & 1;
#pragma unroll
        for (int jp = 0; jp < G; jp += 2) {
          const float r0 = __shfl_xor_sync(0xffffffffu, odd ? V(jp, 0) : V(jp + 1, 0), 1);
          const float r1 = __shfl_xor_sync(0xffffffffu, odd ? V(jp, 1) : V(jp + 1, 1), 1);
          const int j = odd ? jp + 1 : jp;
          const int c = n0 + 8 * j + 2 * (q & 2);
          const float4 v = odd ? make_float4(r0, r1, V(jp + 1, 0), V(jp + 1, 1))
                               : make_float4(V(jp, 0), V(jp, 1), r0, r1);
          if (inside && j < G && c < g.Cout) *reinterpret_cast<float4*>(o + c) = v;
        }
      } else if (inside) {
        // Cout % 8 != 0: one element a store
#pragma unroll
        for (int j = 0; j < G; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int c = n0 + 8 * j + 2 * q + e;
            if (c >= g.Cout) continue;
            if (out_bf16)
              static_cast<__nv_bfloat16*>(out)[row * g.Cout + c] = __float2bfloat16_rn(acc[mi][4 * j + 2 * h + e]);
            else
              static_cast<float*>(out)[row * g.Cout + c] = acc[mi][4 * j + 2 * h + e];
          }
      }
#undef V
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

struct Args {
  const void* x;
  const void* wt;
  const float* bias;
  void* out;
  int B, D, H, W, Cin, Cout, relu, out_bf16, n_tiles, loads_only;
  cudaStream_t stream;
};

template <class C>
int launch(const Args& a) {
  if constexpr (C::STAGES < 3) {
    return -2;  // a tile the wrapper never chooses: fewer than three stages fit
  } else {
    EncodeTiled encode = encode_tiled();
    if (encode == nullptr) return -1;
    const cuuint64_t e = 2;  // bytes per bf16
    const cuuint32_t ones[5] = {1, 1, 1, 1, 1};

    // activation: dims {C, Y, X, Z, B}, box {BKC, 8, BX + 2, 1, 1}
    CUtensorMap tm_x;
    const cuuint64_t x_dims[5] = {(cuuint64_t)a.Cin, (cuuint64_t)a.H, (cuuint64_t)a.W, (cuuint64_t)a.D,
                                  (cuuint64_t)a.B};
    const cuuint64_t x_strides[4] = {(cuuint64_t)a.W * a.Cin * e, (cuuint64_t)a.Cin * e,
                                     (cuuint64_t)a.H * a.W * a.Cin * e, (cuuint64_t)a.D * a.H * a.W * a.Cin * e};
    const cuuint32_t x_box[5] = {(cuuint32_t)C::BKC, 8, (cuuint32_t)(C::BX + 2), 1, 1};
    CUresult r = encode(&tm_x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 5, const_cast<void*>(a.x), x_dims, x_strides,
                        x_box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle_for(C::SWZ),
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    if (r != CUDA_SUCCESS) return -(1000 + (int)r);

    // weights (27, Cout, Cin): dims {Cin, Cout, 27}, box {BKC, BN, 3}
    CUtensorMap tm_w;
    const cuuint64_t w_dims[3] = {(cuuint64_t)a.Cin, (cuuint64_t)a.Cout, 27};
    const cuuint64_t w_strides[2] = {(cuuint64_t)a.Cin * e, (cuuint64_t)a.Cout * a.Cin * e};
    const cuuint32_t w_box[3] = {(cuuint32_t)C::BKC, (cuuint32_t)C::BN, 3};
    r = encode(&tm_w, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(a.wt), w_dims, w_strides, w_box, ones,
               CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle_for(C::SWZ), CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    if (r != CUDA_SUCCESS) return -(1000 + (int)r);

    Geo g;
    g.D = a.D;
    g.H = a.H;
    g.W = a.W;
    g.Cin = a.Cin;
    g.Cout = a.Cout;
    g.tiles_x = (a.W + C::BX - 1) / C::BX;
    g.n_tiles = a.n_tiles;
    const int tiles_y = (a.H + 7) / 8;
    const dim3 grid((unsigned)(g.n_tiles * g.tiles_x * tiles_y), (unsigned)a.D, (unsigned)a.B);
    auto kernel = conv3d_sm90n_kernel<C>;
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
    kernel<<<grid, kThreads, C::SMEM, a.stream>>>(tm_x, tm_w, a.bias, a.out, g, a.relu, a.out_bf16, a.loads_only);
    return (int)cudaGetLastError();
  }
}

// MW 1-3 up to N = 64, 1-2 at 96, 1 above: the accumulator takes MW * N / 2
// registers a thread, at most 96 of the 168 that a 288-thread block may
// hold without spills
template <int BKC, int BN>
int by_mw(int mw, const Args& a) {
  if (mw == 1) return launch<Cfg<BKC, BN, 1>>(a);
  if constexpr (BN <= 96) {
    if (mw == 2) return launch<Cfg<BKC, BN, 2>>(a);
  }
  if constexpr (BN <= 64) {
    if (mw == 3) return launch<Cfg<BKC, BN, 3>>(a);
  }
  return -2;
}

template <int BKC>
int by_n(int bn, int mw, const Args& a) {
  switch (bn) {
    case 8: return by_mw<BKC, 8>(mw, a);
    case 24: return by_mw<BKC, 24>(mw, a);
    case 32: return by_mw<BKC, 32>(mw, a);
    case 48: return by_mw<BKC, 48>(mw, a);
    case 64: return by_mw<BKC, 64>(mw, a);
    case 96: return by_mw<BKC, 96>(mw, a);
    case 144: return by_mw<BKC, 144>(mw, a);
    case 192: return by_mw<BKC, 192>(mw, a);
    default: return -2;
  }
}

}  // namespace

// x (B, D, H, W, Cin) bf16; wt (27, Cout, Cin) bf16; bias (Cout,) f32 or
// null; out (B, D, H, W, Cout) bf16 (out_bf16) or f32. The tile (bkc input
// channels a chunk, bn output channels an n-tile, n_tiles of them, mw m64
// tiles a consumer) is the wrapper's choice (`cuda_conv.sm90n_tile`). Needs
// Cin % 8 == 0, n_tiles * bn >= Cout and 16-byte-aligned x and wt (the
// wrapper checks). loads_only != 0 runs the load pipeline alone: out is
// left unwritten.
extern "C" int conv3d_sm90n(const void* x, const void* wt, const void* bias, void* out, int B, int D, int H, int W,
                            int Cin, int Cout, int relu, int out_bf16, int bkc, int bn, int n_tiles, int mw,
                            int loads_only, void* stream) {
  if (Cin % 8 != 0 || Cout < 1 || (long long)n_tiles * bn < Cout) return (int)cudaErrorInvalidValue;
  if ((long long)B * D * H * W == 0) return 0;
  const Args a{x, wt, static_cast<const float*>(bias), out, B, D, H, W, Cin, Cout, relu, out_bf16, n_tiles,
               loads_only, static_cast<cudaStream_t>(stream)};
  if (bkc == 64) return by_n<64>(bn, mw, a);
  if (bkc == 32) return by_n<32>(bn, mw, a);
  if (bkc == 16) return by_n<16>(bn, mw, a);
  return -2;
}
