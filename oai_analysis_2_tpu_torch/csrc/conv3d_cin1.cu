// 3x3x3, stride-1, SAME convolution of a one-channel bf16 volume into Cout
// channels (Cout % 8 == 0, Cout <= 64), f32 accumulation on the tensor
// cores, for Hopper (sm_90a): the segment UNet's first conv (enc0a).
//
// Replaces the TPU kernel `_kernel` / `conv3d_zstack`
// (oai_analysis_2_tpu/ops/pallas_conv.py:100, called at :227) for bf16
// input with Cin = 1. Contract, conv3d_zstack's: out = cast(relu?(conv(x, w)
// + bias)), bias, ReLU and the one output cast applied to the f32
// accumulator. Input NDHWC with C = 1; the weights come re-laid out by the
// wrapper from DHWIO (3, 3, 3, 1, Cout) to (32, Cout): the 27 taps in DHWIO
// order, then 5 zero rows.
//
// What bounds it on an H100. With one input channel a voxel reads 2 bytes
// and writes 2 * Cout: enc0a's shape (x 48x416x416x1 -> 32, bf16 out) moves
// 16.6 MB in and 531.6 MB out, 0.164 ms at 3.35 TB/s. Its 14.35 GFLOP are
// 0.0145 ms on the bf16 tensor cores but 0.214 ms as f32 FMA on the CUDA
// cores, more than the bytes bound: the products go to the tensor cores and
// everything else serves the output stores.
//
// Design.
//   * Products by mma.sync m16n8k16 (bf16 x bf16 -> f32): M = 16 voxels of
//     one x-row, K = 27 taps padded to 32 (two k16 steps), N = 8 channels,
//     Cout / 8 n-tiles. At about 1 FLOP per byte the tensor-core rate is
//     nowhere near the limit, so wgmma's 64-row warpgroup tiles, its
//     shared-memory operand layouts and their fences would buy nothing; the
//     per-warp mma.sync keeps every warp independent.
//   * The B fragments (the weights) are loaded into registers once per
//     thread and kept for the whole run; the accumulators start each
//     fragment at the bias.
//   * A tile is TY x-rows of TX voxels of one z plane (TX = W where a row's
//     output fits the staging buffer, else W cut into equal multiples of
//     16, at most 208). Its input box, 3 planes x (TY + 2) rows, lies in
//     shared memory as three copies shifted by one x column each (copy kx
//     holds input column x0 + c + kx - 1 at column c), with the SAME halo
//     as zeros. Then for every 16-voxel fragment, each 8x8 block of A (8
//     voxels x 8 taps) is 8 rows of 16 aligned bytes (one tap's row of 8
//     neighbouring voxels, in the copy of the tap's kx), so one
//     ldmatrix.x4.trans loads an m16k16 A fragment: two per fragment. Taps
//     27-31 read a 16-byte row of zeros. Row pitch and copy spacing are
//     padded (80 and 112 bytes past a multiple of 128) so that at one-row
//     tiles, enc0a's, the 8 rows of every block fall in distinct banks.
//   * How the box arrives: its input rows land in shared memory unshifted,
//     and the block builds the three copies from there. Where a row of x is
//     a multiple of 16 bytes (W % 8 == 0), by TMA:
//     one thread issues one load of the {x, y, z} box through a tensor map
//     of x from x coordinate x0 - 8 (TMA wants a 16-byte-aligned start in
//     the innermost dimension, which is also why TMA cannot write the
//     shifted copies itself), and TMA zero-fills what lies outside the
//     volume, halo included. The landing buffers form a ring of 3, one
//     mbarrier each, and a tile's load is issued two tiles ahead: under
//     the write stream that saturates device memory a read takes
//     microseconds, longer than one tile's products and stores. The build is
//     then 8 columns a thread: one 16-byte read, two 4-byte reads, five
//     funnel shifts, three 16-byte writes. Otherwise by the threads:
//     16-byte cp.async copies of the raw rows into a double-buffered
//     landing zone, one tile ahead, and a build element by element that
//     masks the halo.
//   * The stores decide the time. A tile's output is bias + ReLU + cast
//     (cvt.relu.bf16x2) into a staging buffer in shared memory, written by
//     stmatrix (bf16) and laid out as the output is in device memory, and
//     written out by one thread's asynchronous copy. For bf16 output with
//     Cout = 8, 16, 32 or 64 and TX a multiple of 16 (enc0a's case) that
//     copy is one TMA tensor store of the {Cout, x, y} tile, and the staging
//     tile is in TMA's matching swizzle (32, 64 or 128 bytes), so the 8
//     voxel rows of each stmatrix block meet no bank twice; TMA clips what
//     lies outside the volume. Otherwise it is one `cp.async.bulk` shared ->
//     global copy per x-row of the tile (one for the tile where TX = W):
//     with Cout the full channel extent, each is one contiguous range. The
//     staging buffer is double-buffered: one tile's store runs while the
//     block multiplies the next, and the block waits for a store to have
//     read its buffer only two tiles later.
//   * Persistent blocks of 4 warps, as many as fit on the card at once
//     (four an SM at enc0a's shape, each on half an x-row), walk the tiles,
//     so one block's products overlap the others' stores.
//   * A wait on an mbarrier that does not complete within seconds traps, so
//     a fault in the loads ends the kernel with an error instead of hanging
//     the card.
//   * A stores-only build (`stores_only`) skips the box loads and the
//     products and writes bias + ReLU of zero through the same staging and
//     copies: its time is what the store path alone takes for the call.
//     `general` takes the cp.async landing and the `cp.async.bulk` rows at
//     any shape: its time at enc0a's shape is what the TMA landing and the
//     TMA store gain. Both are measurements, not routes.
//
// Plain C interface for ctypes: pointers and the stream as void*; returns
// cudaGetLastError() of the launch, cudaErrorInvalidValue for a Cout, an
// input or output pointer or a size the kernel does not take, -(1000 + CUresult)
// when the tensor map cannot be encoded, or -1 when libcuda has no
// cuTensorMapEncodeTiled.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kStageBudget = 16 * 1024;  // bytes of one staging buffer (a target)
constexpr int kMaxTX = 208;              // the landing box, TX + 16 wide, within TMA's 256
constexpr int kRing = 3;                 // TMA landing buffers: loads run two tiles ahead

struct Geo {
  int D, H, W;
  int TY, TX;       // tile rows, tile columns
  int TXp;          // staging row pitch in voxels: TX rounded up to 16
  int BP;           // box row pitch in elements
  int copy;         // elements from one kx-shifted copy of the box to the next
  int LW;           // landing row width in elements, a multiple of 8
  int land_bytes;   // one landing buffer, a multiple of 128
  int load_bytes;   // bytes that TMA writes into one landing buffer
  int tiles_x, tiles_y;
  int n_tiles;
  int stage_bytes;  // one staging buffer, a multiple of 1024
  int swz_mask;     // staging swizzle: 16-byte chunk ^= (byte offset >> 7) & swz_mask
  int box_off;      // byte offsets from the 1024-aligned base: the box, the
  int zero_off;     // zero row, the first landing buffer and the mbarriers
  int land_off;
  int bar_off;
  long long numel;  // elements of x
};

struct Tile {
  int b, z, y0, x0, ny, nx;
};

__device__ __forceinline__ Tile tile_at(const Geo& g, int t) {
  Tile tl;
  tl.x0 = (t % g.tiles_x) * g.TX;
  t /= g.tiles_x;
  tl.y0 = (t % g.tiles_y) * g.TY;
  t /= g.tiles_y;
  tl.z = t % g.D;
  tl.b = t / g.D;
  tl.nx = min(g.TX, g.W - tl.x0);
  tl.ny = min(g.TY, g.H - tl.y0);
  return tl;
}

// box row `row` of a tile: whether its input row lies in the volume, and
// the element index of its column x0 - 1
__device__ __forceinline__ bool box_row(const Geo& g, const Tile& tl, int row, long long& start) {
  const int dz = row / (g.TY + 2);
  const int by = row - dz * (g.TY + 2);
  const int gz = tl.z + dz - 1, gy = tl.y0 + by - 1;
  start = (((long long)tl.b * g.D + gz) * g.H + gy) * g.W + tl.x0 - 1;
  return by < tl.ny + 2 && (unsigned)gz < (unsigned)g.D && (unsigned)gy < (unsigned)g.H;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// D (16 x 8, f32) += A (16 x 16, bf16, row) * B (16 x 8, bf16, col)
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// four 8x8 b16 blocks, each stored as 8 rows of 8 (row i's address from
// lane 8 (block) + i), delivered transposed: the m16k16 A fragment when the
// stored rows are taps and their 8 elements neighbouring voxels
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* a, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(addr)
               : "memory");
}

// the accumulator layout of 4 (x4) or 2 (x2) 8x8 blocks to 8 rows of 16
// bytes each, row i of block k at the address of lane 8k + i
__device__ __forceinline__ void stmatrix_x4(uint32_t addr, uint32_t r0, uint32_t r1, uint32_t r2, uint32_t r3) {
  asm volatile("stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1, %2, %3, %4};\n" ::"r"(addr), "r"(r0), "r"(r1),
               "r"(r2), "r"(r3)
               : "memory");
}
__device__ __forceinline__ void stmatrix_x2(uint32_t addr, uint32_t r0, uint32_t r1) {
  asm volatile("stmatrix.sync.aligned.m8n8.x2.shared.b16 [%0], {%1, %2};\n" ::"r"(addr), "r"(r0), "r"(r1) : "memory");
}

// (lo, hi) -> bf16x2 with lo in the low half, ReLU fused when asked
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi, int relu) {
  uint32_t d;
  if (relu)
    asm("cvt.rn.relu.bf16x2.f32 %0, %1, %2;\n" : "=r"(d) : "f"(hi), "f"(lo));
  else
    asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(d) : "f"(hi), "f"(lo));
  return d;
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes) : "memory");
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

__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map, uint32_t src, int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// 16 bytes global -> shared, of which the first src_bytes are read and the
// rest zero-filled
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, uint32_t src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::: "memory"); }

__device__ __forceinline__ void bulk_store(void* dst, uint32_t src, uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(dst), "r"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void bulk_commit() { asm volatile("cp.async.bulk.commit_group;\n" ::: "memory"); }
// wait until at most N committed copy groups still read shared memory
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void bulk_wait_all() { asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory"); }
// this thread's shared-memory writes become visible to the bulk copies
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// TMA: a tile's input rows into landing buffer `land_s`, column c holding
// x = x0 - 8 + c, completing on `bar`; issued by one thread
__device__ __forceinline__ void tma_land(const Geo& g, const CUtensorMap* map, const Tile& tl, uint32_t land_s,
                                         uint32_t bar) {
  mbar_arrive_expect_tx(bar, (uint32_t)g.load_bytes);
  tma_load_4d(land_s, map, bar, tl.x0 - 8, tl.y0 - 1, tl.z - 1, tl.b);
}

// TMA path: the three copies of the box from a landing buffer (zero outside
// the volume already), 8 columns c..c+7 a thread: copy kx column c holds
// landing column c + 7 + kx
__device__ __forceinline__ void build_box_tma(const Geo& g, const uint8_t* land, uint8_t* box) {
  const int nch = g.TXp / 8;
  for (int e = threadIdx.x; e < 3 * (g.TY + 2) * nch; e += kThreads) {
    const int row = e / nch;
    const int c = 8 * (e - row * nch);
    const uint8_t* src = land + 2 * (row * g.LW + c);
    const uint32_t a3 = *reinterpret_cast<const uint32_t*>(src + 12);      // columns c+6, c+7
    const uint4 bq = *reinterpret_cast<const uint4*>(src + 16);            // columns c+8..c+15
    const uint32_t c0 = *reinterpret_cast<const uint32_t*>(src + 32);      // columns c+16, c+17
    const uint32_t s0 = __funnelshift_r(bq.x, bq.y, 16), s1 = __funnelshift_r(bq.y, bq.z, 16),
                   s2 = __funnelshift_r(bq.z, bq.w, 16);
    uint8_t* dst = box + 2 * (row * g.BP + c);
    *reinterpret_cast<uint4*>(dst) = make_uint4(__funnelshift_r(a3, bq.x, 16), s0, s1, s2);
    *reinterpret_cast<uint4*>(dst + 2 * g.copy) = bq;
    *reinterpret_cast<uint4*>(dst + 4 * g.copy) = make_uint4(s0, s1, s2, __funnelshift_r(bq.w, c0, 16));
  }
}

// cp.async: a tile's input rows into landing buffer `land_s`, a warp per
// row: row `row` holds the 16-byte-aligned chunks that cover its columns
// x0 - 1 to x0 + 16 fpr, from the chunk holding column x0 - 1 on; rows
// outside the volume are not copied
__device__ __forceinline__ void land_tile(const Geo& g, const uint16_t* x, const Tile& tl, uint32_t land_s,
                                          int warp, int lane) {
  for (int row = warp; row < 3 * (g.TY + 2); row += kWarps) {
    long long start;
    if (!box_row(g, tl, row, start)) continue;
    for (int ch = lane; ch < g.LW / 8; ch += 32) {
      const long long a = (start & ~7LL) + 8 * ch;  // first element of the chunk
      if (a >= g.numel) break;
      const long long avail = g.numel - a;
      const uint32_t bytes = a < 0 ? 0u : (avail >= 8 ? 16u : (uint32_t)(2 * avail));
      cp_async16(land_s + 2 * (row * g.LW + 8 * ch), a < 0 ? x : x + a, bytes);
    }
  }
}

// cp.async path: the three copies of the box from the landing buffer, a
// warp per row, zero outside the volume (the SAME halo): source column u
// (x = x0 + u - 1) goes to column u - kx of copy kx. Writes left of column
// 0 and right of column width - 1 land in columns that no fragment reads
// (BP >= width + 2).
__device__ __forceinline__ void build_box(const Geo& g, const Tile& tl, const uint16_t* land, uint16_t* box,
                                          int width, int warp, int lane) {
  for (int row = warp; row < 3 * (g.TY + 2); row += kWarps) {
    long long start;
    const bool row_ok = box_row(g, tl, row, start);
    const uint16_t* src = land + row * g.LW + (int)(start - (start & ~7LL));
    uint16_t* dst = box + row * g.BP;
    for (int u = lane; u < width + 2; u += 32) {
      const int gx = tl.x0 + u - 1;
      const uint16_t v = row_ok && (unsigned)gx < (unsigned)g.W ? src[u] : (uint16_t)0;
      dst[u] = v;
      dst[g.copy + u - 1] = v;
      dst[2 * g.copy + u - 2] = v;
    }
  }
}

template <int NT, bool kTmaLoad, bool kTmaStore>
__global__ void __launch_bounds__(kThreads, 3)
    conv3d_cin1_kernel(const __grid_constant__ CUtensorMap tm_x, const __grid_constant__ CUtensorMap tm_out,
                       const uint16_t* __restrict__ x, const uint16_t* __restrict__ w,
                       const float* __restrict__ bias, uint8_t* __restrict__ out, Geo g, int relu, int out_bf16,
                       int stores_only) {
  constexpr int COUT = NT * 8;
  extern __shared__ uint8_t smem_raw[];
  // from a 1024-aligned base (the staging swizzle repeats every 1024 bytes):
  // [staging 0][staging 1][box: copies kx = 0, 1, 2][16 zero bytes]
  // [landing buffers: kRing (TMA) or 2][kRing mbarriers, TMA only]
  const uint32_t raw_s = smem_u32(smem_raw);
  const uint32_t smem_s = (raw_s + 1023u) & ~1023u;
  uint8_t* smem = smem_raw + (smem_s - raw_s);
  const uint32_t zero_s = smem_s + g.zero_off;
  const uint32_t bars = smem_s + g.bar_off;
  const int vbytes = COUT * (out_bf16 ? 2 : 4);

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int gq = lane / 4;  // accumulator row (voxel) group
  const int q = lane % 4;   // thread in group

  if (threadIdx.x < 8) reinterpret_cast<uint16_t*>(smem + g.zero_off)[threadIdx.x] = 0;
  if (kTmaLoad && threadIdx.x == 0) {
    for (int k = 0; k < kRing; ++k) mbar_init(bars + 8 * k, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // B fragments of both k16 steps and every n-tile, and the bias of this
  // thread's accumulator columns, once for the whole run
  uint32_t bf[2][NT][2];
  float bv[NT][2];
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int n = j * 8 + gq;
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const int k = s * 16 + 2 * q;
      bf[s][j][0] = (uint32_t)__ldg(w + k * COUT + n) | ((uint32_t)__ldg(w + (k + 1) * COUT + n) << 16);
      bf[s][j][1] = (uint32_t)__ldg(w + (k + 8) * COUT + n) | ((uint32_t)__ldg(w + (k + 9) * COUT + n) << 16);
    }
    bv[j][0] = bias ? bias[j * 8 + 2 * q] : 0.0f;
    bv[j][1] = bias ? bias[j * 8 + 2 * q + 1] : 0.0f;
  }
  // the row this lane addresses for ldmatrix, relative to a box buffer: tap
  // 16 s + 8 (lane / 16) + lane % 8 (DHWIO order), voxels 8 ((lane / 8) % 2)
  // to + 7 of the fragment
  uint32_t a_row[2];
  bool a_pad[2];
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const int tap = 16 * s + 8 * (lane / 16) + lane % 8;
    const int kz = tap / 9, ky = (tap / 3) % 3, kx = tap % 3;
    a_pad[s] = tap >= 27;
    a_row[s] = smem_s + g.box_off + 2 * (kx * g.copy + (kz * (g.TY + 2) + ky) * g.BP + 8 * ((lane / 8) % 2));
  }
  // this lane's stmatrix row: voxel 8 ((lane / 8) % 2) + lane % 8 of a
  // fragment, 16-byte chunk lane / 16 of a pair of n-tiles
  const int st_voxel = 8 * ((lane / 8) % 2) + lane % 8;
  const int st_chunk = lane / 16;

  Tile tl = tile_at(g, blockIdx.x);
  if (!stores_only) {
    if (kTmaLoad) {
      if (threadIdx.x == 0)
        for (int k = 0; k < kRing - 1; ++k) {
          const int tk = blockIdx.x + k * gridDim.x;
          if (tk < g.n_tiles) tma_land(g, &tm_x, tile_at(g, tk), smem_s + g.land_off + k * g.land_bytes, bars + 8 * k);
        }
    } else if ((int)blockIdx.x < g.n_tiles) {
      land_tile(g, x, tl, smem_s + g.land_off, warp, lane);
    }
  }
  if (!kTmaLoad) cp_async_commit();

  int it = 0;
  for (int t = blockIdx.x; t < g.n_tiles; t += gridDim.x, ++it) {
    const int fpr = (tl.nx + 15) / 16;  // fragments per row
    if (!stores_only) {
      if (kTmaLoad) {
        mbar_wait(bars + 8 * (it % kRing), (it / kRing) & 1);  // this tile's rows have arrived
      } else {
        cp_async_wait_all();  // this tile's rows have landed
      }
    }
    if (threadIdx.x == 0) bulk_wait_read<1>();  // the store of two tiles ago has read this staging buffer
    __syncthreads();  // and every warp is done with the previous tile's box

    const Tile next = tile_at(g, t + gridDim.x);
    if (!stores_only) {
      if (kTmaLoad) {
        build_box_tma(g, smem + g.land_off + (it % kRing) * g.land_bytes, smem + g.box_off);
        // the rows kRing - 1 tiles ahead go into the buffer the previous tile used
        const int ta = t + (kRing - 1) * gridDim.x;
        if (threadIdx.x == 0 && ta < g.n_tiles)
          tma_land(g, &tm_x, tile_at(g, ta), smem_s + g.land_off + ((it + kRing - 1) % kRing) * g.land_bytes,
                   bars + 8 * ((it + kRing - 1) % kRing));
      } else {
        build_box(g, tl, reinterpret_cast<const uint16_t*>(smem + g.land_off + (it & 1) * g.land_bytes),
                  reinterpret_cast<uint16_t*>(smem + g.box_off), fpr * 16, warp, lane);
        // the next tile's rows land while this one is multiplied and stored
        if (t + (int)gridDim.x < g.n_tiles)
          land_tile(g, x, next, smem_s + g.land_off + ((it + 1) & 1) * g.land_bytes, warp, lane);
        cp_async_commit();
      }
      __syncthreads();  // the box is built
    }

    uint8_t* stage = smem + (it & 1) * g.stage_bytes;
    const uint32_t stage_s = smem_s + (it & 1) * g.stage_bytes;
    for (int f = warp; f < tl.ny * fpr; f += kWarps) {
      const int ry = f / fpr;
      const int fx = (f - ry * fpr) * 16;  // the fragment's first voxel in the tile row
      float acc[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        acc[j][0] = acc[j][2] = bv[j][0];
        acc[j][1] = acc[j][3] = bv[j][1];
      }
      if (!stores_only) {
        const uint32_t fo = 2 * (ry * g.BP + fx);
#pragma unroll
        for (int s = 0; s < 2; ++s) {
          uint32_t a[4];
          ldmatrix_x4_trans(a, a_pad[s] ? zero_s : a_row[s] + fo);
#pragma unroll
          for (int j = 0; j < NT; ++j) mma_bf16(acc[j], a, bf[s][j]);
        }
      }
      // epilogue: accumulator register 2h + e of n-tile j is voxel
      // fx + gq + 8h, channel 8j + 2q + e; staging voxel ry TXp + fx + ...
      const int v0 = ry * g.TXp + fx;
      if (out_bf16) {
        // stmatrix blocks (h = 0, j), (h = 1, j), (h = 0, j + 1), (h = 1, j + 1);
        // voxels past nx land in the staging row's pitch and are not stored
        const int off = (v0 + st_voxel) * vbytes;
        const int swz = (off >> 7) & g.swz_mask;
#pragma unroll
        for (int j = 0; j + 1 < NT; j += 2)
          stmatrix_x4(stage_s + off + 16 * ((j + st_chunk) ^ swz), pack_bf16(acc[j][0], acc[j][1], relu),
                      pack_bf16(acc[j][2], acc[j][3], relu), pack_bf16(acc[j + 1][0], acc[j + 1][1], relu),
                      pack_bf16(acc[j + 1][2], acc[j + 1][3], relu));
        if (NT % 2)
          stmatrix_x2(stage_s + off + 16 * ((NT - 1) ^ swz), pack_bf16(acc[NT - 1][0], acc[NT - 1][1], relu),
                      pack_bf16(acc[NT - 1][2], acc[NT - 1][3], relu));
      } else {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float2* dst = reinterpret_cast<float2*>(stage + (v0 + gq + 8 * h) * vbytes);
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            float lo = acc[j][2 * h], hi = acc[j][2 * h + 1];
            if (relu) {
              lo = fmaxf(lo, 0.0f);
              hi = fmaxf(hi, 0.0f);
            }
            dst[j * 4 + q] = make_float2(lo, hi);
          }
        }
      }
    }
    fence_proxy_async();
    __syncthreads();
    if (threadIdx.x == 0) {
      if (kTmaStore) {
        tma_store_4d(&tm_out, stage_s, 0, tl.x0, tl.y0, tl.b * g.D + tl.z);
      } else {
        const long long v = (((long long)tl.b * g.D + tl.z) * g.H + tl.y0) * g.W + tl.x0;
        if (tl.nx == g.W && g.TXp == g.W) {
          bulk_store(out + v * vbytes, stage_s, (uint32_t)(tl.ny * tl.nx * vbytes));
        } else {
          for (int ry = 0; ry < tl.ny; ++ry)
            bulk_store(out + (v + (long long)ry * g.W) * vbytes, stage_s + ry * g.TXp * vbytes,
                       (uint32_t)(tl.nx * vbytes));
        }
      }
      bulk_commit();
    }
    tl = next;
  }
  if (threadIdx.x == 0) bulk_wait_all();
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

constexpr int round_to(int v, int m, int r) { return (v - r + m - 1) / m * m + r; }  // least >= v that is r mod m

template <int NT, bool kTmaLoad, bool kTmaStore>
int launch_kernel(const CUtensorMap& tm_x, const CUtensorMap& tm_out, const void* x, const void* w,
                  const float* bias, void* out, const Geo& g, int smem, int relu, int out_bf16, int stores_only,
                  cudaStream_t stream) {
  auto kernel = conv3d_cin1_kernel<NT, kTmaLoad, kTmaStore>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  int per_sm = 0, dev = 0, sms = 0;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem)) != cudaSuccess ||
      (e = cudaGetDevice(&dev)) != cudaSuccess ||
      (e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)e;
  int blocks = (per_sm > 0 ? per_sm : 1) * sms;
  if (blocks > g.n_tiles) blocks = g.n_tiles;
  kernel<<<(unsigned)blocks, kThreads, smem, stream>>>(tm_x, tm_out, static_cast<const uint16_t*>(x),
                                                       static_cast<const uint16_t*>(w), bias,
                                                       static_cast<uint8_t*>(out), g, relu, out_bf16, stores_only);
  return (int)cudaGetLastError();
}

template <int NT>
int launch(const void* x, const void* w, const float* bias, void* out, int B, int D, int H, int W, int relu,
           int out_bf16, int stores_only, int general, cudaStream_t stream) {
  const int vbytes = NT * 8 * (out_bf16 ? 2 : 4);
  Geo g;
  g.D = D;
  g.H = H;
  g.W = W;
  // whole rows where one fits the staging buffer and kMaxTX, else W cut in
  // equal chunks, each a multiple of 16 voxels
  int chunks = (int)(((long long)W * vbytes + kStageBudget - 1) / kStageBudget);
  if (chunks < (W + kMaxTX - 1) / kMaxTX) chunks = (W + kMaxTX - 1) / kMaxTX;
  g.TX = chunks == 1 ? W : ((W + chunks - 1) / chunks + 15) / 16 * 16;
  g.TXp = (g.TX + 15) / 16 * 16;
  g.TY = kStageBudget / (g.TXp * vbytes);
  g.TY = g.TY < 1 ? 1 : (g.TY > H ? H : g.TY);
  const int rows = 3 * (g.TY + 2);
  const bool tma_load = !general && W % 8 == 0;
  const bool tma_store = !general && out_bf16 && (NT == 1 || NT == 2 || NT == 4 || NT == 8) && g.TX == g.TXp;
  // box pitch 80 bytes past a multiple of 128 and copies 112 past one (the
  // cp.async build wants two slack columns); landing rows cover x0 - 8 to
  // x0 + TXp + 8
  g.BP = round_to(g.TXp + (tma_load ? 0 : 2), 64, 40);
  g.copy = round_to(rows * g.BP, 64, 56);
  g.LW = g.TXp + 16;
  g.load_bytes = rows * g.LW * 2;
  g.land_bytes = (g.load_bytes + 127) / 128 * 128;
  const int tiles_x = (W + g.TX - 1) / g.TX;
  const int tiles_y = (H + g.TY - 1) / g.TY;
  const long long n_tiles = (long long)B * D * tiles_y * tiles_x;
  if (n_tiles >= (1LL << 31) - (1LL << 24)) return (int)cudaErrorInvalidValue;
  g.tiles_x = tiles_x;
  g.tiles_y = tiles_y;
  g.n_tiles = (int)n_tiles;
  g.stage_bytes = (g.TY * g.TXp * vbytes + 1023) / 1024 * 1024;
  g.swz_mask = tma_store ? vbytes / 16 - 1 : 0;
  g.box_off = 2 * g.stage_bytes;
  g.zero_off = g.box_off + (3 * g.copy * 2 + 127) / 128 * 128;
  g.land_off = g.zero_off + 128;
  g.bar_off = g.land_off + (tma_load ? kRing : 2) * g.land_bytes;
  g.numel = (long long)B * D * H * W;
  const int smem = 1024 /* alignment slack */ + g.bar_off + 8 * kRing;

  CUtensorMap tm_x = {}, tm_out = {};
  EncodeTiled encode = (tma_load || tma_store) ? encode_tiled() : nullptr;
  if ((tma_load || tma_store) && encode == nullptr) return -1;
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  if (tma_load) {
    // x as {X, Y, Z, B}; box {LW, TY + 2, 3, 1}; zero fill outside the volume
    const cuuint64_t dims[4] = {(cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)D, (cuuint64_t)B};
    const cuuint64_t strides[3] = {(cuuint64_t)W * 2, (cuuint64_t)H * W * 2, (cuuint64_t)D * H * W * 2};
    const cuuint32_t box[4] = {(cuuint32_t)g.LW, (cuuint32_t)(g.TY + 2), 3, 1};
    const CUresult r = encode(&tm_x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(x), dims, strides, box,
                              ones, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                              CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    if (r != CUDA_SUCCESS) return -(1000 + (int)r);
  }
  if (tma_store) {
    // out as {C, X, Y, B D}; box {Cout, TX, TY, 1} in the swizzle of a
    // Cout * 2-byte row; stores outside the volume are clipped
    const int C = NT * 8;
    const cuuint64_t dims[4] = {(cuuint64_t)C, (cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)B * D};
    const cuuint64_t strides[3] = {(cuuint64_t)C * 2, (cuuint64_t)W * C * 2, (cuuint64_t)H * W * C * 2};
    const cuuint32_t box[4] = {(cuuint32_t)C, (cuuint32_t)g.TX, (cuuint32_t)g.TY, 1};
    const CUtensorMapSwizzle swz = C == 8    ? CU_TENSOR_MAP_SWIZZLE_NONE
                                   : C == 16 ? CU_TENSOR_MAP_SWIZZLE_32B
                                   : C == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                                             : CU_TENSOR_MAP_SWIZZLE_128B;
    const CUresult r = encode(&tm_out, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, out, dims, strides, box, ones,
                              CU_TENSOR_MAP_INTERLEAVE_NONE, swz, CU_TENSOR_MAP_L2_PROMOTION_NONE,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    if (r != CUDA_SUCCESS) return -(1000 + (int)r);
  }
  if (tma_load && tma_store)
    return launch_kernel<NT, true, true>(tm_x, tm_out, x, w, bias, out, g, smem, relu, out_bf16, stores_only, stream);
  if (tma_load)
    return launch_kernel<NT, true, false>(tm_x, tm_out, x, w, bias, out, g, smem, relu, out_bf16, stores_only, stream);
  if (tma_store)
    return launch_kernel<NT, false, true>(tm_x, tm_out, x, w, bias, out, g, smem, relu, out_bf16, stores_only, stream);
  return launch_kernel<NT, false, false>(tm_x, tm_out, x, w, bias, out, g, smem, relu, out_bf16, stores_only, stream);
}

}  // namespace

// x (B, D, H, W, 1) bf16 and out (B, D, H, W, Cout) bf16 (out_bf16) or
// f32, both 16-byte aligned; w (32, Cout) bf16, rows 27-31 zero; bias
// (Cout,) f32 or null. Needs Cout % 8 == 0 and Cout <= 64. stores_only != 0
// launches the stores-only build: out holds relu?(bias), not the conv.
// general != 0 takes the cp.async landing and the bulk row stores whatever
// the shape.
extern "C" int conv3d_cin1(const void* x, const void* w, const void* bias, void* out, int B, int D, int H, int W,
                           int Cout, int relu, int out_bf16, int stores_only, int general, void* stream) {
  if (Cout % 8 != 0 || Cout < 8 || Cout > 64 || reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  if ((long long)B * D * H * W == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* bp = static_cast<const float*>(bias);
  switch (Cout / 8) {
    case 1: return launch<1>(x, w, bp, out, B, D, H, W, relu, out_bf16, stores_only, general, s);
    case 2: return launch<2>(x, w, bp, out, B, D, H, W, relu, out_bf16, stores_only, general, s);
    case 3: return launch<3>(x, w, bp, out, B, D, H, W, relu, out_bf16, stores_only, general, s);
    case 4: return launch<4>(x, w, bp, out, B, D, H, W, relu, out_bf16, stores_only, general, s);
    case 5: return launch<5>(x, w, bp, out, B, D, H, W, relu, out_bf16, stores_only, general, s);
    case 6: return launch<6>(x, w, bp, out, B, D, H, W, relu, out_bf16, stores_only, general, s);
    case 7: return launch<7>(x, w, bp, out, B, D, H, W, relu, out_bf16, stores_only, general, s);
    default: return launch<8>(x, w, bp, out, B, D, H, W, relu, out_bf16, stores_only, general, s);
  }
}
