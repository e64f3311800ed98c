// 3x3x3, stride-1, SAME convolution of a bf16 volume with a few input
// channels (Cin 2-4) into Cout channels (Cout % 8 == 0, and B fragments
// that fit the registers: ceil(27 Cin / 16) * Cout / 8 <= 32, so Cout <= 64
// at Cin 2, <= 40 at Cin 3, <= 32 at Cin 4), f32 accumulation on the tensor
// cores, for Hopper (sm_90a): the GradICON stages' first conv (enc0a, the
// two images in, Cin 2) when the registration network trains in bf16.
//
// Replaces the TPU kernel `_kernel` / `conv3d_zstack`
// (oai_analysis_2_tpu/ops/pallas_conv.py:100, called at :227) for bf16
// input with 2-4 channels. Contract, conv3d_zstack's: out = cast(relu?(
// conv(x, w) + bias)), bias, ReLU and the one output cast applied to the
// f32 accumulator. Input NDHWC; the weights come re-laid out by the wrapper
// from DHWIO (3, 3, 3, Cin, Cout) to (KP, Cout): row k = tap * Cin +
// channel, tap = (kz * 3 + ky) * 3 + kx (the DHWIO order), then zero rows
// up to KP = 16 * ceil(27 Cin / 16).
//
// What bounds it on an H100. A voxel reads 2 Cin bytes and writes 2 Cout
// (bf16 out): the GradICON enc0a shape (x 1x48x96x96x2 -> 24) reads 1.77 MB
// and writes 21.2 MB, 0.0069 ms at 3.35 TB/s; its 1.15 GFLOP are 0.0012 ms
// on the bf16 tensor cores. So bytes bound it, and at that size the launch
// and the card's fill and drain are a large share of any time it takes.
//
// Design: conv3d_cin1.cu's, with K = 27 Cin (tap, channel) columns.
//   * Products by mma.sync m16n8k16 (bf16 x bf16 -> f32): M = 16 voxels of
//     one x-row, K = 27 Cin padded to a multiple of 16 (54 -> 64 at Cin 2:
//     four k16 steps), N = 8 channels, Cout / 8 n-tiles (3 at Cout 24). The
//     B fragments (the weights) are loaded into registers once per thread
//     and kept for the whole run; the accumulators start at the bias.
//   * A tile is TY x-rows of TX voxels of one z plane (TX = W where a row's
//     output fits the staging buffer and TMA's 256-element box, else W cut
//     into equal multiples of 16). TY fills a 16 KB staging buffer, lowered
//     by at most half where that spreads the tile's 16-voxel fragments
//     evenly over the block's 4 warps (enc0a: TX 96, TY 2, 12 fragments,
//     2304 tiles for about 4 blocks an SM).
//   * The input box (3 planes x (TY + 2) rows) lands in shared memory by
//     TMA, where a row of x is a multiple of 16 bytes (W Cin % 8 == 0; 384
//     bytes at enc0a): one thread issues one load of the {x Cin, y, z} box
//     through a tensor map of x viewed as (B, D, H, W Cin), from x column
//     x0 - 8 (TMA wants a 16-byte-aligned innermost start), and TMA
//     zero-fills what lies outside the volume, the SAME halo included. The
//     landing buffers form a ring of 3, one mbarrier each, loads issued two
//     tiles ahead.
//   * The block then splits the interleaved channels into 3 Cin
//     channel-planar copies, one per (kx, channel), copy kx shifted by one
//     x column each (copy (kx, c) holds channel c of input column
//     x0 + u + kx - 1 at column u). Each (tap, channel) column of A is then
//     a 16-byte row of 8 neighbouring voxels in one copy, so one
//     ldmatrix.x4.trans still loads an m16k16 A fragment. A thread builds 8
//     columns of every copy of one row: 16-byte reads of the landing row,
//     byte permutes, 3 Cin 16-byte writes. Row pitch and copy spacing are
//     chosen on the host so that the 8 rows of every ldmatrix block fall in
//     distinct banks. K columns past 27 Cin read a 16-byte row of zeros.
//   * Otherwise (W Cin % 8 != 0) the block builds the same copies straight
//     from device memory, element by element, masking the halo.
//   * A tile's output is bias + ReLU + cast (cvt.relu.bf16x2) into a
//     staging buffer laid out as the output is in device memory (stmatrix
//     for bf16: at Cout 24 the 48-byte voxel rows of each block meet no bank
//     twice), written out by one thread's `cp.async.bulk` copy per tile
//     (one contiguous range where TX = W) or per x-row. The staging buffer
//     is double-buffered: one tile's store runs while the block multiplies
//     the next.
//   * Persistent blocks of 4 warps, as many as fit on the card at once,
//     walk the tiles.
//   * A wait on an mbarrier that does not complete within seconds traps, so
//     a fault in the loads ends the kernel with an error instead of hanging
//     the card.
//
// The helpers are copies of conv3d_cin1.cu's, not a shared header: the
// build's hash covers each source file alone.
//
// Plain C interface for ctypes: pointers and the stream as void*; returns
// cudaGetLastError() of the launch, cudaErrorInvalidValue for a Cin, a Cout,
// an input or output pointer or a size the kernel does not take,
// -(1000 + CUresult) when the tensor map cannot be encoded, or -1 when
// libcuda has no cuTensorMapEncodeTiled.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kStageBudget = 16 * 1024;  // bytes of one staging buffer (a target)
constexpr int kRing = 3;                 // TMA landing buffers: loads run two tiles ahead

__host__ __device__ constexpr int k_steps(int cin) { return (27 * cin + 15) / 16; }

struct Geo {
  int D, H, W;
  int TY, TX;       // tile rows, tile columns
  int TXp;          // staging row pitch in voxels: TX rounded up to 16
  int BP;           // box row pitch in elements, a multiple of 8
  int copy;         // elements from one (kx, channel) copy of the box to the next, a multiple of 8
  int LWC;          // landing row in elements: TXp + 16 voxels of Cin channels
  int land_bytes;   // one landing buffer, a multiple of 128
  int load_bytes;   // bytes that TMA writes into one landing buffer
  int tiles_x, tiles_y;
  int n_tiles;
  int stage_bytes;  // one staging buffer, a multiple of 128
  int box_off;      // byte offsets from the 128-aligned base: the box, the
  int zero_off;     // zero row, the first landing buffer and the mbarriers
  int land_off;
  int bar_off;
  int tma;          // 1: the box lands by TMA; 0: it is built from device memory
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
// the voxel index of its column x0 - 1
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
// stored rows are K columns and their 8 elements neighbouring voxels
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

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

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

// TMA: a tile's input rows into landing buffer `land_s`, element e of a
// row holding channel e % Cin of x column x0 - 8 + e / Cin, completing on
// `bar`; issued by one thread
template <int CIN>
__device__ __forceinline__ void tma_land(const Geo& g, const CUtensorMap* map, const Tile& tl, uint32_t land_s,
                                         uint32_t bar) {
  mbar_arrive_expect_tx(bar, (uint32_t)g.load_bytes);
  tma_load_4d(land_s, map, bar, (tl.x0 - 8) * CIN, tl.y0 - 1, tl.z - 1, tl.b);
}

// bf16 element e (low half of the word for even e) of a run of words
__device__ __forceinline__ uint32_t pair_of(const uint32_t* wd, int e0, int e1) {
  return __byte_perm(wd[e0 / 2], wd[e1 / 2], (e0 % 2 ? 0x0032 : 0x0010) | (e1 % 2 ? 0x7600 : 0x5400));
}

// TMA path: the 3 Cin copies of the box from a landing buffer (zero outside
// the volume already). A thread builds columns c..c+7 of every copy of one
// row: copy (kx, ch) column u holds landing voxel u + kx + 7, so it reads
// landing voxels c + 7 to c + 16, as the 16-byte chunks from element
// c Cin + E0 on, and writes 3 Cin rows of 8 columns.
template <int CIN>
__device__ __forceinline__ void build_box_tma(const Geo& g, const uint8_t* land, uint8_t* box) {
  constexpr int E0 = (7 * CIN) / 8 * 8;
  constexpr int NQ = ((17 * CIN + 7) / 8 * 8 - E0) / 8;
  const int nch = g.TXp / 8;
  for (int e = threadIdx.x; e < 3 * (g.TY + 2) * nch; e += kThreads) {
    const int row = e / nch;
    const int c = 8 * (e - row * nch);
    const uint4* src = reinterpret_cast<const uint4*>(land + 2 * (row * g.LWC + c * CIN + E0));
    uint32_t wd[4 * NQ];
#pragma unroll
    for (int i = 0; i < NQ; ++i) {
      const uint4 v = src[i];
      wd[4 * i] = v.x;
      wd[4 * i + 1] = v.y;
      wd[4 * i + 2] = v.z;
      wd[4 * i + 3] = v.w;
    }
    uint8_t* dst = box + 2 * (row * g.BP + c);
#pragma unroll
    for (int kx = 0; kx < 3; ++kx) {
#pragma unroll
      for (int ch = 0; ch < CIN; ++ch) {
        uint32_t o[4];
#pragma unroll
        for (int p = 0; p < 4; ++p) {
          const int e0 = (7 + kx + 2 * p) * CIN + ch - E0;  // element of column c + 2p
          o[p] = pair_of(wd, e0, e0 + CIN);
        }
        *reinterpret_cast<uint4*>(dst + 2 * (kx * CIN + ch) * g.copy) = make_uint4(o[0], o[1], o[2], o[3]);
      }
    }
  }
}

// device-memory path: the same copies straight from x, zero outside the
// volume (the SAME halo): columns c..c+7 of one row read input columns
// x0 + c - 1 to x0 + c + 8
template <int CIN>
__device__ __forceinline__ void build_box_global(const Geo& g, const Tile& tl, const uint16_t* x, uint8_t* box) {
  const int nch = g.TXp / 8;
  for (int e = threadIdx.x; e < 3 * (g.TY + 2) * nch; e += kThreads) {
    const int row = e / nch;
    const int c = 8 * (e - row * nch);
    long long start;
    const bool row_ok = box_row(g, tl, row, start);
    uint32_t v[10 * CIN];
#pragma unroll
    for (int i = 0; i < 10; ++i) {
      const int gx = tl.x0 + c + i - 1;
      const bool ok = row_ok && (unsigned)gx < (unsigned)g.W;
#pragma unroll
      for (int ch = 0; ch < CIN; ++ch) v[i * CIN + ch] = ok ? (uint32_t)__ldg(x + (start + c + i) * CIN + ch) : 0u;
    }
    uint8_t* dst = box + 2 * (row * g.BP + c);
#pragma unroll
    for (int kx = 0; kx < 3; ++kx) {
#pragma unroll
      for (int ch = 0; ch < CIN; ++ch) {
        uint32_t o[4];
#pragma unroll
        for (int p = 0; p < 4; ++p) o[p] = v[(kx + 2 * p) * CIN + ch] | (v[(kx + 2 * p + 1) * CIN + ch] << 16);
        *reinterpret_cast<uint4*>(dst + 2 * (kx * CIN + ch) * g.copy) = make_uint4(o[0], o[1], o[2], o[3]);
      }
    }
  }
}

template <int CIN, int NT>
__global__ void __launch_bounds__(kThreads, 3)
    conv3d_cinsmall_kernel(const __grid_constant__ CUtensorMap tm_x, const uint16_t* __restrict__ x,
                           const uint16_t* __restrict__ w, const float* __restrict__ bias,
                           uint8_t* __restrict__ out, Geo g, int relu, int out_bf16) {
  constexpr int COUT = NT * 8;
  constexpr int KS = k_steps(CIN);
  extern __shared__ uint8_t smem_raw[];
  // from a 128-aligned base: [staging 0][staging 1][box: 3 Cin copies]
  // [16 zero bytes][landing buffers, kRing][kRing mbarriers] (TMA only for
  // the last two)
  const uint32_t raw_s = smem_u32(smem_raw);
  const uint32_t smem_s = (raw_s + 127u) & ~127u;
  uint8_t* smem = smem_raw + (smem_s - raw_s);
  const uint32_t zero_s = smem_s + g.zero_off;
  const uint32_t bars = smem_s + g.bar_off;
  const int vbytes = COUT * (out_bf16 ? 2 : 4);

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int gq = lane / 4;  // accumulator row (voxel) group
  const int q = lane % 4;   // thread in group

  if (threadIdx.x < 8) reinterpret_cast<uint16_t*>(smem + g.zero_off)[threadIdx.x] = 0;
  if (g.tma && threadIdx.x == 0) {
    for (int k = 0; k < kRing; ++k) mbar_init(bars + 8 * k, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // B fragments of every k16 step and n-tile, and the bias of this
  // thread's accumulator columns, once for the whole run
  uint32_t bf[KS][NT][2];
  float bv[NT][2];
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int n = j * 8 + gq;
#pragma unroll
    for (int s = 0; s < KS; ++s) {
      const int k = s * 16 + 2 * q;
      bf[s][j][0] = (uint32_t)__ldg(w + k * COUT + n) | ((uint32_t)__ldg(w + (k + 1) * COUT + n) << 16);
      bf[s][j][1] = (uint32_t)__ldg(w + (k + 8) * COUT + n) | ((uint32_t)__ldg(w + (k + 9) * COUT + n) << 16);
    }
    bv[j][0] = bias ? bias[j * 8 + 2 * q] : 0.0f;
    bv[j][1] = bias ? bias[j * 8 + 2 * q + 1] : 0.0f;
  }
  // the row this lane addresses for ldmatrix, relative to the box: K column
  // k = 16 s + 8 (lane / 16) + lane % 8, i.e. (tap k / Cin, channel k % Cin),
  // voxels 8 ((lane / 8) % 2) to + 7 of the fragment
  uint32_t a_row[KS];
  bool a_pad[KS];
#pragma unroll
  for (int s = 0; s < KS; ++s) {
    const int k = 16 * s + 8 * (lane / 16) + lane % 8;
    const int tap = k / CIN, ch = k % CIN;
    const int kz = tap / 9, ky = (tap / 3) % 3, kx = tap % 3;
    a_pad[s] = k >= 27 * CIN;
    a_row[s] = smem_s + g.box_off +
               2 * ((kx * CIN + ch) * g.copy + (kz * (g.TY + 2) + ky) * g.BP + 8 * ((lane / 8) % 2));
  }
  // this lane's stmatrix row: voxel 8 ((lane / 8) % 2) + lane % 8 of a
  // fragment, 16-byte chunk lane / 16 of a pair of n-tiles
  const int st_voxel = 8 * ((lane / 8) % 2) + lane % 8;
  const int st_chunk = lane / 16;

  Tile tl = tile_at(g, blockIdx.x);
  if (g.tma && threadIdx.x == 0)
    for (int k = 0; k < kRing - 1; ++k) {
      const int tk = blockIdx.x + k * gridDim.x;
      if (tk < g.n_tiles)
        tma_land<CIN>(g, &tm_x, tile_at(g, tk), smem_s + g.land_off + k * g.land_bytes, bars + 8 * k);
    }

  int it = 0;
  for (int t = blockIdx.x; t < g.n_tiles; t += gridDim.x, ++it) {
    const int fpr = (tl.nx + 15) / 16;  // fragments per row
    if (g.tma) mbar_wait(bars + 8 * (it % kRing), (it / kRing) & 1);  // this tile's rows have arrived
    if (threadIdx.x == 0) bulk_wait_read<1>();  // the store of two tiles ago has read this staging buffer
    __syncthreads();  // and every warp is done with the previous tile's box

    if (g.tma) {
      build_box_tma<CIN>(g, smem + g.land_off + (it % kRing) * g.land_bytes, smem + g.box_off);
      // the rows kRing - 1 tiles ahead go into the buffer the previous tile used
      const int ta = t + (kRing - 1) * gridDim.x;
      if (threadIdx.x == 0 && ta < g.n_tiles)
        tma_land<CIN>(g, &tm_x, tile_at(g, ta), smem_s + g.land_off + ((it + kRing - 1) % kRing) * g.land_bytes,
                      bars + 8 * ((it + kRing - 1) % kRing));
    } else {
      build_box_global<CIN>(g, tl, x, smem + g.box_off);
    }
    __syncthreads();  // the box is built

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
      const uint32_t fo = 2 * (ry * g.BP + fx);
#pragma unroll
      for (int s = 0; s < KS; ++s) {
        uint32_t a[4];
        ldmatrix_x4_trans(a, a_pad[s] ? zero_s : a_row[s] + fo);
#pragma unroll
        for (int j = 0; j < NT; ++j) mma_bf16(acc[j], a, bf[s][j]);
      }
      // epilogue: accumulator register 2h + e of n-tile j is voxel
      // fx + gq + 8h, channel 8j + 2q + e; staging voxel ry TXp + fx + ...
      const int v0 = ry * g.TXp + fx;
      if (out_bf16) {
        // stmatrix blocks (h = 0, j), (h = 1, j), (h = 0, j + 1), (h = 1, j + 1);
        // voxels past nx land in the staging row's pitch and are not stored
        const int off = (v0 + st_voxel) * vbytes;
#pragma unroll
        for (int j = 0; j + 1 < NT; j += 2)
          stmatrix_x4(stage_s + off + 16 * (j + st_chunk), pack_bf16(acc[j][0], acc[j][1], relu),
                      pack_bf16(acc[j][2], acc[j][3], relu), pack_bf16(acc[j + 1][0], acc[j + 1][1], relu),
                      pack_bf16(acc[j + 1][2], acc[j + 1][3], relu));
        if (NT % 2)
          stmatrix_x2(stage_s + off + 16 * (NT - 1), pack_bf16(acc[NT - 1][0], acc[NT - 1][1], relu),
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
      const long long v = (((long long)tl.b * g.D + tl.z) * g.H + tl.y0) * g.W + tl.x0;
      if (tl.nx == g.W && g.TXp == g.W) {
        bulk_store(out + v * vbytes, stage_s, (uint32_t)(tl.ny * tl.nx * vbytes));
      } else {
        for (int ry = 0; ry < tl.ny; ++ry)
          bulk_store(out + (v + (long long)ry * g.W) * vbytes, stage_s + ry * g.TXp * vbytes,
                     (uint32_t)(tl.nx * vbytes));
      }
      bulk_commit();
    }
    tl = tile_at(g, t + gridDim.x);
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

// Bank conflicts of the A loads for a box row pitch `bp` and copy spacing
// `cp` (elements, multiples of 8): for every ldmatrix block (k16 step s,
// half h: 8 K columns), the most of its 8 rows that share a 16-byte bank
// group (row address / 16 mod 8), summed over the blocks; 2 (KS) is none.
// A shift common to all rows (the fragment's voxel offset) changes nothing.
int box_conflicts(int cin, int ty, int bp, int cp) {
  int sum = 0;
  for (int s = 0; s < k_steps(cin); ++s)
    for (int h = 0; h < 2; ++h) {
      int seen[8] = {0, 0, 0, 0, 0, 0, 0, 0}, worst = 0;
      for (int i = 0; i < 8; ++i) {
        const int k = 16 * s + 8 * h + i;
        if (k >= 27 * cin) continue;  // the zero row
        const int tap = k / cin, ch = k % cin;
        const int kz = tap / 9, ky = (tap / 3) % 3, kx = tap % 3;
        const long long unit = ((long long)(kx * cin + ch) * cp + (long long)(kz * (ty + 2) + ky) * bp) / 8;
        const int n = ++seen[unit % 8];
        if (n > worst) worst = n;
      }
      sum += worst;
    }
  return sum;
}

// The block's geometry at TY = `ty` rows a tile (TX, TXp set): the tiles,
// the landing boxes, the box copies' pitch and spacing and the shared
// memory offsets. Returns the shared memory a block takes; n_tiles -1
// where the tiles exceed the index range.
template <int CIN>
int layout(Geo& g, int ty, int B, int vbytes) {
  g.TY = ty;
  const int rows = 3 * (g.TY + 2);
  g.tma = (int)(((long long)g.W * CIN) % 8 == 0);
  g.LWC = (g.TXp + 16) * CIN;
  g.load_bytes = rows * g.LWC * 2;
  g.land_bytes = (g.load_bytes + 127) / 128 * 128;
  g.tiles_x = (g.W + g.TX - 1) / g.TX;
  g.tiles_y = (g.H + g.TY - 1) / g.TY;
  const long long n_tiles = (long long)B * g.D * g.tiles_y * g.tiles_x;
  g.n_tiles = n_tiles >= (1LL << 31) - (1LL << 24) ? -1 : (int)n_tiles;
  g.stage_bytes = (g.TY * g.TXp * vbytes + 127) / 128 * 128;
  // row pitch and copy spacing: of the residues mod 64 elements, those with
  // the fewest bank conflicts, then the smallest box
  int best_score = -1;
  for (int rb = 0; rb < 64; rb += 8)
    for (int rc = 0; rc < 64; rc += 8) {
      const int bp = round_to(g.TXp, 64, rb);
      const int cp = round_to(rows * bp, 64, rc);
      const int score = box_conflicts(CIN, g.TY, bp, cp) * (1 << 20) + cp / 8;
      if (best_score < 0 || score < best_score) {
        best_score = score;
        g.BP = bp;
        g.copy = cp;
      }
    }
  g.box_off = 2 * g.stage_bytes;
  g.zero_off = g.box_off + (3 * CIN * g.copy * 2 + 127) / 128 * 128;
  g.land_off = g.zero_off + 128;
  g.bar_off = g.land_off + (g.tma ? kRing * g.land_bytes : 0);
  return 128 /* alignment slack */ + g.bar_off + 8 * kRing;
}

template <int CIN, int NT>
int launch(const void* x, const void* w, const float* bias, void* out, int B, int D, int H, int W, int relu,
           int out_bf16, cudaStream_t stream) {
  const int vbytes = NT * 8 * (out_bf16 ? 2 : 4);
  const int max_tx = (256 / CIN - 16) / 16 * 16;  // the landing box, (TX + 16) Cin wide, within TMA's 256
  Geo g;
  g.D = D;
  g.H = H;
  g.W = W;
  // whole rows where one fits the staging buffer and max_tx, else W cut in
  // equal chunks, each a multiple of 16 voxels
  int chunks = (int)(((long long)W * vbytes + kStageBudget - 1) / kStageBudget);
  if (chunks < (W + max_tx - 1) / max_tx) chunks = (W + max_tx - 1) / max_tx;
  g.TX = chunks == 1 ? W : ((W + chunks - 1) / chunks + 15) / 16 * 16;
  g.TXp = (g.TX + 15) / 16 * 16;
  int ty = kStageBudget / (g.TXp * vbytes);
  ty = ty < 1 ? 1 : (ty > H ? H : ty);
  // down to half of that, the most rows whose fragments split evenly over the warps
  for (int t = ty; 2 * t > ty; --t)
    if (t * (g.TXp / 16) % kWarps == 0) {
      ty = t;
      break;
    }
  // the box grows with TY: fewer rows where the layout would not fit 200 KB
  int smem = 0;
  for (;; --ty) {
    smem = layout<CIN>(g, ty, B, vbytes);
    if (smem <= 200 * 1024 || ty == 1) break;
  }
  if (g.n_tiles < 0) return (int)cudaErrorInvalidValue;

  CUtensorMap tm_x = {};
  if (g.tma) {
    EncodeTiled encode = encode_tiled();
    if (encode == nullptr) return -1;
    // x as {W Cin, H, D, B}; box {LWC, TY + 2, 3, 1}; zero fill outside the volume
    const cuuint64_t dims[4] = {(cuuint64_t)W * CIN, (cuuint64_t)H, (cuuint64_t)D, (cuuint64_t)B};
    const cuuint64_t strides[3] = {(cuuint64_t)W * CIN * 2, (cuuint64_t)H * W * CIN * 2,
                                   (cuuint64_t)D * H * W * CIN * 2};
    const cuuint32_t box[4] = {(cuuint32_t)g.LWC, (cuuint32_t)(g.TY + 2), 3, 1};
    const cuuint32_t ones[4] = {1, 1, 1, 1};
    const CUresult r = encode(&tm_x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(x), dims, strides, box,
                              ones, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                              CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    if (r != CUDA_SUCCESS) return -(1000 + (int)r);
  }

  auto kernel = conv3d_cinsmall_kernel<CIN, NT>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  int per_sm = 0, dev = 0, sms = 0;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem)) != cudaSuccess ||
      (e = cudaGetDevice(&dev)) != cudaSuccess ||
      (e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)e;
  int blocks = (per_sm > 0 ? per_sm : 1) * sms;
  if (blocks > g.n_tiles) blocks = g.n_tiles;
  kernel<<<(unsigned)blocks, kThreads, smem, stream>>>(tm_x, static_cast<const uint16_t*>(x),
                                                       static_cast<const uint16_t*>(w), bias,
                                                       static_cast<uint8_t*>(out), g, relu, out_bf16);
  return (int)cudaGetLastError();
}

// the build for Cout = 8 NT, over NT = FROM, FROM + 1, ... while the B
// fragments fit (k_steps(CIN) * NT <= 32)
template <int CIN, int FROM>
int by_nt(int nt, const void* x, const void* w, const float* bias, void* out, int B, int D, int H, int W, int relu,
          int out_bf16, cudaStream_t stream) {
  if constexpr (k_steps(CIN) * FROM > 32) {
    return (int)cudaErrorInvalidValue;
  } else {
    if (nt == FROM) return launch<CIN, FROM>(x, w, bias, out, B, D, H, W, relu, out_bf16, stream);
    return by_nt<CIN, FROM + 1>(nt, x, w, bias, out, B, D, H, W, relu, out_bf16, stream);
  }
}

}  // namespace

// x (B, D, H, W, Cin) bf16 and out (B, D, H, W, Cout) bf16 (out_bf16) or
// f32, both 16-byte aligned; w (KP, Cout) bf16, KP = 16 ceil(27 Cin / 16),
// rows from 27 Cin on zero; bias (Cout,) f32 or null. Needs 2 <= Cin <= 4,
// Cout % 8 == 0 and ceil(27 Cin / 16) * Cout / 8 <= 32.
extern "C" int conv3d_cinsmall(const void* x, const void* w, const void* bias, void* out, int B, int D, int H,
                               int W, int Cin, int Cout, int relu, int out_bf16, void* stream) {
  if (Cin < 2 || Cin > 4 || Cout % 8 != 0 || Cout < 8 || k_steps(Cin) * (Cout / 8) > 32 ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0 || reinterpret_cast<uintptr_t>(out) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  if ((long long)B * D * H * W == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* bp = static_cast<const float*>(bias);
  switch (Cin) {
    case 2: return by_nt<2, 1>(Cout / 8, x, w, bp, out, B, D, H, W, relu, out_bf16, s);
    case 3: return by_nt<3, 1>(Cout / 8, x, w, bp, out, B, D, H, W, relu, out_bf16, s);
    default: return by_nt<4, 1>(Cout / 8, x, w, bp, out, B, D, H, W, relu, out_bf16, s);
  }
}
