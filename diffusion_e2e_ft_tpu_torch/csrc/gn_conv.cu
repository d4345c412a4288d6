// Fused GroupNorm(+SiLU) -> SAME 3x3 conv for Hopper (sm_90a), in two forms.
//
// v1 replaces diffusion_e2e_ft_tpu/kernels/gn_conv.py::_conv_kernel
// (launched there by _pallas_gn_conv). From x, the per-channel fp32 sums of
// the statistics kernel (groupnorm.cu, [B, 2, C]), the GroupNorm's fp32
// weight and bias, `groups` and `eps`, it computes
//     out = conv3x3_SAME(act(x)) + bias,   act(x)[c] = silu(x[c] * a[c] + b[c])
// with a, b folded from the sums in the kernel's prologue (group mean,
// E[x^2] - mean^2 clamped at 0, rsqrt(var + eps) * w, b = bias - mean * a:
// `fold_groups`, gn_common.cuh) and the activation zero outside the image:
// the conv pads the ACTIVATION with zeros, and silu(0 * a + b) is not 0, so
// padding x instead would be wrong at every border pixel.
//
// v2, gn_conv_v2_kernel, replaces ::_conv_kernel_v2 (launched by
// _pallas_gn_conv_v2): the same output from raw x in one launch. The TPU
// kernel carries the statistics across a sequential grid axis; on the GPU
// the phase boundary is a grid-wide barrier, so v2 is a cooperative launch
// of a persistent grid, one block an SM (no more blocks than the larger
// phase has items):
// - phase 1 cuts each (b, c) row into `parts` segments and reduces each
//   with one warp (`segment_partial` + a butterfly: no block barrier), into
//   an fp32 scratch [B, 2, C, parts], one store a segment, no atomics.
//   `v2_parts` takes the fewest parts whose B * C * parts items fill the
//   grid's 8 warps a block in waves at least kV2FillPct% full, each segment
//   at least kV2MinSegment values: on 132 SMs (1056 warps), 4 parts of the
//   256 rows of [2,128,480,640], 2 of 512 rows, 1 of 1024. A block of 8
//   warps is all an SM holds beside phase 2's shared memory, so each lane
//   keeps kV2StatsUnroll = 8 16-byte loads in flight (32 KB an SM; ~6 a
//   thread cover 3.35 TB/s at ~1 us of latency);
// - __threadfence + cooperative_groups' grid.sync();
// - phase 2 walks the (image, pixel tile, channel tile) items with a grid
//   stride, the channel tile fastest, so the channel tiles of one pixel tile
//   run side by side and read its halo from L2 after the first (the weights,
//   at most 4.7 MB, stay in L2 throughout). At each new image the block
//   folds the image's groups into a, b (`fold_parts`): the parts added in
//   part order, read through L2 (`__ldcg`: the scratch was written by other
//   blocks of this launch) into shared memory, then the groups from there.
//   bf16 runs each item through the wgmma body below
//   (`hop::wgmma_tile`, v1's body: a, b halved under SiLU), fp32 through
//   `conv_tile`; between items every cp.async and wgmma group is drained and
//   the block passes a barrier before the shared memory is reused.
// Same input, same bits: the segments' sums, the parts and the products
// are each added in one fixed order.
//
// Layout: x and out are NCHW, as the port's modules hold them; the weights
// arrive as [Cout, 3, 3, C] (OHWI, rearranged and cast by the wrapper). The
// conv is an implicit GEMM over one image: M = output pixels, N = Cout,
// K = 9 taps x C.
//
// bf16, v1 and v2: the wgmma body (`hop::wgmma_tile`). What bounds it on the
// H100: at C = Cout = 128 an output pixel costs 2 * 9 * 128 * 128 FLOPs
// against ~2 * 128 bytes of x read and written, about 576 FLOPs per byte,
// above the card's ~295: compute-bound on the tensor cores. The design:
// - Products: `wgmma.mma_async` m64n128k16, bf16 in, fp32 accumulators in
//   registers, both operands from shared memory. A block is two warpgroups
//   (256 threads) and a tile of TH x TW = 4 x 64 output pixels by BN = 128
//   output channels; each warpgroup owns two tile rows, one m64 block each.
//   A is the activation halo in wgmma's unswizzled K-major layout, [channel
//   group of 8][halo pixel][8 channels]: any 8 consecutive pixels of a group
//   are one 128-byte core matrix, so each tap's A operand is the halo
//   shifted by (dy, dx) pixels, read in place through its descriptor (a tile
//   row of 64 pixels is one m64 block: TW = 64 keeps the rows' stride
//   uniform). B, one tap's [BN][BKC = 64] weight slab, is in the 128-byte
//   swizzled K-major layout (chunk j of row n at j ^ (n % 8)).
// - A ring of STAGES = 5 weight slabs, AHEAD = 3 of them in flight
//   (`cp.async`, one commit group a slab, zeros past Cout): the K loop walks
//   (64-channel chunk, tap) slabs with one block barrier each, and each
//   tap's 8 wgmmas a warpgroup are one commit group, one of them left in
//   flight across the barrier.
// - The activation is double-buffered by chunk: while chunk i's products
//   run, the raw x halo of chunk i + 1 is loaded into registers as 16-byte
//   runs along w (8 runs a halo row of 66 columns; the two edge columns one
//   value each; scalar loads where W % 8 != 0), two channels a lane, and
//   normalised, SiLU'd, zero-masked outside the image and cast once per
//   staged value into the other buffer, one run item a tap two taps after
//   its loads, after the tap's wgmmas are issued. SiLU is h + h tanh(h) with
//   h = y / 2 (a and b are folded halved): one MUFU operation a value.
//   Dedicating a third warpgroup to the activation (warp specialisation)
//   measured slower: one warp a scheduler could not hide its latencies.
// - Weight restaging: each block streams all 9 * C * BN weights once for
//   256 output pixels. At [2,128,480,640] -> 128 the launch moves 2400 tiles
//   x 295 KB = 708 MB of weights from L2 into shared memory against 157 MB
//   of x: 4.5x.
// - Waves: one block an SM (~190 KB of shared memory, 255 registers a
//   thread). The 60x80 decoder layer (512 -> 512) is 240 tiles on 132 SMs,
//   1.82 waves: the SMs are 91% busy over the launch. BN = 64 there (480
//   tiles, 3.6 waves, also 91%) measured slower: the halo transform is per
//   tile, so it doubles against the products; the tile stays the same at
//   every shape.
// - Epilogue: the fp32 bias added to the accumulators, the tile staged
//   through shared memory as bf16 [BN][256 pixels], and NCHW stored as
//   16-byte runs along w (scalar at a ragged edge).
// v1 launches one block a tile and folds in its prologue; v2 walks tiles in
// a persistent block and folds at each new image. Ragged H, W and Cout are
// masked in the body; C must be a multiple of 64.
//
// fp32, v1 and v2: the scalar body `conv_tile`, exact to summation order (no
// TF32): an 8 x 16-pixel tile, BN = 128, its halo normalised once per
// 32-channel chunk into shared memory (SiLU as y / (1 + exp(-y)), a and b
// unhalved), the nine taps' weights copied with `cp.async`, products by
// scalar FMA in k order; one shared-memory stage, one block an SM.

#include <cooperative_groups.h>

#include <algorithm>

#include "gn_common.cuh"
#include "mma_common.cuh"

namespace cg = cooperative_groups;

namespace {

// ---- fp32: the `conv_tile` body (v1 and v2) ----

constexpr int TH = 8, TW = 16;                  // output tile: rows x columns of one image
constexpr int BM = TH * TW;                     // 128 output pixels
constexpr int BN = 128;                         // output channels per tile
constexpr int BK = 32;                          // input channels per chunk
constexpr int HALO_W = TW + 2, HALO = (TH + 2) * HALO_W;  // 180 halo pixels
constexpr int THREADS = 256;                    // 8 warps: 4 (pixel rows) x 2 (channel halves)
static_assert(BM == 4 * 32 && BN == 2 * 64 && TW == 16, "warp tiling: 2 tile rows x 64 channels a warp");

// Shared memory of one tile: the halo [HALO][LDK], then the nine taps'
// weights [9 * BN][LDK], rows padded so that 8 consecutive rows fall in
// distinct bank groups (the float4 reads are then conflict-free) and stay
// 16-byte aligned; the C tile [BN][LDC] (pixels contiguous) reuses them once
// the K loop is done.
constexpr int LDK = BK + 4;
constexpr int LDC = BM + 4;
constexpr int W_OFF = align_up(HALO * LDK * 4, 128);
constexpr int AB_BYTES = W_OFF + 9 * BN * LDK * 4;
constexpr int C_BYTES = BN * LDC * 4;
constexpr int TILE_BYTES = align_up(AB_BYTES > C_BYTES ? AB_BYTES : C_BYTES, 128);

// Dynamic shared memory: the tile, then a[C] and b[C] (~190 KB: one block an SM).
int smem_bytes(int C) { return TILE_BYTES + 2 * C * 4; }

__device__ __forceinline__ float act(float v, float a, float b, bool silu) {
  const float y = fmaf(v, a, b);
  return silu ? y / (1.f + expf(-y)) : y;
}

// acc[r][j][e]: this thread's outputs for the warp's pixel row r (tile row
// 2 * wm + r, 16 pixels) and 8-channel group j (channels wn * 64 + 8 j ...):
// pixel g + 8 (e / 2), channel 2 tig + e % 2, with g = lane / 4 and tig =
// lane % 4.
using Acc = float[2][8][4];

// One chunk's products over the nine taps, by scalar FMA in k order.
__device__ __forceinline__ void chunk_products(Acc& acc, const float* sx, const float* sw, int wm, int wn,
                                               int lane) {
  const int g = lane / 4, tig = lane % 4;
#pragma unroll 1
  for (int tap = 0; tap < 9; ++tap) {
    const int dy = tap / 3, dx = tap % 3;
#pragma unroll 1
    for (int k = 0; k < BK; k += 4) {
      float4 av[2][2];
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          av[r][h] = *reinterpret_cast<const float4*>(sx + ((2 * wm + r + dy) * HALO_W + g + 8 * h + dx) * LDK + k);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float4 bv =
              *reinterpret_cast<const float4*>(sw + (tap * BN + wn * 64 + 8 * j + 2 * tig + e) * LDK + k);
#pragma unroll
          for (int r = 0; r < 2; ++r)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              float s = acc[r][j][2 * h + e];
              s = fmaf(av[r][h].x, bv.x, s);
              s = fmaf(av[r][h].y, bv.y, s);
              s = fmaf(av[r][h].z, bv.z, s);
              acc[r][j][2 * h + e] = fmaf(av[r][h].w, bv.w, s);
            }
        }
    }
  }
}

// One tile of one image: ob[co, h, w] = bias[co] + sum_{tap, c} wk[co, tap, c]
// * act(xb)[c, h + dy - 1, w + dx - 1] for the TH x TW pixels from (h0, w0)
// and the BN channels from n0, with act from the per-channel sa, sb in
// shared memory and zero outside the image. Every thread of the block calls
// it; it ends with the block synchronised and its shared memory free.
template <bool kSilu>
__device__ void conv_tile(const float* __restrict__ xb, const float* sa, const float* sb,
                          const float* __restrict__ wk, const float* __restrict__ bias, float* __restrict__ ob, int C,
                          int Cout, int H, int W, int h0, int w0, int n0, unsigned char* smem) {
  float* sx = reinterpret_cast<float*>(smem);
  float* sw = reinterpret_cast<float*>(smem + W_OFF);
  float* sC = reinterpret_cast<float*>(smem);
  const int64_t HW = static_cast<int64_t>(H) * W;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp % 4, wn = warp / 4;

  Acc acc;
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[r][j][e] = 0.f;

  for (int c0 = 0; c0 < C; c0 += BK) {
    // the nine taps' weights, 16-byte vectors of one output channel's run of
    // BK input channels, copied asynchronously (zeros past Cout) while the
    // halo below is loaded and normalized
    constexpr int VEC = 4, VECS = BK / VEC;
    for (int i = threadIdx.x; i < 9 * BN * VECS; i += THREADS) {
      const int v = i % VECS, row = i / VECS;  // row = tap * BN + n
      const int tap = row / BN, co = n0 + row % BN;
      const float* src = co < Cout ? wk + (static_cast<int64_t>(co) * 9 + tap) * C + c0 + v * VEC : wk;
      cp_async16(sw + row * LDK + v * VEC, src, co < Cout);
    }
    // the halo's activation: two channels of one pixel a task, neighbouring
    // threads on neighbouring pixels; a batch of tasks' loads is issued
    // before the first is used, so their latencies overlap
    constexpr int TASKS = HALO * (BK / 2), PER_THREAD = (TASKS + THREADS - 1) / THREADS;
    constexpr int BATCH = 6;  // tasks in flight a thread
    static_assert(PER_THREAD % BATCH == 0, "halo tasks must split into batches");
#pragma unroll 1
    for (int j0 = 0; j0 < PER_THREAD; j0 += BATCH) {
      float2 raw[BATCH];
      unsigned inside = 0;  // bit j: task j0 + j lies in the image
#pragma unroll
      for (int j = 0; j < BATCH; ++j) {
        const int i = threadIdx.x + (j0 + j) * THREADS;
        const int k = 2 * (i / HALO), p = i % HALO;
        const int h = h0 - 1 + p / HALO_W, w = w0 - 1 + p % HALO_W;
        if (i < TASKS && h >= 0 && h < H && w >= 0 && w < W) {
          const float* src = xb + (c0 + k) * HW + static_cast<int64_t>(h) * W + w;
          raw[j] = make_float2(src[0], src[HW]);
          inside |= 1u << j;
        }
      }
#pragma unroll
      for (int j = 0; j < BATCH; ++j) {
        const int i = threadIdx.x + (j0 + j) * THREADS;
        const int k = 2 * (i / HALO), p = i % HALO;
        float v0 = 0.f, v1 = 0.f;  // the conv's zero padding of the activation
        if (inside >> j & 1u) {
          const int c = c0 + k;
          v0 = act(raw[j].x, sa[c], sb[c], kSilu);
          v1 = act(raw[j].y, sa[c + 1], sb[c + 1], kSilu);
        }
        if (i < TASKS) *reinterpret_cast<float2*>(sx + p * LDK + k) = make_float2(v0, v1);
      }
    }
    cp_async_wait_all();
    __syncthreads();
    chunk_products(acc, sx, sw, wm, wn, lane);
    __syncthreads();
  }

  const int g = lane / 4, tig = lane % 4;
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        sC[(wn * 64 + 8 * j + 2 * tig + e % 2) * LDC + (2 * wm + r) * TW + g + 8 * (e / 2)] = acc[r][j][e];
  __syncthreads();
  for (int i = threadIdx.x; i < BM * BN; i += THREADS) {
    const int n = i / BM, m = i % BM;
    const int h = h0 + m / TW, w = w0 + m % TW, co = n0 + n;
    if (h < H && w < W && co < Cout) ob[co * HW + static_cast<int64_t>(h) * W + w] = sC[n * LDC + m] + bias[co];
  }
  __syncthreads();
}

// ---- bf16: the wgmma body (v1 and v2) ----

namespace hop {

constexpr int TH = 4, TW = 64;                 // output tile: rows x columns of one image; a tile row is one m64 block
constexpr int BM = TH * TW;                    // 256 output pixels: two warpgroups x two tile rows
constexpr int BN = 128;                        // output channels a tile
constexpr int BKC = 64;                        // input channels per chunk: one 128-byte weight row
constexpr int HALO_H = TH + 2, HALO_W = TW + 2, HALO = HALO_H * HALO_W;  // 396 halo pixels
constexpr int HALO_PAD = 401;                  // pixels a channel group: = 1 mod 8, conflict-free stores
constexpr int STAGES = 5, AHEAD = 3;           // weight slab ring; slabs in flight ahead of the products
constexpr int THREADS = 256;
constexpr int TAPS = 9;
constexpr int VECS = TW / 8;                   // 16-byte runs of a halo row inside the tile's columns
constexpr int RUN_ITEMS = HALO_H * VECS / (THREADS / 32);  // 6 a thread: (row, run); lane = channel pair
constexpr int EDGE_ITEMS = 2;                  // (row, side): 12 items over 8 warps
constexpr int LDO = BM + 8;                    // epilogue staging row stride, bf16
constexpr int ACT_BYTES = BKC / 8 * HALO_PAD * 16;  // one activation buffer
static_assert(RUN_ITEMS == 6 && HALO_H * VECS % (THREADS / 32) == 0 && BKC == 2 * 32, "a lane: two channels");
static_assert(HALO_H * 2 <= EDGE_ITEMS * (THREADS / 32), "the edge items");
static_assert(HALO_PAD >= HALO && HALO_PAD % 8 == 1, "channel groups apart by 1 mod 8 x 16 bytes");

constexpr int SLAB = BN * BKC * 2;             // one tap's [BN][64] bf16 weights
constexpr int SMEM_ACT = STAGES * SLAB;        // the ring first: 1024-byte aligned (the swizzle atom)
constexpr int SMEM_AB = SMEM_ACT + 2 * ACT_BYTES;   // a[C], b[C] fp32, then the bias [BN]
static_assert(BN * LDO * 2 <= 2 * ACT_BYTES, "the epilogue's staging fits the activation buffers");

int smem_bytes(int C) { return 1024 + SMEM_AB + (2 * C + BN) * 4; }  // 1024: room to align the base

// The activation's layout, [channel group of 8][halo pixel (HALO_PAD)][8
// channels]: 8 consecutive pixels of one group are one 128-byte core matrix
// of wgmma's unswizzled K-major layout, from any first pixel, so each tap's
// A operand is the halo shifted by (dy, dx) pixels through its descriptor.
__device__ __forceinline__ int act_index(int p, int k) { return ((k >> 3) * HALO_PAD + p) * 8 + (k & 7); }

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// plain and cp.async writes to shared memory (generic proxy) made visible to
// wgmma's reads (async proxy)
__device__ __forceinline__ void fence_proxy_async() { asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory"); }

template <int R>
__device__ __forceinline__ void fence_operands(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Shared-memory matrix descriptors (start address >> 4, leading byte offset
// >> 4 at bit 16, stride byte offset >> 4 at bit 32, layout type at bit 62).
// B: K-major [N][64] bf16, 128-byte rows in the 128-byte swizzle (layout 1),
// 1024 bytes between 8-row groups (the leading offset is unused).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) | (1ull << 62);
}
// A: K-major, unswizzled (layout 0): 128 bytes between 8-row groups (along
// M), HALO_PAD * 16 bytes between the two 8-channel halves of k16 (along K).
__device__ __forceinline__ uint64_t act_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(HALO_PAD) << 16) | (8ull << 32);
}

// d[64 x 128] += a[64 x 16] * b[16 x 128], both from shared memory (K-major).
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63},"
      " %64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

// A thread's part of each weight slab: rows n = threadIdx.x / 8 + 32 it
// (output channel n0 + n, zeros past Cout), 16-byte chunk j = threadIdx.x % 8
// of the row's 64 input channels, stored at chunk j ^ (n % 8) (the 128-byte
// swizzle) of the row's 128 bytes. Only the slab's offset in the weights
// changes from one slab to the next.
struct SlabLoader {
  static constexpr int ROWS = BN * 8 / THREADS;  // rows a thread copies
  const bf16* src;                               // row threadIdx.x / 8, chunk j, of the first slab
  int64_t row_step;                              // 32 rows of [Cout, 3, 3, C]
  int dst;                                       // byte offset of the first row's chunk in a slot
  int rows_in;                                   // of this thread's rows, those below Cout
  const bf16* any;                               // a mapped address for the zero-filled copies

  __device__ SlabLoader(const bf16* wk, int C, int Cout, int n0) : any(wk) {
    const int n = threadIdx.x / 8, j = threadIdx.x % 8;
    row_step = static_cast<int64_t>(32) * TAPS * C;
    src = wk + static_cast<int64_t>(n0 + n) * TAPS * C + 8 * j;
    dst = n * 128 + ((j ^ (n & 7)) << 4);
    rows_in = 0;
#pragma unroll
    for (int it = 0; it < ROWS; ++it) rows_in += n0 + n + 32 * it < Cout;
  }

  // slab (chunk, tap) into the slot at `slot`
  __device__ __forceinline__ void load(unsigned char* slot, int chunk, int tap, int C) const {
    const int64_t off = static_cast<int64_t>(tap) * C + chunk * BKC;
#pragma unroll
    for (int it = 0; it < ROWS; ++it) {
      const bool ok = it < rows_in;
      cp_async16(slot + dst + it * 32 * 128, ok ? src + it * row_step + off : any, ok);
    }
  }
};

// The tile's image and place: raw x is read as 16-byte runs of 8 columns
// (zeros where outside the image; the activation is masked again when it is
// stored).
struct HaloTile {
  const bf16* xb;  // this image's x, from the chunk's first channel
  int64_t HW;
  int H, W, h0, w0;
  bool aligned;  // W % 8 == 0: every run inside the image is one 16-byte load
};

__device__ __forceinline__ void run_item(int k, int& r, int& v) {
  const int id = threadIdx.x / 32 + (THREADS / 32) * k;  // (row, run)
  r = id / VECS;
  v = id % VECS;
}

__device__ __forceinline__ bool edge_item(int k, int& r, int& side) {
  const int id = threadIdx.x / 32 + (THREADS / 32) * k;  // (row, side)
  r = id / 2;
  side = id % 2;
  return id < HALO_H * 2;
}

__device__ __forceinline__ uint4 load_run(const HaloTile& t, int c, int r, int v) {
  uint4 raw = make_uint4(0u, 0u, 0u, 0u);
  const int h = t.h0 - 1 + r, w = t.w0 + 8 * v;
  if (h < 0 || h >= t.H || w >= t.W) return raw;
  const bf16* p = t.xb + c * t.HW + static_cast<int64_t>(h) * t.W + w;
  if (t.aligned) return __ldg(reinterpret_cast<const uint4*>(p));
  unsigned short* e = reinterpret_cast<unsigned short*>(&raw);
  const unsigned short* q = reinterpret_cast<const unsigned short*>(p);
#pragma unroll
  for (int j = 0; j < 8; ++j)
    if (w + j < t.W) e[j] = q[j];
  return raw;
}

__device__ __forceinline__ unsigned short load_edge(const HaloTile& t, int c, int r, int side) {
  const int h = t.h0 - 1 + r, w = side ? t.w0 + TW : t.w0 - 1;
  if (h < 0 || h >= t.H || w < 0 || w >= t.W) return 0;
  return reinterpret_cast<const unsigned short*>(t.xb)[c * t.HW + static_cast<int64_t>(h) * t.W + w];
}

__device__ __forceinline__ float tanh_approx(float x) {
  float y;
  asm("tanh.approx.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// act(x) of two channels' raw bf16 values, packed as bf16x2 (the first in the
// low half, the lower address); zeros outside the image (the conv's padding
// of the activation). SiLU as h + h tanh(h) with h = y / 2 = x a / 2 + b / 2
// (the fold halves a and b under SiLU): one FMA, one MUFU operation and one
// FMA a value.
template <bool kSilu>
__device__ __forceinline__ uint32_t act_pair(uint32_t r0, uint32_t r1, float a0, float b0, float a1, float b1,
                                             bool inside) {
  if (!inside) return 0u;
  float y0 = fmaf(__uint_as_float(r0 << 16), a0, b0), y1 = fmaf(__uint_as_float(r1 << 16), a1, b1);
  if (kSilu) {
    y0 = fmaf(y0, tanh_approx(y0), y0);
    y1 = fmaf(y1, tanh_approx(y1), y1);
  }
  return pack_bf16x2(y0, y1);
}

// A thread's raw x of one run item: channels 2 lane and 2 lane + 1 of the chunk.
struct RunRaw {
  uint4 c0, c1;
};

__device__ __forceinline__ void load_item(const HaloTile& t, int k, RunRaw& raw) {
  int r, v;
  run_item(k, r, v);
  const int c = 2 * (threadIdx.x % 32);
  raw.c0 = load_run(t, c, r, v);
  raw.c1 = load_run(t, c + 1, r, v);
}

// Normalise run item k into the activation at pixels (r, 1 + 8 v + j): one
// 4-byte store of the channel pair a pixel.
template <bool kSilu>
__device__ __forceinline__ void store_item(bf16* act, const HaloTile& t, const float* sa, const float* sb, int c0,
                                           int k, const RunRaw& raw) {
  int r, v;
  run_item(k, r, v);
  const int cl = 2 * (threadIdx.x % 32), c = c0 + cl;
  const float a0 = sa[c], b0 = sb[c], a1 = sa[c + 1], b1 = sb[c + 1];
  const int h = t.h0 - 1 + r, w = t.w0 + 8 * v;
  const bool row_in = h >= 0 && h < t.H;
  const uint32_t* e0 = reinterpret_cast<const uint32_t*>(&raw.c0);
  const uint32_t* e1 = reinterpret_cast<const uint32_t*>(&raw.c1);
  uint32_t* dst = reinterpret_cast<uint32_t*>(act + act_index(r * HALO_W + 1 + 8 * v, cl));
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const uint32_t x0 = j % 2 ? e0[j / 2] >> 16 : e0[j / 2] & 0xffffu;
    const uint32_t x1 = j % 2 ? e1[j / 2] >> 16 : e1[j / 2] & 0xffffu;
    dst[4 * j] = act_pair<kSilu>(x0, x1, a0, b0, a1, b1, row_in && w + j < t.W);
  }
}

__device__ __forceinline__ void load_edges(const HaloTile& t, uint32_t (&edge)[EDGE_ITEMS]) {
  const int c = 2 * (threadIdx.x % 32);
#pragma unroll
  for (int k = 0; k < EDGE_ITEMS; ++k) {
    int r, side;
    edge[k] = 0;
    if (edge_item(k, r, side)) edge[k] = load_edge(t, c, r, side) | static_cast<uint32_t>(load_edge(t, c + 1, r, side)) << 16;
  }
}

template <bool kSilu>
__device__ __forceinline__ void store_edges(bf16* act, const HaloTile& t, const float* sa, const float* sb, int c0,
                                            const uint32_t (&edge)[EDGE_ITEMS]) {
  const int cl = 2 * (threadIdx.x % 32), c = c0 + cl;
#pragma unroll
  for (int k = 0; k < EDGE_ITEMS; ++k) {
    int r, side;
    if (!edge_item(k, r, side)) continue;
    const int h = t.h0 - 1 + r, w = side ? t.w0 + TW : t.w0 - 1;
    const bool inside = h >= 0 && h < t.H && w >= 0 && w < t.W;
    *reinterpret_cast<uint32_t*>(act + act_index(r * HALO_W + (side ? HALO_W - 1 : 0), cl)) =
        act_pair<kSilu>(edge[k] & 0xffffu, edge[k] >> 16, sa[c], sb[c], sa[c + 1], sb[c + 1], inside);
  }
}

// The body's shared memory, carved from a block's dynamic buffer: the ring
// on the 1024-byte swizzle atom, the two activation buffers, a[C], b[C] and
// the bias [BN].
struct Smem {
  unsigned char* ring;
  bf16* act;
  float* sa;
  float* sb;
  float* sbias;
  uint32_t ring_addr, act_addr;
};

__device__ __forceinline__ Smem carve(unsigned char* smem_raw, int C) {
  const uint32_t raw_addr = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  unsigned char* smem = smem_raw + ((1024 - (raw_addr & 1023)) & 1023);
  Smem s;
  s.ring = smem;
  s.act = reinterpret_cast<bf16*>(smem + SMEM_ACT);
  s.sa = reinterpret_cast<float*>(smem + SMEM_AB);
  s.sb = s.sa + C;
  s.sbias = s.sb + C;
  s.ring_addr = static_cast<uint32_t>(__cvta_generic_to_shared(s.ring));
  s.act_addr = static_cast<uint32_t>(__cvta_generic_to_shared(s.act));
  return s;
}

// One output tile of one image: ob[co, h, w] = bias[co] + sum over taps and
// channels of wk[co, tap, c] * act(xb)[c, h + dy - 1, w + dx - 1] for the
// TH x TW pixels from (h0, w0) and the BN channels from n0 (xb, ob: the
// image's x and out). `fold()` runs once the ring's first slabs are in
// flight, before chunk 0's halo is normalised: it leaves a, b (halved under
// SiLU) in sm.sa, sm.sb, and the block synchronised if it wrote them. Every
// thread of the block calls it. It returns with every wgmma done and no
// cp.async in flight but an empty group; other threads may still be reading
// the output tile from the activation buffers.
template <bool kSilu, typename Fold>
__device__ __forceinline__ void wgmma_tile(const bf16* __restrict__ xb, const bf16* __restrict__ wk,
                                           const float* __restrict__ bias, bf16* __restrict__ ob, int C, int Cout,
                                           int H, int W, int h0, int w0, int n0, const Smem& sm, Fold&& fold) {
  const int64_t HW = static_cast<int64_t>(H) * W;
  const HaloTile tile{xb, HW, H, W, h0, w0, W % 8 == 0};
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wg = warp / 4, wi = warp % 4;
  const int nchunks = C / BKC, total = nchunks * TAPS;

  // prologue: the first slabs in flight, the fold, then chunk 0's activation
  const SlabLoader slabs(wk, C, Cout, n0);
#pragma unroll
  for (int s = 0; s < AHEAD; ++s) {
    if (s < total) slabs.load(sm.ring + s * SLAB, s / TAPS, s % TAPS, C);
    cp_async_commit();
  }
  for (int n = threadIdx.x; n < BN; n += THREADS) sm.sbias[n] = n0 + n < Cout ? bias[n0 + n] : 0.f;
  fold();
  RunRaw raw[2];
  uint32_t edge[EDGE_ITEMS];
#pragma unroll
  for (int k = 0; k < RUN_ITEMS; ++k) {
    load_item(tile, k, raw[0]);
    store_item<kSilu>(sm.act, tile, sm.sa, sm.sb, 0, k, raw[0]);
  }
  load_edges(tile, edge);
  store_edges<kSilu>(sm.act, tile, sm.sa, sm.sb, 0, edge);

  float acc[2][64];
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[j][i] = 0.f;
  fence_operands(acc[0]);
  fence_operands(acc[1]);

  for (int i = 0; i < nchunks; ++i) {
    const bool more = i + 1 < nchunks;
    const uint32_t cur = sm.act_addr + (i & 1) * ACT_BYTES;
    bf16* nxt = sm.act + ((i + 1) & 1) * (ACT_BYTES / 2);
    const int c_next = (i + 1) * BKC;
    const HaloTile next{tile.xb + static_cast<int64_t>(c_next) * HW, HW, H, W, h0, w0, tile.aligned};
#pragma unroll
    for (int t = 0; t < TAPS; ++t) {
      const int s = i * TAPS + t;
      cp_async_wait<AHEAD - 1>();  // slab s has landed (this thread's part)
      fence_proxy_async();         // ... and so have this thread's activation stores
      __syncthreads();             // everyone's; slab s - 2's products are done, its slot is free
      if (s + AHEAD < total) {
        const int ahead_tap = (t + AHEAD) % TAPS, ahead_chunk = (t + AHEAD) / TAPS;  // t is unrolled
        slabs.load(sm.ring + (s + AHEAD) % STAGES * SLAB, i + ahead_chunk, ahead_tap, C);
      }
      cp_async_commit();
      const int dy = t / 3, dx = t % 3;
      const uint32_t slab = sm.ring_addr + (s % STAGES) * SLAB;
      fence_operands(acc[0]);
      fence_operands(acc[1]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BKC / 16; ++kk) {
        const uint64_t desc_b = sw128_desc(slab + kk * 32);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          // the warpgroup's tile row 2 wg + j, shifted by the tap; channels 16 kk ..
          const int p0 = (2 * wg + j + dy) * HALO_W + dx;
          wgmma_ss(acc[j], act_desc(cur + (2 * kk * HALO_PAD + p0) * 16), desc_b);
        }
      }
      wgmma_commit();
      // while the tap's products run, chunk i + 1's activation: run item
      // t - 1 stored into the other buffer (chunk i - 1's, whose products
      // ended before tap 1's barrier), item t + 1 loaded (items 0 and 1 at
      // tap 0); the edge columns loaded at tap 5 and stored at tap 7
      if (more) {
        if (t == 0) {
          load_item(next, 0, raw[0]);
          load_item(next, 1, raw[1]);
        }
        if (t >= 1 && t <= RUN_ITEMS) store_item<kSilu>(nxt, next, sm.sa, sm.sb, c_next, t - 1, raw[(t - 1) % 2]);
        if (t >= 1 && t + 1 < RUN_ITEMS) load_item(next, t + 1, raw[(t + 1) % 2]);
        if (t == RUN_ITEMS - 1) load_edges(next, edge);
        if (t == RUN_ITEMS + 1) store_edges<kSilu>(nxt, next, sm.sa, sm.sb, c_next, edge);
      }
      wgmma_wait<1>();
      fence_operands(acc[0]);
      fence_operands(acc[1]);
    }
  }
  wgmma_wait<0>();
  fence_operands(acc[0]);
  fence_operands(acc[1]);
  __syncthreads();  // every product done: the activation buffers take the output tile

  // accumulator (m64 block j, n8 block q, e): tile row 2 wg + j, column
  // 16 wi + lane / 4 (+8 for e >= 2), channel 8 q + 2 (lane % 4) + e % 2
  bf16* so = sm.act;  // [BN][LDO]: channel rows, the tile's 256 pixels row-major
  const int g = lane / 4, tq = lane % 4;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int m = (2 * wg + j) * TW + 16 * wi + g;
#pragma unroll
    for (int q = 0; q < BN / 8; ++q) {
      const int n = 8 * q + 2 * tq;
      const float b0 = sm.sbias[n], b1 = sm.sbias[n + 1];
      so[n * LDO + m] = __float2bfloat16(acc[j][4 * q] + b0);
      so[(n + 1) * LDO + m] = __float2bfloat16(acc[j][4 * q + 1] + b1);
      so[n * LDO + m + 8] = __float2bfloat16(acc[j][4 * q + 2] + b0);
      so[(n + 1) * LDO + m + 8] = __float2bfloat16(acc[j][4 * q + 3] + b1);
    }
  }
  __syncthreads();
#pragma unroll 4
  for (int it = 0; it < BN * TH * VECS / THREADS; ++it) {
    const int idx = threadIdx.x + it * THREADS;
    const int n = idx / (TH * VECS), r = idx % (TH * VECS) / VECS, v = idx % VECS;
    const int co = n0 + n, h = h0 + r, w = w0 + 8 * v;
    if (co >= Cout || h >= H || w >= W) continue;
    const bf16* src = so + n * LDO + r * TW + 8 * v;
    bf16* dst = ob + co * HW + static_cast<int64_t>(h) * W + w;
    if (tile.aligned) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    } else {
      for (int e = 0; e < 8 && w + e < W; ++e) dst[e] = src[e];
    }
  }
}

// v1: one block a tile, the fold from the statistics kernel's [B, 2, C] sums.
template <bool kSilu>
__global__ void __launch_bounds__(THREADS, 1)
gn_conv_wgmma_kernel(const bf16* __restrict__ x, const float* __restrict__ stats, const float* __restrict__ gn_w,
                     const float* __restrict__ gn_b, const bf16* __restrict__ wk, const float* __restrict__ bias,
                     bf16* __restrict__ out, int C, int Cout, int H, int W, int groups, float eps) {
  extern __shared__ unsigned char smem_raw[];
  const Smem sm = carve(smem_raw, C);
  const int b = blockIdx.z;
  const int tiles_w = (W + TW - 1) / TW;
  const int64_t HW = static_cast<int64_t>(H) * W;
  wgmma_tile<kSilu>(x + static_cast<int64_t>(b) * C * HW, wk, bias, out + static_cast<int64_t>(b) * Cout * HW, C,
                    Cout, H, W, blockIdx.x / tiles_w * TH, blockIdx.x % tiles_w * TW, blockIdx.y * BN, sm, [&] {
                      fold_groups<THREADS>(stats + static_cast<int64_t>(b) * 2 * C, gn_w, gn_b, C, groups, HW, eps,
                                           sm.sa, sm.sb, kSilu ? 0.5f : 1.f);
                    });
}

template <bool kSilu>
int launch_bf16(const void* x, const float* stats, const float* gn_w, const float* gn_b, const void* wk,
                const float* bias, void* out, int B, int C, int Cout, int H, int W, int groups, float eps,
                cudaStream_t stream) {
  auto kernel = gn_conv_wgmma_kernel<kSilu>;
  const int bytes = smem_bytes(C);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t tiles_hw = static_cast<int64_t>((H + TH - 1) / TH) * ((W + TW - 1) / TW);
  dim3 grid(static_cast<unsigned>(tiles_hw), (Cout + BN - 1) / BN, B);
  kernel<<<grid, THREADS, bytes, stream>>>(static_cast<const bf16*>(x), stats, gn_w, gn_b,
                                           static_cast<const bf16*>(wk), bias, static_cast<bf16*>(out), C, Cout, H,
                                           W, groups, eps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace hop

// ---- v1 in fp32 ----

template <bool kSilu>
__global__ void __launch_bounds__(THREADS, 1)
gn_conv_kernel(const float* __restrict__ x, const float* __restrict__ stats, const float* __restrict__ gn_w,
               const float* __restrict__ gn_b, const float* __restrict__ wk, const float* __restrict__ bias,
               float* __restrict__ out, int C, int Cout, int H, int W, int groups, float eps) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* sa = reinterpret_cast<float*>(smem + TILE_BYTES);
  float* sb = sa + C;
  const int b = blockIdx.z;
  const int64_t HW = static_cast<int64_t>(H) * W;
  fold_groups<THREADS>(stats + static_cast<int64_t>(b) * 2 * C, gn_w, gn_b, C, groups, HW, eps, sa, sb);
  const int tiles_w = (W + TW - 1) / TW;
  conv_tile<kSilu>(x + b * C * HW, sa, sb, wk, bias, out + b * Cout * HW, C, Cout, H, W, blockIdx.x / tiles_w * TH,
                   blockIdx.x % tiles_w * TW, blockIdx.y * BN, smem);
}

template <bool kSilu>
int launch_v1_fp32(const void* x, const float* stats, const float* gn_w, const float* gn_b, const void* wk,
                   const float* bias, void* out, int B, int C, int Cout, int H, int W, int groups, float eps,
                   cudaStream_t stream) {
  auto kernel = gn_conv_kernel<kSilu>;
  const int bytes = smem_bytes(C);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t tiles_hw = static_cast<int64_t>((H + TH - 1) / TH) * ((W + TW - 1) / TW);
  dim3 grid(static_cast<unsigned>(tiles_hw), (Cout + BN - 1) / BN, B);
  kernel<<<grid, THREADS, bytes, stream>>>(static_cast<const float*>(x), stats, gn_w, gn_b,
                                           static_cast<const float*>(wk), bias, static_cast<float*>(out), C, Cout,
                                           H, W, groups, eps);
  return static_cast<int>(cudaGetLastError());
}

// ---- v2: statistics, a grid barrier, the fold and the conv in one launch ----

constexpr int kV2Warps = THREADS / 32;  // statistics items a block reduces at once, one a warp
constexpr int kV2MaxParts = 8;          // segments a (b, c) row at most
constexpr int kV2MinSegment = 4096;     // values a segment at least, before a row is split further
constexpr int kV2FillPct = 90;          // the waves of B * C * parts items on the grid's warps at least this full
constexpr int kV2StatsUnroll = 8;       // 16-byte loads in flight a thread in the statistics phase
static_assert(hop::THREADS == THREADS, "one block size for both bodies");

// Segments a (b, c) row of n values in the statistics phase on `slots`
// warps (the grid's blocks x kV2Warps): the fewest parts (at most
// kV2MaxParts, each segment at least kV2MinSegment values unless the row is
// whole) whose rows * parts items fill ceil(items / slots) waves at least
// kV2FillPct% full; else the fullest of those (the fewest on a tie).
int v2_parts(int64_t rows, int64_t n, int64_t slots) {
  int best = 1;
  int64_t best_items = 0, best_room = 1;
  for (int p = 1; p <= kV2MaxParts; ++p) {
    if (p > 1 && n / p < kV2MinSegment) break;
    const int64_t items = rows * p, room = (items + slots - 1) / slots * slots;  // the waves' slots
    if (items * 100 >= room * kV2FillPct) return p;
    if (items * best_room > best_items * room) {
      best = p;
      best_items = items;
      best_room = room;
    }
  }
  return best;
}

// The tiles of one image in phase 2: (pixel tiles along w, pixel tiles, channel tiles).
template <typename T>
struct V2Tiles {
  static constexpr bool kWgmma = std::is_same<T, bf16>::value;
  static constexpr int TH = kWgmma ? hop::TH : ::TH, TW = kWgmma ? hop::TW : ::TW, BN = kWgmma ? hop::BN : ::BN;
  int tiles_w, tiles_hw, ntiles;
  __host__ __device__ V2Tiles(int Cout, int H, int W)
      : tiles_w((W + TW - 1) / TW), tiles_hw((H + TH - 1) / TH * tiles_w), ntiles((Cout + BN - 1) / BN) {}
};

// v2's phase 1: each (b, c, part) item's fp32 (sum x, sum x^2), one warp an
// item, into stats [B, 2, C, parts]; one block barrier at the end. The wgmma
// body after it holds 255 registers a thread, and how ptxas allocates them
// depends on this code's shape: without the barrier the body spills 52-60
// bytes, and as a call of its own (not inlined) 68-76, each ~10% slower
// (`perf/torch_gn_v2_variants.py`).
template <typename T>
__device__ __forceinline__ void v2_stats(const T* x, float* stats, int rows, int C, int64_t HW, int parts) {
  const int lane = threadIdx.x % 32;
  for (int r = blockIdx.x * kV2Warps + threadIdx.x / 32; r < rows * parts; r += gridDim.x * kV2Warps) {
    const int row = r / parts, part = r % parts;  // row = b * C + c
    float s = 0.f, ss = 0.f;
    segment_partial<T, 32, kV2StatsUnroll>(x + static_cast<int64_t>(row) * HW, HW, part, parts, lane, s, ss);
    warp_sums(s, ss);
    if (lane == 0) {
      float* st = stats + (static_cast<int64_t>(row / C) * 2 * C + row % C) * parts + part;
      st[0] = s;
      st[static_cast<int64_t>(C) * parts] = ss;
    }
  }
  __syncthreads();
}

template <typename T, bool kSilu>
__global__ void __launch_bounds__(THREADS, 1)
gn_conv_v2_kernel(const T* __restrict__ x, const float* __restrict__ gn_w, const float* __restrict__ gn_b,
                  const T* __restrict__ wk, const float* __restrict__ bias, T* __restrict__ out, float* stats,
                  int parts, int B, int C, int Cout, int H, int W, int groups, float eps) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int64_t HW = static_cast<int64_t>(H) * W;

  v2_stats(x, stats, B * C, C, HW, parts);
  __threadfence();
  cg::this_grid().sync();

  // phase 2: the items (image, pixel tile, channel tile), the channel tile
  // fastest; the fold at each new image, from sums other blocks wrote before
  // the barrier (read through L2 by fold_groups)
  const V2Tiles<T> tl(Cout, H, W);
  const int per_image = tl.tiles_hw * tl.ntiles;
  int folded = -1;
  if constexpr (V2Tiles<T>::kWgmma) {
    const hop::Smem sm = hop::carve(smem, C);
    for (int t = blockIdx.x; t < B * per_image; t += gridDim.x) {
      const int b = t / per_image, pix = t % per_image / tl.ntiles, n0 = t % tl.ntiles * hop::BN;
      hop::wgmma_tile<kSilu>(x + static_cast<int64_t>(b) * C * HW, wk, bias, out + static_cast<int64_t>(b) * Cout * HW,
                             C, Cout, H, W, pix / tl.tiles_w * hop::TH, pix % tl.tiles_w * hop::TW, n0, sm, [&] {
                               if (b == folded) return;  // the activation buffers are free: the fold's scratch
                               fold_parts<THREADS>(stats + static_cast<int64_t>(b) * 2 * C * parts, gn_w, gn_b, C,
                                                   groups, HW, eps, sm.sa, sm.sb, kSilu ? 0.5f : 1.f, parts,
                                                   reinterpret_cast<float*>(sm.act));
                               folded = b;
                             });
      cp_async_wait_all();  // the shared memory free for the next item: no copy or read in flight
      __syncthreads();
    }
  } else {
    float* sa = reinterpret_cast<float*>(smem + TILE_BYTES);
    float* sb = sa + C;
    for (int t = blockIdx.x; t < B * per_image; t += gridDim.x) {
      const int b = t / per_image, pix = t % per_image / tl.ntiles, n0 = t % tl.ntiles * BN;
      if (b != folded) {  // the previous tile ended with the block synchronised: its tiles are the scratch
        fold_parts<THREADS>(stats + static_cast<int64_t>(b) * 2 * C * parts, gn_w, gn_b, C, groups, HW, eps, sa, sb,
                            1.f, parts, reinterpret_cast<float*>(smem));
        folded = b;
      }
      conv_tile<kSilu>(x + b * C * HW, sa, sb, wk, bias, out + b * Cout * HW, C, Cout, H, W, pix / tl.tiles_w * TH,
                       pix % tl.tiles_w * TW, n0, smem);
    }
  }
}

template <typename T, bool kSilu>
int launch_v2(const void* x, const float* gn_w, const float* gn_b, const void* wk, const float* bias, void* out,
              float* stats, int parts, int B, int C, int Cout, int H, int W, int groups, float eps,
              cudaStream_t stream) {
  auto kernel = gn_conv_v2_kernel<T, kSilu>;
  const int bytes = V2Tiles<T>::kWgmma ? hop::smem_bytes(C) : smem_bytes(C);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  int device = 0, coop = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return static_cast<int>(err);
  if ((err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device)) != cudaSuccess)
    return static_cast<int>(err);
  if (!coop) return -2;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess)
    return static_cast<int>(err);
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, bytes)) != cudaSuccess)
    return static_cast<int>(err);
  if (per_sm < 1) return -3;
  // the persistent grid: every block resident at once (the barrier needs
  // it), and no more blocks than the larger phase has items
  const int64_t full = static_cast<int64_t>(per_sm) * sms, rows = static_cast<int64_t>(B) * C;
  if (parts != v2_parts(rows, static_cast<int64_t>(H) * W, full * kV2Warps)) return -4;
  const V2Tiles<T> tl(Cout, H, W);
  const int64_t work =
      std::max((rows * parts + kV2Warps - 1) / kV2Warps, static_cast<int64_t>(B) * tl.tiles_hw * tl.ntiles);
  const int64_t blocks = std::min(full, work);
  const T* xp = static_cast<const T*>(x);
  const T* wp = static_cast<const T*>(wk);
  T* op = static_cast<T*>(out);
  void* args[] = {&xp, &gn_w, &gn_b, &wp, &bias, &op, &stats, &parts, &B, &C, &Cout, &H, &W, &groups, &eps};
  err = cudaLaunchCooperativeKernel(kernel, dim3(static_cast<unsigned>(blocks)), dim3(THREADS), args, bytes, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// v1. dtype: 0 = float32, 1 = bfloat16 (x, wk and out); silu: 0 or 1. x:
// contiguous [B, C, H, W]; stats: contiguous fp32 [B, 2, C] (sum x, then sum
// x^2 over H * W, from e2eft_gn_channel_stats); gn_w, gn_b: the GroupNorm's
// fp32 [C]; wk: contiguous [Cout, 3, 3, C]; bias: fp32 [Cout]; out:
// contiguous [B, Cout, H, W]. C must be a multiple of 64 and of `groups`.
// Returns 0, a cudaError_t from the launch, or -1 for unsupported arguments.
// Launches on `stream` and does not synchronise.
int e2eft_gn_silu_conv3x3(const void* x, const float* stats, const float* gn_w, const float* gn_b, const void* wk,
                          const float* bias, void* out, int dtype, int silu, int B, int C, int Cout, int H, int W,
                          int groups, float eps, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (C % hop::BKC != 0 || groups < 1 || C % groups != 0) return -1;
  if (dtype == 0 && silu) return launch_v1_fp32<true>(x, stats, gn_w, gn_b, wk, bias, out, B, C, Cout, H, W, groups, eps, st);
  if (dtype == 0) return launch_v1_fp32<false>(x, stats, gn_w, gn_b, wk, bias, out, B, C, Cout, H, W, groups, eps, st);
  if (dtype == 1 && silu)
    return hop::launch_bf16<true>(x, stats, gn_w, gn_b, wk, bias, out, B, C, Cout, H, W, groups, eps, st);
  if (dtype == 1)
    return hop::launch_bf16<false>(x, stats, gn_w, gn_b, wk, bias, out, B, C, Cout, H, W, groups, eps, st);
  return -1;
}

// v2: as e2eft_gn_silu_conv3x3, from x alone (no statistics argument);
// `stats` is fp32 scratch of [B, 2, C, parts] that the kernel overwrites,
// with `parts` as v2_parts gives it for this card (the wrapper's
// `gn_conv.v2_plan`). C must be a multiple of `groups`, and of 64 (at most
// 6416) in bf16, of 32 in fp32. Returns as above, and -2 when the device
// cannot launch cooperatively, -3 when one block does not fit on an SM, -4
// when `parts` is not the kernel's.
int e2eft_gn_silu_conv3x3_v2(const void* x, const float* gn_w, const float* gn_b, const void* wk,
                             const float* bias, void* out, float* stats, int parts, int dtype, int silu, int B, int C,
                             int Cout, int H, int W, int groups, float eps, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (C % (dtype == 1 ? hop::BKC : BK) != 0 || groups < 1 || C % groups != 0) return -1;
  if (8 * C > (dtype == 1 ? hop::ACT_BYTES : TILE_BYTES)) return -1;  // the fold's scratch, 2 C floats
  if (dtype == 0 && silu)
    return launch_v2<float, true>(x, gn_w, gn_b, wk, bias, out, stats, parts, B, C, Cout, H, W, groups, eps, st);
  if (dtype == 0)
    return launch_v2<float, false>(x, gn_w, gn_b, wk, bias, out, stats, parts, B, C, Cout, H, W, groups, eps, st);
  if (dtype == 1 && silu)
    return launch_v2<bf16, true>(x, gn_w, gn_b, wk, bias, out, stats, parts, B, C, Cout, H, W, groups, eps, st);
  if (dtype == 1)
    return launch_v2<bf16, false>(x, gn_w, gn_b, wk, bias, out, stats, parts, B, C, Cout, H, W, groups, eps, st);
  return -1;
}

}  // extern "C"
