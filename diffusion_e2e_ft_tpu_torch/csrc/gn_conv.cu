// Fused GroupNorm(+SiLU) -> SAME 3x3 conv for Hopper (sm_90a), in two forms.
//
// v1, gn_conv_kernel, replaces diffusion_e2e_ft_tpu/kernels/gn_conv.py::
// _conv_kernel (launched there by _pallas_gn_conv): given the per-channel
// fp32 a, b of the GroupNorm (from the statistics kernel, groupnorm.cu, and
// a [B, C] fold in torch), it computes
//     out = conv3x3_SAME(act(x)) + bias,   act(x)[c] = silu(x[c] * a[c] + b[c])
// with the activation zero outside the image: the conv pads the ACTIVATION
// with zeros, and silu(0 * a + b) is not 0, so padding x instead would be
// wrong at every border pixel.
//
// v2, gn_conv_v2_kernel, replaces ::_conv_kernel_v2 (launched by
// _pallas_gn_conv_v2): the same output from raw x in one launch. The TPU
// kernel carries the statistics across a sequential grid axis; on the GPU
// the phase boundary is a grid-wide barrier, so v2 is a cooperative launch
// of a persistent grid (as many blocks as fit on the card at once): phase 1
// runs the statistics kernel's row reduction over the (b, c) rows into an
// fp32 scratch buffer, cooperative_groups' grid.sync() separates the phases,
// then each block folds the groups of its image into a, b in shared memory
// (mean, variance clamped at 0, rsqrt) and walks its conv tiles with v1's body.
//
// Layout: x and out are NCHW, as the port's modules hold them; the weights
// arrive as [Cout, 3, 3, C] (OHWI, rearranged and cast by the wrapper). The
// conv is an implicit GEMM over one image: M = output pixels, N = Cout,
// K = 9 taps x C. A block owns a tile of TH x TW = 8 x 16 output pixels and
// BN = 128 output channels. For each chunk of BK = 32 input channels it stages
// in shared memory (a) the activation of the tile's (TH + 2) x (TW + 2) halo,
// normalized + SiLU'd once in fp32 and cast to the compute dtype, with zeros
// outside the image, pixels as rows and channels contiguous, and (b) the nine
// taps' [BN x BK] weight slabs. Every tap's operand is then the halo shifted
// by (dy, dx) rows, read in place, so each input value is normalized about
// 1.4 times per output-channel tile instead of nine times. Ragged H, W and
// Cout are masked in the kernel.
//
// Products: bf16 through `ldmatrix` + `mma.sync` m16n8k16 (fp32
// accumulators; each warp 32 pixels x 64 channels); fp32 by scalar FMA over
// the same fragments' layout, which keeps fp32 results exact to summation
// order (no TF32). The bias is added in fp32 before the cast to the output,
// through a shared-memory staging of the tile so the NCHW stores coalesce.
//
// What bounds it on the H100: at C = Cout = 128 an output pixel costs
// 2 * 9 * 128 * 128 FLOPs against ~2 * 128 bytes of x read and written, about
// 576 FLOPs per byte, above the card's ~295: compute-bound on the tensor
// cores. This kernel has one shared-memory stage (the loads of a chunk do not
// overlap its products inside a block; two resident blocks an SM overlap each
// other; inside the load phase the weights copy asynchronously while the halo
// loads, issued in batches, are in flight) and no wgmma or TMA,
// so it sits far below the 989 TFLOP/s bf16 peak.

#include <cooperative_groups.h>

#include "gn_common.cuh"
#include "mma_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int TH = 8, TW = 16;                  // output tile: rows x columns of one image
constexpr int BM = TH * TW;                     // 128 output pixels
constexpr int BN = 128;                         // output channels per tile
constexpr int BK = 32;                          // input channels per chunk
constexpr int HALO_W = TW + 2, HALO = (TH + 2) * HALO_W;  // 180 halo pixels
constexpr int THREADS = 256;                    // 8 warps: 4 (pixel rows) x 2 (channel halves)
static_assert(BM == 4 * 32 && BN == 2 * 64 && TW == 16, "warp tiling: 2 tile rows x 64 channels a warp");

template <typename T>
struct ConvSmem {
  // rows padded so that 8 consecutive rows fall in distinct bank groups
  // (`ldmatrix` and the fp32 float4 reads are then conflict-free) and stay
  // 16-byte aligned
  static constexpr int LDK = std::is_same<T, bf16>::value ? BK + 8 : BK + 4;
  static constexpr int LDC = BM + 4;  // C tile [BN][LDC] fp32, pixels contiguous
  static constexpr int w_off = align_up(HALO * LDK * static_cast<int>(sizeof(T)), 128);
  static constexpr int ab_bytes = w_off + 9 * BN * LDK * static_cast<int>(sizeof(T));
  static constexpr int c_bytes = BN * LDC * 4;
  // the C tile reuses the halo and weight tiles once the K loop is done
  static constexpr int tile_bytes = align_up(ab_bytes > c_bytes ? ab_bytes : c_bytes, 128);
};

// Resident blocks an SM: two in bf16 (~105 KB of shared memory each, and at
// most 128 registers a thread); the fp32 tiles (~190 KB) leave room for one.
template <typename T>
constexpr int kBlocksPerSm = std::is_same<T, bf16>::value ? 2 : 1;

// Dynamic shared memory: the tiles, then a[C] and b[C], then the reduction
// scratch of row_stats (used by v2).
template <typename T>
int smem_bytes(int C) {
  return ConvSmem<T>::tile_bytes + 2 * C * 4 + 2 * (THREADS / 32) * 4;
}

template <typename T>
__device__ __forceinline__ float act(float v, float a, float b, bool silu) {
  const float y = fmaf(v, a, b);
  if (!silu) return y;
  if constexpr (std::is_same<T, bf16>::value) {
    return __fdividef(y, 1.f + __expf(-y));
  } else {
    return y / (1.f + expf(-y));
  }
}

__device__ __forceinline__ void store2(bf16* dst, float v0, float v1) {
  *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(v0, v1);
}
__device__ __forceinline__ void store2(float* dst, float v0, float v1) {
  *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
}

// Two values `stride` apart (two channels of one pixel), held as one pair.
template <typename T>
struct Pair;
template <>
struct Pair<bf16> {
  using type = __nv_bfloat162;
};
template <>
struct Pair<float> {
  using type = float2;
};

__device__ __forceinline__ __nv_bfloat162 load_pair(const bf16* p, int64_t stride) {
  return __halves2bfloat162(p[0], p[stride]);
}
__device__ __forceinline__ float2 load_pair(const float* p, int64_t stride) { return make_float2(p[0], p[stride]); }
__device__ __forceinline__ float2 to_f32x2(__nv_bfloat162 v) { return __bfloat1622float2(v); }
__device__ __forceinline__ float2 to_f32x2(float2 v) { return v; }

// acc[r][j][e]: this thread's outputs in the mma.sync C-fragment layout, for
// the warp's pixel row r (tile row 2 * wm + r, 16 pixels) and 8-channel group
// j (channels wn * 64 + 8 j ...): pixel g + 8 (e / 2), channel 2 tig + e % 2,
// with g = lane / 4 and tig = lane % 4.
using Acc = float[2][8][4];

// One chunk's products over the nine taps, bf16 on the tensor cores.
__device__ __forceinline__ void chunk_products(Acc& acc, const bf16* sx, const bf16* sw, int wm, int wn,
                                               int lane) {
  constexpr int LDK = ConvSmem<bf16>::LDK;
  // ldmatrix row addresses: A rows are pixels (lanes 0-15 rows 0-15 at k, lanes
  // 16-31 the same rows at k + 8); B rows are output channels (lanes 0-7 and
  // 16-23 rows 0-7 and 8-15 at k, lanes 8-15 and 24-31 the same at k + 8)
  const int a_row = lane % 16, a_k = 8 * (lane / 16);
  const int b_row = lane % 8 + 8 * (lane / 16), b_k = 8 * ((lane / 8) % 2);
#pragma unroll 1
  for (int tap = 0; tap < 9; ++tap) {
    const int dy = tap / 3, dx = tap % 3;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t a[2][4];
#pragma unroll
      for (int r = 0; r < 2; ++r)
        ldmatrix_x4(a[r], sx + ((2 * wm + r + dy) * HALO_W + a_row + dx) * LDK + kk + a_k);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        uint32_t b[4];
        ldmatrix_x4(b, sw + (tap * BN + wn * 64 + jj * 16 + b_row) * LDK + kk + b_k);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          mma_bf16(acc[r][2 * jj], a[r], b[0], b[1]);
          mma_bf16(acc[r][2 * jj + 1], a[r], b[2], b[3]);
        }
      }
    }
  }
}

// The same for fp32, by scalar FMA in k order.
__device__ __forceinline__ void chunk_products(Acc& acc, const float* sx, const float* sw, int wm, int wn,
                                               int lane) {
  constexpr int LDK = ConvSmem<float>::LDK;
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
template <typename T, bool kSilu>
__device__ void conv_tile(const T* __restrict__ xb, const float* sa, const float* sb, const T* __restrict__ wk,
                          const float* __restrict__ bias, T* __restrict__ ob, int C, int Cout, int H, int W,
                          int h0, int w0, int n0, unsigned char* smem) {
  using S = ConvSmem<T>;
  T* sx = reinterpret_cast<T*>(smem);
  T* sw = reinterpret_cast<T*>(smem + S::w_off);
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
    constexpr int VEC = 16 / sizeof(T), VECS = BK / VEC;
    for (int i = threadIdx.x; i < 9 * BN * VECS; i += THREADS) {
      const int v = i % VECS, row = i / VECS;  // row = tap * BN + n
      const int tap = row / BN, co = n0 + row % BN;
      const T* src = co < Cout ? wk + (static_cast<int64_t>(co) * 9 + tap) * C + c0 + v * VEC : wk;
      cp_async16(sw + row * S::LDK + v * VEC, src, co < Cout);
    }
    // the halo's activation: two channels of one pixel a task, neighbouring
    // threads on neighbouring pixels; a batch of tasks' loads is issued
    // before the first is used, so their latencies overlap
    constexpr int TASKS = HALO * (BK / 2), PER_THREAD = (TASKS + THREADS - 1) / THREADS;
    constexpr int BATCH = 6;  // tasks in flight: bounded by the 128 registers of two blocks an SM
    static_assert(PER_THREAD % BATCH == 0, "halo tasks must split into batches");
#pragma unroll 1
    for (int j0 = 0; j0 < PER_THREAD; j0 += BATCH) {
      typename Pair<T>::type raw[BATCH];
      unsigned inside = 0;  // bit j: task j0 + j lies in the image
#pragma unroll
      for (int j = 0; j < BATCH; ++j) {
        const int i = threadIdx.x + (j0 + j) * THREADS;
        const int k = 2 * (i / HALO), p = i % HALO;
        const int h = h0 - 1 + p / HALO_W, w = w0 - 1 + p % HALO_W;
        if (i < TASKS && h >= 0 && h < H && w >= 0 && w < W) {
          raw[j] = load_pair(xb + (c0 + k) * HW + static_cast<int64_t>(h) * W + w, HW);
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
          const float2 v = to_f32x2(raw[j]);
          v0 = act<T>(v.x, sa[c], sb[c], kSilu);
          v1 = act<T>(v.y, sa[c + 1], sb[c + 1], kSilu);
        }
        if (i < TASKS) store2(sx + p * S::LDK + k, v0, v1);
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
        sC[(wn * 64 + 8 * j + 2 * tig + e % 2) * S::LDC + (2 * wm + r) * TW + g + 8 * (e / 2)] = acc[r][j][e];
  __syncthreads();
  for (int i = threadIdx.x; i < BM * BN; i += THREADS) {
    const int n = i / BM, m = i % BM;
    const int h = h0 + m / TW, w = w0 + m % TW, co = n0 + n;
    if (h < H && w < W && co < Cout) {
      ob[co * HW + static_cast<int64_t>(h) * W + w] = from_f32<T>(sC[n * S::LDC + m] + bias[co]);
    }
  }
  __syncthreads();
}

template <typename T, bool kSilu>
__global__ void __launch_bounds__(THREADS, kBlocksPerSm<T>)
gn_conv_kernel(const T* __restrict__ x, const float* __restrict__ ab, const T* __restrict__ wk,
               const float* __restrict__ bias, T* __restrict__ out, int C, int Cout, int H, int W) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* sa = reinterpret_cast<float*>(smem + ConvSmem<T>::tile_bytes);
  float* sb = sa + C;
  const int b = blockIdx.z;
  const int64_t HW = static_cast<int64_t>(H) * W;
  for (int c = threadIdx.x; c < C; c += THREADS) {
    sa[c] = ab[static_cast<int64_t>(b) * 2 * C + c];
    sb[c] = ab[static_cast<int64_t>(b) * 2 * C + C + c];
  }
  __syncthreads();
  const int tiles_w = (W + TW - 1) / TW;
  conv_tile<T, kSilu>(x + b * C * HW, sa, sb, wk, bias, out + b * Cout * HW, C, Cout, H, W,
                      blockIdx.x / tiles_w * TH, blockIdx.x % tiles_w * TW, blockIdx.y * BN, smem);
}

template <typename T, bool kSilu>
__global__ void __launch_bounds__(THREADS, kBlocksPerSm<T>)
gn_conv_v2_kernel(const T* __restrict__ x, const float* __restrict__ gn_w, const float* __restrict__ gn_b,
                  const T* __restrict__ wk, const float* __restrict__ bias, T* __restrict__ out, float* stats,
                  int B, int C, int Cout, int H, int W, int groups, float eps) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* sa = reinterpret_cast<float*>(smem + ConvSmem<T>::tile_bytes);
  float* sb = sa + C;
  float* red = sb + C;
  const int64_t HW = static_cast<int64_t>(H) * W;

  // phase 1: per-channel (sum x, sum x^2), one (b, c) row per block at a time
  for (int r = blockIdx.x; r < B * C; r += gridDim.x) {
    float s, ss;
    row_stats<T, THREADS>(x + static_cast<int64_t>(r) * HW, HW, red, &s, &ss);
    if (threadIdx.x == 0) {
      const int b = r / C, c = r % C;
      stats[static_cast<int64_t>(b) * 2 * C + c] = s;
      stats[static_cast<int64_t>(b) * 2 * C + C + c] = ss;
    }
  }
  __threadfence();
  cg::this_grid().sync();

  // phase 2: fold the groups of the tile's image into a, b (whenever the
  // image changes), then v1's conv body
  const int tiles_w = (W + TW - 1) / TW;
  const int tiles_hw = (H + TH - 1) / TH * tiles_w;
  const int per_image = tiles_hw * ((Cout + BN - 1) / BN);
  const int gs = C / groups;
  const float count = static_cast<float>(HW * gs);
  int folded = -1;
  for (int t = blockIdx.x; t < B * per_image; t += gridDim.x) {
    const int b = t / per_image, rem = t % per_image;
    if (b != folded) {
      const float* st = stats + static_cast<int64_t>(b) * 2 * C;
      for (int c = threadIdx.x; c < C; c += THREADS) {
        const int g0 = c / gs * gs;
        float gsum = 0.f, gsq = 0.f;
        for (int j = 0; j < gs; ++j) {  // L2 reads: written by other blocks before the barrier
          gsum += __ldcg(st + g0 + j);
          gsq += __ldcg(st + C + g0 + j);
        }
        const float mean = gsum / count;
        const float var = fmaxf(gsq / count - mean * mean, 0.f);
        const float a = rsqrtf(var + eps) * gn_w[c];
        sa[c] = a;
        sb[c] = gn_b[c] - mean * a;
      }
      __syncthreads();
      folded = b;
    }
    const int pix = rem % tiles_hw;
    conv_tile<T, kSilu>(x + b * C * HW, sa, sb, wk, bias, out + b * Cout * HW, C, Cout, H, W,
                        pix / tiles_w * TH, pix % tiles_w * TW, rem / tiles_hw * BN, smem);
  }
}

template <typename T, bool kSilu>
int launch_v1(const void* x, const float* ab, const void* wk, const float* bias, void* out, int B, int C,
              int Cout, int H, int W, cudaStream_t stream) {
  auto kernel = gn_conv_kernel<T, kSilu>;
  const int bytes = smem_bytes<T>(C);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t tiles_hw = static_cast<int64_t>((H + TH - 1) / TH) * ((W + TW - 1) / TW);
  dim3 grid(static_cast<unsigned>(tiles_hw), (Cout + BN - 1) / BN, B);
  kernel<<<grid, THREADS, bytes, stream>>>(static_cast<const T*>(x), ab, static_cast<const T*>(wk), bias,
                                           static_cast<T*>(out), C, Cout, H, W);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool kSilu>
int launch_v2(const void* x, const float* gn_w, const float* gn_b, const void* wk, const float* bias, void* out,
              float* stats, int B, int C, int Cout, int H, int W, int groups, float eps, cudaStream_t stream) {
  auto kernel = gn_conv_v2_kernel<T, kSilu>;
  const int bytes = smem_bytes<T>(C);
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
  // the persistent grid: every block resident at once (the barrier needs it),
  // and no more blocks than the larger phase has work items
  const int64_t tiles =
      static_cast<int64_t>(B) * ((H + TH - 1) / TH) * ((W + TW - 1) / TW) * ((Cout + BN - 1) / BN);
  int64_t work = static_cast<int64_t>(B) * C;
  if (tiles > work) work = tiles;
  int64_t blocks = static_cast<int64_t>(per_sm) * sms;
  if (work < blocks) blocks = work;
  const T* xp = static_cast<const T*>(x);
  const T* wp = static_cast<const T*>(wk);
  T* op = static_cast<T*>(out);
  void* args[] = {&xp, &gn_w, &gn_b, &wp, &bias, &op, &stats, &B, &C, &Cout, &H, &W, &groups, &eps};
  err = cudaLaunchCooperativeKernel(kernel, dim3(static_cast<unsigned>(blocks)), dim3(THREADS), args, bytes, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (x, wk and out); silu: 0 or 1. x:
// contiguous [B, C, H, W]; ab: contiguous fp32 [B, 2, C] (a, then b); wk:
// contiguous [Cout, 3, 3, C]; bias: fp32 [Cout]; out: contiguous
// [B, Cout, H, W]. C must be a multiple of 32. Returns 0, a cudaError_t from
// the launch, or -1 for unsupported arguments. Launches on `stream` and does
// not synchronise.
int e2eft_gn_silu_conv3x3(const void* x, const float* ab, const void* wk, const float* bias, void* out,
                          int dtype, int silu, int B, int C, int Cout, int H, int W, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (C % BK != 0) return -1;
  if (dtype == 0 && silu) return launch_v1<float, true>(x, ab, wk, bias, out, B, C, Cout, H, W, st);
  if (dtype == 0) return launch_v1<float, false>(x, ab, wk, bias, out, B, C, Cout, H, W, st);
  if (dtype == 1 && silu) return launch_v1<bf16, true>(x, ab, wk, bias, out, B, C, Cout, H, W, st);
  if (dtype == 1) return launch_v1<bf16, false>(x, ab, wk, bias, out, B, C, Cout, H, W, st);
  return -1;
}

// v2: as e2eft_gn_silu_conv3x3, from the GroupNorm's fp32 weight and bias
// [C] instead of ab; `stats` is fp32 scratch of [B, 2, C] that the kernel
// overwrites. C must be a multiple of 32 and of `groups`. Returns as above,
// and -2 when the device cannot launch cooperatively, -3 when one block does
// not fit on an SM.
int e2eft_gn_silu_conv3x3_v2(const void* x, const float* gn_w, const float* gn_b, const void* wk,
                             const float* bias, void* out, float* stats, int dtype, int silu, int B, int C,
                             int Cout, int H, int W, int groups, float eps, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (C % BK != 0 || groups < 1 || C % groups != 0) return -1;
  if (dtype == 0 && silu)
    return launch_v2<float, true>(x, gn_w, gn_b, wk, bias, out, stats, B, C, Cout, H, W, groups, eps, st);
  if (dtype == 0)
    return launch_v2<float, false>(x, gn_w, gn_b, wk, bias, out, stats, B, C, Cout, H, W, groups, eps, st);
  if (dtype == 1 && silu)
    return launch_v2<bf16, true>(x, gn_w, gn_b, wk, bias, out, stats, B, C, Cout, H, W, groups, eps, st);
  if (dtype == 1)
    return launch_v2<bf16, false>(x, gn_w, gn_b, wk, bias, out, stats, B, C, Cout, H, W, groups, eps, st);
  return -1;
}

}  // extern "C"
