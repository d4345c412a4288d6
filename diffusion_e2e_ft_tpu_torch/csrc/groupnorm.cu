// GroupNorm statistics for Hopper (sm_90a): per-channel fp32 (sum x, sum x^2);
// below them, the GroupNorm apply that turns those sums into the normalized,
// affine (+SiLU) output; last, the whole GroupNorm in one cluster launch where
// a group fits on chip, and the one C entry point (e2eft_group_norm) that
// takes either that launch or the two kernels.
//
// Replaces diffusion_e2e_ft_tpu/kernels/groupnorm.py::_stats_kernel (launched
// there by _channel_stats). Same result: for x [B, C, N] (N = H * W) in fp32
// or bf16, out[b, 0, c] = sum_n x and out[b, 1, c] = sum_n x^2, accumulated in
// fp32. The TPU kernel carries a [2, C] accumulator across a sequential grid
// axis of row blocks of a [B, N, C] array; the port keeps the module's NCHW
// layout, where the N values of one (b, c) are contiguous, so each (b, c) row
// is reduced on its own: no carry, no atomics, a fixed summation order.
// Ragged N needs no zero-padding copy: the row's head and tail outside the
// 16-byte vectors are read one value at a time.
//
// What bounds it on the H100: one read of x, no reuse, about one FLOP per
// byte. At the 480x640 train step's largest decoder layer, [2, 128, 480, 640]
// bf16, that is 157 MB, or ~0.047 ms at 3.35 TB/s: only bytes in flight
// matter. Design:
// - each thread keeps 4 independent 16-byte loads in flight (an unrolled
//   loop over the row; streaming loads, x is read once);
// - a long row is split over a thread-block cluster of `parts` blocks, so
//   that the grid fills about one wave of resident blocks (kStatsBlocksPerSm
//   an SM) without passing it: kStatsMaxParts at most, each segment at least
//   kStatsMinSegment values, `parts` a function of the shape and the card's
//   SM count alone. At [2, 128, 480, 640] on 132 SMs: 256 rows x 4 parts =
//   1024 blocks, not 256 (one 512-thread block a row, one 16-byte load in
//   flight a thread, fills fewer than two blocks an SM). Each block reduces
//   its run of whole vectors into shared memory, and block 0 of the cluster
//   adds the parts' sums in rank order through distributed shared memory:
//   one input always gives the same bits.

#include <cooperative_groups.h>

#include "gn_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kStatsThreads = 256;
constexpr int kStatsMaxParts = 8;         // blocks a row at most (a portable cluster size)
constexpr int kStatsMinSegment = 16384;   // values a block at least, before a row is split further
constexpr int kStatsBlocksPerSm = 8;      // resident blocks an SM (2048 threads)

int stats_parts(int64_t rows, int64_t n, int sms) {
  int parts = 1;
  while (parts < kStatsMaxParts && n / (2 * parts) >= kStatsMinSegment &&
         rows * parts * 2 <= static_cast<int64_t>(sms) * kStatsBlocksPerSm)
    parts *= 2;
  return parts;
}

template <typename T>
__global__ void __launch_bounds__(kStatsThreads)
channel_stats_kernel(const T* __restrict__ x, float* __restrict__ out, int C, int64_t n, int parts) {
  __shared__ float red[2 * kStatsThreads / 32];
  __shared__ float part_sums[2];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int row = blockIdx.x / parts;  // b * C + c
  float s, ss;
  segment_stats<T, kStatsThreads>(x + static_cast<int64_t>(row) * n, n, rank, parts, red, &s, &ss);
  if (threadIdx.x == 0) {
    part_sums[0] = s;
    part_sums[1] = ss;
  }
  cluster.sync();
  if (rank == 0 && threadIdx.x == 0) {
    float ts = 0.f, tss = 0.f;
    for (int r = 0; r < parts; ++r) {  // rank order: the same bits every call
      const float* p = cluster.map_shared_rank(part_sums, r);
      ts += p[0];
      tss += p[1];
    }
    const int b = row / C, c = row % C;
    out[static_cast<int64_t>(b) * 2 * C + c] = ts;
    out[static_cast<int64_t>(b) * 2 * C + C + c] = tss;
  }
  cluster.sync();  // no block leaves while block 0 reads its shared memory
}

constexpr int kMaxDevices = 64;

// The current device and its SM count, asked of CUDA once a device: every
// launch of the statistics and the one-launch GroupNorm needs the count.
cudaError_t current_sms(int* device, int* sms) {
  static int cached[kMaxDevices] = {};
  cudaError_t err = cudaGetDevice(device);
  if (err != cudaSuccess) return err;
  if (*device < 0 || *device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (cached[*device] == 0) {
    err = cudaDeviceGetAttribute(&cached[*device], cudaDevAttrMultiProcessorCount, *device);
    if (err != cudaSuccess) return err;
  }
  *sms = cached[*device];
  return cudaSuccess;
}

template <typename T>
int launch(const void* x, float* out, int B, int C, int64_t n, cudaStream_t stream) {
  int device = 0, sms = 0;
  cudaError_t err = current_sms(&device, &sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int parts = stats_parts(static_cast<int64_t>(B) * C, n, sms);
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(static_cast<unsigned>(static_cast<int64_t>(B) * C * parts));
  config.blockDim = dim3(kStatsThreads);
  config.dynamicSmemBytes = 0;
  config.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = parts;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  err = cudaLaunchKernelEx(&config, channel_stats_kernel<T>, static_cast<const T*>(x), out, C, n, parts);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. x: contiguous [B, C, n]; out: contiguous
// fp32 [B, 2, C]. Returns 0, a cudaError_t from the launch, or -1 for an
// unsupported dtype. Launches on `stream` and does not synchronise.
int e2eft_gn_channel_stats(const void* x, float* out, int dtype, int B, int C, int64_t n, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, out, B, C, n, st);
  if (dtype == 1) return launch<bf16>(x, out, B, C, n, st);
  return -1;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// GroupNorm apply for Hopper (sm_90a): y = act(x * a + b) per (b, c), with
// a, b folded from the statistics above.
//
// Replaces no Pallas kernel. It replaces the XLA normalize + affine + SiLU
// fusion that follows _stats_kernel in
// diffusion_e2e_ft_tpu/kernels/groupnorm.py::_pallas_group_norm (:141-148):
// with it, a standalone GroupNorm on the card is two launches (statistics,
// apply) where the plain PyTorch version is about twenty eager passes. Same
// result as kernels/groupnorm.py::group_norm_apply_reference: for x
// [B, C, n] in fp32 or bf16, the [B, 2, C] fp32 sums of e2eft_gn_channel_stats,
// the affine [C] in fp32 or bf16 (read in its own dtype, so a bf16 module
// needs no cast a call), each (b, c) gets a = rsqrt(var + eps) * w and
// b = bias - mean * a from its group's sums (`fold_channel`, gn_common.cuh,
// the group's channels added in channel order as `fold_groups` does); then
// y = x * a + b, optionally y * sigmoid(y) with expf (not the conv kernels'
// tanh.approx), in fp32, stored in x's dtype.
//
// What bounds it on the H100: one read of x and one write of y, 2 |x| bytes
// and a few FLOPs a value. At Marigold 768x768's largest GroupNorm,
// [1, 256, 768, 768] bf16 in the decoder, |x| is 302 MB, so 604 MB a call,
// ~0.180 ms at 3.35 TB/s: only bytes in flight matter. Design:
// - the decoder's full-resolution inputs have 256 or 128 rows of 589,824
//   values, so a row is cut into segments of kApplySegmentBytes (a block
//   each): 36 blocks a row there, 9216 or 4608 in all, several waves of
//   resident blocks on 132 SMs;
// - a block folds its channel's a, b once (thread 0, into shared memory),
//   then streams its segment's 16-byte vectors, kApplyUnroll loads in flight
//   a thread; segment 0 also takes the row's scalar head (up to the first
//   16-byte boundary) and the last segment the scalar tail, as
//   `segment_partial` cuts a row. y's rows have x's alignment when the two
//   base pointers agree modulo 16 (`vec`); otherwise every value of a row
//   goes the scalar way in segment 0.
// No sums across threads: every output is one fma (and the SiLU) of its
// input, so one input always gives the same bits.

namespace {

constexpr int kApplyThreads = 256;
constexpr int kApplyUnroll = 4;
constexpr int kApplySegmentBytes = 32768;  // bytes of x a block at most: 8 vectors a thread

template <typename T>
__device__ __forceinline__ T from_f32(float v) {
  if constexpr (std::is_same<T, float>::value) {
    return v;
  } else {
    return __float2bfloat16(v);
  }
}

template <bool SILU>
__device__ __forceinline__ float apply_one(float v, float a, float b) {
  const float y = fmaf(v, a, b);
  if constexpr (SILU) {
    return y * (1.f / (1.f + expf(-y)));
  } else {
    return y;
  }
}

template <typename T, bool SILU>
__device__ __forceinline__ uint4 apply_vec(const uint4& raw, float a, float b) {
  constexpr int VEC = 16 / sizeof(T);
  const T* v = reinterpret_cast<const T*>(&raw);
  uint4 out;
  T* o = reinterpret_cast<T*>(&out);
#pragma unroll
  for (int j = 0; j < VEC; ++j) o[j] = from_f32<T>(apply_one<SILU>(to_f32(v[j]), a, b));
  return out;
}

template <typename T, typename TA, bool SILU>
__global__ void __launch_bounds__(kApplyThreads)
gn_apply_kernel(const T* __restrict__ x, const float* __restrict__ stats, const TA* __restrict__ w,
                const TA* __restrict__ bias, T* __restrict__ y, int C, int groups, int64_t n, int segs, float eps,
                bool vec) {
  constexpr int VEC = 16 / sizeof(T);
  __shared__ float ab[2];
  const int64_t row = static_cast<int64_t>(blockIdx.x) / segs;  // b * C + c
  const int seg = static_cast<int>(static_cast<int64_t>(blockIdx.x) % segs);
  if (threadIdx.x == 0) {
    const int c = static_cast<int>(row % C), gs = C / groups, g0 = c / gs * gs;
    const float* st = stats + row / C * 2 * C;
    float gsum = 0.f, gsq = 0.f;
    for (int j = 0; j < gs; ++j) {
      gsum += st[g0 + j];
      gsq += st[C + g0 + j];
    }
    fold_channel(gsum, gsq, static_cast<float>(n * gs), eps, to_f32(w[c]), to_f32(bias[c]), 1.f, &ab[0], &ab[1]);
  }
  __syncthreads();
  const float a = ab[0], b = ab[1];
  const T* xr = x + row * n;
  T* yr = y + row * n;
  int64_t head = vec ? static_cast<int64_t>(((16 - (reinterpret_cast<uintptr_t>(xr) & 15)) & 15) / sizeof(T)) : n;
  if (head > n) head = n;
  const int64_t nvec = (n - head) / VEC;
  if (seg == 0) {
    for (int64_t i = threadIdx.x; i < head; i += kApplyThreads)
      yr[i] = from_f32<T>(apply_one<SILU>(to_f32(xr[i]), a, b));
  }
  const uint4* xb = reinterpret_cast<const uint4*>(xr + head);
  uint4* yb = reinterpret_cast<uint4*>(yr + head);
  const int64_t v0 = nvec * seg / segs, v1 = nvec * (seg + 1) / segs;
  int64_t i = v0 + threadIdx.x;
  for (; i + (kApplyUnroll - 1) * kApplyThreads < v1; i += kApplyUnroll * kApplyThreads) {
    uint4 raw[kApplyUnroll];
#pragma unroll
    for (int u = 0; u < kApplyUnroll; ++u) raw[u] = __ldg(xb + i + u * kApplyThreads);
#pragma unroll
    for (int u = 0; u < kApplyUnroll; ++u) yb[i + u * kApplyThreads] = apply_vec<T, SILU>(raw[u], a, b);
  }
  for (; i < v1; i += kApplyThreads) yb[i] = apply_vec<T, SILU>(__ldg(xb + i), a, b);
  if (seg == segs - 1) {
    for (int64_t j = head + nvec * VEC + threadIdx.x; j < n; j += kApplyThreads)
      yr[j] = from_f32<T>(apply_one<SILU>(to_f32(xr[j]), a, b));
  }
}

template <typename T, typename TA, bool SILU>
int launch_apply(const void* x, const float* stats, const void* w, const void* b, void* out, int B, int C,
                 int64_t n, int groups, float eps, cudaStream_t stream) {
  const int64_t seg_values = kApplySegmentBytes / static_cast<int64_t>(sizeof(T));
  const int64_t segs = (n + seg_values - 1) / seg_values;
  const int64_t blocks = static_cast<int64_t>(B) * C * segs;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  const bool vec = ((reinterpret_cast<uintptr_t>(x) ^ reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  gn_apply_kernel<T, TA, SILU><<<static_cast<unsigned>(blocks), kApplyThreads, 0, stream>>>(
      static_cast<const T*>(x), stats, static_cast<const TA*>(w), static_cast<const TA*>(b), static_cast<T*>(out),
      C, groups, n, static_cast<int>(segs), eps, vec);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename TA>
int launch_apply_silu(const void* x, const float* stats, const void* w, const void* b, void* out, int B, int C,
                      int64_t n, int groups, float eps, int silu, cudaStream_t stream) {
  if (silu) return launch_apply<T, TA, true>(x, stats, w, b, out, B, C, n, groups, eps, stream);
  return launch_apply<T, TA, false>(x, stats, w, b, out, B, C, n, groups, eps, stream);
}

}  // namespace

extern "C" {

// dtype (x and out) and affine_dtype (w and b): 0 = float32, 1 = bfloat16.
// x, out: contiguous [B, C, n]; stats: contiguous fp32 [B, 2, C] (sum x,
// sum x^2 a channel); w, b: [C]; C a multiple of groups. Returns 0, a
// cudaError_t from the launch, or -1 for an unsupported dtype. Launches on
// `stream` and does not synchronise.
int e2eft_gn_apply(const void* x, const float* stats, const void* w, const void* b, void* out, int dtype,
                   int affine_dtype, int B, int C, int64_t n, int groups, float eps, int silu, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (groups <= 0 || C % groups != 0) return -1;
  if (dtype == 0 && affine_dtype == 0)
    return launch_apply_silu<float, float>(x, stats, w, b, out, B, C, n, groups, eps, silu, st);
  if (dtype == 0 && affine_dtype == 1)
    return launch_apply_silu<float, bf16>(x, stats, w, b, out, B, C, n, groups, eps, silu, st);
  if (dtype == 1 && affine_dtype == 0)
    return launch_apply_silu<bf16, float>(x, stats, w, b, out, B, C, n, groups, eps, silu, st);
  if (dtype == 1 && affine_dtype == 1)
    return launch_apply_silu<bf16, bf16>(x, stats, w, b, out, B, C, n, groups, eps, silu, st);
  return -1;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// The whole GroupNorm in one launch for Hopper (sm_90a): statistics, fold,
// affine and SiLU of one (b, g) slab by one thread-block cluster, the slab
// held in the cluster's shared memory between its one read and its one write.
//
// Replaces diffusion_e2e_ft_tpu/kernels/groupnorm.py::_stats_kernel and the
// XLA normalize + affine + SiLU that follows it in _pallas_group_norm
// (:131-148), wherever a group fits on chip; the same function as
// kernels/groupnorm.py::group_norm_reference: fp32 sums of x and x^2 over
// the group, var = E[x^2] - E[x]^2 clamped at 0, a = rsqrt(var + eps) * w,
// b = bias - mean * a (`fold_channel`, the count and eps of the route), then
// y = x * a + b and optionally y * sigmoid(y) with expf, in fp32, stored in
// x's dtype. The affine is read in its own dtype, fp32 or bf16.
//
// What bounds it on the H100: one read of x and one write of y, 2 |x| bytes
// (the statistics kernel + apply route moves 3 |x|), about ten fp32
// operations a value with the SiLU. At the UNet's shapes, [1, 1280, 12, 12]
// to [1, 960, 96, 96] in bf16, that is 0.74-35 MB a call, or 0.22-10.6 us
// at 3.35 TB/s: at B = 1 the launch and the host path around it, not the
// card, set the time, so the design is one launch a GroupNorm, not two.
// In NCHW the gs = C / groups channels of one image's group form one
// contiguous slab of gs * n values. Design:
// - one cluster of `parts` blocks a slab (`group_parts`): a block's share of
//   the slab's 16-byte vectors fits kGroupSmemBytes of shared memory beside
//   the group's per-channel a, b; slabs that need more than kGroupMaxParts
//   blocks (the VAE's 384x384 and 768x768 layers) keep the route. Within
//   that, `parts` grows while each share keeps kGroupMinShareBytes and the
//   grid stays within one block an SM: at B = 1 (32 slabs) a large slab takes
//   4 blocks, a small one 1;
// - thread 0 issues the share as bulk asynchronous copies (`cp.async.bulk`)
//   of kGroupChunkBytes, each completing on its own mbarrier, so the block
//   adds a chunk's values while the next ones land; the slab's scalar head
//   (up to its first 16-byte boundary) and tail are read directly by the
//   first and last rank, as `segment_partial` cuts a row;
// - each block reduces its partial fp32 sums in a fixed order (each thread's
//   vectors in index order, the warp butterfly, the warps in order); after a
//   cluster barrier each block adds all ranks' partials in rank order
//   through distributed shared memory, so every block holds the same bits of
//   the group's sums and one input always gives the same output; a cluster
//   barrier before exit keeps each block's partial sums alive until every
//   rank has read them;
// - each block folds the group's a, b per channel into shared memory, then
//   applies them to its share from shared memory and stores y with 16-byte
//   streaming stores (scalar stores when y's base is not aligned like x's);
// - at the VAE's larger slabs a block holds up to 147 KB, one block an SM:
//   1024 threads keep enough shared-memory reads and SiLU arithmetic in
//   flight (perf/torch_gn_group_variants.py, an H100 SXM at 700 W, calls back
//   to back: [1, 512, 192, 192] bf16 0.071 ms with 1024 threads, 0.085 with
//   512; unrolling the loops by 4 moved neither).

namespace {

constexpr int kGroupThreads = 1024;
constexpr int kGroupMaxParts = 8;           // blocks a slab at most (a portable cluster size)
constexpr int kGroupSmemBytes = 229376;     // dynamic shared memory a block at most: its share, then a, b (224 KiB)
constexpr int kGroupMinShareBytes = 16384;  // bytes of a share at least, before a slab is split further
constexpr int kGroupChunkBytes = 16384;     // bytes of one bulk copy, each on its own mbarrier
constexpr int kGroupMaxChunks = kGroupSmemBytes / kGroupChunkBytes;

// Bytes of the largest share of a slab's 16-byte vectors among `parts` blocks, and of a block's dynamic shared
// memory: that share, then the group's gs per-channel a and b in fp32.
__host__ __device__ __forceinline__ int64_t group_share_bytes(int64_t slab_bytes, int parts) {
  return (slab_bytes / 16 + parts - 1) / parts * 16;
}

int64_t group_smem(int64_t slab_bytes, int gs, int parts) { return group_share_bytes(slab_bytes, parts) + 8LL * gs; }

// Blocks (a cluster) that take one of `rows` slabs of slab_bytes bytes (gs channels) on a card of `sms` SMs;
// 0: the slab does not fit kGroupMaxParts blocks, and the GroupNorm takes the two-kernel route. Whether a slab
// fits depends on its bytes and gs alone; the card sets only how far a fitting slab is split.
int group_parts(int64_t rows, int64_t slab_bytes, int gs, int sms) {
  int parts = 1;
  while (group_smem(slab_bytes, gs, parts) > kGroupSmemBytes) {
    if (parts == kGroupMaxParts) return 0;
    parts *= 2;
  }
  while (parts < kGroupMaxParts && slab_bytes / (2 * parts) >= kGroupMinShareBytes && rows * parts * 2 <= sms)
    parts *= 2;
  return parts;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// bytes (a multiple of 16) from global src to shared dst, both 16-byte aligned, completing on `bar`
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes, uint64_t* bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes), "r"(smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void cluster_arrive() { asm volatile("barrier.cluster.arrive.aligned;" ::: "memory"); }
__device__ __forceinline__ void cluster_wait() { asm volatile("barrier.cluster.wait.aligned;" ::: "memory"); }

// act(v * a + b) of one 16-byte vector whose first value is value e of the slab, with the per-channel a, b of
// the group's channels (n values a channel); a vector may cross channel boundaries.
template <typename T, bool SILU>
__device__ __forceinline__ uint4 apply_slab_vec(const uint4& raw, uint32_t e, uint32_t n, const float* sa,
                                                const float* sb) {
  constexpr int VEC = 16 / sizeof(T);
  const uint32_t c = e / n;
  if (e - c * n + VEC <= n) return apply_vec<T, SILU>(raw, sa[c], sb[c]);
  const T* v = reinterpret_cast<const T*>(&raw);
  uint4 out;
  T* o = reinterpret_cast<T*>(&out);
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    const uint32_t cj = (e + j) / n;
    o[j] = from_f32<T>(apply_one<SILU>(to_f32(v[j]), sa[cj], sb[cj]));
  }
  return out;
}

template <typename T, typename TA, bool SILU>
__global__ void __launch_bounds__(kGroupThreads)
gn_group_kernel(const T* __restrict__ x, const TA* __restrict__ w, const TA* __restrict__ bias, T* __restrict__ y,
                int groups, int gs, int64_t n, int parts, float eps, bool vec) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int WARPS = kGroupThreads / 32;
  constexpr int CHUNK_VECS = kGroupChunkBytes / 16;
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t bars[kGroupMaxChunks];
  __shared__ float red[2 * WARPS];
  __shared__ float part_sums[2];
  __shared__ float group_sums[2];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int64_t row = blockIdx.x / parts;  // b * groups + g
  const int64_t len = static_cast<int64_t>(gs) * n;
  const T* xs = x + row * len;
  T* ys = y + row * len;
  int64_t head = static_cast<int64_t>(((16 - (reinterpret_cast<uintptr_t>(xs) & 15)) & 15) / sizeof(T));
  if (head > len) head = len;
  const int64_t nvec = (len - head) / VEC;
  const int64_t v0 = nvec * rank / parts;
  const int share = static_cast<int>(nvec * (rank + 1) / parts - v0);  // vectors of this block
  const int chunks = (share + CHUNK_VECS - 1) / CHUNK_VECS;
  const uint4* src = reinterpret_cast<const uint4*>(xs + head) + v0;
  uint4* buf = reinterpret_cast<uint4*>(smem);
  float* sa = reinterpret_cast<float*>(smem + group_share_bytes(len * static_cast<int64_t>(sizeof(T)), parts));
  float* sb = sa + gs;

  if (threadIdx.x == 0) {
    for (int k = 0; k < chunks; ++k) mbar_init(&bars[k], 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    for (int k = 0; k < chunks; ++k) {
      const int first = k * CHUNK_VECS;
      const uint32_t bytes = static_cast<uint32_t>(min(CHUNK_VECS, share - first)) * 16u;
      mbar_expect_tx(&bars[k], bytes);
      bulk_load(buf + first, src + first, bytes, &bars[k]);
    }
  }
  __syncthreads();  // the barriers are initialised before any thread waits on them

  // this block's partial sums: the scalar head (rank 0), its share as the chunks land, the scalar tail (last rank)
  float s = 0.f, ss = 0.f;
  const int64_t tail = head + nvec * VEC;
  if (rank == 0) {
    for (int64_t i = threadIdx.x; i < head; i += kGroupThreads) {
      const float v = to_f32(xs[i]);
      s += v;
      ss = fmaf(v, v, ss);
    }
  }
  int landed = 0;
  for (int i = threadIdx.x; i < share; i += kGroupThreads) {
    while (i >= landed * CHUNK_VECS) mbar_wait(&bars[landed++], 0);
    add_vec<T>(buf[i], s, ss);
  }
  if (rank == parts - 1) {
    for (int64_t i = tail + threadIdx.x; i < len; i += kGroupThreads) {
      const float v = to_f32(xs[i]);
      s += v;
      ss = fmaf(v, v, ss);
    }
  }
  warp_sums(s, ss);
  if (threadIdx.x % 32 == 0) {
    red[threadIdx.x / 32] = s;
    red[WARPS + threadIdx.x / 32] = ss;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float ts = 0.f, tss = 0.f;
    for (int k = 0; k < WARPS; ++k) {
      ts += red[k];
      tss += red[WARPS + k];
    }
    part_sums[0] = ts;
    part_sums[1] = tss;
  }
  cluster.sync();  // every rank's partial sums are in its shared memory
  if (threadIdx.x == 0) {
    float ts = 0.f, tss = 0.f;
    for (int r = 0; r < parts; ++r) {  // rank order: every block, every call, the same bits
      const float* p = cluster.map_shared_rank(part_sums, r);
      ts += p[0];
      tss += p[1];
    }
    group_sums[0] = ts;
    group_sums[1] = tss;
  }
  cluster_arrive();  // this block is done reading the other ranks' shared memory
  __syncthreads();
  const int c0 = static_cast<int>(row % groups) * gs;
  for (int j = threadIdx.x; j < gs; j += kGroupThreads)
    fold_channel(group_sums[0], group_sums[1], static_cast<float>(len), eps, to_f32(w[c0 + j]),
                 to_f32(bias[c0 + j]), 1.f, &sa[j], &sb[j]);
  __syncthreads();

  const uint32_t n32 = static_cast<uint32_t>(n);
  const uint32_t e0 = static_cast<uint32_t>(head + v0 * VEC);  // slab index of this share's first value
  for (int i = threadIdx.x; i < share; i += kGroupThreads) {
    const uint32_t e = e0 + static_cast<uint32_t>(i) * VEC;
    const uint4 out = apply_slab_vec<T, SILU>(buf[i], e, n32, sa, sb);
    if (vec) {
      __stcs(reinterpret_cast<uint4*>(ys + e), out);
    } else {
      const T* o = reinterpret_cast<const T*>(&out);
#pragma unroll
      for (int j = 0; j < VEC; ++j) ys[e + j] = o[j];
    }
  }
  if (rank == 0) {
    for (int64_t i = threadIdx.x; i < head; i += kGroupThreads) {
      const int c = static_cast<int>(i / n);
      ys[i] = from_f32<T>(apply_one<SILU>(to_f32(xs[i]), sa[c], sb[c]));
    }
  }
  if (rank == parts - 1) {
    for (int64_t i = tail + threadIdx.x; i < len; i += kGroupThreads) {
      const int c = static_cast<int>(i / n);
      ys[i] = from_f32<T>(apply_one<SILU>(to_f32(xs[i]), sa[c], sb[c]));
    }
  }
  cluster_wait();  // no block leaves while another rank may still read its partial sums
}

template <typename T, typename TA, bool SILU>
int launch_group(const void* x, const void* w, const void* b, void* out, int B, int groups, int gs, int64_t n,
                 int parts, float eps, int device, cudaStream_t stream) {
  static bool sized[kMaxDevices] = {};
  auto kernel = gn_group_kernel<T, TA, SILU>;
  if (!sized[device]) {
    const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kGroupSmemBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    sized[device] = true;
  }
  const int64_t blocks = static_cast<int64_t>(B) * groups * parts;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(static_cast<unsigned>(blocks));
  config.blockDim = dim3(kGroupThreads);
  config.dynamicSmemBytes = static_cast<size_t>(group_smem(gs * n * static_cast<int64_t>(sizeof(T)), gs, parts));
  config.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = parts;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  const bool vec = ((reinterpret_cast<uintptr_t>(x) ^ reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  const cudaError_t err = cudaLaunchKernelEx(&config, kernel, static_cast<const T*>(x), static_cast<const TA*>(w),
                                             static_cast<const TA*>(b), static_cast<T*>(out), groups, gs, n, parts,
                                             eps, vec);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename TA>
int launch_group_silu(const void* x, const void* w, const void* b, void* out, int B, int groups, int gs, int64_t n,
                      int parts, float eps, int silu, int device, cudaStream_t stream) {
  if (silu) return launch_group<T, TA, true>(x, w, b, out, B, groups, gs, n, parts, eps, device, stream);
  return launch_group<T, TA, false>(x, w, b, out, B, groups, gs, n, parts, eps, device, stream);
}

}  // namespace

extern "C" {

// A whole GroupNorm(+SiLU), one C call. dtype (x and out) and affine_dtype
// (w and b): 0 = float32, 1 = bfloat16. x, out: contiguous [B, C, n]; w, b:
// [C]; C a multiple of groups. Where `group_parts` takes the (b, g) slab, one
// launch of gn_group_kernel; elsewhere the statistics kernel into `stats`
// (contiguous fp32 [B, 2, C], which the caller allocates for those shapes
// alone; null otherwise), then the apply kernel. Returns 0, a cudaError_t
// from a launch, or -1 for unsupported arguments (a null `stats` where the
// route needs it). Launches on `stream` and does not synchronise.
int e2eft_group_norm(const void* x, const void* w, const void* b, void* out, float* stats, int dtype,
                     int affine_dtype, int B, int C, int64_t n, int groups, float eps, int silu, void* stream) {
  if (groups <= 0 || C % groups != 0 || dtype < 0 || dtype > 1 || affine_dtype < 0 || affine_dtype > 1) return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int device = 0, sms = 0;
  const cudaError_t err = current_sms(&device, &sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int gs = C / groups;
  const int64_t slab_bytes = gs * n * (dtype == 0 ? 4 : 2);
  const int parts = group_parts(static_cast<int64_t>(B) * groups, slab_bytes, gs, sms);
  if (parts == 0) {
    if (stats == nullptr) return -1;
    const int e = e2eft_gn_channel_stats(x, stats, dtype, B, C, n, stream);
    if (e != 0) return e;
    return e2eft_gn_apply(x, stats, w, b, out, dtype, affine_dtype, B, C, n, groups, eps, silu, stream);
  }
  if (dtype == 0 && affine_dtype == 0)
    return launch_group_silu<float, float>(x, w, b, out, B, groups, gs, n, parts, eps, silu, device, st);
  if (dtype == 0)
    return launch_group_silu<float, bf16>(x, w, b, out, B, groups, gs, n, parts, eps, silu, device, st);
  if (affine_dtype == 0)
    return launch_group_silu<bf16, float>(x, w, b, out, B, groups, gs, n, parts, eps, silu, device, st);
  return launch_group_silu<bf16, bf16>(x, w, b, out, B, groups, gs, n, parts, eps, silu, device, st);
}

}  // extern "C"
