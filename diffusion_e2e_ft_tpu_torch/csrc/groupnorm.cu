// GroupNorm statistics for Hopper (sm_90a): per-channel fp32 (sum x, sum x^2);
// and, below them, the GroupNorm apply that turns those sums into the
// normalized, affine (+SiLU) output.
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

template <typename T>
int launch(const void* x, float* out, int B, int C, int64_t n, cudaStream_t stream) {
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
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
