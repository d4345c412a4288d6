// GroupNorm statistics for Hopper (sm_90a): per-channel fp32 (sum x, sum x^2).
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
