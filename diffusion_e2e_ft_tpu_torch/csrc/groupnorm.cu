// GroupNorm statistics for Hopper (sm_90a): per-channel fp32 (sum x, sum x^2).
//
// Replaces diffusion_e2e_ft_tpu/kernels/groupnorm.py::_stats_kernel (launched
// there by _channel_stats). Same result: for x [B, C, N] (N = H * W) in fp32
// or bf16, out[b, 0, c] = sum_n x and out[b, 1, c] = sum_n x^2, accumulated in
// fp32. The TPU kernel carries a [2, C] accumulator across a sequential grid
// axis of row blocks of a [B, N, C] array; the port keeps the module's NCHW
// layout, where the N values of one (b, c) are contiguous, so one block
// reduces one whole (b, c) row: no carry, no atomics, a fixed summation order.
// Ragged N needs no zero-padding copy: the row's head and tail outside the
// 16-byte vectors are read one value at a time.
//
// What bounds it on the H100: one read of x, no reuse, about one FLOP per
// byte. At the 480x640 train step's largest decoder layer, [2, 128, 480, 640]
// bf16, that is 157 MB, or ~0.05 ms at 3.35 TB/s. The design keeps every load
// a coalesced 16-byte vector and puts 512 threads on each row, so B * C rows
// (256 to 1024 on the main path) fill the card with loads in flight.

#include "gn_common.cuh"

namespace {

constexpr int kStatsThreads = 512;

template <typename T>
__global__ void __launch_bounds__(kStatsThreads)
channel_stats_kernel(const T* __restrict__ x, float* __restrict__ out, int C, int64_t n) {
  __shared__ float red[2 * kStatsThreads / 32];
  const int row = blockIdx.x;  // b * C + c
  const int b = row / C, c = row % C;
  float s, ss;
  row_stats<T, kStatsThreads>(x + static_cast<int64_t>(row) * n, n, red, &s, &ss);
  if (threadIdx.x == 0) {
    out[static_cast<int64_t>(b) * 2 * C + c] = s;
    out[static_cast<int64_t>(b) * 2 * C + C + c] = ss;
  }
}

template <typename T>
int launch(const void* x, float* out, int B, int C, int64_t n, cudaStream_t stream) {
  channel_stats_kernel<T><<<B * C, kStatsThreads, 0, stream>>>(static_cast<const T*>(x), out, C, n);
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
