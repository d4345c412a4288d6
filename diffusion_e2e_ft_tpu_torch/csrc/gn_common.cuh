// Helpers shared by the GroupNorm statistics kernel (groupnorm.cu) and the
// fused GroupNorm+SiLU -> conv3x3 kernels (gn_conv.cu): dtype conversions and
// the block-wide fp32 reduction of one contiguous row into (sum x, sum x^2).
// Each translation unit gets its own copy.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float v) { return __float2bfloat16(v); }

__host__ __device__ constexpr int align_up(int x, int a) { return (x + a - 1) / a * a; }

// Sum x and sum x^2 of the n contiguous values at `row`, in fp32. Every
// thread of the block calls it; thread 0 receives the totals. The body is
// read as 16-byte vectors (the scalar head reaches the first 16-byte boundary,
// the scalar tail covers the rest), and the order of the sums is fixed: no
// atomics, so one input always gives the same bits. `red` is shared memory
// for 2 * THREADS / 32 floats; it is free again when the function returns.
template <typename T, int THREADS>
__device__ void row_stats(const T* row, int64_t n, float* red, float* out_s, float* out_ss) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int WARPS = THREADS / 32;
  float s = 0.f, ss = 0.f;
  const uintptr_t addr = reinterpret_cast<uintptr_t>(row);
  int64_t head = static_cast<int64_t>(((16 - (addr & 15)) & 15) / sizeof(T));
  if (head > n) head = n;
  for (int64_t i = threadIdx.x; i < head; i += THREADS) {
    const float v = to_f32(row[i]);
    s += v;
    ss = fmaf(v, v, ss);
  }
  const int64_t nvec = (n - head) / VEC;
  const uint4* body = reinterpret_cast<const uint4*>(row + head);
  for (int64_t i = threadIdx.x; i < nvec; i += THREADS) {
    const uint4 raw = body[i];
    const T* v = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const float f = to_f32(v[j]);
      s += f;
      ss = fmaf(f, f, ss);
    }
  }
  for (int64_t i = head + nvec * VEC + threadIdx.x; i < n; i += THREADS) {
    const float v = to_f32(row[i]);
    s += v;
    ss = fmaf(v, v, ss);
  }
#pragma unroll
  for (int off = 16; off > 0; off /= 2) {
    s += __shfl_xor_sync(0xffffffffu, s, off);
    ss += __shfl_xor_sync(0xffffffffu, ss, off);
  }
  const int warp = threadIdx.x / 32;
  if (threadIdx.x % 32 == 0) {
    red[warp] = s;
    red[WARPS + warp] = ss;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float ts = 0.f, tss = 0.f;
    for (int w = 0; w < WARPS; ++w) {
      ts += red[w];
      tss += red[WARPS + w];
    }
    *out_s = ts;
    *out_ss = tss;
  }
  __syncthreads();
}

}  // namespace
