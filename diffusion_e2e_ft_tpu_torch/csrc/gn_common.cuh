// Helpers shared by the GroupNorm statistics kernel (groupnorm.cu) and the
// fused GroupNorm+SiLU -> conv3x3 kernels (gn_conv.cu): dtype conversions,
// the block-wide fp32 reduction of a contiguous row (or one segment of it)
// into (sum x, sum x^2), and the group fold of those sums into the
// per-channel a, b of the GroupNorm. Each translation unit gets its own copy.

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

template <typename T>
__device__ __forceinline__ void add_vec(const uint4& raw, float& s, float& ss) {
  const T* v = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int j = 0; j < static_cast<int>(16 / sizeof(T)); ++j) {
    const float f = to_f32(v[j]);
    s += f;
    ss = fmaf(f, f, ss);
  }
}

// Sum x and sum x^2 of segment `part` of `parts` of the n contiguous values
// at `row`, in fp32. Every thread of the block calls it; thread 0 receives
// the segment's totals. The row's body is read as 16-byte vectors and cut
// into `parts` runs of whole vectors; part 0 also takes the scalar head
// (up to the first 16-byte boundary) and the last part the scalar tail. Each
// thread keeps UNROLL independent 16-byte loads in flight, and the order of
// the sums is fixed: no atomics, so one input always gives the same bits.
// `red` is shared memory for 2 * THREADS / 32 floats; it is free again when
// the function returns.
template <typename T, int THREADS, int UNROLL = 4>
__device__ void segment_stats(const T* row, int64_t n, int part, int parts, float* red, float* out_s,
                              float* out_ss) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int WARPS = THREADS / 32;
  float s = 0.f, ss = 0.f;
  const uintptr_t addr = reinterpret_cast<uintptr_t>(row);
  int64_t head = static_cast<int64_t>(((16 - (addr & 15)) & 15) / sizeof(T));
  if (head > n) head = n;
  const int64_t nvec = (n - head) / VEC;
  if (part == 0) {
    for (int64_t i = threadIdx.x; i < head; i += THREADS) {
      const float v = to_f32(row[i]);
      s += v;
      ss = fmaf(v, v, ss);
    }
  }
  const uint4* body = reinterpret_cast<const uint4*>(row + head);
  const int64_t v0 = nvec * part / parts, v1 = nvec * (part + 1) / parts;
  int64_t i = v0 + threadIdx.x;
  for (; i + (UNROLL - 1) * THREADS < v1; i += UNROLL * THREADS) {
    uint4 raw[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) raw[u] = __ldcs(body + i + u * THREADS);  // read once: stream past L1
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) add_vec<T>(raw[u], s, ss);
  }
  for (; i < v1; i += THREADS) add_vec<T>(__ldcs(body + i), s, ss);
  if (part == parts - 1) {
    for (int64_t j = head + nvec * VEC + threadIdx.x; j < n; j += THREADS) {
      const float v = to_f32(row[j]);
      s += v;
      ss = fmaf(v, v, ss);
    }
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

// The whole row in one block (v2's statistics phase).
template <typename T, int THREADS>
__device__ void row_stats(const T* row, int64_t n, float* red, float* out_s, float* out_ss) {
  segment_stats<T, THREADS>(row, n, 0, 1, red, out_s, out_ss);
}

// The GroupNorm fold of one image: from its per-channel sums st[0, c] = sum x
// and st[C + c] = sum x^2 over hw values each, the per-channel fp32 a, b with
// GroupNorm(x) = x * a + b: group mean, E[x^2] - mean^2 clamped at 0,
// a = rsqrt(var + eps) * w, b = bias - mean * a, both times `scale`. Every
// thread of the block calls it (threads stride over C); `st` is read through
// L2 (`__ldcg`), so a buffer written by other blocks of the same launch
// before a grid barrier is seen. Returns with the block synchronised.
template <int THREADS>
__device__ void fold_groups(const float* st, const float* __restrict__ gn_w, const float* __restrict__ gn_b,
                            int C, int groups, int64_t hw, float eps, float* sa, float* sb, float scale = 1.f) {
  const int gs = C / groups;
  const float count = static_cast<float>(hw * gs);
  for (int c = threadIdx.x; c < C; c += THREADS) {
    const int g0 = c / gs * gs;
    float gsum = 0.f, gsq = 0.f;
    for (int j = 0; j < gs; ++j) {
      gsum += __ldcg(st + g0 + j);
      gsq += __ldcg(st + C + g0 + j);
    }
    const float mean = gsum / count;
    const float var = fmaxf(gsq / count - mean * mean, 0.f);
    const float a = rsqrtf(var + eps) * gn_w[c];
    sa[c] = a * scale;
    sb[c] = (gn_b[c] - mean * a) * scale;
  }
  __syncthreads();
}

}  // namespace
