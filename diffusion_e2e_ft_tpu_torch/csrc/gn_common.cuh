// Helpers shared by the GroupNorm statistics kernel (groupnorm.cu) and the
// fused GroupNorm+SiLU -> conv3x3 kernels (gn_conv.cu): the fp32 reduction
// of one segment of a contiguous row into (sum x, sum x^2), by a block or a
// warp, and the group fold of those sums into the per-channel a, b of the
// GroupNorm. Each translation unit gets its own copy.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }

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

// One thread's share of sum x and sum x^2 of segment `part` of `parts` of
// the n contiguous values at `row`, in fp32, added into s and ss: thread
// `rank` of WIDTH threads that read the segment together. The row's body is
// read as 16-byte vectors and cut into `parts` runs of whole vectors; part 0
// also takes the scalar head (up to the first 16-byte boundary) and the last
// part the scalar tail. Each thread keeps UNROLL independent 16-byte loads
// in flight and adds its values in index order.
template <typename T, int WIDTH, int UNROLL>
__device__ __forceinline__ void segment_partial(const T* row, int64_t n, int part, int parts, int rank, float& s,
                                                float& ss) {
  constexpr int VEC = 16 / sizeof(T);
  const uintptr_t addr = reinterpret_cast<uintptr_t>(row);
  int64_t head = static_cast<int64_t>(((16 - (addr & 15)) & 15) / sizeof(T));
  if (head > n) head = n;
  const int64_t nvec = (n - head) / VEC;
  if (part == 0) {
    for (int64_t i = rank; i < head; i += WIDTH) {
      const float v = to_f32(row[i]);
      s += v;
      ss = fmaf(v, v, ss);
    }
  }
  const uint4* body = reinterpret_cast<const uint4*>(row + head);
  const int64_t v0 = nvec * part / parts, v1 = nvec * (part + 1) / parts;
  int64_t i = v0 + rank;
  for (; i + (UNROLL - 1) * WIDTH < v1; i += UNROLL * WIDTH) {
    uint4 raw[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) raw[u] = __ldcs(body + i + u * WIDTH);  // read once: stream past L1
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) add_vec<T>(raw[u], s, ss);
  }
  for (; i < v1; i += WIDTH) add_vec<T>(__ldcs(body + i), s, ss);
  if (part == parts - 1) {
    for (int64_t j = head + nvec * VEC + rank; j < n; j += WIDTH) {
      const float v = to_f32(row[j]);
      s += v;
      ss = fmaf(v, v, ss);
    }
  }
}

// The warp's butterfly sum of s and ss: every lane receives the totals.
__device__ __forceinline__ void warp_sums(float& s, float& ss) {
#pragma unroll
  for (int off = 16; off > 0; off /= 2) {
    s += __shfl_xor_sync(0xffffffffu, s, off);
    ss += __shfl_xor_sync(0xffffffffu, ss, off);
  }
}

// Sum x and sum x^2 of segment `part` of `parts` of the n contiguous values
// at `row` (`segment_partial`), by the whole block. Every thread of the
// block calls it; thread 0 receives the segment's totals. The order of the
// sums is fixed (each warp's butterfly, then the warps in order): no
// atomics, so one input always gives the same bits. `red` is shared memory
// for 2 * THREADS / 32 floats; it is free again when the function returns.
template <typename T, int THREADS, int UNROLL = 4>
__device__ void segment_stats(const T* row, int64_t n, int part, int parts, float* red, float* out_s,
                              float* out_ss) {
  constexpr int WARPS = THREADS / 32;
  float s = 0.f, ss = 0.f;
  segment_partial<T, THREADS, UNROLL>(row, n, part, parts, threadIdx.x, s, ss);
  warp_sums(s, ss);
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

// One channel's GroupNorm fold from its group's sums gsum = sum x and gsq =
// sum x^2 over `count` values: group mean, E[x^2] - mean^2 clamped at 0,
// a = rsqrt(var + eps) * w, b = bias - mean * a, both times `scale`.
__device__ __forceinline__ void fold_channel(float gsum, float gsq, float count, float eps, float w, float bias,
                                             float scale, float* a_out, float* b_out) {
  const float mean = gsum / count;
  const float var = fmaxf(gsq / count - mean * mean, 0.f);
  const float a = rsqrtf(var + eps) * w;
  *a_out = a * scale;
  *b_out = (bias - mean * a) * scale;
}

// The GroupNorm fold of one image: from its per-channel sums st[0, c] = sum x
// and st[C + c] = sum x^2 over hw values each, the per-channel fp32 a, b with
// GroupNorm(x) = x * a + b (`fold_channel`, the group's sums added channel
// by channel). Every thread of the block calls it (threads stride over C);
// `st` is read through L2 (`__ldcg`), so a buffer written by other blocks of
// the same launch before a grid barrier is seen. Returns with the block
// synchronised.
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
    fold_channel(gsum, gsq, count, eps, gn_w[c], gn_b[c], scale, sa + c, sb + c);
  }
  __syncthreads();
}

// The same fold from `parts` partial sums a channel (st [2, C, parts]), as
// v2's statistics phase leaves them: each channel's parts added in part
// order into `scratch` (2 * C floats of shared memory), then each group's
// channels from it in channel order (the bits of `fold_groups` when parts is
// 1). Each thread's reads of `st` are independent of one another, where
// fold_groups chains a group's worth of them through L2 a channel. Returns
// with the block synchronised.
template <int THREADS>
__device__ void fold_parts(const float* st, const float* __restrict__ gn_w, const float* __restrict__ gn_b, int C,
                           int groups, int64_t hw, float eps, float* sa, float* sb, float scale, int parts,
                           float* scratch) {
  const float* sq = st + static_cast<int64_t>(C) * parts;
  for (int c = threadIdx.x; c < C; c += THREADS) {
    float cs = 0.f, csq = 0.f;
    for (int q = 0; q < parts; ++q) {
      cs += __ldcg(st + c * parts + q);
      csq += __ldcg(sq + c * parts + q);
    }
    scratch[c] = cs;
    scratch[C + c] = csq;
  }
  __syncthreads();
  const int gs = C / groups;
  const float count = static_cast<float>(hw * gs);
  for (int c = threadIdx.x; c < C; c += THREADS) {
    const int g0 = c / gs * gs;
    float gsum = 0.f, gsq = 0.f;
    for (int j = 0; j < gs; ++j) {
      gsum += scratch[g0 + j];
      gsq += scratch[C + g0 + j];
    }
    fold_channel(gsum, gsq, count, eps, gn_w[c], gn_b[c], scale, sa + c, sb + c);
  }
  __syncthreads();
}

}  // namespace
