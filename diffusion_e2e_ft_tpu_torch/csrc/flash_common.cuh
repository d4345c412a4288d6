// Helpers shared by the flash-attention forward (flash_attention.cu) and
// backward (flash_attention_bwd.cu) kernels: shared-memory alignment, the
// exponential, and the tile loader. Each translation unit gets its own copy.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kAlign = 128;  // byte alignment of each shared-memory array

// bf16 tiles take the fast exponential; fp32 keeps the exact one.
template <bool kFast>
__device__ __forceinline__ float exp_(float x) {
  if constexpr (kFast) {
    return __expf(x);
  } else {
    return expf(x);
  }
}

__host__ __device__ constexpr int align_up(int x, int a) { return (x + a - 1) / a * a; }

// Copy `rows` rows of D elements from global (row stride `ld` elements) into
// shared memory (row stride LDT), zero-filling rows at or past `valid`.
// Global rows are read as 16-byte vectors; the wrapper checks the alignment.
template <typename T, int D, int LDT, int THREADS>
__device__ void load_tile(T* dst, const T* src, int64_t ld, int rows, int valid) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int CHUNKS = D / VEC;
  for (int i = threadIdx.x; i < rows * CHUNKS; i += THREADS) {
    const int r = i / CHUNKS;
    const int c = (i % CHUNKS) * VEC;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (r < valid) val = *reinterpret_cast<const uint4*>(src + r * ld + c);
    if constexpr (std::is_same<T, bf16>::value) {
      *reinterpret_cast<uint4*>(dst + r * LDT + c) = val;  // LDT keeps 16-byte alignment
    } else {
      const float* f = reinterpret_cast<const float*>(&val);
#pragma unroll
      for (int j = 0; j < VEC; ++j) dst[r * LDT + c + j] = f[j];
    }
  }
}

}  // namespace
