// Helpers shared by the flash-attention forward (flash_attention.cu) and
// backward (flash_attention_bwd.cu) kernels' fp32 bodies: shared-memory
// alignment and the tile loader. Each translation unit gets its own copy.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kAlign = 128;  // byte alignment of each shared-memory array

__host__ __device__ constexpr int align_up(int x, int a) { return (x + a - 1) / a * a; }

// Copy `rows` rows of D floats from global (row stride `ld` elements) into
// shared memory (row stride LDT), zero-filling rows at or past `valid`.
// Global rows are read as 16-byte vectors; the wrapper checks the alignment.
template <int D, int LDT, int THREADS>
__device__ void load_tile(float* dst, const float* src, int64_t ld, int rows, int valid) {
  constexpr int CHUNKS = D / 4;
  for (int i = threadIdx.x; i < rows * CHUNKS; i += THREADS) {
    const int r = i / CHUNKS;
    const int c = (i % CHUNKS) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < valid) val = *reinterpret_cast<const float4*>(src + r * ld + c);
    dst[r * LDT + c] = val.x;
    dst[r * LDT + c + 1] = val.y;
    dst[r * LDT + c + 2] = val.z;
    dst[r * LDT + c + 3] = val.w;
  }
}

}  // namespace
