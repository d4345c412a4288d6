// Tensor-core and asynchronous-copy helpers shared by the bf16 kernels
// (flash_attention.cu, flash_attention_bwd.cu, gn_conv.cu): `cp.async` copies
// global -> shared with their group bookkeeping and a row loader on top,
// `ldmatrix` fragment loads, the `mma.sync` m16n8k16 bf16 product with fp32
// accumulators, the fast base-2 exponential and named barriers. Each
// translation unit gets its own copy.
//
// Fragment layouts of m16n8k16 (g = lane / 4, t = lane % 4):
//   A 16x16 (4 regs of 2 bf16): a0 (row g, cols 2t, 2t+1), a1 (row g+8, same
//     cols), a2 (row g, cols 2t+8, 2t+9), a3 (row g+8, cols 2t+8, 2t+9);
//   B 16x8 (2 regs): b0 (k 2t, 2t+1; n g), b1 (k 2t+8, 2t+9; n g);
//   C 16x8 (4 fp32): c0, c1 (row g, cols 2t, 2t+1), c2, c3 (row g+8).
// Two neighbouring C tiles along n are therefore one A tile along k, in
// registers: (c0 c1 | c2 c3) of tile 2i give a0 | a1 and of tile 2i+1 a2 | a3.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;

// 16 bytes global -> shared without a register stage; zeros when !valid (the
// source is then not read, but must still be a mapped address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(addr), "l"(src), "r"(valid ? 16 : 0));
}

// 4 bytes global -> shared (through L1: the 16-byte form is the only one that
// may bypass it); zero when !valid, as above.
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(addr), "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

// Wait until at most N of this thread's committed groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  cp_async_commit();
  cp_async_wait<0>();
}

// Four 8x8 b16 matrices; lane i gives the row address of matrix i / 8.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// The same, each matrix transposed: a row-major [k][n] tile read as B.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const bf16* p) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two fp32 values as one bf16x2 register, `lo` in the low half (the lower column).
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Barrier `id` (1-15; 0 is __syncthreads) over `threads` threads, a multiple of 32.
__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// ROWS rows of D bf16 from global (row stride `ld` elements) into shared
// memory (row stride LDT), asynchronously; rows at or past `valid` are zero.
template <int D, int LDT, int THREADS, int ROWS>
__device__ __forceinline__ void load_rows_async(bf16* dst, const bf16* src, int64_t ld, int valid) {
  constexpr int CHUNKS = D / 8, TOTAL = ROWS * CHUNKS;
#pragma unroll
  for (int it = 0; it < (TOTAL + THREADS - 1) / THREADS; ++it) {
    const int i = threadIdx.x + it * THREADS;
    if (TOTAL % THREADS == 0 || i < TOTAL) {
      const int r = i / CHUNKS, c = (i % CHUNKS) * 8;
      const bool ok = r < valid;
      cp_async16(dst + r * LDT + c, src + (ok ? r * ld + c : 0), ok);
    }
  }
}

}  // namespace
