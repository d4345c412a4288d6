// Flash-attention backward for Hopper (sm_90a), in the FlashAttention-2 form:
// two kernels, no atomics.
//
// Replaces diffusion_e2e_ft_tpu/kernels/flash_attention.py::_dq_kernel and
// ::_dkv_kernel (both launched by _flash_bwd_bnld). Same math: the
// probabilities are recomputed from the forward's per-row log-sum-exp,
// p = exp(s * scale - lse), and with delta = rowsum(dO * O) (computed by the
// caller in fp32)
//   dq = sum_k  ds K,   dv = P^T dO,   dk = ds^T Q,   ds = p (dO V^T - delta) scale.
// Products accumulate in fp32; for bf16 inputs P and ds are cast to bf16
// before their products, as the TPU kernels cast them to the input dtype.
//
// What differs from the TPU kernels is the schedule. There, the sequential
// innermost grid axis carries the accumulators between grid steps. Here the
// dq kernel gives one block a Q tile and loops over every KV tile inside it;
// the dk/dv kernel gives one block a KV tile and loops over every Q tile. So
// each output row is written by exactly one block and nothing is reduced
// across blocks. Ragged Lq and Lk are masked in the kernel: rows past Lq and
// columns past Lk get p = 0 (the TPU version relies on zero-padded dO and
// delta instead), and no row past the end is written.
//
// Inputs and outputs are addressed by strides ([B, L, N, D] with D
// contiguous), so the attention module's projections need no transposes.
//
// What bounds it on the H100: five L x L x d products per head (S and dP in
// both kernels, plus dq, or dv and dk) against O(L d) bytes, so it is
// compute-bound like the forward. This first version stages every tile and
// accumulator in shared memory and runs the bf16 products on the tensor cores
// through WMMA (16x16x16, fp32 accumulate); fp32 takes scalar FMA (no TF32).
// No wgmma, TMA or warp specialisation yet.
//
// Head dim 512: the dk/dv block holds two fp32 [BK, 512] accumulators, the K
// and V tiles, the Q and dO tiles and the [BQ, BK] score tiles. With BK = 16
// that is 2 * 16 * 516 * 4 = 66 KB of accumulators; in fp32 the whole block
// takes ~200 KB of the 227 KB a block may have, so the tiles are 16 x 16 there.
// The limit is raised with cudaFuncSetAttribute, as in the forward.

#include <mma.h>

#include <cmath>

#include "flash_common.cuh"

namespace {

// Tile configuration per (dtype, head dim, kernel): BQ rows of Q / dO, BK
// rows of K / V. The dq kernel's block owns BQ rows, the dk/dv kernel's BK.
template <typename T, int D, bool kDkv>
struct BwdCfg;

template <bool kDkv>
struct BwdCfg<bf16, 64, kDkv> {
  static constexpr int BQ = 64, BK = 64, THREADS = 128;
};
template <bool kDkv>
struct BwdCfg<bf16, 512, kDkv> {
  static constexpr int BQ = 32, BK = 16, THREADS = 256;
};
template <bool kDkv>
struct BwdCfg<float, 64, kDkv> {
  static constexpr int BQ = 64, BK = 64, THREADS = 128;
};
template <bool kDkv>
struct BwdCfg<float, 512, kDkv> {
  static constexpr int BQ = 16, BK = 16, THREADS = 256;
};

// Shared-memory layout, padded as in the forward: bf16 rows by 8 elements
// (every 16-row WMMA tile stays 32-byte aligned), fp32 rows by 1 element
// (conflict-free column walks in the scalar path). The dq kernel keeps one
// [BQ, D] accumulator, the dk/dv kernel two [BK, D] accumulators.
template <typename T, int D, bool kDkv>
struct BwdSmem {
  using C = BwdCfg<T, D, kDkv>;
  static constexpr bool kBf16 = std::is_same<T, bf16>::value;
  static constexpr int LDT = kBf16 ? D + 8 : D + 1;          // Q, dO, K, V rows
  static constexpr int LDS = kBf16 ? C::BK + 4 : C::BK + 1;  // S, dP (fp32) rows
  static constexpr int LDP = C::BK + 8;                      // P, dS (bf16) rows
  static constexpr int LDA = kBf16 ? D + 4 : D + 1;          // accumulator rows
  static constexpr int ACC_ROWS = kDkv ? C::BK : C::BQ;
  static constexpr int NACC = kDkv ? 2 : 1;
  static constexpr int q_off = 0;
  static constexpr int do_off = align_up(q_off + C::BQ * LDT * (int)sizeof(T), kAlign);
  static constexpr int k_off = align_up(do_off + C::BQ * LDT * (int)sizeof(T), kAlign);
  static constexpr int v_off = align_up(k_off + C::BK * LDT * (int)sizeof(T), kAlign);
  static constexpr int s_off = align_up(v_off + C::BK * LDT * (int)sizeof(T), kAlign);
  static constexpr int dp_off = align_up(s_off + C::BQ * LDS * 4, kAlign);
  static constexpr int p_off = align_up(dp_off + C::BQ * LDS * 4, kAlign);
  static constexpr int ds_off = align_up(p_off + (kBf16 ? C::BQ * LDP * 2 : 0), kAlign);
  static constexpr int acc_off = align_up(ds_off + (kBf16 ? C::BQ * LDP * 2 : 0), kAlign);
  static constexpr int lse_off = align_up(acc_off + NACC * ACC_ROWS * LDA * 4, kAlign);
  static constexpr int dd_off = lse_off + C::BQ * 4;
  static constexpr int bytes = dd_off + C::BQ * 4;
  static_assert(bytes <= 227 * 1024, "tile does not fit shared memory");
};

// C[M, N] = A[M, K] B[N, K]^T, A and B row-major in shared memory, C fp32.
template <typename T, int M, int N, int K, int THREADS>
__device__ void mm_abt(float* c, int ldc, const T* a, int lda, const T* b, int ldb) {
  if constexpr (std::is_same<T, bf16>::value) {
    using namespace nvcuda;
    constexpr int TN = N / 16, TILES = (M / 16) * TN, WARPS = THREADS / 32;
    for (int t = threadIdx.x / 32; t < TILES; t += WARPS) {
      const int m0 = (t / TN) * 16, n0 = (t % TN) * 16;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
#pragma unroll 4
      for (int k0 = 0; k0 < K; k0 += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
        wmma::load_matrix_sync(fa, a + m0 * lda + k0, lda);
        wmma::load_matrix_sync(fb, b + n0 * ldb + k0, ldb);  // rows of B = columns of B^T
        wmma::mma_sync(acc, fa, fb, acc);
      }
      wmma::store_matrix_sync(c + m0 * ldc + n0, acc, ldc, wmma::mem_row_major);
    }
  } else {
    for (int i = threadIdx.x; i < M * N; i += THREADS) {
      const int r = i / N, col = i % N;
      const float* ar = a + r * lda;
      const float* br = b + col * ldb;
      float acc = 0.f;
#pragma unroll 8
      for (int k = 0; k < K; ++k) acc = fmaf(ar[k], br[k], acc);
      c[r * ldc + col] = acc;
    }
  }
}

// C[M, N] += A[M, K] B[K, N] (kTransA = false) or A[K, M]^T B[K, N]
// (kTransA = true); A and B row-major in shared memory, C an fp32 accumulator.
template <bool kTransA, typename T, int M, int N, int K, int THREADS>
__device__ void mm_acc(float* c, int ldc, const T* a, int lda, const T* b, int ldb) {
  if constexpr (std::is_same<T, bf16>::value) {
    using namespace nvcuda;
    using ALayout = typename std::conditional<kTransA, wmma::col_major, wmma::row_major>::type;
    constexpr int TN = N / 16, TILES = (M / 16) * TN, WARPS = THREADS / 32;
    for (int t = threadIdx.x / 32; t < TILES; t += WARPS) {
      const int m0 = (t / TN) * 16, n0 = (t % TN) * 16;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::load_matrix_sync(acc, c + m0 * ldc + n0, ldc, wmma::mem_row_major);
#pragma unroll
      for (int k0 = 0; k0 < K; k0 += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, ALayout> fa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
        // A^T[m, k] = A[k, m]: a column-major view of A's rows
        wmma::load_matrix_sync(fa, kTransA ? a + k0 * lda + m0 : a + m0 * lda + k0, lda);
        wmma::load_matrix_sync(fb, b + k0 * ldb + n0, ldb);
        wmma::mma_sync(acc, fa, fb, acc);
      }
      wmma::store_matrix_sync(c + m0 * ldc + n0, acc, ldc, wmma::mem_row_major);
    }
  } else {
    for (int i = threadIdx.x; i < M * N; i += THREADS) {
      const int r = i / N, col = i % N;
      float acc = c[r * ldc + col];
#pragma unroll 8
      for (int k = 0; k < K; ++k) {
        const float av = kTransA ? a[k * lda + r] : a[r * lda + k];
        acc = fmaf(av, b[k * ldb + col], acc);
      }
      c[r * ldc + col] = acc;
    }
  }
}

// p and ds for one [BQ, BK] tile: p = exp(s * scale - lse) (0 for rows at or
// past q_valid and columns at or past kv_valid), ds = p (dP - delta) scale.
// bf16 writes p and ds as bf16 tiles; fp32 overwrites S with p and dP with ds.
template <typename T, int D, bool kDkv>
__device__ void probs_and_ds(unsigned char* smem, int q_valid, int kv_valid, float scale) {
  using L = BwdSmem<T, D, kDkv>;
  using C = BwdCfg<T, D, kDkv>;
  float* sS = reinterpret_cast<float*>(smem + L::s_off);
  float* sDP = reinterpret_cast<float*>(smem + L::dp_off);
  bf16* sP = reinterpret_cast<bf16*>(smem + L::p_off);
  bf16* sDS = reinterpret_cast<bf16*>(smem + L::ds_off);
  const float* sLse = reinterpret_cast<const float*>(smem + L::lse_off);
  const float* sDd = reinterpret_cast<const float*>(smem + L::dd_off);
  for (int i = threadIdx.x; i < C::BQ * C::BK; i += C::THREADS) {
    const int r = i / C::BK, c = i % C::BK;
    float p = 0.f, ds = 0.f;
    if (r < q_valid && c < kv_valid) {
      p = exp_<L::kBf16>(sS[r * L::LDS + c] * scale - sLse[r]);
      ds = p * (sDP[r * L::LDS + c] - sDd[r]) * scale;
    }
    if constexpr (L::kBf16) {
      sP[r * L::LDP + c] = __float2bfloat16(p);
      sDS[r * L::LDP + c] = __float2bfloat16(ds);
    } else {
      sS[r * L::LDS + c] = p;
      sDP[r * L::LDS + c] = ds;
    }
  }
}

template <typename T>
__device__ __forceinline__ T from_float(float x) {
  if constexpr (std::is_same<T, bf16>::value) {
    return __float2bfloat16(x);
  } else {
    return x;
  }
}

// Strides (elements), in order: q, k, v, dO, dq, dk, dv, each (b, l, n).
struct Strides {
  int64_t v[21];
};

// dq for one Q tile of one (b, n): loop over every KV tile.
template <typename T, int D>
__global__ void __launch_bounds__(BwdCfg<T, D, false>::THREADS)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ dd, T* __restrict__ dq, int N, int Lq, int Lk,
                    float scale, Strides st) {
  using C = BwdCfg<T, D, false>;
  using L = BwdSmem<T, D, false>;
  constexpr int BQ = C::BQ, BK = C::BK, THREADS = C::THREADS;
  extern __shared__ __align__(kAlign) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem + L::q_off);
  T* sDO = reinterpret_cast<T*>(smem + L::do_off);
  T* sK = reinterpret_cast<T*>(smem + L::k_off);
  T* sV = reinterpret_cast<T*>(smem + L::v_off);
  float* sS = reinterpret_cast<float*>(smem + L::s_off);
  float* sDP = reinterpret_cast<float*>(smem + L::dp_off);
  float* sAcc = reinterpret_cast<float*>(smem + L::acc_off);
  float* sLse = reinterpret_cast<float*>(smem + L::lse_off);
  float* sDd = reinterpret_cast<float*>(smem + L::dd_off);

  const int q0 = blockIdx.x * BQ;
  const int bn = blockIdx.y;
  const int b = bn / N, n = bn % N;
  const int q_valid = min(BQ, Lq - q0);
  load_tile<T, D, L::LDT, THREADS>(sQ, q + b * st.v[0] + n * st.v[2] + q0 * st.v[1], st.v[1], BQ,
                                   q_valid);
  load_tile<T, D, L::LDT, THREADS>(sDO, dout + b * st.v[9] + n * st.v[11] + q0 * st.v[10],
                                   st.v[10], BQ, q_valid);
  // lse and delta are [B, Lq, N]: consecutive rows are N apart
  const int64_t row0 = (static_cast<int64_t>(b) * Lq + q0) * N + n;
  for (int r = threadIdx.x; r < BQ; r += THREADS) {
    sLse[r] = r < q_valid ? lse[row0 + static_cast<int64_t>(r) * N] : 0.f;
    sDd[r] = r < q_valid ? dd[row0 + static_cast<int64_t>(r) * N] : 0.f;
  }
  for (int i = threadIdx.x; i < BQ * L::LDA; i += THREADS) sAcc[i] = 0.f;

  const T* kb = k + b * st.v[3] + n * st.v[5];
  const T* vb = v + b * st.v[6] + n * st.v[8];
  for (int kv0 = 0; kv0 < Lk; kv0 += BK) {
    const int kv_valid = min(BK, Lk - kv0);
    __syncthreads();  // the previous tile's K and dS are consumed
    load_tile<T, D, L::LDT, THREADS>(sK, kb + kv0 * st.v[4], st.v[4], BK, kv_valid);
    load_tile<T, D, L::LDT, THREADS>(sV, vb + kv0 * st.v[7], st.v[7], BK, kv_valid);
    __syncthreads();
    mm_abt<T, BQ, BK, D, THREADS>(sS, L::LDS, sQ, L::LDT, sK, L::LDT);    // S = Q K^T
    mm_abt<T, BQ, BK, D, THREADS>(sDP, L::LDS, sDO, L::LDT, sV, L::LDT);  // dP = dO V^T
    __syncthreads();
    probs_and_ds<T, D, false>(smem, q_valid, kv_valid, scale);
    __syncthreads();
    if constexpr (L::kBf16) {  // dq += dS K
      mm_acc<false, bf16, BQ, D, BK, THREADS>(sAcc, L::LDA,
                                              reinterpret_cast<const bf16*>(smem + L::ds_off), L::LDP,
                                              sK, L::LDT);
    } else {
      mm_acc<false, float, BQ, D, BK, THREADS>(sAcc, L::LDA, sDP, L::LDS, sK, L::LDT);
    }
  }
  __syncthreads();

  T* dqb = dq + b * st.v[12] + n * st.v[14] + q0 * st.v[13];
  for (int i = threadIdx.x; i < q_valid * D; i += THREADS) {
    const int r = i / D, c = i % D;
    dqb[r * st.v[13] + c] = from_float<T>(sAcc[r * L::LDA + c]);
  }
}

// dk and dv for one KV tile of one (b, n): loop over every Q tile.
template <typename T, int D>
__global__ void __launch_bounds__(BwdCfg<T, D, true>::THREADS)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const T* __restrict__ dout, const float* __restrict__ lse,
                     const float* __restrict__ dd, T* __restrict__ dk, T* __restrict__ dv, int N,
                     int Lq, int Lk, float scale, Strides st) {
  using C = BwdCfg<T, D, true>;
  using L = BwdSmem<T, D, true>;
  constexpr int BQ = C::BQ, BK = C::BK, THREADS = C::THREADS;
  extern __shared__ __align__(kAlign) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem + L::q_off);
  T* sDO = reinterpret_cast<T*>(smem + L::do_off);
  T* sK = reinterpret_cast<T*>(smem + L::k_off);
  T* sV = reinterpret_cast<T*>(smem + L::v_off);
  float* sS = reinterpret_cast<float*>(smem + L::s_off);
  float* sDP = reinterpret_cast<float*>(smem + L::dp_off);
  float* sDK = reinterpret_cast<float*>(smem + L::acc_off);
  float* sDV = sDK + BK * L::LDA;
  float* sLse = reinterpret_cast<float*>(smem + L::lse_off);
  float* sDd = reinterpret_cast<float*>(smem + L::dd_off);

  const int k0 = blockIdx.x * BK;
  const int bn = blockIdx.y;
  const int b = bn / N, n = bn % N;
  const int kv_valid = min(BK, Lk - k0);
  load_tile<T, D, L::LDT, THREADS>(sK, k + b * st.v[3] + n * st.v[5] + k0 * st.v[4], st.v[4], BK,
                                   kv_valid);
  load_tile<T, D, L::LDT, THREADS>(sV, v + b * st.v[6] + n * st.v[8] + k0 * st.v[7], st.v[7], BK,
                                   kv_valid);
  for (int i = threadIdx.x; i < 2 * BK * L::LDA; i += THREADS) sDK[i] = 0.f;

  const T* qb = q + b * st.v[0] + n * st.v[2];
  const T* dob = dout + b * st.v[9] + n * st.v[11];
  const int64_t lse_b = static_cast<int64_t>(b) * Lq * N + n;
  for (int q0 = 0; q0 < Lq; q0 += BQ) {
    const int q_valid = min(BQ, Lq - q0);
    __syncthreads();  // the previous tile's Q, dO, P and dS are consumed
    load_tile<T, D, L::LDT, THREADS>(sQ, qb + q0 * st.v[1], st.v[1], BQ, q_valid);
    load_tile<T, D, L::LDT, THREADS>(sDO, dob + q0 * st.v[10], st.v[10], BQ, q_valid);
    for (int r = threadIdx.x; r < BQ; r += THREADS) {
      const int64_t idx = lse_b + static_cast<int64_t>(q0 + r) * N;
      sLse[r] = r < q_valid ? lse[idx] : 0.f;
      sDd[r] = r < q_valid ? dd[idx] : 0.f;
    }
    __syncthreads();
    mm_abt<T, BQ, BK, D, THREADS>(sS, L::LDS, sQ, L::LDT, sK, L::LDT);    // S = Q K^T
    mm_abt<T, BQ, BK, D, THREADS>(sDP, L::LDS, sDO, L::LDT, sV, L::LDT);  // dP = dO V^T
    __syncthreads();
    probs_and_ds<T, D, true>(smem, q_valid, kv_valid, scale);
    __syncthreads();
    if constexpr (L::kBf16) {
      const bf16* sP = reinterpret_cast<const bf16*>(smem + L::p_off);
      const bf16* sDS = reinterpret_cast<const bf16*>(smem + L::ds_off);
      mm_acc<true, bf16, BK, D, BQ, THREADS>(sDV, L::LDA, sP, L::LDP, sDO, L::LDT);  // dv += P^T dO
      mm_acc<true, bf16, BK, D, BQ, THREADS>(sDK, L::LDA, sDS, L::LDP, sQ, L::LDT);  // dk += dS^T Q
    } else {
      mm_acc<true, float, BK, D, BQ, THREADS>(sDV, L::LDA, sS, L::LDS, sDO, L::LDT);
      mm_acc<true, float, BK, D, BQ, THREADS>(sDK, L::LDA, sDP, L::LDS, sQ, L::LDT);
    }
  }
  __syncthreads();

  T* dkb = dk + b * st.v[15] + n * st.v[17] + k0 * st.v[16];
  T* dvb = dv + b * st.v[18] + n * st.v[20] + k0 * st.v[19];
  for (int i = threadIdx.x; i < kv_valid * D; i += THREADS) {
    const int r = i / D, c = i % D;
    dkb[r * st.v[16] + c] = from_float<T>(sDK[r * L::LDA + c]);
    dvb[r * st.v[19] + c] = from_float<T>(sDV[r * L::LDA + c]);
  }
}

template <typename T, int D, bool kDkv>
int launch_bwd(const void* q, const void* k, const void* v, const void* dout, const float* lse,
               const float* dd, void* out0, void* out1, int B, int N, int Lq, int Lk, float scale,
               const int64_t* s, cudaStream_t stream) {
  using C = BwdCfg<T, D, kDkv>;
  constexpr int bytes = BwdSmem<T, D, kDkv>::bytes;
  Strides st;
  for (int i = 0; i < 21; ++i) st.v[i] = s[i];
  const T* tq = static_cast<const T*>(q);
  const T* tk = static_cast<const T*>(k);
  const T* tv = static_cast<const T*>(v);
  const T* tdo = static_cast<const T*>(dout);
  if constexpr (kDkv) {
    auto kernel = flash_bwd_dkv_kernel<T, D>;
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    dim3 grid((Lk + C::BK - 1) / C::BK, B * N);
    kernel<<<grid, C::THREADS, bytes, stream>>>(tq, tk, tv, tdo, lse, dd, static_cast<T*>(out0),
                                                static_cast<T*>(out1), N, Lq, Lk, scale, st);
  } else {
    auto kernel = flash_bwd_dq_kernel<T, D>;
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    dim3 grid((Lq + C::BQ - 1) / C::BQ, B * N);
    kernel<<<grid, C::THREADS, bytes, stream>>>(tq, tk, tv, tdo, lse, dd, static_cast<T*>(out0), N,
                                                Lq, Lk, scale, st);
  }
  return static_cast<int>(cudaGetLastError());
}

template <bool kDkv>
int dispatch(const void* q, const void* k, const void* v, const void* dout, const float* lse,
             const float* dd, void* out0, void* out1, int dtype, int B, int N, int Lq, int Lk,
             int D, float scale, const int64_t* s, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1 && D == 64)
    return launch_bwd<bf16, 64, kDkv>(q, k, v, dout, lse, dd, out0, out1, B, N, Lq, Lk, scale, s, st);
  if (dtype == 1 && D == 512)
    return launch_bwd<bf16, 512, kDkv>(q, k, v, dout, lse, dd, out0, out1, B, N, Lq, Lk, scale, s, st);
  if (dtype == 0 && D == 64)
    return launch_bwd<float, 64, kDkv>(q, k, v, dout, lse, dd, out0, out1, B, N, Lq, Lk, scale, s, st);
  if (dtype == 0 && D == 512)
    return launch_bwd<float, 512, kDkv>(q, k, v, dout, lse, dd, out0, out1, B, N, Lq, Lk, scale, s, st);
  return -1;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. lse and delta: contiguous fp32 [B, Lq, N].
// strides (elements): q, k, v, dO, dq, dk, dv, each (b, l, n); 21 in all.
// Each returns 0, a cudaError_t from the launch, or -1 for an unsupported
// (dtype, head dim) pair. They launch on `stream` and do not synchronise.
int e2eft_flash_attention_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                                 const float* lse, const float* delta, void* dq, int dtype, int B,
                                 int N, int Lq, int Lk, int D, float scale,
                                 const int64_t* strides, void* stream) {
  return dispatch<false>(q, k, v, dout, lse, delta, dq, nullptr, dtype, B, N, Lq, Lk, D, scale,
                         strides, stream);
}

int e2eft_flash_attention_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                                  const float* lse, const float* delta, void* dk, void* dv,
                                  int dtype, int B, int N, int Lq, int Lk, int D, float scale,
                                  const int64_t* strides, void* stream) {
  return dispatch<true>(q, k, v, dout, lse, delta, dk, dv, dtype, B, N, Lq, Lk, D, scale, strides,
                        stream);
}

}  // extern "C"
