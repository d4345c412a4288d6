// Flash-attention forward for Hopper (sm_90a): softmax(Q K^T * scale) V.
//
// Replaces diffusion_e2e_ft_tpu/kernels/flash_attention.py::_flash_kernel
// (launched there by _flash_bnld) and, with the kLse template flag,
// ::_flash_kernel_lse (launched by _flash_bnld_lse), which also writes the
// backward's residual: the fp32 per-row log-sum-exp m + log l of the scaled
// logits, as an [B, Lq, N] array. Same math: fp32 logits, fp32 online softmax
// (running max m, denominator l, accumulator O), P cast to the input dtype
// before the P.V product, output in the input dtype. What differs from the TPU
// kernel is the schedule: on Hopper nothing carries across blocks, so one block
// owns a Q tile and walks every KV tile in an inner loop. Ragged Lq and Lk are
// masked in the kernel (rows past Lq are never written; columns past Lk get a
// -inf logit), so there is no zero-padding copy of K and V.
//
// With HP > 1 the same kernel replaces ::_flash_kernel_mh, the TPU's
// heads-per-program variant for narrow heads (E2EFT_FA_HP, d < 64): one block
// owns the same Q tile of HP consecutive heads and runs them one after the
// other through the same shared memory, so the grid has HP times fewer
// blocks. The TPU lever (amortizing the per-program prologue over hp heads)
// has no large counterpart on Hopper, where a block's start costs little; the
// variant exists so that the option computes the same function on the card.
//
// Inputs are addressed by strides ([B, L, N, D] with D contiguous, or
// [BN, L, D] as B=BN, N=1), so the attention module passes its projections
// without a transpose.
//
// What bounds it on the H100: at d=64 in bf16, S = Q K^T and P V are about
// 2 * 2 * L^2 * d FLOPs per head against 4 * L * d * 2 bytes of Q, K, V, O:
// at L = 9216 that is ~2300 FLOPs per byte, far above the card's ~295, so the
// kernel is compute-bound and its ceiling is the tensor-core rate (the same
// holds at d = 40, 80, 160 and the GeoWizard lengths). This first version runs
// the products on the tensor cores through WMMA (16x16x16 bf16, fp32
// accumulate) with the accumulator and the logits staged in shared memory; it
// does not use wgmma, TMA or warp specialisation, so it reaches a fraction of
// that ceiling. fp32 inputs take scalar FMA (no TF32), to keep fp32 results
// exact to ~1e-6.
//
// Head dims: 64 (SD2 UNet), 512 (VAE mid block), and GeoWizard's SD1.5 UNet
// at 40, 80 and 160 (8 heads over 320, 640 and 1280 channels).
// - d = 40 is not a multiple of WMMA's 16-wide k step. The bf16 tiles are
//   40 wide in device memory and 48 wide in shared memory, with columns 40-47
//   of Q, K and V zero: Q K^T then runs over k = 48 and P V over n = 48, and
//   the zero columns add nothing (output columns 40-47 are 0 and are not
//   stored). A bf16 row of 40 is 80 bytes, so the 16-byte loads still hold.
// - d = 512: a 64 x 512 fp32 accumulator is 128 KB and cannot live in one
//   block's registers. The accumulator lives in dynamic shared memory with a
//   small Q tile (32 rows in bf16 -> 64 KB; 16 rows in fp32 -> 32 KB), and the
//   shared-memory limit is raised with cudaFuncSetAttribute. Splitting D
//   across blocks would recompute the full-D logits once per split.
// - d = 160: 64 x 64 tiles would need ~133 KB in bf16 (one block per SM, 4
//   warps). A 64-row Q tile with 32-column KV tiles needs ~99 KB, so two
//   blocks share an SM; the 1152-token level-2 shape then fits its 144 blocks
//   in one wave of 132 SMs x 2. fp32 takes 32 x 32 tiles (~87 KB).

#include <mma.h>

#include <cmath>

#include "flash_common.cuh"

namespace {

// Tile configuration per (dtype, head dim).
template <typename T, int D>
struct Cfg;

template <>
struct Cfg<bf16, 40> {
  static constexpr int BQ = 64, BK = 64, THREADS = 128;
};
template <>
struct Cfg<bf16, 64> {
  static constexpr int BQ = 64, BK = 64, THREADS = 128;
};
template <>
struct Cfg<bf16, 80> {
  static constexpr int BQ = 64, BK = 64, THREADS = 128;
};
template <>
struct Cfg<bf16, 160> {
  static constexpr int BQ = 64, BK = 32, THREADS = 128;
};
template <>
struct Cfg<bf16, 512> {
  static constexpr int BQ = 32, BK = 32, THREADS = 256;
};
template <>
struct Cfg<float, 40> {
  static constexpr int BQ = 64, BK = 64, THREADS = 128;
};
template <>
struct Cfg<float, 64> {
  static constexpr int BQ = 64, BK = 64, THREADS = 128;
};
template <>
struct Cfg<float, 80> {
  static constexpr int BQ = 64, BK = 64, THREADS = 128;
};
template <>
struct Cfg<float, 160> {
  static constexpr int BQ = 32, BK = 32, THREADS = 128;
};
template <>
struct Cfg<float, 512> {
  static constexpr int BQ = 16, BK = 16, THREADS = 256;
};

// Shared-memory layout. bf16 tiles are DP = D rounded up to 16 columns wide
// (WMMA's step), rows padded by 8 more elements (16 bytes), which keeps every
// 16-row WMMA tile 32-byte aligned and spreads banks; fp32 rows are padded by
// 1 element, which makes the column walks of the scalar path conflict-free.
template <typename T, int D>
struct Smem {
  using C = Cfg<T, D>;
  static constexpr bool kBf16 = std::is_same<T, bf16>::value;
  static constexpr int DP = kBf16 ? align_up(D, 16) : D;    // columns the products run over
  static constexpr int LDT = kBf16 ? DP + 8 : D + 1;        // Q, K, V row stride (elements)
  static constexpr int LDS = kBf16 ? C::BK + 4 : C::BK + 1;  // S (fp32) row stride
  static constexpr int LDP = C::BK + 8;                     // P (bf16) row stride
  static constexpr int LDO = kBf16 ? DP + 4 : D + 1;        // O (fp32) row stride
  static constexpr int q_off = 0;
  static constexpr int k_off = align_up(q_off + C::BQ * LDT * (int)sizeof(T), kAlign);
  static constexpr int v_off = align_up(k_off + C::BK * LDT * (int)sizeof(T), kAlign);
  static constexpr int s_off = align_up(v_off + C::BK * LDT * (int)sizeof(T), kAlign);
  static constexpr int p_off = align_up(s_off + C::BQ * LDS * 4, kAlign);
  static constexpr int o_off = align_up(p_off + (kBf16 ? C::BQ * LDP * 2 : 0), kAlign);
  static constexpr int m_off = align_up(o_off + C::BQ * LDO * 4, kAlign);
  static constexpr int l_off = m_off + C::BQ * 4;
  static constexpr int c_off = l_off + C::BQ * 4;
  static constexpr int bytes = c_off + C::BQ * 4;
};

// Zero columns [D, DP) of a tile's `rows` rows. load_tile writes columns < D
// only, so the padding set once stays zero for every tile loaded after it.
template <typename T, int D, int DP, int LDT, int THREADS>
__device__ void zero_pad_columns(T* tile, int rows) {
  constexpr int PAD = DP - D;
  for (int i = threadIdx.x; i < rows * PAD; i += THREADS) {
    tile[(i / PAD) * LDT + D + i % PAD] = T(0.f);
  }
}

template <typename T, int D, bool kLse, int HP>
__global__ void __launch_bounds__(Cfg<T, D>::THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, float* __restrict__ lse, int N, int Lq, int Lk, float scale,
                 int64_t q_sb, int64_t q_sl, int64_t q_sn,
                 int64_t k_sb, int64_t k_sl, int64_t k_sn,
                 int64_t v_sb, int64_t v_sl, int64_t v_sn,
                 int64_t o_sb, int64_t o_sl, int64_t o_sn) {
  using C = Cfg<T, D>;
  using L = Smem<T, D>;
  constexpr int BQ = C::BQ, BK = C::BK, THREADS = C::THREADS;
  constexpr int TPR = THREADS / BQ;  // threads sharing one row in the softmax
  static_assert(TPR >= 1 && TPR <= 32 && (TPR & (TPR - 1)) == 0, "row group must fit a warp");
  static_assert(BK % TPR == 0, "columns must split evenly over the row group");

  extern __shared__ __align__(kAlign) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem + L::q_off);
  T* sK = reinterpret_cast<T*>(smem + L::k_off);
  T* sV = reinterpret_cast<T*>(smem + L::v_off);
  float* sS = reinterpret_cast<float*>(smem + L::s_off);
  bf16* sP = reinterpret_cast<bf16*>(smem + L::p_off);
  float* sO = reinterpret_cast<float*>(smem + L::o_off);
  float* sM = reinterpret_cast<float*>(smem + L::m_off);
  float* sL = reinterpret_cast<float*>(smem + L::l_off);
  float* sC = reinterpret_cast<float*>(smem + L::c_off);

  if constexpr (L::DP > D) {  // read by the first tile's products, after the loads' barrier
    zero_pad_columns<T, D, L::DP, L::LDT, THREADS>(sQ, BQ);
    zero_pad_columns<T, D, L::DP, L::LDT, THREADS>(sK, BK);
    zero_pad_columns<T, D, L::DP, L::LDT, THREADS>(sV, BK);
  }

  const int q0 = blockIdx.x * BQ;
  const int q_valid = min(BQ, Lq - q0);
  const int row = threadIdx.x / TPR;   // softmax row of this thread
  const int sub = threadIdx.x % TPR;   // its slot in the row group
  const int warp = threadIdx.x / 32;
  constexpr int WARPS = THREADS / 32;

  // HP consecutive (batch, head) pairs share this block's Q tile index
  for (int h = 0; h < HP; ++h) {
    const int bn = blockIdx.y * HP + h;
    const int b = bn / N, n = bn % N;
    const T* qb = q + b * q_sb + n * q_sn + q0 * q_sl;
    const T* kb = k + b * k_sb + n * k_sn;
    const T* vb = v + b * v_sb + n * v_sn;
    T* ob = o + b * o_sb + n * o_sn + q0 * o_sl;

    if (h > 0) __syncthreads();  // the previous head's O and l are stored
    load_tile<T, D, L::LDT, THREADS>(sQ, qb, q_sl, BQ, q_valid);
    for (int i = threadIdx.x; i < BQ * L::LDO; i += THREADS) sO[i] = 0.f;
    for (int i = threadIdx.x; i < BQ; i += THREADS) {
      sM[i] = -INFINITY;
      sL[i] = 0.f;
    }

    for (int kv0 = 0; kv0 < Lk; kv0 += BK) {
      const int kv_valid = min(BK, Lk - kv0);
      __syncthreads();  // previous tile's K, V, P are consumed
      load_tile<T, D, L::LDT, THREADS>(sK, kb + kv0 * k_sl, k_sl, BK, kv_valid);
      load_tile<T, D, L::LDT, THREADS>(sV, vb + kv0 * v_sl, v_sl, BK, kv_valid);
      __syncthreads();

      // S = Q K^T (unscaled, fp32)
      if constexpr (L::kBf16) {
        using namespace nvcuda;
        constexpr int TN = BK / 16, TILES = (BQ / 16) * TN;
        for (int t = warp; t < TILES; t += WARPS) {
          const int m0 = (t / TN) * 16, n0 = (t % TN) * 16;
          wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
          wmma::fill_fragment(acc, 0.f);
#pragma unroll 4
          for (int d0 = 0; d0 < L::DP; d0 += 16) {
            wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
            wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
            wmma::load_matrix_sync(fa, sQ + m0 * L::LDT + d0, L::LDT);
            wmma::load_matrix_sync(fb, sK + n0 * L::LDT + d0, L::LDT);  // K rows = K^T columns
            wmma::mma_sync(acc, fa, fb, acc);
          }
          wmma::store_matrix_sync(sS + m0 * L::LDS + n0, acc, L::LDS, wmma::mem_row_major);
        }
      } else {
        for (int i = threadIdx.x; i < BQ * BK; i += THREADS) {
          const int r = i / BK, c = i % BK;
          const float* qr = sQ + r * L::LDT;
          const float* kr = sK + c * L::LDT;
          float acc = 0.f;
#pragma unroll 8
          for (int d = 0; d < D; ++d) acc = fmaf(qr[d], kr[d], acc);
          sS[r * L::LDS + c] = acc;
        }
      }
      __syncthreads();

      // Online softmax over this tile: TPR threads per row, reduced by shuffles.
      {
        float* srow = sS + row * L::LDS;
        float mx = -INFINITY;
        for (int c = sub; c < BK; c += TPR) {
          const float s = c < kv_valid ? srow[c] * scale : -INFINITY;
          srow[c] = s;
          mx = fmaxf(mx, s);
        }
#pragma unroll
        for (int off = TPR / 2; off > 0; off /= 2) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        const float m_prev = sM[row];
        const float m_new = fmaxf(m_prev, mx);  // finite: every tile has a valid column
        float sum = 0.f;
        for (int c = sub; c < BK; c += TPR) {
          const float p = exp_<L::kBf16>(srow[c] - m_new);
          sum += p;
          if constexpr (L::kBf16) {
            sP[row * L::LDP + c] = __float2bfloat16(p);
          } else {
            srow[c] = p;
          }
        }
#pragma unroll
        for (int off = TPR / 2; off > 0; off /= 2) sum += __shfl_xor_sync(0xffffffffu, sum, off);
        if (sub == 0) {
          const float corr = exp_<L::kBf16>(m_prev - m_new);  // 0 on the first tile
          sM[row] = m_new;
          sL[row] = sL[row] * corr + sum;
          sC[row] = corr;
        }
      }
      __syncthreads();

      // O = O * corr + P V
      if constexpr (L::kBf16) {
        using namespace nvcuda;
        for (int i = threadIdx.x; i < BQ * D; i += THREADS) {
          const int r = i / D, c = i % D;
          sO[r * L::LDO + c] *= sC[r];  // columns past D stay 0: V's padding is 0
        }
        __syncthreads();
        constexpr int TN = L::DP / 16, TILES = (BQ / 16) * TN;
        for (int t = warp; t < TILES; t += WARPS) {
          const int m0 = (t / TN) * 16, n0 = (t % TN) * 16;
          wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
          wmma::load_matrix_sync(acc, sO + m0 * L::LDO + n0, L::LDO, wmma::mem_row_major);
#pragma unroll
          for (int j0 = 0; j0 < BK; j0 += 16) {
            wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
            wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
            wmma::load_matrix_sync(fa, sP + m0 * L::LDP + j0, L::LDP);
            wmma::load_matrix_sync(fb, sV + j0 * L::LDT + n0, L::LDT);
            wmma::mma_sync(acc, fa, fb, acc);
          }
          wmma::store_matrix_sync(sO + m0 * L::LDO + n0, acc, L::LDO, wmma::mem_row_major);
        }
      } else {
        for (int i = threadIdx.x; i < BQ * D; i += THREADS) {
          const int r = i / D, c = i % D;
          const float* prow = sS + r * L::LDS;
          float acc = sO[r * L::LDO + c] * sC[r];
#pragma unroll 8
          for (int j = 0; j < BK; ++j) acc = fmaf(prow[j], sV[j * L::LDT + c], acc);
          sO[r * L::LDO + c] = acc;
        }
      }
    }
    __syncthreads();

    for (int i = threadIdx.x; i < q_valid * D; i += THREADS) {
      const int r = i / D, c = i % D;
      const float val = sO[r * L::LDO + c] / sL[r];
      if constexpr (L::kBf16) {
        ob[r * o_sl + c] = __float2bfloat16(val);
      } else {
        ob[r * o_sl + c] = val;
      }
    }
    if constexpr (kLse) {
      for (int r = threadIdx.x; r < q_valid; r += THREADS) {
        lse[(static_cast<int64_t>(b) * Lq + q0 + r) * N + n] = sM[r] + logf(sL[r]);
      }
    }
  }
}

template <typename T, int D, bool kLse, int HP>
int launch_variant(const void* q, const void* k, const void* v, void* o, float* lse, int B,
                   int N, int Lq, int Lk, float scale, const int64_t* s, cudaStream_t stream) {
  using C = Cfg<T, D>;
  constexpr int bytes = Smem<T, D>::bytes;
  static_assert(bytes <= 227 * 1024, "tile does not fit shared memory");
  auto kernel = flash_fwd_kernel<T, D, kLse, HP>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((Lq + C::BQ - 1) / C::BQ, B * N / HP);
  kernel<<<grid, C::THREADS, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), lse, N, Lq, Lk, scale, s[0], s[1], s[2], s[3], s[4], s[5], s[6], s[7],
      s[8], s[9], s[10], s[11]);
  return static_cast<int>(cudaGetLastError());
}

// The forward at one head per block; with an lse array at d = 64 and 512 only
// (the head dims of the trained models).
template <typename T>
int launch_fwd(const void* q, const void* k, const void* v, void* o, float* lse, int B, int N,
               int Lq, int Lk, int D, float scale, const int64_t* s, cudaStream_t st) {
  if (lse != nullptr) {
    if (D == 64) return launch_variant<T, 64, true, 1>(q, k, v, o, lse, B, N, Lq, Lk, scale, s, st);
    if (D == 512) return launch_variant<T, 512, true, 1>(q, k, v, o, lse, B, N, Lq, Lk, scale, s, st);
    return -1;
  }
  switch (D) {
    case 40: return launch_variant<T, 40, false, 1>(q, k, v, o, lse, B, N, Lq, Lk, scale, s, st);
    case 64: return launch_variant<T, 64, false, 1>(q, k, v, o, lse, B, N, Lq, Lk, scale, s, st);
    case 80: return launch_variant<T, 80, false, 1>(q, k, v, o, lse, B, N, Lq, Lk, scale, s, st);
    case 160: return launch_variant<T, 160, false, 1>(q, k, v, o, lse, B, N, Lq, Lk, scale, s, st);
    case 512: return launch_variant<T, 512, false, 1>(q, k, v, o, lse, B, N, Lq, Lk, scale, s, st);
    default: return -1;
  }
}

// The heads-per-block forward, at the narrow head dim (40) only.
template <typename T>
int launch_fwd_mh(const void* q, const void* k, const void* v, void* o, int B, int N, int Lq,
                  int Lk, int D, int hp, float scale, const int64_t* s, cudaStream_t st) {
  if (D != 40 || (B * N) % hp != 0) return -1;
  switch (hp) {
    case 2: return launch_variant<T, 40, false, 2>(q, k, v, o, nullptr, B, N, Lq, Lk, scale, s, st);
    case 4: return launch_variant<T, 40, false, 4>(q, k, v, o, nullptr, B, N, Lq, Lk, scale, s, st);
    case 8: return launch_variant<T, 40, false, 8>(q, k, v, o, nullptr, B, N, Lq, Lk, scale, s, st);
    default: return -1;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. strides (elements): q (b, l, n), k, v, o.
// lse: null for the plain forward, else a contiguous fp32 [B, Lq, N] array
// that receives each row's log-sum-exp (D = 64 or 512). Returns 0, a
// cudaError_t from the launch, or -1 for an unsupported (dtype, head dim)
// pair. Launches on `stream` and does not synchronise.
int e2eft_flash_attention_fwd(const void* q, const void* k, const void* v, void* o, float* lse,
                              int dtype, int B, int N, int Lq, int Lk, int D, float scale,
                              const int64_t* strides, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return launch_fwd<bf16>(q, k, v, o, lse, B, N, Lq, Lk, D, scale, strides, st);
  if (dtype == 0) return launch_fwd<float>(q, k, v, o, lse, B, N, Lq, Lk, D, scale, strides, st);
  return -1;
}

// The same forward with `hp` (2, 4 or 8) consecutive (batch, head) pairs per
// block, D = 40; B * N must divide by hp. Returns as above.
int e2eft_flash_attention_fwd_mh(const void* q, const void* k, const void* v, void* o, int dtype,
                                 int B, int N, int Lq, int Lk, int D, int hp, float scale,
                                 const int64_t* strides, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return launch_fwd_mh<bf16>(q, k, v, o, B, N, Lq, Lk, D, hp, scale, strides, st);
  if (dtype == 0) return launch_fwd_mh<float>(q, k, v, o, B, N, Lq, Lk, D, hp, scale, strides, st);
  return -1;
}

}  // extern "C"
