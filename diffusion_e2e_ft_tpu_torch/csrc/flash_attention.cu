// Flash-attention forward for Hopper (sm_90a): softmax(Q K^T * scale) V.
//
// Replaces diffusion_e2e_ft_tpu/kernels/flash_attention.py::_flash_kernel
// (launched there by _flash_bnld) and, with the kLse template flag,
// ::_flash_kernel_lse (launched by _flash_bnld_lse), which also writes the
// backward's residual: the fp32 per-row natural-log log-sum-exp of the scaled
// logits, as an [B, Lq, N] array. With HP > 1 the same kernel replaces
// ::_flash_kernel_mh, the TPU's heads-per-program variant for narrow heads
// (E2EFT_FA_HP, d < 64): a block walks the same Q tile of HP consecutive
// (batch, head) pairs one after the other, so the grid has HP times fewer
// blocks. Same math as the TPU kernels: fp32 logits, fp32 online softmax, P
// cast to bf16 before the P.V product, output in the input dtype. On Hopper
// nothing carries across blocks, so a block owns a Q tile and walks every KV
// tile in an inner loop. Ragged Lq and Lk are masked in the kernel (rows past
// Lq are zero-filled and never written; columns past Lk get a -inf logit).
// Inputs are addressed by strides ([B, L, N, D] with D contiguous), so the
// attention module passes its projections without a transpose.
//
// What bounds it on the H100: Q K^T and P V are 4 L^2 d FLOPs per head
// against 4 L d * 2 bytes of Q, K, V, O; at d = 64 and L = 9216 that is
// ~2300 FLOPs a byte against the card's ~295, so every main-path shape is
// compute-bound and the ceiling is the tensor cores. What keeps a kernel off
// that ceiling is everything around the products: shared-memory round trips
// of the logits and the accumulator, loads the tensor cores wait for, and
// block-wide barriers. The bf16 kernel (FlashAttention-2's schedule) removes
// them:
// - Each warp owns 16 Q rows for the whole KV loop. Its Q fragments stay in
//   registers; S = Q K^T, the running max m and sum l, and the O accumulator
//   live in registers in mma.sync's C-fragment layout.
// - The softmax runs on those fragments: a row's four owners reduce the row
//   max with two quad shuffles; l is kept per thread and reduced once at the
//   end. exp2 with scale * log2(e) folded into one FMA; m is kept in that
//   base-2 scale, and the LSE goes back to the natural log once per row:
//   lse = (m + log2 l) ln 2.
// - P goes from the C layout to the A layout of P V in registers (two
//   neighbouring 16x8 C tiles are one 16x16 A tile) and never touches shared
//   memory; O is rescaled in registers once per KV tile.
// - K and V arrive through a ring of STAGES shared-memory stages filled by
//   cp.async (16-byte copies, zero-filled past Lk by a source size of 0):
//   tile j + STAGES - 1 is in flight while tile j computes, and one block
//   barrier per KV tile both publishes a stage and frees the previous one.
// - Products: ldmatrix + mma.sync m16n8k16 (bf16 in, fp32 accumulate), with
//   rows padded by 16 bytes so every ldmatrix is free of bank conflicts.
//   mma.sync rather than wgmma: it keeps P in registers in a documented
//   fragment layout and needs no shared-memory descriptors; it does not reach
//   wgmma's rate.
// Tiles (Tile<D> below): 128 Q rows (8 warps) at d <= 80, which halves the
// K/V traffic per Q row against 64; 64 rows (4 warps) at d = 160, whose Q
// fragments (40 registers) and 16 x 160 accumulator (80) leave no room for a
// second row block per warp. d = 40 runs padded to 48 (three k-steps of 16
// and six 8-wide n-tiles): cp.async fills columns 0-39, columns 40-47 of
// every Q, K and V row are zeroed once per block, so Q K^T adds nothing from
// them and output columns 40-47 are dropped.
// d = 512 (the VAE mid block) splits d across warps: a 64 x 512 fp32
// accumulator is 512 registers a thread over one warp group. 8 warps form 4
// row groups x 2 halves; each warp owns O[16 rows, 256 columns] (128
// registers) and computes its half's partial logits over its 256 columns of
// d; the two halves exchange partials through a 64 x 32 fp32 buffer and a
// named barrier per row-group pair, and each adds the other's to its own
// (commutative, so both hold the same S bit for bit and run the same
// softmax). Q (64 x 512) stays in shared memory and is re-read per tile;
// with two K/V stages of 32 rows the block takes 215 KB of shared memory.
//
// fp32 inputs (the parity dtype, not the serving one) take their own scalar
// body (flash_fwd_kernel_fp32): FMA in shared memory, exact to ~1e-6, with no
// tensor cores (no TF32).

#include <cmath>

#include "flash_common.cuh"
#include "mma_common.cuh"

namespace {

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// ---------------------------------------------------------------- bf16 ----

// bf16 tiles per head dim: BQ Q rows a block (16 a warp per row group), BK
// KV rows a stage, DS warps splitting d, STAGES K/V stages, and the resident
// blocks an SM the registers are held to.
template <int D>
struct Tile;
template <>
struct Tile<40> {
  static constexpr int BQ = 128, BK = 64, DS = 1, STAGES = 3, MIN_BLOCKS = 2;
};
template <>
struct Tile<64> {
  static constexpr int BQ = 128, BK = 64, DS = 1, STAGES = 3, MIN_BLOCKS = 2;
};
template <>
struct Tile<80> {
  static constexpr int BQ = 128, BK = 64, DS = 1, STAGES = 3, MIN_BLOCKS = 2;
};
template <>
struct Tile<160> {
  static constexpr int BQ = 64, BK = 64, DS = 1, STAGES = 2, MIN_BLOCKS = 2;
};
template <>
struct Tile<512> {
  static constexpr int BQ = 64, BK = 32, DS = 2, STAGES = 2, MIN_BLOCKS = 1;
};

// Shared memory: Q's BQ rows, then each stage's BK K rows and BK V rows, all
// DP = D rounded up to 16 columns wide with a 16-byte row pad (LDT); then,
// with DS > 1, the DS halves' partial logits, BQ x BK fp32 each.
template <int D>
struct Bf16Smem {
  using C = Tile<D>;
  static constexpr int THREADS = 32 * (C::BQ / 16) * C::DS;
  static constexpr int DP = align_up(D, 16);
  static constexpr int LDT = DP + 8;
  static constexpr int LDS = C::BK + 8;
  static constexpr int rows = C::BQ + C::STAGES * 2 * C::BK;
  static constexpr int s_off = rows * LDT * 2;
  static constexpr int bytes = s_off + (C::DS > 1 ? C::DS * C::BQ * LDS * 4 : 0);
};

template <int D, bool kLse, int HP>
__global__ void __launch_bounds__(Bf16Smem<D>::THREADS, Tile<D>::MIN_BLOCKS)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
                 bf16* __restrict__ o, float* __restrict__ lse, int N, int Lq, int Lk, float scale,
                 int64_t q_sb, int64_t q_sl, int64_t q_sn,
                 int64_t k_sb, int64_t k_sl, int64_t k_sn,
                 int64_t v_sb, int64_t v_sl, int64_t v_sn,
                 int64_t o_sb, int64_t o_sl, int64_t o_sn) {
  using C = Tile<D>;
  using L = Bf16Smem<D>;
  constexpr int BQ = C::BQ, BK = C::BK, DS = C::DS, STAGES = C::STAGES, THREADS = L::THREADS;
  constexpr int LDT = L::LDT, LDS = L::LDS;
  constexpr int DW = L::DP / DS;  // columns of d one warp covers
  constexpr int KSTEPS = DW / 16, SN = BK / 8, ON = DW / 8;
  constexpr bool kQRegs = DS == 1;  // Q fragments in registers; else re-read from shared memory
  static_assert(DS <= 2, "the halves' partial logits are summed in an order both share");
  static_assert(L::DP == D || L::DP == D + 8, "the padding is one 16-byte column chunk");
  static_assert(SN % 2 == 0 && ON % 2 == 0 && STAGES >= 2, "x4 ldmatrix loads two n-tiles");
  static_assert(L::bytes <= 227 * 1024, "tiles do not fit shared memory");

  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sKV = sQ + BQ * LDT;  // stage s: K at sKV + 2 s BK LDT, V BK LDT after it
  float* sS = reinterpret_cast<float*>(smem + L::s_off);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int rg = warp % (BQ / 16), part = warp / (BQ / 16);
  const int wrow = 16 * rg, dcol = DW * part;
  // ldmatrix row addresses: A (Q) and transposed B (V) rows lane % 16 at
  // column 8 (lane / 16); B (K) rows lane % 8 + 8 (lane / 16) at 8 ((lane / 8) % 2)
  const int a_row = lane % 16, a_col = 8 * (lane / 16);
  const int b_row = lane % 8 + 8 * (lane / 16), b_col = 8 * ((lane / 8) % 2);

  if constexpr (L::DP > D) {  // columns D..DP-1 of every row; cp.async never writes them
    for (int r = threadIdx.x; r < L::rows; r += THREADS)
      *reinterpret_cast<uint4*>(sQ + r * LDT + D) = make_uint4(0, 0, 0, 0);
  }

  const float sl2 = scale * kLog2e;
  const int q0 = blockIdx.x * BQ;
  const int q_valid = min(BQ, Lq - q0);
  const int n_tiles = (Lk + BK - 1) / BK;

#pragma unroll 1
  for (int h = 0; h < HP; ++h) {
    const int bn = blockIdx.y * HP + h;
    const int b = bn / N, n = bn % N;
    const bf16* kb = k + b * k_sb + n * k_sn;
    const bf16* vb = v + b * v_sb + n * v_sn;
    auto load_kv = [&](int tile) {
      bf16* dst = sKV + (tile % STAGES) * 2 * BK * LDT;
      const int kv0 = tile * BK, valid = min(BK, Lk - kv0);
      load_rows_async<D, LDT, THREADS, BK>(dst, kb + kv0 * k_sl, k_sl, valid);
      load_rows_async<D, LDT, THREADS, BK>(dst + BK * LDT, vb + kv0 * v_sl, v_sl, valid);
    };

    if (h > 0) __syncthreads();  // every warp is done with the previous head's Q and stages
    load_rows_async<D, LDT, THREADS, BQ>(sQ, q + b * q_sb + n * q_sn + q0 * q_sl, q_sl, q_valid);
    cp_async_commit();
#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
      if (s < n_tiles) load_kv(s);
      cp_async_commit();  // one group per stage, empty past the last tile
    }

    uint32_t qf[kQRegs ? KSTEPS : 1][4];
    if constexpr (kQRegs) {
      cp_async_wait<STAGES - 1>();  // Q's group
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk) ldmatrix_x4(qf[kk], sQ + (wrow + a_row) * LDT + 16 * kk + a_col);
    }

    float acc[ON][4];
#pragma unroll
    for (int jn = 0; jn < ON; ++jn)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[jn][e] = 0.f;
    float m[2] = {-INFINITY, -INFINITY};  // rows g and g + 8, in base-2 scaled units
    float l[2] = {0.f, 0.f};              // this thread's columns only

#pragma unroll 1
    for (int j = 0; j < n_tiles; ++j) {
      cp_async_wait<STAGES - 2>();
      __syncthreads();  // tile j is in; every warp is done with tile j - 1's stage
      if (j + STAGES - 1 < n_tiles) load_kv(j + STAGES - 1);
      cp_async_commit();
      const bf16* sK = sKV + (j % STAGES) * 2 * BK * LDT;
      const bf16* sV = sK + BK * LDT;

      // S = Q K^T over this warp's columns of d (unscaled, fp32)
      float s[SN][4];
#pragma unroll
      for (int jn = 0; jn < SN; ++jn)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[jn][e] = 0.f;
      auto qk_step = [&](const uint32_t(&a)[4], int kk) {
#pragma unroll
        for (int jj = 0; jj < SN / 2; ++jj) {
          uint32_t bk[4];
          ldmatrix_x4(bk, sK + (16 * jj + b_row) * LDT + dcol + 16 * kk + b_col);
          mma_bf16(s[2 * jj], a, bk[0], bk[1]);
          mma_bf16(s[2 * jj + 1], a, bk[2], bk[3]);
        }
      };
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk) {
        if constexpr (kQRegs) {
          qk_step(qf[kk], kk);
        } else {
          uint32_t a[4];
          ldmatrix_x4(a, sQ + (wrow + a_row) * LDT + dcol + 16 * kk + a_col);
          qk_step(a, kk);
        }
      }

      if constexpr (DS > 1) {  // add the other half's partial logits
        float* mine = sS + (part * BQ + wrow) * LDS;
        const float* other = sS + ((1 - part) * BQ + wrow) * LDS;
#pragma unroll
        for (int jn = 0; jn < SN; ++jn) {
          *reinterpret_cast<float2*>(mine + g * LDS + 8 * jn + 2 * t) = make_float2(s[jn][0], s[jn][1]);
          *reinterpret_cast<float2*>(mine + (g + 8) * LDS + 8 * jn + 2 * t) = make_float2(s[jn][2], s[jn][3]);
        }
        named_barrier(1 + rg, 32 * DS);
#pragma unroll
        for (int jn = 0; jn < SN; ++jn) {
          const float2 x0 = *reinterpret_cast<const float2*>(other + g * LDS + 8 * jn + 2 * t);
          const float2 x1 = *reinterpret_cast<const float2*>(other + (g + 8) * LDS + 8 * jn + 2 * t);
          s[jn][0] += x0.x;
          s[jn][1] += x0.y;
          s[jn][2] += x1.x;
          s[jn][3] += x1.y;
        }
      }

      const int kv0 = j * BK;
      if (kv0 + BK > Lk) {  // the ragged last tile
#pragma unroll
        for (int jn = 0; jn < SN; ++jn)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (kv0 + 8 * jn + 2 * t + (e & 1) >= Lk) s[jn][e] = -INFINITY;
      }

      // online softmax in registers; every tile has a valid column, so the max is finite
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int jn = 0; jn < SN; ++jn) {
        mx[0] = fmaxf(mx[0], fmaxf(s[jn][0], s[jn][1]));
        mx[1] = fmaxf(mx[1], fmaxf(s[jn][2], s[jn][3]));
      }
      float corr[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m[r], mx[r] * sl2);
        corr[r] = exp2_approx(m[r] - m_new);  // 0 on the first tile
        m[r] = m_new;
        l[r] *= corr[r];
      }
#pragma unroll
      for (int jn = 0; jn < SN; ++jn)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[jn][e] = exp2_approx(fmaf(s[jn][e], sl2, -m[e / 2]));
          l[e / 2] += s[jn][e];
        }
#pragma unroll
      for (int jn = 0; jn < ON; ++jn) {
        acc[jn][0] *= corr[0];
        acc[jn][1] *= corr[0];
        acc[jn][2] *= corr[1];
        acc[jn][3] *= corr[1];
      }

      // O += P V, P as bf16 A fragments straight from the S registers
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint32_t a[4] = {pack_bf16x2(s[2 * kk][0], s[2 * kk][1]), pack_bf16x2(s[2 * kk][2], s[2 * kk][3]),
                               pack_bf16x2(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                               pack_bf16x2(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
        for (int jj = 0; jj < ON / 2; ++jj) {
          uint32_t bv[4];
          ldmatrix_x4_trans(bv, sV + (16 * kk + a_row) * LDT + dcol + 16 * jj + a_col);
          mma_bf16(acc[2 * jj], a, bv[0], bv[1]);
          mma_bf16(acc[2 * jj + 1], a, bv[2], bv[3]);
        }
      }
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    }
    bf16* ob = o + b * o_sb + n * o_sn;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = wrow + g + 8 * r;
      if (row >= q_valid) continue;
      const float inv = 1.f / l[r];
      bf16* orow = ob + (q0 + row) * o_sl;
#pragma unroll
      for (int jn = 0; jn < ON; ++jn) {
        const int col = dcol + 8 * jn + 2 * t;
        if (col < D)
          *reinterpret_cast<__nv_bfloat162*>(orow + col) =
              __floats2bfloat162_rn(acc[jn][2 * r] * inv, acc[jn][2 * r + 1] * inv);
      }
      if constexpr (kLse) {
        if (part == 0 && t == 0)
          lse[(static_cast<int64_t>(b) * Lq + q0 + row) * N + n] = (m[r] + log2f(l[r])) * kLn2;
      }
    }
  }
}

// ---------------------------------------------------------------- fp32 ----

// fp32 tiles per head dim (scalar FMA through shared memory).
template <int D>
struct Cfg;
template <>
struct Cfg<40> {
  static constexpr int BQ = 64, BK = 64, THREADS = 128;
};
template <>
struct Cfg<64> {
  static constexpr int BQ = 64, BK = 64, THREADS = 128;
};
template <>
struct Cfg<80> {
  static constexpr int BQ = 64, BK = 64, THREADS = 128;
};
template <>
struct Cfg<160> {
  static constexpr int BQ = 32, BK = 32, THREADS = 128;
};
template <>
struct Cfg<512> {
  static constexpr int BQ = 16, BK = 16, THREADS = 256;
};

// Rows padded by one element, which makes the column walks conflict-free.
template <int D>
struct Fp32Smem {
  using C = Cfg<D>;
  static constexpr int LDT = D + 1;       // Q, K, V and O row stride
  static constexpr int LDS = C::BK + 1;   // S row stride
  static constexpr int k_off = align_up(C::BQ * LDT * 4, kAlign);
  static constexpr int v_off = align_up(k_off + C::BK * LDT * 4, kAlign);
  static constexpr int s_off = align_up(v_off + C::BK * LDT * 4, kAlign);
  static constexpr int o_off = align_up(s_off + C::BQ * LDS * 4, kAlign);
  static constexpr int m_off = align_up(o_off + C::BQ * LDT * 4, kAlign);
  static constexpr int l_off = m_off + C::BQ * 4;
  static constexpr int c_off = l_off + C::BQ * 4;
  static constexpr int bytes = c_off + C::BQ * 4;
};

template <int D, bool kLse, int HP>
__global__ void __launch_bounds__(Cfg<D>::THREADS)
flash_fwd_kernel_fp32(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                      float* __restrict__ o, float* __restrict__ lse, int N, int Lq, int Lk, float scale,
                      int64_t q_sb, int64_t q_sl, int64_t q_sn,
                      int64_t k_sb, int64_t k_sl, int64_t k_sn,
                      int64_t v_sb, int64_t v_sl, int64_t v_sn,
                      int64_t o_sb, int64_t o_sl, int64_t o_sn) {
  using C = Cfg<D>;
  using L = Fp32Smem<D>;
  constexpr int BQ = C::BQ, BK = C::BK, THREADS = C::THREADS;
  constexpr int TPR = THREADS / BQ;  // threads sharing one row in the softmax
  static_assert(TPR >= 1 && TPR <= 32 && (TPR & (TPR - 1)) == 0, "row group must fit a warp");
  static_assert(BK % TPR == 0, "columns must split evenly over the row group");

  extern __shared__ __align__(kAlign) unsigned char smem[];
  float* sQ = reinterpret_cast<float*>(smem);
  float* sK = reinterpret_cast<float*>(smem + L::k_off);
  float* sV = reinterpret_cast<float*>(smem + L::v_off);
  float* sS = reinterpret_cast<float*>(smem + L::s_off);
  float* sO = reinterpret_cast<float*>(smem + L::o_off);
  float* sM = reinterpret_cast<float*>(smem + L::m_off);
  float* sL = reinterpret_cast<float*>(smem + L::l_off);
  float* sC = reinterpret_cast<float*>(smem + L::c_off);

  const int q0 = blockIdx.x * BQ;
  const int q_valid = min(BQ, Lq - q0);
  const int row = threadIdx.x / TPR;  // softmax row of this thread
  const int sub = threadIdx.x % TPR;  // its slot in the row group

  for (int h = 0; h < HP; ++h) {
    const int bn = blockIdx.y * HP + h;
    const int b = bn / N, n = bn % N;
    const float* kb = k + b * k_sb + n * k_sn;
    const float* vb = v + b * v_sb + n * v_sn;
    float* ob = o + b * o_sb + n * o_sn + q0 * o_sl;

    if (h > 0) __syncthreads();  // the previous head's O and l are stored
    load_tile<D, L::LDT, THREADS>(sQ, q + b * q_sb + n * q_sn + q0 * q_sl, q_sl, BQ, q_valid);
    for (int i = threadIdx.x; i < BQ * L::LDT; i += THREADS) sO[i] = 0.f;
    for (int i = threadIdx.x; i < BQ; i += THREADS) {
      sM[i] = -INFINITY;
      sL[i] = 0.f;
    }

    for (int kv0 = 0; kv0 < Lk; kv0 += BK) {
      const int kv_valid = min(BK, Lk - kv0);
      __syncthreads();  // previous tile's K, V, S are consumed
      load_tile<D, L::LDT, THREADS>(sK, kb + kv0 * k_sl, k_sl, BK, kv_valid);
      load_tile<D, L::LDT, THREADS>(sV, vb + kv0 * v_sl, v_sl, BK, kv_valid);
      __syncthreads();

      for (int i = threadIdx.x; i < BQ * BK; i += THREADS) {  // S = Q K^T (unscaled)
        const int r = i / BK, c = i % BK;
        const float* qr = sQ + r * L::LDT;
        const float* kr = sK + c * L::LDT;
        float acc = 0.f;
#pragma unroll 8
        for (int d = 0; d < D; ++d) acc = fmaf(qr[d], kr[d], acc);
        sS[r * L::LDS + c] = acc;
      }
      __syncthreads();

      {  // online softmax over this tile: TPR threads per row, reduced by shuffles
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
          const float p = expf(srow[c] - m_new);
          sum += p;
          srow[c] = p;
        }
#pragma unroll
        for (int off = TPR / 2; off > 0; off /= 2) sum += __shfl_xor_sync(0xffffffffu, sum, off);
        if (sub == 0) {
          const float corr = expf(m_prev - m_new);  // 0 on the first tile
          sM[row] = m_new;
          sL[row] = sL[row] * corr + sum;
          sC[row] = corr;
        }
      }
      __syncthreads();

      for (int i = threadIdx.x; i < BQ * D; i += THREADS) {  // O = O * corr + P V
        const int r = i / D, c = i % D;
        const float* prow = sS + r * L::LDS;
        float acc = sO[r * L::LDT + c] * sC[r];
#pragma unroll 8
        for (int j = 0; j < BK; ++j) acc = fmaf(prow[j], sV[j * L::LDT + c], acc);
        sO[r * L::LDT + c] = acc;
      }
    }
    __syncthreads();

    for (int i = threadIdx.x; i < q_valid * D; i += THREADS) {
      const int r = i / D, c = i % D;
      ob[r * o_sl + c] = sO[r * L::LDT + c] / sL[r];
    }
    if constexpr (kLse) {
      for (int r = threadIdx.x; r < q_valid; r += THREADS) {
        lse[(static_cast<int64_t>(b) * Lq + q0 + r) * N + n] = sM[r] + logf(sL[r]);
      }
    }
  }
}

// ------------------------------------------------------------- launch ----

template <typename KernelFn, typename T>
int launch_kernel(KernelFn kernel, int bytes, dim3 grid, int threads, const void* q, const void* k,
                  const void* v, void* o, float* lse, int N, int Lq, int Lk, float scale, const int64_t* s,
                  cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, threads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), static_cast<T*>(o), lse, N,
      Lq, Lk, scale, s[0], s[1], s[2], s[3], s[4], s[5], s[6], s[7], s[8], s[9], s[10], s[11]);
  return static_cast<int>(cudaGetLastError());
}

// dtype 1: the bf16 kernel; 0: the fp32 one.
template <int D, bool kLse, int HP>
int launch_variant(int dtype, const void* q, const void* k, const void* v, void* o, float* lse, int B, int N,
                   int Lq, int Lk, float scale, const int64_t* s, cudaStream_t st) {
  if (dtype == 1) {
    constexpr int BQ = Tile<D>::BQ;
    return launch_kernel<decltype(&flash_fwd_kernel<D, kLse, HP>), bf16>(
        flash_fwd_kernel<D, kLse, HP>, Bf16Smem<D>::bytes, dim3((Lq + BQ - 1) / BQ, B * N / HP),
        Bf16Smem<D>::THREADS, q, k, v, o, lse, N, Lq, Lk, scale, s, st);
  }
  if (dtype == 0) {
    using C = Cfg<D>;
    static_assert(Fp32Smem<D>::bytes <= 227 * 1024, "tile does not fit shared memory");
    return launch_kernel<decltype(&flash_fwd_kernel_fp32<D, kLse, HP>), float>(
        flash_fwd_kernel_fp32<D, kLse, HP>, Fp32Smem<D>::bytes, dim3((Lq + C::BQ - 1) / C::BQ, B * N / HP),
        C::THREADS, q, k, v, o, lse, N, Lq, Lk, scale, s, st);
  }
  return -1;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. strides (elements): q (b, l, n), k, v, o.
// lse: null for the plain forward, else a contiguous fp32 [B, Lq, N] array
// that receives each row's natural-log log-sum-exp. Both take D = 40, 64, 80,
// 160 or 512. Returns 0, a cudaError_t from the launch, or -1 for an
// unsupported (dtype, head dim) pair. Launches on `stream` and does not
// synchronise.
int e2eft_flash_attention_fwd(const void* q, const void* k, const void* v, void* o, float* lse, int dtype, int B,
                              int N, int Lq, int Lk, int D, float scale, const int64_t* strides, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (lse != nullptr) {
    switch (D) {
      case 40: return launch_variant<40, true, 1>(dtype, q, k, v, o, lse, B, N, Lq, Lk, scale, strides, st);
      case 64: return launch_variant<64, true, 1>(dtype, q, k, v, o, lse, B, N, Lq, Lk, scale, strides, st);
      case 80: return launch_variant<80, true, 1>(dtype, q, k, v, o, lse, B, N, Lq, Lk, scale, strides, st);
      case 160: return launch_variant<160, true, 1>(dtype, q, k, v, o, lse, B, N, Lq, Lk, scale, strides, st);
      case 512: return launch_variant<512, true, 1>(dtype, q, k, v, o, lse, B, N, Lq, Lk, scale, strides, st);
      default: return -1;
    }
  }
  switch (D) {
    case 40: return launch_variant<40, false, 1>(dtype, q, k, v, o, lse, B, N, Lq, Lk, scale, strides, st);
    case 64: return launch_variant<64, false, 1>(dtype, q, k, v, o, lse, B, N, Lq, Lk, scale, strides, st);
    case 80: return launch_variant<80, false, 1>(dtype, q, k, v, o, lse, B, N, Lq, Lk, scale, strides, st);
    case 160: return launch_variant<160, false, 1>(dtype, q, k, v, o, lse, B, N, Lq, Lk, scale, strides, st);
    case 512: return launch_variant<512, false, 1>(dtype, q, k, v, o, lse, B, N, Lq, Lk, scale, strides, st);
    default: return -1;
  }
}

// The same forward with `hp` (2, 4 or 8) consecutive (batch, head) pairs per
// block, D = 40; B * N must divide by hp. Returns as above.
int e2eft_flash_attention_fwd_mh(const void* q, const void* k, const void* v, void* o, int dtype, int B, int N,
                                 int Lq, int Lk, int D, int hp, float scale, const int64_t* strides, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D != 40 || (B * N) % hp != 0) return -1;
  switch (hp) {
    case 2: return launch_variant<40, false, 2>(dtype, q, k, v, o, nullptr, B, N, Lq, Lk, scale, strides, st);
    case 4: return launch_variant<40, false, 4>(dtype, q, k, v, o, nullptr, B, N, Lq, Lk, scale, strides, st);
    case 8: return launch_variant<40, false, 8>(dtype, q, k, v, o, nullptr, B, N, Lq, Lk, scale, strides, st);
    default: return -1;
  }
}

}  // extern "C"
