// Flash-attention backward for Hopper (sm_90a), in the FlashAttention-2 form:
// two kernels, no atomics.
//
// Replaces diffusion_e2e_ft_tpu/kernels/flash_attention.py::_dq_kernel and
// ::_dkv_kernel (both launched by _flash_bwd_bnld). Same math: the
// probabilities are recomputed from the forward's per-row log-sum-exp,
// p = exp(s * scale - lse), and with delta = rowsum(dO * O) (computed by the
// caller in fp32)
//   dq = ds K,   dv = P^T dO,   dk = ds^T Q,   ds = p (dO V^T - delta) scale.
// Products accumulate in fp32; for bf16 inputs P and ds are cast to bf16
// before their products, as the TPU kernels cast them to the input dtype.
//
// What differs from the TPU kernels is the schedule. There, the sequential
// innermost grid axis carries the accumulators between grid steps. Here the
// dq kernel gives one block a Q tile and loops over every KV tile inside it;
// the dk/dv kernel gives one block a KV tile and loops over every Q tile. So
// each output row is written by exactly one block, nothing is reduced across
// blocks, and dq is deterministic. Inputs and outputs are addressed by
// strides ([B, L, N, D] with D contiguous), so the attention module's
// projections need no transposes.
//
// What bounds it on the H100: per head, the dq kernel runs three L x L x d
// products (S, dP, dq) and the dk/dv kernel four (S, dP, dv, dk), against
// O(L d) bytes: every main-path shape is compute-bound, and what keeps a
// kernel off the tensor cores' rate is everything around the products. The
// bf16 body (bwd_body, one template for both kernels) keeps that off the
// critical path:
// - A block owns BM rows (Q rows for dq, KV rows for dk/dv), 16 a warp, and
//   streams the other side in tiles of BN rows. With X1, X2 its own rows of
//   (Q, dO) or (K, V) and Y1, Y2 a streamed tile of (K, V) or (Q, dO), a warp
//   computes S = X1 Y1^T and dP = X2 Y2^T as mma.sync C fragments in
//   registers (for dk/dv the transposed tiles S^T = K Q^T and dP^T = V dO^T),
//   then p = exp2(s scale log2e - lse log2e) and ds = p (dP - delta) scale on
//   those fragments. lse and delta belong to the rows of S: for dq the warp's
//   own Q rows, held in registers; for dk/dv the columns, the tile's Q rows,
//   staged in shared memory beside the tile. P and ds go from the C layout
//   to the A layout in registers (two neighbouring 16x8 C tiles are one 16x16
//   A tile) as bf16 and feed dq += ds Y1 (= K), or dv += P Y2 (= dO) and
//   dk += ds Y1 (= Q), with Y read as B through ldmatrix.trans. The
//   accumulators stay in registers until the final store: nothing but the
//   operand tiles (and, with DS > 1, the partial products below) touches
//   shared memory.
// - Ragged edges: rows past Lq / Lk are zero-filled by cp.async, and on a
//   ragged tile p and ds are set to 0 explicitly for every row past its
//   extent and every column past the other's (a zero-filled Q row has s = 0
//   and, in dk/dv, a staged lse of 0, which would give p = 1). No row past
//   the end is written.
// - The streamed tiles (and for dk/dv their lse and delta, 4-byte copies:
//   rows are N apart in [B, Lq, N]) arrive through a ring of STAGES
//   shared-memory stages filled by cp.async: tile j + STAGES - 1 is in flight
//   while tile j computes, and one block barrier per tile both publishes a
//   stage and frees the previous one.
// - Products: ldmatrix + mma.sync m16n8k16 (bf16 in, fp32 accumulate) from
//   mma_common.cuh, rows padded by 16 bytes so every ldmatrix is free of bank
//   conflicts. The block's own rows' A fragments stay in registers where a
//   warp's slice of d is at most 80 wide; wider, they are re-read from shared
//   memory per tile. d = 40 runs padded to 48 (three k-steps of 16): columns
//   40-47 of every shared row are zeroed once per block, so they add nothing,
//   and output columns 40-47 are dropped.
// - d = 160 (dk/dv) and 512 (both): the accumulators of one warp's 16 rows
//   (d fp32 a row for dq, 2 d for dk and dv; at d = 512 256 and 512
//   registers a thread) do not fit, so DS warps split d. Each owns DW = d /
//   DS columns of the accumulators and computes partial S and dP over those
//   columns of d; the DS partials go through shared memory behind a named
//   barrier per row group, and every owner sums all DS of them in the order
//   0..DS-1, so all hold the same S and dP bit for bit and run the same p
//   and ds.
// Tiles per (head dim, kernel) in BwdTile below, each the fastest of five
// candidates timed on the H100 by perf/torch_bwd_tiles.py; __launch_bounds__
// holds the registers to MIN_BLOCKS resident blocks an SM, and `-Xptxas -v`
// reports the spills. mma.sync rather than wgmma, as in the forward: P and ds
// stay in registers in a documented fragment layout; it does not reach
// wgmma's rate.
//
// fp32 inputs (the parity dtype, not the training one) keep the scalar body
// (flash_bwd_{dq,dkv}_kernel_fp32): tiles staged in shared memory, FMA, exact
// to ~1e-6, no tensor cores (no TF32).

#include <cmath>

#include "flash_common.cuh"
#include "mma_common.cuh"

namespace {

constexpr float kLog2e = 1.4426950408889634f;

// Strides (elements), in order: q, k, v, dO, dq, dk, dv, each (b, l, n).
struct Strides {
  int64_t v[21];
};

// ---------------------------------------------------------------- bf16 ----

// bf16 tiles per (head dim, kernel: false = dq, true = dk/dv): BM rows a
// block owns (16 a warp per row group), BN rows a streamed tile, DS warps
// splitting d, STAGES ring stages, and the resident blocks an SM the
// registers are held to.
template <int D, bool kDkv>
struct BwdTile;
template <>
struct BwdTile<40, false> {
  static constexpr int BM = 64, BN = 64, DS = 1, STAGES = 2, MIN_BLOCKS = 3;
};
template <>
struct BwdTile<64, false> {
  static constexpr int BM = 64, BN = 64, DS = 1, STAGES = 2, MIN_BLOCKS = 3;
};
template <>
struct BwdTile<80, false> {
  static constexpr int BM = 64, BN = 32, DS = 1, STAGES = 2, MIN_BLOCKS = 3;
};
template <>
struct BwdTile<160, false> {
  static constexpr int BM = 64, BN = 32, DS = 1, STAGES = 3, MIN_BLOCKS = 2;
};
template <>
struct BwdTile<512, false> {
  static constexpr int BM = 64, BN = 16, DS = 2, STAGES = 2, MIN_BLOCKS = 1;
};
template <>
struct BwdTile<40, true> {
  static constexpr int BM = 64, BN = 32, DS = 1, STAGES = 2, MIN_BLOCKS = 3;
};
template <>
struct BwdTile<64, true> {
  static constexpr int BM = 64, BN = 64, DS = 1, STAGES = 2, MIN_BLOCKS = 2;
};
template <>
struct BwdTile<80, true> {
  static constexpr int BM = 64, BN = 32, DS = 1, STAGES = 3, MIN_BLOCKS = 2;
};
template <>
struct BwdTile<160, true> {
  static constexpr int BM = 64, BN = 32, DS = 2, STAGES = 2, MIN_BLOCKS = 1;
};
template <>
struct BwdTile<512, true> {
  static constexpr int BM = 32, BN = 16, DS = 4, STAGES = 3, MIN_BLOCKS = 1;
};

// Shared memory: the block's X1 and X2 rows, then each stage's Y1 and Y2
// rows, all DP = D rounded up to 16 columns wide with a 16-byte row pad
// (LDT); for dk/dv each stage's lse and delta (BN fp32 each); with DS > 1 the
// partial S and dP of every warp, [2][DS][BM][LDX] fp32 (LDX = BN + 8 keeps
// the float2 accesses free of bank conflicts).
template <int D, bool kDkv>
struct BwdSmem {
  using C = BwdTile<D, kDkv>;
  static constexpr int RG = C::BM / 16;
  static constexpr int THREADS = 32 * RG * C::DS;
  static constexpr int DP = align_up(D, 16);
  static constexpr int LDT = DP + 8;
  static constexpr int LDX = C::BN + 8;
  static constexpr int rows = 2 * C::BM + C::STAGES * 2 * C::BN;
  static constexpr int stat_off = rows * LDT * 2;
  static constexpr int part_off = stat_off + (kDkv ? C::STAGES * 2 * C::BN * 4 : 0);
  static constexpr int bytes = part_off + (C::DS > 1 ? 2 * C::DS * C::BM * LDX * 4 : 0);
};

template <int D, bool kDkv>
__device__ __forceinline__ void bwd_body(const bf16* __restrict__ q, const bf16* __restrict__ k,
                                         const bf16* __restrict__ v, const bf16* __restrict__ dout,
                                         const float* __restrict__ lse, const float* __restrict__ dd,
                                         bf16* __restrict__ out0, bf16* __restrict__ out1, int N, int Lq,
                                         int Lk, float scale, const Strides& st) {
  using C = BwdTile<D, kDkv>;
  using L = BwdSmem<D, kDkv>;
  constexpr int BM = C::BM, BN = C::BN, DS = C::DS, STAGES = C::STAGES, THREADS = L::THREADS, RG = L::RG;
  constexpr int LDT = L::LDT, LDX = L::LDX;
  constexpr int DW = L::DP / DS;  // columns of d one warp covers
  constexpr int KSTEPS = DW / 16, SN = BN / 8, ON = DW / 8;
  constexpr bool kXRegs = DW <= 80;  // the own rows' A fragments in registers; else re-read per tile
  constexpr int NACC = kDkv ? 2 : 1;  // dq; or dk, dv
  // operands: q 0, k 1, v 2, dO 3, dq 4, dk 5, dv 6
  constexpr int iX1 = kDkv ? 1 : 0, iX2 = kDkv ? 2 : 3, iY1 = kDkv ? 0 : 1, iY2 = kDkv ? 3 : 2;
  static_assert(BM % 16 == 0 && BN % 16 == 0 && DW % 16 == 0 && STAGES >= 2, "tiles are whole mma tiles");
  static_assert(L::DP == D || L::DP == D + 8, "the padding is one 16-byte column chunk");
  static_assert(L::bytes <= 227 * 1024, "tiles do not fit shared memory");
  static_assert(C::MIN_BLOCKS * (L::bytes + 1024) <= 228 * 1024, "MIN_BLOCKS blocks do not fit an SM");
  static_assert(2 * BN <= THREADS, "one thread per staged lse / delta value");

  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sX = reinterpret_cast<bf16*>(smem);  // X1 rows 0..BM-1, X2 rows BM..2BM-1
  bf16* sY = sX + 2 * BM * LDT;             // stage s: Y1 at sY + 2 s BN LDT, Y2 BN LDT after it
  float* sStat = reinterpret_cast<float*>(smem + L::stat_off);  // stage s: lse at 2 s BN, delta BN after
  float* sPart = reinterpret_cast<float*>(smem + L::part_off);  // [S, dP][part][row][LDX]

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int rg = warp % RG, part = warp / RG;
  const int wrow = 16 * rg, dcol = DW * part;
  // ldmatrix row addresses: A and transposed B rows lane % 16 at column
  // 8 (lane / 16); B rows lane % 8 + 8 (lane / 16) at 8 ((lane / 8) % 2)
  const int a_row = lane % 16, a_col = 8 * (lane / 16);
  const int b_row = lane % 8 + 8 * (lane / 16), b_col = 8 * ((lane / 8) % 2);

  const int b = blockIdx.y / N, n = blockIdx.y % N;
  const int m0 = blockIdx.x * BM;
  const int LM = kDkv ? Lk : Lq, LN = kDkv ? Lq : Lk;  // extents of the own rows and of the streamed side
  const int n_tiles = (LN + BN - 1) / BN;
  const bf16* ops[4] = {q, k, v, dout};
  auto row_ptr = [&](int i, int row) {  // operand i at (b, row, n)
    return ops[i] + b * st.v[3 * i] + n * st.v[3 * i + 2] + row * st.v[3 * i + 1];
  };

  if constexpr (L::DP > D) {  // columns D..DP-1 of every row; cp.async never writes them
    for (int r = threadIdx.x; r < L::rows; r += THREADS)
      *reinterpret_cast<uint4*>(sX + r * LDT + D) = make_uint4(0, 0, 0, 0);
  }

  const int m_valid = min(BM, LM - m0);
  load_rows_async<D, LDT, THREADS, BM>(sX, row_ptr(iX1, m0), st.v[3 * iX1 + 1], m_valid);
  load_rows_async<D, LDT, THREADS, BM>(sX + BM * LDT, row_ptr(iX2, m0), st.v[3 * iX2 + 1], m_valid);
  cp_async_commit();

  auto load_stage = [&](int tile) {
    const int s = tile % STAGES, n0 = tile * BN, valid = min(BN, LN - n0);
    bf16* dst = sY + s * 2 * BN * LDT;
    load_rows_async<D, LDT, THREADS, BN>(dst, row_ptr(iY1, n0), st.v[3 * iY1 + 1], valid);
    load_rows_async<D, LDT, THREADS, BN>(dst + BN * LDT, row_ptr(iY2, n0), st.v[3 * iY2 + 1], valid);
    if constexpr (kDkv) {  // the tile's Q rows' lse and delta ([B, Lq, N]: rows N apart)
      const int64_t row0 = (static_cast<int64_t>(b) * Lq + n0) * N + n;
      const int i = threadIdx.x, r = i % BN;
      if (i < 2 * BN) {
        const bool ok = r < valid;
        cp_async4(sStat + s * 2 * BN + i, (i < BN ? lse : dd) + row0 + (ok ? static_cast<int64_t>(r) * N : 0), ok);
      }
    }
  };
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_tiles) load_stage(s);
    cp_async_commit();  // one group per stage, empty past the last tile
  }

  // dq: the warp's rows' lse (in base-2 units) and delta, rows g and g + 8
  float row_lse[2] = {0.f, 0.f}, row_dd[2] = {0.f, 0.f};
  if constexpr (!kDkv) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = m0 + wrow + g + 8 * r;
      if (row < Lq) {
        const int64_t idx = (static_cast<int64_t>(b) * Lq + row) * N + n;
        row_lse[r] = lse[idx] * kLog2e;
        row_dd[r] = dd[idx];
      }
    }
  }

  uint32_t xf[2][kXRegs ? KSTEPS : 1][4];
  if constexpr (kXRegs) {
    cp_async_wait<STAGES - 1>();  // the X group
    __syncthreads();
#pragma unroll
    for (int x = 0; x < 2; ++x)
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk)
        ldmatrix_x4(xf[x][kk], sX + (x * BM + wrow + a_row) * LDT + dcol + 16 * kk + a_col);
  }

  float acc[NACC][ON][4];
#pragma unroll
  for (int a = 0; a < NACC; ++a)
#pragma unroll
    for (int jn = 0; jn < ON; ++jn)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[a][jn][e] = 0.f;

  const float sl2 = scale * kLog2e;
#pragma unroll 1
  for (int j = 0; j < n_tiles; ++j) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // tile j is in; every warp is done with tile j - 1's stage and partials
    if (j + STAGES - 1 < n_tiles) load_stage(j + STAGES - 1);
    cp_async_commit();
    const int stage = j % STAGES;
    const bf16* y1 = sY + stage * 2 * BN * LDT;
    const bf16* y2 = y1 + BN * LDT;

    // S = X1 Y1^T and dP = X2 Y2^T over this warp's columns of d (unscaled, fp32)
    float s[SN][4], dp[SN][4];
#pragma unroll
    for (int jn = 0; jn < SN; ++jn)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[jn][e] = dp[jn][e] = 0.f;
    auto products = [&](const uint32_t(&a1)[4], const uint32_t(&a2)[4], int kk) {
#pragma unroll
      for (int jj = 0; jj < SN / 2; ++jj) {
        uint32_t b1[4], b2[4];
        ldmatrix_x4(b1, y1 + (16 * jj + b_row) * LDT + dcol + 16 * kk + b_col);
        ldmatrix_x4(b2, y2 + (16 * jj + b_row) * LDT + dcol + 16 * kk + b_col);
        mma_bf16(s[2 * jj], a1, b1[0], b1[1]);
        mma_bf16(s[2 * jj + 1], a1, b1[2], b1[3]);
        mma_bf16(dp[2 * jj], a2, b2[0], b2[1]);
        mma_bf16(dp[2 * jj + 1], a2, b2[2], b2[3]);
      }
    };
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
      if constexpr (kXRegs) {
        products(xf[0][kk], xf[1][kk], kk);
      } else {
        uint32_t a1[4], a2[4];
        ldmatrix_x4(a1, sX + (wrow + a_row) * LDT + dcol + 16 * kk + a_col);
        ldmatrix_x4(a2, sX + (BM + wrow + a_row) * LDT + dcol + 16 * kk + a_col);
        products(a1, a2, kk);
      }
    }

    if constexpr (DS > 1) {  // every owner of these rows sums the DS partials in one order
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        float* mine = sPart + ((x * DS + part) * BM + wrow) * LDX;
        const float(&src)[SN][4] = x == 0 ? s : dp;
#pragma unroll
        for (int jn = 0; jn < SN; ++jn) {
          *reinterpret_cast<float2*>(mine + g * LDX + 8 * jn + 2 * t) = make_float2(src[jn][0], src[jn][1]);
          *reinterpret_cast<float2*>(mine + (g + 8) * LDX + 8 * jn + 2 * t) = make_float2(src[jn][2], src[jn][3]);
        }
      }
      named_barrier(1 + rg, 32 * DS);
#pragma unroll
      for (int jn = 0; jn < SN; ++jn)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int off = (wrow + g + 8 * h) * LDX + 8 * jn + 2 * t;
          float2 ts = make_float2(0.f, 0.f), tp = make_float2(0.f, 0.f);
#pragma unroll
          for (int p = 0; p < DS; ++p) {
            const float2 xs = *reinterpret_cast<const float2*>(sPart + p * BM * LDX + off);
            const float2 xp = *reinterpret_cast<const float2*>(sPart + (DS + p) * BM * LDX + off);
            ts.x += xs.x;
            ts.y += xs.y;
            tp.x += xp.x;
            tp.y += xp.y;
          }
          s[jn][2 * h] = ts.x;
          s[jn][2 * h + 1] = ts.y;
          dp[jn][2 * h] = tp.x;
          dp[jn][2 * h + 1] = tp.y;
        }
    }

    // p (into s) and ds (into dp), 0 past the extents on a ragged tile
    const int n0 = j * BN;
    const bool ragged = m0 + BM > LM || n0 + BN > LN;
    const float* tile_stat = sStat + stage * 2 * BN;
#pragma unroll
    for (int jn = 0; jn < SN; ++jn) {
      float2 c_lse = make_float2(0.f, 0.f), c_dd = make_float2(0.f, 0.f);
      if constexpr (kDkv) {  // per column: the tile's Q rows
        c_lse = *reinterpret_cast<const float2*>(tile_stat + 8 * jn + 2 * t);
        c_dd = *reinterpret_cast<const float2*>(tile_stat + BN + 8 * jn + 2 * t);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float l2 = kDkv ? ((e & 1) ? c_lse.y : c_lse.x) * kLog2e : row_lse[e / 2];
        const float del = kDkv ? ((e & 1) ? c_dd.y : c_dd.x) : row_dd[e / 2];
        float p = exp2_approx(fmaf(s[jn][e], sl2, -l2));
        float ds = p * (dp[jn][e] - del) * scale;
        if (ragged && (m0 + wrow + g + 8 * (e / 2) >= LM || n0 + 8 * jn + 2 * t + (e & 1) >= LN)) p = ds = 0.f;
        s[jn][e] = p;
        dp[jn][e] = ds;
      }
    }

    // dq += ds Y1; or dk += ds Y1 and dv += P Y2: P and ds as bf16 A fragments from the C registers
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      const uint32_t a_ds[4] = {pack_bf16x2(dp[2 * kk][0], dp[2 * kk][1]), pack_bf16x2(dp[2 * kk][2], dp[2 * kk][3]),
                                pack_bf16x2(dp[2 * kk + 1][0], dp[2 * kk + 1][1]),
                                pack_bf16x2(dp[2 * kk + 1][2], dp[2 * kk + 1][3])};
      const uint32_t a_p[4] = {pack_bf16x2(s[2 * kk][0], s[2 * kk][1]), pack_bf16x2(s[2 * kk][2], s[2 * kk][3]),
                               pack_bf16x2(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                               pack_bf16x2(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int jj = 0; jj < ON / 2; ++jj) {
        uint32_t b1[4];
        ldmatrix_x4_trans(b1, y1 + (16 * kk + a_row) * LDT + dcol + 16 * jj + a_col);
        mma_bf16(acc[0][2 * jj], a_ds, b1[0], b1[1]);
        mma_bf16(acc[0][2 * jj + 1], a_ds, b1[2], b1[3]);
        if constexpr (kDkv) {
          uint32_t b2[4];
          ldmatrix_x4_trans(b2, y2 + (16 * kk + a_row) * LDT + dcol + 16 * jj + a_col);
          mma_bf16(acc[1][2 * jj], a_p, b2[0], b2[1]);
          mma_bf16(acc[1][2 * jj + 1], a_p, b2[2], b2[3]);
        }
      }
    }
  }

  // the own rows' gradients: dq, or dk and dv
  bf16* outs[2] = {out0, out1};
#pragma unroll
  for (int a = 0; a < NACC; ++a) {
    const int io = kDkv ? 5 + a : 4;
    bf16* ob = outs[a] + b * st.v[3 * io] + n * st.v[3 * io + 2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = m0 + wrow + g + 8 * r;
      if (row >= LM) continue;
      bf16* orow = ob + row * st.v[3 * io + 1];
#pragma unroll
      for (int jn = 0; jn < ON; ++jn) {
        const int col = dcol + 8 * jn + 2 * t;
        if (col < D)
          *reinterpret_cast<__nv_bfloat162*>(orow + col) =
              __floats2bfloat162_rn(acc[a][jn][2 * r], acc[a][jn][2 * r + 1]);
      }
    }
  }
}

// dq for one Q tile of one (b, n): loops over every KV tile.
template <int D>
__global__ void __launch_bounds__(BwdSmem<D, false>::THREADS, BwdTile<D, false>::MIN_BLOCKS)
flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
                    const bf16* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ dd,
                    bf16* __restrict__ dq, int N, int Lq, int Lk, float scale, Strides st) {
  bwd_body<D, false>(q, k, v, dout, lse, dd, dq, nullptr, N, Lq, Lk, scale, st);
}

// dk and dv for one KV tile of one (b, n): loops over every Q tile.
template <int D>
__global__ void __launch_bounds__(BwdSmem<D, true>::THREADS, BwdTile<D, true>::MIN_BLOCKS)
flash_bwd_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
                     const bf16* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ dd,
                     bf16* __restrict__ dk, bf16* __restrict__ dv, int N, int Lq, int Lk, float scale,
                     Strides st) {
  bwd_body<D, true>(q, k, v, dout, lse, dd, dk, dv, N, Lq, Lk, scale, st);
}

// ---------------------------------------------------------------- fp32 ----

// fp32 tiles per (head dim, kernel): BQ rows of Q / dO, BK rows of K / V. The
// dq kernel's block owns BQ rows, the dk/dv kernel's BK.
template <int D>
struct Fp32Cfg;
template <>
struct Fp32Cfg<40> {
  static constexpr int BQ = 64, BK = 64, THREADS = 128;
};
template <>
struct Fp32Cfg<64> {
  static constexpr int BQ = 64, BK = 64, THREADS = 128;
};
template <>
struct Fp32Cfg<80> {
  static constexpr int BQ = 64, BK = 64, THREADS = 128;
};
template <>
struct Fp32Cfg<160> {
  static constexpr int BQ = 32, BK = 32, THREADS = 128;
};
template <>
struct Fp32Cfg<512> {
  static constexpr int BQ = 16, BK = 16, THREADS = 256;
};

// Shared memory, rows padded by one element (conflict-free column walks): the
// Q, dO, K and V tiles, the S and dP tiles (overwritten with p and ds), one
// [BQ, D] accumulator (dq) or two [BK, D] (dk, dv), and the Q rows' lse and
// delta.
template <int D, bool kDkv>
struct Fp32Smem {
  using C = Fp32Cfg<D>;
  static constexpr int LDT = D + 1;
  static constexpr int LDS = C::BK + 1;
  static constexpr int ACC_ROWS = kDkv ? C::BK : C::BQ;
  static constexpr int NACC = kDkv ? 2 : 1;
  static constexpr int do_off = align_up(C::BQ * LDT * 4, kAlign);
  static constexpr int k_off = align_up(do_off + C::BQ * LDT * 4, kAlign);
  static constexpr int v_off = align_up(k_off + C::BK * LDT * 4, kAlign);
  static constexpr int s_off = align_up(v_off + C::BK * LDT * 4, kAlign);
  static constexpr int dp_off = align_up(s_off + C::BQ * LDS * 4, kAlign);
  static constexpr int acc_off = align_up(dp_off + C::BQ * LDS * 4, kAlign);
  static constexpr int lse_off = align_up(acc_off + NACC * ACC_ROWS * LDT * 4, kAlign);
  static constexpr int dd_off = lse_off + C::BQ * 4;
  static constexpr int bytes = dd_off + C::BQ * 4;
  static_assert(bytes <= 227 * 1024, "tile does not fit shared memory");
};

// C[M, N] = A[M, K] B[N, K]^T, all row-major in shared memory.
template <int M, int N, int K, int THREADS>
__device__ void mm_abt(float* c, int ldc, const float* a, int lda, const float* b, int ldb) {
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

// C[M, N] += A[M, K] B[K, N] (kTransA = false) or A[K, M]^T B[K, N]
// (kTransA = true), all row-major in shared memory.
template <bool kTransA, int M, int N, int K, int THREADS>
__device__ void mm_acc(float* c, int ldc, const float* a, int lda, const float* b, int ldb) {
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

// p and ds for one [BQ, BK] tile, in place of S and dP: p = exp(s * scale -
// lse) (0 for rows at or past q_valid and columns at or past kv_valid),
// ds = p (dP - delta) scale.
template <int D, bool kDkv>
__device__ void probs_and_ds(unsigned char* smem, int q_valid, int kv_valid, float scale) {
  using L = Fp32Smem<D, kDkv>;
  using C = Fp32Cfg<D>;
  float* sS = reinterpret_cast<float*>(smem + L::s_off);
  float* sDP = reinterpret_cast<float*>(smem + L::dp_off);
  const float* sLse = reinterpret_cast<const float*>(smem + L::lse_off);
  const float* sDd = reinterpret_cast<const float*>(smem + L::dd_off);
  for (int i = threadIdx.x; i < C::BQ * C::BK; i += C::THREADS) {
    const int r = i / C::BK, c = i % C::BK;
    float p = 0.f, ds = 0.f;
    if (r < q_valid && c < kv_valid) {
      p = expf(sS[r * L::LDS + c] * scale - sLse[r]);
      ds = p * (sDP[r * L::LDS + c] - sDd[r]) * scale;
    }
    sS[r * L::LDS + c] = p;
    sDP[r * L::LDS + c] = ds;
  }
}

// lse and delta of BQ Q rows from q0 ([B, Lq, N]: consecutive rows N apart), 0 past q_valid.
template <int D, bool kDkv>
__device__ void load_stats(unsigned char* smem, const float* lse, const float* dd, int b, int n, int N, int Lq,
                           int q0, int q_valid) {
  using L = Fp32Smem<D, kDkv>;
  float* sLse = reinterpret_cast<float*>(smem + L::lse_off);
  float* sDd = reinterpret_cast<float*>(smem + L::dd_off);
  const int64_t row0 = (static_cast<int64_t>(b) * Lq + q0) * N + n;
  for (int r = threadIdx.x; r < Fp32Cfg<D>::BQ; r += Fp32Cfg<D>::THREADS) {
    sLse[r] = r < q_valid ? lse[row0 + static_cast<int64_t>(r) * N] : 0.f;
    sDd[r] = r < q_valid ? dd[row0 + static_cast<int64_t>(r) * N] : 0.f;
  }
}

template <int D>
__global__ void __launch_bounds__(Fp32Cfg<D>::THREADS)
flash_bwd_dq_kernel_fp32(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                         const float* __restrict__ dout, const float* __restrict__ lse,
                         const float* __restrict__ dd, float* __restrict__ dq, int N, int Lq, int Lk,
                         float scale, Strides st) {
  using C = Fp32Cfg<D>;
  using L = Fp32Smem<D, false>;
  constexpr int BQ = C::BQ, BK = C::BK, THREADS = C::THREADS;
  extern __shared__ __align__(kAlign) unsigned char smem[];
  float* sQ = reinterpret_cast<float*>(smem);
  float* sDO = reinterpret_cast<float*>(smem + L::do_off);
  float* sK = reinterpret_cast<float*>(smem + L::k_off);
  float* sV = reinterpret_cast<float*>(smem + L::v_off);
  float* sS = reinterpret_cast<float*>(smem + L::s_off);
  float* sDP = reinterpret_cast<float*>(smem + L::dp_off);
  float* sAcc = reinterpret_cast<float*>(smem + L::acc_off);

  const int q0 = blockIdx.x * BQ;
  const int b = blockIdx.y / N, n = blockIdx.y % N;
  const int q_valid = min(BQ, Lq - q0);
  load_tile<D, L::LDT, THREADS>(sQ, q + b * st.v[0] + n * st.v[2] + q0 * st.v[1], st.v[1], BQ, q_valid);
  load_tile<D, L::LDT, THREADS>(sDO, dout + b * st.v[9] + n * st.v[11] + q0 * st.v[10], st.v[10], BQ, q_valid);
  load_stats<D, false>(smem, lse, dd, b, n, N, Lq, q0, q_valid);
  for (int i = threadIdx.x; i < BQ * L::LDT; i += THREADS) sAcc[i] = 0.f;

  const float* kb = k + b * st.v[3] + n * st.v[5];
  const float* vb = v + b * st.v[6] + n * st.v[8];
  for (int kv0 = 0; kv0 < Lk; kv0 += BK) {
    const int kv_valid = min(BK, Lk - kv0);
    __syncthreads();  // the previous tile's K and ds are consumed
    load_tile<D, L::LDT, THREADS>(sK, kb + kv0 * st.v[4], st.v[4], BK, kv_valid);
    load_tile<D, L::LDT, THREADS>(sV, vb + kv0 * st.v[7], st.v[7], BK, kv_valid);
    __syncthreads();
    mm_abt<BQ, BK, D, THREADS>(sS, L::LDS, sQ, L::LDT, sK, L::LDT);    // S = Q K^T
    mm_abt<BQ, BK, D, THREADS>(sDP, L::LDS, sDO, L::LDT, sV, L::LDT);  // dP = dO V^T
    __syncthreads();
    probs_and_ds<D, false>(smem, q_valid, kv_valid, scale);
    __syncthreads();
    mm_acc<false, BQ, D, BK, THREADS>(sAcc, L::LDT, sDP, L::LDS, sK, L::LDT);  // dq += ds K
  }
  __syncthreads();

  float* dqb = dq + b * st.v[12] + n * st.v[14] + q0 * st.v[13];
  for (int i = threadIdx.x; i < q_valid * D; i += THREADS) {
    const int r = i / D, c = i % D;
    dqb[r * st.v[13] + c] = sAcc[r * L::LDT + c];
  }
}

template <int D>
__global__ void __launch_bounds__(Fp32Cfg<D>::THREADS)
flash_bwd_dkv_kernel_fp32(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                          const float* __restrict__ dout, const float* __restrict__ lse,
                          const float* __restrict__ dd, float* __restrict__ dk, float* __restrict__ dv, int N,
                          int Lq, int Lk, float scale, Strides st) {
  using C = Fp32Cfg<D>;
  using L = Fp32Smem<D, true>;
  constexpr int BQ = C::BQ, BK = C::BK, THREADS = C::THREADS;
  extern __shared__ __align__(kAlign) unsigned char smem[];
  float* sQ = reinterpret_cast<float*>(smem);
  float* sDO = reinterpret_cast<float*>(smem + L::do_off);
  float* sK = reinterpret_cast<float*>(smem + L::k_off);
  float* sV = reinterpret_cast<float*>(smem + L::v_off);
  float* sS = reinterpret_cast<float*>(smem + L::s_off);
  float* sDP = reinterpret_cast<float*>(smem + L::dp_off);
  float* sDK = reinterpret_cast<float*>(smem + L::acc_off);
  float* sDV = sDK + BK * L::LDT;

  const int k0 = blockIdx.x * BK;
  const int b = blockIdx.y / N, n = blockIdx.y % N;
  const int kv_valid = min(BK, Lk - k0);
  load_tile<D, L::LDT, THREADS>(sK, k + b * st.v[3] + n * st.v[5] + k0 * st.v[4], st.v[4], BK, kv_valid);
  load_tile<D, L::LDT, THREADS>(sV, v + b * st.v[6] + n * st.v[8] + k0 * st.v[7], st.v[7], BK, kv_valid);
  for (int i = threadIdx.x; i < 2 * BK * L::LDT; i += THREADS) sDK[i] = 0.f;

  const float* qb = q + b * st.v[0] + n * st.v[2];
  const float* dob = dout + b * st.v[9] + n * st.v[11];
  for (int q0 = 0; q0 < Lq; q0 += BQ) {
    const int q_valid = min(BQ, Lq - q0);
    __syncthreads();  // the previous tile's Q, dO, p and ds are consumed
    load_tile<D, L::LDT, THREADS>(sQ, qb + q0 * st.v[1], st.v[1], BQ, q_valid);
    load_tile<D, L::LDT, THREADS>(sDO, dob + q0 * st.v[10], st.v[10], BQ, q_valid);
    load_stats<D, true>(smem, lse, dd, b, n, N, Lq, q0, q_valid);
    __syncthreads();
    mm_abt<BQ, BK, D, THREADS>(sS, L::LDS, sQ, L::LDT, sK, L::LDT);    // S = Q K^T
    mm_abt<BQ, BK, D, THREADS>(sDP, L::LDS, sDO, L::LDT, sV, L::LDT);  // dP = dO V^T
    __syncthreads();
    probs_and_ds<D, true>(smem, q_valid, kv_valid, scale);
    __syncthreads();
    mm_acc<true, BK, D, BQ, THREADS>(sDV, L::LDT, sS, L::LDS, sDO, L::LDT);  // dv += P^T dO
    mm_acc<true, BK, D, BQ, THREADS>(sDK, L::LDT, sDP, L::LDS, sQ, L::LDT);  // dk += ds^T Q
  }
  __syncthreads();

  float* dkb = dk + b * st.v[15] + n * st.v[17] + k0 * st.v[16];
  float* dvb = dv + b * st.v[18] + n * st.v[20] + k0 * st.v[19];
  for (int i = threadIdx.x; i < kv_valid * D; i += THREADS) {
    const int r = i / D, c = i % D;
    dkb[r * st.v[16] + c] = sDK[r * L::LDT + c];
    dvb[r * st.v[19] + c] = sDV[r * L::LDT + c];
  }
}

// ------------------------------------------------------------- launch ----

template <typename KernelFn, typename... Args>
int launch(KernelFn kernel, int bytes, dim3 grid, int threads, cudaStream_t stream, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, threads, bytes, stream>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

// dtype 1: the bf16 kernels; 0: the fp32 ones. out1 is dv (dk/dv) or unused (dq).
template <int D, bool kDkv>
int launch_bwd(int dtype, const void* q, const void* k, const void* v, const void* dout, const float* lse,
               const float* dd, void* out0, void* out1, int B, int N, int Lq, int Lk, float scale, const Strides& st,
               cudaStream_t stream) {
  const int rows = kDkv ? Lk : Lq;
  if (dtype == 1) {
    using T = bf16;
    using L = BwdSmem<D, kDkv>;
    const dim3 grid((rows + BwdTile<D, kDkv>::BM - 1) / BwdTile<D, kDkv>::BM, B * N);
    const T *tq = static_cast<const T*>(q), *tk = static_cast<const T*>(k), *tv = static_cast<const T*>(v),
            *tdo = static_cast<const T*>(dout);
    if constexpr (kDkv)
      return launch(flash_bwd_dkv_kernel<D>, L::bytes, grid, L::THREADS, stream, tq, tk, tv, tdo, lse, dd,
                    static_cast<T*>(out0), static_cast<T*>(out1), N, Lq, Lk, scale, st);
    else
      return launch(flash_bwd_dq_kernel<D>, L::bytes, grid, L::THREADS, stream, tq, tk, tv, tdo, lse, dd,
                    static_cast<T*>(out0), N, Lq, Lk, scale, st);
  }
  if (dtype == 0) {
    using T = float;
    using C = Fp32Cfg<D>;
    const dim3 grid((rows + (kDkv ? C::BK : C::BQ) - 1) / (kDkv ? C::BK : C::BQ), B * N);
    const T *tq = static_cast<const T*>(q), *tk = static_cast<const T*>(k), *tv = static_cast<const T*>(v),
            *tdo = static_cast<const T*>(dout);
    if constexpr (kDkv)
      return launch(flash_bwd_dkv_kernel_fp32<D>, Fp32Smem<D, true>::bytes, grid, C::THREADS, stream, tq, tk, tv,
                    tdo, lse, dd, static_cast<T*>(out0), static_cast<T*>(out1), N, Lq, Lk, scale, st);
    else
      return launch(flash_bwd_dq_kernel_fp32<D>, Fp32Smem<D, false>::bytes, grid, C::THREADS, stream, tq, tk, tv,
                    tdo, lse, dd, static_cast<T*>(out0), N, Lq, Lk, scale, st);
  }
  return -1;
}

template <bool kDkv>
int dispatch(const void* q, const void* k, const void* v, const void* dout, const float* lse, const float* dd,
             void* out0, void* out1, int dtype, int B, int N, int Lq, int Lk, int D, float scale, const int64_t* s,
             void* stream) {
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  Strides st;
  for (int i = 0; i < 21; ++i) st.v[i] = s[i];
  switch (D) {
    case 40: return launch_bwd<40, kDkv>(dtype, q, k, v, dout, lse, dd, out0, out1, B, N, Lq, Lk, scale, st, cs);
    case 64: return launch_bwd<64, kDkv>(dtype, q, k, v, dout, lse, dd, out0, out1, B, N, Lq, Lk, scale, st, cs);
    case 80: return launch_bwd<80, kDkv>(dtype, q, k, v, dout, lse, dd, out0, out1, B, N, Lq, Lk, scale, st, cs);
    case 160: return launch_bwd<160, kDkv>(dtype, q, k, v, dout, lse, dd, out0, out1, B, N, Lq, Lk, scale, st, cs);
    case 512: return launch_bwd<512, kDkv>(dtype, q, k, v, dout, lse, dd, out0, out1, B, N, Lq, Lk, scale, st, cs);
    default: return -1;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16; D = 40, 64, 80, 160 or 512. lse and
// delta: contiguous fp32 [B, Lq, N]. strides (elements): q, k, v, dO, dq, dk,
// dv, each (b, l, n); 21 in all. Each returns 0, a cudaError_t from the
// launch, or -1 for an unsupported (dtype, head dim) pair. They launch on
// `stream` and do not synchronise.
int e2eft_flash_attention_bwd_dq(const void* q, const void* k, const void* v, const void* dout, const float* lse,
                                 const float* delta, void* dq, int dtype, int B, int N, int Lq, int Lk, int D,
                                 float scale, const int64_t* strides, void* stream) {
  return dispatch<false>(q, k, v, dout, lse, delta, dq, nullptr, dtype, B, N, Lq, Lk, D, scale, strides, stream);
}

int e2eft_flash_attention_bwd_dkv(const void* q, const void* k, const void* v, const void* dout, const float* lse,
                                  const float* delta, void* dk, void* dv, int dtype, int B, int N, int Lq, int Lk,
                                  int D, float scale, const int64_t* strides, void* stream) {
  return dispatch<true>(q, k, v, dout, lse, delta, dk, dv, dtype, B, N, Lq, Lk, D, scale, strides, stream);
}

}  // extern "C"
