// K5: flash attention forward, hand-written for Hopper.
//
// Replaces the reference's `_attn_kernel` (src/repro/kernels/attention.py,
// launched by `_flash_attention`). What it computes is that kernel's
// contract: per KV tile the scores q.k^T.scale in fp32 (the reference
// scales the fp32 query first; this kernel scales each score, by scale x
// log2 e, which differs by rounding), queries right-aligned against the keys
// (q_pos = row + skv - sq), the causal mask k_pos <= q_pos and the window
// mask k_pos > q_pos - window, a running max, denominator and accumulator
// rescaled on every tile, and acc / l at the end -- 0 where l == 0.
//
// Layout. One block per (query tile, leading index): gridDim.x walks the
// flattened leading dims (batch x heads), gridDim.y the query tiles from
// the last, so a whole (B, S, D) stack is one launch -- the counterpart of
// the reference's jax.vmap over one-slice calls. The reference's sequential
// KV grid axis carried (max, denom, acc) in scratch from one grid step to the
// next; blocks on this card run in any order, so the KV loop is inside the
// block and the running state never leaves registers.
//
// The design (what bounds it is the FMA pipeline):
//
//   * Q, K and V stay in their storage layout, rows padded by kPad floats
//     (pitch D + 4, four rows on disjoint banks). The score product reads a
//     query row and a key row four d at a time, one 16-byte `ld.shared`
//     each; P.V reads a probability row four keys at a time and each key's
//     V row across the thread's columns.
//   * K and V tiles come through one `cp.async` ring of STAGES slots, each
//     slot a K or a V tile: the KV step t is two half steps, 2t (S = Q K^T,
//     softmax, P into shared memory) and 2t + 1 (acc += P V), and the copy
//     of half step h + STAGES - 1 is issued when half step h starts, so
//     STAGES - 1 tiles are in flight while one computes; one barrier per
//     half step hands a slot over. Rows past a tile's keys land as zeros
//     (a copy of source size 0). Q arrives in the first commit group.
//   * 256 threads, each owning query rows qi + 16 i (i < BQ / 16) in both
//     products, so the running max, denominator and rescale stay in its
//     registers. The accumulator tile is those rows by value columns
//     4 c + 64 u + e (c < 16, u < D / 64, e < 4): 8 x 8 at (BQ, D) =
//     (128, 128). The score tile is those rows by keys kj + KJ j; where
//     that would leave a thread fewer than 64 scores (8 x 4 at BK = 64),
//     the score product's d is split in two halves across lane pairs
//     (Layout::SPLIT): each lane computes an 8 x 8 tile over its half, and
//     one shuffle a score adds the halves, each lane of the pair keeping
//     half of the keys for the softmax (K slices of two, summed in
//     registers). A row's 16 threads are lanes of one warp, so its max and
//     sum are four shuffles. Eight lanes of one row read eight key rows at
//     one d (disjoint banks) and broadcast one query row.
//   * Scores go to base 2 in one multiply, by scale x log2 e, and the
//     exponents are exp2f; the split workspace keeps the max in base 2.
//   * P rows are padded by kPadP = 16 floats (8 where d is split), so the
//     scalar stores of a warp fill the 32 banks once.
//   * Longest blocks first: blocks start in the order of their linear
//     index, and a causal band grows with the query tile, so the query
//     tiles are walked from the last. In ascending order the longest
//     blocks of the last heads started while the card was draining (a
//     prefill took 23 % longer on the card, PERF.md).
//   * f64 inputs compute in fp32, as the reference does: their tiles are a
//     converting copy (load, convert, store) into the same fp32 slots, made
//     by the threads when the half step is issued instead of by
//     `cp.async`, so for f64 the copy does not overlap the math.
//
// Band skip. The KV loop runs only over the tiles that meet the causal /
// window band of the block's queries (from the first tile holding key
// q_lo - window + 1 to the one holding key q_hi): tiles wholly outside it are
// never loaded -- the skip the reference says its TPU grid could not do
// (attention.py:11-14). Masking inside a visited tile is elementwise.
//
// Masked scores are -inf and the running max starts at -inf. Where a row's
// max is still -inf the exponent is taken against 0 instead, so
// exp(-inf - -inf) never happens: a row that sees no key keeps l == 0 and
// returns 0, as the reference's docstring and its oracle
// (`flash_attention_ref`) say. The reference kernel itself masks with the
// finite -1e30 and returns mean(v) for such rows; this kernel follows the
// oracle.
//
// Tiles. (BQ, BK, D, STAGES) are template parameters: BQ, BK are the tile's
// capacity in queries and keys, D the head width, STAGES the ring's slots.
// A launch may ask for a smaller
// block (bq <= BQ, bk <= BK, any value): the kernel then processes bq
// queries per block and bk keys per step and masks the rest of the tile, so
// any block that divides the sequence and fits an instantiated tile runs.
// The launcher returns -1 for a (D, BQ, BK) it does not instantiate; the
// Python wrapper reads the table and each tile's STAGES from the
// REPRO_ATTN_TILE lines below (kernels/attention.py, ATTN_TILES["fma"],
// ATTN_FMA_STAGES).
//
// Split-KV. When the grid (query tiles x leading index) cannot fill the
// card, gridDim.z splits each block's band of KV tiles into chunks
// (kv_range): each split writes its unnormalised accumulator and its rows'
// running max (in base-2 units: scores x scale x log2 e) and denominator,
// in fp32, to a workspace, and attn_combine_kernel merges the splits. With
// one split the block writes acc / l itself.
//
// What bounds it: at the prefill shapes it runs (S = 4096, D = 128) the
// work is 4 S^2 D flops per head (half of it under the causal band) over
// 4 S D bytes per head: bound by operations. This kernel runs them on the
// CUDA cores with exact fp32 FMAs, for f32 and f64 inputs only (fp32 means
// fp32: no TF32). bf16 / f16 run the tensor-core kernel of
// attention_tc.cuh. An R x C thread tile reads R + C 16-byte words per
// 4 R C FMAs, and a word costs the SM four of the cycles in which it
// issues 16 warp FMAs (the rates PERF.md records for gemm.cuh): 8 x 8 keeps
// the FMA pipe fed, and both products run on 8 x 8 thread tiles at (BQ,
// BK, D) = (128, 64, 128). More keys per step instead would not fit Q and
// a ring of such tiles in a block's shared memory at D = 128; 128 threads
// a block on 8 x 8 tiles without the split, and 512 on 4 x 8 tiles, ran
// slower on the card (PERF.md).

#pragma once

#include <type_traits>

#include "gemm.cuh"  // Num, Pack, load_cvt, store_cvt, cp.async, allow_smem

namespace repro {
namespace attn {

constexpr int kThreads = 256;  // kThreads / 16 rows of 16 threads
constexpr int kPad = 4;        // row padding of Q, K and V (floats)
constexpr int kPadP = 16;      // row padding of P (floats; half with SPLIT)

// Shared-memory layout of one block, all fp32: the query tile Q[BQ][LD],
// the ring of STAGES K or V tiles [BK][LD], and the probabilities
// P[BQ][LDP]. SPLIT is 2 where the score tile gives a thread fewer than
// 64 scores (BQ BK < 64 kThreads): the score product's d is then split in
// two halves across lane pairs, each a thread tile twice as wide, and P
// rows are padded by 8 (else 16) floats so that a warp's stores fill the
// 32 banks once. kernels/attention.py:attn_smem_footprint is the same, and
// a CPU test evaluates BYTES as written here against it.
template <int BQ, int BK, int D, int STAGES>
struct Layout {
  static constexpr int SPLIT = BQ * BK < 64 * kThreads ? 2 : 1;
  static constexpr int LD = D + kPad;
  static constexpr int LDP = BK + kPadP / SPLIT;
  static constexpr int RING_OFF = BQ * LD;
  static constexpr int SLOT = BK * LD;
  static constexpr int P_OFF = RING_OFF + STAGES * SLOT;
  static constexpr int FLOATS = P_OFF + BQ * LDP;
  static constexpr int BYTES = 4 * FLOATS;
};

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

constexpr float kLog2e = 1.4426950408889634f;

// The KV tiles one block visits: `tiles` steps of bk keys from key `begin`.
// The band is every key some query of the block's `rows` queries from q0
// can see (from the first tile holding key q_lo - window + 1 to the one
// holding key q_hi, queries right-aligned against the keys); split `split`
// of `splits` takes the split-th chunk of ceil(band tiles / splits) of them
// (kernels/attention.py:kv_range is the same function).
struct KvRange {
  int begin, tiles;
};

__device__ __forceinline__ KvRange kv_range(int q0, int rows, int sq, int skv,
                                            int bk, int causal,
                                            int use_window, int window,
                                            int split, int splits) {
  const int shift = skv - sq;
  const int q_lo = q0 + shift, q_hi = q0 + rows - 1 + shift;
  const int kv_begin = use_window ? max(0, q_lo - window + 1) : 0;
  const int kv_end = causal ? min(skv, q_hi + 1) : skv;
  if (kv_end <= kv_begin) return {0, 0};  // no key in the band: no tile
  const int first = (kv_begin / bk) * bk;
  const int band = (kv_end - first + bk - 1) / bk;
  const int chunk = (band + splits - 1) / splits;
  const int t0 = min(band, split * chunk);
  return {first + t0 * bk, min(band, t0 + chunk) - t0};
}

// cp.async of 16 bytes that writes zeros instead where `valid` is false
// (source size 0: nothing is read).
__device__ __forceinline__ void cp_async16_zfill(void* dst, const void* src,
                                                 bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

// Rows [0, valid) of a row-major (., D) matrix into dst[r * (D + kPad) + d]
// as fp32; rows [valid, ROWS) are 0. f32: `cp.async` (the caller commits);
// f64: loaded, converted and stored by the threads.
template <typename T, int ROWS, int D>
__device__ __forceinline__ void copy_rows(const T* src, int valid,
                                          float* dst, int tid) {
  constexpr int CPR = D / 4;  // 4-element chunks per row
  constexpr int LD = D + kPad;
  for (int v = tid; v < ROWS * CPR; v += kThreads) {
    const int r = v / CPR, c = v % CPR * 4;
    if constexpr (sizeof(T) == 4) {
      cp_async16_zfill(dst + r * LD + c, src + (r < valid ? r * D + c : 0),
                       r < valid);
    } else {
      typename Num<T>::Acc x[4] = {};
      if (r < valid) load_cvt<T, 4>(src + (long long)r * D + c, x);
      float f[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) f[e] = static_cast<float>(x[e]);
      store_cvt<float, float, 4>(dst + r * LD + c, f);
    }
  }
}

// Max (or sum) of a value over the threads that share a row of the score
// tile: the KJ lanes of one key group (lane bits below KJ) and, where the
// d halves of the score product were split across lane pairs (H == 2),
// both lanes of the pair (lane bit 4).
template <int KJ, int H>
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int o = KJ / 2; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  if constexpr (H == 2) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 16));
  return x;
}

template <int KJ, int H>
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = KJ / 2; o > 0; o >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, o);
  if constexpr (H == 2) x += __shfl_xor_sync(0xffffffffu, x, 16);
  return x;
}

template <typename T, int BQ, int BK, int D, int STAGES>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ Q, const T* __restrict__ K,
                       const T* __restrict__ V, T* __restrict__ O,
                       float* __restrict__ ws_o, float* __restrict__ ws_ml,
                       int sq, int skv, int bq, int bk, int causal,
                       int use_window, int window, float scale) {
  using L = Layout<BQ, BK, D, STAGES>;
  constexpr int H = L::SPLIT;              // d halves of the score product
  constexpr int KJ = 16 / H;               // lanes of a key group
  constexpr int TY = kThreads / 16;        // rows of threads
  constexpr int RQ = BQ / TY, RK = BK / KJ, RD = D / 16;
  constexpr int RKK = RK / H;              // scores a thread keeps
  constexpr int DH = D / H;
  constexpr int LD = L::LD, LDP = L::LDP;
  static_assert(STAGES >= 2 && BQ % TY == 0 && BK % KJ == 0 &&
                    D % 64 == 0 && (H == 1 || RK % 4 == 0),
                "a ring of two slots or more; whole 16-byte chunks");

  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);
  float* ring = Qs + L::RING_OFF;
  float* Ps = Qs + L::P_OFF;

  // Lane = kj + KJ (qb + 2 h): thread (qi, kj, h) of a warp w owns query
  // rows qi + TY i (qi = 2 w + qb), keys kj + KJ j of the score tile over
  // the d half h, and value columns 4 c + 64 u (c = kj + KJ h).
  const int tid = threadIdx.x, lane = tid & 31;
  const int kj = lane % KJ, qb = lane / KJ & 1, h = lane / (2 * KJ);
  const int qi = 2 * (tid >> 5) + qb, c16 = kj + KJ * h;
  // Blocks start in the order of their linear index: the last query tiles,
  // whose causal bands are the longest, go first (gridDim.y walks the query
  // tiles backwards), so no long block starts when the card is draining.
  const long long lead = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * bq;
  const int rows = min(bq, sq - q0);
  const long long row0 = lead * sq + q0;  // first output row of the block
  Q += row0 * D;
  K += lead * skv * (long long)D;
  V += lead * skv * (long long)D;

  const int shift = skv - sq;
  const KvRange kv = kv_range(q0, rows, sq, skv, bk, causal, use_window,
                              window, blockIdx.z, gridDim.z);
  const float scale2 = scale * kLog2e;

  // Half step n: the K (n even) or V (n odd) tile of KV step n / 2 into
  // slot n % STAGES.
  const int halves = 2 * kv.tiles;
  auto issue = [&](int n) {
    const int k0 = kv.begin + (n >> 1) * bk;
    copy_rows<T, BK, D>(((n & 1) ? V : K) + (long long)k0 * D,
                        min(bk, skv - k0), ring + (n % STAGES) * L::SLOT,
                        tid);
  };
  copy_rows<T, BQ, D>(Q, rows, Qs, tid);
#pragma unroll
  for (int n = 0; n < STAGES - 1; ++n) {
    if (n < halves) issue(n);
    cp_async_commit();
  }

  // The keys whose scores the thread keeps: with split d halves, lane h = 0
  // keeps its key groups j < RK / 2 and lane h = 1 the others, in an order
  // that puts the two lanes' probabilities 16 banks apart in P.
  auto kept = [&](int j) {
    if constexpr (H == 1) return j;
    constexpr int HALF = RK / 2, SKEW = HALF % 4 == 0 ? 2 : 0;
    return h ? HALF + (j + SKEW) % HALF : j;
  };

  int q_pos[RQ];
  bool q_ok[RQ];
  float m_run[RQ], l_run[RQ];
  float acc[RQ][RD];
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    q_pos[i] = q0 + qi + TY * i + shift;
    q_ok[i] = qi + TY * i < rows;
    m_run[i] = neg_inf();
    l_run[i] = 0.f;
#pragma unroll
    for (int t = 0; t < RD; ++t) acc[i][t] = 0.f;
  }

  for (int n = 0; n < halves; ++n) {
    // Half step n has landed for this thread; the barrier makes it
    // everyone's (and P written at n - 1), and frees the slot of n - 1.
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    if (n + STAGES - 1 < halves) issue(n + STAGES - 1);
    cp_async_commit();
    const float* slot = ring + (n % STAGES) * L::SLOT;

    if (!(n & 1)) {
      // S = q k^T over the thread's d half for its RQ x RK tile, four d at
      // a time.
      float s[RQ][RK];
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int j = 0; j < RK; ++j) s[i][j] = 0.f;
      const float* qrow = Qs + qi * LD + h * DH;
      const float* krow = slot + kj * LD + h * DH;
#pragma unroll 2
      for (int d = 0; d < DH; d += 4) {
        float qa[RQ][4], kb[RK][4];
#pragma unroll
        for (int i = 0; i < RQ; ++i)
          load_cvt<float, 4>(qrow + TY * i * LD + d, qa[i]);
#pragma unroll
        for (int j = 0; j < RK; ++j)
          load_cvt<float, 4>(krow + KJ * j * LD + d, kb[j]);
#pragma unroll
        for (int e = 0; e < 4; ++e)
#pragma unroll
          for (int i = 0; i < RQ; ++i)
#pragma unroll
            for (int j = 0; j < RK; ++j)
              s[i][j] = fmaf(qa[i][e], kb[j][e], s[i][j]);
      }
      // The two d halves: each lane hands its partner (lane ^ 16) the
      // partial scores of the keys the partner keeps, and adds the
      // partner's to its own.
      float t[RQ][RKK];
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int j = 0; j < RKK; ++j) {
          if constexpr (H == 1) {
            t[i][j] = s[i][j];
          } else {
            constexpr int HALF = RK / 2, SKEW = HALF % 4 == 0 ? 2 : 0;
            const float lo = s[i][j], hi = s[i][HALF + (j + SKEW) % HALF];
            t[i][j] = (h ? hi : lo) +
                      __shfl_xor_sync(0xffffffffu, h ? lo : hi, 16);
          }
        }

      // Mask, online softmax in base 2, rescale; probabilities into P.
      const int k0 = kv.begin + (n >> 1) * bk;
      const int keys = min(bk, skv - k0);
#pragma unroll
      for (int i = 0; i < RQ; ++i) {
        float m_tile = neg_inf();
#pragma unroll
        for (int j = 0; j < RKK; ++j) {
          const int c = kj + KJ * kept(j);
          const int k_pos = k0 + c;
          const bool ok = q_ok[i] && c < keys &&
                          (!causal || k_pos <= q_pos[i]) &&
                          (!use_window || k_pos > q_pos[i] - window);
          t[i][j] = ok ? t[i][j] * scale2 : neg_inf();
          m_tile = fmaxf(m_tile, t[i][j]);
        }
        const float m_new = fmaxf(m_run[i], row_max<KJ, H>(m_tile));
        const float m_use = m_new == neg_inf() ? 0.f : m_new;
        const float corr = exp2f(m_run[i] - m_use);
        float l_tile = 0.f;
#pragma unroll
        for (int j = 0; j < RKK; ++j) {
          t[i][j] = exp2f(t[i][j] - m_use);
          l_tile += t[i][j];
          Ps[(qi + TY * i) * LDP + kj + KJ * kept(j)] = t[i][j];
        }
        l_run[i] = corr * l_run[i] + row_sum<KJ, H>(l_tile);
        m_run[i] = m_new;
#pragma unroll
        for (int t2 = 0; t2 < RD; ++t2) acc[i][t2] *= corr;
      }
    } else {
      // acc += P V, four keys at a time (rows of V past the tile's keys
      // are 0 and so are their P columns).
      const float* prow = Ps + qi * LDP;
      const float* vcol = slot + 4 * c16;
#pragma unroll 4
      for (int j = 0; j < BK; j += 4) {
        float pa[RQ][4];
#pragma unroll
        for (int i = 0; i < RQ; ++i)
          load_cvt<float, 4>(prow + TY * i * LDP + j, pa[i]);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float vb[RD];
#pragma unroll
          for (int u = 0; u < RD / 4; ++u)
            load_cvt<float, 4>(vcol + (j + e) * LD + 64 * u, vb + 4 * u);
#pragma unroll
          for (int i = 0; i < RQ; ++i)
#pragma unroll
            for (int t2 = 0; t2 < RD; ++t2)
              acc[i][t2] = fmaf(pa[i][e], vb[t2], acc[i][t2]);
        }
      }
    }
  }
  cp_async_wait<0>();

  // One split: acc / l, 0 for a row that saw no key (its acc is 0 too).
  // Several: this split's acc, max (base 2) and denominator, unnormalised.
  const long long part = (long long)blockIdx.z * gridDim.x * sq + row0;
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int r = qi + TY * i;
    if (!q_ok[i]) continue;
    if (ws_o != nullptr) {
#pragma unroll
      for (int u = 0; u < RD / 4; ++u)
        store_cvt<float, float, 4>(ws_o + (part + r) * D + 4 * c16 + 64 * u,
                                   acc[i] + 4 * u);
      if (c16 == 0) {
        ws_ml[(part + r) * 2] = m_run[i];
        ws_ml[(part + r) * 2 + 1] = l_run[i];
      }
      continue;
    }
    const float l = l_run[i] == 0.f ? 1.f : l_run[i];
    float out[RD];
#pragma unroll
    for (int t2 = 0; t2 < RD; ++t2) out[t2] = acc[i][t2] / l;
#pragma unroll
    for (int u = 0; u < RD / 4; ++u)
      store_cvt<T, float, 4>(O + (row0 + r) * D + 4 * c16 + 64 * u,
                             out + 4 * u);
  }
}

// Merge the splits of a split-KV launch. part_o: (splits, rows, width)
// unnormalised accumulators, part_ml: (splits, rows, 2) each split's max
// (base 2) and denominator, both fp32; out: (rows, width) in the input type.
// m* = max_s m_s, w_s = 2^(m_s - m*) (0 where m_s = -inf: a split that saw
// no key), out = sum_s w_s acc_s / sum_s w_s l_s, exactly 0 where the
// denominator is 0. One warp per row, lanes on consecutive columns.
constexpr int kCombineThreads = 256;
constexpr int kCombineCols = 8;  // columns per lane: width <= 256

template <typename T>
__global__ void __launch_bounds__(kCombineThreads)
attn_combine_kernel(const float* __restrict__ part_o,
                    const float* __restrict__ part_ml, T* __restrict__ out,
                    int splits, long long rows, int width) {
  const long long row =
      (long long)blockIdx.x * (kCombineThreads / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  float m_max = neg_inf();
  for (int s = 0; s < splits; ++s)
    m_max = fmaxf(m_max, part_ml[(s * rows + row) * 2]);
  float num[kCombineCols] = {};
  float den = 0.f;
  for (int s = 0; s < splits; ++s) {
    const float m = part_ml[(s * rows + row) * 2];
    const float w = m == neg_inf() ? 0.f : exp2f(m - m_max);
    den += w * part_ml[(s * rows + row) * 2 + 1];
    const float* p = part_o + (s * rows + row) * width;
#pragma unroll
    for (int j = 0; j < kCombineCols; ++j)
      if (j * 32 + lane < width) num[j] += w * p[j * 32 + lane];
  }
#pragma unroll
  for (int j = 0; j < kCombineCols; ++j)
    if (j * 32 + lane < width)
      out[row * width + j * 32 + lane] =
          Num<T>::from_acc(den == 0.f ? 0.f : num[j] / den);
}

template <typename T>
static int launch_combine(const void* part_o, const void* part_ml, void* out,
                          int splits, long long rows, int width,
                          void* stream) {
  if (width > 32 * kCombineCols) return -1;
  constexpr int kRows = kCombineThreads / 32;
  const unsigned blocks = static_cast<unsigned>((rows + kRows - 1) / kRows);
  attn_combine_kernel<T><<<blocks, kCombineThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(part_o), static_cast<const float*>(part_ml),
      static_cast<T*>(out), splits, rows, width);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int BQ, int BK, int D, int STAGES>
static int launch(const void* q, const void* k, const void* v, void* o,
                  float* ws_o, float* ws_ml, int sq, int skv, int bq, int bk,
                  int batch, int splits, int causal, int use_window,
                  int window, float scale, cudaStream_t stream) {
  using L = Layout<BQ, BK, D, STAGES>;
  auto kernel = flash_attention_kernel<T, BQ, BK, D, STAGES>;
  if (int err = allow_smem(kernel, L::BYTES)) return err;
  dim3 grid(batch, (sq + bq - 1) / bq, splits);
  kernel<<<grid, kThreads, L::BYTES, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), ws_o, ws_ml, sq, skv, bq,
      bk, causal, use_window, window, scale);
  return static_cast<int>(cudaGetLastError());
}

// The instantiated (D, BQ, BK) tiles of f32 / f64 and the ring slots of
// each (three where they fit a block's shared memory, else two);
// kernels/attention.py reads ATTN_TILES["fma"] and ATTN_FMA_STAGES from
// these lines.
#define REPRO_ATTN_TILE(DD, TQ_, TK_, ST_)                                   \
  if (d == DD && tile_q == TQ_ && tile_k == TK_)                             \
    return launch<T, TQ_, TK_, DD, ST_>(q, k, v, o, ws_o, ws_ml, sq, skv,    \
                                        bq, bk, batch, splits, causal,       \
                                        use_window, window, scale, st);

template <typename T>
static int dispatch(const void* q, const void* k, const void* v, void* o,
                    void* ws_o_, void* ws_ml_, int sq, int skv, int d, int bq,
                    int bk, int tile_q, int tile_k, int batch, int splits,
                    int causal, int use_window, int window, float scale,
                    void* stream) {
  static_assert(std::is_same<T, float>::value || std::is_same<T, double>::value,
                "16-bit K5 is the tensor-core kernel of attention_tc.cuh");
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* ws_o = static_cast<float*>(ws_o_);
  float* ws_ml = static_cast<float*>(ws_ml_);
  REPRO_ATTN_TILE(64, 64, 32, 3)
  REPRO_ATTN_TILE(64, 64, 64, 3)
  REPRO_ATTN_TILE(64, 64, 128, 3)
  REPRO_ATTN_TILE(64, 128, 32, 3)
  REPRO_ATTN_TILE(64, 128, 64, 3)
  REPRO_ATTN_TILE(64, 128, 128, 3)
  REPRO_ATTN_TILE(128, 64, 32, 3)
  REPRO_ATTN_TILE(128, 64, 64, 3)
  REPRO_ATTN_TILE(128, 64, 128, 2)
  REPRO_ATTN_TILE(128, 128, 32, 3)
  REPRO_ATTN_TILE(128, 128, 64, 3)
  REPRO_ATTN_TILE(256, 64, 32, 3)
  REPRO_ATTN_TILE(256, 64, 64, 2)
  return -1;
}

#undef REPRO_ATTN_TILE

}  // namespace attn
}  // namespace repro

// Every element type defines the combine, whose C name takes the type of
// its output: REPRO_DEFINE_ATTN_COMBINE_API(f32, float) defines
// repro_attn_combine_f32.
#define REPRO_DEFINE_ATTN_COMBINE_API(SUFFIX, TYPE)                           \
  extern "C" int repro_attn_combine_##SUFFIX(                                 \
      const void* part_o, const void* part_ml, void* out, int splits,        \
      long long rows, int width, void* stream) {                              \
    return repro::attn::launch_combine<TYPE>(part_o, part_ml, out, splits,   \
                                             rows, width, stream);            \
  }

// One translation unit per element type expands this once:
// REPRO_DEFINE_ATTENTION_API(f32, float) defines repro_flash_attention_f32
// and repro_attn_combine_f32. q: (batch, sq, d), k/v: (batch, skv, d),
// o: (batch, sq, d), contiguous, d one of the instantiated widths; bq / bk
// the block, tile_q / tile_k the instantiated tile that runs it; use_window
// = 0 means no window. splits > 1 writes the workspace ws_o (splits, batch
// * sq, d) and ws_ml (splits, batch * sq, 2) instead of o (both null for
// one split). attention_tc.cuh defines the same signature for bf16 / f16.
#define REPRO_DEFINE_ATTENTION_API(SUFFIX, TYPE)                              \
  extern "C" int repro_flash_attention_##SUFFIX(                              \
      const void* q, const void* k, const void* v, void* o, void* ws_o,      \
      void* ws_ml, int sq, int skv, int d, int block_q, int block_k,         \
      int tile_q, int tile_k, int batch, int splits, int causal,             \
      int use_window, int window, float scale, void* stream) {                \
    return repro::attn::dispatch<TYPE>(q, k, v, o, ws_o, ws_ml, sq, skv, d,  \
                                       block_q, block_k, tile_q, tile_k,      \
                                       batch, splits, causal, use_window,     \
                                       window, scale, stream);                \
  }                                                                           \
  REPRO_DEFINE_ATTN_COMBINE_API(SUFFIX, TYPE)
