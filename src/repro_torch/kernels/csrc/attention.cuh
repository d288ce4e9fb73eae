// K5: flash attention forward, hand-written for Hopper.
//
// Replaces the reference's `_attn_kernel` (src/repro/kernels/attention.py,
// launched by `_flash_attention`). What it computes is that kernel's
// contract: per KV tile the scores q.k^T.scale in fp32 (scale applied to the
// fp32 query, as the reference does), queries right-aligned against the keys
// (q_pos = row + skv - sq), the causal mask k_pos <= q_pos and the window
// mask k_pos > q_pos - window, a running max, denominator and accumulator
// rescaled on every tile, and acc / l at the end -- 0 where l == 0.
//
// Layout. One block per (query tile, leading index): gridDim.x walks the
// query tiles, gridDim.y the flattened leading dims (batch x heads), so a
// whole (B, S, D) stack is one launch -- the counterpart of the reference's
// jax.vmap over one-slice calls. The reference's sequential KV grid axis
// carried (max, denom, acc) in scratch from one grid step to the next; blocks
// on this card run in any order, so the KV loop is inside the block and the
// running state never leaves registers. The query tile is staged once, in
// fp32, already scaled; each KV step stages the K tile (transposed) and the
// V tile in fp32, computes the (BQ, BK) score tile in a register micro-tile
// per thread, reduces each row's max and sum across the 16 threads that
// share the row with warp shuffles, writes the probabilities to shared memory
// and accumulates P.V into a (BQ/16, D/16) register micro-tile.
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
// Tiles. (BQ, BK, D) are template parameters: BQ, BK are the tile's capacity
// in queries and keys, D the head width. A launch may ask for a smaller
// block (bq <= BQ, bk <= BK, any value): the kernel then processes bq
// queries per block and bk keys per step and masks the rest of the tile, so
// any block that divides the sequence and fits an instantiated tile runs.
// The launcher returns -1 for a (D, BQ, BK) it does not instantiate; the
// Python wrapper reads the table from the REPRO_ATTN_TILE lines below
// (kernels/attention.py, ATTN_TILES["fma"]).
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
// attention_tc.cuh.

#pragma once

#include <type_traits>

#include "gemm.cuh"  // Num, Pack, load_cvt, store_cvt, Frag, allow_smem

namespace repro {
namespace attn {

constexpr int kThreads = 256;  // 16 x 16
constexpr int kPad = 4;        // shared-memory row padding (floats)

// Shared-memory layout of one block, all fp32: the query tile transposed
// (Qt[D][BQ + pad]), the key tile transposed (Kt[D][BK + pad]), the value
// tile (Vs[BK][D + pad]) and the probabilities transposed (Pt[BK][BQ + pad]).
// kernels/attention.py:attn_smem_footprint mirrors BYTES.
template <int BQ, int BK, int D>
struct Layout {
  static constexpr int LDQ = BQ + kPad;
  static constexpr int LDK = BK + kPad;
  static constexpr int LDV = D + kPad;
  static constexpr int LDP = BQ + kPad;
  static constexpr int K_OFF = D * LDQ;
  static constexpr int V_OFF = K_OFF + D * LDK;
  static constexpr int P_OFF = V_OFF + BK * LDV;
  static constexpr int FLOATS = P_OFF + BK * LDP;
  static constexpr size_t BYTES = sizeof(float) * FLOATS;
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

// Stage rows [0, valid) of a row-major (., D) matrix TRANSPOSED into
// dst[d * (CAP + kPad) + r] as fp32 times `mul`; rows [valid, CAP) are 0.
// Neighbouring threads take neighbouring rows of one 16-byte column chunk,
// so each shared-memory store of a warp hits 32 consecutive words.
template <typename T, int CAP, int D>
__device__ __forceinline__ void stage_transposed(const T* src, int valid,
                                                 float mul, float* dst,
                                                 int tid) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int VPR = D / VEC;  // 16-byte vectors per row
  constexpr int LD = CAP + kPad;
  for (int v = tid; v < CAP * VPR; v += kThreads) {
    const int c = (v / CAP) * VEC;
    const int r = v - (v / CAP) * CAP;
    if (r < valid) {
      Pack<T, VEC> pk =
          *reinterpret_cast<const Pack<T, VEC>*>(src + (long long)r * D + c);
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        dst[(c + e) * LD + r] = static_cast<float>(Num<T>::to_acc(pk.v[e])) * mul;
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) dst[(c + e) * LD + r] = 0.f;
    }
  }
}

// Stage rows [0, valid) of a row-major (., D) matrix as fp32 rows of
// dst[r * (D + kPad) + d]; rows [valid, CAP) are 0. Stores are 16 bytes.
template <typename T, int CAP, int D>
__device__ __forceinline__ void stage_rows(const T* src, int valid,
                                           float* dst, int tid) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int VPR = D / VEC;
  constexpr int LD = D + kPad;
  for (int v = tid; v < CAP * VPR; v += kThreads) {
    const int r = v / VPR;
    const int c = (v - r * VPR) * VEC;
    float f[VEC];
    if (r < valid) {
      Pack<T, VEC> pk =
          *reinterpret_cast<const Pack<T, VEC>*>(src + (long long)r * D + c);
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        f[e] = static_cast<float>(Num<T>::to_acc(pk.v[e]));
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) f[e] = 0.f;
    }
    store_cvt<float, float, VEC>(dst + r * LD + c, f);
  }
}

// Max (or sum) of a value over the 16 threads of a half-warp: the threads
// that share one row of the score tile.
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <typename T, int BQ, int BK, int D>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ Q, const T* __restrict__ K,
                       const T* __restrict__ V, T* __restrict__ O,
                       float* __restrict__ ws_o, float* __restrict__ ws_ml,
                       int sq, int skv, int bq, int bk, int causal,
                       int use_window, int window, float scale) {
  using L = Layout<BQ, BK, D>;
  constexpr int TQ = BQ / 16, TK = BK / 16, TD = D / 16;
  using FQ = Frag<TQ>;
  using FK = Frag<TK>;
  using FD = Frag<TD>;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Qt = reinterpret_cast<float*>(smem_raw);
  float* Kt = Qt + L::K_OFF;
  float* Vs = Qt + L::V_OFF;
  float* Pt = Qt + L::P_OFF;

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const long long lead = blockIdx.y;
  const int q0 = blockIdx.x * bq;
  const int rows = min(bq, sq - q0);
  const long long row0 = lead * sq + q0;  // first output row of the block
  Q += row0 * D;
  K += lead * skv * (long long)D;
  V += lead * skv * (long long)D;

  const int shift = skv - sq;
  const KvRange kv = kv_range(q0, rows, sq, skv, bk, causal, use_window,
                              window, blockIdx.z, gridDim.z);

  stage_transposed<T, BQ, D>(Q, rows, scale, Qt, tid);

  int q_pos[TQ];
  bool q_ok[TQ];
  float m_run[TQ], l_run[TQ];
  float acc[TQ][TD];
#pragma unroll
  for (int i = 0; i < TQ; ++i) {
    const int r = FQ::row(i, ty);
    q_pos[i] = q0 + r + shift;
    q_ok[i] = r < rows;
    m_run[i] = neg_inf();
    l_run[i] = 0.f;
#pragma unroll
    for (int t = 0; t < TD; ++t) acc[i][t] = 0.f;
  }

  for (int t = 0; t < kv.tiles; ++t) {
    const int k0 = kv.begin + t * bk;
    const int keys = min(bk, skv - k0);
    __syncthreads();  // the previous step is done with Kt, Vs and Pt
    stage_transposed<T, BK, D>(K + (long long)k0 * D, keys, 1.f, Kt, tid);
    stage_rows<T, BK, D>(V + (long long)k0 * D, keys, Vs, tid);
    __syncthreads();

    // S = (scale q) k^T for the thread's (TQ, TK) micro-tile.
    float s[TQ][TK];
#pragma unroll
    for (int i = 0; i < TQ; ++i)
#pragma unroll
      for (int j = 0; j < TK; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float a[TQ], b[TK];
#pragma unroll
      for (int c = 0; c < FQ::NCHUNK; ++c)
        load_cvt<float, FQ::V>(Qt + d * L::LDQ + FQ::offset(c, ty),
                               a + c * FQ::V);
#pragma unroll
      for (int c = 0; c < FK::NCHUNK; ++c)
        load_cvt<float, FK::V>(Kt + d * L::LDK + FK::offset(c, tx),
                               b + c * FK::V);
#pragma unroll
      for (int i = 0; i < TQ; ++i)
#pragma unroll
        for (int j = 0; j < TK; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
    }

    // Mask, online softmax, rescale; probabilities into Pt.
#pragma unroll
    for (int i = 0; i < TQ; ++i) {
      float m_tile = neg_inf();
#pragma unroll
      for (int j = 0; j < TK; ++j) {
        const int c = FK::row(j, tx);
        const int k_pos = k0 + c;
        const bool ok = q_ok[i] && c < keys && (!causal || k_pos <= q_pos[i]) &&
                        (!use_window || k_pos > q_pos[i] - window);
        s[i][j] = ok ? s[i][j] : neg_inf();
        m_tile = fmaxf(m_tile, s[i][j]);
      }
      const float m_new = fmaxf(m_run[i], row_max(m_tile));
      const float m_use = m_new == neg_inf() ? 0.f : m_new;
      const float corr = expf(m_run[i] - m_use);
      float l_tile = 0.f;
#pragma unroll
      for (int j = 0; j < TK; ++j) {
        s[i][j] = expf(s[i][j] - m_use);
        l_tile += s[i][j];
      }
      l_run[i] = corr * l_run[i] + row_sum(l_tile);
      m_run[i] = m_new;
#pragma unroll
      for (int t = 0; t < TD; ++t) acc[i][t] *= corr;
#pragma unroll
      for (int j = 0; j < TK; ++j)
        Pt[FK::row(j, tx) * L::LDP + FQ::row(i, ty)] = s[i][j];
    }
    __syncthreads();

    // acc += P V (rows of Vs past `keys` are 0 and so are their P columns).
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float a[TQ], b[TD];
#pragma unroll
      for (int u = 0; u < FQ::NCHUNK; ++u)
        load_cvt<float, FQ::V>(Pt + c * L::LDP + FQ::offset(u, ty),
                               a + u * FQ::V);
#pragma unroll
      for (int u = 0; u < FD::NCHUNK; ++u)
        load_cvt<float, FD::V>(Vs + c * L::LDV + FD::offset(u, tx),
                               b + u * FD::V);
#pragma unroll
      for (int i = 0; i < TQ; ++i)
#pragma unroll
        for (int t = 0; t < TD; ++t) acc[i][t] = fmaf(a[i], b[t], acc[i][t]);
    }
  }

  // One split: acc / l, 0 for a row that saw no key (its acc is 0 too).
  // Several: this split's acc, max (base 2) and denominator, unnormalised.
  const long long part = (long long)blockIdx.z * gridDim.y * sq + row0;
#pragma unroll
  for (int i = 0; i < TQ; ++i) {
    const int r = FQ::row(i, ty);
    if (!q_ok[i]) continue;
    if (ws_o != nullptr) {
#pragma unroll
      for (int u = 0; u < FD::NCHUNK; ++u)
        store_cvt<float, float, FD::V>(
            ws_o + (part + r) * D + FD::offset(u, tx), acc[i] + u * FD::V);
      if (tx == 0) {
        ws_ml[(part + r) * 2] = m_run[i] * kLog2e;
        ws_ml[(part + r) * 2 + 1] = l_run[i];
      }
      continue;
    }
    const float l = l_run[i] == 0.f ? 1.f : l_run[i];
    float out[TD];
#pragma unroll
    for (int t = 0; t < TD; ++t) out[t] = acc[i][t] / l;
#pragma unroll
    for (int u = 0; u < FD::NCHUNK; ++u)
      store_cvt<T, float, FD::V>(O + (row0 + r) * D + FD::offset(u, tx),
                                 out + u * FD::V);
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

template <typename T, int BQ, int BK, int D>
static int launch(const void* q, const void* k, const void* v, void* o,
                  float* ws_o, float* ws_ml, int sq, int skv, int bq, int bk,
                  int batch, int splits, int causal, int use_window,
                  int window, float scale, cudaStream_t stream) {
  using L = Layout<BQ, BK, D>;
  auto kernel = flash_attention_kernel<T, BQ, BK, D>;
  if (int err = allow_smem(kernel, L::BYTES)) return err;
  dim3 grid((sq + bq - 1) / bq, batch, splits);
  kernel<<<grid, kThreads, L::BYTES, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), ws_o, ws_ml, sq, skv, bq,
      bk, causal, use_window, window, scale);
  return static_cast<int>(cudaGetLastError());
}

// The instantiated (D, BQ, BK) tiles of f32 / f64; kernels/attention.py
// reads ATTN_TILES["fma"] from these lines.
#define REPRO_ATTN_TILE(DD, TQ_, TK_)                                        \
  if (d == DD && tile_q == TQ_ && tile_k == TK_)                             \
    return launch<T, TQ_, TK_, DD>(q, k, v, o, ws_o, ws_ml, sq, skv, bq, bk, \
                                   batch, splits, causal, use_window, window,\
                                   scale, st);

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
  REPRO_ATTN_TILE(64, 64, 32)
  REPRO_ATTN_TILE(64, 64, 64)
  REPRO_ATTN_TILE(64, 64, 128)
  REPRO_ATTN_TILE(64, 128, 32)
  REPRO_ATTN_TILE(64, 128, 64)
  REPRO_ATTN_TILE(64, 128, 128)
  REPRO_ATTN_TILE(128, 64, 32)
  REPRO_ATTN_TILE(128, 64, 64)
  REPRO_ATTN_TILE(128, 64, 128)
  REPRO_ATTN_TILE(128, 128, 32)
  REPRO_ATTN_TILE(128, 128, 64)
  REPRO_ATTN_TILE(256, 64, 32)
  REPRO_ATTN_TILE(256, 64, 64)
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
