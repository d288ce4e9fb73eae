// K5 on the tensor cores: flash attention forward for bf16 / f16.
//
// Replaces the reference's `_attn_kernel` (src/repro/kernels/attention.py,
// launched by `_flash_attention`) for 16-bit inputs, where attention.cuh's
// FMA kernel keeps f32 and f64. What it computes is that kernel's contract,
// as attention.cuh states it: scores q.k^T.scale in fp32, queries
// right-aligned against the keys (q_pos = row + skv - sq), the causal mask
// k_pos <= q_pos and the window mask k_pos > q_pos - window, a running max,
// denominator and accumulator in fp32, acc / l at the end and exactly 0 for
// a row that sees no key.
//
// What bounds it: operations. Qwen3-1.7B prefill (16 heads x (4096, 4096,
// 128), causal) is 68.7 GFLOP of visible (query, key) pairs: 0.0695 ms at the
// 989 TFLOP/s dense bf16 / f16 tensor-core rate of an H100 SXM, where the
// fp32 FMA pipeline alone could not go below 1.025 ms. Decode (128 queries
// against 4096 keys) is bound by bytes and by the grid: split-KV below.
//
// Design (FlashAttention-3's shape, kept simple):
//
//   * One block per (leading index, query tile): gridDim.x the leading
//     index, gridDim.y the query tiles in reverse, so the longest causal
//     bands launch first, gridDim.z the KV splits.
//   * TMA. One producer thread loads the Q tile once and streams the band's
//     K and V tiles through a ring of kStages stages, each tracked by a full
//     and an empty mbarrier. Every tile arrives as [rows x 64] boxes
//     swizzled 128 B from a 3-D tensor map (d, sequence, leading index), so
//     rows past the sequence read as zeros, never as the next slice's.
//   * One consumer warpgroup per 64 query rows. S = Q.K^T is `wgmma`
//     m64nTKk16 with A = Q and B = K both K-major (K is stored (key, d):
//     trans-b = 0). The scores are scaled by scale x log2 e in fp32 (q is
//     not rounded after scaling; bf16 x bf16 products are exact in fp32),
//     masked -- elementwise only on tiles that cross the band's edge or hold
//     keys past the block's bk -- and exponentiated with exp2f against the
//     running max; the -inf guard is attention.cuh's (m_use).
//   * O += P.V is `wgmma` m64nDk16 in its register-A form: the score
//     accumulator's layout is the A fragment's, so the probabilities,
//     rounded to the input type, feed the product from registers. V is
//     stored (key, d), MN-major as B: trans-b = 1.
//   * Band skip as in attention.cuh (kv_range): only tiles that meet the
//     block's causal / window band are loaded.
//   * Split-KV as in attention.cuh: with gridDim.z > 1 each split writes its
//     unnormalised accumulator, max (base 2) and denominator to the fp32
//     workspace and attn_combine_kernel merges them.
//
// The launcher returns the launch's cudaError_t, -1 for a (D, TQ, TK) this
// file does not instantiate and -2 when a tensor map cannot be encoded.
// Operands must be contiguous and 16-byte aligned; the wrapper checks both.

#pragma once

#include "attention.cuh"  // kv_range, neg_inf, kLog2e, the combine kernel
#include "gemm_tc.cuh"    // mbarriers, TMA, wgmma, descriptors, store_acc

namespace repro {
namespace attn_tc {

using tc::fence_acc;
using tc::kAlign;
using tc::kBarrier;
using tc::make_desc;
using tc::mbar_arrive;
using tc::mbar_expect_tx;
using tc::mbar_init;
using tc::mbar_wait;
using tc::smem_u32;
using tc::tma_load;
using tc::wgmma_commit;
using tc::wgmma_fence;
using tc::wgmma_wait;

constexpr int kStages = 2;   // K / V ring stages
constexpr int kBoxCols = 64;  // columns of one 128-byte swizzled box

// Dynamic shared memory of one block: the Q tile, the ring of K and V tiles
// and the barriers (full and empty per stage, one for Q), after the
// alignment slack. kernels/attention.py:attn_smem_footprint computes the
// same, and a CPU test evaluates these formulas as written against it.
template <int TQ, int TK, int D> struct Smem {
  static constexpr int Q_BYTES = TQ * D * 2;
  static constexpr int KV_BYTES = TK * D * 2;
  static constexpr int STAGE = 2 * KV_BYTES;
  static constexpr int BYTES =
      kAlign + Q_BYTES + kStages * STAGE + (2 * kStages + 1) * kBarrier;
};

// Descriptor of a K-major operand (Q as A, K as B): rows of 64 elements
// (128 bytes, swizzled), 8-row groups 1024 bytes apart.
__device__ __forceinline__ uint64_t desc_k_major(uint32_t addr) {
  return make_desc(addr, 16, 1024, 1);
}

// Address of 16-deep step kk of a K-major tile stored as [rows x 64] boxes.
template <int ROWS>
__device__ __forceinline__ uint32_t k_step(uint32_t tile, int kk) {
  return tile + (kk / 4) * ROWS * 128 + (kk % 4) * 32;
}

// Descriptor of V, MN-major as B: [TK x 64] boxes, the next 64 columns one
// box (TK * 128 bytes) on, the next 8 keys 1024 bytes on.
template <int TK>
__device__ __forceinline__ uint64_t desc_v(uint32_t addr) {
  return make_desc(addr, TK * 128, 1024, 1);
}

template <typename T> __device__ __forceinline__ uint32_t pack2(float, float);
template <> __device__ __forceinline__ uint32_t pack2<__nv_bfloat16>(float lo,
                                                                   float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
template <> __device__ __forceinline__ uint32_t pack2<__half>(float lo,
                                                            float hi) {
  __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

template <typename T, int TQ, int TK, int D>
__global__ void __launch_bounds__(TQ / 64 * 128 + 32)
flash_attention_tc_kernel(const __grid_constant__ CUtensorMap map_q,
                          const __grid_constant__ CUtensorMap map_k,
                          const __grid_constant__ CUtensorMap map_v,
                          T* __restrict__ O, float* __restrict__ ws_o,
                          float* __restrict__ ws_ml, int sq, int skv, int bq,
                          int bk, int causal, int use_window, int window,
                          float scale_log2) {
  using S = Smem<TQ, TK, D>;
  constexpr int WG = TQ / 64;       // consumer warpgroups
  constexpr int BOXES = D / kBoxCols;
  constexpr int SN = TK / 2;        // score accumulators per thread
  constexpr int ON = D / 2;         // output accumulators per thread

  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* q_tile = tc::align_smem(smem);
  unsigned char* ring = q_tile + S::Q_BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kStages * S::STAGE);
  uint64_t* empty = full + kStages;
  uint64_t* q_bar = empty + kStages;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], WG * 128);
    }
    mbar_init(q_bar, 1);
    tc::mbar_init_fence();
  }
  __syncthreads();

  const int lead = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * bq;  // longest bands first
  const int rows = min(bq, sq - q0);
  const attn::KvRange kv = attn::kv_range(q0, rows, sq, skv, bk, causal,
                                          use_window, window, blockIdx.z,
                                          gridDim.z);

  if (warp == WG * 4) {
    // Producer: one thread loads Q once and keeps the K / V ring full.
    if (lane == 0 && kv.tiles > 0) {
      mbar_expect_tx(q_bar, S::Q_BYTES);
#pragma unroll
      for (int b = 0; b < BOXES; ++b)
        tma_load(q_tile + b * TQ * 128, &map_q, q_bar, b * kBoxCols, q0, lead);
      for (int t = 0; t < kv.tiles; ++t) {
        const int s = t % kStages;
        mbar_wait(&empty[s], ((t / kStages) & 1) ^ 1);
        unsigned char* st = ring + s * S::STAGE;
        const int k0 = kv.begin + t * bk;
        mbar_expect_tx(&full[s], S::STAGE);
#pragma unroll
        for (int b = 0; b < BOXES; ++b) {
          tma_load(st + b * TK * 128, &map_k, &full[s], b * kBoxCols, k0,
                   lead);
          tma_load(st + S::KV_BYTES + b * TK * 128, &map_v, &full[s],
                   b * kBoxCols, k0, lead);
        }
      }
    }
    return;
  }

  const int wg = warp / 4, wl = warp % 4;
  const uint32_t q_addr = smem_u32(q_tile) + wg * 64 * 128;
  const uint32_t ring_addr = smem_u32(ring);
  const int shift = skv - sq;
  // The thread's two rows: r and r + 8 of the warpgroup's 64.
  const int r = wl * 16 + (lane >> 2);
  const int valid = rows - wg * 64;  // rows of the warpgroup's 64 to write
  const int q_pos[2] = {q0 + wg * 64 + r + shift, q0 + wg * 64 + r + 8 + shift};
  // The warpgroup's first and last query positions, for the edge test.
  const int wg_lo = q0 + wg * 64 + shift;
  const int wg_hi = wg_lo + max(min(valid, 64), 1) - 1;

  float m_run[2] = {attn::neg_inf(), attn::neg_inf()};
  float l_run[2] = {0.f, 0.f};  // this thread's columns; summed at the end
  float o[ON];
#pragma unroll
  for (int i = 0; i < ON; ++i) o[i] = 0.f;
  float s[SN];
#pragma unroll
  for (int i = 0; i < SN; ++i) s[i] = 0.f;
  fence_acc(o);
  fence_acc(s);

  if (kv.tiles > 0) mbar_wait(q_bar, 0);
  for (int t = 0; t < kv.tiles; ++t) {
    const int st = t % kStages;
    mbar_wait(&full[st], (t / kStages) & 1);
    const uint32_t k_addr = ring_addr + st * S::STAGE;
    const uint32_t v_addr = k_addr + S::KV_BYTES;

    // S = Q K^T for the warpgroup's 64 rows.
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      tc::Wgmma<T, TK, 0>::run(s, desc_k_major(k_step<TQ>(q_addr, kk)),
                               desc_k_major(k_step<TK>(k_addr, kk)),
                               kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(s);

    // Scale; mask where the tile crosses the band's edge or holds keys
    // past this step's bk (or past the sequence, read as zeros).
    const int k0 = kv.begin + t * bk;
    const int keys = min(bk, skv - k0);
    const bool edge = keys < TK || (causal && k0 + TK - 1 > wg_lo) ||
                      (use_window && k0 <= wg_hi - window);
    if (edge) {
#pragma unroll
      for (int j = 0; j < TK / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int c = 8 * j + 2 * (lane & 3) + e;
            const int k_pos = k0 + c;
            const bool ok = c < keys && (!causal || k_pos <= q_pos[h]) &&
                            (!use_window || k_pos > q_pos[h] - window);
            float& x = s[4 * j + 2 * h + e];
            x = ok ? x * scale_log2 : attn::neg_inf();
          }
    } else {
#pragma unroll
      for (int i = 0; i < SN; ++i) s[i] *= scale_log2;
    }

    // Online softmax, base 2, per row; rescale the output accumulator.
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = attn::neg_inf();
#pragma unroll
      for (int j = 0; j < TK / 8; ++j)
        mx = fmaxf(mx, fmaxf(s[4 * j + 2 * h], s[4 * j + 2 * h + 1]));
      const float m_new = fmaxf(m_run[h], quad_max(mx));
      const float m_use = m_new == attn::neg_inf() ? 0.f : m_new;
      const float corr = exp2f(m_run[h] - m_use);
      m_run[h] = m_new;
      float l = 0.f;
#pragma unroll
      for (int j = 0; j < TK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = s[4 * j + 2 * h + e];
          x = exp2f(x - m_use);
          l += x;
        }
      l_run[h] = corr * l_run[h] + l;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        o[4 * j + 2 * h] *= corr;
        o[4 * j + 2 * h + 1] *= corr;
      }
    }

    // P, rounded to the input type, as register A fragments: k-step kk
    // covers score chunks 2 kk and 2 kk + 1.
    uint32_t p[TK / 16][4];
#pragma unroll
    for (int kk = 0; kk < TK / 16; ++kk) {
      p[kk][0] = pack2<T>(s[8 * kk], s[8 * kk + 1]);
      p[kk][1] = pack2<T>(s[8 * kk + 2], s[8 * kk + 3]);
      p[kk][2] = pack2<T>(s[8 * kk + 4], s[8 * kk + 5]);
      p[kk][3] = pack2<T>(s[8 * kk + 6], s[8 * kk + 7]);
    }

    // O += P V.
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < TK / 16; ++kk)
      tc::WgmmaRS<T, D>::run(o, p[kk], desc_v<TK>(v_addr + kk * 2048));
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(o);
    mbar_arrive(&empty[st]);
  }

  // One split: acc / l (0 for a row that saw no key: its acc is 0 too).
  // Several: this split's acc, max (base 2) and denominator, unnormalised.
  const long long row0 = (long long)lead * sq + q0 + wg * 64;
#pragma unroll
  for (int h = 0; h < 2; ++h) l_run[h] = quad_sum(l_run[h]);
  if (ws_o == nullptr) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float inv = l_run[h] == 0.f ? 0.f : 1.f / l_run[h];
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        o[4 * j + 2 * h] *= inv;
        o[4 * j + 2 * h + 1] *= inv;
      }
    }
    tc::store_acc<T, D>(O + row0 * D, D, o, lane, wl, valid);
    return;
  }
  const long long part = (long long)blockIdx.z * gridDim.x * sq + row0;
  tc::store_acc<float, D>(ws_o + part * D, D, o, lane, wl, valid);
  if ((lane & 3) == 0)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (r + 8 * h < valid) {
        ws_ml[(part + r + 8 * h) * 2] = m_run[h];
        ws_ml[(part + r + 8 * h) * 2 + 1] = l_run[h];
      }
}

template <typename T, int TQ, int TK, int D>
static int launch(const void* q, const void* k, const void* v, void* o,
                  float* ws_o, float* ws_ml, int sq, int skv, int bq, int bk,
                  int batch, int splits, int causal, int use_window,
                  int window, float scale, cudaStream_t stream) {
  constexpr auto swizzle = CU_TENSOR_MAP_SWIZZLE_128B;
  CUtensorMap map_q, map_k, map_v;
  if (int err = tc::encode<T>(&map_q, q, sq, D, TQ, kBoxCols, swizzle, batch))
    return err;
  if (int err = tc::encode<T>(&map_k, k, skv, D, TK, kBoxCols, swizzle,
                              batch))
    return err;
  if (int err = tc::encode<T>(&map_v, v, skv, D, TK, kBoxCols, swizzle,
                              batch))
    return err;
  const size_t smem = Smem<TQ, TK, D>::BYTES;
  auto kernel = flash_attention_tc_kernel<T, TQ, TK, D>;
  if (int err = allow_smem(kernel, smem)) return err;
  dim3 grid(batch, (sq + bq - 1) / bq, splits);
  kernel<<<grid, TQ / 64 * 128 + 32, smem, stream>>>(
      map_q, map_k, map_v, static_cast<T*>(o), ws_o, ws_ml, sq, skv, bq, bk,
      causal, use_window, window, scale * attn::kLog2e);
  return static_cast<int>(cudaGetLastError());
}

// The instantiated (D, TQ, TK) tiles of bf16 / f16; kernels/attention.py
// reads ATTN_TILES["tc"] from these lines. At D = 256 the 128 x 64 tile
// (two warpgroups, each with 128 output and 32 score accumulators) spilled
// and ptxas serialised its wgmma for want of registers, so D = 256 has the
// 64 x 64 tile only.
#define REPRO_ATTN_TC_TILE(DD, TQ_, TK_)                                     \
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
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* ws_o = static_cast<float*>(ws_o_);
  float* ws_ml = static_cast<float*>(ws_ml_);
  REPRO_ATTN_TC_TILE(64, 64, 64)
  REPRO_ATTN_TC_TILE(64, 64, 128)
  REPRO_ATTN_TC_TILE(64, 128, 64)
  REPRO_ATTN_TC_TILE(64, 128, 128)
  REPRO_ATTN_TC_TILE(128, 64, 64)
  REPRO_ATTN_TC_TILE(128, 64, 128)
  REPRO_ATTN_TC_TILE(128, 128, 64)
  REPRO_ATTN_TC_TILE(128, 128, 128)
  REPRO_ATTN_TC_TILE(256, 64, 64)
  return -1;
}

#undef REPRO_ATTN_TC_TILE

}  // namespace attn_tc
}  // namespace repro

// One translation unit per 16-bit type expands this once:
// REPRO_DEFINE_ATTENTION_TC_API(bf16, __nv_bfloat16) defines
// repro_flash_attention_bf16 on the tensor-core kernel, with the signature
// of attention.cuh's REPRO_DEFINE_ATTENTION_API, and repro_attn_combine_bf16.
#define REPRO_DEFINE_ATTENTION_TC_API(SUFFIX, TYPE)                           \
  extern "C" int repro_flash_attention_##SUFFIX(                              \
      const void* q, const void* k, const void* v, void* o, void* ws_o,      \
      void* ws_ml, int sq, int skv, int d, int block_q, int block_k,         \
      int tile_q, int tile_k, int batch, int splits, int causal,             \
      int use_window, int window, float scale, void* stream) {                \
    return repro::attn_tc::dispatch<TYPE>(                                    \
        q, k, v, o, ws_o, ws_ml, sq, skv, d, block_q, block_k, tile_q,       \
        tile_k, batch, splits, causal, use_window, window, scale, stream);    \
  }                                                                           \
  REPRO_DEFINE_ATTN_COMBINE_API(SUFFIX, TYPE)
