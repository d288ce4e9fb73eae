// K1-K3 for fp64 operands on Hopper's fp64 tensor cores (DMMA).
//
//   matmul_dmma_kernel        C = A @ B. Replaces the reference's
//                             `matmul_kernel` (src/repro/kernels/matmul.py,
//                             launched by `matmul_pallas`) for f64.
//   square_whole_dmma_kernel  C = A @ A from one staged copy of A (P^2 fits a
//                             block's shared memory). Replaces
//                             `square_kernel` (tier "whole" of
//                             `square_pallas`) for f64.
//   square_panel_dmma_kernel  C = A @ A from an (H, P) row panel resident in
//                             shared memory. Replaces `square_panel_kernel`
//                             (tier "panel") for f64.
//
// gemm.cuh's FMA kernels keep f32. Every product is a fused fp64
// multiply-add (`mma.sync...f64.f64.f64.f64`): no reduced precision
// anywhere, the sum only taken in another order than a sequential FMA loop's
// (and, in K2 / K3, in K slices whose partial sums are added at the end).
//
// What bounds K1 on this card: operations. A (4096^2) @ (4096^2) f64 product
// is 137 GFLOP over 403 MB (each operand read once, the result written
// once): 2.051 ms at the 67 TFLOP/s the H100 SXM data sheet gives for fp64
// on the tensor cores, against 0.120 ms for the bytes at 3.35 TB/s. The FMA
// pipeline gives half that rate (34 TFLOP/s), so no FMA kernel can come
// under 4.04 ms; gemm.cuh's took 11.1 ms on an NVIDIA H100 80GB HBM3 at a
// 700 W power limit (chip_smoke.py, phase "kernels").
//
// What bounds K2 and K3: neither rate. Their tiers hold small operands (K2
// P <= 160, K3 P <= 384 at the chain's 64-wide tile): a 256^2 squaring is
// 33.6 MFLOP (0.5 us at 67 TFLOP/s) over 1 MB (0.31 us at 3.35 TB/s). What
// a block spends is the copy of its operands from L2 into shared memory and
// the latency of a short K loop, and what the grid spends is the SMs it
// leaves idle. So K2 and K3 pick their own output tiles and grids
// (kernels/matmul.py:square_whole_grid / square_panel_grid) for the least
// time on the busiest SM -- K steps waited through, bytes staged and DMMA
// flops, a model fitted on the card -- on output tiles down to 16 rows,
// DMMA's own height, and split K across a block's warps where the tile is
// too small to give each warp its own part.
//
// What the design does about it:
//
//   * m16n8k8 (four doubles of A, two of B, four of C per thread), one of
//     the fp64 shapes PTX ISA 7.8 added for sm_90 beside m16n8k4 and
//     m16n8k16: half the instructions of m16n8k4 and half the fragment
//     registers of m16n8k16. (m8n8k4 is the sm_80 form.)
//   * K1: a square TILE x TILE block tile of four warps (DmmaWarps, 2 x 2),
//     each a 32 x 32 (tile 64) or 16 x 16 (tile 32) warp tile. A 32 x 32
//     warp tile loads 16 doubles from shared memory per 8 DMMAs of 2,048
//     flops each, and takes 152-160 registers, so three blocks share an SM.
//     A 128-wide tile (eight 64 x 32 warps, 224 registers, one block per
//     SM), measured at K step 16 with 3 stages, ran slower on the card
//     (PERF.md), so it is not instantiated.
//   * K1's ring of STAGES `cp.async` stages (the REPRO_DMMA_TILE table), each
//     the [TILE x BK] tile of A and the [BK x TILE] tile of B, row-major as
//     they lie in memory. A fragment element is one 8-byte `ld.shared`,
//     which `ldmatrix` (16-bit rows) cannot do, so every staged row is
//     padded by kPad = 4 doubles: with a pitch of 4 mod 16 doubles, a
//     half-warp's 16 loads (rows g and columns t of a fragment, g, t < 4)
//     land on 16 distinct 8-byte bank pairs instead of four.
//   * K2 and K3: blocks of four warps (SquareWarps) over a TM x TN output
//     tile, warp tiles of 16 x min(TN, 32) (32 x 32 in a 64-row tile); the
//     warps the output leaves over are K slices, each taking every KS-th k8
//     step. At the end of a tile the slices past the first hand their sums
//     to the first through shared memory, which adds them in slice order.
//   * K2 stages A once per block into a [P][P + kPad] image: the 16 x 16
//     boxes its tiles read (their box rows for the left operand, their box
//     columns for the right), then computes every tile from that one copy.
//     Landing the boxes K step by K step, a commit group and a barrier each,
//     so that DMMA on the first step starts early, measured 8 % slower on
//     the card than one wait for all of them (PERF.md §6).
//   * K3 keeps the row panel [H][P + kPad] resident: it lands box by box in
//     the commit groups of the first column tile's K steps, and the column
//     tiles [BK][W + kPad] stream through a `cp.async` ring of STAGES (the
//     REPRO_DMMA_PANEL table) while the block loops over its share of them.
//     A block's time goes mostly to the ring's steps (PERF.md), so each
//     pair has a ring of K step 64 and, for P a multiple of 32 only, one of
//     32; the launch takes the deepest whose K step divides P. (A last,
//     partial step in the 64-deep ring cost every step 20 % on the card.)
//   * Epilogue: each thread's accumulator pairs are adjacent columns, stored
//     as 16-byte writes.
//
// The stacked form is the same kernel with the stack on gridDim.z and a
// per-operand stride (0 broadcasts a 2-D operand). Plain C interface, as
// gemm.cuh: the launcher returns the launch's cudaError_t, -1 for a tile or
// pair this file does not instantiate.

#pragma once

#include <cuda_runtime.h>

#include "gemm.cuh"

namespace repro {
namespace dmma {

constexpr int kPad = 4;                   // row padding of the staged tiles
constexpr int kBox = 16;                  // side of K2's staging boxes
constexpr int kSquareWarps = 4;           // warps of a K2 / K3 block
constexpr int kSquareThreads = 32 * kSquareWarps;
constexpr int kWholeRed = 32 * (32 + kPad) * 8;   // K2's partial sums

// The dynamic shared memory of each launcher. kernels/matmul.py computes the
// same (dmma_smem_bytes, dmma_panel_smem_bytes, whole_dmma_smem_bytes), and a
// CPU test evaluates the formulas of DmmaRing, DmmaPanel and DmmaWhole as
// written here against it.

// K1: STAGES stages of the padded A and B tiles.
template <int TILE, int BK, int STAGES> struct DmmaRing {
  static constexpr int LDA = BK + kPad;
  static constexpr int LDB = TILE + kPad;
  static constexpr int STAGE = (TILE * LDA + BK * LDB) * 8;
  static constexpr int BYTES = STAGES * STAGE;
};

// Warps of a K1 block: WARPS_M x WARPS_N, each a WM x WN warp tile of MI
// m16 tiles by NJ n8 tiles.
template <int TILE> struct DmmaWarps {
  static constexpr int WARPS_M = 2, WARPS_N = 2;
  static constexpr int THREADS = 32 * WARPS_M * WARPS_N;
  static constexpr int WM = TILE / WARPS_M, WN = TILE / WARPS_N;
  static constexpr int MI = WM / 16, NJ = WN / 8;
};

// Warps of a K2 / K3 block over a TM x TN output tile: OUT warp tiles of
// WM x WN (WARPS_N of them across), and KS K slices of OUT warps each. The
// slices past the first keep their partial sums in [KS - 1][TM][LDR]
// doubles (RED bytes) at the end of a tile.
template <int TM, int TN> struct SquareWarps {
  static constexpr int WM = TM < 64 ? 16 : 32;
  static constexpr int WN = TN < 32 ? TN : 32;
  static constexpr int WARPS_N = TN / WN;
  static constexpr int OUT = TM / WM * WARPS_N;
  static constexpr int KS = kSquareWarps / OUT;
  static constexpr int MI = WM / 16;
  static constexpr int NJ = WN / 8;
  static constexpr int LDR = TN + kPad;
  static constexpr int RED = (KS - 1) * TM * LDR * 8;
};

// K3: the [H][P + kPad] row panel, STAGES stages of [BK][W + kPad] column
// tiles and the K slices' partial sums.
template <int H, int W, int BK, int STAGES> struct DmmaPanel {
  static constexpr int LDB = W + kPad;
  static constexpr int STAGE = BK * LDB * 8;
  static constexpr int RED = SquareWarps<H, W>::RED;
  static size_t bytes(int P) {
    return (size_t)H * (P + kPad) * 8 + STAGES * STAGE + RED;
  }
};

// K2: the [P][P + kPad] image of A and room for the partial sums of every
// instantiated tile (tile 32's second slice is the largest).
struct DmmaWhole {
  static size_t bytes(int P) {
    return (size_t)P * (P + kPad) * 8 + kWholeRed;
  }
};

// D = A (16 x 8, row) * B (8 x 8, col) + D in fp64. Thread l (g = l / 4,
// t = l % 4) holds A elements (g + 8 (i % 2), t + 4 (i / 2)), B elements
// (t + 4 i, g) and C elements (g + 8 (i / 2), 2 t + i % 2).
__device__ __forceinline__ void dmma(double (&c)[4], const double (&a)[4],
                                     const double (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]), "d"(b[1]));
}

// One k8 step of a warp tile of MI x NJ m16n8 tiles from shared memory: `a`
// is the warp's first row of A at the step's first k (row pitch lda), `b`
// the step's first row of B at the warp's first column (row pitch ldb).
template <int MI, int NJ>
__device__ __forceinline__ void warp_k8(double (&acc)[MI][NJ][4],
                                        const double* a, int lda,
                                        const double* b, int ldb, int g,
                                        int t) {
  double af[MI][4], bf[NJ][2];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      af[i][e] = a[(i * 16 + g + 8 * (e & 1)) * lda + t + 4 * (e >> 1)];
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) bf[j][e] = b[(t + 4 * e) * ldb + j * 8 + g];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) dmma(acc[i][j], af[i], bf[j]);
}

template <int MI, int NJ>
__device__ __forceinline__ void zero_frags(double (&acc)[MI][NJ][4]) {
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0;
}

// Store a warp tile's accumulators; `c` is its first element (row stride
// ldc).
template <int MI, int NJ>
__device__ __forceinline__ void store_frags(double* c, long long ldc,
                                            const double (&acc)[MI][NJ][4],
                                            int g, int t) {
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      double* p = c + (long long)(i * 16 + g) * ldc + j * 8 + 2 * t;
      *reinterpret_cast<Pack<double, 2>*>(p) = {{acc[i][j][0], acc[i][j][1]}};
      *reinterpret_cast<Pack<double, 2>*>(p + 8 * ldc) =
          {{acc[i][j][2], acc[i][j][3]}};
    }
}

// The end of a K2 / K3 output tile whose first element is c (row stride
// ldc): the K slices past the first hand their sums to the first through
// `red`, which adds them in slice order and stores the tile. Every thread
// of the block calls it; with KS > 1 it ends in a barrier, so `red` may be
// written again.
template <int TM, int TN>
__device__ __forceinline__ void finish_tile(
    double (&acc)[SquareWarps<TM, TN>::MI][SquareWarps<TM, TN>::NJ][4],
    double* red, double* c, long long ldc, int q, int wm, int wn, int g,
    int t) {
  using S = SquareWarps<TM, TN>;
  if constexpr (S::KS > 1) {
    auto at = [&](int slice, int i, int j, int e) -> double& {
      return red[((slice - 1) * TM + wm + i * 16 + g + 8 * (e >> 1)) * S::LDR +
                 wn + j * 8 + 2 * t + (e & 1)];
    };
    if (q > 0) {
#pragma unroll
      for (int i = 0; i < S::MI; ++i)
#pragma unroll
        for (int j = 0; j < S::NJ; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) at(q, i, j, e) = acc[i][j][e];
    }
    __syncthreads();
    if (q == 0) {
#pragma unroll
      for (int s = 1; s < S::KS; ++s)
#pragma unroll
        for (int i = 0; i < S::MI; ++i)
#pragma unroll
          for (int j = 0; j < S::NJ; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[i][j][e] += at(s, i, j, e);
    }
  }
  if (q == 0) store_frags(c + (long long)wm * ldc + wn, ldc, acc, g, t);
  if constexpr (S::KS > 1) __syncthreads();
}

// ---------------------------------------------------------------------------
// K1: C[M,N] = A[M,K] @ B[K,N]
// ---------------------------------------------------------------------------

template <int TILE, int BK, int STAGES>
__global__ void __launch_bounds__(DmmaWarps<TILE>::THREADS)
matmul_dmma_kernel(const double* __restrict__ A, const double* __restrict__ B,
                   double* __restrict__ C, int M, int N, int K, long long sA,
                   long long sB, long long sC) {
  using R = DmmaRing<TILE, BK, STAGES>;
  using W = DmmaWarps<TILE>;
  constexpr int STAGE_D = R::STAGE / 8;   // doubles per ring stage

  extern __shared__ __align__(16) unsigned char smem[];
  double* ring = reinterpret_cast<double*>(smem);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const int wm = (warp / W::WARPS_N) * W::WM, wn = (warp % W::WARPS_N) * W::WN;
  const long long row0 = (long long)blockIdx.y * TILE;
  const long long col0 = (long long)blockIdx.x * TILE;
  A += blockIdx.z * sA + row0 * K;
  B += blockIdx.z * sB + col0;
  C += blockIdx.z * sC + row0 * N + col0;

  // One ring stage: A's [TILE x BK] tile and B's [BK x TILE] tile of K step
  // k0, 16 bytes (two doubles) per cp.async.
  auto stage = [&](int s, int k0) {
    double* As = ring + s * STAGE_D;
    double* Bs = As + TILE * R::LDA;
    for (int v = tid; v < TILE * BK / 2; v += W::THREADS) {
      const int r = v / (BK / 2), c = (v % (BK / 2)) * 2;
      cp_async16(As + r * R::LDA + c, A + r * (long long)K + k0 + c);
    }
    for (int v = tid; v < BK * TILE / 2; v += W::THREADS) {
      const int r = v / (TILE / 2), c = (v % (TILE / 2)) * 2;
      cp_async16(Bs + r * R::LDB + c, B + (long long)(k0 + r) * N + c);
    }
  };

  const int k_tiles = K / BK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < k_tiles) stage(s, s * BK);
    cp_async_commit();
  }

  double acc[W::MI][W::NJ][4];
  zero_frags(acc);

  for (int kt = 0; kt < k_tiles; ++kt) {
    // Stage kt has landed for this thread; the barrier makes it everyone's
    // and tells every thread that the stage read at kt - 1 is free again.
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    const int next = kt + STAGES - 1;
    if (next < k_tiles) stage(next % STAGES, next * BK);
    cp_async_commit();

    const double* As = ring + (kt % STAGES) * STAGE_D + wm * R::LDA;
    const double* Bs = ring + (kt % STAGES) * STAGE_D + TILE * R::LDA + wn;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 8)
      warp_k8(acc, As + kk, R::LDA, Bs + kk * R::LDB, R::LDB, g, t);
  }
  cp_async_wait<0>();
  store_frags(C + (long long)wm * N + wn, N, acc, g, t);
}

// ---------------------------------------------------------------------------
// K2: C = A @ A, the boxes of A a block's tiles read staged once per block
// ---------------------------------------------------------------------------

// Block (x, 0, z) computes the output tiles x, x + gridDim.x, ... of matrix
// z, all from one copy of A in shared memory.
template <int TILE>
__global__ void __launch_bounds__(kSquareThreads)
square_whole_dmma_kernel(const double* __restrict__ A, double* __restrict__ C,
                         int P, long long sA, long long sC) {
  using S = SquareWarps<TILE, TILE>;
  static_assert(S::OUT * S::KS == kSquareWarps && S::RED <= kWholeRed,
                "K2's warps and partial sums");
  static_assert(TILE % kBox == 0 && kBox * kBox / 2 == kSquareThreads,
                "a tile is whole boxes; a box is one 16-byte copy a thread");

  extern __shared__ __align__(16) unsigned char smem[];
  const int ld = P + kPad;
  double* As = reinterpret_cast<double*>(smem);   // [P][ld]
  double* red = As + (size_t)P * ld;               // [KS - 1][TILE][LDR]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const int q = warp / S::OUT, wo = warp % S::OUT;
  const int wm = wo / S::WARPS_N * S::WM, wn = wo % S::WARPS_N * S::WN;
  A += blockIdx.z * sA;
  C += blockIdx.z * sC;

  const int per_row = P / TILE, n_tiles = per_row * per_row;
  const int nb = P / kBox;                       // boxes per side, <= 32
  unsigned rows = 0, cols = 0;   // bit i: box row / column i is the block's
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
#pragma unroll
    for (int i = 0; i < TILE / kBox; ++i) {
      rows |= 1u << (tile / per_row * (TILE / kBox) + i);
      cols |= 1u << (tile % per_row * (TILE / kBox) + i);
    }
  }

  // The block reads box (bi, bj) as a left operand if box row bi is its,
  // as a right one if box column bj is: it copies every such box, all in
  // one commit group, and waits for all of them. One box is 16 rows of 8
  // 16-byte chunks, one a thread.
  const int r = tid >> 3, ch = (tid & 7) * 2;
  for (int bi = 0; bi < nb; ++bi)
    for (int bj = 0; bj < nb; ++bj) {
      if (!(rows >> bi & 1) && !(cols >> bj & 1)) continue;
      const int row = bi * kBox + r, col = bj * kBox + ch;
      cp_async16(As + row * ld + col, A + (long long)row * P + col);
    }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int row0 = tile / per_row * TILE, col0 = tile % per_row * TILE;
    double acc[S::MI][S::NJ][4];
    zero_frags(acc);
    const double* a = As + (row0 + wm) * ld;
    const double* b = As + col0 + wn;
    for (int k = q * 8; k < P; k += 8 * S::KS)
      warp_k8(acc, a + k, ld, b + k * ld, ld, g, t);
    finish_tile<TILE, TILE>(acc, red, C + (long long)row0 * P + col0, P, q,
                            wm, wn, g, t);
  }
}

// ---------------------------------------------------------------------------
// K3: C = A @ A, an (H, P) row panel staged once per block
// ---------------------------------------------------------------------------

// Block (x, y, z) owns row panel y of matrix z and the column tiles x,
// x + gridDim.x, ...; its output tiles are H x W. Its work is one flat
// sequence of steps -- (column tile, K step) -- through one ring, so the
// next tile's first steps are in flight while the last ones of a tile
// compute.
template <int H, int W, int BK, int STAGES>
__global__ void __launch_bounds__(kSquareThreads)
square_panel_dmma_kernel(const double* __restrict__ A, double* __restrict__ C,
                         int P, long long sA, long long sC) {
  using S = SquareWarps<H, W>;
  using L = DmmaPanel<H, W, BK, STAGES>;
  constexpr int STAGE_D = L::STAGE / 8;    // doubles per ring stage
  static_assert(S::OUT * S::KS == kSquareWarps, "K3's warps");
  static_assert(BK / 8 % S::KS == 0, "each K slice takes whole k8 steps");

  extern __shared__ __align__(16) unsigned char smem[];
  const int ldp = P + kPad;
  double* panel = reinterpret_cast<double*>(smem);   // [H][ldp], resident
  double* ring = panel + (size_t)H * ldp;            // [STAGES][BK][LDB]
  double* red = ring + STAGES * STAGE_D;             // [KS - 1][H][LDR]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const int q = warp / S::OUT, wo = warp % S::OUT;
  const int wm = wo / S::WARPS_N * S::WM, wn = wo % S::WARPS_N * S::WN;
  const long long row0 = (long long)blockIdx.y * H;
  A += blockIdx.z * sA;
  C += blockIdx.z * sC + row0 * P;

  const int k_tiles = P / BK;
  const int mine = (P / W - 1 - (int)blockIdx.x) / (int)gridDim.x + 1;
  const int steps = mine * k_tiles;

  // Step s <- the [BK x W] column tile of its K step; during the first
  // column tile also the panel's [H x BK] box of that K step, in the same
  // commit group, so step kt waits for box kt and no later one.
  auto stage = [&](int s) {
    const int tt = s / k_tiles, k0 = (s - tt * k_tiles) * BK;
    if (tt == 0) {
      for (int v = tid; v < H * BK / 2; v += kSquareThreads) {
        const int r = v / (BK / 2), c = (v % (BK / 2)) * 2;
        cp_async16(panel + r * ldp + k0 + c, A + (row0 + r) * P + k0 + c);
      }
    }
    const int col0 = (blockIdx.x + tt * gridDim.x) * W;
    double* Bs = ring + (s % STAGES) * STAGE_D;
    for (int v = tid; v < BK * W / 2; v += kSquareThreads) {
      const int r = v / (W / 2), c = (v % (W / 2)) * 2;
      cp_async16(Bs + r * L::LDB + c, A + (long long)(k0 + r) * P + col0 + c);
    }
  };

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < steps) stage(s);
    cp_async_commit();
  }

  double acc[S::MI][S::NJ][4];
  zero_frags(acc);
  for (int s = 0; s < steps; ++s) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    if (s + STAGES - 1 < steps) stage(s + STAGES - 1);
    cp_async_commit();
    const int tt = s / k_tiles, kt = s - tt * k_tiles;
    const double* a = panel + wm * ldp + kt * BK;
    const double* b = ring + (s % STAGES) * STAGE_D + wn;
#pragma unroll
    for (int u = 0; u < BK / 8 / S::KS; ++u) {
      const int kk = (u * S::KS + q) * 8;
      warp_k8(acc, a + kk, ldp, b + kk * L::LDB, L::LDB, g, t);
    }
    if (kt == k_tiles - 1) {
      const int col0 = (blockIdx.x + tt * gridDim.x) * W;
      finish_tile<H, W>(acc, red, C + col0, P, q, wm, wn, g, t);
      zero_frags(acc);
    }
  }
  cp_async_wait<0>();
}

// ---------------------------------------------------------------------------
// Launchers and their tables
// ---------------------------------------------------------------------------

template <int TILE, int BK, int STAGES>
static int launch_matmul(const void* a, const void* b, void* c, int M, int N,
                         int K, long long sA, long long sB, long long sC,
                         int batch, cudaStream_t stream) {
  const size_t smem = DmmaRing<TILE, BK, STAGES>::BYTES;
  auto kernel = matmul_dmma_kernel<TILE, BK, STAGES>;
  if (int err = allow_smem(kernel, smem)) return err;
  dim3 grid(N / TILE, M / TILE, batch);
  kernel<<<grid, DmmaWarps<TILE>::THREADS, smem, stream>>>(
      static_cast<const double*>(a), static_cast<const double*>(b),
      static_cast<double*>(c), M, N, K, sA, sB, sC);
  return static_cast<int>(cudaGetLastError());
}

template <int TILE>
static int launch_square_whole(const void* a, void* c, int P, long long sA,
                               long long sC, int batch, int groups,
                               cudaStream_t stream) {
  const size_t smem = DmmaWhole::bytes(P);
  auto kernel = square_whole_dmma_kernel<TILE>;
  if (int err = allow_smem(kernel, smem)) return err;
  kernel<<<dim3(groups, 1, batch), kSquareThreads, smem, stream>>>(
      static_cast<const double*>(a), static_cast<double*>(c), P, sA, sC);
  return static_cast<int>(cudaGetLastError());
}

template <int H, int W, int BK, int STAGES>
static int launch_square_panel(const void* a, void* c, int P, long long sA,
                               long long sC, int batch, int groups,
                               cudaStream_t stream) {
  const size_t smem = DmmaPanel<H, W, BK, STAGES>::bytes(P);
  auto kernel = square_panel_dmma_kernel<H, W, BK, STAGES>;
  if (int err = allow_smem(kernel, smem)) return err;
  kernel<<<dim3(groups, P / H, batch), kSquareThreads, smem, stream>>>(
      static_cast<const double*>(a), static_cast<double*>(c), P, sA, sC);
  return static_cast<int>(cudaGetLastError());
}

// K1's instantiated (tile, K step) pairs and each one's ring stages;
// kernels/matmul.py:DMMA_BLOCKS / DMMA_STAGES is the same table. The output
// is fp64 whatever `out_acc` says (fp64 is its own accumulation type).
static int matmul_dispatch(const void* a, const void* b, void* c, int M,
                           int N, int K, int tile, int bk, long long sA,
                           long long sB, long long sC, int batch,
                           void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define REPRO_DMMA_TILE(TILE_, BK_, STAGES_)                                \
  if (tile == TILE_ && bk == BK_)                                          \
    return launch_matmul<TILE_, BK_, STAGES_>(a, b, c, M, N, K, sA, sB,    \
                                              sC, batch, st);
  REPRO_DMMA_TILE(32, 16, 4)
  REPRO_DMMA_TILE(64, 16, 4)
  REPRO_DMMA_TILE(64, 32, 2)
#undef REPRO_DMMA_TILE
  return -1;
}

// K2's instantiated square output tiles; kernels/matmul.py:WHOLE_DMMA_TILES
// is the same table.
static int square_whole_dispatch(const void* a, void* c, int P, int tile,
                                 long long sA, long long sC, int batch,
                                 int groups, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define REPRO_WHOLE_DMMA(TILE_)                                             \
  if (tile == TILE_)                                                       \
    return launch_square_whole<TILE_>(a, c, P, sA, sC, batch, groups, st);
  REPRO_WHOLE_DMMA(16)
  REPRO_WHOLE_DMMA(32)
  REPRO_WHOLE_DMMA(64)
#undef REPRO_WHOLE_DMMA
  return -1;
}

// K3's instantiated (panel height, column width, K step) rings and the
// stages of each; kernels/matmul.py:DMMA_PANEL_RINGS is the same table. P is
// a multiple of the K step.
static int square_panel_dispatch(const void* a, void* c, int P, int tile,
                                 int width, int bk, long long sA,
                                 long long sC, int batch, int groups,
                                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define REPRO_DMMA_PANEL(H_, W_, BK_, STAGES_)                              \
  if (tile == H_ && width == W_ && bk == BK_)                              \
    return launch_square_panel<H_, W_, BK_, STAGES_>(a, c, P, sA, sC,      \
                                                     batch, groups, st);
  REPRO_DMMA_PANEL(16, 32, 64, 3)
  REPRO_DMMA_PANEL(16, 32, 32, 4)
  REPRO_DMMA_PANEL(32, 32, 64, 2)
  REPRO_DMMA_PANEL(32, 32, 32, 3)
  REPRO_DMMA_PANEL(64, 64, 16, 3)
#undef REPRO_DMMA_PANEL
  return -1;
}

}  // namespace dmma
}  // namespace repro

// The fp64 translation unit expands this once: repro_matmul_f64,
// repro_square_whole_f64 and repro_square_panel_f64 on the kernels above,
// with the signatures of gemm.cuh's REPRO_DEFINE_C_API. A squaring's `tile`
// and `width` are the panel height and column width of K3's output tiles,
// or K2's square tile; `bk` is the K step of K3's ring. The output is fp64
// whatever `out_acc` says.
#define REPRO_DEFINE_DMMA_API(SUFFIX)                                         \
  extern "C" int repro_matmul_##SUFFIX(                                       \
      const void* a, const void* b, void* c, int M, int N, int K, int tile,  \
      int bk, long long sA, long long sB, long long sC, int batch,           \
      int out_acc, void* stream) {                                            \
    (void)out_acc;                                                            \
    return repro::dmma::matmul_dispatch(a, b, c, M, N, K, tile, bk, sA, sB,  \
                                        sC, batch, stream);                   \
  }                                                                           \
  extern "C" int repro_square_whole_##SUFFIX(                                 \
      const void* a, void* c, int P, int tile, long long sA, long long sC,   \
      int batch, int groups, int out_acc, void* stream) {                     \
    (void)out_acc;                                                            \
    return repro::dmma::square_whole_dispatch(a, c, P, tile, sA, sC, batch,  \
                                              groups, stream);                \
  }                                                                           \
  extern "C" int repro_square_panel_##SUFFIX(                                 \
      const void* a, void* c, int P, int tile, int width, int bk,            \
      long long sA, long long sC, int batch, int groups, int out_acc,        \
      void* stream) {                                                         \
    (void)out_acc;                                                            \
    return repro::dmma::square_panel_dispatch(a, c, P, tile, width, bk, sA,  \
                                              sC, batch, groups, stream);     \
  }
