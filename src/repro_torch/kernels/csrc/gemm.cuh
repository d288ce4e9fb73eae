// Hand-written Hopper kernels for the matrix-power chain on the FMA pipeline.
//
// Three kernels for f32 operands, each a block whose threads own a register
// micro-tile of the output, accumulated in fp32 with exact IEEE FMAs and
// stored once:
//
//   matmul_kernel        C = A @ B in f32. Replaces the reference's
//   matmul_wide_kernel   `matmul_kernel` (src/repro/kernels/matmul.py,
//                        launched by `matmul_pallas`): the wide kernel at
//                        tile 128, matmul_kernel at tiles 64 and 32. The
//                        reference walks K as a sequential grid axis and
//                        carries the accumulator in scratch between grid
//                        steps; blocks on this card run in any order and
//                        share nothing, so the K loop sits inside the block
//                        and the accumulator never leaves registers.
//   square_whole_kernel  C = A @ A from one staged copy of the rows and
//                        columns of A a block's tiles read, f32. Replaces
//                        `square_kernel` (tier "whole" of `square_pallas`).
//                        They are copied into the block's dynamic shared
//                        memory once, as a row strip and a column strip, and
//                        every output tile the block computes reads both of
//                        its panels from that copy.
//   square_panel_kernel  C = A @ A from an (H, P) row panel held in shared
//                        memory, f32. Replaces `square_panel_kernel`
//                        (tier "panel"). The reference relies on a sequential
//                        inner grid axis to stage the row panel once per row
//                        of output tiles; here the loop over the block's
//                        column tiles is inside the block, and the column
//                        tiles stream through a ring (they are re-read by
//                        every row panel, which the L2 cache absorbs for
//                        operands of this tier).
//
// For 16-bit inputs all three are the tensor-core kernels of gemm_tc.cuh,
// for fp64 the fp64 tensor-core kernels of gemm_dmma.cuh.
//
// What bounds them: operations, at every size the chain uses (a 4096^3
// product is 137 GFLOP over 201 MB: 2.05 ms at the 67 TFLOP/s fp32 FMA rate
// of an H100 SXM, 0.06 ms for the bytes). fp32 stays on the FMA pipeline --
// no TF32, which is what keeps a 7-multiply fp32 chain inside its error
// budget -- so the design spends its effort on keeping that pipeline fed:
//
//   * An asynchronous ring (K1, K3). Operand tiles arrive by 16-byte
//     `cp.async.cg` into STAGES shared-memory stages, one commit group per K
//     step; the copy of step k + STAGES - 1 is in flight while step k
//     computes, and one barrier per step hands a stage over. The K step and
//     the stage count are compile-time (the REPRO_F32_TILE lines below; K3's
//     kPanelBK / kPanelStages), so the inner loop unrolls whole (the wide
//     K1's in sub-steps of kWideSubK k: see its note).
//   * A in its storage layout (K1 below tile 128, K3). K1's A tile is
//     [TILE][BK + kPad] and K3's row panel [H][P + kPad], row-major as in
//     memory, so the copy needs no transpose and can be asynchronous. A
//     thread reads each of its rows kStepK = 4 k at a time, one 16-byte
//     `ld.shared` per row, and each k's B row once per column chunk of 4.
//   * Thread tiles sized for the shared-memory pipe. The rates measured on
//     the card (PERF.md) fit a 16-byte `ld.shared` costing the SM four of
//     its 128-byte wavefronts whatever the lanes share, and the SM issuing
//     four warp FMAs a clock: per k a thread tile of R x C outputs reads
//     R + C values, (R + C) / 4 such words, R + C wavefronts a warp, for
//     R C FMAs, R C / 4 clocks of the SM, so at the full FMA rate the
//     shared pipe is 4 (R + C) / (R C) loaded. 8 x 8 sits at the balance
//     (16 wavefronts per 16 clocks, 100 %), with no headroom for latency,
//     barriers or copies, and ran K1 at 58 % of the FMA peak; 4 x 4 got
//     half the FMA rate, 2 x 2 a quarter. (The balance is not all that sets
//     the rate: the instruction cache did too, the wide K1's note says.)
//     K1 takes 16 x 8 at tile 128 (the wide kernel, 128 threads: 6 words
//     per 128 FMAs, 75 %) and the wider 4 x 8 and 2 x 4 at tiles 64 and 32
//     (128 threads; MatmulLayout). K3's 256 threads in f32 are K slices of
//     4 x 8 thread tiles, each over the whole output tile and a share of
//     every K step, their sums added through shared memory at the end of a
//     tile (PanelLayout): a 32 x 64 tile is four slices of 64 threads,
//     where one 2 x 4 tiling of all 256 threads read 6 words per 32 FMAs.
//   * Warp tiles (FmaLayout). A warp's 32 lanes are 4 rows by 8 columns of
//     threads and own one contiguous (4 R) x (8 C) block of the output:
//     thread rows ly + 4 i, columns 8 V c + V lx. Bank arithmetic (4-byte
//     banks, 32 of them; a 16-byte load covers four): a B load is 8 distinct
//     16-byte addresses, 128 contiguous bytes -- one wavefront's worth, any
//     row pitch. An A load is 4 distinct addresses, rows r .. r + 3 at the
//     same k, at word offsets LDA * ly mod 32: with LDA = BK + 4 (36 or 20)
//     or P + 4 (P a multiple of 32) those are {0, 4, 8, 12} or
//     {0, 20, 8, 28} -- four disjoint groups of four banks. Without the pad
//     every row would start on bank 0 and the four rows would conflict. B
//     needs no pad.
//   * K2 (f32) is bound by latency and its grid, not by either rate (a
//     192^2 squaring is 14 MFLOP, 0.2 us at 67 TFLOP/s): each block copies
//     only the tile rows and tile columns of A its tiles read, into two
//     compact strips padded like K3's panel, with one wait, so five
//     16-wide one-tile blocks share an SM; K slices of 4 x 8 or 8 x 8
//     thread tiles (WholeFma) share each tile's K loop. Its grid is its own
//     (kernels/matmul.py:square_whole_grid, a model of the card's rates).
//   * K3's grid is its own (kernels/matmul.py:square_panel_grid): a panel of
//     32 or 64 rows and `groups` blocks per panel sharing its column tiles,
//     chosen for the least output on the busiest SM, where the chain's
//     square tile gave 64 blocks at 512^2. The row panel arrives as P /
//     kPanelBK boxes, each in the commit group of the first column tile's K
//     step that reads it, so the math on box 0 starts while the rest lands.
//
// Every batched form (a leading stack dimension) is the same kernel with the
// stack on gridDim.z and a per-operand stride (0 broadcasts a 2-D operand):
// one launch for the whole stack.
//
// Plain C interface (see REPRO_DEFINE_C_API): no framework header is
// included, pointers and the stream arrive as void*, every function returns
// the launch's cudaError_t (0 on success, -1 for a tile this file does not
// instantiate). Shapes must be tile-divisible and rows 16-byte aligned; the
// Python wrappers check both.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace repro {

constexpr int kThreads = 256;     // threads of K3
constexpr int kPad = 4;           // row padding of K1's A tiles, K3's panel
constexpr int kWideTile = 128;    // K1's output tile on the wide kernel
constexpr int kWideThreads = 128; // its threads: four warps of 64 x 64
constexpr int kWideSubK = 8;      // k a trip of its unrolled FMA loop
constexpr int kStepK = 4;         // k values read per 16-byte row load of A
constexpr int kPanelBK = 32;      // K step of K3's column-tile ring
constexpr int kPanelStages = 3;   // stages of K3's column-tile ring

// ---------------------------------------------------------------------------
// Element types: accumulation type and conversions
// ---------------------------------------------------------------------------

template <typename T> struct Num;

template <> struct Num<float> {
  using Acc = float;
  static __device__ __forceinline__ float to_acc(float v) { return v; }
  static __device__ __forceinline__ float from_acc(float v) { return v; }
};

template <> struct Num<double> {
  using Acc = double;
  static __device__ __forceinline__ double to_acc(double v) { return v; }
  static __device__ __forceinline__ double from_acc(double v) { return v; }
};

template <> struct Num<__half> {
  using Acc = float;
  static __device__ __forceinline__ float to_acc(__half v) {
    return __half2float(v);
  }
  static __device__ __forceinline__ __half from_acc(float v) {
    return __float2half_rn(v);
  }
};

template <> struct Num<__nv_bfloat16> {
  using Acc = float;
  static __device__ __forceinline__ float to_acc(__nv_bfloat16 v) {
    return __bfloat162float(v);
  }
  static __device__ __forceinline__ __nv_bfloat16 from_acc(float v) {
    return __float2bfloat16_rn(v);
  }
};

// N elements moved as one aligned unit (at most 16 bytes).
template <typename T, int N> struct alignas(sizeof(T) * N) Pack {
  T v[N];
};

// Elements per 16-byte (or smaller, when V elements are fewer) access.
template <typename T, int V> struct Chunk {
  static constexpr int value =
      (sizeof(T) * V > 16) ? static_cast<int>(16 / sizeof(T)) : V;
};

// Load V consecutive elements and widen them to the accumulation type.
template <typename T, int V>
__device__ __forceinline__ void load_cvt(const T* p,
                                         typename Num<T>::Acc* d) {
  constexpr int C = Chunk<T, V>::value;
#pragma unroll
  for (int c = 0; c < V; c += C) {
    Pack<T, C> pk = *reinterpret_cast<const Pack<T, C>*>(p + c);
#pragma unroll
    for (int e = 0; e < C; ++e) d[c + e] = Num<T>::to_acc(pk.v[e]);
  }
}

// Narrow V accumulator values to TOut and store them consecutively.
template <typename TOut, typename Acc, int V>
__device__ __forceinline__ void store_cvt(TOut* p, const Acc* s) {
  constexpr int C = Chunk<TOut, V>::value;
#pragma unroll
  for (int c = 0; c < V; c += C) {
    Pack<TOut, C> pk;
#pragma unroll
    for (int e = 0; e < C; ++e) pk.v[e] = Num<TOut>::from_acc(s[c + e]);
    *reinterpret_cast<Pack<TOut, C>*>(p + c) = pk;
  }
}

template <typename Acc, int TM, int TN = TM>
__device__ __forceinline__ void zero_acc(Acc (&acc)[TM][TN]) {
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = Acc(0);
}

// ---------------------------------------------------------------------------
// Asynchronous copies (also used by gemm_tc.cuh and gemm_dmma.cuh)
// ---------------------------------------------------------------------------

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ---------------------------------------------------------------------------
// K1 / K3: the ring, the warp tiles and one K step of FMAs
// ---------------------------------------------------------------------------

// The dynamic shared memory of each launcher. kernels/matmul.py computes the
// same (fma_smem_bytes, fma_panel_smem_bytes), and a CPU test evaluates the
// formulas of FmaRing and FmaPanel as written here against it.

// K1 (f32) below tile 128: STAGES stages, each the [TILE][BK + kPad] A
// tile and the [BK][TILE] B tile of one K step.
template <int TILE, int BK, int STAGES> struct FmaRing {
  static constexpr int LDA = BK + kPad;
  static constexpr int STAGE = (TILE * LDA + BK * TILE) * 4;
  static constexpr int BYTES = STAGES * STAGE;
};

// K1 (f32) at tile 128, the wide kernel: two k-major A buffers
// [BK][kWideTile + kPad] and STAGES stages of the [BK][kWideTile] B tile.
template <int BK, int STAGES> struct WideRing {
  static constexpr int LDA = kWideTile + kPad;
  static constexpr int A_STAGE = BK * LDA * 4;
  static constexpr int B_STAGE = BK * kWideTile * 4;
  static constexpr int BYTES = 2 * A_STAGE + STAGES * B_STAGE;
};

// K3: the [H][P + kPad] row panel, kPanelStages stages of [kPanelBK][W]
// column tiles, and the partial sums of the K slices past the first
// (PanelLayout).
template <int H, int W> struct FmaPanel {
  static constexpr int KS = kThreads / (2 * H);
  static constexpr int STAGE = kPanelBK * W * 4;
  static constexpr int SCRATCH = (KS - 1) * H * W * 4;
  static size_t bytes(int P) {
    return (size_t)H * (P + kPad) * 4 + kPanelStages * STAGE + SCRATCH;
  }
};

// K2: a TILE x TILE output tile in KS K slices of R x C thread tiles (the
// REPRO_WHOLE_F32 lines). A slice is LY x LX threads, thread (ly, lx)
// owning rows ly + LY i (i < R) and columns 4 lx + 4 LX c + e (c < C / 4,
// e < 4): a warp's B load is 8 (LX >= 8) or LX distinct 16-byte addresses
// in a row, its A loads rows at one k (pitch P + kPad puts four rows on
// disjoint banks). The dynamic shared memory is the block's row strip
// [NR * TILE][P + kPad] (the rows of A its tiles read as the left
// operand), its column strip [P][NC * TILE + kPad] (the columns they read
// as the right one) and the [KS][TILE][TILE] partial sums of every slice;
// NR and NC are the most tile rows and tile columns a block of the grid
// has (whole_strips).
template <int TILE, int R, int C, int KS> struct WholeFma {
  static constexpr int LY = TILE / R;
  static constexpr int LX = TILE / C;
  static constexpr int SLICE = LY * LX;
  static constexpr int THREADS = KS * SLICE;
  static constexpr int RED = KS * TILE * TILE * 4;
  static size_t bytes(int P, int NR, int NC) {
    return ((size_t)NR * TILE * (P + kPad) + (size_t)P * (NC * TILE + kPad)) *
               4 + RED;
  }
};

// The most tile rows (nr) and tile columns (nc) one block of a K2 grid of
// `groups` blocks a matrix owns: block b takes tiles b, b + groups, ...
// of the per_row^2 tiles (kernels/matmul.py:whole_strips is the same).
inline void whole_strips(int per_row, int groups, int* nr, int* nc) {
  const int n = per_row * per_row;
  *nr = *nc = 0;
  for (int b = 0; b < groups && b < n; ++b) {
    unsigned rows = 0, cols = 0;
    for (int t = b; t < n; t += groups) {
      rows |= 1u << (t / per_row);
      cols |= 1u << (t % per_row);
    }
    *nr = __builtin_popcount(rows) > *nr ? __builtin_popcount(rows) : *nr;
    *nc = __builtin_popcount(cols) > *nc ? __builtin_popcount(cols) : *nc;
  }
}

// Threads of a (4 R WM) x (8 C WN) output tile, R x C outputs each: WM x WN
// warps, a warp's lanes 4 rows (ly) by 8 columns (lx). Thread t's outputs
// are rows row(t) + 4 i (i < R) and columns col(t) + 8 V c + e, V = min(C,
// 4), c < C / V, e < V; a warp owns one contiguous (4 R) x (8 C) block.
template <int R_, int C_, int WM, int WN> struct FmaLayout {
  static constexpr int R = R_, C = C_;
  static constexpr int THREADS = 32 * WM * WN;
  static constexpr int ROWS = 4 * R * WM, COLS = 8 * C * WN;
  static __device__ __forceinline__ int row(int t) {
    return (t >> 5) / WN * 4 * R + ((t >> 3) & 3);
  }
  static __device__ __forceinline__ int col(int t) {
    return (t >> 5) % WN * 8 * C + (t & 7) * (C < 4 ? C : 4);
  }
};

// matmul_kernel's threads per tile: at tiles 64 and 32 the wider 4 x 8 and
// 2 x 4 thread tiles of 128 threads, whose shared loads per FMA are a third
// fewer than 4 x 4's and 2 x 2's. (Tile 128 is the wide kernel's.)
template <int TILE> struct MatmulLayout;
template <> struct MatmulLayout<64> { using L = FmaLayout<4, 8, 4, 1>; };
template <> struct MatmulLayout<32> { using L = FmaLayout<2, 4, 4, 1>; };

// K3: the block's 256 threads are KS = 128 / H slices of 2 H threads. Each
// slice is a 4 x (W / 8) thread tiling of the whole H x W output tile over a
// 1 / KS share of every K step; at the end of a tile the slices past the
// first add their sums into the first's through shared memory. Its
// registers let two blocks share an SM.
template <int H, int W> struct PanelLayout {
  static constexpr int R = 4, C = W / 8, SLICE = 2 * H;
  static constexpr int KS = kThreads / SLICE;
  using L = FmaLayout<R, C, H / 16, 1>;
};

// acc += A[rows, k0 : k0 + BK] @ B[k0 : k0 + BK, cols] for the thread's
// outputs: `a` is its first row at k0 (its rows lie 4 * lda apart), `b` its
// first column of B's row k0 (B's rows lie ldb apart; its column chunks of V
// lie 8 V apart).
template <typename T, int R, int C, int BK>
__device__ __forceinline__ void fma_step(T (&acc)[R][C], const T* a, int lda,
                                         const T* b, int ldb) {
  constexpr int V = C < 4 ? C : 4;
#pragma unroll
  for (int kk = 0; kk < BK; kk += kStepK) {
    T a4[R][kStepK];
#pragma unroll
    for (int i = 0; i < R; ++i)
      load_cvt<T, kStepK>(a + 4 * i * lda + kk, a4[i]);
#pragma unroll
    for (int s = 0; s < kStepK; ++s) {
      T bv[C];
#pragma unroll
      for (int c = 0; c < C / V; ++c)
        load_cvt<T, V>(b + (kk + s) * ldb + c * 8 * V, bv + c * V);
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < C; ++j) acc[i][j] = fma(a4[i][s], bv[j], acc[i][j]);
    }
  }
}

// Store the thread's outputs; `c` is its first one (row stride ldc).
template <typename T, int R, int C>
__device__ __forceinline__ void fma_store(T* c, long long ldc,
                                          const T (&acc)[R][C]) {
  constexpr int V = C < 4 ? C : 4;
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int k = 0; k < C / V; ++k)
      store_cvt<T, T, V>(c + 4 * i * ldc + k * 8 * V, &acc[i][k * V]);
}

// ---------------------------------------------------------------------------
// K1: C[M,N] = A[M,K] @ B[K,N], f32
// ---------------------------------------------------------------------------

template <typename T, int TILE, int BK, int STAGES>
__global__ void __launch_bounds__(MatmulLayout<TILE>::L::THREADS, 2)
matmul_kernel(const T* __restrict__ A, const T* __restrict__ B,
              T* __restrict__ C, int M, int N, int K, long long sA,
              long long sB, long long sC) {
  static_assert(sizeof(T) == 4, "the FMA K1 is the f32 kernel");
  using Ring = FmaRing<TILE, BK, STAGES>;
  using L = typename MatmulLayout<TILE>::L;
  constexpr int R = L::R, CN = L::C, THREADS = L::THREADS;
  static_assert(L::ROWS == TILE && L::COLS == TILE, "K1's output tile");
  constexpr int LDA = Ring::LDA;
  constexpr int STAGE = Ring::STAGE / 4;   // elements per ring stage
  constexpr int VEC = 4;                   // floats per cp.async

  extern __shared__ __align__(16) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);

  const int tid = threadIdx.x;
  const long long row0 = (long long)blockIdx.y * TILE;
  const long long col0 = (long long)blockIdx.x * TILE;
  A += blockIdx.z * sA + row0 * K;
  B += blockIdx.z * sB + col0;
  C += blockIdx.z * sC + row0 * N + col0;

  // Stage s <- A's [TILE x BK] and B's [BK x TILE] tiles of K step k0.
  auto stage = [&](int s, int k0) {
    T* As = ring + s * STAGE;
    T* Bs = As + TILE * LDA;
    for (int v = tid; v < TILE * BK / VEC; v += THREADS) {
      const int r = v / (BK / VEC), c = (v % (BK / VEC)) * VEC;
      cp_async16(As + r * LDA + c, A + (long long)r * K + k0 + c);
    }
    for (int v = tid; v < BK * TILE / VEC; v += THREADS) {
      const int r = v / (TILE / VEC), c = (v % (TILE / VEC)) * VEC;
      cp_async16(Bs + r * TILE + c, B + (long long)(k0 + r) * N + c);
    }
  };

  const int k_tiles = K / BK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < k_tiles) stage(s, s * BK);
    cp_async_commit();
  }

  T acc[R][CN];
  zero_acc<T, R, CN>(acc);
  const int tr = L::row(tid), tc = L::col(tid);
  for (int kt = 0; kt < k_tiles; ++kt) {
    // Step kt has landed for this thread; the barrier makes it everyone's
    // and tells every thread that the stage read at kt - 1 is free again.
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    const int next = kt + STAGES - 1;
    if (next < k_tiles) stage(next % STAGES, next * BK);
    cp_async_commit();
    const T* As = ring + (kt % STAGES) * STAGE;
    fma_step<T, R, CN, BK>(acc, As + tr * LDA, LDA, As + TILE * LDA + tc,
                           TILE);
  }
  cp_async_wait<0>();
  fma_store<T, R, CN>(C + (long long)tr * N + tc, N, acc);
}

// ---------------------------------------------------------------------------
// K1 at tile 128, the wide kernel: C[M,N] = A[M,K] @ B[K,N], f32
// ---------------------------------------------------------------------------

// A 128 x 128 output tile in kWideThreads = 128 threads: warp w owns the
// 64 x 64 block at rows 64 (w / 2), columns 64 (w % 2); lane (ly, lx) =
// (lane / 8, lane % 8) of it owns 16 x 8 outputs, rows 16 i + 4 ly + e and
// columns 32 c + 4 lx + e (i < 4, c < 2, e < 4). Per k a thread reads its
// 16 values of A and 8 of B as six 16-byte fragments for 128 FMAs: a
// quarter fewer wavefronts per FMA than 8 x 8, which leaves the shared
// pipe 75 % loaded at the full FMA rate.
//
//   * A staged k-major, [BK][LDA] with LDA = 128 + kPad, so one k's 16
//     values of A are four 16-byte words, as B's 8 are two, and a thread
//     holds only the fragments of the k it computes (a row-major A tile
//     would keep 4 k of each of 16 rows live: 64 registers). cp.async
//     cannot transpose, so A goes through registers, into the other of two
//     A buffers (the one the FMAs of K step kt - 1 read; the next step's
//     barrier hands it over): during K step kt a thread's BK / 4 16-byte
//     global loads of step kt + 1 go out in parts, one part a sub-step, and
//     each part is stored as 4-byte values at the start of the next
//     sub-step (or after the last), so only a part's registers are live
//     (8 at BK 32). BK stores a K step against 24 BK wavefronts of fragment
//     loads: about 4 % more.
//   * B through the cp.async ring of matmul_kernel, STAGES stages.
//   * The K step in sub-steps of kWideSubK k: a loop that is not unrolled,
//     each trip unrolled whole. A whole K step unrolled is 128 BK FMAs, 64
//     KB of code at BK 32, past what the SM's instruction cache holds:
//     fully unrolled this kernel ran at the 8 x 8 kernel's 55-59 % of the
//     FMA peak with its fragment loads left out as with them (PERF.md).
//   * Fragments a k ahead: the loads of k + 1 go out before the 128 FMAs of
//     k (two register sets of 24), across sub-steps too, so shared-memory
//     latency hides behind the thread's own FMAs even where a block's four
//     warps are alone on their SM.
//   * Bank arithmetic (4-byte banks, 32 of them). A fragment load is, over
//     a warp, 4 (A) or 8 (B) distinct 16-byte addresses at one k, 64 or 128
//     contiguous bytes: no conflict at any pitch. In the transposing store
//     the lanes of a warp hold 16 consecutive rows (lane % 16) at two k
//     four apart (4 (lane / 16)): word (4 (lane / 16) + e) LDA + lane % 16,
//     and 4 LDA = 528 = 16 mod 32, so the 32 lanes hit 32 distinct banks
//     (without the pad, 4 LDA = 0 mod 32: two-way conflicts). Their global
//     loads read 32 contiguous bytes of each of 16 rows, whole sectors.
//
// Registers (`nvcc -Xptxas -v`, PERF.md): 207 at BK 32, 201 at BK 16, none
// spilled, so two blocks share an SM; an earlier 8 x 16 trial with A
// row-major and the K step unrolled whole took 255.
//
// Each output is one fp32 accumulator updated by fma over k in ascending
// order, as in matmul_kernel: the two kernels give the same bits.
template <typename T, int BK, int STAGES>
__global__ void __launch_bounds__(kWideThreads, 2)
matmul_wide_kernel(const T* __restrict__ A, const T* __restrict__ B,
                   T* __restrict__ C, int M, int N, int K, long long sA,
                   long long sB, long long sC) {
  static_assert(sizeof(T) == 4, "the FMA K1 is the f32 kernel");
  using Ring = WideRing<BK, STAGES>;
  constexpr int TILE = kWideTile, THREADS = kWideThreads;
  constexpr int LDA = Ring::LDA;
  constexpr int A_STAGE = Ring::A_STAGE / 4;   // elements per A buffer
  constexpr int B_STAGE = Ring::B_STAGE / 4;   // elements per B stage
  constexpr int R = 16, CN = 8;                // a thread's outputs
  constexpr int SUB = BK / kWideSubK;          // sub-steps a K step
  constexpr int AV = TILE * BK / 4 / THREADS;  // A's 16-byte loads a step
  constexpr int PART = AV / SUB;               // of them a sub-step
  static_assert(THREADS == 128 && BK % kWideSubK == 0 && PART >= 1 &&
                    AV % SUB == 0 && AV % 2 == 0,
                "the wide kernel's copies");

  extern __shared__ __align__(16) unsigned char smem[];
  T* As = reinterpret_cast<T*>(smem);   // [2][BK][LDA]
  T* Bs = As + 2 * A_STAGE;             // [STAGES][BK][TILE]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long long row0 = (long long)blockIdx.y * TILE;
  const long long col0 = (long long)blockIdx.x * TILE;
  A += blockIdx.z * sA + row0 * K;
  B += blockIdx.z * sB + col0;
  C += blockIdx.z * sC + row0 * N + col0;

  // Stage s <- B's [BK x TILE] tile of K step k0.
  auto stage_b = [&](int s, int k0) {
    T* Bt = Bs + s * B_STAGE;
    for (int v = tid; v < BK * TILE / 4; v += THREADS) {
      const int r = v / (TILE / 4), c = (v % (TILE / 4)) * 4;
      cp_async16(Bt + r * TILE + c, B + (long long)(k0 + r) * N + c);
    }
  };

  // A's load j of a thread: row 16 warp + lane % 16 + 64 (j % 2), k
  // 4 (lane / 16) + 8 (j / 2) .. + 3 of the K step; part p is loads
  // p PART .. p PART + PART - 1.
  Pack<T, 4> a_in[PART];
  const T* a_src = A + (long long)(16 * warp + (lane & 15)) * K +
                   4 * (lane >> 4);
  T* a_dst = As + 4 * (lane >> 4) * LDA + 16 * warp + (lane & 15);
  auto load_a = [&](int k0, int p) {
#pragma unroll
    for (int t = 0; t < PART; ++t) {
      const int j = p * PART + t;
      a_in[t] = *reinterpret_cast<const Pack<T, 4>*>(
          a_src + (long long)(64 * (j & 1)) * K + k0 + 8 * (j >> 1));
    }
  };
  auto store_a = [&](int buf, int p) {
#pragma unroll
    for (int t = 0; t < PART; ++t) {
      const int j = p * PART + t;
#pragma unroll
      for (int e = 0; e < 4; ++e)
        a_dst[buf * A_STAGE + (8 * (j >> 1) + e) * LDA + 64 * (j & 1)] =
            a_in[t].v[e];
    }
  };

  const int k_tiles = K / BK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < k_tiles) stage_b(s, s * BK);
    cp_async_commit();
  }
#pragma unroll 1
  for (int p = 0; p < SUB; ++p) {
    load_a(0, p);
    store_a(0, p);
  }

  T acc[R][CN];
  zero_acc<T, R, CN>(acc);
  const int ly = lane >> 3, lx = lane & 7;
  const int tr = 64 * (warp >> 1) + 4 * ly, tc = 64 * (warp & 1) + 4 * lx;
  for (int kt = 0; kt < k_tiles; ++kt) {
    // B's step kt has landed for this thread and A's buffer kt % 2 holds
    // step kt; the barrier makes both everyone's and tells every thread
    // that what step kt - 1 read is free again.
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    const int next = kt + STAGES - 1;
    if (next < k_tiles) stage_b(next % STAGES, next * BK);
    cp_async_commit();
    const bool more = kt + 1 < k_tiles;
    const int a_next = (kt + 1) & 1;

    const T* a = As + (kt & 1) * A_STAGE + tr;
    const T* b = Bs + (kt % STAGES) * B_STAGE + tc;
    T af[2][R], bf[2][CN];
    auto fragments = [&](int k, T(&ar)[R], T(&br)[CN]) {
#pragma unroll
      for (int i = 0; i < R / 4; ++i)
        load_cvt<T, 4>(a + k * LDA + 16 * i, ar + 4 * i);
#pragma unroll
      for (int c = 0; c < CN / 4; ++c)
        load_cvt<T, 4>(b + k * TILE + 32 * c, br + 4 * c);
    };
    fragments(0, af[0], bf[0]);
#pragma unroll 1
    for (int sub = 0; sub < SUB; ++sub) {
      if (more) {
        if (sub > 0) store_a(a_next, sub - 1);
        load_a((kt + 1) * BK, sub);
      }
      const int k0 = sub * kWideSubK;
      // the k whose fragments the sub-step's last k loads ahead: the next
      // sub-step's first, or again the K step's last after the last
      const int k_on = sub + 1 < SUB ? k0 + kWideSubK : BK - 1;
#pragma unroll
      for (int k = 0; k < kWideSubK; ++k) {
        fragments(k + 1 < kWideSubK ? k0 + k + 1 : k_on, af[(k + 1) & 1],
                  bf[(k + 1) & 1]);
#pragma unroll
        for (int i = 0; i < R; ++i)
#pragma unroll
          for (int j = 0; j < CN; ++j)
            acc[i][j] = fma(af[k & 1][i], bf[k & 1][j], acc[i][j]);
      }
    }
    if (more) store_a(a_next, SUB - 1);
  }
  cp_async_wait<0>();
  T* c = C + (long long)tr * N + tc;
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int cc = 0; cc < CN / 4; ++cc)
      store_cvt<T, T, 4>(c + (long long)(16 * (i / 4) + i % 4) * N + 32 * cc,
                         &acc[i][4 * cc]);
}

// ---------------------------------------------------------------------------
// K2: C = A @ A, the boxes of A a block's tiles read staged once per block
// ---------------------------------------------------------------------------

// Block (x, 0, z) computes the output tiles x, x + gridDim.x, ... of matrix
// z. It copies the rows of A those tiles read (their tile rows, whole) into
// its row strip and the columns they read (their tile columns, every row)
// into its column strip, a tile row or column at the strip's next slot in
// index order, by 16-byte `cp.async`; waits once; and computes every tile
// from that copy. A tile's K loop is cut into KS K slices (WholeFma):
// slice q takes the k groups q, q + KS, ... of kStepK k each; at the end of
// the tile every slice writes its sums to shared memory and all threads add
// them in slice order, each a share of the tile, and store it. `nr` is the
// row strip's tile rows, `ldc` the column strip's pitch (NC * TILE + kPad).
template <int TILE, int R, int C, int KS>
__global__ void __launch_bounds__(WholeFma<TILE, R, C, KS>::THREADS)
square_whole_kernel(const float* __restrict__ A, float* __restrict__ Out,
                    int P, int nr, int ldc, long long sA, long long sC) {
  using W = WholeFma<TILE, R, C, KS>;
  constexpr int THREADS = W::THREADS, LY = W::LY, LX = W::LX;
  constexpr int T4 = TILE * TILE / 4;      // float4s of an output tile
  static_assert(C % 4 == 0 && W::SLICE % 8 == 0,
                "K2's thread tiles and slices");

  extern __shared__ __align__(16) unsigned char smem[];
  const int ldr = P + kPad;
  float* Rs = reinterpret_cast<float*>(smem);   // [nr * TILE][ldr]
  float* Cs = Rs + (size_t)nr * TILE * ldr;      // [P][ldc]
  float* red = Cs + (size_t)P * ldc;             // [KS][TILE][TILE]

  const int tid = threadIdx.x;
  const int q = tid / W::SLICE, st = tid % W::SLICE;
  const int ly = st / LX, lx = st % LX;
  A += blockIdx.z * sA;
  Out += blockIdx.z * sC;

  const int per_row = P / TILE, n_tiles = per_row * per_row;
  unsigned rows = 0, cols = 0;   // bit i: tile row / column i is the block's
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    rows |= 1u << (tile / per_row);
    cols |= 1u << (tile % per_row);
  }

  // Tile rows whole (TILE rows of P / 4 chunks each), then tile columns
  // (P rows of TILE / 4 chunks each); one commit group.
  const int cpr = P / 4;
  for (int tr = 0; tr < per_row; ++tr) {
    if (!(rows >> tr & 1)) continue;
    float* dst = Rs + __popc(rows & ((1u << tr) - 1)) * TILE * ldr;
    const float* src = A + (long long)tr * TILE * P;
    for (int v = tid; v < TILE * cpr; v += THREADS) {
      const int r = v / cpr, c = v % cpr * 4;
      cp_async16(dst + r * ldr + c, src + (long long)r * P + c);
    }
  }
  for (int tc = 0; tc < per_row; ++tc) {
    if (!(cols >> tc & 1)) continue;
    float* dst = Cs + __popc(cols & ((1u << tc) - 1)) * TILE;
    const float* src = A + tc * TILE;
    for (int v = tid; v < P * (TILE / 4); v += THREADS) {
      const int r = v / (TILE / 4), c = v % (TILE / 4) * 4;
      cp_async16(dst + r * ldc + c, src + (long long)r * P + c);
    }
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int tr = tile / per_row, tc = tile % per_row;
    float acc[R][C];
    zero_acc<float, R, C>(acc);
    // The thread's rows of A four k at a time (one 16-byte load per row),
    // each k's row of A across its columns.
    const float* a =
        Rs + (__popc(rows & ((1u << tr) - 1)) * TILE + ly) * ldr;
    const float* b = Cs + __popc(cols & ((1u << tc) - 1)) * TILE + 4 * lx;
    for (int k = kStepK * q; k < P; k += kStepK * KS) {
      float a4[R][kStepK];
#pragma unroll
      for (int i = 0; i < R; ++i)
        load_cvt<float, kStepK>(a + LY * i * ldr + k, a4[i]);
#pragma unroll
      for (int s = 0; s < kStepK; ++s) {
        float bv[C];
#pragma unroll
        for (int c = 0; c < C / 4; ++c)
          load_cvt<float, 4>(b + (k + s) * ldc + 4 * LX * c, bv + 4 * c);
#pragma unroll
        for (int i = 0; i < R; ++i)
#pragma unroll
          for (int j = 0; j < C; ++j)
            acc[i][j] = fmaf(a4[i][s], bv[j], acc[i][j]);
      }
    }
    float* part = red + q * TILE * TILE;
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int c = 0; c < C / 4; ++c)
        store_cvt<float, float, 4>(
            part + (ly + LY * i) * TILE + 4 * lx + 4 * LX * c, &acc[i][4 * c]);
    __syncthreads();
    for (int v = tid; v < T4; v += THREADS) {
      float sum[4];
      load_cvt<float, 4>(red + 4 * v, sum);
#pragma unroll
      for (int p = 1; p < KS; ++p) {
        float more[4];
        load_cvt<float, 4>(red + p * TILE * TILE + 4 * v, more);
#pragma unroll
        for (int e = 0; e < 4; ++e) sum[e] += more[e];
      }
      const int r = v / (TILE / 4), c = v % (TILE / 4) * 4;
      store_cvt<float, float, 4>(
          Out + (long long)(tr * TILE + r) * P + tc * TILE + c, sum);
    }
    __syncthreads();   // the partial sums are written again by the next tile
  }
}

// ---------------------------------------------------------------------------
// K3: C = A @ A, an (H, P) row panel staged once per block, f32
// ---------------------------------------------------------------------------

// Block (g, y, z) owns row panel y of matrix z and the column tiles g,
// g + groups, ...; its output tiles are H x W. Its work is one flat sequence
// of steps -- (column tile t, K step kt) -- through one ring, so the next
// tile's first steps are in flight while the last ones of a tile compute.
template <typename T, int H, int W>
__global__ void __launch_bounds__(kThreads, 2)
square_panel_kernel(const T* __restrict__ A, T* __restrict__ C, int P,
                    long long sA, long long sC) {
  static_assert(sizeof(T) == 4, "the FMA K3 is the f32 kernel");
  using PL = PanelLayout<H, W>;
  constexpr int R = PL::R, CW = PL::C, KS = PL::KS, SLICE = PL::SLICE;
  constexpr int BK = kPanelBK, STAGES = kPanelStages;
  constexpr int KB = BK / KS;               // k of a step in one slice
  constexpr int VEC = 16 / sizeof(T);      // elements per cp.async
  static_assert(KB % kStepK == 0, "a slice's share of a K step");
  static_assert(PL::L::ROWS == H && PL::L::COLS == W, "K3's output tile");

  extern __shared__ __align__(16) unsigned char smem[];
  const int ldp = P + kPad;
  T* panel = reinterpret_cast<T*>(smem);   // [H][ldp], resident
  T* ring = panel + (size_t)H * ldp;       // [STAGES][BK][W]
  T* partial = ring + STAGES * BK * W;     // [KS - 1][R * CW][SLICE]

  const int tid = threadIdx.x;
  const int q = tid / SLICE, st = tid % SLICE;   // K slice, thread in it
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
    const int t = s / k_tiles, k0 = (s - t * k_tiles) * BK;
    if (t == 0) {
      for (int v = tid; v < H * BK / VEC; v += kThreads) {
        const int r = v / (BK / VEC), c = (v % (BK / VEC)) * VEC;
        cp_async16(panel + r * ldp + k0 + c, A + (row0 + r) * P + k0 + c);
      }
    }
    const int col0 = (blockIdx.x + t * gridDim.x) * W;
    T* Bs = ring + (s % STAGES) * (BK * W);
    for (int v = tid; v < BK * W / VEC; v += kThreads) {
      const int r = v / (W / VEC), c = (v % (W / VEC)) * VEC;
      cp_async16(Bs + r * W + c, A + (long long)(k0 + r) * P + col0 + c);
    }
  };

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < steps) stage(s);
    cp_async_commit();
  }

  T acc[R][CW];
  zero_acc<T, R, CW>(acc);
  const int tr = PL::L::row(st), tc = PL::L::col(st);
  for (int s = 0; s < steps; ++s) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    if (s + STAGES - 1 < steps) stage(s + STAGES - 1);
    cp_async_commit();
    const int t = s / k_tiles, kt = s - t * k_tiles;
    fma_step<T, R, CW, KB>(acc, panel + tr * ldp + kt * BK + q * KB, ldp,
                           ring + (s % STAGES) * (BK * W) + q * KB * W + tc,
                           W);
    if (kt == k_tiles - 1) {
      // The tile's last step: slices 1.. hand their sums to slice 0, which
      // adds them in slice order and stores. The next step's barrier
      // orders slice 0's reads before the next tile's writes.
      if constexpr (KS > 1) {
        if (q > 0) {
#pragma unroll
          for (int i = 0; i < R; ++i)
#pragma unroll
            for (int j = 0; j < CW; ++j)
              partial[((q - 1) * R * CW + i * CW + j) * SLICE + st] =
                  acc[i][j];
        }
        __syncthreads();
        if (q == 0) {
#pragma unroll
          for (int p = 0; p < KS - 1; ++p)
#pragma unroll
            for (int i = 0; i < R; ++i)
#pragma unroll
              for (int j = 0; j < CW; ++j)
                acc[i][j] += partial[(p * R * CW + i * CW + j) * SLICE + st];
        }
      }
      if (q == 0) {
        const int col0 = (blockIdx.x + t * gridDim.x) * W;
        fma_store<T, R, CW>(C + (long long)tr * P + col0 + tc, P, acc);
      }
      zero_acc<T, R, CW>(acc);
    }
  }
  cp_async_wait<0>();
}

// ---------------------------------------------------------------------------
// Launchers
// ---------------------------------------------------------------------------

// Dynamic shared memory above 48 KB has to be opted into per kernel.
template <typename Kernel>
static int allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes)));
}

template <typename T, int TILE, int BK, int STAGES>
static int launch_matmul(const void* a, const void* b, void* c, int M, int N,
                         int K, long long sA, long long sB, long long sC,
                         int batch, cudaStream_t stream) {
  void (*kernel)(const T*, const T*, T*, int, int, int, long long, long long,
                 long long);
  size_t smem;
  int threads;
  if constexpr (TILE == kWideTile) {
    kernel = matmul_wide_kernel<T, BK, STAGES>;
    smem = WideRing<BK, STAGES>::BYTES;
    threads = kWideThreads;
  } else {
    kernel = matmul_kernel<T, TILE, BK, STAGES>;
    smem = FmaRing<TILE, BK, STAGES>::BYTES;
    threads = MatmulLayout<TILE>::L::THREADS;
  }
  if (int err = allow_smem(kernel, smem)) return err;
  dim3 grid(N / TILE, M / TILE, batch);
  kernel<<<grid, threads, smem, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b),
      static_cast<T*>(c), M, N, K, sA, sB, sC);
  return static_cast<int>(cudaGetLastError());
}

template <int TILE, int R, int C, int KS>
static int launch_square_whole(const void* a, void* c, int P, long long sA,
                               long long sC, int batch, int groups,
                               cudaStream_t stream) {
  using W = WholeFma<TILE, R, C, KS>;
  if (P / TILE > 32) return -1;   // a block's tile rows are one bit mask
  int nr, nc;
  whole_strips(P / TILE, groups, &nr, &nc);
  const size_t smem = W::bytes(P, nr, nc);
  auto kernel = square_whole_kernel<TILE, R, C, KS>;
  if (int err = allow_smem(kernel, smem)) return err;
  dim3 grid(groups, 1, batch);
  kernel<<<grid, W::THREADS, smem, stream>>>(
      static_cast<const float*>(a), static_cast<float*>(c), P, nr,
      nc * TILE + kPad, sA, sC);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int H, int W>
static int launch_square_panel(const void* a, void* c, int P, long long sA,
                               long long sC, int batch, int groups,
                               cudaStream_t stream) {
  const size_t smem = FmaPanel<H, W>::bytes(P);
  auto kernel = square_panel_kernel<T, H, W>;
  if (int err = allow_smem(kernel, smem)) return err;
  dim3 grid(groups, P / H, batch);
  kernel<<<grid, kThreads, smem, stream>>>(static_cast<const T*>(a),
                                           static_cast<T*>(c), P, sA, sC);
  return static_cast<int>(cudaGetLastError());
}

// K1's instantiated (tile, K step) pairs and the ring stages of each (of
// B's ring alone at tile 128, the wide kernel's); kernels/matmul.py:
// F32_STAGES is the same table. The output is f32 whatever
// `out_acc` says (f32 is its own accumulation type).
template <typename T>
static int matmul_dispatch(const void* a, const void* b, void* c, int M, int N,
                           int K, int tile, int bk, long long sA,
                           long long sB, long long sC, int batch,
                           void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define REPRO_F32_TILE(TILE_, BK_, STAGES_)                                 \
  if (tile == TILE_ && bk == BK_)                                          \
    return launch_matmul<T, TILE_, BK_, STAGES_>(a, b, c, M, N, K, sA, sB, \
                                                 sC, batch, st);
  REPRO_F32_TILE(32, 16, 4)
  REPRO_F32_TILE(32, 32, 3)
  REPRO_F32_TILE(64, 16, 4)
  REPRO_F32_TILE(64, 32, 2)
  REPRO_F32_TILE(128, 16, 4)
  REPRO_F32_TILE(128, 32, 4)
#undef REPRO_F32_TILE
  return -1;
}

// K2's instantiated output tiles and the thread tile (R x C) and K slices
// of each; kernels/matmul.py:WHOLE_F32 is the same table. `tile` is the
// square output tile; the output is f32 (its own accumulation type).
template <typename T>
static int square_whole_dispatch(const void* a, void* c, int P, int tile,
                                 long long sA, long long sC, int batch,
                                 int groups, void* stream) {
  static_assert(sizeof(T) == 4, "the FMA K2 is the f32 kernel");
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define REPRO_WHOLE_F32(TILE_, R_, C_, KS_)                                 \
  if (tile == TILE_)                                                       \
    return launch_square_whole<TILE_, R_, C_, KS_>(a, c, P, sA, sC, batch, \
                                                   groups, st);
  REPRO_WHOLE_F32(16, 4, 8, 16)
  REPRO_WHOLE_F32(32, 8, 4, 4)
  REPRO_WHOLE_F32(64, 8, 8, 4)
#undef REPRO_WHOLE_F32
  return -1;
}

// K3's instantiated (panel height, column width) pairs;
// kernels/matmul.py:FMA_PANELS is the same table. The output is the input
// type, which is its own accumulation type.
template <typename T>
static int square_panel_dispatch(const void* a, void* c, int P, int tile,
                                 int width, long long sA, long long sC,
                                 int batch, int groups, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define REPRO_FMA_PANEL(H_, W_)                                             \
  if (tile == H_ && width == W_)                                           \
    return launch_square_panel<T, H_, W_>(a, c, P, sA, sC, batch, groups,  \
                                          st);
  REPRO_FMA_PANEL(32, 32)
  REPRO_FMA_PANEL(32, 64)
  REPRO_FMA_PANEL(64, 64)
#undef REPRO_FMA_PANEL
  return -1;
}

}  // namespace repro

// One translation unit per element type (they compile in parallel) expands
// this once: REPRO_DEFINE_C_API(f32, float) defines repro_matmul_f32,
// repro_square_whole_f32 and repro_square_panel_f32. The 16-bit units take
// all three from gemm_tc.cuh, the fp64 unit from gemm_dmma.cuh. A squaring's
// `tile` and `width` are the panel height and column width of K3's output
// tiles, or K2's square tile; K3 ignores `bk` (its ring's K step is
// kPanelBK) and `out_acc`, K1 `out_acc`.
#define REPRO_DEFINE_C_API(SUFFIX, TYPE)                                      \
  extern "C" int repro_matmul_##SUFFIX(                                       \
      const void* a, const void* b, void* c, int M, int N, int K, int tile,  \
      int bk, long long sA, long long sB, long long sC, int batch,           \
      int out_acc, void* stream) {                                            \
    (void)out_acc;                                                            \
    return repro::matmul_dispatch<TYPE>(a, b, c, M, N, K, tile, bk, sA, sB,  \
                                        sC, batch, stream);                   \
  }                                                                           \
  extern "C" int repro_square_whole_##SUFFIX(                                 \
      const void* a, void* c, int P, int tile, long long sA, long long sC,   \
      int batch, int groups, int out_acc, void* stream) {                     \
    (void)out_acc;                                                            \
    return repro::square_whole_dispatch<TYPE>(a, c, P, tile, sA, sC, batch,  \
                                              groups, stream);                \
  }                                                                           \
  extern "C" int repro_square_panel_##SUFFIX(                                 \
      const void* a, void* c, int P, int tile, int width, int bk,            \
      long long sA, long long sC, int batch, int groups, int out_acc,        \
      void* stream) {                                                         \
    (void)bk;                                                                 \
    (void)out_acc;                                                            \
    return repro::square_panel_dispatch<TYPE>(a, c, P, tile, width, sA, sC,  \
                                              batch, groups, stream);         \
  }
