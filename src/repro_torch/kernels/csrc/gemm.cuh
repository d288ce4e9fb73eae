// Hand-written Hopper kernels for the matrix-power chain on the FMA pipeline.
//
// Three kernels for f32 operands, each a block of 256 threads whose threads
// own a register micro-tile of the output, accumulated in fp32 with exact
// IEEE FMAs and stored once:
//
//   matmul_kernel        C = A @ B in f32. Replaces the reference's
//                        `matmul_kernel` (src/repro/kernels/matmul.py,
//                        launched by `matmul_pallas`). The reference walks K
//                        as a sequential grid axis and carries the
//                        accumulator in scratch between grid steps; blocks on
//                        this card run in any order and share nothing, so the
//                        K loop sits inside the block and the accumulator
//                        never leaves registers.
//   square_whole_kernel  C = A @ A from ONE staged copy of A, f32.
//                        Replaces `square_kernel` (tier "whole" of
//                        `square_pallas`). A is copied into the block's
//                        dynamic shared memory once; the row panel and the
//                        column panel of every output tile the block computes
//                        are read from that single copy.
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
//     kPanelBK / kPanelStages), so the inner loop unrolls whole.
//   * A in its storage layout. K1's A tile is [TILE][BK + kPad] and K3's
//     row panel [H][P + kPad], row-major as in memory, so the copy needs no
//     transpose and can be asynchronous. A thread reads each of its rows
//     kStepK = 4 k at a time, one 16-byte `ld.shared` per row, and each k's
//     B row once per column chunk of 4.
//   * Thread tiles sized for the shared-memory pipe. The rates measured on
//     the card (PERF.md) fit a 16-byte `ld.shared` costing the SM four of
//     its 128-byte wavefronts whatever the lanes share: a thread tile of
//     R x C outputs reads R + C such words per 4 R C FMAs, so it keeps the
//     FMA pipe fed only where 4 R C >= 16 (R + C). 8 x 8 sits at the
//     balance; 4 x 4 got half the FMA rate, 2 x 2 a quarter. K1 takes 8 x 8 at tile 128 (256
//     threads, two blocks per SM at 128 registers) and the wider 4 x 8 and
//     2 x 4 at tiles 64 and 32 (128 threads; MatmulLayout). K3's 256
//     threads in f32 are K slices of 4 x 8 thread tiles, each over the
//     whole output tile and a share of every K step, their sums added
//     through shared memory at the end of a tile (PanelLayout): a 32 x 64
//     tile is four slices of 64 threads, where one 2 x 4 tiling of all 256
//     threads read 6 words per 32 FMAs.
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

constexpr int kThreads = 256;     // threads of K2, K3 and K1 at tile 128
constexpr int kPad = 4;           // row padding of K1's A tiles, K3's panel
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

// Micro-tile geometry of K2 (16 x 16 threads). A thread with coordinate t
// (0..15) along one axis owns TM elements of that axis, in chunks of V
// consecutive elements; chunk c starts at c * 16 * V + t * V. For TM = 8
// that is columns [4t, 4t+4) and [64 + 4t, 64 + 4t + 4): sixteen threads
// read 256 contiguous bytes.
template <int TM> struct Frag {
  static constexpr int V = TM < 4 ? TM : 4;
  static constexpr int NCHUNK = TM / V;
  static __device__ __forceinline__ int offset(int chunk, int t) {
    return chunk * 16 * V + t * V;
  }
  // Tile row (or column) of the thread's micro-element i.
  static __device__ __forceinline__ int row(int i, int t) {
    return offset(i / V, t) + i % V;
  }
};

template <typename Acc, int TM, int TN = TM>
__device__ __forceinline__ void zero_acc(Acc (&acc)[TM][TN]) {
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = Acc(0);
}

template <typename Acc, int TM>
__device__ __forceinline__ void outer_fma(Acc (&acc)[TM][TM],
                                          const Acc (&a)[TM],
                                          const Acc (&b)[TM]) {
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TM; ++j) acc[i][j] = fma(a[i], b[j], acc[i][j]);
}

// Write the thread's micro-tile of a TILE x TILE output tile whose top-left
// element is c (row stride ldc), one cast from the accumulator per element.
template <typename TOut, typename Acc, int TM>
__device__ __forceinline__ void store_tile(TOut* c, long long ldc, int ty,
                                           int tx, const Acc (&acc)[TM][TM]) {
  using F = Frag<TM>;
#pragma unroll
  for (int ci = 0; ci < F::NCHUNK; ++ci)
#pragma unroll
    for (int e = 0; e < F::V; ++e) {
      const int i = ci * F::V + e;
      TOut* row = c + (long long)(F::offset(ci, ty) + e) * ldc;
#pragma unroll
      for (int cj = 0; cj < F::NCHUNK; ++cj)
        store_cvt<TOut, Acc, F::V>(row + F::offset(cj, tx),
                                   &acc[i][cj * F::V]);
    }
}

// Copy `count` contiguous elements (a multiple of 16 bytes) into shared
// memory unchanged.
template <typename T>
__device__ __forceinline__ void stage_flat(const T* src, long long count,
                                           T* dst, int tid) {
  constexpr int VEC = 16 / sizeof(T);
  const long long nvec = count / VEC;
  const uint4* s = reinterpret_cast<const uint4*>(src);
  uint4* d = reinterpret_cast<uint4*>(dst);
  for (long long v = tid; v < nvec; v += kThreads) d[v] = s[v];
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

// K1 (f32): STAGES stages, each the [TILE][BK + kPad] A tile and the
// [BK][TILE] B tile of one K step.
template <int TILE, int BK, int STAGES> struct FmaRing {
  static constexpr int LDA = BK + kPad;
  static constexpr int STAGE = (TILE * LDA + BK * TILE) * 4;
  static constexpr int BYTES = STAGES * STAGE;
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

// K1's threads per tile: 8 x 8 outputs each at tile 128 (256 threads, two
// blocks per SM at 128 registers); at tiles 64 and 32 the wider 4 x 8 and
// 2 x 4 thread tiles of 128 threads, whose shared loads per FMA are a third
// fewer than 4 x 4's and 2 x 2's. (At tile 128, 8 x 16 in 128 threads took
// 255 registers, ran 6-7 % faster at 4096^2 and 10 % slower at 3072^2,
// where a third wave leaves blocks of four warps alone on their SMs;
// PERF.md.)
template <int TILE> struct MatmulLayout;
template <> struct MatmulLayout<128> { using L = FmaLayout<8, 8, 4, 2>; };
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
// K2: C = A @ A, the whole of A staged once per block
// ---------------------------------------------------------------------------

template <typename T, typename TOut, int TILE>
__global__ void __launch_bounds__(kThreads)
square_whole_kernel(const T* __restrict__ A, TOut* __restrict__ C, int P,
                    long long sA, long long sC) {
  using Acc = typename Num<T>::Acc;
  constexpr int TM = TILE / 16;
  using F = Frag<TM>;

  extern __shared__ __align__(16) unsigned char smem[];
  T* As = reinterpret_cast<T*>(smem);  // [P][P], storage type

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  A += blockIdx.z * sA;
  C += blockIdx.z * sC;

  stage_flat<T>(A, (long long)P * P, As, tid);
  __syncthreads();

  // The blocks of one matrix (gridDim.x of them) share its output tiles.
  const int tiles_per_row = P / TILE;
  const int n_tiles = tiles_per_row * tiles_per_row;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int row0 = (tile / tiles_per_row) * TILE;
    const int col0 = (tile % tiles_per_row) * TILE;
    Acc acc[TM][TM];
    zero_acc<Acc, TM>(acc);
    for (int kk = 0; kk < P; kk += kStepK) {
      // The thread's rows of A, kStepK consecutive k at a time: one 16-byte
      // shared load per row (all sixteen threads of a row broadcast).
      Acc a4[TM][kStepK];
#pragma unroll
      for (int i = 0; i < TM; ++i)
        load_cvt<T, kStepK>(As + (row0 + F::row(i, ty)) * P + kk, a4[i]);
#pragma unroll
      for (int s = 0; s < kStepK; ++s) {
        Acc a[TM], b[TM];
#pragma unroll
        for (int i = 0; i < TM; ++i) a[i] = a4[i][s];
#pragma unroll
        for (int c = 0; c < F::NCHUNK; ++c)
          load_cvt<T, F::V>(As + (kk + s) * P + col0 + F::offset(c, tx),
                            b + c * F::V);
        outer_fma<Acc, TM>(acc, a, b);
      }
    }
    store_tile<TOut, Acc, TM>(C + (long long)row0 * P + col0, P, ty, tx, acc);
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
  const size_t smem = FmaRing<TILE, BK, STAGES>::BYTES;
  auto kernel = matmul_kernel<T, TILE, BK, STAGES>;
  if (int err = allow_smem(kernel, smem)) return err;
  dim3 grid(N / TILE, M / TILE, batch);
  kernel<<<grid, MatmulLayout<TILE>::L::THREADS, smem, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b),
      static_cast<T*>(c), M, N, K, sA, sB, sC);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename TOut, int TILE>
static int launch_square_whole(const void* a, void* c, int P, long long sA,
                               long long sC, int batch, int groups,
                               cudaStream_t stream) {
  const size_t smem = (size_t)P * P * sizeof(T);
  auto kernel = square_whole_kernel<T, TOut, TILE>;
  if (int err = allow_smem(kernel, smem)) return err;
  dim3 grid(groups, 1, batch);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(a), static_cast<TOut*>(c), P, sA, sC);
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

// K1's instantiated (tile, K step) pairs and the ring stages of each;
// kernels/matmul.py:F32_STAGES is the same table. The output is f32 whatever
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
  REPRO_F32_TILE(128, 32, 3)
#undef REPRO_F32_TILE
  return -1;
}

// K2: `out_acc` selects the output type, 0 the input type, 1 the
// accumulation type (the same for f32); `tile` is the square output tile.
template <typename T>
static int square_whole_dispatch(const void* a, void* c, int P, int tile,
                                 long long sA, long long sC, int batch,
                                 int groups, int out_acc, void* stream) {
  using Acc = typename Num<T>::Acc;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (tile) {
#define REPRO_WHOLE_TILE(TILE_)                                               \
  case TILE_:                                                                \
    return out_acc ? launch_square_whole<T, Acc, TILE_>(a, c, P, sA, sC,     \
                                                        batch, groups, st)   \
                   : launch_square_whole<T, T, TILE_>(a, c, P, sA, sC,       \
                                                      batch, groups, st);
    REPRO_WHOLE_TILE(32)
    REPRO_WHOLE_TILE(64)
    REPRO_WHOLE_TILE(128)
#undef REPRO_WHOLE_TILE
    default:
      return -1;
  }
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
    return repro::square_whole_dispatch<TYPE>(a, c, P, tile, sA, sC, batch,  \
                                              groups, out_acc, stream);       \
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
