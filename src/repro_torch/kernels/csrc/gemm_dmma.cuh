// K1 for fp64 operands on Hopper's fp64 tensor cores (DMMA).
//
//   matmul_dmma_kernel  C = A @ B in double precision. Replaces the
//                       reference's `matmul_kernel` (src/repro/kernels/
//                       matmul.py, launched by `matmul_pallas`) for f64, where
//                       gemm.cuh's FMA `matmul_kernel` keeps f32. K2 and K3
//                       in f64 stay on gemm.cuh.
//
// Every product is a fused fp64 multiply-add (`mma.sync...f64.f64.f64.f64`):
// no reduced precision anywhere, the sum only taken in another order than
// the FMA kernel's.
//
// What bounds it on this card: operations. A (4096^2) @ (4096^2) f64 product
// is 137 GFLOP over 403 MB (each operand read once, the result written
// once): 2.051 ms at the 67 TFLOP/s the H100 SXM data sheet gives for fp64
// on the tensor cores, against 0.120 ms for the bytes at 3.35 TB/s. The FMA
// pipeline gives half that rate (34 TFLOP/s), so no FMA kernel can come
// under 4.04 ms; gemm.cuh's took 11.1 ms on an NVIDIA H100 80GB HBM3 at a
// 700 W power limit (chip_smoke.py, phase "kernels").
//
// What the design does about it:
//
//   * m16n8k8 (four doubles of A, two of B, four of C per thread), one of
//     the fp64 shapes PTX ISA 7.8 added for sm_90 beside m16n8k4 and
//     m16n8k16: half the instructions of m16n8k4 and half the fragment
//     registers of m16n8k16. (m8n8k4 is the sm_80 form.)
//   * A square TILE x TILE block tile of four warps (DmmaWarps, 2 x 2), each
//     a 32 x 32 (tile 64) or 16 x 16 (tile 32) warp tile. A 32 x 32 warp
//     tile loads 16 doubles from shared memory per 8 DMMAs of 2,048 flops
//     each, and takes 152-160 registers, so three blocks share an SM. A
//     128-wide tile (eight 64 x 32 warps, 224 registers, one block per SM),
//     measured at K step 16 with 3 stages, ran slower on the card (PERF.md),
//     so it is not instantiated.
//   * A ring of STAGES `cp.async` stages (the REPRO_DMMA_TILE table), each
//     the [TILE x BK] tile of A and the [BK x TILE] tile of B, row-major as
//     they lie in memory. A
//     fragment element is one 8-byte `ld.shared`, which `ldmatrix` (16-bit
//     rows) cannot do, so both tiles pad their rows by kPad = 4 doubles: a
//     half-warp's 16 loads (rows g and columns t of a fragment, g, t < 4)
//     then land on 16 distinct 8-byte bank pairs instead of four.
//   * Epilogue: each thread's accumulator pairs are adjacent columns, stored
//     as 16-byte writes.
//
// The stacked form is the same kernel with the stack on gridDim.z and a
// per-operand stride (0 broadcasts a 2-D operand). Plain C interface, as
// gemm.cuh: the launcher returns the launch's cudaError_t, -1 for a
// (tile, K step) pair this file does not instantiate.

#pragma once

#include <cuda_runtime.h>

#include "gemm.cuh"
#include "gemm_tc.cuh"

namespace repro {
namespace dmma {

constexpr int kPad = 4;                   // row padding of the staged tiles

// The ring of one launch: STAGES stages of the padded A and B tiles.
// kernels/matmul.py:dmma_smem_bytes computes the same, and a CPU test
// evaluates this formula as written against it.
template <int TILE, int BK, int STAGES> struct DmmaRing {
  static constexpr int LDA = BK + kPad;
  static constexpr int LDB = TILE + kPad;
  static constexpr int STAGE = (TILE * LDA + BK * LDB) * 8;
  static constexpr int BYTES = STAGES * STAGE;
};

// Warps of a block: WARPS_M x WARPS_N, each a WM x WN warp tile of MI
// m16 tiles by NJ n8 tiles.
template <int TILE> struct DmmaWarps {
  static constexpr int WARPS_M = 2, WARPS_N = 2;
  static constexpr int THREADS = 32 * WARPS_M * WARPS_N;
  static constexpr int WM = TILE / WARPS_M, WN = TILE / WARPS_N;
  static constexpr int MI = WM / 16, NJ = WN / 8;
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
#pragma unroll
  for (int i = 0; i < W::MI; ++i)
#pragma unroll
    for (int j = 0; j < W::NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0;

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
    for (int kk = 0; kk < BK; kk += 8) {
      double a[W::MI][4], b[W::NJ][2];
#pragma unroll
      for (int i = 0; i < W::MI; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          a[i][e] = As[(i * 16 + g + 8 * (e & 1)) * R::LDA + kk + t +
                       4 * (e >> 1)];
#pragma unroll
      for (int j = 0; j < W::NJ; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          b[j][e] = Bs[(kk + t + 4 * e) * R::LDB + j * 8 + g];
#pragma unroll
      for (int i = 0; i < W::MI; ++i)
#pragma unroll
        for (int j = 0; j < W::NJ; ++j) dmma(acc[i][j], a[i], b[j]);
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < W::MI; ++i)
#pragma unroll
    for (int j = 0; j < W::NJ; ++j) {
      double* p = C + (long long)(wm + i * 16 + g) * N + wn + j * 8 + 2 * t;
      *reinterpret_cast<Pack<double, 2>*>(p) = {{acc[i][j][0], acc[i][j][1]}};
      *reinterpret_cast<Pack<double, 2>*>(p + 8 * (long long)N) =
          {{acc[i][j][2], acc[i][j][3]}};
    }
}

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

// The instantiated (tile, K step) pairs and each one's ring stages;
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

}  // namespace dmma
}  // namespace repro

// The fp64 translation unit expands this once: repro_matmul_f64 on the
// tensor-core kernel above, with the signature of gemm.cuh's
// REPRO_DEFINE_C_API, and repro_square_panel_f64 / repro_square_whole_f64 on
// gemm.cuh's FMA kernels (REPRO_DEFINE_SQUARE_API).
#define REPRO_DEFINE_DMMA_API(SUFFIX)                                         \
  extern "C" int repro_matmul_##SUFFIX(                                       \
      const void* a, const void* b, void* c, int M, int N, int K, int tile,  \
      int bk, long long sA, long long sB, long long sC, int batch,           \
      int out_acc, void* stream) {                                            \
    (void)out_acc;                                                            \
    return repro::dmma::matmul_dispatch(a, b, c, M, N, K, tile, bk, sA, sB,  \
                                        sC, batch, stream);                   \
  }                                                                           \
  REPRO_DEFINE_SQUARE_API(SUFFIX, double)
