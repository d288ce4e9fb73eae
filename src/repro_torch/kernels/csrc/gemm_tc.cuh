// Tensor-core kernels for the 16-bit (bf16, f16) operands of the
// matrix-power chain.
//
//   matmul_tc_kernel        C = A @ B. Replaces the reference's `matmul_kernel`
//                           (src/repro/kernels/matmul.py, `matmul_pallas`) for
//                           bf16 / f16, where gemm.cuh's FMA `matmul_kernel`
//                           keeps f32 and f64.
//   square_panel_tc_kernel  C = A @ A from a (TILE, P) row panel resident in
//                           shared memory. Replaces `square_panel_kernel`
//                           (tier "panel" of `square_pallas`) for bf16 / f16.
//   square_whole_tc_kernel  C = A @ A from one staged copy of A (P^2 fits a
//                           block's shared memory). Replaces `square_kernel`
//                           (tier "whole" of `square_pallas`) for bf16 / f16,
//                           where gemm.cuh's FMA `square_whole_kernel` keeps
//                           f32 and f64.
//
// All three compute what the reference computes: products of the storage
// type accumulated in fp32, one rounding to the output type at the store
// (fp32 out when `out_acc` is set). The stacked form is the same kernel with
// the stack on gridDim.z: one launch per stacked multiply.
//
// K2 is bound by neither rate at the sizes of its tier: a 192^2 squaring is
// 14 MFLOP (0.014 us at 989 TFLOP/s) over 147 KB (0.044 us at 3.35 TB/s).
// Latency and the grid bound it, so K2 picks its own output tile (32 or 64,
// kernels/matmul.py:square_whole_grid) to put a block on as many SMs as the
// output allows, whatever the chain's tile; runs `mma.sync.m16n8k16` (the
// 64-row `wgmma` tiles would give the 9-block grid back at 192^2); and
// stages A by TMA in 64 x 64 boxes with one barrier each, so the first
// k-slices' products start while later boxes are in flight.
//
// What bounds them on this card: operations. A (4096^2) @ (4096^2) bf16
// product is 137 GFLOP over 100 MB (each operand read once, the result
// written once): 0.139 ms at the 989 TFLOP/s dense bf16 / f16 tensor-core
// rate of an H100 SXM, against 0.030 ms for the bytes at 3.35 TB/s. gemm.cuh's
// FMA kernel widened every 16-bit element to fp32 and ran 3.74 ms on an
// NVIDIA H100 80GB HBM3 at a 700 W power limit, where cuBLAS took 0.18 ms;
// this one runs 0.244 ms (563 TFLOP/s, 57 % of the bound's rate) on the same
// card and limit (chip_smoke.py, phase "kernels").
//
// What the design does about it:
//
//   * Tensor cores. A 64-row warpgroup issues `wgmma.mma_async` m64nTILEk16
//     with fp32 accumulators in registers; a 128-wide tile runs two consumer
//     warpgroups. Both operands are read by `wgmma` straight from shared
//     memory in their storage type: A (row-major, K-major) as it is, B
//     (row-major (K, N), so MN-major) through the transpose flag `wgmma`
//     allows for 16-bit types -- no transposing copy.
//   * A TMA ring. One producer thread issues 2-D tensor-map loads into a ring
//     of stages, each tracked by a "full" and an "empty" mbarrier; the
//     consumers wait on "full", run the stage's `wgmma`s, keep one group in
//     flight and release the stage before theirs. A's box is [TILE x BK],
//     swizzled 128 B at BK = 64 (64 B at BK = 32) to match the descriptor;
//     B's boxes are [BK x 64], swizzled 128 B. A stacked operand is one
//     (batch * rows, cols) tensor map; a block's row coordinate is
//     z * rows + row0, or row0 for a broadcast (stride 0) operand. The ring
//     takes at most half a block's shared memory (3 stages at TILE 128, BK
//     64; 4 otherwise) so two blocks share an SM and one's epilogue overlaps
//     the other's main loop.
//   * K3 keeps the row panel resident: it arrives once per block by TMA as
//     P / BK swizzled [TILE x BK] boxes and is the `wgmma` A operand for the
//     block's whole sweep over column tiles, which stream through the ring
//     as B. The row panel is never re-read per output tile.
//   * Epilogue: the four lanes of a quad trade accumulator pairs by shuffles
//     so each lane holds eight consecutive columns, converted and written
//     with 16-byte stores.
//   * Tile 32 (`wgmma` needs 64 rows) runs `mma.sync.m16n8k16` fed by
//     `ldmatrix` from a `cp.async` double buffer, so every instantiated
//     16-bit tile runs on the tensor cores.
//
// Tensor maps are encoded on the host with `cuTensorMapEncodeTiled`, reached
// through `cudaGetDriverEntryPoint`, so the library links nothing beyond the
// CUDA runtime; the kernel takes each map as a `__grid_constant__` argument.
// The launchers return the launch's cudaError_t, -1 for a (tile, K step)
// pair this file does not instantiate and -2 when a tensor map cannot be
// encoded. Shapes must be tile- and K-step-divisible and the operands
// 16-byte aligned; the Python wrappers check both.

#pragma once

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "gemm.cuh"

namespace repro {
namespace tc {

constexpr int kAlign = 1024;              // swizzled tiles start 1024-aligned
constexpr int kRingBudget = 232448 / 2;   // a ring takes at most half a block's
constexpr int kPanelStages = 4;           // ring stages of K3's column tiles
constexpr int kMmaPad = 8;                // row padding of the tile-32 buffers
constexpr int kMmaLdb = 32 + kMmaPad;     // row pitch of a tile-32 B buffer
constexpr int kBarrier = 8;               // bytes of one mbarrier
constexpr int kEncodeFailed = -2;

// The dynamic shared memory of each launcher. kernels/matmul.py:tc_smem_bytes
// computes the same from the constants above, and a CPU test evaluates the
// formulas of Ring, PanelRing and MmaTiles as written here against it.

// K1's ring: the A box and the B boxes of one K step per stage, plus a full
// and an empty barrier per stage; four stages where they fit half a block's
// shared memory, else three.
template <int TILE, int BK> struct Ring {
  static constexpr int STAGE = 2 * TILE * BK * 2;
  static constexpr int STAGES =
      (kAlign + 4 * (STAGE + 2 * kBarrier) <= kRingBudget) ? 4 : 3;
  static constexpr int BYTES = kAlign + STAGES * (STAGE + 2 * kBarrier);
};

// K3: the row panel, a ring of column tiles and one more barrier for the
// panel.
template <int TILE, int BK> struct PanelRing {
  static constexpr int STAGE = BK * TILE * 2;
  static constexpr int STAGES = kPanelStages;
  static size_t bytes(int P) {
    return kAlign + (size_t)TILE * P * 2 + STAGES * (STAGE + 2 * kBarrier) +
           kBarrier;
  }
};

// Tile 32 (mma.sync): K1 double-buffers padded A [32][BK + pad] and B
// [BK][32 + pad] tiles; K3 keeps the padded (32, P) row panel and
// double-buffers B.
template <int BK> struct MmaTiles {
  static constexpr int BYTES = 2 * (32 * (BK + kMmaPad) + BK * kMmaLdb) * 2;
  static size_t bytes(int P) {
    return (size_t)32 * (P + kMmaPad) * 2 + 2 * BK * kMmaLdb * 2;
  }
};

// ---------------------------------------------------------------------------
// PTX helpers: shared addresses, mbarriers, TMA, wgmma, mma.sync (cp.async:
// gemm.cuh)
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ unsigned char* align_smem(unsigned char* p) {
  return p + ((kAlign - (smem_u32(p) & (kAlign - 1))) & (kAlign - 1));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// Wait until the barrier's phase of the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// One 2-D box of a tensor map into shared memory; completion is counted in
// bytes on `bar`. c0 is the inner (column) coordinate, c1 the row.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

// The same from a 3-D map (encode_stack): c2 picks the matrix of the stack.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1,
                                         int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N> __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving accumulator reads or writes across the
// asynchronous wgmma that owns the registers.
template <int N> __device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// wgmma shared-memory matrix descriptor: start address, leading and stride
// byte offsets (16-byte units), swizzle mode (1: 128 B, 2: 64 B).
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, uint32_t mode) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | ((uint64_t)mode << 62);
}

// A: K-major rows of BK elements as TMA wrote them; consecutive 8-row groups
// are 8 * BK * 2 bytes apart (SBO); LBO is unused by a swizzled K-major
// layout. A 16-deep K step inside the swizzle atom adds 32 bytes.
template <int BK> __device__ __forceinline__ uint64_t desc_a(uint32_t addr) {
  static_assert(BK == 32 || BK == 64, "wgmma K steps are 32 or 64");
  return make_desc(addr, 16, 8 * BK * 2, BK == 64 ? 1 : 2);
}

// B: MN-major [BK x 64] boxes swizzled 128 B (one 128-byte row per k).
// LBO steps to the next 64 columns (the next box, BK * 128 bytes on), SBO to
// the next 8 rows of k (1024 bytes). A 16-deep K step adds 2048 bytes.
template <int BK> __device__ __forceinline__ uint64_t desc_b(uint32_t addr) {
  return make_desc(addr, BK * 128, 1024, 1);
}

// One m64nNk16 wgmma, fp32 accumulate. Wgmma: A K-major from a descriptor;
// B from a descriptor, MN-major (TRANS_B = 1, K1 / K3's row-major B) or
// K-major (TRANS_B = 0: the keys of attention's Q.K^T, stored (key, d)).
// scale_d = 0 overwrites d instead of accumulating. WgmmaRS: A from four
// registers per thread in the m64k16 fragment layout (the layout an
// m64nNk16 accumulator leaves behind, so attention's probabilities feed
// P.V without a trip through shared memory), B MN-major.
template <typename T, int N, int TRANS_B = 1> struct Wgmma;
template <typename T, int N> struct WgmmaRS;

#define REPRO_WGMMA_SS_64(TYPE, PTX, TB)                                      \
  template <> struct Wgmma<TYPE, 64, TB> {                                    \
    static __device__ __forceinline__ void run(float (&d)[32], uint64_t da,   \
                                               uint64_t db,                   \
                                               int scale_d = 1) {             \
      asm volatile(                                                           \
          "{\n"                                                               \
          ".reg .pred p;\n"                                                   \
          "setp.ne.b32 p, %34, 0;\n"                                          \
          "wgmma.mma_async.sync.aligned.m64n64k16.f32." PTX "." PTX " "       \
          "{%0, %1, %2, %3, %4, %5, %6, %7, "                                 \
          "%8, %9, %10, %11, %12, %13, %14, %15, "                            \
          "%16, %17, %18, %19, %20, %21, %22, %23, "                          \
          "%24, %25, %26, %27, %28, %29, %30, %31}, "                         \
          "%32, %33, p, 1, 1, 0, " #TB ";\n"                                  \
          "}\n"                                                               \
          : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),       \
            "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),       \
            "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),  \
            "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),  \
            "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),  \
            "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),  \
            "+f"(d[30]), "+f"(d[31])                                          \
          : "l"(da), "l"(db), "r"(scale_d));                                  \
    }                                                                         \
  };

#define REPRO_WGMMA_SS_128(TYPE, PTX, TB)                                     \
  template <> struct Wgmma<TYPE, 128, TB> {                                   \
    static __device__ __forceinline__ void run(float (&d)[64], uint64_t da,   \
                                               uint64_t db,                   \
                                               int scale_d = 1) {             \
      asm volatile(                                                           \
          "{\n"                                                               \
          ".reg .pred p;\n"                                                   \
          "setp.ne.b32 p, %66, 0;\n"                                          \
          "wgmma.mma_async.sync.aligned.m64n128k16.f32." PTX "." PTX " "      \
          "{%0, %1, %2, %3, %4, %5, %6, %7, "                                 \
          "%8, %9, %10, %11, %12, %13, %14, %15, "                            \
          "%16, %17, %18, %19, %20, %21, %22, %23, "                          \
          "%24, %25, %26, %27, %28, %29, %30, %31, "                          \
          "%32, %33, %34, %35, %36, %37, %38, %39, "                          \
          "%40, %41, %42, %43, %44, %45, %46, %47, "                          \
          "%48, %49, %50, %51, %52, %53, %54, %55, "                          \
          "%56, %57, %58, %59, %60, %61, %62, %63}, "                         \
          "%64, %65, p, 1, 1, 0, " #TB ";\n"                                  \
          "}\n"                                                               \
          : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),       \
            "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),       \
            "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),  \
            "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),  \
            "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),  \
            "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),  \
            "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),  \
            "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),  \
            "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),  \
            "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),  \
            "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),  \
            "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),  \
            "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])                \
          : "l"(da), "l"(db), "r"(scale_d));                                  \
    }                                                                         \
  };

#define REPRO_WGMMA_RS_64(TYPE, PTX)                                          \
  template <> struct WgmmaRS<TYPE, 64> {                                      \
    static __device__ __forceinline__ void run(float (&d)[32],                \
                                               const uint32_t (&a)[4],        \
                                               uint64_t db) {                 \
      asm volatile(                                                           \
          "{\n"                                                               \
          ".reg .pred p;\n"                                                   \
          "setp.ne.b32 p, %37, 0;\n"                                          \
          "wgmma.mma_async.sync.aligned.m64n64k16.f32." PTX "." PTX " "       \
          "{%0, %1, %2, %3, %4, %5, %6, %7, "                                 \
          "%8, %9, %10, %11, %12, %13, %14, %15, "                            \
          "%16, %17, %18, %19, %20, %21, %22, %23, "                          \
          "%24, %25, %26, %27, %28, %29, %30, %31}, "                         \
          "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"                          \
          "}\n"                                                               \
          : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),       \
            "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),       \
            "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),  \
            "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),  \
            "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),  \
            "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),  \
            "+f"(d[30]), "+f"(d[31])                                          \
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),              \
            "r"(1));                                                          \
    }                                                                         \
  };

#define REPRO_WGMMA_RS_128(TYPE, PTX)                                         \
  template <> struct WgmmaRS<TYPE, 128> {                                     \
    static __device__ __forceinline__ void run(float (&d)[64],                \
                                               const uint32_t (&a)[4],        \
                                               uint64_t db) {                 \
      asm volatile(                                                           \
          "{\n"                                                               \
          ".reg .pred p;\n"                                                   \
          "setp.ne.b32 p, %69, 0;\n"                                          \
          "wgmma.mma_async.sync.aligned.m64n128k16.f32." PTX "." PTX " "      \
          "{%0, %1, %2, %3, %4, %5, %6, %7, "                                 \
          "%8, %9, %10, %11, %12, %13, %14, %15, "                            \
          "%16, %17, %18, %19, %20, %21, %22, %23, "                          \
          "%24, %25, %26, %27, %28, %29, %30, %31, "                          \
          "%32, %33, %34, %35, %36, %37, %38, %39, "                          \
          "%40, %41, %42, %43, %44, %45, %46, %47, "                          \
          "%48, %49, %50, %51, %52, %53, %54, %55, "                          \
          "%56, %57, %58, %59, %60, %61, %62, %63}, "                         \
          "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"                          \
          "}\n"                                                               \
          : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),       \
            "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),       \
            "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),  \
            "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),  \
            "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),  \
            "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),  \
            "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),  \
            "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),  \
            "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),  \
            "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),  \
            "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),  \
            "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),  \
            "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])                \
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),              \
            "r"(1));                                                          \
    }                                                                         \
  };

#define REPRO_WGMMA_RS_256(TYPE, PTX)                                         \
  template <> struct WgmmaRS<TYPE, 256> {                                     \
    static __device__ __forceinline__ void run(float (&d)[128],               \
                                               const uint32_t (&a)[4],        \
                                               uint64_t db) {                 \
      asm volatile(                                                           \
          "{\n"                                                               \
          ".reg .pred p;\n"                                                   \
          "setp.ne.b32 p, %133, 0;\n"                                         \
          "wgmma.mma_async.sync.aligned.m64n256k16.f32." PTX "." PTX " "      \
          "{%0, %1, %2, %3, %4, %5, %6, %7, "                                 \
          "%8, %9, %10, %11, %12, %13, %14, %15, "                            \
          "%16, %17, %18, %19, %20, %21, %22, %23, "                          \
          "%24, %25, %26, %27, %28, %29, %30, %31, "                          \
          "%32, %33, %34, %35, %36, %37, %38, %39, "                          \
          "%40, %41, %42, %43, %44, %45, %46, %47, "                          \
          "%48, %49, %50, %51, %52, %53, %54, %55, "                          \
          "%56, %57, %58, %59, %60, %61, %62, %63, "                          \
          "%64, %65, %66, %67, %68, %69, %70, %71, "                          \
          "%72, %73, %74, %75, %76, %77, %78, %79, "                          \
          "%80, %81, %82, %83, %84, %85, %86, %87, "                          \
          "%88, %89, %90, %91, %92, %93, %94, %95, "                          \
          "%96, %97, %98, %99, %100, %101, %102, %103, "                      \
          "%104, %105, %106, %107, %108, %109, %110, %111, "                  \
          "%112, %113, %114, %115, %116, %117, %118, %119, "                  \
          "%120, %121, %122, %123, %124, %125, %126, %127}, "                 \
          "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n"                     \
          "}\n"                                                               \
          : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),       \
            "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),       \
            "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),  \
            "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),  \
            "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),  \
            "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),  \
            "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),  \
            "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),  \
            "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),  \
            "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),  \
            "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),  \
            "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),  \
            "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),  \
            "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),  \
            "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),  \
            "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),  \
            "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),  \
            "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),  \
            "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),  \
            "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),  \
            "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),\
            "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),\
            "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),\
            "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),\
            "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),\
            "+f"(d[125]), "+f"(d[126]), "+f"(d[127])                          \
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),              \
            "r"(1));                                                          \
    }                                                                         \
  };

REPRO_WGMMA_SS_64(__nv_bfloat16, "bf16", 1)
REPRO_WGMMA_SS_128(__nv_bfloat16, "bf16", 1)
REPRO_WGMMA_SS_64(__half, "f16", 1)
REPRO_WGMMA_SS_128(__half, "f16", 1)
REPRO_WGMMA_SS_64(__nv_bfloat16, "bf16", 0)
REPRO_WGMMA_SS_128(__nv_bfloat16, "bf16", 0)
REPRO_WGMMA_SS_64(__half, "f16", 0)
REPRO_WGMMA_SS_128(__half, "f16", 0)
REPRO_WGMMA_RS_64(__nv_bfloat16, "bf16")
REPRO_WGMMA_RS_128(__nv_bfloat16, "bf16")
REPRO_WGMMA_RS_256(__nv_bfloat16, "bf16")
REPRO_WGMMA_RS_64(__half, "f16")
REPRO_WGMMA_RS_128(__half, "f16")
REPRO_WGMMA_RS_256(__half, "f16")

#undef REPRO_WGMMA_SS_64
#undef REPRO_WGMMA_SS_128
#undef REPRO_WGMMA_RS_64
#undef REPRO_WGMMA_RS_128
#undef REPRO_WGMMA_RS_256

// m16n8k16 mma.sync, fp32 accumulate; a: 4 registers (ldmatrix.x4 of a
// 16 x 16 A tile), b: 2 registers (16 k x 8 n).
template <typename T> struct Mma;

#define REPRO_MMA(TYPE, PTX)                                                  \
  template <> struct Mma<TYPE> {                                              \
    static __device__ __forceinline__ void run(float (&c)[4],                \
                                               const uint32_t (&a)[4],        \
                                               uint32_t b0, uint32_t b1) {    \
      asm volatile(                                                           \
          "mma.sync.aligned.m16n8k16.row.col.f32." PTX "." PTX ".f32 "        \
          "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "                    \
          "{%0, %1, %2, %3};\n"                                               \
          : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])                    \
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));    \
    }                                                                         \
  };

REPRO_MMA(__nv_bfloat16, "bf16")
REPRO_MMA(__half, "f16")

#undef REPRO_MMA

// ldmatrix of four 8x8 16-bit matrices from a shared address (each lane
// gives one 16-byte row), plain or transposed.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// ---------------------------------------------------------------------------
// Epilogues
// ---------------------------------------------------------------------------

// Eight consecutive values, converted once, in 16-byte stores.
template <typename TOut>
__device__ __forceinline__ void store8(TOut* p, const float (&v)[8]) {
  constexpr int C = 16 / sizeof(TOut);
#pragma unroll
  for (int c = 0; c < 8; c += C) {
    Pack<TOut, C> pk;
#pragma unroll
    for (int e = 0; e < C; ++e) pk.v[e] = Num<TOut>::from_acc(v[c + e]);
    *reinterpret_cast<Pack<TOut, C>*>(p + c) = pk;
  }
}

// Write one warpgroup's 64 x N accumulator tile (top-left element c, row
// stride ldc), or its first `rows` rows. wgmma leaves lane l of warp w
// holding, for each 8-column chunk j, columns 2(l%4) and 2(l%4)+1 of rows
// 16w + l/4 and 16w + l/4 + 8. The four lanes of a quad trade those pairs so
// that lane q ends up with all eight columns of chunk 4g + q.
template <typename TOut, int N>
__device__ __forceinline__ void store_acc(TOut* c, long long ldc,
                                          const float (&d)[N / 2], int lane,
                                          int warp_in_wg, int rows = 64) {
  const int q = lane & 3;
  const long long r = warp_in_wg * 16 + (lane >> 2);
#pragma unroll
  for (int g = 0; g < N / 32; ++g)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float v[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int peer = q ^ i;
        // Send my pair of the chunk `peer` stores; receive `peer`'s pair of
        // the chunk I store (it holds that chunk's columns 2 peer, +1).
        float s0 = 0.f, s1 = 0.f;
#pragma unroll
        for (int k = 0; k < 4; ++k)
          if (k == peer) {
            s0 = d[(4 * g + k) * 4 + 2 * h];
            s1 = d[(4 * g + k) * 4 + 2 * h + 1];
          }
        const float r0 = __shfl_xor_sync(0xffffffffu, s0, i);
        const float r1 = __shfl_xor_sync(0xffffffffu, s1, i);
#pragma unroll
        for (int k = 0; k < 4; ++k)
          if (k == peer) {
            v[2 * k] = r0;
            v[2 * k + 1] = r1;
          }
      }
      if (r + 8 * h < rows)
        store8<TOut>(c + (r + 8 * h) * ldc + g * 32 + q * 8, v);
    }
}

template <typename TOut>
__device__ __forceinline__ void store2(TOut* p, float x, float y) {
  Pack<TOut, 2> pk;
  pk.v[0] = Num<TOut>::from_acc(x);
  pk.v[1] = Num<TOut>::from_acc(y);
  *reinterpret_cast<Pack<TOut, 2>*>(p) = pk;
}

// ---------------------------------------------------------------------------
// The wgmma main loop shared by K1 and K3
// ---------------------------------------------------------------------------

// Accumulate one warpgroup's 64 x TILE output tile over `k_tiles` ring
// stages, starting at ring position `it` (advanced). `a_addr(kt, s)` is the
// shared address of the warpgroup's 64 A rows for K step kt (in ring stage
// s, or in the resident panel); `b_addr(s)` that of stage s's B boxes. One
// wgmma group stays in flight: a stage is released once the group after it
// has been issued.
template <typename T, int TILE, int BK, int STAGES, typename AAddr,
          typename BAddr>
__device__ __forceinline__ void consume(float (&acc)[TILE / 2], int k_tiles,
                                        int& it, uint64_t* full,
                                        uint64_t* empty, AAddr a_addr,
                                        BAddr b_addr) {
#pragma unroll
  for (int i = 0; i < TILE / 2; ++i) acc[i] = 0.f;
  fence_acc(acc);
  for (int kt = 0; kt < k_tiles; ++kt, ++it) {
    const int s = it % STAGES;
    mbar_wait(&full[s], (it / STAGES) & 1);
    const uint32_t a0 = a_addr(kt, s), b0 = b_addr(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      Wgmma<T, TILE>::run(acc, desc_a<BK>(a0 + kk * 32),
                          desc_b<BK>(b0 + kk * 2048));
    wgmma_commit();
    wgmma_wait<1>();
    if (kt > 0) mbar_arrive(&empty[(it - 1) % STAGES]);
  }
  wgmma_wait<0>();
  fence_acc(acc);
  if (k_tiles > 0) mbar_arrive(&empty[(it - 1) % STAGES]);
}

// ---------------------------------------------------------------------------
// K1 on tensor cores: C[M,N] = A[M,K] @ B[K,N], tile 64 or 128
// ---------------------------------------------------------------------------

template <typename T, typename TOut, int TILE, int BK>
__global__ void __launch_bounds__(TILE / 64 * 128 + 32)
matmul_tc_kernel(const __grid_constant__ CUtensorMap map_a,
                 const __grid_constant__ CUtensorMap map_b,
                 TOut* __restrict__ C, int M, int N, int K, int stacked_a,
                 int stacked_b, long long sC) {
  using R = Ring<TILE, BK>;
  constexpr int WG = TILE / 64;             // consumer warpgroups
  constexpr int A_BYTES = TILE * BK * 2;    // A box of a stage; B boxes follow

  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* ring = align_smem(smem);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + R::STAGES * R::STAGE);
  uint64_t* empty = full + R::STAGES;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < R::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], WG * 128);
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int z = blockIdx.z;
  const int row0 = blockIdx.y * TILE, col0 = blockIdx.x * TILE;
  const int k_tiles = K / BK;

  if (warp == WG * 4) {
    // Producer: one thread keeps the ring full.
    if (lane == 0) {
      const int a_row = (stacked_a ? z * M : 0) + row0;
      const int b_row = stacked_b ? z * K : 0;
      for (int kt = 0; kt < k_tiles; ++kt) {
        const int s = kt % R::STAGES;
        mbar_wait(&empty[s], ((kt / R::STAGES) & 1) ^ 1);
        unsigned char* st = ring + s * R::STAGE;
        mbar_expect_tx(&full[s], R::STAGE);
        tma_load(st, &map_a, &full[s], kt * BK, a_row);
#pragma unroll
        for (int c = 0; c < TILE / 64; ++c)
          tma_load(st + A_BYTES + c * BK * 128, &map_b, &full[s],
                   col0 + 64 * c, b_row + kt * BK);
      }
    }
    return;
  }

  const int wg = warp / 4;
  const uint32_t ring_addr = smem_u32(ring);
  float acc[TILE / 2];
  int it = 0;
  consume<T, TILE, BK, R::STAGES>(
      acc, k_tiles, it, full, empty,
      [&](int, int s) {
        return ring_addr + s * R::STAGE + wg * 64 * BK * 2;
      },
      [&](int s) { return ring_addr + s * R::STAGE + A_BYTES; });
  store_acc<TOut, TILE>(C + z * sC + (long long)(row0 + wg * 64) * N + col0,
                        N, acc, lane, warp % 4);
}

// ---------------------------------------------------------------------------
// K3 on tensor cores: C = A @ A, the (TILE, P) row panel resident
// ---------------------------------------------------------------------------

template <typename T, typename TOut, int TILE, int BK>
__global__ void __launch_bounds__(TILE / 64 * 128 + 32)
square_panel_tc_kernel(const __grid_constant__ CUtensorMap map_panel,
                       const __grid_constant__ CUtensorMap map_col,
                       TOut* __restrict__ C, int P, int stacked,
                       long long sC) {
  using R = PanelRing<TILE, BK>;
  constexpr int WG = TILE / 64;
  constexpr int BOX = TILE * BK * 2;        // one [TILE x BK] panel box

  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* panel = align_smem(smem);
  unsigned char* ring = panel + (size_t)TILE * P * 2;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + R::STAGES * R::STAGE);
  uint64_t* empty = full + R::STAGES;
  uint64_t* panel_bar = empty + R::STAGES;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < R::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], WG * 128);
    }
    mbar_init(panel_bar, 1);
    mbar_init_fence();
  }
  __syncthreads();

  const int z = blockIdx.z;
  const int row0 = blockIdx.y * TILE;
  const int base = stacked ? z * P : 0;     // first row of this matrix
  const int k_tiles = P / BK, col_tiles = P / TILE;

  if (warp == WG * 4) {
    if (lane == 0) {
      mbar_expect_tx(panel_bar, (uint32_t)TILE * P * 2);
      for (int kb = 0; kb < k_tiles; ++kb)
        tma_load(panel + (size_t)kb * BOX, &map_panel, panel_bar, kb * BK,
                 base + row0);
      // The blocks of one panel (gridDim.x of them) share its column tiles.
      int it = 0;
      for (int jt = blockIdx.x; jt < col_tiles; jt += gridDim.x)
        for (int kb = 0; kb < k_tiles; ++kb, ++it) {
          const int s = it % R::STAGES;
          mbar_wait(&empty[s], ((it / R::STAGES) & 1) ^ 1);
          unsigned char* st = ring + s * R::STAGE;
          mbar_expect_tx(&full[s], R::STAGE);
#pragma unroll
          for (int c = 0; c < TILE / 64; ++c)
            tma_load(st + c * BK * 128, &map_col, &full[s],
                     jt * TILE + 64 * c, base + kb * BK);
        }
    }
    return;
  }

  const int wg = warp / 4;
  const uint32_t panel_addr = smem_u32(panel), ring_addr = smem_u32(ring);
  mbar_wait(panel_bar, 0);
  float acc[TILE / 2];
  int it = 0;
  for (int jt = blockIdx.x; jt < col_tiles; jt += gridDim.x) {
    consume<T, TILE, BK, R::STAGES>(
        acc, k_tiles, it, full, empty,
        [&](int kt, int) {
          return panel_addr + kt * BOX + wg * 64 * BK * 2;
        },
        [&](int s) { return ring_addr + s * R::STAGE; });
    store_acc<TOut, TILE>(
        C + z * sC + (long long)(row0 + wg * 64) * P + jt * TILE, P, acc,
        lane, warp % 4);
  }
}

// ---------------------------------------------------------------------------
// Tile 32: mma.sync m16n8k16, ldmatrix, cp.async double buffer
// ---------------------------------------------------------------------------
// 128 threads; warp w computes the 16 x 16 quarter at rows 16 (w / 2),
// columns 16 (w % 2) of the 32 x 32 output tile: per 16-deep K step one
// ldmatrix.x4 of A, one ldmatrix.x4.trans of B (row-major, so transposed on
// the way into the fragment) and two mma.sync. Rows of the staged tiles are
// padded by kMmaPad elements so the eight rows an ldmatrix reads fall in
// distinct banks.

constexpr int kMmaThreads = 128;

// Stage the [BK x 32] tile of a row-major matrix (row stride ld) at src.
template <typename T, int BK>
__device__ __forceinline__ void mma_stage_b(const T* src, long long ld, T* dst,
                                            int tid) {
  for (int v = tid; v < BK * 4; v += kMmaThreads) {
    const int r = v >> 2, c = (v & 3) * 8;
    cp_async16(dst + r * kMmaLdb + c, src + r * ld + c);
  }
}

// One BK-deep step of the warp's 16 x 16 quarter: A rows at a (row stride
// lda, K offset already applied), B rows at b.
template <typename T, int BK>
__device__ __forceinline__ void mma_step(float (&acc)[2][4], const T* a,
                                         int lda, const T* b, int lane) {
#pragma unroll
  for (int kk = 0; kk < BK; kk += 16) {
    uint32_t fa[4], fb[4];
    ldsm_x4(fa, smem_u32(a + (lane & 15) * lda + kk + (lane >> 4) * 8));
    ldsm_x4_t(fb,
              smem_u32(b + (kk + (lane & 15)) * kMmaLdb + (lane >> 4) * 8));
    Mma<T>::run(acc[0], fa, fb[0], fb[1]);
    Mma<T>::run(acc[1], fa, fb[2], fb[3]);
  }
}

// Write the warp's 16 x 16 quarter (top-left element c, row stride ldc):
// lane l holds columns 2(l%4), +1 of rows l/4 and l/4 + 8 of each 8-column
// half.
template <typename TOut>
__device__ __forceinline__ void mma_store(TOut* c, long long ldc,
                                          const float (&acc)[2][4], int lane) {
  TOut* p = c + (long long)(lane >> 2) * ldc + (lane & 3) * 2;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    store2<TOut>(p + j * 8, acc[j][0], acc[j][1]);
    store2<TOut>(p + 8 * ldc + j * 8, acc[j][2], acc[j][3]);
  }
}

template <typename T, typename TOut, int BK>
__global__ void __launch_bounds__(kMmaThreads)
matmul_mma_kernel(const T* __restrict__ A, const T* __restrict__ B,
                  TOut* __restrict__ C, int M, int N, int K, long long sA,
                  long long sB, long long sC) {
  constexpr int LDA = BK + kMmaPad;
  extern __shared__ __align__(16) unsigned char smem[];
  T* As = reinterpret_cast<T*>(smem);       // [2][32][LDA]
  T* Bs = As + 2 * 32 * LDA;                // [2][BK][kMmaLdb]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int row0 = blockIdx.y * 32, col0 = blockIdx.x * 32;
  const int wm = (warp >> 1) * 16, wn = (warp & 1) * 16;
  A += blockIdx.z * sA + (long long)row0 * K;
  B += blockIdx.z * sB + col0;
  C += blockIdx.z * sC + (long long)row0 * N + col0;

  auto stage = [&](int s, int k0) {
    for (int v = tid; v < 32 * BK / 8; v += kMmaThreads) {
      const int r = v / (BK / 8), c = (v % (BK / 8)) * 8;
      cp_async16(As + (s * 32 + r) * LDA + c, A + (long long)r * K + k0 + c);
    }
    mma_stage_b<T, BK>(B + (long long)k0 * N, N, Bs + s * BK * kMmaLdb, tid);
    cp_async_commit();
  };

  float acc[2][4] = {};
  const int k_tiles = K / BK;
  stage(0, 0);
  for (int kt = 0; kt < k_tiles; ++kt) {
    if (kt + 1 < k_tiles) {
      stage((kt + 1) & 1, (kt + 1) * BK);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int s = kt & 1;
    mma_step<T, BK>(acc, As + (s * 32 + wm) * LDA, LDA,
                    Bs + s * BK * kMmaLdb + wn, lane);
    __syncthreads();
  }
  mma_store<TOut>(C + (long long)wm * N + wn, N, acc, lane);
}

template <typename T, typename TOut, int BK>
__global__ void __launch_bounds__(kMmaThreads)
square_panel_mma_kernel(const T* __restrict__ A, TOut* __restrict__ C, int P,
                        long long sA, long long sC) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ldp = P + kMmaPad;
  T* panel = reinterpret_cast<T*>(smem);    // [32][ldp], resident
  T* Bs = panel + 32 * ldp;                 // [2][BK][kMmaLdb]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int row0 = blockIdx.y * 32;
  const int wm = (warp >> 1) * 16, wn = (warp & 1) * 16;
  A += blockIdx.z * sA;
  C += blockIdx.z * sC + (long long)row0 * P;

  const int vpr = P / 8;                    // 16-byte chunks per panel row
  for (int v = tid; v < 32 * vpr; v += kMmaThreads) {
    const int r = v / vpr, c = (v - r * vpr) * 8;
    cp_async16(panel + r * ldp + c, A + (long long)(row0 + r) * P + c);
  }
  cp_async_commit();

  const int k_tiles = P / BK, col_tiles = P / 32;
  for (int jt = blockIdx.x; jt < col_tiles; jt += gridDim.x) {
    const T* col = A + jt * 32;
    float acc[2][4] = {};
    mma_stage_b<T, BK>(col, P, Bs, tid);
    cp_async_commit();
    for (int kt = 0; kt < k_tiles; ++kt) {
      if (kt + 1 < k_tiles) {
        mma_stage_b<T, BK>(col + (long long)(kt + 1) * BK * P, P,
                           Bs + ((kt + 1) & 1) * BK * kMmaLdb, tid);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      mma_step<T, BK>(acc, panel + wm * ldp + kt * BK, ldp,
                      Bs + (kt & 1) * BK * kMmaLdb + wn, lane);
      __syncthreads();
    }
    mma_store<TOut>(C + jt * 32 + (long long)wm * P + wn, P, acc, lane);
  }
}

// ---------------------------------------------------------------------------
// K2 on tensor cores: C = A @ A from one staged copy of A
// ---------------------------------------------------------------------------
// A arrives by TMA as 64 x 64 boxes, 128-byte swizzled, box (i, j) holding
// rows 64 i.. and columns 64 j.. (past P: zeros). Each box has its own
// mbarrier, so a warp starts on k-slice kb as soon as the two boxes it needs
// for that slice -- (its row box, kb) and (kb, its column box) -- have
// landed. The row panel (the mma A operand, through ldmatrix) and the column
// panel (B, through ldmatrix.trans) of every output tile come from the same
// staged boxes. Each block stages only the boxes its own tiles read (a
// 4-block cluster sharing one copy by TMA multicast ran slower; PERF.md).
//
// 128 threads, four warps, each accumulating a 32 x 32 square (2 m16 by 4
// n8 tiles of m16n8k16 mma.sync, eight independent products per k16 step).
// Tile 64: the four quarters of the output tile. Tile 32: the whole tile,
// each warp over every fourth k16 step, the four partial sums added through
// shared memory -- a quarter of the dependent steps of one warp per tile.

constexpr int kWholeBox = 64;             // box side: one 128-byte swizzled row
constexpr int kWholeThreads = 128;
constexpr int kWholeRed = 4 * 32 * 32 * 4;  // tile 32's partial sums (bytes)

// The dynamic shared memory of the K2 launcher: the (P / 64)^2 boxes, tile
// 32's partial sums and one barrier per box, plus the alignment slack.
template <int BOX> struct WholeBoxes {
  static constexpr int BOX_BYTES = BOX * BOX * 2;
  static size_t bytes(int P) {
    return kAlign + kWholeRed +
           (size_t)((P + BOX - 1) / BOX) * ((P + BOX - 1) / BOX) *
               (BOX_BYTES + kBarrier);
  }
};

// Shared address of the 16-byte chunk holding element (r, c) of A, c a
// multiple of 8: 128-byte swizzle XORs the chunk index with the row mod 8.
__device__ __forceinline__ uint32_t whole_addr(uint32_t boxes, int nb, int r,
                                               int c) {
  constexpr int BOX_BYTES = WholeBoxes<kWholeBox>::BOX_BYTES;
  const int box = (r / kWholeBox) * nb + c / kWholeBox;
  const int rr = r % kWholeBox, chunk = (c % kWholeBox) / 8;
  return boxes + box * BOX_BYTES + rr * 128 + ((chunk ^ (rr & 7)) << 4);
}

template <typename T, typename TOut, int TILE>
__global__ void __launch_bounds__(kWholeThreads)
square_whole_tc_kernel(const __grid_constant__ CUtensorMap map,
                       TOut* __restrict__ C, int P, long long sC) {
  static_assert(TILE == 32 || TILE == 64, "K2 tiles are 32 and 64");
  constexpr int BOX_BYTES = WholeBoxes<kWholeBox>::BOX_BYTES;
  constexpr int KSPLIT = TILE == 32 ? 4 : 1;   // warps sharing one tile

  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* boxes = align_smem(smem);
  const int nb = (P + kWholeBox - 1) / kWholeBox;
  float* red = reinterpret_cast<float*>(boxes + nb * nb * BOX_BYTES);
  uint64_t* bar = reinterpret_cast<uint64_t*>(
      boxes + nb * nb * BOX_BYTES + kWholeRed);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int z = blockIdx.z;
  const int tiles_per_row = P / TILE, n_tiles = tiles_per_row * tiles_per_row;

  // Box rows and box columns this block's tiles read (bit i: box row or
  // column i). The blocks of one matrix (gridDim.x) share its tiles.
  uint32_t rows = 0, cols = 0;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    rows |= 1u << (tile / tiles_per_row * TILE / kWholeBox);
    cols |= 1u << (tile % tiles_per_row * TILE / kWholeBox);
  }

  // One lane of warp 0 per box (at most 25 of them): it initialises the
  // box's barrier and, if a tile of this block reads the box as a row box or
  // a column box, arms it and issues it at once, so no one thread walks the
  // boxes in turn while K2 waits (issuing k-slice 0's boxes first ran slower
  // on the card).
  const int b = lane, bi = b / nb, bj = b - bi * nb;
  if (warp == 0 && b < nb * nb) {
    mbar_init(&bar[b], 1);
    const bool lands = ((rows >> bi) & 1) || ((cols >> bj) & 1);
    if (lands) mbar_expect_tx(&bar[b], BOX_BYTES);
    mbar_init_fence();
    if (lands)
      tma_load(boxes + b * BOX_BYTES, &map, &bar[b], bj * kWholeBox,
               bi * kWholeBox, z);
  }
  __syncthreads();                           // barriers initialised

  const uint32_t base = smem_u32(boxes);
  const int wm = KSPLIT > 1 ? 0 : (warp >> 1) * 32;
  const int wn = KSPLIT > 1 ? 0 : (warp & 1) * 32;
  const int first = KSPLIT > 1 ? warp : 0;   // this warp's first k16 step
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int row0 = tile / tiles_per_row * TILE + wm;
    const int col0 = tile % tiles_per_row * TILE + wn;
    const int rb = row0 / kWholeBox, cb = col0 / kWholeBox;
    float acc[2][4][4] = {};
    int ready = -1;                          // last k-slice waited for
    for (int step = first; step < P / 16; step += KSPLIT) {
      const int k0 = step * 16, kb = k0 / kWholeBox;
      if (kb != ready) {
        mbar_wait(&bar[rb * nb + kb], 0);
        mbar_wait(&bar[kb * nb + cb], 0);
        ready = kb;
      }
      uint32_t fa[2][4], fb[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        ldsm_x4(fa[i], whole_addr(base, nb, row0 + i * 16 + (lane & 15),
                                  k0 + (lane >> 4) * 8));
#pragma unroll
      for (int j = 0; j < 2; ++j)
        ldsm_x4_t(fb[j], whole_addr(base, nb, k0 + (lane & 15),
                                    col0 + j * 16 + (lane >> 4) * 8));
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          Mma<T>::run(acc[i][2 * j], fa[i], fb[j][0], fb[j][1]);
          Mma<T>::run(acc[i][2 * j + 1], fa[i], fb[j][2], fb[j][3]);
        }
    }
    // Lane l holds columns 2 (l % 4), +1 of rows l / 4 and l / 4 + 8 of each
    // m16 x n8 accumulator.
    TOut* out = C + z * sC + (long long)(row0 + (lane >> 2)) * P + col0 +
                (lane & 3) * 2;
    if constexpr (KSPLIT > 1) {
      // Add the four warps' partial sums: warp w sums and stores n8 column
      // block w of both m16 rows, reading red[(warp, element), lane].
      if (tile != static_cast<int>(blockIdx.x))
        __syncthreads();                     // red is free again
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            red[((warp * 32) + (i * 4 + j) * 4 + e) * 32 + lane] =
                acc[i][j][e];
      __syncthreads();
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float v[4] = {};
#pragma unroll
        for (int q = 0; q < KSPLIT; ++q)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            v[e] += red[((q * 32) + (i * 4 + warp) * 4 + e) * 32 + lane];
        TOut* o = out + (long long)i * 16 * P + warp * 8;
        store2<TOut>(o, v[0], v[1]);
        store2<TOut>(o + 8 * (long long)P, v[2], v[3]);
      }
    } else {
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          TOut* o = out + (long long)i * 16 * P + j * 8;
          store2<TOut>(o, acc[i][j][0], acc[i][j][1]);
          store2<TOut>(o + 8 * (long long)P, acc[i][j][2], acc[i][j][3]);
        }
    }
  }
}

// ---------------------------------------------------------------------------
// Host side: tensor maps and launchers
// ---------------------------------------------------------------------------

static PFN_cuTensorMapEncodeTiled_v12000 encode_fn() {
  static const PFN_cuTensorMapEncodeTiled_v12000 fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p);
  }();
  return fn;
}

template <typename T> constexpr CUtensorMapDataType tma_type();
template <> constexpr CUtensorMapDataType tma_type<__nv_bfloat16>() {
  return CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
}
template <> constexpr CUtensorMapDataType tma_type<__half>() {
  return CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
}

// A row-major (rows, cols) 16-bit matrix read in [box_rows x box_cols]
// boxes (rank 2); or, with depth > 0, a stack of `depth` of them read in
// boxes of one matrix (rank 3, tma_load's c2 picks the matrix), so that a
// box's rows past `rows` read as zeros, not as the next matrix's first rows.
template <typename T>
static int encode(CUtensorMap* map, const void* base, unsigned long long rows,
                  unsigned long long cols, unsigned box_rows,
                  unsigned box_cols, CUtensorMapSwizzle swizzle,
                  unsigned long long depth = 0) {
  const PFN_cuTensorMapEncodeTiled_v12000 fn = encode_fn();
  if (fn == nullptr) return kEncodeFailed;
  const cuuint64_t dims[3] = {cols, rows, depth};
  const cuuint64_t strides[2] = {cols * sizeof(T), rows * cols * sizeof(T)};
  const cuuint32_t box[3] = {box_cols, box_rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult res =
      fn(map, tma_type<T>(), depth ? 3 : 2, const_cast<void*>(base), dims,
         strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
         CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : kEncodeFailed;
}

template <int BK> constexpr CUtensorMapSwizzle a_swizzle() {
  return BK == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B;
}

template <typename T, typename TOut, int TILE, int BK>
static int launch_matmul(const void* a, const void* b, void* c, int M, int N,
                         int K, long long sA, long long sB, long long sC,
                         int batch, cudaStream_t stream) {
  dim3 grid(N / TILE, M / TILE, batch);
  if constexpr (TILE == 32) {
    const size_t smem = MmaTiles<BK>::BYTES;
    auto kernel = matmul_mma_kernel<T, TOut, BK>;
    if (int err = allow_smem(kernel, smem)) return err;
    kernel<<<grid, kMmaThreads, smem, stream>>>(
        static_cast<const T*>(a), static_cast<const T*>(b),
        static_cast<TOut*>(c), M, N, K, sA, sB, sC);
  } else {
    CUtensorMap map_a, map_b;
    if (int err = encode<T>(&map_a, a, (sA ? batch : 1) * (long long)M, K,
                            TILE, BK, a_swizzle<BK>()))
      return err;
    if (int err = encode<T>(&map_b, b, (sB ? batch : 1) * (long long)K, N, BK,
                            64, CU_TENSOR_MAP_SWIZZLE_128B))
      return err;
    const size_t smem = Ring<TILE, BK>::BYTES;
    auto kernel = matmul_tc_kernel<T, TOut, TILE, BK>;
    if (int err = allow_smem(kernel, smem)) return err;
    kernel<<<grid, TILE / 64 * 128 + 32, smem, stream>>>(
        map_a, map_b, static_cast<TOut*>(c), M, N, K, sA != 0, sB != 0, sC);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename TOut, int TILE, int BK>
static int launch_square_panel(const void* a, void* c, int P, long long sA,
                               long long sC, int batch, int groups,
                               cudaStream_t stream) {
  dim3 grid(groups, P / TILE, batch);
  if constexpr (TILE == 32) {
    const size_t smem = MmaTiles<BK>::bytes(P);
    auto kernel = square_panel_mma_kernel<T, TOut, BK>;
    if (int err = allow_smem(kernel, smem)) return err;
    kernel<<<grid, kMmaThreads, smem, stream>>>(
        static_cast<const T*>(a), static_cast<TOut*>(c), P, sA, sC);
  } else {
    const long long rows = (sA ? batch : 1) * (long long)P;
    CUtensorMap map_panel, map_col;
    if (int err = encode<T>(&map_panel, a, rows, P, TILE, BK,
                            a_swizzle<BK>()))
      return err;
    if (int err = encode<T>(&map_col, a, rows, P, BK, 64,
                            CU_TENSOR_MAP_SWIZZLE_128B))
      return err;
    const size_t smem = PanelRing<TILE, BK>::bytes(P);
    auto kernel = square_panel_tc_kernel<T, TOut, TILE, BK>;
    if (int err = allow_smem(kernel, smem)) return err;
    kernel<<<grid, TILE / 64 * 128 + 32, smem, stream>>>(
        map_panel, map_col, static_cast<TOut*>(c), P, sA != 0, sC);
  }
  return static_cast<int>(cudaGetLastError());
}

// K2: a rank-3 map (columns, rows, matrix) so a box past P reads zeros, not
// the next matrix; 64 x 64 boxes, 128-byte swizzle. `groups` blocks share
// each matrix's output tiles.
template <typename T, typename TOut, int TILE>
static int launch_square_whole(const void* a, void* c, int P, long long sC,
                               int batch, int groups, cudaStream_t stream) {
  CUtensorMap map;
  if (int err = encode<T>(&map, a, P, P, kWholeBox, kWholeBox,
                          CU_TENSOR_MAP_SWIZZLE_128B, batch))
    return err;
  const size_t smem = WholeBoxes<kWholeBox>::bytes(P);
  auto kernel = square_whole_tc_kernel<T, TOut, TILE>;
  if (int err = allow_smem(kernel, smem)) return err;
  kernel<<<dim3(groups, 1, batch), kWholeThreads, smem, stream>>>(
      map, static_cast<TOut*>(c), P, sC);
  return static_cast<int>(cudaGetLastError());
}

template <typename TOut, int TILE, int BK> struct Tiling {
  using Out = TOut;
  static constexpr int tile = TILE, bk = BK;
};

// The instantiated (tile, K step) pairs, each with the input type and fp32
// as output; kernels/matmul.py:TC_BLOCKS is the same table.
template <typename T, typename Launch>
static int dispatch(int tile, int bk, int out_acc, Launch&& launch) {
#define REPRO_TC_TILE(TILE_, BK_)                                           \
  if (tile == TILE_ && bk == BK_)                                           \
    return out_acc ? launch(Tiling<float, TILE_, BK_>{})                    \
                   : launch(Tiling<T, TILE_, BK_>{});
  REPRO_TC_TILE(32, 32)
  REPRO_TC_TILE(64, 32)
  REPRO_TC_TILE(64, 64)
  REPRO_TC_TILE(128, 32)
  REPRO_TC_TILE(128, 64)
#undef REPRO_TC_TILE
  return -1;
}

template <typename T>
static int matmul_dispatch(const void* a, const void* b, void* c, int M, int N,
                           int K, int tile, int bk, long long sA,
                           long long sB, long long sC, int batch, int out_acc,
                           void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dispatch<T>(tile, bk, out_acc, [&](auto t) {
    using Tl = decltype(t);
    return launch_matmul<T, typename Tl::Out, Tl::tile, Tl::bk>(
        a, b, c, M, N, K, sA, sB, sC, batch, st);
  });
}

template <typename T>
static int square_panel_dispatch(const void* a, void* c, int P, int tile,
                                 int bk, long long sA, long long sC, int batch,
                                 int groups, int out_acc, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dispatch<T>(tile, bk, out_acc, [&](auto t) {
    using Tl = decltype(t);
    return launch_square_panel<T, typename Tl::Out, Tl::tile, Tl::bk>(
        a, c, P, sA, sC, batch, groups, st);
  });
}

// K2's output tiles (kernels/matmul.py:WHOLE_TC_TILES).
template <typename T>
static int square_whole_dispatch(const void* a, void* c, int P, int tile,
                                 long long sA, long long sC, int batch,
                                 int groups, int out_acc, void* stream) {
  (void)sA;                                 // the tensor map strides the stack
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define REPRO_WHOLE_TC(TILE_)                                                \
  if (tile == TILE_)                                                         \
    return out_acc ? launch_square_whole<T, float, TILE_>(a, c, P, sC, batch,\
                                                          groups, st)        \
                   : launch_square_whole<T, T, TILE_>(a, c, P, sC, batch,    \
                                                      groups, st);
  REPRO_WHOLE_TC(32)
  REPRO_WHOLE_TC(64)
#undef REPRO_WHOLE_TC
  return -1;
}

}  // namespace tc
}  // namespace repro

// One translation unit per 16-bit type expands this once:
// REPRO_DEFINE_TC_API(bf16, __nv_bfloat16) defines repro_matmul_bf16,
// repro_square_whole_bf16 and repro_square_panel_bf16 on the tensor-core
// kernels, with the signatures of gemm.cuh's REPRO_DEFINE_C_API.
#define REPRO_DEFINE_TC_API(SUFFIX, TYPE)                                     \
  extern "C" int repro_matmul_##SUFFIX(                                       \
      const void* a, const void* b, void* c, int M, int N, int K, int tile,  \
      int bk, long long sA, long long sB, long long sC, int batch,           \
      int out_acc, void* stream) {                                            \
    return repro::tc::matmul_dispatch<TYPE>(a, b, c, M, N, K, tile, bk, sA,  \
                                            sB, sC, batch, out_acc, stream);  \
  }                                                                           \
  extern "C" int repro_square_whole_##SUFFIX(                                 \
      const void* a, void* c, int P, int tile, long long sA, long long sC,   \
      int batch, int groups, int out_acc, void* stream) {                     \
    return repro::tc::square_whole_dispatch<TYPE>(                            \
        a, c, P, tile, sA, sC, batch, groups, out_acc, stream);               \
  }                                                                           \
  extern "C" int repro_square_panel_##SUFFIX(                                 \
      const void* a, void* c, int P, int tile, int width, int bk,            \
      long long sA, long long sC, int batch, int groups, int out_acc,        \
      void* stream) {                                                         \
    (void)width;                  /* K3's output tiles are tile x tile */    \
    return repro::tc::square_panel_dispatch<TYPE>(                            \
        a, c, P, tile, bk, sA, sC, batch, groups, out_acc, stream);           \
  }
