// Hand-written Hopper kernels for the matrix-power chain.
//
// Three kernels, one register-tiled design (16 x 16 threads per block, each
// thread owns a (TILE/16) x (TILE/16) micro-tile of the output, accumulated
// in registers at fp32 -- fp64 for fp64 input -- and cast once at the store):
//
//   matmul_kernel        C = A @ B. Replaces the reference's `matmul_kernel`
//                        (src/repro/kernels/matmul.py, launched by
//                        `matmul_pallas`). The reference walks K as a
//                        sequential grid axis and carries the accumulator
//                        in scratch between grid steps; blocks on this card
//                        run in any order and share nothing, so the K loop
//                        sits inside the block and the accumulator never
//                        leaves registers.
//   square_whole_kernel  C = A @ A from ONE staged copy of A. Replaces
//                        `square_kernel` (tier "whole" of `square_pallas`).
//                        A is copied into the block's dynamic shared memory
//                        once; the row panel and the column panel of every
//                        output tile the block computes are read from that
//                        single copy, so A crosses the memory bus once per
//                        block instead of twice per output tile.
//   square_panel_kernel  C = A @ A from a (TILE, P) row panel held in shared
//                        memory. Replaces `square_panel_kernel` (tier
//                        "panel"). The reference relies on a sequential
//                        inner grid axis to stage the row panel once per
//                        row of output tiles; here the loop over column
//                        tiles is inside the block, and the column panel is
//                        streamed through a small staging tile (it is
//                        re-read by every block row, which the L2 cache
//                        absorbs for operands of this tier).
//
// What bounds them: all three are bound by operations, not bytes, at every
// size the chain uses (a 4096^3 product is 137 GFLOP over 201 MB). They run
// on the CUDA cores with exact IEEE fp32 / fp64 FMAs -- no TF32 -- which is
// what keeps a 7-multiply fp32 chain inside its error budget. For 16-bit
// inputs all three are the tensor-core kernels of gemm_tc.cuh, and for fp64
// K1 is the fp64 tensor-core kernel of gemm_dmma.cuh. The design
// therefore spends its effort on the FMA : shared-load ratio: micro-tiles up
// to 8 x 8 (64 FMAs for four 16-byte shared loads), A staged transposed so
// both fragments are contiguous, fragments split in two 64-column halves so
// 16-byte shared loads are conflict-free. The squaring kernels keep A in its
// row-major storage layout (that is what lets one copy serve both sides), so
// they read a thread's rows four k at a time -- one 16-byte load per row per
// four k steps instead of four scalar loads.
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

constexpr int kThreads = 256;  // 16 x 16
constexpr int kPad = 4;        // shared-memory row padding (elements)
constexpr int kStepK = 4;      // k values a squaring kernel reads per row load

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

// Micro-tile geometry. A thread with coordinate t (0..15) along one axis owns
// TM elements of that axis, in chunks of V consecutive elements; chunk c
// starts at c * 16 * V + t * V. For TM = 8 that is columns [4t, 4t+4) and
// [64 + 4t, 64 + 4t + 4): sixteen threads read 256 contiguous bytes.
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

template <typename Acc, int TM>
__device__ __forceinline__ void zero_acc(Acc (&acc)[TM][TM]) {
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TM; ++j) acc[i][j] = Acc(0);
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

// Stage a (rows x TILE) tile of a row-major matrix (row stride ld) into
// shared memory as accumulation-type values, row stride TILE + kPad.
template <typename T, int TILE>
__device__ __forceinline__ void stage_rows(const T* src, long long ld,
                                           int rows,
                                           typename Num<T>::Acc* dst,
                                           int tid) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int VPR = TILE / VEC;  // 16-byte vectors per tile row
  constexpr int LD = TILE + kPad;
  for (int v = tid; v < rows * VPR; v += kThreads) {
    const int r = v / VPR;
    const int c = (v - r * VPR) * VEC;
    Pack<T, VEC> pk =
        *reinterpret_cast<const Pack<T, VEC>*>(src + (long long)r * ld + c);
#pragma unroll
    for (int e = 0; e < VEC; ++e) dst[r * LD + c + e] = Num<T>::to_acc(pk.v[e]);
  }
}

// Stage a (TILE x cols) tile of a row-major matrix TRANSPOSED: dst[c][r].
template <typename T, int TILE>
__device__ __forceinline__ void stage_transposed(const T* src, long long ld,
                                                 int cols,
                                                 typename Num<T>::Acc* dst,
                                                 int tid) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int LD = TILE + kPad;
  const int vpr = cols / VEC;
  for (int v = tid; v < TILE * vpr; v += kThreads) {
    const int r = v / vpr;
    const int c = (v - r * vpr) * VEC;
    Pack<T, VEC> pk =
        *reinterpret_cast<const Pack<T, VEC>*>(src + (long long)r * ld + c);
#pragma unroll
    for (int e = 0; e < VEC; ++e) dst[(c + e) * LD + r] = Num<T>::to_acc(pk.v[e]);
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
// K1: C[M,N] = A[M,K] @ B[K,N]
// ---------------------------------------------------------------------------

template <typename T, typename TOut, int TILE>
__global__ void __launch_bounds__(kThreads)
matmul_kernel(const T* __restrict__ A, const T* __restrict__ B,
              TOut* __restrict__ C, int M, int N, int K, int bk,
              long long sA, long long sB, long long sC) {
  using Acc = typename Num<T>::Acc;
  constexpr int TM = TILE / 16;
  using F = Frag<TM>;
  constexpr int LD = TILE + kPad;

  extern __shared__ __align__(16) unsigned char smem[];
  Acc* As = reinterpret_cast<Acc*>(smem);  // [bk][LD], A tile transposed
  Acc* Bs = As + bk * LD;                  // [bk][LD]

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const long long row0 = (long long)blockIdx.y * TILE;
  const long long col0 = (long long)blockIdx.x * TILE;
  A += blockIdx.z * sA + row0 * K;
  B += blockIdx.z * sB + col0;
  C += blockIdx.z * sC + row0 * N + col0;

  Acc acc[TM][TM];
  zero_acc<Acc, TM>(acc);

  for (int k0 = 0; k0 < K; k0 += bk) {
    stage_transposed<T, TILE>(A + k0, K, bk, As, tid);
    stage_rows<T, TILE>(B + (long long)k0 * N, N, bk, Bs, tid);
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < bk; ++kk) {
      Acc a[TM], b[TM];
#pragma unroll
      for (int c = 0; c < F::NCHUNK; ++c) {
        load_cvt<Acc, F::V>(As + kk * LD + F::offset(c, ty), a + c * F::V);
        load_cvt<Acc, F::V>(Bs + kk * LD + F::offset(c, tx), b + c * F::V);
      }
      outer_fma<Acc, TM>(acc, a, b);
    }
    __syncthreads();
  }
  store_tile<TOut, Acc, TM>(C, N, ty, tx, acc);
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
// K3: C = A @ A, a (TILE, P) row panel staged once per block
// ---------------------------------------------------------------------------

template <typename T, typename TOut, int TILE>
__global__ void __launch_bounds__(kThreads)
square_panel_kernel(const T* __restrict__ A, TOut* __restrict__ C, int P,
                    int bk, long long sA, long long sC) {
  using Acc = typename Num<T>::Acc;
  constexpr int TM = TILE / 16;
  using F = Frag<TM>;
  constexpr int LD = TILE + kPad;

  extern __shared__ __align__(16) unsigned char smem[];
  T* panel = reinterpret_cast<T*>(smem);  // [TILE][P], storage type
  Acc* Bs = reinterpret_cast<Acc*>(smem + (size_t)TILE * P * sizeof(T));

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const long long row0 = (long long)blockIdx.y * TILE;
  A += blockIdx.z * sA;
  C += blockIdx.z * sC + row0 * P;

  // Rows row0 .. row0+TILE of a row-major matrix are one contiguous range.
  stage_flat<T>(A + row0 * P, (long long)TILE * P, panel, tid);
  __syncthreads();

  // The blocks of one panel (gridDim.x of them) share its column tiles.
  const int col_tiles = P / TILE;
  for (int jt = blockIdx.x; jt < col_tiles; jt += gridDim.x) {
    const int col0 = jt * TILE;
    Acc acc[TM][TM];
    zero_acc<Acc, TM>(acc);
    for (int k0 = 0; k0 < P; k0 += bk) {
      stage_rows<T, TILE>(A + (long long)k0 * P + col0, P, bk, Bs, tid);
      __syncthreads();
      for (int kk = 0; kk < bk; kk += kStepK) {
        Acc a4[TM][kStepK];
#pragma unroll
        for (int i = 0; i < TM; ++i)
          load_cvt<T, kStepK>(panel + F::row(i, ty) * P + k0 + kk, a4[i]);
#pragma unroll
        for (int s = 0; s < kStepK; ++s) {
          Acc a[TM], b[TM];
#pragma unroll
          for (int i = 0; i < TM; ++i) a[i] = a4[i][s];
#pragma unroll
          for (int c = 0; c < F::NCHUNK; ++c)
            load_cvt<Acc, F::V>(Bs + (kk + s) * LD + F::offset(c, tx),
                                b + c * F::V);
          outer_fma<Acc, TM>(acc, a, b);
        }
      }
      __syncthreads();
    }
    store_tile<TOut, Acc, TM>(C + col0, P, ty, tx, acc);
  }
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

template <typename T, typename TOut, int TILE>
static int launch_matmul(const void* a, const void* b, void* c, int M, int N,
                         int K, int bk, long long sA, long long sB,
                         long long sC, int batch, cudaStream_t stream) {
  using Acc = typename Num<T>::Acc;
  const size_t smem = (size_t)2 * bk * (TILE + kPad) * sizeof(Acc);
  auto kernel = matmul_kernel<T, TOut, TILE>;
  if (int err = allow_smem(kernel, smem)) return err;
  dim3 grid(N / TILE, M / TILE, batch);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b),
      static_cast<TOut*>(c), M, N, K, bk, sA, sB, sC);
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

template <typename T, typename TOut, int TILE>
static int launch_square_panel(const void* a, void* c, int P, int bk,
                               long long sA, long long sC, int batch,
                               int groups, cudaStream_t stream) {
  using Acc = typename Num<T>::Acc;
  const size_t smem = (size_t)TILE * P * sizeof(T) +
                      (size_t)bk * (TILE + kPad) * sizeof(Acc);
  auto kernel = square_panel_kernel<T, TOut, TILE>;
  if (int err = allow_smem(kernel, smem)) return err;
  dim3 grid(groups, P / TILE, batch);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(a), static_cast<TOut*>(c), P, bk, sA, sC);
  return static_cast<int>(cudaGetLastError());
}

// `out_acc` selects the output type: 0 the input type, 1 the accumulation
// type (fp32 for 16-bit input). `tile` is the square output tile.
#define REPRO_TILE_SWITCH(LAUNCH, ...)                                  \
  switch (tile) {                                                       \
    case 32:                                                            \
      return out_acc ? LAUNCH<T, Acc, 32>(__VA_ARGS__)                  \
                     : LAUNCH<T, T, 32>(__VA_ARGS__);                   \
    case 64:                                                            \
      return out_acc ? LAUNCH<T, Acc, 64>(__VA_ARGS__)                  \
                     : LAUNCH<T, T, 64>(__VA_ARGS__);                   \
    case 128:                                                           \
      return out_acc ? LAUNCH<T, Acc, 128>(__VA_ARGS__)                 \
                     : LAUNCH<T, T, 128>(__VA_ARGS__);                  \
    default:                                                            \
      return -1;                                                        \
  }

template <typename T>
static int matmul_dispatch(const void* a, const void* b, void* c, int M, int N,
                           int K, int tile, int bk, long long sA,
                           long long sB, long long sC, int batch, int out_acc,
                           void* stream) {
  using Acc = typename Num<T>::Acc;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  REPRO_TILE_SWITCH(launch_matmul, a, b, c, M, N, K, bk, sA, sB, sC, batch, st)
}

template <typename T>
static int square_whole_dispatch(const void* a, void* c, int P, int tile,
                                 long long sA, long long sC, int batch,
                                 int groups, int out_acc, void* stream) {
  using Acc = typename Num<T>::Acc;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  REPRO_TILE_SWITCH(launch_square_whole, a, c, P, sA, sC, batch, groups, st)
}

template <typename T>
static int square_panel_dispatch(const void* a, void* c, int P, int tile,
                                 int bk, long long sA, long long sC, int batch,
                                 int groups, int out_acc, void* stream) {
  using Acc = typename Num<T>::Acc;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  REPRO_TILE_SWITCH(launch_square_panel, a, c, P, bk, sA, sC, batch, groups,
                    st)
}

}  // namespace repro

// One translation unit per element type (they compile in parallel) expands
// this once: REPRO_DEFINE_C_API(f32, float) defines repro_matmul_f32,
// repro_square_whole_f32 and repro_square_panel_f32. The 16-bit units take
// all three from gemm_tc.cuh; the fp64 unit takes K1 from gemm_dmma.cuh and
// K2 / K3 from here (REPRO_DEFINE_SQUARE_WHOLE_API).
#define REPRO_DEFINE_SQUARE_WHOLE_API(SUFFIX, TYPE)                           \
  extern "C" int repro_square_whole_##SUFFIX(                                 \
      const void* a, void* c, int P, int tile, long long sA, long long sC,   \
      int batch, int groups, int out_acc, void* stream) {                     \
    return repro::square_whole_dispatch<TYPE>(a, c, P, tile, sA, sC, batch,  \
                                              groups, out_acc, stream);       \
  }

#define REPRO_DEFINE_C_API(SUFFIX, TYPE)                                      \
  extern "C" int repro_matmul_##SUFFIX(                                       \
      const void* a, const void* b, void* c, int M, int N, int K, int tile,  \
      int bk, long long sA, long long sB, long long sC, int batch,           \
      int out_acc, void* stream) {                                            \
    return repro::matmul_dispatch<TYPE>(a, b, c, M, N, K, tile, bk, sA, sB,  \
                                        sC, batch, out_acc, stream);          \
  }                                                                           \
  extern "C" int repro_square_panel_##SUFFIX(                                 \
      const void* a, void* c, int P, int tile, int bk, long long sA,         \
      long long sC, int batch, int groups, int out_acc, void* stream) {       \
    return repro::square_panel_dispatch<TYPE>(a, c, P, tile, bk, sA, sC,     \
                                              batch, groups, out_acc,         \
                                              stream);                        \
  }                                                                           \
  REPRO_DEFINE_SQUARE_WHOLE_API(SUFFIX, TYPE)
