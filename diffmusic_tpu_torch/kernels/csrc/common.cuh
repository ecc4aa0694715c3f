// Shared device routines of the port's Hopper kernels (sm_90a).
//
// Every kernel here is a sum of (rows, K) @ (K, cols) products over tiles
// staged in shared memory: the conv1d kernels accumulate one product per tap
// over a haloed time window, the upsampler one per phase tap, the transformer
// block its projections and feed-forward. `TileAcc` is that product, written
// once:
//   - bf16 operands run on the tensor cores through WMMA 16x16x16 fragments
//     with fp32 accumulators (mma.sync underneath);
//   - fp32 operands run as scalar FMAs, so the fp32 path is exact fp32 (no
//     TF32) and serves the tight-tolerance checks.
// The accumulator tile is read from / written to fp32 shared memory, where the
// kernels apply their epilogues. wgmma, TMA and persistent scheduling are not
// used yet.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace dm {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ float leaky(float v, float slope) {
  return v >= 0.f ? v : slope * v;
}

// Row stride (in elements) of a shared-memory operand tile with `cols`
// columns: a multiple of 32 bytes, so that every row start is 32-byte aligned
// as WMMA loads require, plus 32 bytes of skew against bank conflicts.
template <typename T> __host__ __device__ constexpr int smem_ld(int cols) {
  return ((cols * (int)sizeof(T) + 31) / 32) * 32 / (int)sizeof(T) + 32 / (int)sizeof(T);
}
// fp32 accumulator staging tiles: a multiple of 4 floats (WMMA store rule).
__host__ __device__ constexpr int acc_ld(int cols) { return cols + 8; }

__host__ __device__ constexpr size_t align128(size_t n) { return (n + 127) & ~size_t(127); }

// Copy rows [row0, row0 + nrows) x cols [col0, col0 + ncols) of a row-major
// global matrix (row stride `ld`) into shared memory (row stride `ldd`).
// Rows outside [0, valid_rows) read as zero; `slope_on` applies the leaky
// ReLU in fp32 and rounds back to T (the TPU kernel's order). ncols must be a
// multiple of 16 / sizeof(T), and `src` 16-byte aligned at each row start.
template <typename T>
__device__ __forceinline__ void load_rows(T* dst, int ldd, const T* src, int ld,
                                          int row0, int nrows, int valid_rows,
                                          int col0, int ncols, bool slope_on,
                                          float slope) {
  constexpr int V = 16 / sizeof(T);
  const int vpr = ncols / V;
  for (int i = threadIdx.x; i < nrows * vpr; i += blockDim.x) {
    const int r = i / vpr, c = (i % vpr) * V;
    const int g = row0 + r;
    uint4 raw = make_uint4(0, 0, 0, 0);
    if (g >= 0 && g < valid_rows) {
      raw = *reinterpret_cast<const uint4*>(src + (size_t)g * ld + col0 + c);
      if (slope_on) {
        T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
        for (int q = 0; q < V; ++q) e[q] = from_f<T>(leaky(to_f(e[q]), slope));
      }
    }
    *reinterpret_cast<uint4*>(dst + (size_t)r * ldd + c) = raw;
  }
}

// C(BM x BN) += A(BM x K) @ B(K x BN); A, B row-major in shared memory.
// WM x WN warps tile the output; the block has exactly 32*WM*WN threads.
template <typename T, int BM, int BN, int WM, int WN> struct TileAcc;

template <int BM, int BN, int WM, int WN> struct TileAcc<bf16, BM, BN, WM, WN> {
  static_assert(BM % (16 * WM) == 0 && BN % (16 * WN) == 0, "tile/warp mismatch");
  static constexpr int FM = BM / (16 * WM), FN = BN / (16 * WN);
  nvcuda::wmma::fragment<nvcuda::wmma::accumulator, 16, 16, 16, float> c[FM][FN];
  int r0, c0;

  __device__ void zero() {
    const int warp = threadIdx.x / 32;
    r0 = (warp / WN) * FM * 16;
    c0 = (warp % WN) * FN * 16;
#pragma unroll
    for (int i = 0; i < FM; ++i)
#pragma unroll
      for (int j = 0; j < FN; ++j) nvcuda::wmma::fill_fragment(c[i][j], 0.f);
  }
  // K a multiple of 16; lda, ldb multiples of 16 elements; A, B 32-byte aligned.
  __device__ void mma(const bf16* A, int lda, const bf16* B, int ldb, int K) {
    using namespace nvcuda;
    for (int kk = 0; kk < K; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[FM];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b[FN];
#pragma unroll
      for (int i = 0; i < FM; ++i)
        wmma::load_matrix_sync(a[i], A + (size_t)(r0 + i * 16) * lda + kk, lda);
#pragma unroll
      for (int j = 0; j < FN; ++j)
        wmma::load_matrix_sync(b[j], B + (size_t)kk * ldb + c0 + j * 16, ldb);
#pragma unroll
      for (int i = 0; i < FM; ++i)
#pragma unroll
        for (int j = 0; j < FN; ++j) wmma::mma_sync(c[i][j], a[i], b[j], c[i][j]);
    }
  }
  __device__ void store(float* C, int ldc) {
#pragma unroll
    for (int i = 0; i < FM; ++i)
#pragma unroll
      for (int j = 0; j < FN; ++j)
        nvcuda::wmma::store_matrix_sync(C + (size_t)(r0 + i * 16) * ldc + c0 + j * 16,
                                        c[i][j], ldc, nvcuda::wmma::mem_row_major);
  }
  __device__ void load(const float* C, int ldc) {
    const int warp = threadIdx.x / 32;
    r0 = (warp / WN) * FM * 16;
    c0 = (warp % WN) * FN * 16;
#pragma unroll
    for (int i = 0; i < FM; ++i)
#pragma unroll
      for (int j = 0; j < FN; ++j)
        nvcuda::wmma::load_matrix_sync(c[i][j], C + (size_t)(r0 + i * 16) * ldc + c0 + j * 16,
                                       ldc, nvcuda::wmma::mem_row_major);
  }
};

template <int BM, int BN, int WM, int WN> struct TileAcc<float, BM, BN, WM, WN> {
  static constexpr int NT = 32 * WM * WN;
  static_assert((BM * BN) % NT == 0, "tile/thread mismatch");
  static constexpr int PER = BM * BN / NT;
  float c[PER];

  __device__ void zero() {
#pragma unroll
    for (int i = 0; i < PER; ++i) c[i] = 0.f;
  }
  __device__ void mma(const float* A, int lda, const float* B, int ldb, int K) {
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int e = threadIdx.x + i * NT, r = e / BN, col = e % BN;
      float s = c[i];
      for (int k = 0; k < K; ++k) s = fmaf(A[(size_t)r * lda + k], B[(size_t)k * ldb + col], s);
      c[i] = s;
    }
  }
  __device__ void store(float* C, int ldc) {
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int e = threadIdx.x + i * NT;
      C[(size_t)(e / BN) * ldc + e % BN] = c[i];
    }
  }
  __device__ void load(const float* C, int ldc) {
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int e = threadIdx.x + i * NT;
      c[i] = C[(size_t)(e / BN) * ldc + e % BN];
    }
  }
};

// Host side: opt in to more than 48 KB of dynamic shared memory, launch, and
// report the launch error (a refused launch never runs, and a later
// synchronize would not report it).
template <typename Kernel, typename... Args>
inline int launch(Kernel kernel, dim3 grid, dim3 block, size_t smem, cudaStream_t stream,
                  Args... args) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, block, smem, stream>>>(args...);
  return (int)cudaGetLastError();
}

}  // namespace dm
