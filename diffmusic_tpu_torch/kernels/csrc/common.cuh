// Shared device routines of the port's Hopper kernels (sm_90a).
//
// The exact fp32 paths, for the card-against-CPU reference runs, are sums of
// (rows, K) @ (K, cols) products over tiles staged in shared memory: the
// conv1d kernels accumulate one product per tap over a haloed time window,
// the upsampler one per phase tap, the transformer block its projections and
// feed-forward, the stage backward its adjoint convs. `TileAcc<float>` is
// that product, written once, as scalar FMAs (exact fp32, no TF32); the
// accumulator tile is read from / written to fp32 shared memory, where the
// kernels apply their epilogues. Every bf16 kernel keeps its own
// tensor-core path: the conv1d kernels and the stage backward's passes, the
// conv2d and the upsampler on TMA and wgmma (hopper.cuh), the flash attention
// and the transformer block on mma.sync (mma_attention.cuh).
//
// `HeadAttention` is the exact fp32 attention core at head_dim 8 that the
// fp32 transformer block and the fp32 flash kernel use, for the
// card-against-CPU reference runs: an online softmax over key chunks staged
// in shared memory, with QK^T and PV as scalar fp32 FMAs, one thread per
// (row, head) pair. The bf16 kernels run their attention on mma.sync
// (mma_attention.cuh).
#pragma once

#include <math_constants.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
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
// for the 16-byte row loads, plus 32 bytes of skew against bank conflicts.
template <typename T> __host__ __device__ constexpr int smem_ld(int cols) {
  return ((cols * (int)sizeof(T) + 31) / 32) * 32 / (int)sizeof(T) + 32 / (int)sizeof(T);
}
// fp32 accumulator staging tiles: a multiple of 4 floats (16-byte rows).
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

// The transpose of rows [row0, row0 + nrows) x cols [col0, col0 + ncols) of a
// row-major global matrix into shared memory: dst[c * ldd + r] = src[row0 + r,
// col0 + c]. The adjoint convolutions read a weight tap w[j] (Cin, Cout) as
// its transpose this way, so no transposed weight copy is ever made. ncols a
// multiple of 16 / sizeof(T); every row read must exist.
template <typename T>
__device__ __forceinline__ void load_rows_t(T* dst, int ldd, const T* src, int ld, int row0,
                                            int nrows, int col0, int ncols) {
  constexpr int V = 16 / sizeof(T);
  const int vpr = ncols / V;
  for (int i = threadIdx.x; i < nrows * vpr; i += blockDim.x) {
    const int r = i / vpr, c = (i % vpr) * V;
    const uint4 raw = *reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * ld + col0 + c);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int q = 0; q < V; ++q) dst[(size_t)(c + q) * ldd + r] = e[q];
  }
}

// C(BM x BN) += A(BM x K) @ B(K x BN); A, B row-major in shared memory.
// WM x WN warps tile the output; the block has exactly 32*WM*WN threads.
// fp32 only: the bf16 kernels run on the tensor cores.
template <typename T, int BM, int BN, int WM, int WN> struct TileAcc;

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
  template <typename F>
  __device__ void for_each(float*, int, F f) {
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int e = threadIdx.x + i * NT;
      f(e / BN, e % BN, c[i]);
    }
  }
};

// Eight consecutive elements (16-byte aligned) to / from fp32 registers.
template <typename T>
__device__ __forceinline__ void load8(const T* p, float* out);
template <>
__device__ __forceinline__ void load8<float>(const float* p, float* out) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
}
template <>
__device__ __forceinline__ void load8<bf16>(const bf16* p, float* out) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const bf16* e = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
  for (int i = 0; i < 8; ++i) out[i] = __bfloat162float(e[i]);
}
template <typename T>
__device__ __forceinline__ void store8(T* p, const float* v);
template <>
__device__ __forceinline__ void store8<float>(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  *reinterpret_cast<float4*>(p + 4) = make_float4(v[4], v[5], v[6], v[7]);
}
template <>
__device__ __forceinline__ void store8<bf16>(bf16* p, const float* v) {
  uint4 raw;
  bf16* e = reinterpret_cast<bf16*>(&raw);
#pragma unroll
  for (int i = 0; i < 8; ++i) e[i] = __float2bfloat16_rn(v[i]);
  *reinterpret_cast<uint4*>(p) = raw;
}

// Softmax attention at head_dim 8 of NP (query row, head) pairs per thread.
// Pair p = threadIdx.x + i * blockDim.x is query row p / heads, head p % heads:
// a warp's threads cover consecutive heads of one or two rows, so the key and
// value row segment they read from shared memory is contiguous (a broadcast,
// no bank conflicts). Logits are in log2 units (q pre-scaled by
// log2(e) / sqrt(8)), so the softmax runs on exp2f. Every thread of the block
// calls each method: `run` synchronises the block.
//
// Bounded softmax (the JAX package's DIFFMUSIC_TPU_BSOFT): given kmax, the
// largest key norm of each head, the shift of row r is fixed from the start
// at the Cauchy-Schwarz bound ||q_r|| * kmax * scale_log2e >= max_k s_rk (the
// norm of the rounded q the logits are made of), so there is no running max
// and no rescale; the denominator is guarded with max(l, 1e-37), since a
// slack bound scales every p of the row by 2^-slack.
template <typename T, int NP, int KT>
struct HeadAttention {
  static constexpr int HD = 8;
  float q[NP][HD], o[NP][HD], m[NP], l[NP];
  int heads, npairs;
  bool bounded;

  // q of (row r, head h) at src[r * ld + h * 8] times scale_log2e; rows at or
  // past rows_valid read as zero. kmax, if not null, holds one key-norm bound
  // per head and turns on the bounded softmax.
  __device__ __forceinline__ void begin(const T* src, size_t ld, int nheads, int rows,
                                        int rows_valid, float scale_log2e,
                                        const float* kmax = nullptr) {
    heads = nheads;
    npairs = rows * nheads;
    bounded = kmax != nullptr;
#pragma unroll
    for (int i = 0; i < NP; ++i) {
      const int p = threadIdx.x + i * blockDim.x;
      m[i] = bounded ? 0.f : -CUDART_INF_F;
      l[i] = 0.f;
#pragma unroll
      for (int d = 0; d < HD; ++d) o[i][d] = q[i][d] = 0.f;
      if (p < npairs && p / heads < rows_valid) {
        load8<T>(src + (size_t)(p / heads) * ld + (p % heads) * HD, q[i]);
        if (bounded) {
          float n2 = 0.f;
#pragma unroll
          for (int d = 0; d < HD; ++d) n2 = fmaf(q[i][d], q[i][d], n2);
          m[i] = sqrtf(n2) * kmax[p % heads] * scale_log2e;
        }
#pragma unroll
        for (int d = 0; d < HD; ++d) q[i][d] *= scale_log2e;
      }
    }
  }

  // Attend over keys [0, Tk) of kg / vg (row stride C), staged KT rows at a
  // time in ks / vs (row stride ldk, 16-byte aligned). bias, if not null,
  // holds one additive logit bias per key in natural-log units (the mask's
  // 0 / -1e9), staged in bs (KT floats). Keys past Tk are masked here.
  __device__ __forceinline__ void run(const T* kg, const T* vg, int C, int Tk,
                                      const float* bias, T* ks, T* vs, int ldk, float* bs) {
    for (int kt0 = 0; kt0 < Tk; kt0 += KT) {
      const int nk = min(KT, Tk - kt0);
      __syncthreads();
      load_rows(ks, ldk, kg, C, kt0, KT, Tk, 0, C, false, 0.f);
      load_rows(vs, ldk, vg, C, kt0, KT, Tk, 0, C, false, 0.f);
      if (bias != nullptr)
        for (int j = threadIdx.x; j < KT; j += blockDim.x)
          bs[j] = j < nk ? bias[kt0 + j] * 1.4426950408889634f : 0.f;
      __syncthreads();
#pragma unroll
      for (int i = 0; i < NP; ++i) {
        const int p = threadIdx.x + i * blockDim.x;
        if (p >= npairs) continue;
        const int hoff = (p % heads) * HD;
        float s[KT];
        float mc = m[i];
#pragma unroll
        for (int j = 0; j < KT; ++j) {
          float kv[HD];
          load8<T>(ks + (size_t)j * ldk + hoff, kv);
          float acc = bias != nullptr ? bs[j] : 0.f;
#pragma unroll
          for (int d = 0; d < HD; ++d) acc = fmaf(q[i][d], kv[d], acc);
          s[j] = j < nk ? acc : -CUDART_INF_F;
          if (!bounded) mc = fmaxf(mc, s[j]);
        }
        if (!bounded) {
          const float corr = exp2f(m[i] - mc);   // 0 on the first chunk (m = -inf)
          l[i] *= corr;
#pragma unroll
          for (int d = 0; d < HD; ++d) o[i][d] *= corr;
          m[i] = mc;
        }
#pragma unroll
        for (int j = 0; j < KT; ++j) {
          const float pj = exp2f(s[j] - mc);
          float vv[HD];
          load8<T>(vs + (size_t)j * ldk + hoff, vv);
          l[i] += pj;
#pragma unroll
          for (int d = 0; d < HD; ++d) o[i][d] = fmaf(pj, vv[d], o[i][d]);
        }
      }
    }
  }

  // The normalised output of (row r, head h) to dst[r * ld + h * 8], rounded
  // to T; rows at or past rows_valid are not written.
  __device__ __forceinline__ void end(T* dst, size_t ld, int rows_valid) {
#pragma unroll
    for (int i = 0; i < NP; ++i) {
      const int p = threadIdx.x + i * blockDim.x;
      if (p >= npairs || p / heads >= rows_valid) continue;
      const float inv = 1.f / (bounded ? fmaxf(l[i], 1e-37f) : l[i]);
      float r[HD];
#pragma unroll
      for (int d = 0; d < HD; ++d) r[d] = o[i][d] * inv;
      store8<T>(dst + (size_t)(p / heads) * ld + (p % heads) * HD, r);
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
