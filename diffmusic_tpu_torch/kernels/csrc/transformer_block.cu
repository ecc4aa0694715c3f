// Fused self-attention BasicTransformerBlock on Hopper.
//
// Replaces diffmusic_tpu/pallas/transformer_kernel.py::fused_transformer_block
// (self-attention mode). One thread block per (batch, 32-row query tile):
//   LN1 -> Q projection -> per-head online softmax over all T keys
//   -> output projection + residual -> LN3 -> GEGLU FF (exact erf GELU),
//   chunked over the 4C hidden width -> + residual.
// K and V are projected outside from LN1(x) with torch.matmul, as the JAX
// wrapper does; every other intermediate stays in shared memory and the
// (T, T) logits never exist in device memory.
//
// Bound: at MusicLDM's head_dim 8 the attention is ~T*T*heads*(2*8+2) scalar
// operations per call -- far below the bf16 MMA depth of 16, so QK^T and PV
// are scalar fp32 FMAs here (no padding to 16: half of every MMA would
// multiply zeros). Each thread owns (row, head) pairs; a warp's 32 threads
// cover consecutive heads of one or two rows, so the K/V chunk it reads from
// shared memory is one contiguous row segment (broadcast, no bank conflicts).
// The projections and the FF are (32, C) @ (C, N) products on the tensor
// cores (common.cuh TileAcc); their weights (up to 256 x 2048 bf16 for the FF)
// do not fit in shared memory and stream through L2 in 32-row tiles.
#include <math_constants.h>

#include "common.cuh"

namespace {

using dm::bf16;
constexpr int QB = 32;         // query rows per block
constexpr int BN = 64, BK = 32, HC = 64, KT = 32;
constexpr int THREADS = 256;   // 8 warps
constexpr int HD = 8;          // head_dim
constexpr int MAXP = 4;        // (row, head) pairs per thread: heads <= 32

struct Layout {
  int ldr, lda, ldb, ldc, ldg, ldk;
  size_t res, abuf, qbuf, bt, st_a, st_g, gbuf, kv, total;
};

template <typename T>
__host__ __device__ Layout layout(int C) {
  Layout L;
  L.ldr = C + 4;                       // fp32 residual stream
  L.lda = dm::smem_ld<T>(C);           // LN output / attention output
  L.ldb = dm::smem_ld<T>(BN);          // streamed weight tile
  L.ldc = dm::acc_ld(BN);              // fp32 staging
  L.ldg = dm::smem_ld<T>(HC);          // GEGLU chunk
  L.ldk = C + 16 / (int)sizeof(T);     // K/V chunk rows (16-byte aligned)
  size_t o = 0;
  L.res = o;  o += dm::align128((size_t)QB * L.ldr * sizeof(float));
  L.abuf = o; o += dm::align128((size_t)QB * L.lda * sizeof(T));
  L.qbuf = o; o += dm::align128((size_t)QB * L.lda * sizeof(T));
  L.bt = o;   o += dm::align128((size_t)BK * L.ldb * sizeof(T));
  L.st_a = o; o += dm::align128((size_t)QB * L.ldc * sizeof(float));
  L.st_g = o; o += dm::align128((size_t)QB * L.ldc * sizeof(float));
  L.gbuf = o; o += dm::align128((size_t)QB * L.ldg * sizeof(T));
  L.kv = o;   o += dm::align128((size_t)2 * KT * L.ldk * sizeof(T));
  L.total = o;
  return L;
}

// acc(QB x BN) = A(QB x K, smem) @ W[:, n0:n0+BN] (W global, row stride ldw)
template <typename T>
__device__ void project(dm::TileAcc<T, QB, BN, 2, 4>& acc, const T* A, int lda, const T* W,
                        int ldw, int K, int n0, T* bt, int ldb) {
  for (int kc = 0; kc < K; kc += BK) {
    __syncthreads();
    dm::load_rows(bt, ldb, W, ldw, kc, BK, K, n0, BN, false, 0.f);
    __syncthreads();
    acc.mma(A + kc, lda, bt, ldb, BK);
  }
  __syncthreads();
}

// LayerNorm (fp32 statistics, two-pass variance, eps 1e-6) of the fp32 rows
// `src` into T rows `dst`; one warp per row.
template <typename T>
__device__ void layer_norm(const float* src, int lds, T* dst, int ldd, const T* scale,
                           const T* bias, int C) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < QB; r += THREADS / 32) {
    const float* row = src + (size_t)r * lds;
    float s = 0.f;
    for (int c = lane; c < C; c += 32) s += row[c];
    for (int o = 16; o; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    const float mu = s / C;
    float v = 0.f;
    for (int c = lane; c < C; c += 32) v += (row[c] - mu) * (row[c] - mu);
    for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    const float inv = rsqrtf(v / C + 1e-6f);
    for (int c = lane; c < C; c += 32)
      dst[(size_t)r * ldd + c] =
          dm::from_f<T>((row[c] - mu) * inv * dm::to_f(scale[c]) + dm::to_f(bias[c]));
  }
}

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
__global__ void __launch_bounds__(THREADS)
transformer_block_kernel(const T* __restrict__ x, const T* __restrict__ kx,
                         const T* __restrict__ vx, const T* __restrict__ ln1_s,
                         const T* __restrict__ ln1_b, const T* __restrict__ wq,
                         const T* __restrict__ wo, const T* __restrict__ bo,
                         const T* __restrict__ ln3_s, const T* __restrict__ ln3_b,
                         const T* __restrict__ wi, const T* __restrict__ bi,
                         const T* __restrict__ wo2, const T* __restrict__ bo2,
                         T* __restrict__ out, int Tlen, int C, float scale_log2e) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout L = layout<T>(C);
  float* res = reinterpret_cast<float*>(smem + L.res);
  T* abuf = reinterpret_cast<T*>(smem + L.abuf);
  T* qbuf = reinterpret_cast<T*>(smem + L.qbuf);
  T* bt = reinterpret_cast<T*>(smem + L.bt);
  float* st_a = reinterpret_cast<float*>(smem + L.st_a);
  float* st_g = reinterpret_cast<float*>(smem + L.st_g);
  T* gbuf = reinterpret_cast<T*>(smem + L.gbuf);
  T* ks = reinterpret_cast<T*>(smem + L.kv);
  T* vs = ks + (size_t)KT * L.ldk;

  const int t0 = blockIdx.x * QB, b = blockIdx.y;
  const int heads = C / HD, C4 = 4 * C;
  const size_t base = (size_t)b * Tlen * C;

  // x tile -> fp32 residual stream (rows past T are zero and never stored)
  for (int e = threadIdx.x; e < QB * C; e += THREADS) {
    const int r = e / C, c = e % C, t = t0 + r;
    res[(size_t)r * L.ldr + c] = t < Tlen ? dm::to_f(x[base + (size_t)t * C + c]) : 0.f;
  }
  __syncthreads();
  layer_norm<T>(res, L.ldr, abuf, L.lda, ln1_s, ln1_b, C);

  // q = LN1(x) @ wq, rounded to T like the keys it meets
  for (int n0 = 0; n0 < C; n0 += BN) {
    dm::TileAcc<T, QB, BN, 2, 4> acc;
    acc.zero();
    project<T>(acc, abuf, L.lda, wq, C, C, n0, bt, L.ldb);
    acc.store(st_a, L.ldc);
    __syncthreads();
    for (int e = threadIdx.x; e < QB * BN; e += THREADS)
      qbuf[(size_t)(e / BN) * L.lda + n0 + e % BN] = dm::from_f<T>(st_a[(e / BN) * L.ldc + e % BN]);
  }

  // attention: thread owns pairs p = tid + i*THREADS, row = p / heads, head = p % heads
  const int npairs = QB * heads;
  float q[MAXP][HD], o[MAXP][HD], m[MAXP], l[MAXP];
  __syncthreads();
#pragma unroll
  for (int i = 0; i < MAXP; ++i) {
    const int p = threadIdx.x + i * THREADS;
    m[i] = -CUDART_INF_F;
    l[i] = 0.f;
#pragma unroll
    for (int d = 0; d < HD; ++d) {
      o[i][d] = 0.f;
      q[i][d] = p < npairs
          ? dm::to_f(qbuf[(size_t)(p / heads) * L.lda + (p % heads) * HD + d]) * scale_log2e
          : 0.f;
    }
  }
  for (int kt0 = 0; kt0 < Tlen; kt0 += KT) {
    const int nk = min(KT, Tlen - kt0);
    __syncthreads();
    dm::load_rows(ks, L.ldk, kx + base, C, kt0, KT, Tlen, 0, C, false, 0.f);
    dm::load_rows(vs, L.ldk, vx + base, C, kt0, KT, Tlen, 0, C, false, 0.f);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < MAXP; ++i) {
      const int p = threadIdx.x + i * THREADS;
      if (p >= npairs) continue;
      const int hoff = (p % heads) * HD;
      float s[KT];
      float mc = m[i];
#pragma unroll
      for (int j = 0; j < KT; ++j) {
        float kv[HD];
        load8<T>(ks + (size_t)j * L.ldk + hoff, kv);
        float acc = 0.f;
#pragma unroll
        for (int d = 0; d < HD; ++d) acc = fmaf(q[i][d], kv[d], acc);
        s[j] = j < nk ? acc : -CUDART_INF_F;
        mc = fmaxf(mc, s[j]);
      }
      const float corr = exp2f(m[i] - mc);   // 0 on the first chunk (m = -inf)
      l[i] *= corr;
#pragma unroll
      for (int d = 0; d < HD; ++d) o[i][d] *= corr;
      m[i] = mc;
#pragma unroll
      for (int j = 0; j < KT; ++j) {
        const float pj = exp2f(s[j] - mc);
        float vv[HD];
        load8<T>(vs + (size_t)j * L.ldk + hoff, vv);
        l[i] += pj;
#pragma unroll
        for (int d = 0; d < HD; ++d) o[i][d] = fmaf(pj, vv[d], o[i][d]);
      }
    }
  }
  // attention output (concatenated heads) -> abuf, rounded to T for the dot
#pragma unroll
  for (int i = 0; i < MAXP; ++i) {
    const int p = threadIdx.x + i * THREADS;
    if (p >= npairs) continue;
    const float inv = 1.f / l[i];
#pragma unroll
    for (int d = 0; d < HD; ++d)
      abuf[(size_t)(p / heads) * L.lda + (p % heads) * HD + d] = dm::from_f<T>(o[i][d] * inv);
  }

  // res1 = x + attn @ wo + bo
  for (int n0 = 0; n0 < C; n0 += BN) {
    dm::TileAcc<T, QB, BN, 2, 4> acc;
    acc.zero();
    project<T>(acc, abuf, L.lda, wo, C, C, n0, bt, L.ldb);
    acc.store(st_a, L.ldc);
    __syncthreads();
    for (int e = threadIdx.x; e < QB * BN; e += THREADS) {
      const int r = e / BN, c = e % BN;
      res[(size_t)r * L.ldr + n0 + c] += st_a[r * L.ldc + c] + dm::to_f(bo[n0 + c]);
    }
  }
  __syncthreads();
  layer_norm<T>(res, L.ldr, abuf, L.lda, ln3_s, ln3_b, C);
  __syncthreads();
  // the FF accumulates into the residual stream: start it at res1 + bo2
  for (int e = threadIdx.x; e < QB * C; e += THREADS)
    res[(size_t)(e / C) * L.ldr + e % C] += dm::to_f(bo2[e % C]);

  // GEGLU FF, chunked over the 4C hidden width
  for (int h0 = 0; h0 < C4; h0 += HC) {
    dm::TileAcc<T, QB, BN, 2, 4> acc;
    acc.zero();
    project<T>(acc, abuf, L.lda, wi, 2 * C4, C, h0, bt, L.ldb);        // a
    acc.store(st_a, L.ldc);
    acc.zero();
    project<T>(acc, abuf, L.lda, wi, 2 * C4, C, C4 + h0, bt, L.ldb);   // gate
    acc.store(st_g, L.ldc);
    __syncthreads();
    for (int e = threadIdx.x; e < QB * HC; e += THREADS) {
      const int r = e / HC, c = e % HC;
      const float a = st_a[r * L.ldc + c] + dm::to_f(bi[h0 + c]);
      const float g = st_g[r * L.ldc + c] + dm::to_f(bi[C4 + h0 + c]);
      gbuf[(size_t)r * L.ldg + c] = dm::from_f<T>(a * 0.5f * g * (1.f + erff(g * 0.70710678118654752f)));
    }
    for (int n0 = 0; n0 < C; n0 += BN) {
      dm::TileAcc<T, QB, BN, 2, 4> y;
      __syncthreads();
      y.load(res + n0, L.ldr);
      project<T>(y, gbuf, L.ldg, wo2 + (size_t)h0 * C, C, HC, n0, bt, L.ldb);
      y.store(res + n0, L.ldr);
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < QB * C; e += THREADS) {
    const int r = e / C, c = e % C, t = t0 + r;
    if (t < Tlen) out[base + (size_t)t * C + c] = dm::from_f<T>(res[(size_t)r * L.ldr + c]);
  }
}

template <typename T>
int run(const void* const* a, void* out, int B, int Tlen, int C, float scale_log2e,
        cudaStream_t s) {
  dim3 grid((Tlen + QB - 1) / QB, B);
  return dm::launch(transformer_block_kernel<T>, grid, dim3(THREADS), layout<T>(C).total, s,
                    (const T*)a[0], (const T*)a[1], (const T*)a[2], (const T*)a[3],
                    (const T*)a[4], (const T*)a[5], (const T*)a[6], (const T*)a[7],
                    (const T*)a[8], (const T*)a[9], (const T*)a[10], (const T*)a[11],
                    (const T*)a[12], (const T*)a[13], (T*)out, Tlen, C, scale_log2e);
}

}  // namespace

// args: x, k, v, ln1_scale, ln1_bias, wq, wo, bo, ln3_scale, ln3_bias, wi, bi,
// wo2, bo2 (14 device pointers). dtype: 0 = float32, 1 = bfloat16.
extern "C" int dm_transformer_block(int dtype, const void* const* args, void* out, int B,
                                    int Tlen, int C, float scale_log2e, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 1) return run<bf16>(args, out, B, Tlen, C, scale_log2e, s);
  return run<float>(args, out, B, Tlen, C, scale_log2e, s);
}

extern "C" size_t dm_transformer_block_smem(int dtype, int C) {
  return dtype == 1 ? layout<bf16>(C).total : layout<float>(C).total;
}
