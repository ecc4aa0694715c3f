// Fused BasicTransformerBlock on Hopper: self-attention, up to two
// cross-attention streams (AudioLDM2's dual conditioning), GEGLU FF.
//
// Replaces diffmusic_tpu/pallas/transformer_kernel.py::fused_transformer_block
// (self-attention and dual-cross modes, each with or without the bounded
// softmax of its self-attention: common.cuh HeadAttention). One thread block
// per (batch, 32-row query tile):
//   LN1 -> Q projection -> per-head online softmax over all T keys
//   -> output projection + residual
//   -> per cross stream i: LN2_i -> Q_i projection -> online softmax over the
//      stream's Tk_i keys with the mask's additive bias -> output projection
//      + bias + residual
//   -> LN3 -> GEGLU FF (exact erf GELU), chunked over the 4C hidden width
//   -> + residual.
// The self K/V and each stream's K/V are projected outside with torch.matmul,
// as the JAX wrapper does; every other intermediate stays in shared memory and
// the (T, T) logits never exist in device memory.
//
// Bound: at head_dim 8 the self-attention is ~T*T*heads*(2*8+2) scalar
// operations per call -- far below the bf16 MMA depth of 16, so QK^T and PV
// are scalar fp32 FMAs (common.cuh HeadAttention, shared with the flash
// kernel). The projections and the FF are (32, C) @ (C, N) products on the
// tensor cores (common.cuh TileAcc); their weights (up to 256 x 2048 bf16 for
// the FF, 256 x 256 for each stream's wq_i and wo_i) do not fit in shared
// memory beside the activations and stream through L2 in 32-row tiles.
#include "common.cuh"

namespace {

using dm::bf16;
constexpr int QB = 32;         // query rows per block
constexpr int BN = 64, BK = 32, HC = 64, KT = 32;
constexpr int THREADS = 256;   // 8 warps
constexpr int MAXP = 4;        // (row, head) pairs per thread: heads <= 32
constexpr int MAX_CROSS = 2;

struct Layout {
  int ldr, lda, ldb, ldc, ldg, ldk;
  size_t res, abuf, qbuf, bt, st_a, st_g, gbuf, kv, bs, total;
};

// The cross-attention streams: projected keys and values (B, Tk, C), the
// additive logit bias (B, Tk) fp32 in natural-log units, and the stream's
// LN2 scale/bias, wq (C, C), wo (C, C), bo (C).
template <typename T>
struct Cross {
  const T* k[MAX_CROSS];
  const T* v[MAX_CROSS];
  const float* bias[MAX_CROSS];
  const T* ln_s[MAX_CROSS];
  const T* ln_b[MAX_CROSS];
  const T* wq[MAX_CROSS];
  const T* wo[MAX_CROSS];
  const T* bo[MAX_CROSS];
  int tk[MAX_CROSS];
  int n;
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
  L.bs = o;   o += dm::align128((size_t)KT * sizeof(float));
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

// res += softmax-attention(q = A @ wq over the keys kg / vg) @ wo + bo, where A
// (QB x C, smem) holds the layer-normed rows; q is rounded to T like the keys
// it meets, and the attention output to T for the product with wo.
template <typename T>
__device__ __forceinline__ void attention_residual(T* abuf, T* qbuf, float* res, const T* wq, const T* wo,
                                   const T* bo, const T* kg, const T* vg, int Tk,
                                   const float* bias, const float* kmax, int heads, int C,
                                   float scale_log2e, const Layout& L, T* bt, float* st_a, T* ks,
                                   T* vs, float* bs) {
  for (int n0 = 0; n0 < C; n0 += BN) {
    dm::TileAcc<T, QB, BN, 2, 4> acc;
    acc.zero();
    project<T>(acc, abuf, L.lda, wq, C, C, n0, bt, L.ldb);
    acc.store(st_a, L.ldc);
    __syncthreads();
    for (int e = threadIdx.x; e < QB * BN; e += THREADS)
      qbuf[(size_t)(e / BN) * L.lda + n0 + e % BN] = dm::from_f<T>(st_a[(e / BN) * L.ldc + e % BN]);
  }
  __syncthreads();
  {
    dm::HeadAttention<T, MAXP, KT> att;
    att.begin(qbuf, L.lda, heads, QB, QB, scale_log2e, kmax);
    att.run(kg, vg, C, Tk, bias, ks, vs, L.ldk, bs);
    att.end(abuf, L.lda, QB);
  }
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
                         const Cross<T> cross, const float* __restrict__ kmax,
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
  float* bs = reinterpret_cast<float*>(smem + L.bs);

  const int t0 = blockIdx.x * QB, b = blockIdx.y;
  const int heads = C / 8, C4 = 4 * C;
  const size_t base = (size_t)b * Tlen * C;

  // x tile -> fp32 residual stream (rows past T are zero and never stored)
  for (int e = threadIdx.x; e < QB * C; e += THREADS) {
    const int r = e / C, c = e % C, t = t0 + r;
    res[(size_t)r * L.ldr + c] = t < Tlen ? dm::to_f(x[base + (size_t)t * C + c]) : 0.f;
  }
  __syncthreads();
  layer_norm<T>(res, L.ldr, abuf, L.lda, ln1_s, ln1_b, C);

  // self-attention: q = LN1(x) @ wq, attention over all T keys, @ wo + bo;
  // kmax (B, heads), if given, bounds the softmax
  attention_residual<T>(abuf, qbuf, res, wq, wo, bo, kx + base, vx + base, Tlen, nullptr,
                        kmax ? kmax + (size_t)b * heads : nullptr, heads, C, scale_log2e, L,
                        bt, st_a, ks, vs, bs);
  // cross streams, in order: res += attn(LN2_i(res) @ wq_i, K_i, V_i) @ wo_i + bo_i
  for (int i = 0; i < cross.n; ++i) {
    __syncthreads();
    layer_norm<T>(res, L.ldr, abuf, L.lda, cross.ln_s[i], cross.ln_b[i], C);
    const size_t cbase = (size_t)b * cross.tk[i];
    attention_residual<T>(abuf, qbuf, res, cross.wq[i], cross.wo[i], cross.bo[i],
                          cross.k[i] + cbase * C, cross.v[i] + cbase * C, cross.tk[i],
                          cross.bias[i] + cbase, nullptr, heads, C, scale_log2e, L, bt, st_a,
                          ks, vs, bs);
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
int run(const void* const* a, void* out, int B, int Tlen, int C, int n_cross, const int* tk,
        float scale_log2e, const float* kmax, cudaStream_t s) {
  Cross<T> cross = {};
  cross.n = n_cross;
  for (int i = 0; i < n_cross; ++i) {
    const void* const* c = a + 14 + 8 * i;
    cross.k[i] = (const T*)c[0];
    cross.v[i] = (const T*)c[1];
    cross.bias[i] = (const float*)c[2];
    cross.ln_s[i] = (const T*)c[3];
    cross.ln_b[i] = (const T*)c[4];
    cross.wq[i] = (const T*)c[5];
    cross.wo[i] = (const T*)c[6];
    cross.bo[i] = (const T*)c[7];
    cross.tk[i] = tk[i];
  }
  dim3 grid((Tlen + QB - 1) / QB, B);
  return dm::launch(transformer_block_kernel<T>, grid, dim3(THREADS), layout<T>(C).total, s,
                    (const T*)a[0], (const T*)a[1], (const T*)a[2], (const T*)a[3],
                    (const T*)a[4], (const T*)a[5], (const T*)a[6], (const T*)a[7],
                    (const T*)a[8], (const T*)a[9], (const T*)a[10], (const T*)a[11],
                    (const T*)a[12], (const T*)a[13], cross, kmax, (T*)out, Tlen, C,
                    scale_log2e);
}

}  // namespace

// args: x, k, v, ln1_scale, ln1_bias, wq, wo, bo, ln3_scale, ln3_bias, wi, bi,
// wo2, bo2 (14 device pointers), then per cross stream i < n_cross (at most 2):
// k_i, v_i, bias_i (fp32), ln2_scale_i, ln2_bias_i, wq_i, wo_i, bo_i, whose
// keys number tk0 and tk1. kmax: null, or (B, C / 8) fp32 key-norm maxima for
// the bounded softmax. dtype: 0 = float32, 1 = bfloat16.
extern "C" int dm_transformer_block(int dtype, const void* const* args, void* out, int B,
                                    int Tlen, int C, int n_cross, int tk0, int tk1,
                                    float scale_log2e, const void* kmax, void* stream) {
  if (n_cross < 0 || n_cross > MAX_CROSS) return (int)cudaErrorInvalidValue;
  const int tk[MAX_CROSS] = {tk0, tk1};
  cudaStream_t s = (cudaStream_t)stream;
  const float* km = (const float*)kmax;
  if (dtype == 1) return run<bf16>(args, out, B, Tlen, C, n_cross, tk, scale_log2e, km, s);
  return run<float>(args, out, B, Tlen, C, n_cross, tk, scale_log2e, km, s);
}

extern "C" size_t dm_transformer_block_smem(int dtype, int C) {
  return dtype == 1 ? layout<bf16>(C).total : layout<float>(C).total;
}
