// Fused BasicTransformerBlock on Hopper: self-attention, up to two
// cross-attention streams (AudioLDM2's dual conditioning), GEGLU FF.
//
// Replaces diffmusic_tpu/pallas/transformer_kernel.py::fused_transformer_block
// (self-attention and dual-cross modes, each with or without the bounded
// softmax of its self-attention), per 32-row query tile:
//   LN1 -> Q projection -> per-head softmax attention over all T keys
//   -> output projection + residual
//   -> per cross stream i: LN2_i -> Q_i projection -> softmax over the
//      stream's Tk_i keys with the mask's additive bias -> output projection
//      + bias + residual
//   -> LN3 -> GEGLU FF (exact erf GELU) -> + residual.
// The self K/V and each stream's K/V are projected outside with torch.matmul,
// as the JAX wrapper does; every other intermediate stays on chip and the (T,
// T) logits never exist in device memory.
//
// Bound: the self-attention's exponentials, one exp2 per logit, T^2 * heads
// of them at 16 per clock per SM (the MUFU; 0.061 ms at T 4000, 16 heads,
// 0.0077 at T 1000, 32 heads), above the bytes (x, out and the weights once)
// and the tensor-core work (the projections and the FF, 32 T C^2, and the
// attention's products, 4 T^2 C).
//
// bf16: `block_mma_kernel`. The attention is the flash kernel's warp core
// (mma_attention.cuh): QK^T on mma.sync m16n8k8, an online softmax per
// 64-key chunk (bounded: the shift fixed at ||q_r|| * kmax_h, no rescale),
// P rounded to bf16 for PV on m16n8k16, key and value chunks through a
// double-buffered cp.async ring. The grid: one block per (32-row tile, 8
// heads), the n = heads / 8 blocks of a tile forming a cluster. A block of
// 16 warps owns 8 heads and 64 channels, the attention's own unit, one warp
// per (16 rows, head), so a 32-row tile gives n blocks: 250 at (T 4000, 16
// heads) and 128 at (T 1000, 32 heads) for 132 SMs, where one block per tile
// gave 125 and 32. (16-row tiles would give only 63 at T 1000; wgmma's 64-row
// tiles 16.) The split follows the heads through every product:
//   - each block computes the LayerNorms of its tile's rows itself, and q
//     only for its heads (LN @ wq[:, own 64 columns]);
//   - after the attention the blocks gather the cluster's attention outputs
//     (32 x C bf16) from each other's shared memory, and each computes the
//     output projection and the residual for its own 64 channels, then
//     gathers the other channels of the updated residual: two cluster
//     barriers per residual update, (n - 1) * 12 KB read across the cluster;
//   - the FF splits the 4C hidden units, 256 a block: a and gate for them
//     (LN3 @ wi[:, own a and gate columns]), g = a * gelu(gate) in bf16, and
//     the partial product g @ wo2[own 256 rows, :], which the cluster sums
//     for each block's own 64 output channels (a reduce-scatter) before the
//     one rounding and store.
// Each block thus reads 1/n of every weight. The projections are mma.sync
// m16n8k16 products of a (32, K) bf16 tile in shared memory with weight
// tiles streamed 32 rows at a time through a 3-stage cp.async ring, one
// barrier per 32 rows of K. The residual stream stays fp32 in shared memory;
// q, the attention output, LN outputs and g are rounded to bf16 as the JAX
// kernel rounds them, the output once.
//
// fp32: `transformer_block_kernel<float>`, the exact scalar path for the
// card-against-CPU reference runs: one block of 8 warps per 32-row tile, the
// attention in common.cuh's HeadAttention (one thread per (row, head) pair,
// fp32 FMAs), the products in TileAcc<float>, weights staged 32 rows at a
// time.
#include "common.cuh"
#include "hopper.cuh"
#include "mma_attention.cuh"

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
// `src` into T rows `dst`; one warp per row. The statistics are over the
// first Cn channels, the model's; the C - Cn past them are padding, whose
// zero scale and bias write zeros.
template <typename T>
__device__ void layer_norm(const float* src, int lds, T* dst, int ldd, const T* scale,
                           const T* bias, int C, int Cn) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < QB; r += THREADS / 32) {
    const float* row = src + (size_t)r * lds;
    float s = 0.f;
    for (int c = lane; c < Cn; c += 32) s += row[c];
    for (int o = 16; o; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    const float mu = s / Cn;
    float v = 0.f;
    for (int c = lane; c < Cn; c += 32) v += (row[c] - mu) * (row[c] - mu);
    for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    const float inv = rsqrtf(v / Cn + 1e-6f);
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

// The exact fp32 block (bf16 takes tc:: below).
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
                         T* __restrict__ out, int Tlen, int C, int Cn, float scale_log2e) {
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
  layer_norm<T>(res, L.ldr, abuf, L.lda, ln1_s, ln1_b, C, Cn);

  // self-attention: q = LN1(x) @ wq, attention over all T keys, @ wo + bo;
  // kmax (B, heads), if given, bounds the softmax
  attention_residual<T>(abuf, qbuf, res, wq, wo, bo, kx + base, vx + base, Tlen, nullptr,
                        kmax ? kmax + (size_t)b * heads : nullptr, heads, C, scale_log2e, L,
                        bt, st_a, ks, vs, bs);
  // cross streams, in order: res += attn(LN2_i(res) @ wq_i, K_i, V_i) @ wo_i + bo_i
  for (int i = 0; i < cross.n; ++i) {
    __syncthreads();
    layer_norm<T>(res, L.ldr, abuf, L.lda, cross.ln_s[i], cross.ln_b[i], C, Cn);
    const size_t cbase = (size_t)b * cross.tk[i];
    attention_residual<T>(abuf, qbuf, res, cross.wq[i], cross.wo[i], cross.bo[i],
                          cross.k[i] + cbase * C, cross.v[i] + cbase * C, cross.tk[i],
                          cross.bias[i] + cbase, nullptr, heads, C, scale_log2e, L, bt, st_a,
                          ks, vs, bs);
  }
  __syncthreads();
  layer_norm<T>(res, L.ldr, abuf, L.lda, ln3_s, ln3_b, C, Cn);
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

// ------------------------------------------------------ bf16: tensor cores
namespace tc {

using namespace dm::mma;   // KC, HEADS, LD, STAGES, the warp core and its primitives
using dm::hopper::cluster_sync;

constexpr int QB = 32;                    // query rows per block
constexpr int THREADS = 32 * 2 * HEADS;   // one warp per (16 rows, head)
constexpr int COLS = 8 * HEADS;           // channels per block
constexpr int HID = 4 * COLS;             // hidden units per block: 4C / n
constexpr int C_MAX = 4 * COLS;           // heads <= 32: at most 4 blocks a cluster
constexpr int WK = 32;                    // weight rows per ring stage
constexpr int WSTAGES = 3;
constexpr int RES_LD = C_MAX + 4;         // fp32 residual stream (and the FF's partials)
constexpr int A_LD = C_MAX + 8;           // bf16: LN outputs, gathered attention output, g
constexpr int Q_LD = COLS + 8;            // bf16: this block's q and attention output
constexpr int W_LD_MAX = 2 * HID + 8;     // the widest weight stage: a and gate
static_assert(THREADS == STAGE_THREADS, "one staged (key, head) slot per thread");
static_assert(HID == C_MAX, "g fits the LN buffer");

constexpr size_t cmax(size_t a, size_t b) { return a > b ? a : b; }
constexpr size_t OFF_RES = 0;
constexpr size_t OFF_A = OFF_RES + dm::align128((size_t)QB * RES_LD * 4);
constexpr size_t OFF_Q = OFF_A + dm::align128((size_t)QB * A_LD * 2);
constexpr size_t OFF_O = OFF_Q + dm::align128((size_t)QB * Q_LD * 2);
constexpr size_t OFF_BS = OFF_O + dm::align128((size_t)QB * Q_LD * 2);
constexpr size_t OFF_RING = OFF_BS + dm::align128((size_t)STAGES * KC * 4);
constexpr size_t RING = cmax(cmax((size_t)WSTAGES * WK * W_LD_MAX * 2, KV_BYTES),
                             (size_t)QB * RES_LD * 4);
constexpr size_t SMEM = OFF_RING + RING;

struct Stream {
  const bf16 *k, *v, *ln_s, *ln_b, *wq, *wo, *bo;
  const float* bias;   // (B, tk) additive logit bias, natural-log units
  int tk;
};

struct Params {
  const bf16 *x, *kx, *vx, *ln1_s, *ln1_b, *wq, *wo, *bo, *ln3_s, *ln3_b, *wi, *bi, *wo2, *bo2;
  Stream cross[MAX_CROSS];
  int n_cross;
  const float* kmax;   // (B, heads) key-norm maxima for the bounded softmax, or null
  bf16* out;
  int T, C, Cn;        // C: whole 64-channel slices; Cn <= C: the model's channels
  float scale_log2e;   // log2(e) / sqrt(8)
};

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

// this thread's address of p in the shared memory of block `rank` of the cluster
template <typename P>
__device__ __forceinline__ P* peer(P* p, int rank) {
  uint64_t out;
  asm volatile("mapa.u64 %0, %1, %2;" : "=l"(out) : "l"(p), "r"(rank));
  return reinterpret_cast<P*>(out);
}

// LayerNorm (fp32 statistics, two-pass variance, eps 1e-6) of the QB fp32 rows
// of res into bf16 rows of dst; one warp per row. The statistics are over the
// first Cn channels, the padding's zero scale and bias write zeros past them.
__device__ void layer_norm(const float* res, bf16* dst, const bf16* scale, const bf16* bias,
                           int C, int Cn) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < QB; r += THREADS / 32) {
    const float* row = res + (size_t)r * RES_LD;
    float s = 0.f;
    for (int c = lane; c < Cn; c += 32) s += row[c];
    for (int o = 16; o; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    const float mu = s / Cn;
    float v = 0.f;
    for (int c = lane; c < Cn; c += 32) v += (row[c] - mu) * (row[c] - mu);
    for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    const float inv = rsqrtf(v / Cn + 1e-6f);
    for (int c = lane; c < C; c += 32)
      dst[(size_t)r * A_LD + c] = __float2bfloat16_rn(
          (row[c] - mu) * inv * __bfloat162float(scale[c]) + __bfloat162float(bias[c]));
  }
}

// acc = A (QB x K, bf16 rows in shared memory, stride A_LD) @ W (K x N), N =
// NT * 64, for this warp's NT tiles of 16 rows x 8 columns. W is NSEG column
// segments of width N / NSEG: segment s is the global matrix at w[s] (row
// stride ldw, its first column there). Warp (rg = warp / 8, cg = warp % 8)
// owns rows 16 rg.. and, of every segment, columns cg * 8 NT / NSEG.. ; its
// tile u lies in segment u / (NT / NSEG). The weights stream WK rows at a
// time through a WSTAGES-deep cp.async ring. K % WK == 0. Synchronises the
// block on entry to each stage and on exit.
template <int NT, int NSEG>
__device__ void gemm(const bf16* A, int K, const bf16* const* w, int ldw, bf16* ring,
                     float (&acc)[NT][4]) {
  constexpr int TPS = NT / NSEG;          // tiles per segment per warp
  constexpr int NW = TPS * 64;            // segment width: 8 column groups
  constexpr int SLD = NSEG * NW + 8;      // staged row stride (16 B of skew)
  constexpr int VPR = NW / 8;             // 16-byte vectors per segment row
  static_assert(TPS * NSEG == NT, "whole tiles per segment");
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int rg = warp / 8, cg = warp % 8;
  const int steps = K / WK;
  auto stage = [&](int st) {
    bf16* dst = ring + (size_t)(st % WSTAGES) * WK * SLD;
    for (int i = threadIdx.x; i < WK * NSEG * VPR; i += THREADS) {
      const int r = i / (NSEG * VPR), sg = i / VPR % NSEG, v = i % VPR;
      cp_async16(dst + r * SLD + sg * NW + v * 8, w[sg] + (size_t)(st * WK + r) * ldw + v * 8,
                 16);
    }
    cp_async_commit();
  };
#pragma unroll
  for (int u = 0; u < NT; ++u) acc[u][0] = acc[u][1] = acc[u][2] = acc[u][3] = 0.f;
  stage(0);
  if (steps > 1) stage(1);
  for (int st = 0; st < steps; ++st) {
    if (st + 1 < steps)
      asm volatile("cp.async.wait_group 1;" ::: "memory");
    else
      asm volatile("cp.async.wait_group 0;" ::: "memory");
    __syncthreads();   // stage st landed for every thread; stage st - 1 is free
    if (st + 2 < steps) stage(st + 2);
    const bf16* bt = ring + (size_t)(st % WSTAGES) * WK * SLD;
    uint32_t a[2][4];
#pragma unroll
    for (int kk = 0; kk < 2; ++kk)
      ldmatrix_x4(a[kk], A + (size_t)(16 * rg + lane % 16) * A_LD + st * WK + 16 * kk +
                             8 * (lane / 16));
#pragma unroll
    for (int u = 0; u < NT; ++u) {
      uint32_t b[4];   // k rows 0-15 (b0, b1), 16-31 (b2, b3) of the tile's 8 columns
      ldmatrix_x4_trans(b, bt + (size_t)lane * SLD + (u / TPS) * NW + cg * TPS * 8 +
                               8 * (u % TPS));
      mma_k16(acc[u], a[0], b[0], b[1]);
      mma_k16(acc[u], a[1], b[2], b[3]);
    }
  }
  __syncthreads();   // A and the ring are free again
}

// The warp's fragment positions: acc[u][e] is row 16 rg + g (+ 8 for e >= 2),
// column col(u) + 2 t4 + e % 2 of the product.
struct Frag {
  int r, c;   // row of e = 0, 1; column offset within a tile
  __device__ Frag() {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    r = 16 * (warp / 8) + lane / 4;
    c = 2 * (lane % 4);
  }
};

// res[:, own channels] += attention(q = A @ wq[:, own], kg, vg) gathered over
// the cluster @ wo[:, own] + bo[own], then every block's res holds the update
// of all C channels. A holds the tile's layer-normed rows; q, the attention
// output and its gather are bf16.
__device__ void attend_residual(const Params& p, float* res, bf16* abuf, bf16* qbuf,
                                bf16* obuf, float* bs, bf16* ring, const bf16* wq,
                                const bf16* wo, const bf16* bo, const bf16* kg,
                                const bf16* vg, int tk, const float* bias, const float* kmax,
                                int n, int rank) {
  const int C = p.C, c0 = rank * COLS;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const Frag f;
  {   // q for this block's heads
    float acc[1][4];
    const bf16* w[1] = {wq + c0};
    gemm<1, 1>(abuf, C, w, C, ring, acc);
    const int col = 8 * (warp % 8) + f.c;
    *reinterpret_cast<__nv_bfloat162*>(qbuf + (size_t)f.r * Q_LD + col) =
        __floats2bfloat162_rn(acc[0][0], acc[0][1]);
    *reinterpret_cast<__nv_bfloat162*>(qbuf + (size_t)(f.r + 8) * Q_LD + col) =
        __floats2bfloat162_rn(acc[0][2], acc[0][3]);
  }
  __syncthreads();
  {   // the attention: warp (16 rows, head hl) over all tk keys
    const int hl = warp % HEADS, rows0 = 16 * (warp / HEADS), t4 = lane % 4, g = lane / 4;
    bf16* ks = ring;
    bf16* vs = ks + (size_t)STAGES * KC * LD;
    const float bscale = 1.4426950408889634f / p.scale_log2e;   // natural log -> raw logit
    auto stage = [&](int chunk) {
      if (bias != nullptr && threadIdx.x % HEADS == 0) {
        const int key = chunk * KC + threadIdx.x / HEADS;
        bs[(chunk % STAGES) * KC + threadIdx.x / HEADS] = key < tk ? bias[key] * bscale : 0.f;
      }
      stage_kv(ks, vs, kg, vg, C, rank * HEADS, HEADS, tk, chunk);
    };
    WarpAttention att;
    const bf16* qp = qbuf + (size_t)(rows0 + g) * Q_LD + hl * 8 + 2 * t4;
    att.begin(*reinterpret_cast<const uint32_t*>(qp),
              *reinterpret_cast<const uint32_t*>(qp + 8 * Q_LD));
    if (kmax != nullptr) att.bound(kmax[hl]);
    const int chunks = (tk + KC - 1) / KC;
    if (chunks > 0) stage(0);
    for (int c = 0; c < chunks; ++c) {
      if (c + 1 < chunks) {
        stage(c + 1);
        asm volatile("cp.async.wait_group 1;" ::: "memory");
      } else {
        asm volatile("cp.async.wait_group 0;" ::: "memory");
      }
      __syncthreads();   // chunk c is in shared memory for every warp
      const int s = c % STAGES;
      const bf16* kp = ks + ((size_t)s * KC + lane) * LD + hl * 8;
      const bf16* vp = vs + ((size_t)s * KC + lane) * LD + hl * 8;
      if (kmax != nullptr)
        att.chunk<true, false>(kp, vp, tk - c * KC, p.scale_log2e, nullptr);
      else if (bias != nullptr)
        att.chunk<false, true>(kp, vp, tk - c * KC, p.scale_log2e, bs + s * KC);
      else
        att.chunk<false, false>(kp, vp, tk - c * KC, p.scale_log2e, nullptr);
      __syncthreads();   // every warp is done with chunk c's stage
    }
    __nv_bfloat162 o[2];
    att.finish(o, kmax != nullptr);
    *reinterpret_cast<__nv_bfloat162*>(obuf + (size_t)(rows0 + g) * Q_LD + hl * 8 + 2 * t4) =
        o[0];
    *reinterpret_cast<__nv_bfloat162*>(obuf + (size_t)(rows0 + g + 8) * Q_LD + hl * 8 +
                                       2 * t4) = o[1];
  }
  cluster_sync();   // every block's attention output is in its obuf
  for (int i = threadIdx.x; i < n * QB * COLS / 8; i += THREADS) {
    const int q = i / (QB * COLS / 8), row = i / (COLS / 8) % QB, v = i % (COLS / 8);
    *reinterpret_cast<uint4*>(abuf + (size_t)row * A_LD + q * COLS + v * 8) =
        *peer(reinterpret_cast<const uint4*>(obuf + (size_t)row * Q_LD + v * 8), q);
  }
  __syncthreads();
  {   // the output projection and residual of this block's channels
    float acc[1][4];
    const bf16* w[1] = {wo + c0};
    gemm<1, 1>(abuf, C, w, C, ring, acc);
    const int col = c0 + 8 * (warp % 8) + f.c;
    const float2 bb = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(bo + col));
    float* r0 = res + (size_t)f.r * RES_LD + col;
    float* r1 = r0 + 8 * RES_LD;
    r0[0] += acc[0][0] + bb.x;
    r0[1] += acc[0][1] + bb.y;
    r1[0] += acc[0][2] + bb.x;
    r1[1] += acc[0][3] + bb.y;
  }
  cluster_sync();   // every block's channels of res are updated
  for (int i = threadIdx.x; i < n * QB * COLS / 4; i += THREADS) {
    const int q = i / (QB * COLS / 4), row = i / (COLS / 4) % QB, v = i % (COLS / 4);
    if (q == rank) continue;
    float4* dst = reinterpret_cast<float4*>(res + (size_t)row * RES_LD + q * COLS + v * 4);
    *dst = *peer(dst, q);
  }
  __syncthreads();
}

// The FF's partial product g (QB x HID, in abuf) @ wo2[own HID rows, :] into
// part (QB x C fp32, stride RES_LD), for NT = C / 64.
template <int NT>
__device__ void ff_partial(const Params& p, const bf16* abuf, bf16* ring, float* part,
                           int rank) {
  float acc[NT][4];
  const bf16* w[1] = {p.wo2 + (size_t)rank * HID * p.C};
  gemm<NT, 1>(abuf, HID, w, p.C, ring, acc);
  const Frag f;
  const int cg = threadIdx.x / 32 % 8;
#pragma unroll
  for (int u = 0; u < NT; ++u) {
    const int col = cg * NT * 8 + 8 * u + f.c;
    *reinterpret_cast<float2*>(part + (size_t)f.r * RES_LD + col) =
        make_float2(acc[u][0], acc[u][1]);
    *reinterpret_cast<float2*>(part + (size_t)(f.r + 8) * RES_LD + col) =
        make_float2(acc[u][2], acc[u][3]);
  }
}

__global__ void __launch_bounds__(THREADS, 1) block_mma_kernel(const __grid_constant__ Params p) {
  extern __shared__ __align__(1024) unsigned char smem[];
  float* res = reinterpret_cast<float*>(smem + OFF_RES);
  bf16* abuf = reinterpret_cast<bf16*>(smem + OFF_A);
  bf16* qbuf = reinterpret_cast<bf16*>(smem + OFF_Q);
  bf16* obuf = reinterpret_cast<bf16*>(smem + OFF_O);
  float* bs = reinterpret_cast<float*>(smem + OFF_BS);
  bf16* ring = reinterpret_cast<bf16*>(smem + OFF_RING);

  const int C = p.C, n = C / COLS, rank = (int)cluster_rank();
  const int t0 = blockIdx.x / n * QB, b = blockIdx.y, c0 = rank * COLS;
  const size_t base = (size_t)b * p.T * C;

  // x tile -> fp32 residual stream (rows past T are zero and never stored)
  for (int i = threadIdx.x; i < QB * C / 8; i += THREADS) {
    const int r = i / (C / 8), c = i % (C / 8) * 8, t = t0 + r;
    float v[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (t < p.T) dm::load8<bf16>(p.x + base + (size_t)t * C + c, v);
    dm::store8<float>(res + (size_t)r * RES_LD + c, v);
  }
  __syncthreads();
  layer_norm(res, abuf, p.ln1_s, p.ln1_b, C, p.Cn);
  __syncthreads();
  attend_residual(p, res, abuf, qbuf, obuf, bs, ring, p.wq, p.wo, p.bo, p.kx + base,
                  p.vx + base, p.T, nullptr,
                  p.kmax ? p.kmax + (size_t)b * (C / 8) + rank * HEADS : nullptr, n, rank);
  for (int i = 0; i < p.n_cross; ++i) {
    const Stream& s = p.cross[i];
    layer_norm(res, abuf, s.ln_s, s.ln_b, C, p.Cn);
    __syncthreads();
    attend_residual(p, res, abuf, qbuf, obuf, bs, ring, s.wq, s.wo, s.bo,
                    s.k + (size_t)b * s.tk * C, s.v + (size_t)b * s.tk * C, s.tk,
                    s.bias + (size_t)b * s.tk, nullptr, n, rank);
  }
  layer_norm(res, abuf, p.ln3_s, p.ln3_b, C, p.Cn);
  __syncthreads();
  {   // a and gate of this block's hidden units, g = a * gelu(gate) -> abuf
    float acc[8][4];
    const bf16* w[2] = {p.wi + rank * HID, p.wi + 4 * C + rank * HID};
    gemm<8, 2>(abuf, C, w, 8 * C, ring, acc);
    const Frag f;
    const int cg = threadIdx.x / 32 % 8;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int col = cg * 32 + 8 * u + f.c, h = rank * HID + col;
      const float2 ba = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p.bi + h));
      const float2 bg =
          __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p.bi + 4 * C + h));
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float gv[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float a = acc[u][2 * half + e] + (e ? ba.y : ba.x);
          const float gate = acc[u + 4][2 * half + e] + (e ? bg.y : bg.x);
          gv[e] = a * 0.5f * gate * (1.f + erff(gate * 0.70710678118654752f));
        }
        *reinterpret_cast<__nv_bfloat162*>(abuf + (size_t)(f.r + 8 * half) * A_LD + col) =
            __floats2bfloat162_rn(gv[0], gv[1]);
      }
    }
  }
  __syncthreads();
  float* part = reinterpret_cast<float*>(ring);
  switch (n) {
    case 1: ff_partial<1>(p, abuf, ring, part, rank); break;
    case 2: ff_partial<2>(p, abuf, ring, part, rank); break;
    case 3: ff_partial<3>(p, abuf, ring, part, rank); break;
    default: ff_partial<4>(p, abuf, ring, part, rank); break;
  }
  cluster_sync();   // every block's partial FF output is in its ring
  // out[own channels] = res + bo2 + the cluster's partials, rounded once
  for (int i = threadIdx.x; i < QB * COLS / 8; i += THREADS) {
    const int r = i / (COLS / 8), c = c0 + i % (COLS / 8) * 8, t = t0 + r;
    if (t >= p.T) continue;
    float v[8], bb[8];
    dm::load8<float>(res + (size_t)r * RES_LD + c, v);
    dm::load8<bf16>(p.bo2 + c, bb);
    for (int q = 0; q < n; ++q) {
      const float4* src = peer(reinterpret_cast<const float4*>(part + (size_t)r * RES_LD + c), q);
      const float4 lo = src[0], hi = src[1];
      v[0] += lo.x; v[1] += lo.y; v[2] += lo.z; v[3] += lo.w;
      v[4] += hi.x; v[5] += hi.y; v[6] += hi.z; v[7] += hi.w;
    }
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] += bb[e];
    dm::store8<bf16>(p.out + base + (size_t)t * C + c, v);
  }
  cluster_sync();   // no block leaves while its partials may still be read
}

int opt_in() {   // more than 48 KB of dynamic shared memory, once
  static bool done = false;
  if (!done) {
    cudaError_t err = cudaFuncSetAttribute(block_mma_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM);
    if (err != cudaSuccess) return (int)err;
    done = true;
  }
  return 0;
}

int run(const void* const* a, void* out, int B, int Tlen, int C, int Cn, int n_cross,
        const int* tk, float scale_log2e, const float* kmax, cudaStream_t s) {
  const int n = C / COLS;   // blocks per tile: 8 heads each
  if (C % COLS != 0 || n < 1 || n > C_MAX / COLS) return (int)cudaErrorInvalidValue;
  Params p = {};
  p.x = (const bf16*)a[0];
  p.kx = (const bf16*)a[1];
  p.vx = (const bf16*)a[2];
  p.ln1_s = (const bf16*)a[3];
  p.ln1_b = (const bf16*)a[4];
  p.wq = (const bf16*)a[5];
  p.wo = (const bf16*)a[6];
  p.bo = (const bf16*)a[7];
  p.ln3_s = (const bf16*)a[8];
  p.ln3_b = (const bf16*)a[9];
  p.wi = (const bf16*)a[10];
  p.bi = (const bf16*)a[11];
  p.wo2 = (const bf16*)a[12];
  p.bo2 = (const bf16*)a[13];
  p.n_cross = n_cross;
  for (int i = 0; i < n_cross; ++i) {
    const void* const* c = a + 14 + 8 * i;
    p.cross[i] = {(const bf16*)c[0], (const bf16*)c[1], (const bf16*)c[3], (const bf16*)c[4],
                  (const bf16*)c[5], (const bf16*)c[6], (const bf16*)c[7],
                  (const float*)c[2], tk[i]};
  }
  p.kmax = kmax;
  p.out = (bf16*)out;
  p.T = Tlen;
  p.C = C;
  p.Cn = Cn;
  p.scale_log2e = scale_log2e;
  const int rc = opt_in();
  if (rc != 0) return rc;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((Tlen + QB - 1) / QB * n, B);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = SMEM;
  cfg.stream = s;
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = n;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  cfg.attrs = &cluster;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, block_mma_kernel, p);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

}  // namespace tc

template <typename T>
int run_tiled(const void* const* a, void* out, int B, int Tlen, int C, int Cn, int n_cross,
              const int* tk, float scale_log2e, const float* kmax, cudaStream_t s) {
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
                    (const T*)a[12], (const T*)a[13], cross, kmax, (T*)out, Tlen, C, Cn,
                    scale_log2e);
}

}  // namespace

// args: x, k, v, ln1_scale, ln1_bias, wq, wo, bo, ln3_scale, ln3_bias, wi, bi,
// wo2, bo2 (14 device pointers), then per cross stream i < n_cross (at most 2):
// k_i, v_i, bias_i (fp32), ln2_scale_i, ln2_bias_i, wq_i, wo_i, bo_i, whose
// keys number tk0 and tk1. kmax: null, or (B, C / 8) fp32 key-norm maxima for
// the bounded softmax. dtype: 0 = float32, 1 = bfloat16. C is a whole number
// of 64-channel slices; a block of Cn < C channels (a multiple of 8) comes
// zero-padded to C (kernels/transformer_block.py::widen) and its LayerNorms
// take their statistics over the first Cn.
extern "C" int dm_transformer_block(int dtype, const void* const* args, void* out, int B,
                                    int Tlen, int C, int Cn, int n_cross, int tk0, int tk1,
                                    float scale_log2e, const void* kmax, void* stream) {
  if (n_cross < 0 || n_cross > MAX_CROSS || C % 64 != 0 || Cn % 8 != 0 || Cn < 8 ||
      Cn > C || C - Cn >= 64)
    return (int)cudaErrorInvalidValue;
  const int tk[MAX_CROSS] = {tk0, tk1};
  cudaStream_t s = (cudaStream_t)stream;
  const float* km = (const float*)kmax;
  if (dtype == 1) return tc::run(args, out, B, Tlen, C, Cn, n_cross, tk, scale_log2e, km, s);
  return run_tiled<float>(args, out, B, Tlen, C, Cn, n_cross, tk, scale_log2e, km, s);
}

extern "C" size_t dm_transformer_block_smem(int dtype, int C) {
  return dtype == 1 ? tc::SMEM : layout<float>(C).total;
}
