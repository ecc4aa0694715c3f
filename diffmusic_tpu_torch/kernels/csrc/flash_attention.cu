// Flash self-attention on Hopper, at head_dim 8 and at head_dim 32-512.
//
// Replaces diffmusic_tpu/pallas/attention_kernel.py::flash_attention: unmasked
// softmax(Q K^T / sqrt(D)) V over (B, T, H, D) tensors, which in memory are
// (B, T, C) rows with C = H * D. The (T, T) logits never reach device memory.
// Head_dim 8 is the UNets' attention (below); head_dim 32-512 in steps of 32
// the VAE's mid-block (one head of D = C channels: 512 at published widths,
// 32 in the tiny configs), further below.
//
// Bound: at head_dim 8 the products are small (4 T^2 H 8 FLOPs, 0.01 ms of
// tensor-core time at T = 4000, H = 16) and the bytes smaller still; what
// every logit needs is one exp2, T^2 H of them, at 16 per clock per SM (the
// MUFU): 256 M at T = 4000, H = 16, some 0.06-0.07 ms at 1.75-1.98 GHz.
// Depth 8 is not below the tensor cores' reach: mma.sync has
// m16n8k8.row.col.f32.bf16.bf16.f32 (only WMMA and wgmma need depth 16).
//
// bf16: `flash_mma_kernel`, on the warp core of mma_attention.cuh (shared
// with the fused transformer block). One warp owns 16 query rows of one head:
// QK^T on mma.sync m16n8k8 from ldmatrix fragments, an online softmax per
// chunk of KC = 64 keys with the logit scale folded into exp2's FMA, P
// rounded to bf16 in registers for PV on m16n8k16 (the JAX kernel rounds P
// the same way, attention_kernel.py:52). A block is 2 row groups (32 query
// rows) x up to 8 heads, one warp each, and stages the key and value chunks
// of its heads, 128 contiguous bytes a key, through a double-buffered
// cp.async ring.
//
// fp32: `flash_attention_kernel`, the exact scalar core it shares with the
// transformer block (common.cuh, HeadAttention: one thread per (row, head)
// pair, fp32 FMAs), which the card-against-CPU reference runs use.
//
// Head_dim 32-512 ("wide"). Bound on the H100: the tensor cores. At (1, 4000,
// 1, 512) the products are 4 T^2 D = 3.3e10 FLOP, 0.033 ms at 989 TFLOP/s,
// against 0.005 ms for the 16.4 MB of q, k, v and out and 0.004 ms for the
// T^2 exp2. What the head_dim-8 design cannot do here: a 16-row fp32 output
// accumulator is 16 x 512 floats (256 registers a thread), QK^T contracts
// over 512, and a 64-key chunk of K is 64 KB. So:
//   - bf16, `flash_wide_kernel`: a block owns BQ = 128 query rows (8 warps
//     of 16 rows) and one DV = 128-column slice of the output; the grid's y
//     walks the D / 128 slices, each recomputing S (the other way, splitting
//     the keys across blocks and combining by log-sum-exp, would need a
//     second pass; the recompute costs (D / DV - 1) x the QK^T products).
//     At T = 4000 that is 32 x 4 = 128 blocks for 132 SMs. Q's 128 x D tile
//     stays in shared memory; K (KC = 32 keys x D) and V (32 keys x DV)
//     stream through a double-buffered cp.async ring (212 KB at D = 512).
//     QK^T is mma.sync m16n8k16 over D / 16 steps of 16 (A = Q by ldmatrix,
//     B = K as it lies by ldmatrix); the online softmax and P rounded to
//     bf16 in registers are the head_dim-8 core's; PV is m16n8k16 with V by
//     ldmatrix.trans into 16 accumulator tiles of 8 columns (64 registers).
//   - fp32, `flash_wide_f32_kernel`: exact scalar FMAs, 16 query rows a
//     block over all D output columns, a thread per (row, 16th of the
//     columns): S per 16-key chunk in shared memory (one logit a thread, a
//     D-long dot product), then each thread's online softmax of its row and
//     its 2-32 output columns.
#include "common.cuh"
#include "mma_attention.cuh"

namespace {

using dm::bf16;

// ------------------------------------------------------------- fp32: scalar
constexpr int THREADS = 256;
constexpr int KT = 32;   // keys per staged chunk

template <typename T>
__host__ __device__ int key_ld(int C) { return C + 16 / (int)sizeof(T); }

template <typename T>
size_t smem_bytes(int C) {
  return dm::align128((size_t)2 * KT * key_ld<T>(C) * sizeof(T));
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int Tlen, int heads,
                       float scale_log2e) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int C = heads * 8, ldk = key_ld<T>(C);
  T* ks = reinterpret_cast<T*>(smem);
  T* vs = ks + (size_t)KT * ldk;
  const int rows = max(1, THREADS / heads);
  const int t0 = blockIdx.x * rows, b = blockIdx.y;
  const int valid = min(rows, Tlen - t0);
  const size_t base = (size_t)b * Tlen * C;

  dm::HeadAttention<T, 1, KT> att;
  att.begin(q + base + (size_t)t0 * C, C, heads, rows, valid, scale_log2e);
  att.run(k + base, v + base, C, Tlen, nullptr, ks, vs, ldk, nullptr);
  att.end(out + base + (size_t)t0 * C, C, valid);
}

template <typename T>
int run(const void* q, const void* k, const void* v, void* out, int B, int Tlen, int heads,
        float scale_log2e, cudaStream_t s) {
  const int rows = THREADS / heads > 1 ? THREADS / heads : 1;
  dim3 grid((Tlen + rows - 1) / rows, B);
  return dm::launch(flash_attention_kernel<T>, grid, dim3(THREADS), smem_bytes<T>(heads * 8), s,
                    (const T*)q, (const T*)k, (const T*)v, (T*)out, Tlen, heads, scale_log2e);
}

// ------------------------------------------------------ bf16: tensor cores
namespace tc {

using namespace dm::mma;

constexpr int ROW_GROUPS = 2;   // 16-row groups per block
constexpr int THREADS = 32 * ROW_GROUPS * HEADS;
constexpr size_t SMEM = KV_BYTES;
static_assert(THREADS == STAGE_THREADS, "one staged (key, head) slot per thread");

__global__ void __launch_bounds__(THREADS)
flash_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ out, int Tlen, int heads,
                 float scale_log2e) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* ks = reinterpret_cast<bf16*>(smem);            // [stage][key][LD]
  bf16* vs = ks + (size_t)STAGES * KC * LD;
  const int C = heads * 8;
  const int hb0 = blockIdx.y * HEADS, nh = min(HEADS, heads - hb0);
  const size_t base = (size_t)blockIdx.z * Tlen * C;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int hl = warp % HEADS;                           // head within the block
  const int r0 = blockIdx.x * (16 * ROW_GROUPS) + (warp / HEADS) * 16;
  const bool active = hl < nh;

  // the warp's Q fragment: rows r0 + g and r0 + g + 8, d = 2 t4, 2 t4 + 1
  WarpAttention att;
  {
    const bf16* qp = q + base + (size_t)(hb0 + hl) * 8 + 2 * t4;
    att.begin(load_pair(qp + (size_t)(r0 + g) * C, active && r0 + g < Tlen),
              load_pair(qp + (size_t)(r0 + g + 8) * C, active && r0 + g + 8 < Tlen));
  }

  const int chunks = (Tlen + KC - 1) / KC;
  stage_kv(ks, vs, k + base, v + base, C, hb0, nh, Tlen, 0);
  for (int c = 0; c < chunks; ++c) {
    if (c + 1 < chunks) {
      stage_kv(ks, vs, k + base, v + base, C, hb0, nh, Tlen, c + 1);
      asm volatile("cp.async.wait_group 1;" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;" ::: "memory");
    }
    __syncthreads();   // chunk c is in shared memory for every warp

    if (active) {
      const int s = c % STAGES;
      att.chunk<false, false>(ks + ((size_t)s * KC + lane) * LD + hl * 8,
                              vs + ((size_t)s * KC + lane) * LD + hl * 8, Tlen - c * KC,
                              scale_log2e, nullptr);
    }
    __syncthreads();   // every warp is done with chunk c's stage
  }

  if (!active) return;
  __nv_bfloat162 o[2];
  att.finish(o, false);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + g + 8 * r;
    if (row < Tlen)
      *reinterpret_cast<__nv_bfloat162*>(out + base + (size_t)row * C + (hb0 + hl) * 8 +
                                         2 * t4) = o[r];
  }
}

int run(const void* q, const void* k, const void* v, void* out, int B, int Tlen, int heads,
        float scale_log2e, cudaStream_t s) {
  dim3 grid((Tlen + 16 * ROW_GROUPS - 1) / (16 * ROW_GROUPS), (heads + HEADS - 1) / HEADS, B);
  return dm::launch(flash_mma_kernel, grid, dim3(THREADS), SMEM, s, (const bf16*)q,
                    (const bf16*)k, (const bf16*)v, (bf16*)out, Tlen, heads, scale_log2e);
}

}  // namespace tc

// ------------------------------------------------ head_dim 32-512: bf16
namespace wide {

using namespace dm::mma;

constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int BQ = 16 * WARPS;   // query rows per block
constexpr int WKC = 32;          // keys per staged chunk
constexpr int DV = 128;          // output columns per block
constexpr int WSTAGES = 2;

// staged row stride in elements: 16 bytes of skew, so ldmatrix's 8 row reads
// hit 8 distinct 16-byte bank groups (stride 2 D + 16 bytes, D % 32 == 0)
__host__ __device__ inline int row_ld(int cols) { return cols + 8; }

size_t smem_bytes(int D) {
  return (size_t)(BQ * row_ld(D) + WSTAGES * WKC * row_ld(D) + WSTAGES * WKC * row_ld(DV)) *
         sizeof(bf16);
}

__global__ void __launch_bounds__(THREADS, 1)
flash_wide_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, bf16* __restrict__ out, int Tlen, int heads,
                  int D, float scale_log2e) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int ldq = row_ld(D), ldv = row_ld(DV);
  bf16* qs = reinterpret_cast<bf16*>(smem);             // [BQ][ldq]
  bf16* ks = qs + (size_t)BQ * ldq;                      // [stage][WKC][ldq]
  bf16* vs = ks + (size_t)WSTAGES * WKC * ldq;           // [stage][WKC][ldv]
  const int b = blockIdx.z / heads, h = blockIdx.z % heads;
  const size_t rs = (size_t)heads * D;                   // elements between rows t, t + 1
  const size_t base = (size_t)b * Tlen * rs + (size_t)h * D;
  const bf16 *qg = q + base, *kg = k + base, *vg = v + base;
  const int q0 = blockIdx.x * BQ;
  const int dv0 = blockIdx.y * DV, nv = min(DV, D - dv0);   // this block's output columns
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int pieces = D / 8, vpieces = nv / 8;            // 16-byte pieces of a row

  // Q once, in the first group with chunk 0; rows past Tlen read zeros
  for (int i = threadIdx.x; i < BQ * pieces; i += THREADS) {
    const int r = i / pieces, c = (i % pieces) * 8;
    const bool ok = q0 + r < Tlen;
    cp_async16(qs + (size_t)r * ldq + c, qg + (ok ? (size_t)(q0 + r) * rs + c : 0),
               ok ? 16 : 0);
  }
  // K chunk `c` (all D columns) and V chunk `c` (this block's nv columns);
  // keys past Tlen read zeros
  auto stage = [&](int c) {
    const int key0 = c * WKC;
    bf16* kd = ks + (size_t)(c % WSTAGES) * WKC * ldq;
    bf16* vd = vs + (size_t)(c % WSTAGES) * WKC * ldv;
    for (int i = threadIdx.x; i < WKC * pieces; i += THREADS) {
      const int r = i / pieces, col = (i % pieces) * 8;
      const bool ok = key0 + r < Tlen;
      cp_async16(kd + (size_t)r * ldq + col, kg + (ok ? (size_t)(key0 + r) * rs + col : 0),
                 ok ? 16 : 0);
    }
    for (int i = threadIdx.x; i < WKC * vpieces; i += THREADS) {
      const int r = i / vpieces, col = (i % vpieces) * 8;
      const bool ok = key0 + r < Tlen;
      cp_async16(vd + (size_t)r * ldv + col,
                 vg + (ok ? (size_t)(key0 + r) * rs + dv0 + col : 0), ok ? 16 : 0);
    }
    cp_async_commit();
  };

  // ldmatrix lane addresses. A (Q, 16 rows x 16 d): row lane % 16, d + 8 for
  // lanes 16-31. B (K as it lies, [key][d]): matrices (keys 0-7, d 0-7), (keys
  // 0-7, d 8-15), (keys 8-15, d 0-7), (keys 8-15, d 8-15), i.e. b0, b1 of two
  // 8-key tiles. V by .trans ([key][col]): (keys 0-7, cols 0-7), (keys 8-15,
  // cols 0-7), (keys 0-7, cols 8-15), (keys 8-15, cols 8-15), i.e. b0, b1 of
  // two 8-column tiles.
  const bf16* qa = qs + (size_t)(warp * 16 + lane % 16) * ldq + (lane / 16) * 8;
  const int kb_off = ((lane / 16) * 8 + lane % 8) * ldq + ((lane / 8) % 2) * 8;
  const int vb_off = (lane % 8 + ((lane / 8) % 2) * 8) * ldv + (lane / 16) * 8;

  float o[DV / 8][4];
#pragma unroll
  for (int j = 0; j < DV / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F}, l[2] = {0.f, 0.f};

  const int chunks = (Tlen + WKC - 1) / WKC;
  stage(0);
  for (int c = 0; c < chunks; ++c) {
    if (c + 1 < chunks) {
      stage(c + 1);
      asm volatile("cp.async.wait_group 1;" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;" ::: "memory");
    }
    __syncthreads();   // chunk c (and Q) is in shared memory for every warp
    const bf16* kc = ks + (size_t)(c % WSTAGES) * WKC * ldq;
    const bf16* vc = vs + (size_t)(c % WSTAGES) * WKC * ldv;

    // S = Q K^T: 4 tiles of 16 rows x 8 keys; c0, c1 row g, c2, c3 row g + 8,
    // keys 8 j + 2 t4 + (0, 1)
    float sc[WKC / 8][4];
#pragma unroll
    for (int j = 0; j < WKC / 8; ++j) sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
#pragma unroll 4
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a[4];
      ldmatrix_x4(a, qa + kk * 16);
#pragma unroll
      for (int np = 0; np < WKC / 16; ++np) {
        uint32_t kb[4];
        ldmatrix_x4(kb, kc + (size_t)np * 16 * ldq + kb_off + kk * 16);
        mma_k16(sc[2 * np], a, kb[0], kb[1]);
        mma_k16(sc[2 * np + 1], a, kb[2], kb[3]);
      }
    }
    const int nvalid = Tlen - c * WKC;
    if (nvalid < WKC) {   // keys past the last, in the last chunk only
#pragma unroll
      for (int j = 0; j < WKC / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (8 * j + 2 * t4 + (e & 1) >= nvalid) sc[j][e] = -CUDART_INF_F;
    }
    // the online softmax: running max, one rescale of o and l per chunk
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < WKC / 8; ++j) {
      mx[0] = fmaxf(mx[0], fmaxf(sc[j][0], sc[j][1]));
      mx[1] = fmaxf(mx[1], fmaxf(sc[j][2], sc[j][3]));
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float corr = ex2((m[r] - mx[r]) * scale_log2e);   // 0 on the first chunk
      l[r] *= corr;
#pragma unroll
      for (int j = 0; j < DV / 8; ++j) {
        o[j][2 * r] *= corr;
        o[j][2 * r + 1] *= corr;
      }
      m[r] = mx[r];
    }
    const float neg0 = -m[0] * scale_log2e, neg1 = -m[1] * scale_log2e;
#pragma unroll
    for (int j = 0; j < WKC / 8; ++j) {
      sc[j][0] = ex2(fmaf(sc[j][0], scale_log2e, neg0));
      sc[j][1] = ex2(fmaf(sc[j][1], scale_log2e, neg0));
      sc[j][2] = ex2(fmaf(sc[j][2], scale_log2e, neg1));
      sc[j][3] = ex2(fmaf(sc[j][3], scale_log2e, neg1));
      l[0] += sc[j][0] + sc[j][1];
      l[1] += sc[j][2] + sc[j][3];
    }
    // O += bf16(P) V over this block's columns, 16 keys per product
#pragma unroll
    for (int kk = 0; kk < WKC / 16; ++kk) {
      const float* p0 = sc[2 * kk];
      const float* p1 = sc[2 * kk + 1];
      const uint32_t pa[4] = {pack_bf16(p0[0], p0[1]), pack_bf16(p0[2], p0[3]),
                              pack_bf16(p1[0], p1[1]), pack_bf16(p1[2], p1[3])};
#pragma unroll
      for (int np = 0; np < DV / 16; ++np) {
        if (np * 16 < nv) {
          uint32_t vb[4];
          ldmatrix_x4_trans(vb, vc + (size_t)kk * 16 * ldv + vb_off + np * 16);
          mma_k16(o[2 * np], pa, vb[0], vb[1]);
          mma_k16(o[2 * np + 1], pa, vb[2], vb[3]);
        }
      }
    }
    __syncthreads();   // every warp is done with chunk c's stage
  }

  bf16* og = out + base;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const float inv = 1.f / l[r];
    const int row = q0 + warp * 16 + g + 8 * r;
    if (row >= Tlen) continue;
#pragma unroll
    for (int j = 0; j < DV / 8; ++j)
      if (j * 8 < nv)
        *reinterpret_cast<__nv_bfloat162*>(og + (size_t)row * rs + dv0 + j * 8 + 2 * t4) =
            __floats2bfloat162_rn(o[j][2 * r] * inv, o[j][2 * r + 1] * inv);
  }
}

int run(const void* q, const void* k, const void* v, void* out, int B, int Tlen, int heads,
        int D, float scale_log2e, cudaStream_t s) {
  dim3 grid((Tlen + BQ - 1) / BQ, (D + DV - 1) / DV, B * heads);
  return dm::launch(flash_wide_kernel, grid, dim3(THREADS), smem_bytes(D), s, (const bf16*)q,
                    (const bf16*)k, (const bf16*)v, (bf16*)out, Tlen, heads, D, scale_log2e);
}

// ------------------------------------------------ head_dim 32-512: fp32
constexpr int F_THREADS = 256;
constexpr int F_ROWS = 16;                      // query rows per block
constexpr int F_KT = 16;                        // keys per staged chunk
constexpr int F_COLS = F_THREADS / F_ROWS;      // threads per row
constexpr int F_MAXJ = 512 / F_COLS;            // output columns per thread at D = 512

size_t smem_bytes_f32(int D) {
  return (size_t)(F_ROWS * (D + 1) + F_KT * (D + 1) + F_KT * D + F_ROWS * F_KT) * sizeof(float);
}

__global__ void __launch_bounds__(F_THREADS)
flash_wide_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, float* __restrict__ out, int Tlen, int heads,
                      int D, float scale_log2e) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int ldq = D + 1;                                 // odd stride: the 16 keys' dot
  float* qs = reinterpret_cast<float*>(smem);            // products hit 16 banks
  float* ks = qs + (size_t)F_ROWS * ldq;
  float* vs = ks + (size_t)F_KT * ldq;
  float* ss = vs + (size_t)F_KT * D;                     // [row][key] logits of the chunk
  const int b = blockIdx.y / heads, h = blockIdx.y % heads;
  const size_t rs = (size_t)heads * D;
  const size_t base = (size_t)b * Tlen * rs + (size_t)h * D;
  const float *qg = q + base, *kg = k + base, *vg = v + base;
  const int t0 = blockIdx.x * F_ROWS;
  const int r = threadIdx.x / F_COLS, cl = threadIdx.x % F_COLS;
  const int nj = D / F_COLS;                             // this thread's columns cl + 16 j

  for (int i = threadIdx.x; i < F_ROWS * D; i += F_THREADS) {
    const int rr = i / D, d = i % D;
    qs[rr * ldq + d] = t0 + rr < Tlen ? qg[(size_t)(t0 + rr) * rs + d] : 0.f;
  }
  float o[F_MAXJ];
#pragma unroll
  for (int j = 0; j < F_MAXJ; ++j) o[j] = 0.f;
  float m = -CUDART_INF_F, l = 0.f;

  for (int k0 = 0; k0 < Tlen; k0 += F_KT) {
    const int nk = min(F_KT, Tlen - k0);
    __syncthreads();   // the last chunk's readers are done (and Q is staged)
    for (int i = threadIdx.x; i < F_KT * D; i += F_THREADS) {
      const int kk = i / D, d = i % D;
      const bool ok = kk < nk;
      ks[kk * ldq + d] = ok ? kg[(size_t)(k0 + kk) * rs + d] : 0.f;
      vs[kk * D + d] = ok ? vg[(size_t)(k0 + kk) * rs + d] : 0.f;
    }
    __syncthreads();
    float acc = 0.f;
    for (int d = 0; d < D; ++d) acc = fmaf(qs[r * ldq + d], ks[cl * ldq + d], acc);
    ss[r * F_KT + cl] = cl < nk ? acc : -CUDART_INF_F;
    __syncthreads();
    float mc = m;
#pragma unroll
    for (int j = 0; j < F_KT; ++j) mc = fmaxf(mc, ss[r * F_KT + j]);
    const float corr = exp2f((m - mc) * scale_log2e);   // 0 on the first chunk (m = -inf)
    l *= corr;
#pragma unroll
    for (int j = 0; j < F_MAXJ; ++j) o[j] *= corr;
    m = mc;
    for (int kk = 0; kk < F_KT; ++kk) {
      const float p = exp2f((ss[r * F_KT + kk] - mc) * scale_log2e);
      l += p;
#pragma unroll
      for (int j = 0; j < F_MAXJ; ++j)
        if (j < nj) o[j] = fmaf(p, vs[kk * D + cl + F_COLS * j], o[j]);
    }
  }
  if (t0 + r >= Tlen) return;
  const float inv = 1.f / l;
  float* og = out + base + (size_t)(t0 + r) * rs;
#pragma unroll
  for (int j = 0; j < F_MAXJ; ++j)
    if (j < nj) og[cl + F_COLS * j] = o[j] * inv;
}

int run_f32(const void* q, const void* k, const void* v, void* out, int B, int Tlen, int heads,
            int D, float scale_log2e, cudaStream_t s) {
  dim3 grid((Tlen + F_ROWS - 1) / F_ROWS, B * heads);
  return dm::launch(flash_wide_f32_kernel, grid, dim3(F_THREADS), smem_bytes_f32(D), s,
                    (const float*)q, (const float*)k, (const float*)v, (float*)out, Tlen, heads,
                    D, scale_log2e);
}

}  // namespace wide

}  // namespace

// q, k, v, out: (B, T, heads, 8) contiguous; heads <= 256. dtype: 0 = float32,
// 1 = bfloat16. scale_log2e = log2(e) / sqrt(8).
extern "C" int dm_flash_attention(int dtype, const void* q, const void* k, const void* v,
                                  void* out, int B, int Tlen, int heads, float scale_log2e,
                                  void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 1) return tc::run(q, k, v, out, B, Tlen, heads, scale_log2e, s);
  return run<float>(q, k, v, out, B, Tlen, heads, scale_log2e, s);
}

extern "C" size_t dm_flash_attention_smem(int dtype, int heads) {
  return dtype == 1 ? tc::SMEM : smem_bytes<float>(heads * 8);
}

// q, k, v, out: (B, T, heads, D) contiguous, 32 <= D <= 512, D % 32 == 0.
// dtype: 0 = float32, 1 = bfloat16. scale_log2e = log2(e) / sqrt(D).
extern "C" int dm_flash_attention_wide(int dtype, const void* q, const void* k, const void* v,
                                       void* out, int B, int Tlen, int heads, int D,
                                       float scale_log2e, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 1) return wide::run(q, k, v, out, B, Tlen, heads, D, scale_log2e, s);
  return wide::run_f32(q, k, v, out, B, Tlen, heads, D, scale_log2e, s);
}

extern "C" size_t dm_flash_attention_wide_smem(int dtype, int D) {
  return dtype == 1 ? wide::smem_bytes(D) : wide::smem_bytes_f32(D);
}
