// Flash self-attention at head_dim 8 on Hopper.
//
// Replaces diffmusic_tpu/pallas/attention_kernel.py::flash_attention: unmasked
// softmax(Q K^T / sqrt(8)) V over (B, T, H, 8) tensors, which in memory are
// (B, T, C) rows with C = H * 8. The (T, T) logits never reach device memory.
//
// Bound: at head_dim 8 the products are small (4 T^2 H 8 FLOPs, 0.01 ms of
// tensor-core time at T = 4000, H = 16) and the bytes smaller still; what
// every logit needs is one exp2, T^2 H of them, at 16 per clock per SM (the
// MUFU): 256 M at T = 4000, H = 16, some 0.06-0.07 ms at 1.75-1.98 GHz.
// Depth 8 is not below the tensor cores' reach: mma.sync has
// m16n8k8.row.col.f32.bf16.bf16.f32 (only WMMA and wgmma need depth 16).
//
// bf16: `flash_mma_kernel`. One warp owns 16 query rows of one head.
//   - QK^T is mma.sync m16n8k8: A is the warp's Q fragment, loaded once; B is
//     8 keys of K as they lie, [key][d], by ldmatrix (32 keys per x4).
//   - The softmax is online, per chunk of KC = 64 keys: the row max by quad
//     shuffles, one rescale of the output and the running sum per chunk, the
//     logits scaled inside the exponent's FMA (exp2(s c - m c)).
//   - PV is m16n8k16 with N = 8 = head_dim. Its A operand is P rounded to
//     bf16 in registers from two adjacent S accumulators (the FlashAttention-2
//     register reuse; the JAX kernel rounds P the same way,
//     attention_kernel.py:52), its B operand V by ldmatrix.trans.
//   - A block is 2 row groups (32 query rows) x up to 8 heads, one warp each.
//     It stages key and value chunks for all its heads at once, rows of up to
//     8 heads x 16 B = 128 contiguous bytes (one head's slice alone is 16 bytes
//     at a stride of C * 2, half a sector), through a double-buffered cp.async
//     ring, the next chunk in flight while the warps work on this one. Rows
//     are padded by 16 bytes, so ldmatrix's 8 row reads hit 8 distinct banks.
//
// fp32: `flash_attention_kernel`, the exact scalar core it shares with the
// transformer block (common.cuh, HeadAttention: one thread per (row, head)
// pair, fp32 FMAs), which the card-against-CPU reference runs use.
#include "common.cuh"

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

constexpr int KC = 64;          // keys per staged chunk
constexpr int ROW_GROUPS = 2;   // 16-row groups per block
constexpr int HEADS = 8;        // heads per block
constexpr int STAGES = 2;
constexpr int THREADS = 32 * ROW_GROUPS * HEADS;
constexpr int LD = HEADS * 8 + 8;   // staged row stride, elements: 8 heads + 16 B

constexpr size_t SMEM = (size_t)STAGES * 2 * KC * LD * sizeof(bf16);
static_assert(THREADS == KC * HEADS, "one staged (key, head) slot per thread");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; src_bytes 0 writes zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(smem_u32(dst)), "l"(src),
               "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// c (16 x 8, fp32) += a (16 x 8, bf16, row) @ b (8 x 8, bf16, col)
__device__ __forceinline__ void mma_k8(float* c, const uint32_t* a, uint32_t b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5}, {%6}, "
      "{%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(b));
}

// c (16 x 8, fp32) += a (16 x 16, bf16, row) @ b (16 x 8, bf16, col)
__device__ __forceinline__ void mma_k16(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t load_pair(const bf16* p, bool ok) {
  return ok ? *reinterpret_cast<const uint32_t*>(p) : 0u;
}

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
  uint32_t qa[2];
  {
    const bf16* qp = q + base + (size_t)(hb0 + hl) * 8 + 2 * t4;
    qa[0] = load_pair(qp + (size_t)(r0 + g) * C, active && r0 + g < Tlen);
    qa[1] = load_pair(qp + (size_t)(r0 + g + 8) * C, active && r0 + g + 8 < Tlen);
  }
  float o[4] = {0.f, 0.f, 0.f, 0.f};
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F}, l[2] = {0.f, 0.f};

  const int chunks = (Tlen + KC - 1) / KC;
  // one key row's slot for one head per thread (THREADS == KC * HEADS): its K
  // and V copies share the offset; slots past the last head or key read zeros
  const int slot_h = threadIdx.x % HEADS, slot_key = threadIdx.x / HEADS;
  auto stage = [&](int chunk) {
    const int s = chunk % STAGES, key = chunk * KC + slot_key;
    const bool ok = key < Tlen && slot_h < nh;
    const size_t off = ok ? base + (size_t)key * C + (hb0 + slot_h) * 8 : 0;
    const size_t at = ((size_t)s * KC + slot_key) * LD + slot_h * 8;
    cp_async16(ks + at, k + off, ok ? 16 : 0);
    cp_async16(vs + at, v + off, ok ? 16 : 0);
    asm volatile("cp.async.commit_group;" ::: "memory");
  };

  stage(0);
  for (int c = 0; c < chunks; ++c) {
    if (c + 1 < chunks) {
      stage(c + 1);
      asm volatile("cp.async.wait_group 1;" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;" ::: "memory");
    }
    __syncthreads();   // chunk c is in shared memory for every warp

    if (active) {
      const int s = c % STAGES, nvalid = Tlen - c * KC;
      const bf16* kp = ks + ((size_t)s * KC + lane) * LD + hl * 8;
      const bf16* vp = vs + ((size_t)s * KC + lane) * LD + hl * 8;
      // S = Q K^T: 8 tiles of 16 rows x 8 keys; c0, c1 row g, c2, c3 row g + 8,
      // keys 8 j + 2 t4 + (0, 1)
      float sc[KC / 8][4];
#pragma unroll
      for (int kk = 0; kk < KC / 32; ++kk) {
        uint32_t kb[4];
        ldmatrix_x4(kb, kp + (size_t)kk * 32 * LD);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          float* acc = sc[kk * 4 + u];
          acc[0] = acc[1] = acc[2] = acc[3] = 0.f;
          mma_k8(acc, qa, kb[u]);
        }
      }
      if (nvalid < KC) {   // keys past T, in the last chunk only
#pragma unroll
        for (int j = 0; j < KC / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (8 * j + 2 * t4 + (e & 1) >= nvalid) sc[j][e] = -CUDART_INF_F;
      }
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int j = 0; j < KC / 8; ++j) {
        mx[0] = fmaxf(mx[0], fmaxf(sc[j][0], sc[j][1]));
        mx[1] = fmaxf(mx[1], fmaxf(sc[j][2], sc[j][3]));
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        // 0 on the first chunk (m = -inf); the logits' max is finite
        const float corr = ex2((m[r] - mx[r]) * scale_log2e);
        l[r] *= corr;
        o[2 * r] *= corr;
        o[2 * r + 1] *= corr;
        m[r] = mx[r];
      }
      const float neg0 = -m[0] * scale_log2e, neg1 = -m[1] * scale_log2e;
#pragma unroll
      for (int j = 0; j < KC / 8; ++j) {
        sc[j][0] = ex2(fmaf(sc[j][0], scale_log2e, neg0));
        sc[j][1] = ex2(fmaf(sc[j][1], scale_log2e, neg0));
        sc[j][2] = ex2(fmaf(sc[j][2], scale_log2e, neg1));
        sc[j][3] = ex2(fmaf(sc[j][3], scale_log2e, neg1));
        l[0] += sc[j][0] + sc[j][1];
        l[1] += sc[j][2] + sc[j][3];
      }
      // O += bf16(P) V, 16 keys per product
#pragma unroll
      for (int kk = 0; kk < KC / 32; ++kk) {
        uint32_t vb[4];
        ldmatrix_x4_trans(vb, vp + (size_t)kk * 32 * LD);
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const float* p0 = sc[kk * 4 + 2 * half];
          const float* p1 = sc[kk * 4 + 2 * half + 1];
          const uint32_t pa[4] = {pack_bf16(p0[0], p0[1]), pack_bf16(p0[2], p0[3]),
                                  pack_bf16(p1[0], p1[1]), pack_bf16(p1[2], p1[3])};
          mma_k16(o, pa, vb[2 * half], vb[2 * half + 1]);
        }
      }
    }
    __syncthreads();   // every warp is done with chunk c's stage
  }

  if (!active) return;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int row = r0 + g + 8 * r;
    if (row < Tlen) {
      const float inv = 1.f / l[r];
      *reinterpret_cast<__nv_bfloat162*>(out + base + (size_t)row * C + (hb0 + hl) * 8 +
                                         2 * t4) =
          __floats2bfloat162_rn(o[2 * r] * inv, o[2 * r + 1] * inv);
    }
  }
}

int run(const void* q, const void* k, const void* v, void* out, int B, int Tlen, int heads,
        float scale_log2e, cudaStream_t s) {
  dim3 grid((Tlen + 16 * ROW_GROUPS - 1) / (16 * ROW_GROUPS), (heads + HEADS - 1) / HEADS, B);
  return dm::launch(flash_mma_kernel, grid, dim3(THREADS), SMEM, s, (const bf16*)q,
                    (const bf16*)k, (const bf16*)v, (bf16*)out, Tlen, heads, scale_log2e);
}

}  // namespace tc

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
