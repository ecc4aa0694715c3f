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
