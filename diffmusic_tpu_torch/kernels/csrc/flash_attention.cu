// Flash self-attention at head_dim 8 on Hopper.
//
// Replaces diffmusic_tpu/pallas/attention_kernel.py::flash_attention: unmasked
// softmax(Q K^T / sqrt(8)) V over (B, T, H, 8) tensors, which in memory are
// (B, T, C) rows with C = H * 8. One thread block per (batch, tile of
// 256 / H query rows); each of its 256 threads owns one (row, head) pair.
// The block walks all T keys in 32-key chunks staged in shared memory with
// the online softmax of common.cuh (HeadAttention), so the (T, T) logits never
// exist in device memory.
//
// Bound: at head_dim 8 the work is ~T*T*H*(2*8 FMAs + exp2 + max) scalar fp32
// operations per call against 4*T*C elements of input and output -- far below
// the bf16 MMA depth of 16, so no tensor cores. Each block re-reads K and V
// whole from L2 (2*T*C elements); one pair per thread keeps the grid at
// T*H/256 blocks (250 at T = 4000, H = 16; 125 at T = 1000, H = 32).
#include "common.cuh"

namespace {

using dm::bf16;
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

}  // namespace

// q, k, v, out: (B, T, heads, 8) contiguous; heads <= 256. dtype: 0 = float32,
// 1 = bfloat16. scale_log2e = log2(e) / sqrt(8).
extern "C" int dm_flash_attention(int dtype, const void* q, const void* k, const void* v,
                                  void* out, int B, int Tlen, int heads, float scale_log2e,
                                  void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 1) return run<bf16>(q, k, v, out, B, Tlen, heads, scale_log2e, s);
  return run<float>(q, k, v, out, B, Tlen, heads, scale_log2e, s);
}

extern "C" size_t dm_flash_attention_smem(int dtype, int heads) {
  return dtype == 1 ? smem_bytes<bf16>(heads * 8) : smem_bytes<float>(heads * 8);
}
