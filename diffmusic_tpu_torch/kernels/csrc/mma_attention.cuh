// The bf16 attention core at head_dim 8 on mma.sync, shared by the flash
// kernel (flash_attention.cu) and the fused transformer block
// (transformer_block.cu).
//
// One warp owns 16 query rows of one head:
//   - QK^T is mma.sync m16n8k8: A is the warp's Q fragment, loaded once; B is
//     8 keys of K as they lie, [key][d], by ldmatrix (32 keys per x4).
//   - The softmax is online, per chunk of KC = 64 keys: the row max by quad
//     shuffles, one rescale of the output and the running sum per chunk, the
//     logits scaled inside the exponent's FMA (exp2(s c - m c)).
//   - PV is m16n8k16 with N = 8 = head_dim. Its A operand is P rounded to
//     bf16 in registers from two adjacent S accumulators (the FlashAttention-2
//     register reuse; the JAX kernels round P the same way), its B operand V
//     by ldmatrix.trans.
// A block of KC * HEADS = 512 threads stages the key and value chunks of
// HEADS = 8 heads at once, rows of 8 heads x 16 B = 128 contiguous bytes (one
// head's slice alone is 16 bytes at a stride of C * 2, half a sector),
// through a double-buffered cp.async ring, the next chunk in flight while the
// warps work on this one. Rows are padded by 16 bytes, so ldmatrix's 8 row
// reads hit 8 distinct banks.
//
// Two variants beside the exact softmax, for the transformer block:
//   - bounded (the JAX package's DIFFMUSIC_TPU_BSOFT): the row's shift is
//     fixed before the first key at ||round(q_r)|| * kmax_h (times the logit
//     scale in the exponent), the Cauchy-Schwarz bound of every logit of the
//     row, so there is no running max and no rescale; the denominator is
//     guarded with max(l, 1e-37), since a slack bound scales every p of the
//     row by 2^-slack. A large slack puts p below 2^-126, where ex2.ftz
//     flushes and bf16 has no normal values, while fp32's exp2 keeps
//     subnormals down to 2^-149: so every p carries 2^HEADROOM (23), which
//     cancels in o / l (the guard scaled alike) and keeps p normal wherever
//     fp32 has it at all (p' <= 2^23 per key, l' <= T 2^23: no overflow);
//   - a per-key additive bias (a cross stream's attention mask), staged per
//     chunk in raw logit units, added to S before the max.
#pragma once

#include <math_constants.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace dm {
namespace mma {

using bf16 = __nv_bfloat16;

constexpr int KC = 64;                 // keys per staged chunk
constexpr int HEADS = 8;               // heads staged per chunk
constexpr int STAGES = 2;
constexpr int LD = HEADS * 8 + 8;      // staged row stride, elements: 8 heads + 16 B
constexpr int STAGE_THREADS = KC * HEADS;   // one staged (key, head) slot per thread
constexpr size_t KV_BYTES = (size_t)STAGES * 2 * KC * LD * sizeof(bf16);
constexpr float HEADROOM = 23.f;            // bounded: log2 of the scale every p carries
constexpr float GUARD = 1e-37f * 8388608.f;  // bounded: max(l, 1e-37) at that scale (2^23)

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; src_bytes 0 writes zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(smem_u32(dst)), "l"(src),
               "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
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

// Stage key chunk `chunk` of a (rows, C) key and value matrix pair at k and v
// (row `key` at offset key * C, heads [hb0, hb0 + nh) of them) into stage
// chunk % STAGES of ks / vs ([stage][key][LD]), and commit it as one cp.async
// group. Thread t stages key t / HEADS of head t % HEADS; keys at or past
// `rows` and heads past nh read zeros. The block has STAGE_THREADS threads.
__device__ __forceinline__ void stage_kv(bf16* ks, bf16* vs, const bf16* k, const bf16* v,
                                         int C, int hb0, int nh, int rows, int chunk) {
  const int slot_h = threadIdx.x % HEADS, slot_key = threadIdx.x / HEADS;
  const int s = chunk % STAGES, key = chunk * KC + slot_key;
  const bool ok = key < rows && slot_h < nh;
  const size_t off = ok ? (size_t)key * C + (hb0 + slot_h) * 8 : 0;
  const size_t at = ((size_t)s * KC + slot_key) * LD + slot_h * 8;
  cp_async16(ks + at, k + off, ok ? 16 : 0);
  cp_async16(vs + at, v + off, ok ? 16 : 0);
  cp_async_commit();
}

// One warp's 16 query rows of one head. Thread (g = lane / 4, t4 = lane % 4)
// holds the Q fragment of rows g and g + 8 at d = 2 t4, 2 t4 + 1, and the
// output, running max and running sum of the same two rows.
struct WarpAttention {
  uint32_t qa[2];
  float o[4], m[2], l[2];

  __device__ __forceinline__ void begin(uint32_t q_lo, uint32_t q_hi) {
    qa[0] = q_lo;
    qa[1] = q_hi;
#pragma unroll
    for (int i = 0; i < 4; ++i) o[i] = 0.f;
    m[0] = m[1] = -CUDART_INF_F;
    l[0] = l[1] = 0.f;
  }

  // The bounded softmax: each row's shift, in raw logit units, is ||q_r|| *
  // kmax (the norm of the rounded q the logits are made of), fixed for good.
  __device__ __forceinline__ void bound(float kmax) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&qa[r]));
      float n2 = fmaf(f.x, f.x, f.y * f.y);
      n2 += __shfl_xor_sync(0xffffffffu, n2, 1);
      n2 += __shfl_xor_sync(0xffffffffu, n2, 2);
      m[r] = sqrtf(n2) * kmax;
    }
  }

  // One chunk of KC keys: kp and vp are this lane's rows of the staged chunk
  // (key `lane`, this head's 8 channels); keys at or past nvalid are masked.
  // BIAS: bias[key] (raw logit units) is added to each logit first.
  template <bool BOUNDED, bool BIAS>
  __device__ __forceinline__ void chunk(const bf16* kp, const bf16* vp, int nvalid,
                                        float scale_log2e, const float* bias) {
    const int t4 = threadIdx.x % 4;
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
    if (BIAS) {
#pragma unroll
      for (int j = 0; j < KC / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[j][e] += bias[8 * j + 2 * t4 + (e & 1)];
    }
    if (nvalid < KC) {   // keys past the last, in the last chunk only
#pragma unroll
      for (int j = 0; j < KC / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (8 * j + 2 * t4 + (e & 1) >= nvalid) sc[j][e] = -CUDART_INF_F;
    }
    if (!BOUNDED) {
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
    }
    const float neg0 = BOUNDED ? HEADROOM - m[0] * scale_log2e : -m[0] * scale_log2e;
    const float neg1 = BOUNDED ? HEADROOM - m[1] * scale_log2e : -m[1] * scale_log2e;
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

  // The normalised output of rows g (r = 0) and g + 8 (r = 1) at d = 2 t4,
  // 2 t4 + 1, rounded to bf16; `bounded` guards the denominator.
  __device__ __forceinline__ void finish(__nv_bfloat162* out, bool bounded) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      const float inv = 1.f / (bounded ? fmaxf(l[r], GUARD) : l[r]);
      out[r] = __floats2bfloat162_rn(o[2 * r] * inv, o[2 * r + 1] * inv);
    }
  }
};

}  // namespace mma
}  // namespace dm
