// Leaky-ReLU backward masks of the vocoder's adjoint convs on Hopper:
// out = where(h >= 0, g, slope * g) [+ r], h, r and out (B, T, C).
//
// Replaces diffmusic_tpu/pallas/mask_kernel.py::leaky_mask and
// ::leaky_mask_add (_mask_kernel, _mask_add_kernel).
//
// Bound: device memory (two or three reads and one write per element, two
// or three operations): 4.6-12 us of bytes at the 10-s slice's stages, and
// less where the operands still sit in the 50 MB L2. What the mask route
// paid on top was outside the kernel: the host's time to launch it, and a
// copy of g before it. The adjoint conv that makes g leaves it as the
// transposed view of its contiguous (B, C, T) output, and a mask that reads
// only (B, T, C) needed it copied first, one more read and write of g and
// one more launch per mask. So g comes in either layout:
//   - `leaky_mask_kernel`, g laid out as h: a grid-stride pass over the flat
//     tensors with 16-byte loads and stores (8 bf16 or two 4-float halves per
//     step); a scalar loop takes the tail.
//   - `leaky_mask_gt_kernel`, g the transposed view of (B, C, T): one 64 t x
//     64 c tile per block. Its g rows (64 t of one channel, contiguous) are
//     read along t as 16-byte vectors into shared memory (scalar loads where
//     T leaves the rows unaligned, as at T 5001 and 20004 in bf16), the
//     tile's 16-byte columns swizzled by the channel group so that reading
//     8 channels of one t back hits distinct bank quarters; h, r and out are
//     then read and written along c as 16-byte vectors of 8 channels.
// The compare and the select run in fp32 as the TPU kernel does, the result
// rounded once to g's dtype. The launch is a bare <<<>>> with no attribute
// call: the kernels use no dynamic shared memory.
#include "common.cuh"

namespace {

using dm::bf16;
constexpr int THREADS = 256;
constexpr int TT = 64;   // the transposed form's tile edge

template <typename T>
__global__ void __launch_bounds__(THREADS)
leaky_mask_kernel(const T* __restrict__ h, const T* __restrict__ g, const T* __restrict__ r,
                  T* __restrict__ out, size_t n, float slope) {
  const size_t stride = (size_t)gridDim.x * THREADS;
  const size_t n8 = n / 8;
  for (size_t i = (size_t)blockIdx.x * THREADS + threadIdx.x; i < n8; i += stride) {
    float hv[8], gv[8], rv[8];
    dm::load8<T>(h + 8 * i, hv);
    dm::load8<T>(g + 8 * i, gv);
    if (r != nullptr) dm::load8<T>(r + 8 * i, rv);
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      gv[q] = hv[q] >= 0.f ? gv[q] : slope * gv[q];
      if (r != nullptr) gv[q] += rv[q];
    }
    dm::store8<T>(out + 8 * i, gv);
  }
  for (size_t i = 8 * n8 + (size_t)blockIdx.x * THREADS + threadIdx.x; i < n; i += stride) {
    float v = dm::to_f(g[i]);
    v = dm::to_f(h[i]) >= 0.f ? v : slope * v;
    if (r != nullptr) v += dm::to_f(r[i]);
    out[i] = dm::from_f<T>(v);
  }
}

// gt: g as a contiguous (B, C, T) tensor; h, r, out (B, T, C); C % 8 == 0.
template <typename T>
__global__ void __launch_bounds__(THREADS)
leaky_mask_gt_kernel(const T* __restrict__ h, const T* __restrict__ gt, const T* __restrict__ r,
                     T* __restrict__ out, int Tn, int C, float slope) {
  constexpr int V = 16 / sizeof(T);          // elements in 16 bytes
  constexpr int ITEMS = TT * TT / 8 / THREADS;   // groups of 8 elements per thread
  __shared__ __align__(16) T tile[TT][TT];   // [channel][swizzled t]
  auto at = [](int c, int t) { return ((t / 8) ^ (c / 8 % 8)) * 8 + t % 8; };
  const int t0 = blockIdx.x * TT, c0 = blockIdx.y * TT, b = blockIdx.z;
  const T* src = gt + ((size_t)b * C + c0) * Tn + t0;
  const bool aligned = (Tn * sizeof(T)) % 16 == 0;
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    const int i = threadIdx.x + k * THREADS;
    const int c = i / (TT / 8), t = (i % (TT / 8)) * 8;
    alignas(16) T e[8];
    const T* row = src + (size_t)c * Tn + t;
    if (c0 + c < C && aligned && t0 + t + 8 <= Tn) {
#pragma unroll
      for (int q = 0; q < 8; q += V)
        *reinterpret_cast<uint4*>(e + q) = *reinterpret_cast<const uint4*>(row + q);
    } else {
#pragma unroll
      for (int q = 0; q < 8; ++q)
        e[q] = c0 + c < C && t0 + t + q < Tn ? row[q] : dm::from_f<T>(0.f);
    }
#pragma unroll
    for (int q = 0; q < 8; q += V)
      *reinterpret_cast<uint4*>(&tile[c][at(c, t) + q]) = *reinterpret_cast<const uint4*>(e + q);
  }
  __syncthreads();
  // a warp takes 8 t x 4 groups of 8 channels: its 32 lanes read 4 distinct
  // 16-byte columns of the tile per channel, and 4 x 16 contiguous bytes of
  // each of 8 rows of h, r and out
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    const int i = threadIdx.x + k * THREADS, lane = i % 32, w = i / 32;
    const int t = (w % 8) * 8 + lane % 8, c = ((w / 8) * 4 + lane / 8) * 8;
    if (t0 + t >= Tn || c0 + c >= C) continue;
    const size_t o = ((size_t)b * Tn + t0 + t) * C + c0 + c;
    float hv[8], gv[8], rv[8];
    dm::load8<T>(h + o, hv);
    if (r != nullptr) dm::load8<T>(r + o, rv);
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const float gq = dm::to_f(tile[c + q][at(c, t)]);
      gv[q] = hv[q] >= 0.f ? gq : slope * gq;
      if (r != nullptr) gv[q] += rv[q];
    }
    dm::store8<T>(out + o, gv);
  }
}

template <typename T>
int run_mask(int g_layout, const void* h, const void* g, const void* r, void* out, size_t n,
             int B, int Tn, int C, float slope, cudaStream_t s) {
  if (g_layout == 1) {
    const dim3 grid((Tn + TT - 1) / TT, (C + TT - 1) / TT, B);
    leaky_mask_gt_kernel<T><<<grid, THREADS, 0, s>>>((const T*)h, (const T*)g, (const T*)r,
                                                     (T*)out, Tn, C, slope);
    return (int)cudaGetLastError();
  }
  // enough blocks to cover every SM several times; the grid stride does the rest
  const size_t want = (n / 8 + THREADS - 1) / THREADS;
  const int blocks = (int)(want < 1 ? 1 : (want > 132 * 16 ? 132 * 16 : want));
  leaky_mask_kernel<T><<<blocks, THREADS, 0, s>>>((const T*)h, (const T*)g, (const T*)r,
                                                  (T*)out, n, slope);
  return (int)cudaGetLastError();
}

}  // namespace

// h, g, r (r may be null), out: n elements each, 16-byte aligned. g_layout
// 0: g laid out as h; 1: h, r and out are (B, T, C) contiguous with C % 8
// == 0, and g is the transposed view of a contiguous (B, C, T) tensor.
// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t (0 = launched).
extern "C" int dm_leaky_mask(int dtype, int g_layout, const void* h, const void* g,
                             const void* r, void* out, size_t n, int B, int T, int C,
                             float slope, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 1) return run_mask<bf16>(g_layout, h, g, r, out, n, B, T, C, slope, s);
  return run_mask<float>(g_layout, h, g, r, out, n, B, T, C, slope, s);
}
