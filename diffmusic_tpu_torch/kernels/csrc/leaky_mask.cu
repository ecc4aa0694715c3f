// Leaky-ReLU backward masks of the vocoder's adjoint convs on Hopper:
// out = where(h >= 0, g, slope * g) [+ r].
//
// Replaces diffmusic_tpu/pallas/mask_kernel.py::leaky_mask and
// ::leaky_mask_add (_mask_kernel, _mask_add_kernel).
//
// Bound: device memory (two or three reads and one write per element, two
// or three operations). A grid-stride pass over the flat tensors with
// 16-byte loads and stores (8 bf16 or two 4-float halves per step), the
// compare and the select in fp32 as the TPU kernel does, the result
// rounded once to g's dtype; a scalar loop takes the tail.
#include "common.cuh"

namespace {

using dm::bf16;
constexpr int THREADS = 256;

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

template <typename T>
int run_mask(const void* h, const void* g, const void* r, void* out, size_t n, float slope,
             cudaStream_t s) {
  // enough blocks to cover every SM several times; the grid stride does the rest
  const size_t want = (n / 8 + THREADS - 1) / THREADS;
  const int blocks = (int)(want < 1 ? 1 : (want > 132 * 16 ? 132 * 16 : want));
  return dm::launch(leaky_mask_kernel<T>, dim3(blocks), dim3(THREADS), 0, s, (const T*)h,
                    (const T*)g, (const T*)r, (T*)out, n, slope);
}

}  // namespace

// h, g, r (r may be null), out: n elements each, 16-byte aligned. dtype:
// 0 = float32, 1 = bfloat16. Returns a cudaError_t (0 = launched).
extern "C" int dm_leaky_mask(int dtype, const void* h, const void* g, const void* r, void* out,
                             size_t n, float slope, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 1) return run_mask<bf16>(h, g, r, out, n, slope, s);
  return run_mask<float>(h, g, r, out, n, slope, s);
}
