// HiFi-GAN upsampler forward on Hopper: phase-decomposed ConvTranspose1d.
//
// Replaces diffmusic_tpu/pallas/upsampler_kernel.py::phase_convtranspose
// (_phase_ct_pallas). With p_ct = (k - stride) / 2 and t = stride * tp + rho,
// torch ConvTranspose1d semantics give
//     y[stride*tp + rho] = sum_d x[tp + d] @ W[rho + p_ct - stride*d]
// over the d that make the tap index valid. Layout (B, T, C); W (k, Cin, Cout).
//
// Bound: tensor-core work (~k/stride tap products per output row); the
// lhs-dilated formulation would multiply the interleaved zeros too. One block
// per (row tile, Cout tile, batch x phase): it stages the x window its output
// rows need, accumulates only its phase's taps and writes its rows straight
// into the interleaved (B, t_out, Cout) output, masking the ragged tail -- one
// launch, no per-phase buffers and no interleave copy. The phases are a grid
// dimension, not a loop, so that the short 1000-row input of upsampler 0
// still gives stride times more blocks than SMs.
#include "common.cuh"

namespace {

using dm::bf16;
constexpr int BM = 64, BN = 64, BK = 32, THREADS = 128;

template <typename T>
__global__ void __launch_bounds__(THREADS)
phase_ct_kernel(const T* __restrict__ x, const T* __restrict__ w, const T* __restrict__ bias,
                T* __restrict__ y, int Tin, int Cin, int Cout, int k, int stride, int d_lo,
                int d_hi, int t_out) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int lda = dm::smem_ld<T>(BK), ldb = dm::smem_ld<T>(BN), ldc = dm::acc_ld(BN);
  const int win_rows = BM + d_hi - d_lo;
  T* win = reinterpret_cast<T*>(smem);
  T* wt = reinterpret_cast<T*>(smem + dm::align128((size_t)win_rows * lda * sizeof(T)));
  float* stage = reinterpret_cast<float*>(
      reinterpret_cast<unsigned char*>(wt) + dm::align128((size_t)BK * ldb * sizeof(T)));

  const int tp0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int b = blockIdx.z / stride, rho = blockIdx.z % stride;
  const int p_ct = (k - stride) / 2;
  const T* xb = x + (size_t)b * Tin * Cin;

  dm::TileAcc<T, BM, BN, 2, 2> acc;
  acc.zero();
  for (int kc = 0; kc < Cin; kc += BK) {
    __syncthreads();
    // window row r <-> input row tp0 + d_lo + r
    dm::load_rows(win, lda, xb, Cin, tp0 + d_lo, win_rows, Tin, kc, BK, false, 0.f);
    for (int j = 0; j < k; ++j) {
      if ((((j - p_ct) % stride) + stride) % stride != rho) continue;
      const int d = (rho + p_ct - j) / stride;  // exact division
      dm::load_rows(wt, ldb, w + (size_t)j * Cin * Cout, Cout, kc, BK, Cin, n0, BN, false,
                    0.f);
      __syncthreads();
      acc.mma(win + (size_t)(d - d_lo) * lda, lda, wt, ldb, BK);
      __syncthreads();
    }
  }
  acc.store(stage, ldc);
  __syncthreads();
  for (int e = threadIdx.x; e < BM * BN; e += THREADS) {
    const int r = e / BN, c = e % BN;
    const long t = (long)(tp0 + r) * stride + rho;
    if (t >= t_out) continue;
    y[((size_t)b * t_out + t) * Cout + n0 + c] =
        dm::from_f<T>(stage[r * ldc + c] + dm::to_f(bias[n0 + c]));
  }
}

template <typename T>
size_t ct_smem(int d_lo, int d_hi) {
  return dm::align128((size_t)(BM + d_hi - d_lo) * dm::smem_ld<T>(BK) * sizeof(T)) +
         dm::align128((size_t)BK * dm::smem_ld<T>(BN) * sizeof(T)) +
         (size_t)BM * dm::acc_ld(BN) * sizeof(float);
}

template <typename T>
int run(const void* x, const void* w, const void* b, void* y, int B, int Tin, int Cin,
        int Cout, int k, int stride, int d_lo, int d_hi, int t_out, cudaStream_t s) {
  const int rows = (t_out + stride - 1) / stride;
  dim3 grid((rows + BM - 1) / BM, Cout / BN, B * stride);
  return dm::launch(phase_ct_kernel<T>, grid, dim3(THREADS), ct_smem<T>(d_lo, d_hi), s,
                    (const T*)x, (const T*)w, (const T*)b, (T*)y, Tin, Cin, Cout, k, stride,
                    d_lo, d_hi, t_out);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t (0 = launched).
extern "C" int dm_phase_convtranspose(int dtype, const void* x, const void* w, const void* b,
                                      void* y, int B, int Tin, int Cin, int Cout, int k,
                                      int stride, int d_lo, int d_hi, int t_out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 1) return run<bf16>(x, w, b, y, B, Tin, Cin, Cout, k, stride, d_lo, d_hi, t_out, s);
  return run<float>(x, w, b, y, B, Tin, Cin, Cout, k, stride, d_lo, d_hi, t_out, s);
}

extern "C" size_t dm_phase_convtranspose_smem(int dtype, int d_lo, int d_hi) {
  return dtype == 1 ? ct_smem<bf16>(d_lo, d_hi) : ct_smem<float>(d_lo, d_hi);
}
