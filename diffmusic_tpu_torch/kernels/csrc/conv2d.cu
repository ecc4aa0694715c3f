// 'same' 2-D convolution (stride 1, odd kh x kw, + bias) over NCHW on Hopper.
//
// Replaces diffmusic_tpu/pallas/conv2d_kernel.py::conv2d_same_fused
// (_conv2d_pallas), forward only.
//
// Bound: tensor-core work. The UNet's and the VAE decoder's 3x3 convs are
// GEMMs of M = H*W output pixels, N = Cout, K = kh*kw*Cin: 19 GFLOP at
// (250, 16) with 512 channels, 75 at (500, 32). The kernel is an implicit
// GEMM on the port's NCHW tensors as they are, with no layout copy and no
// padded copy: it computes the transposed product y^T (Cout x pixels) =
// W (Cout x K) @ X (K x pixels), so that an X row is one input channel's
// pixels (contiguous in NCHW) and an output row one output channel's pixels
// (written contiguously). A block owns BM output channels x BN flattened
// pixels (h * W + w) of one image; for each BK-channel slice and each tap
// (dh, dw) it stages the weights w[n, c, dh, dw] and the shifted pixels
// x[c, h + dh, w + dw] in shared memory, the image edges read as zero by
// predicated loads (a pixel row of the tile may span several image rows,
// so the predicate is per pixel), and accumulates the (BM x BK) @ (BK x BN)
// product with `dm::TileAcc` (WMMA bf16 -> fp32 on the tensor cores, exact
// fp32 FMAs for fp32). Bias is added in the epilogue.
#include "common.cuh"

namespace {

using dm::bf16;
constexpr int BM = 64;        // output channels per block
constexpr int BN = 128;       // output pixels per block
constexpr int BK = 32;        // input channels per staged slice
constexpr int THREADS = 256;  // 8 warps, 2 x 4 over the (BM, BN) tile

template <typename T>
__global__ void __launch_bounds__(THREADS)
conv2d_same_kernel(const T* __restrict__ x, const T* __restrict__ w,
                   const T* __restrict__ bias, T* __restrict__ y, int Cin, int Cout, int H,
                   int W, int kh, int kw) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int lda = dm::smem_ld<T>(BK), ldb = dm::smem_ld<T>(BN), ldc = dm::acc_ld(BN);
  T* As = reinterpret_cast<T*>(smem);
  T* Bs = reinterpret_cast<T*>(smem + dm::align128((size_t)BM * lda * sizeof(T)));
  float* stage = reinterpret_cast<float*>(
      reinterpret_cast<unsigned char*>(Bs) + dm::align128((size_t)BK * ldb * sizeof(T)));

  const int M = H * W, taps = kh * kw;
  const int p0 = blockIdx.x * BN, n0 = blockIdx.y * BM, b = blockIdx.z;
  const T* xb = x + (size_t)b * Cin * M;
  // each thread stages one pixel column of X, fixed for the whole block
  const int j = threadIdx.x % BN, p = p0 + j;
  const int ph = p / W, pw = p % W;

  dm::TileAcc<T, BM, BN, 2, 4> acc;
  acc.zero();
  for (int kc = 0; kc < Cin; kc += BK) {
    for (int t = 0; t < taps; ++t) {
      const int hh = ph + t / kw - kh / 2, ww = pw + t % kw - kw / 2;
      const bool inside = p < M && hh >= 0 && hh < H && ww >= 0 && ww < W;
      const size_t src = inside ? (size_t)hh * W + ww : 0;
      __syncthreads();   // the previous product is done with As and Bs
      for (int e = threadIdx.x; e < BM * BK; e += THREADS) {
        const int r = e / BK, c = e % BK;
        As[r * lda + c] = w[((size_t)(n0 + r) * Cin + kc + c) * taps + t];
      }
      for (int c = threadIdx.x / BN; c < BK; c += THREADS / BN)
        Bs[c * ldb + j] = inside ? xb[(size_t)(kc + c) * M + src] : dm::from_f<T>(0.f);
      __syncthreads();
      acc.mma(As, lda, Bs, ldb, BK);
    }
  }
  acc.store(stage, ldc);
  __syncthreads();
  for (int e = threadIdx.x; e < BM * BN; e += THREADS) {
    const int r = e / BN, jj = e % BN;
    if (p0 + jj >= M) continue;
    y[((size_t)b * Cout + n0 + r) * M + p0 + jj] =
        dm::from_f<T>(stage[r * ldc + jj] + dm::to_f(bias[n0 + r]));
  }
}

template <typename T>
size_t conv2d_smem() {
  return dm::align128((size_t)BM * dm::smem_ld<T>(BK) * sizeof(T)) +
         dm::align128((size_t)BK * dm::smem_ld<T>(BN) * sizeof(T)) +
         (size_t)BM * dm::acc_ld(BN) * sizeof(float);
}

template <typename T>
int run_conv2d(const void* x, const void* w, const void* b, void* y, int B, int Cin, int Cout,
               int H, int W, int kh, int kw, cudaStream_t s) {
  dim3 grid((H * W + BN - 1) / BN, Cout / BM, B);
  return dm::launch(conv2d_same_kernel<T>, grid, dim3(THREADS), conv2d_smem<T>(), s,
                    (const T*)x, (const T*)w, (const T*)b, (T*)y, Cin, Cout, H, W, kh, kw);
}

}  // namespace

// x (B, Cin, H, W), w (Cout, Cin, kh, kw), b (Cout,), y (B, Cout, H, W);
// Cin % 32 == 0, Cout % 64 == 0, kh and kw odd. dtype: 0 = float32,
// 1 = bfloat16. Returns a cudaError_t (0 = launched).
extern "C" int dm_conv2d_same(int dtype, const void* x, const void* w, const void* b, void* y,
                              int B, int Cin, int Cout, int H, int W, int kh, int kw,
                              void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 1) return run_conv2d<bf16>(x, w, b, y, B, Cin, Cout, H, W, kh, kw, s);
  return run_conv2d<float>(x, w, b, y, B, Cin, Cout, H, W, kh, kw, s);
}

extern "C" size_t dm_conv2d_same_smem(int dtype) {
  return dtype == 1 ? conv2d_smem<bf16>() : conv2d_smem<float>();
}
