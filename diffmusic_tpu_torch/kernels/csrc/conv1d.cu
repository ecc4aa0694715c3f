// HiFi-GAN resblock convolutions on Hopper: conv1d_fused and conv1d_fused_pair,
// each also on the canvas.
//
// Replace diffmusic_tpu/pallas/conv1d_kernel.py::conv1d_fused (_conv1d_pallas)
// and ::conv1d_fused_pair (_conv1d_pair_pallas), and their canvas forms
// ::conv1d_fused_canvas / ::conv1d_canvas_xbwd (_conv1d_canvas_pallas, with
// its adjoint mode) and ::conv1d_pair_canvas (_pair_canvas_pallas). Layout
// (B, T, C), weights (k, Cin, Cout), 'same' padding, odd k.
//
// Bound: the vocoder forward is ~1 TFLOP at 10 s (tensor-core work), while
// each conv reads x and w once and writes y once -- so the design keeps all k
// taps of one time tile on one staged window: a block loads the haloed window
// x[t0 - pad, t0 + BM + pad) of a 32-channel slice once (leaky applied on the
// way in) and accumulates k shifted (BM, 32) @ (32, BN) tap products from it
// on the tensor cores, instead of materialising im2col patches in device
// memory. The pair kernel also keeps the intermediate h in shared memory: one
// block computes h for its time tile plus conv2's halo over ALL channels,
// zeroes it outside the signal, writes it once (the backward's mask needs it)
// and runs conv2 straight from shared memory.
//
// The signal is rows [sig0, sig1) of x's T rows: [0, T) for the plain calls,
// [512, 512 + t) on a canvas (kernels/canvas.py), whose zero margins let every
// window be read with no edge case. Rows outside the signal are written as
// exact zeros (a bias must not leak into a margin the next conv reads), and a
// tile that holds no signal row writes its zeros and stops. The adjoint mode
// (the canvas backward) flips the taps and contracts the other channel axis,
// reading each tap w[k-1-j] transposed into shared memory (load_rows_t): the
// backward needs no transposed weight copy.
#include "common.cuh"

namespace {

using dm::bf16;
constexpr int BM = 64, BN = 64, BK = 32;
constexpr int P = 8;            // h halo rows kept on each side (>= (k-1)/2)
constexpr int HR = BM + 2 * P;  // h rows per block
constexpr int THREADS = 128;    // 4 warps

// rows [t0, t0 + BM) of every channel of a (B, Tlen, C) tensor set to zero
template <typename T>
__device__ void zero_rows(T* y, int b, int Tlen, int C, int t0, int n0, int ncols) {
  for (int e = threadIdx.x; e < BM * ncols; e += THREADS) {
    const int t = t0 + e / ncols;
    if (t < Tlen) y[((size_t)b * Tlen + t) * C + n0 + e % ncols] = dm::from_f<T>(0.f);
  }
}

// conv1d_fused: y = conv1d(leaky(x), w, dil) [+ b] [+ res] on the signal rows;
// with `adjoint`, w is (k, Cout, Cin) and tap j multiplies by w[k-1-j]^T.
template <typename T>
__global__ void __launch_bounds__(THREADS)
conv1d_fused_kernel(const T* __restrict__ x, const T* __restrict__ w,
                    const T* __restrict__ bias, const T* __restrict__ res,
                    T* __restrict__ y, int Tlen, int Cin, int Cout, int k, int dil,
                    float slope, int has_slope, int sig0, int sig1, int adjoint) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int lda = dm::smem_ld<T>(BK), ldb = dm::smem_ld<T>(BN), ldc = dm::acc_ld(BN);
  const int win_rows = BM + (k - 1) * dil;
  T* win = reinterpret_cast<T*>(smem);
  T* wt = reinterpret_cast<T*>(smem + dm::align128((size_t)win_rows * lda * sizeof(T)));
  float* stage = reinterpret_cast<float*>(
      reinterpret_cast<unsigned char*>(wt) + dm::align128((size_t)BK * ldb * sizeof(T)));

  const int t0 = blockIdx.x * BM, n0 = blockIdx.y * BN, b = blockIdx.z;
  if (t0 + BM <= sig0 || t0 >= sig1) {   // no signal row in this tile
    zero_rows(y, b, Tlen, Cout, t0, n0, BN);
    return;
  }
  const int pad = (k - 1) * dil / 2;
  const T* xb = x + (size_t)b * Tlen * Cin;

  dm::TileAcc<T, BM, BN, 2, 2> acc;
  acc.zero();
  for (int kc = 0; kc < Cin; kc += BK) {
    __syncthreads();
    dm::load_rows(win, lda, xb, Cin, t0 - pad, win_rows, Tlen, kc, BK, has_slope != 0, slope);
    for (int j = 0; j < k; ++j) {
      if (adjoint)
        dm::load_rows_t(wt, ldb, w + (size_t)(k - 1 - j) * Cout * Cin, Cin, n0, BN, kc, BK);
      else
        dm::load_rows(wt, ldb, w + (size_t)j * Cin * Cout, Cout, kc, BK, Cin, n0, BN, false, 0.f);
      __syncthreads();
      acc.mma(win + (size_t)j * dil * lda, lda, wt, ldb, BK);
      __syncthreads();
    }
  }
  acc.store(stage, ldc);
  __syncthreads();
  for (int e = threadIdx.x; e < BM * BN; e += THREADS) {
    const int r = e / BN, c = e % BN, t = t0 + r;
    if (t >= Tlen) continue;
    const size_t o = ((size_t)b * Tlen + t) * Cout + n0 + c;
    float v = 0.f;
    if (t >= sig0 && t < sig1) {
      v = stage[r * ldc + c];
      if (bias) v += dm::to_f(bias[n0 + c]);
      if (res) v += dm::to_f(res[o]);
    }
    y[o] = dm::from_f<T>(v);
  }
}

// conv1d_fused_pair: h = conv1(leaky(x), w1, dil) + b1, zeroed outside the
// signal; y = conv2(leaky(h), w2) + b2 + x on the signal rows. Emits y and h.
template <typename T>
__global__ void __launch_bounds__(THREADS)
conv1d_pair_kernel(const T* __restrict__ x, const T* __restrict__ w1,
                   const T* __restrict__ b1, const T* __restrict__ w2,
                   const T* __restrict__ b2, T* __restrict__ y, T* __restrict__ h_out,
                   int Tlen, int C, int k, int dil, float slope, int sig0, int sig1) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int ldh = dm::smem_ld<T>(C), lda = dm::smem_ld<T>(BK);
  const int ldb = dm::smem_ld<T>(BN), ldc = dm::acc_ld(BN);
  const int pad1 = (k - 1) * dil / 2, pad2 = (k - 1) / 2;
  const int win_rows = HR + 2 * pad1;
  unsigned char* p = smem;
  T* H = reinterpret_cast<T*>(p);      p += dm::align128((size_t)HR * ldh * sizeof(T));
  T* win = reinterpret_cast<T*>(p);    p += dm::align128((size_t)win_rows * lda * sizeof(T));
  T* wt = reinterpret_cast<T*>(p);     p += dm::align128((size_t)BK * ldb * sizeof(T));
  float* stage = reinterpret_cast<float*>(p);

  const int t0 = blockIdx.x * BM, b = blockIdx.z;
  if (t0 + BM <= sig0 || t0 >= sig1) {   // no signal row in this tile
    zero_rows(y, b, Tlen, C, t0, 0, C);
    zero_rows(h_out, b, Tlen, C, t0, 0, C);
    return;
  }
  const T* xb = x + (size_t)b * Tlen * C;

  // phase 1: H row r <-> time t0 - P + r, for every output channel of conv1
  for (int n0 = 0; n0 < C; n0 += BN) {
    dm::TileAcc<T, HR, BN, 1, 4> acc;
    acc.zero();
    for (int kc = 0; kc < C; kc += BK) {
      __syncthreads();
      dm::load_rows(win, lda, xb, C, t0 - P - pad1, win_rows, Tlen, kc, BK, true, slope);
      for (int j = 0; j < k; ++j) {
        dm::load_rows(wt, ldb, w1 + (size_t)j * C * C, C, kc, BK, C, n0, BN, false, 0.f);
        __syncthreads();
        acc.mma(win + (size_t)j * dil * lda, lda, wt, ldb, BK);
        __syncthreads();
      }
    }
    acc.store(stage, ldc);
    __syncthreads();
    for (int e = threadIdx.x; e < HR * BN; e += THREADS) {
      const int r = e / BN, c = e % BN, t = t0 - P + r;
      const bool inside = t >= sig0 && t < sig1;
      const float v = inside ? stage[r * ldc + c] + dm::to_f(b1[n0 + c]) : 0.f;
      if (r >= P && r < P + BM && t < Tlen)
        h_out[((size_t)b * Tlen + t) * C + n0 + c] = dm::from_f<T>(v);
      H[(size_t)r * ldh + n0 + c] = dm::from_f<T>(dm::leaky(v, slope));
    }
  }
  // phase 2: conv2 over H (output row i, tap j reads H row i + j - pad2 + P)
  for (int n0 = 0; n0 < C; n0 += BN) {
    dm::TileAcc<T, BM, BN, 2, 2> acc;
    acc.zero();
    for (int kc = 0; kc < C; kc += BK) {
      for (int j = 0; j < k; ++j) {
        __syncthreads();
        dm::load_rows(wt, ldb, w2 + (size_t)j * C * C, C, kc, BK, C, n0, BN, false, 0.f);
        __syncthreads();
        acc.mma(H + (size_t)(j - pad2 + P) * ldh + kc, ldh, wt, ldb, BK);
      }
    }
    __syncthreads();
    acc.store(stage, ldc);
    __syncthreads();
    for (int e = threadIdx.x; e < BM * BN; e += THREADS) {
      const int r = e / BN, c = e % BN, t = t0 + r;
      if (t >= Tlen) continue;
      const size_t o = ((size_t)b * Tlen + t) * C + n0 + c;
      y[o] = dm::from_f<T>(t >= sig0 && t < sig1
                               ? stage[r * ldc + c] + dm::to_f(b2[n0 + c]) + dm::to_f(x[o])
                               : 0.f);
    }
  }
}

template <typename T>
size_t fused_smem(int k, int dil) {
  return dm::align128((size_t)(BM + (k - 1) * dil) * dm::smem_ld<T>(BK) * sizeof(T)) +
         dm::align128((size_t)BK * dm::smem_ld<T>(BN) * sizeof(T)) +
         (size_t)BM * dm::acc_ld(BN) * sizeof(float);
}

template <typename T>
size_t pair_smem(int C, int k, int dil) {
  const int pad1 = (k - 1) * dil / 2;
  return dm::align128((size_t)HR * dm::smem_ld<T>(C) * sizeof(T)) +
         dm::align128((size_t)(HR + 2 * pad1) * dm::smem_ld<T>(BK) * sizeof(T)) +
         dm::align128((size_t)BK * dm::smem_ld<T>(BN) * sizeof(T)) +
         (size_t)HR * dm::acc_ld(BN) * sizeof(float);
}

template <typename T>
int run_fused(const void* x, const void* w, const void* b, const void* res, void* y, int B,
              int Tlen, int Cin, int Cout, int k, int dil, float slope, int has_slope,
              int sig0, int sig1, int adjoint, cudaStream_t s) {
  dim3 grid((Tlen + BM - 1) / BM, Cout / BN, B);
  return dm::launch(conv1d_fused_kernel<T>, grid, dim3(THREADS), fused_smem<T>(k, dil), s,
                    (const T*)x, (const T*)w, (const T*)b, (const T*)res, (T*)y, Tlen, Cin,
                    Cout, k, dil, slope, has_slope, sig0, sig1, adjoint);
}

template <typename T>
int run_pair(const void* x, const void* w1, const void* b1, const void* w2, const void* b2,
             void* y, void* h, int B, int Tlen, int C, int k, int dil, float slope,
             int sig0, int sig1, cudaStream_t s) {
  dim3 grid((Tlen + BM - 1) / BM, 1, B);
  return dm::launch(conv1d_pair_kernel<T>, grid, dim3(THREADS), pair_smem<T>(C, k, dil), s,
                    (const T*)x, (const T*)w1, (const T*)b1, (const T*)w2, (const T*)b2,
                    (T*)y, (T*)h, Tlen, C, k, dil, slope, sig0, sig1);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. The signal is rows [sig0, sig1) of the
// Tlen; b and res may be null. Returns a cudaError_t (0 = launched).
extern "C" int dm_conv1d_fused(int dtype, const void* x, const void* w, const void* b,
                               const void* res, void* y, int B, int Tlen, int Cin, int Cout,
                               int k, int dil, float slope, int has_slope, int sig0, int sig1,
                               int adjoint, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 1)
    return run_fused<bf16>(x, w, b, res, y, B, Tlen, Cin, Cout, k, dil, slope, has_slope,
                           sig0, sig1, adjoint, s);
  return run_fused<float>(x, w, b, res, y, B, Tlen, Cin, Cout, k, dil, slope, has_slope, sig0,
                          sig1, adjoint, s);
}

extern "C" int dm_conv1d_pair(int dtype, const void* x, const void* w1, const void* b1,
                              const void* w2, const void* b2, void* y, void* h, int B,
                              int Tlen, int C, int k, int dil, float slope, int sig0, int sig1,
                              void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 1)
    return run_pair<bf16>(x, w1, b1, w2, b2, y, h, B, Tlen, C, k, dil, slope, sig0, sig1, s);
  return run_pair<float>(x, w1, b1, w2, b2, y, h, B, Tlen, C, k, dil, slope, sig0, sig1, s);
}

extern "C" size_t dm_conv1d_fused_smem(int dtype, int k, int dil) {
  return dtype == 1 ? fused_smem<bf16>(k, dil) : fused_smem<float>(k, dil);
}

extern "C" size_t dm_conv1d_pair_smem(int dtype, int C, int k, int dil) {
  return dtype == 1 ? pair_smem<bf16>(C, k, dil) : pair_smem<float>(C, k, dil);
}
