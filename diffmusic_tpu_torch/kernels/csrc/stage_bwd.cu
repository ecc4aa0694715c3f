// Whole-stage backward of a HiFi-GAN resblock stage on the canvas, one launch.
//
// Replaces diffmusic_tpu/pallas/stage_bwd_kernel.py::stage_resblocks_canvas
// (_stage_bwd_pallas). The stage's forward is the chain of canvas pairs
// y = conv2(leaky(conv1(leaky(x), d) + b1)) + b2 + x per branch, averaged over
// the branches; it saved every pair's canvas input x_i and intermediate h_i.
// This kernel computes the stage's input cotangent:
//   dx = sum over branches of: dcur = g / n_branches, then for the branch's
//        pairs in reverse
//          dh   = leaky'(h_i) * conv(dcur, flip(w2)^T, 1)
//          dcur = leaky'(x_i) * conv(dh, flip(w1)^T, d) + dcur
// with every intermediate zeroed outside the signal, the margins and the tail
// of dx written as zeros. Roundings as the Pallas kernel's: g arrives in the
// saved tensors' dtype; each conv's operand is rounded to the weight dtype;
// the masks, the skip sums, the branch sum and the 1/n are fp32.
//
// Design for Hopper (not the TPU's): the Pallas kernel keeps the stage's 4.1 MB
// of flipped weights and 19 haloed windows in VMEM; a Hopper block has 227 KB.
// So one block per (batch, TM output rows) keeps only the fp32 dcur of its
// window (TM rows plus a 64-row halo each side, HALO >= the longest branch's
// chain of pads, 60 at k = 11, d = (1, 3, 5)) and one T operand buffer in
// shared memory, streams each weight tap (128 x 128, read transposed: the
// adjoint needs no weight copy) from L2, where the stage's weights stay, and
// reads the signs of x_i and h_i from device memory where each mask needs
// them. Every conv is computed over the whole window on the tensor cores
// (WMMA, common.cuh TileAcc); the rows near the window's edges come out wrong
// and are never used for the centre rows. Bound: tensor-core work, 4 T C^2
// sum(k) operations for the stage (165 GFLOP at T = 40008, C = 128); the
// halo recomputation multiplies it by (TM + 2 HALO) / TM.
#include "common.cuh"

namespace {

using dm::bf16;
constexpr int CH = 128;        // the kernel takes the 128-channel stage only
constexpr int HALO = 64;       // window rows on each side of the output rows
constexpr int GUARD = 32;      // zero rows around each operand buffer (>= any conv's pad)
constexpr int THREADS = 256;   // 8 warps
constexpr int MAX_PAIRS = 16;
constexpr int MAX_BRANCHES = 4;

template <typename T> struct Cfg;
// bf16: 64 output rows, 192-row window (~214 KB of shared memory)
template <> struct Cfg<bf16> { static constexpr int TM = 64, BK = 32; };
// fp32 (the exact path of the small checks): 16 output rows
template <> struct Cfg<float> { static constexpr int TM = 16, BK = 16; };

template <typename T>
struct StageArgs {
  const T* x[MAX_PAIRS];   // saved pair inputs (canvas)
  const T* h[MAX_PAIRS];   // saved pair intermediates (canvas)
  const T* w1[MAX_PAIRS];  // (k, C, C) forward layout
  const T* w2[MAX_PAIRS];
  int k[MAX_PAIRS], d[MAX_PAIRS];
  int pairs[MAX_BRANCHES];  // pairs per branch, branch-major order
  int nbranch;
};

template <typename T>
struct Layout {
  static constexpr int TM = Cfg<T>::TM, BK = Cfg<T>::BK, WIN = TM + 2 * HALO;
  static constexpr int ROWS = WIN + 2 * GUARD;
  static constexpr int LDR = CH + 4;                    // fp32 dcur rows
  static constexpr int LDA = dm::smem_ld<T>(CH);        // full-width operand rows
  static constexpr int LDK = dm::smem_ld<T>(BK);        // operand chunk rows
  static constexpr int LDB = dm::smem_ld<T>(CH);        // weight tap tile
  static constexpr int LDW = 20;                        // per-warp fp32 staging
  static constexpr size_t DCUR = 0;
  static constexpr size_t D = DCUR + dm::align128((size_t)WIN * LDR * sizeof(float));
  static constexpr size_t A = D + dm::align128((size_t)ROWS * LDA * sizeof(T));
  static constexpr size_t W = A + dm::align128((size_t)ROWS * LDK * sizeof(T));
  static constexpr size_t STAGE = W + dm::align128((size_t)BK * LDB * sizeof(T));
  static constexpr size_t TOTAL = STAGE + (size_t)(THREADS / 32) * 16 * LDW * sizeof(float);
};

template <typename T>
using Acc = dm::TileAcc<T, Layout<T>::WIN, CH, 4, 2>;

// acc = conv of the window's operand with flip(w)^T at dilation dil, every
// window row. FROM_DCUR: the operand is T(dcur), rounded into the chunk buffer
// A 32 (bf16) or 16 (fp32) channels at a time; else it is the full-width D.
template <typename T, bool FROM_DCUR>
__device__ void adjoint_conv(Acc<T>& acc, const float* dcur, T* A, const T* D, const T* w, int k,
                             int dil, T* wt) {
  using L = Layout<T>;
  const int pad = (k - 1) * dil / 2;
  acc.zero();
  for (int kc = 0; kc < CH; kc += L::BK) {
    if (FROM_DCUR) {
      __syncthreads();
      for (int e = threadIdx.x; e < L::WIN * L::BK; e += THREADS) {
        const int r = e / L::BK, c = e % L::BK;
        A[(size_t)(GUARD + r) * L::LDK + c] = dm::from_f<T>(dcur[(size_t)r * L::LDR + kc + c]);
      }
    }
    for (int j = 0; j < k; ++j) {
      __syncthreads();
      dm::load_rows_t(wt, L::LDB, w + (size_t)(k - 1 - j) * CH * CH, CH, 0, CH, kc, L::BK);
      __syncthreads();
      const int row = GUARD + j * dil - pad;   // operand row of output row 0, tap j
      if (FROM_DCUR)
        acc.mma(A + (size_t)row * L::LDK, L::LDK, wt, L::LDB, L::BK);
      else
        acc.mma(D + (size_t)row * L::LDA + kc, L::LDA, wt, L::LDB, L::BK);
    }
  }
  __syncthreads();
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
stage_bwd_kernel(const T* __restrict__ g, const StageArgs<T> a, T* __restrict__ out, int Tlen,
                 int sig0, int sig1, float slope, float inv) {
  using L = Layout<T>;
  constexpr int TM = L::TM, PER = TM * CH / THREADS;
  extern __shared__ __align__(128) unsigned char smem[];
  float* dcur = reinterpret_cast<float*>(smem + L::DCUR);
  T* D = reinterpret_cast<T*>(smem + L::D);
  T* A = reinterpret_cast<T*>(smem + L::A);
  T* wt = reinterpret_cast<T*>(smem + L::W);
  float* stage = reinterpret_cast<float*>(smem + L::STAGE) + (threadIdx.x / 32) * 16 * L::LDW;

  const int t0 = blockIdx.x * TM, b = blockIdx.y;
  const size_t base = (size_t)b * Tlen * CH;
  if (t0 + TM <= sig0 || t0 >= sig1) {   // a margin tile: zeros
    for (int e = threadIdx.x; e < TM * CH; e += THREADS)
      if (t0 + e / CH < Tlen) out[base + (size_t)(t0 + e / CH) * CH + e % CH] = dm::from_f<T>(0.f);
    return;
  }
  const int w0 = t0 - HALO;   // row of x's T rows at window row 0
  auto inside = [&](int r) { return w0 + r >= sig0 && w0 + r < sig1; };

  // the operand buffers' guard rows read as zero (conv taps reaching past the
  // window); their window rows are written before each read
  for (int e = threadIdx.x; e < 2 * GUARD * CH; e += THREADS) {
    const int r = e / CH, row = r < GUARD ? r : L::WIN + r;
    D[(size_t)row * L::LDA + e % CH] = dm::from_f<T>(0.f);
  }
  for (int e = threadIdx.x; e < 2 * GUARD * L::BK; e += THREADS) {
    const int r = e / L::BK, row = r < GUARD ? r : L::WIN + r;
    A[(size_t)row * L::LDK + e % L::BK] = dm::from_f<T>(0.f);
  }

  float dx[PER];
#pragma unroll
  for (int q = 0; q < PER; ++q) dx[q] = 0.f;
  Acc<T> acc;
  int first = 0;
  for (int br = 0; br < a.nbranch; ++br) {
    __syncthreads();
    for (int e = threadIdx.x; e < L::WIN * CH; e += THREADS) {
      const int r = e / CH, c = e % CH;
      dcur[(size_t)r * L::LDR + c] =
          inside(r) ? dm::to_f(g[base + (size_t)(w0 + r) * CH + c]) * inv : 0.f;
    }
    for (int q = a.pairs[br] - 1; q >= 0; --q) {
      const int i = first + q;
      // dh = leaky'(h_i) * conv(dcur, flip(w2)^T, 1) -> D (rounded to T)
      adjoint_conv<T, true>(acc, dcur, A, D, a.w2[i], a.k[i], 1, wt);
      const T* hi = a.h[i];
      acc.for_each(stage, L::LDW, [&](int r, int c, float v) {
        float dh = 0.f;
        if (inside(r)) {
          const float s = dm::to_f(hi[base + (size_t)(w0 + r) * CH + c]);
          dh = s >= 0.f ? v : slope * v;
        }
        D[(size_t)(GUARD + r) * L::LDA + c] = dm::from_f<T>(dh);
      });
      __syncthreads();
      // dcur += leaky'(x_i) * conv(dh, flip(w1)^T, d)
      adjoint_conv<T, false>(acc, dcur, A, D, a.w1[i], a.k[i], a.d[i], wt);
      const T* xi = a.x[i];
      acc.for_each(stage, L::LDW, [&](int r, int c, float v) {
        if (inside(r)) {
          const float s = dm::to_f(xi[base + (size_t)(w0 + r) * CH + c]);
          dcur[(size_t)r * L::LDR + c] += s >= 0.f ? v : slope * v;
        }
      });
    }
    first += a.pairs[br];
    __syncthreads();
#pragma unroll
    for (int q = 0; q < PER; ++q) {
      const int e = threadIdx.x + q * THREADS;
      dx[q] += dcur[(size_t)(HALO + e / CH) * L::LDR + e % CH];
    }
  }
#pragma unroll
  for (int q = 0; q < PER; ++q) {
    const int e = threadIdx.x + q * THREADS, t = t0 + e / CH;
    if (t < Tlen) out[base + (size_t)t * CH + e % CH] = dm::from_f<T>(inside(HALO + e / CH) ? dx[q] : 0.f);
  }
}

template <typename T>
int run(const void* g, const void* const* ptrs, const int* meta, void* out, int B, int Tlen,
        int sig0, int sig1, float slope, float inv, cudaStream_t s) {
  StageArgs<T> a = {};
  const int npairs = meta[0];
  a.nbranch = meta[1];
  if (npairs > MAX_PAIRS || a.nbranch > MAX_BRANCHES) return (int)cudaErrorInvalidValue;
  for (int i = 0; i < a.nbranch; ++i) a.pairs[i] = meta[2 + i];
  for (int i = 0; i < npairs; ++i) {
    a.x[i] = (const T*)ptrs[i];
    a.h[i] = (const T*)ptrs[npairs + i];
    a.w1[i] = (const T*)ptrs[2 * npairs + i];
    a.w2[i] = (const T*)ptrs[3 * npairs + i];
    a.k[i] = meta[2 + a.nbranch + i];
    a.d[i] = meta[2 + a.nbranch + npairs + i];
    if ((a.k[i] - 1) * a.d[i] / 2 > GUARD) return (int)cudaErrorInvalidValue;
  }
  dim3 grid((Tlen + Layout<T>::TM - 1) / Layout<T>::TM, B);
  return dm::launch(stage_bwd_kernel<T>, grid, dim3(THREADS), Layout<T>::TOTAL, s, (const T*)g, a,
                    (T*)out, Tlen, sig0, sig1, slope, inv);
}

}  // namespace

// g, out: (B, Tlen, 128) canvases. ptrs: x_0..x_{n-1}, h_0..h_{n-1}, w1_0.., w2_0..
// (4n device pointers, pairs branch-major). meta (host ints): n, n_branches,
// pairs per branch, k per pair, dilation per pair. The signal is rows
// [sig0, sig1); inv = 1 / n_branches. dtype: 0 = float32, 1 = bfloat16.
extern "C" int dm_stage_bwd(int dtype, const void* g, const void* const* ptrs, const int* meta,
                            void* out, int B, int Tlen, int sig0, int sig1, float slope,
                            float inv, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 1) return run<bf16>(g, ptrs, meta, out, B, Tlen, sig0, sig1, slope, inv, s);
  return run<float>(g, ptrs, meta, out, B, Tlen, sig0, sig1, slope, inv, s);
}

extern "C" size_t dm_stage_bwd_smem(int dtype) {
  return dtype == 1 ? Layout<bf16>::TOTAL : Layout<float>::TOTAL;
}
