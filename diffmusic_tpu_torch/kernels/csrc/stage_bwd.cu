// Whole-stage backward of a HiFi-GAN resblock stage on the canvas.
//
// Replaces diffmusic_tpu/pallas/stage_bwd_kernel.py::stage_resblocks_canvas
// (_stage_bwd_pallas). The stage's forward is the chain of canvas pairs
// y = conv2(leaky(conv1(leaky(x), d) + b1)) + b2 + x per branch, averaged over
// the branches; it saved every pair's canvas input x_i and intermediate h_i.
// The backward computes the stage's input cotangent:
//   dx = sum over branches of: dcur = g / n_branches, then for the branch's
//        pairs in reverse
//          dh   = leaky'(h_i) * conv(dcur, flip(w2)^T, 1)
//          dcur = leaky'(x_i) * conv(dh, flip(w1)^T, d) + dcur
// with every intermediate zeroed outside the signal, the margins and the tail
// of dx written as zeros. Roundings as the Pallas kernel's: g arrives in the
// saved tensors' dtype; each conv's operand is rounded to the weight dtype;
// the masks, the skip sums, the branch sum and the 1/n are fp32.
//
// Bound: tensor-core work, 4 T C^2 sum(k) operations for the stage (165 GFLOP
// at T = 40008, C = 128: 0.167 ms at 989 TFLOP/s), against about 20 canvas
// tensors read once (0.06 ms).
//
// bf16, the design for Hopper: every adjoint conv is a pass over the whole
// canvas of the conv1d kernel's TMA + wgmma core (conv1d.cu, namespace tc,
// `stage_wgmma_kernel`, declared in stage_pass.cuh), reading tap k-1-j of the
// weight tensor as it lies through a tensor map (the maps are made once per
// weight tensor by the wrapper and cached, as for the canvas conv's adjoint).
// Passes have no halo to recompute: the old one-launch kernel's 64-row tiles
// recomputed each conv over 64 + 2 x 64 window rows (3x the work, one block
// an SM, its weights transposed into shared memory by scalar loads). Two
// epilogues of the core do the rest in fp32 with 16-byte loads, each reading
// its sign tensor once:
//   MASK      dh = leaky'(h_i) * acc, stored bf16;
//   MASK_ACC  dcur = leaky'(x_i) * acc + dcur, stored fp32, and rounded to
//             bf16 as the next pair's operand.
// The intermediates go through L2 and device memory: per branch an fp32 dcur
// and bf16 operand and dh canvases (42 MB at T 40008), which the wrapper
// allocates from PyTorch's caching allocator. The wrapper's schedule
// (kernels/stage_bwd.py::stage_schedule) runs one conv of pair q of every
// branch in one launch (the branches' scratch side by side, block z the
// branch; the branch of the largest k first, so its long blocks start
// early): 2 launches per pair step, 939 row tiles with signal a launch at
// T 40008 (3 x 313), about 3.6 waves of the 264 two-block slots, against
// 1.2 waves had each branch its own launches (0.630 against 0.857 ms on an
// H100 at 700 W, chip_smoke.py's check_stage). The first operand,
// round(g / n) on the signal rows, is the same for every branch: a small
// elementwise kernel writes it once per backward, rather than a scale in
// every branch's first pass, which would rewrite each staged tile k times
// (the first MASK_ACC reads g itself for dcur_0); a second kernel sums the
// branches' last dcur in branch order into dx.
//
// fp32 is the exact scalar path, for the card-against-CPU reference runs: one
// launch of `stage_bwd_kernel<float>`, one block per (batch, 16 output rows)
// keeping the fp32 dcur of its window (its rows plus a 64-row halo each side,
// HALO >= the longest branch's chain of pads, 60 at k = 11, d = (1, 3, 5)) and
// one operand buffer in shared memory, every conv computed over the whole
// window as scalar FMAs (common.cuh TileAcc<float>), each weight tap read
// transposed from L2.
#include <algorithm>
#include <cstring>

#include "common.cuh"
#include "stage_pass.cuh"

namespace {

using dm::bf16;
constexpr int CH = 128;        // the kernel takes the 128-channel stage only
constexpr int HALO = 64;       // window rows on each side of the output rows
constexpr int GUARD = 32;      // zero rows around each operand buffer (>= any conv's pad)
constexpr int THREADS = 256;   // 8 warps
constexpr int MAX_PAIRS = 16;
constexpr int MAX_BRANCHES = 4;

template <typename T> struct Cfg;
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
// window row. FROM_DCUR: the operand is T(dcur), copied into the chunk buffer
// A 16 channels at a time; else it is the full-width D.
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

int run_fp32(const void* g, const void* const* ptrs, const int* meta, void* out, int B,
             int Tlen, int sig0, int sig1, float slope, float inv, cudaStream_t s) {
  using T = float;
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

// ------------------------------------------------------------------- bf16
constexpr int EW_THREADS = 256;
// a slot's flags in the schedule (kernels/stage_bwd.py::stage_schedule)
constexpr int FIRST = 1;      // the branch's first pair: MASK reads op0, MASK_ACC g
constexpr int WRITE_OP = 2;   // MASK_ACC rounds dcur into the branch's operand

// op = round(g * inv) on the signal rows, zeros elsewhere: the operand of
// every branch's first conv. 8 channels a thread.
__global__ void __launch_bounds__(EW_THREADS)
first_operand_kernel(const bf16* __restrict__ g, bf16* __restrict__ op, size_t n8, int Tlen,
                     int C, int sig0, int sig1, float inv) {
  for (size_t i = blockIdx.x * (size_t)EW_THREADS + threadIdx.x; i < n8;
       i += (size_t)gridDim.x * EW_THREADS) {
    const size_t e = i * 8;
    const int t = (int)((e / C) % Tlen);
    float v[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (t >= sig0 && t < sig1) {
      dm::load8<bf16>(g + e, v);
#pragma unroll
      for (int q = 0; q < 8; ++q) v[q] *= inv;
    }
    dm::store8<bf16>(op + e, v);
  }
}

// out = round(dcur_0 + dcur_1 + ...) in branch order on the signal rows,
// zeros elsewhere; the branches' dcur lie `stride` elements apart.
__global__ void __launch_bounds__(EW_THREADS)
branch_sum_kernel(const float* __restrict__ dcur, size_t stride, int nbranch,
                  bf16* __restrict__ out, size_t n8, int Tlen, int C, int sig0, int sig1) {
  for (size_t i = blockIdx.x * (size_t)EW_THREADS + threadIdx.x; i < n8;
       i += (size_t)gridDim.x * EW_THREADS) {
    const size_t e = i * 8;
    const int t = (int)((e / C) % Tlen);
    float v[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (t >= sig0 && t < sig1) {
      dm::load8<float>(dcur + e, v);
      for (int br = 1; br < nbranch; ++br) {
        float u[8];
        dm::load8<float>(dcur + br * stride + e, u);
#pragma unroll
        for (int q = 0; q < 8; ++q) v[q] += u[q];
      }
    }
    dm::store8<bf16>(out + e, v);
  }
}

int ew_grid(size_t n8) {
  return (int)std::min<size_t>((n8 + EW_THREADS - 1) / EW_THREADS, 132 * 8);
}

// The passes, in the order of the wrapper's schedule. ptrs: x_i, h_i (n
// each), then the host addresses of the 128-byte tensor maps over w1_i and
// w2_i (the conv1d adjoint's, dm_conv1d_wmap), then the scratch: op0 (B, T,
// C) bf16; dcur (nb, B, T, C) fp32; op and dh (nb, B, T, C) bf16. meta after
// the pairs' k and dilations: the number of passes, then per pass its
// epilogue and slot count and per slot (branch, pair, flags).
int run_bf16(const void* g, const void* const* ptrs, const int* meta, void* out, int B,
             int Tlen, int sig0, int sig1, float slope, float inv, cudaStream_t s) {
  namespace sp = dm::stage_pass;
  const int n = meta[0], nb = meta[1];
  if (n > MAX_PAIRS || nb > sp::MAX_BRANCHES || nb < 1) return (int)cudaErrorInvalidValue;
  const int* ks = meta + 2 + nb;
  const int* ds = meta + 2 + nb + n;
  const int* plan = meta + 2 + nb + 2 * n;
  bf16* op0 = (bf16*)ptrs[4 * n];
  float* dcur = (float*)ptrs[4 * n + 1];
  bf16* op = (bf16*)ptrs[4 * n + 2];
  bf16* dh = (bf16*)ptrs[4 * n + 3];
  const size_t plane = (size_t)B * Tlen * CH, n8 = plane / 8;

  alignas(64) CUtensorMap op0_map, op_map[sp::MAX_BRANCHES], dh_map[sp::MAX_BRANCHES];
  int rc = sp::encode_rows(&op0_map, op0, B, Tlen, CH);
  for (int br = 0; br < nb && rc == 0; ++br) {
    rc = sp::encode_rows(&op_map[br], op + br * plane, B, Tlen, CH);
    if (rc == 0) rc = sp::encode_rows(&dh_map[br], dh + br * plane, B, Tlen, CH);
  }
  if (rc != 0) return rc;

  first_operand_kernel<<<ew_grid(n8), EW_THREADS, 0, s>>>((const bf16*)g, op0, n8, Tlen, CH,
                                                          sig0, sig1, inv);
  if ((rc = (int)cudaGetLastError()) != 0) return rc;
  const int passes = *plan++;
  for (int p = 0; p < passes; ++p) {
    const int epi = *plan++, slots = *plan++;
    if (slots < 1 || slots > sp::MAX_BRANCHES) return (int)cudaErrorInvalidValue;
    sp::Args a;
    a.slots = slots;
    a.inv = inv;
    for (int slot = 0; slot < slots; ++slot, plan += 3) {
      const int br = plan[0], i = plan[1], flags = plan[2];
      if (br < 0 || br >= nb || i < 0 || i >= n) return (int)cudaErrorInvalidValue;
      a.k[slot] = ks[i];
      if (epi == sp::MASK) {   // dh = leaky'(h_i) * conv(op, flip(w2)^T, 1)
        a.a[slot] = flags & FIRST ? op0_map : op_map[br];
        memcpy(&a.w[slot], ptrs[3 * n + i], sizeof(CUtensorMap));
        a.sign[slot] = (const bf16*)ptrs[n + i];
        a.out[slot] = dh + br * plane;
        a.dcur[slot] = nullptr;
        a.g[slot] = nullptr;
        a.dil[slot] = 1;
      } else {                 // dcur = leaky'(x_i) * conv(dh, flip(w1)^T, d) + dcur
        a.a[slot] = dh_map[br];
        memcpy(&a.w[slot], ptrs[2 * n + i], sizeof(CUtensorMap));
        a.sign[slot] = (const bf16*)ptrs[i];
        a.out[slot] = flags & WRITE_OP ? op + br * plane : nullptr;
        a.dcur[slot] = dcur + br * plane;
        a.g[slot] = flags & FIRST ? (const bf16*)g : nullptr;
        a.dil[slot] = ds[i];
      }
    }
    if ((rc = sp::launch(a, epi, B, Tlen, CH, slope, sig0, sig1, s)) != 0) return rc;
  }
  branch_sum_kernel<<<ew_grid(n8), EW_THREADS, 0, s>>>(dcur, plane, nb, (bf16*)out, n8, Tlen,
                                                       CH, sig0, sig1);
  return (int)cudaGetLastError();
}

}  // namespace

// g, out: (B, Tlen, 128) canvases. ptrs: x_0..x_{n-1}, h_0..h_{n-1}, then w1_0..,
// w2_0.. (pairs branch-major): fp32 the weights (k, C, C) themselves; bf16 the
// host addresses of their 128-byte tensor maps (dm_conv1d_wmap over w as it
// lies, the adjoint's), followed by the four scratch tensors of run_bf16.
// meta (host ints): n, n_branches, pairs per branch, k per pair, dilation per
// pair, and for bf16 the schedule of run_bf16. The signal is rows [sig0,
// sig1); inv = 1 / n_branches. dtype: 0 = float32, 1 = bfloat16. Returns a
// cudaError_t (0 = launched).
extern "C" int dm_stage_bwd(int dtype, const void* g, const void* const* ptrs, const int* meta,
                            void* out, int B, int Tlen, int sig0, int sig1, float slope,
                            float inv, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 1) return run_bf16(g, ptrs, meta, out, B, Tlen, sig0, sig1, slope, inv, s);
  return run_fp32(g, ptrs, meta, out, B, Tlen, sig0, sig1, slope, inv, s);
}

extern "C" size_t dm_stage_bwd_smem(int dtype) {
  return dtype == 1 ? dm::stage_pass::smem() : Layout<float>::TOTAL;
}
