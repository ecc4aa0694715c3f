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
// each conv reads x and w once and writes y once.
//
// In bf16 both functions are passes of one implicit GEMM on wgmma fed by TMA
// (`conv1d_wgmma_kernel`, namespace tc below):
//   - A pass writes out = conv(leaky(in), w, dil) [+ bias] [+ res] on the
//     signal rows. A block owns BM = 128 output rows x BN = 128 output
//     channels; two consumer warpgroups run wgmma m64n128k16 (bf16 -> fp32
//     registers) on 64 rows each, one producer thread keeps a 3-stage TMA +
//     mbarrier ring full, and two blocks share an SM.
//   - It walks (input channel slice of BK = 64, tap j). Each step's operands
//     are two boxes: A, 64 channels x 128 rows of the pass's input starting
//     at row t0 + j*dil - pad (channels innermost, so the tap's shift is a
//     whole-row box start; TMA fills rows before 0 or past T with zeros,
//     the 'same' padding, with no predicate); B, 64 input x 128 output
//     channels of the tap's (N, K) weight matrix, K innermost.
//   - The forward's B is the weights' tap-major copy (k, Cout, Cin), made
//     once per weight tensor by the wrapper together with its tensor map.
//     The adjoint (the canvas backward, dx = conv(g, w flipped and
//     transposed)) needs no copy: dx[s, ci] = sum_j sum_co g[s + j dil - pad,
//     co] w[k-1-j, ci, co], so tap j's B is w[k-1-j] as it lies, (N = Cin
//     rows, K = Cout innermost); the producer reads tap k-1-j through a
//     tensor map over w itself.
//   - leaky on A, in place, where the pass has a slope: once a stage lands,
//     each consumer warpgroup rewrites its own 64 rows (8 KB) through leaky
//     in fp32, rounded back to bf16 (elementwise, so the 128-B swizzle does
//     not matter), then fences the generic proxy's writes against the async
//     proxy and meets its warpgroup barrier before its wgmma reads the tile.
//     Passes without a slope (the plain forward without one, the adjoint)
//     compile without the rewrite, the fence and the barrier.
//   - Epilogue: the fp32 tile staged in the drained ring; per 8 channels of
//     a row the bias and the residual in fp32, one rounding to bf16, one
//     16-byte store; rows outside [sig0, sig1) are written as exact zeros,
//     rows at or past T not at all.
// The single conv is one pass. The pair is two, launched back to back by one
// C call: pass 1 reads x and writes h = conv1(leaky(x)) + b1, pass 2 reads h
// and x and writes y = conv2(leaky(h)) + b2 + x. A block that kept h on chip
// would have to own every channel of its rows (79 blocks at stage 0, ch512);
// two (row tile x Cout tile) GEMMs give 160 / 314 / 313 blocks at stages
// 0-2 for the price of reading h back once, which the kernel writes for the
// backward anyway. Pass 2 reads h as pass 1 rounded it, leaky(round(h)), as
// the plain version does; the JAX kernel rounds leaky(h) from fp32 (one
// bf16 ulp apart on negative h). The bf16 stage backward (stage_bwd.cu) runs
// its adjoint convs as passes of the same body, `conv_pass`, with two more
// epilogues (MASK, MASK_ACC: stage_pass.cuh) and one slot of tensor maps and
// outputs per branch in `stage_wgmma_kernel`, block z the slot.
//
// fp32 is the exact scalar path, for the card-against-CPU reference runs:
// `conv1d_fused_kernel<float>` keeps all k taps of one time tile on one
// staged window (the haloed window x[t0 - pad, t0 + BM + pad) of a
// 32-channel slice, leaky applied on the way in) and accumulates k shifted
// tap products from it (common.cuh TileAcc<float>); its adjoint mode reads
// each tap w[k-1-j] transposed into shared memory (load_rows_t). The fp32
// pair (`conv1d_pair_kernel<float>`) computes h for its time tile plus
// conv2's halo over ALL channels in shared memory, writes it once and runs
// conv2 from there.
//
// The signal is rows [sig0, sig1) of x's T rows: [0, T) for the plain calls,
// [512, 512 + t) on a canvas (kernels/canvas.py), whose zero margins let every
// window be read with no edge case. Rows outside the signal are written as
// exact zeros (a bias must not leak into a margin the next conv reads), and a
// tile that holds no signal row writes its zeros and stops.
#include <cstring>

#include "common.cuh"
#include "hopper.cuh"
#include "stage_pass.cuh"

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

// conv1d_fused in fp32 (the exact scalar path; bf16 takes tc:: below):
// y = conv1d(leaky(x), w, dil) [+ b] [+ res] on the signal rows; with
// `adjoint`, w is (k, Cout, Cin) and tap j multiplies by w[k-1-j]^T.
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

// conv1d_fused_pair in fp32 (the exact scalar path; bf16 takes tc:: below):
// h = conv1(leaky(x), w1, dil) + b1, zeroed outside the signal;
// y = conv2(leaky(h), w2) + b2 + x on the signal rows. Emits y and h.
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

int run_fused_fp32(const void* x, const void* w, const void* b, const void* res, void* y,
                   int B, int Tlen, int Cin, int Cout, int k, int dil, float slope,
                   int has_slope, int sig0, int sig1, int adjoint, cudaStream_t s) {
  dim3 grid((Tlen + BM - 1) / BM, Cout / BN, B);
  return dm::launch(conv1d_fused_kernel<float>, grid, dim3(THREADS), fused_smem<float>(k, dil),
                    s, (const float*)x, (const float*)w, (const float*)b, (const float*)res,
                    (float*)y, Tlen, Cin, Cout, k, dil, slope, has_slope, sig0, sig1, adjoint);
}

int run_pair_fp32(const void* x, const void* w1, const void* b1, const void* w2,
                  const void* b2, void* y, void* h, int B, int Tlen, int C, int k, int dil,
                  float slope, int sig0, int sig1, cudaStream_t s) {
  dim3 grid((Tlen + BM - 1) / BM, 1, B);
  return dm::launch(conv1d_pair_kernel<float>, grid, dim3(THREADS), pair_smem<float>(C, k, dil),
                    s, (const float*)x, (const float*)w1, (const float*)b1, (const float*)w2,
                    (const float*)b2, (float*)y, (float*)h, Tlen, C, k, dil, slope, sig0, sig1);
}

// ------------------------------------------------------ bf16: TMA + wgmma
namespace tc {

using namespace dm::hopper;

constexpr int BM = 128;                      // output rows per block (2 x 64)
constexpr int BN = 128;                      // output channels per block
constexpr int BK = 64;                       // input channels per step
constexpr int STAGES = 3;                    // depth of the shared-memory ring
constexpr int A_BYTES = BM * BK * 2;         // 16 KB of input window per stage
constexpr int B_BYTES = BN * BK * 2;         // 16 KB of weights per stage
constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
constexpr int CONSUMER_WARPS = 8;            // warpgroups 0-1
constexpr int THREADS = 32 * CONSUMER_WARPS + 32;   // + one producer warp
constexpr int PRODUCER = 32 * CONSUMER_WARPS;
// staged fp32 output rows: 528 bytes, so the 8 rows of a fragment store fall
// on 8 distinct 4-bank offsets (two wavefronts, the least for 256 bytes)
constexpr int OUT_LD = BN + 4;
static_assert(BM * OUT_LD * 4 <= STAGES * STAGE_BYTES, "the staged tile fits the ring");
constexpr size_t SMEM = (size_t)STAGES * STAGE_BYTES + 2 * STAGES * sizeof(uint64_t) + 1024;

// The pass's epilogues: EPI_BIAS_RES, the conv's own; MASK and MASK_ACC, the
// stage backward's (stage_pass.cuh).
constexpr int EPI_BIAS_RES = 0;
constexpr int MASK = dm::stage_pass::MASK, MASK_ACC = dm::stage_pass::MASK_ACC;

// One pass over batch row b: acc = conv(leaky(in), w, dil), without LEAKY
// conv(in, w, dil). `in` (B, T, Cin) arrives through amap; tap j's (Cout,
// Cin) weight matrix through wmap (k, Cout, Cin) at tap j, or at tap k-1-j
// with `flip` (the adjoint). On the signal rows [sig0, sig1) the epilogue
// writes, per EPI:
//   EPI_BIAS_RES: out = acc [+ bias] [+ res] (bias and res may be null);
//   MASK:         out = leaky'(res) * acc, res the saved sign tensor;
//   MASK_ACC:     v = leaky'(res) * acc + (g ? g * inv : dcur), fp32, into
//                 dcur, and rounded into out unless out is null;
// and exact zeros on the other rows before T.
template <bool LEAKY, int EPI>
__device__ __forceinline__ void conv_pass(const CUtensorMap* amap, const CUtensorMap* wmap,
                                          const bf16* __restrict__ bias,
                                          const bf16* __restrict__ res, bf16* __restrict__ out,
                                          float* __restrict__ dcur, const bf16* __restrict__ g,
                                          float inv, int Tlen, int Cin, int Cout, int k,
                                          int dil, float slope, int sig0, int sig1, int flip,
                                          int b) {
  extern __shared__ unsigned char smem_raw[];
  // 1024-byte alignment: the 128-B swizzle pattern repeats every 8 rows
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + STAGES * STAGE_BYTES);
  uint64_t* empty = full + STAGES;

  const int t0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  if (t0 + BM <= sig0 || t0 >= sig1) {   // no signal row in this tile: zeros
    for (int i = threadIdx.x; i < BM * BN / 8; i += THREADS) {
      const int t = t0 + i / (BN / 8), n = n0 + i % (BN / 8) * 8;
      if (t < Tlen && n < Cout) {
        const size_t o = ((size_t)b * Tlen + t) * Cout + n;
        if (EPI != MASK_ACC || out != nullptr)
          *reinterpret_cast<uint4*>(out + o) = make_uint4(0, 0, 0, 0);
        if constexpr (EPI == MASK_ACC) {
          *reinterpret_cast<float4*>(dcur + o) = make_float4(0.f, 0.f, 0.f, 0.f);
          *reinterpret_cast<float4*>(dcur + o + 4) = make_float4(0.f, 0.f, 0.f, 0.f);
        }
      }
    }
    return;
  }
  const int pad = (k - 1) * dil / 2;
  const int iters = Cin / BK * k;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (threadIdx.x >= PRODUCER) {
    // producer: one thread keeps the ring full
    if (threadIdx.x == PRODUCER) {
      for (int it = 0; it < iters; ++it) {
        const int s = it % STAGES;
        if (it >= STAGES) mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);
        const int kc = (it / k) * BK, j = it % k;
        unsigned char* a = smem + s * STAGE_BYTES;
        mbar_expect_tx(&full[s], STAGE_BYTES);
        tma_load_3d(a, amap, &full[s], kc, t0 + j * dil - pad, b);
        tma_load_3d(a + A_BYTES, wmap, &full[s], kc, n0, flip ? k - 1 - j : j);
      }
    }
    return;
  }

  // consumers: warpgroup wg multiplies output rows [t0 + 64 wg, + 64). The
  // first product overwrites d (scale-d 0) instead of adding to zeros: with
  // d zeroed, ptxas serialized this kernel's wgmma (warning C7515). The empty
  // asm only tells the compiler that d is defined.
  float d[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "=f"(d[i]));
  const int tid = threadIdx.x % 128, lane = threadIdx.x % 32, warp = tid / 32;
  for (int it = 0; it < iters; ++it) {
    const int s = it % STAGES;
    mbar_wait(&full[s], (it / STAGES) & 1);
    unsigned char* tile = smem + s * STAGE_BYTES + wg * 64 * 128;
    if (LEAKY) {
      // leaky on this warpgroup's 64 rows of A, in place, 16 bytes a thread
      // per pass; then hand the tile back to the async proxy
      uint4* v = reinterpret_cast<uint4*>(tile);
#pragma unroll
      for (int q = 0; q < 64 * 128 / 16 / 128; ++q)
        v[tid + 128 * q] = leaky_bf16x8(v[tid + 128 * q], slope);
      fence_proxy_async();
      asm volatile("bar.sync %0, 128;" ::"r"(2 + wg) : "memory");
    }
    const uint32_t a = smem_u32(tile);
    const uint32_t bw = smem_u32(smem + s * STAGE_BYTES + A_BYTES);
    asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
    fence_operands(d);
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma_m64n128k16(d, kmajor_desc(a + 32 * kk), kmajor_desc(bw + 32 * kk),
                       it > 0 || kk > 0);
    asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
    // the previous step's products are done: release its stage
    asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
    fence_operands(d);
    if (it > 0 && lane == 0) mbar_arrive(&empty[(it - 1) % STAGES]);
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
  fence_operands(d);

  // d[4j + e]: row warp * 16 + lane / 4 (+8 for e >= 2), channel
  // 8j + 2 (lane % 4) + e % 2. Stage the warpgroup's 64 x 128 fp32 tile in
  // the drained ring, then per 8 channels of a row: the epilogue in fp32
  // (16-byte loads of bias, res, g; 32-byte of dcur), one rounding, one
  // 16-byte store.
  asm volatile("bar.sync 1, %0;" ::"n"(32 * CONSUMER_WARPS) : "memory");   // ring drained
  float* stage = reinterpret_cast<float*>(smem) + wg * 64 * OUT_LD;
  const int r = warp * 16 + lane / 4;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int n = 8 * j + 2 * (lane % 4);
    *reinterpret_cast<float2*>(stage + r * OUT_LD + n) = make_float2(d[4 * j], d[4 * j + 1]);
    *reinterpret_cast<float2*>(stage + (r + 8) * OUT_LD + n) =
        make_float2(d[4 * j + 2], d[4 * j + 3]);
  }
  asm volatile("bar.sync %0, 128;" ::"r"(2 + wg) : "memory");   // this warpgroup's tile
#pragma unroll 2
  for (int v = 0; v < 64 * BN / 8 / 128; ++v) {
    const int idx = tid + v * 128, rr = idx / (BN / 8), n = idx % (BN / 8) * 8;
    const int t = t0 + wg * 64 + rr;
    if (t >= Tlen || n0 + n >= Cout) continue;
    const size_t o = ((size_t)b * Tlen + t) * Cout + n0 + n;
    uint4 packed = make_uint4(0, 0, 0, 0);
    __nv_bfloat162* pe = reinterpret_cast<__nv_bfloat162*>(&packed);
    if constexpr (EPI == EPI_BIAS_RES) {
      if (t >= sig0 && t < sig1) {
        const float4 lo = *reinterpret_cast<const float4*>(stage + rr * OUT_LD + n);
        const float4 hi = *reinterpret_cast<const float4*>(stage + rr * OUT_LD + n + 4);
        float f[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
        if (bias != nullptr) {
          const uint4 braw = *reinterpret_cast<const uint4*>(bias + n0 + n);
          const bf16* be = reinterpret_cast<const bf16*>(&braw);
#pragma unroll
          for (int q = 0; q < 8; ++q) f[q] += __bfloat162float(be[q]);
        }
        if (res != nullptr) {
          const uint4 rraw = *reinterpret_cast<const uint4*>(res + o);
          const bf16* re = reinterpret_cast<const bf16*>(&rraw);
#pragma unroll
          for (int q = 0; q < 8; ++q) f[q] += __bfloat162float(re[q]);
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) pe[q] = __floats2bfloat162_rn(f[2 * q], f[2 * q + 1]);
      }
      *reinterpret_cast<uint4*>(out + o) = packed;
    } else {
      float f[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      if (t >= sig0 && t < sig1) {
        const float4 lo = *reinterpret_cast<const float4*>(stage + rr * OUT_LD + n);
        const float4 hi = *reinterpret_cast<const float4*>(stage + rr * OUT_LD + n + 4);
        const float acc[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
        const uint4 sraw = *reinterpret_cast<const uint4*>(res + o);   // the signs
        const bf16* se = reinterpret_cast<const bf16*>(&sraw);
#pragma unroll
        for (int q = 0; q < 8; ++q)
          f[q] = __bfloat162float(se[q]) >= 0.f ? acc[q] : slope * acc[q];
        if constexpr (EPI == MASK_ACC) {
          if (g != nullptr) {   // dcur_old = g / n_branches, the branch's first pair
            const uint4 graw = *reinterpret_cast<const uint4*>(g + o);
            const bf16* ge = reinterpret_cast<const bf16*>(&graw);
#pragma unroll
            for (int q = 0; q < 8; ++q) f[q] += __bfloat162float(ge[q]) * inv;
          } else {
            const float4 p0 = *reinterpret_cast<const float4*>(dcur + o);
            const float4 p1 = *reinterpret_cast<const float4*>(dcur + o + 4);
            const float p[8] = {p0.x, p0.y, p0.z, p0.w, p1.x, p1.y, p1.z, p1.w};
#pragma unroll
            for (int q = 0; q < 8; ++q) f[q] += p[q];
          }
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) pe[q] = __floats2bfloat162_rn(f[2 * q], f[2 * q + 1]);
      }
      if constexpr (EPI == MASK_ACC) {
        *reinterpret_cast<float4*>(dcur + o) = make_float4(f[0], f[1], f[2], f[3]);
        *reinterpret_cast<float4*>(dcur + o + 4) = make_float4(f[4], f[5], f[6], f[7]);
      }
      if (EPI == MASK || out != nullptr) *reinterpret_cast<uint4*>(out + o) = packed;
    }
  }
}

// The conv's pass: conv_pass with the bias / residual epilogue, batch row
// blockIdx.z.
template <bool LEAKY>
__global__ void __launch_bounds__(THREADS, 2)
conv1d_wgmma_kernel(const __grid_constant__ CUtensorMap amap,
                    const __grid_constant__ CUtensorMap wmap, const bf16* __restrict__ bias,
                    const bf16* __restrict__ res, bf16* __restrict__ out, int Tlen, int Cin,
                    int Cout, int k, int dil, float slope, int sig0, int sig1, int flip) {
  conv_pass<LEAKY, EPI_BIAS_RES>(&amap, &wmap, bias, res, out, nullptr, nullptr, 0.f, Tlen, Cin,
                                 Cout, k, dil, slope, sig0, sig1, flip, blockIdx.z);
}

// The stage backward's pass: conv_pass of the adjoint (flip, no leaky) with a
// mask epilogue, for slot blockIdx.z / B of `a` and batch row blockIdx.z % B.
template <int EPI>
__global__ void __launch_bounds__(THREADS, 2)
stage_wgmma_kernel(const __grid_constant__ dm::stage_pass::Args a, int B, int Tlen, int C,
                   float slope, int sig0, int sig1) {
  const int slot = blockIdx.z / B;
  conv_pass<false, EPI>(&a.a[slot], &a.w[slot], nullptr, a.sign[slot], a.out[slot],
                        a.dcur[slot], a.g[slot], a.inv, Tlen, C, C, a.k[slot], a.dil[slot],
                        slope, sig0, sig1, 1, blockIdx.z % B);
}

// The tensor map of an activation (B, T, C) as (C, T, B): a box (BK, BM)
// lands as 128 K-major rows of 64 channels; a tap's row shift moves whole
// 128-B rows.
int encode_rows(CUtensorMap* map, const void* base, int B, int Tlen, int C) {
  const cuuint64_t dim[3] = {(cuuint64_t)C, (cuuint64_t)Tlen, (cuuint64_t)B};
  const cuuint64_t stride[2] = {(cuuint64_t)C * 2, (cuuint64_t)Tlen * C * 2};
  const cuuint32_t box[3] = {BK, BM, 1};
  return encode_bf16(map, base, 3, dim, stride, box);
}

// The tensor map of k weight matrices (k, N, K), K innermost, as (K, N, k):
// the tap-major copy (k, Cout, Cin) of the forward, or w (k, Cin, Cout) as it
// lies for the adjoint.
int encode_taps(CUtensorMap* map, const void* w, int k, int kdim, int ndim) {
  const cuuint64_t dim[3] = {(cuuint64_t)kdim, (cuuint64_t)ndim, (cuuint64_t)k};
  const cuuint64_t stride[2] = {(cuuint64_t)kdim * 2, (cuuint64_t)kdim * ndim * 2};
  const cuuint32_t box[3] = {BK, BN, 1};
  return encode_bf16(map, w, 3, dim, stride, box);
}

template <bool LEAKY>
int opt_in() {   // more than 48 KB of dynamic shared memory, once per instantiation
  static bool done = false;
  if (!done) {
    cudaError_t err = cudaFuncSetAttribute(conv1d_wgmma_kernel<LEAKY>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM);
    if (err != cudaSuccess) return (int)err;
    done = true;
  }
  return 0;
}

template <int EPI>
int opt_in_stage() {   // the same, for the stage backward's passes
  static bool done = false;
  if (!done) {
    cudaError_t err = cudaFuncSetAttribute(stage_wgmma_kernel<EPI>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM);
    if (err != cudaSuccess) return (int)err;
    done = true;
  }
  return 0;
}

// One pass on the current stream; the maps are passed by value (__grid_constant__).
int pass(const CUtensorMap& amap, const CUtensorMap& wmap, const void* bias, const void* res,
         void* out, int B, int Tlen, int Cin, int Cout, int k, int dil, bool leaky, float slope,
         int sig0, int sig1, int flip, cudaStream_t s) {
  const int rc = leaky ? opt_in<true>() : opt_in<false>();
  if (rc != 0) return rc;
  const dim3 grid((Tlen + BM - 1) / BM, (Cout + BN - 1) / BN, B);
  if (leaky)
    conv1d_wgmma_kernel<true><<<grid, THREADS, SMEM, s>>>(
        amap, wmap, (const bf16*)bias, (const bf16*)res, (bf16*)out, Tlen, Cin, Cout, k, dil,
        slope, sig0, sig1, flip);
  else
    conv1d_wgmma_kernel<false><<<grid, THREADS, SMEM, s>>>(
        amap, wmap, (const bf16*)bias, (const bf16*)res, (bf16*)out, Tlen, Cin, Cout, k, dil,
        slope, sig0, sig1, flip);
  return (int)cudaGetLastError();
}

int single(const void* x, const void* wmap, const void* b, const void* res, void* y, int B,
           int Tlen, int Cin, int Cout, int k, int dil, float slope, int has_slope, int sig0,
           int sig1, int adjoint, cudaStream_t s) {
  alignas(64) CUtensorMap xmap, wm;
  const int rc = encode_rows(&xmap, x, B, Tlen, Cin);
  if (rc != 0) return rc;
  memcpy(&wm, wmap, sizeof(CUtensorMap));
  return pass(xmap, wm, b, res, y, B, Tlen, Cin, Cout, k, dil, has_slope != 0, slope, sig0,
              sig1, adjoint, s);
}

int pair(const void* x, const void* w1map, const void* b1, const void* w2map, const void* b2,
         void* y, void* h, int B, int Tlen, int C, int k, int dil, float slope, int sig0,
         int sig1, cudaStream_t s) {
  alignas(64) CUtensorMap xmap, hmap, w1, w2;
  int rc = encode_rows(&xmap, x, B, Tlen, C);
  if (rc == 0) rc = encode_rows(&hmap, h, B, Tlen, C);
  if (rc != 0) return rc;
  memcpy(&w1, w1map, sizeof(CUtensorMap));
  memcpy(&w2, w2map, sizeof(CUtensorMap));
  rc = pass(xmap, w1, b1, nullptr, h, B, Tlen, C, C, k, dil, true, slope, sig0, sig1, 0, s);
  if (rc != 0) return rc;
  return pass(hmap, w2, b2, x, y, B, Tlen, C, C, k, 1, true, slope, sig0, sig1, 0, s);
}

int stage(const dm::stage_pass::Args& a, int epi, int B, int Tlen, int C, float slope,
          int sig0, int sig1, cudaStream_t s) {
  if (a.slots < 1 || a.slots > dm::stage_pass::MAX_BRANCHES || (epi != MASK && epi != MASK_ACC))
    return (int)cudaErrorInvalidValue;
  const int rc = epi == MASK ? opt_in_stage<MASK>() : opt_in_stage<MASK_ACC>();
  if (rc != 0) return rc;
  const dim3 grid((Tlen + BM - 1) / BM, (C + BN - 1) / BN, a.slots * B);
  if (epi == MASK)
    stage_wgmma_kernel<MASK><<<grid, THREADS, SMEM, s>>>(a, B, Tlen, C, slope, sig0, sig1);
  else
    stage_wgmma_kernel<MASK_ACC><<<grid, THREADS, SMEM, s>>>(a, B, Tlen, C, slope, sig0, sig1);
  return (int)cudaGetLastError();
}

}  // namespace tc

}  // namespace

namespace dm {
namespace stage_pass {

int encode_rows(CUtensorMap* map, const void* base, int B, int Tlen, int C) {
  return tc::encode_rows(map, base, B, Tlen, C);
}

int launch(const Args& a, int epi, int B, int Tlen, int C, float slope, int sig0, int sig1,
           cudaStream_t s) {
  return tc::stage(a, epi, B, Tlen, C, slope, sig0, sig1, s);
}

size_t smem() { return tc::SMEM; }

}  // namespace stage_pass
}  // namespace dm

// dtype: 0 = float32, 1 = bfloat16. x (B, Tlen, Cin), y (B, Tlen, Cout); the
// signal is rows [sig0, sig1) of the Tlen; b and res may be null. fp32 reads w
// (k, Cin, Cout), or with `adjoint` (k, Cout, Cin) as the flipped transposed
// kernel, itself. For bf16 (Cin and Cout multiples of 64), w is the host
// address of the 128-byte tensor map that dm_conv1d_wmap encoded: of the
// weights' tap-major copy (k, Cout, Cin), or with `adjoint` of the weight
// tensor itself. Returns a cudaError_t (0 = launched).
extern "C" int dm_conv1d_fused(int dtype, const void* x, const void* w, const void* b,
                               const void* res, void* y, int B, int Tlen, int Cin, int Cout,
                               int k, int dil, float slope, int has_slope, int sig0, int sig1,
                               int adjoint, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 1)
    return tc::single(x, w, b, res, y, B, Tlen, Cin, Cout, k, dil, slope, has_slope, sig0,
                      sig1, adjoint, s);
  return run_fused_fp32(x, w, b, res, y, B, Tlen, Cin, Cout, k, dil, slope, has_slope, sig0,
                        sig1, adjoint, s);
}

// The pair: x (B, Tlen, C), w1 and w2 (k, C, C), b1 and b2 (C,), y and h
// (B, Tlen, C); C % 64 == 0. For bf16, w1 and w2 are the host addresses of
// the 128-byte tensor maps of the weights' tap-major copies, which
// dm_conv1d_wmap encodes once per copy; the call launches the two passes of
// the TMA + wgmma kernel. fp32 reads the weights themselves.
// Returns a cudaError_t (0 = launched).
extern "C" int dm_conv1d_pair(int dtype, const void* x, const void* w1, const void* b1,
                              const void* w2, const void* b2, void* y, void* h, int B,
                              int Tlen, int C, int k, int dil, float slope, int sig0, int sig1,
                              void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 1) return tc::pair(x, w1, b1, w2, b2, y, h, B, Tlen, C, k, dil, slope, sig0, sig1, s);
  return run_pair_fp32(x, w1, b1, w2, b2, y, h, B, Tlen, C, k, dil, slope, sig0, sig1, s);
}

// Writes into `map` (128 bytes of host memory) the tensor map through which
// the bf16 kernel reads k weight matrices (k, ndim, kdim) that lie on the
// card, kdim innermost: a tap-major copy (k, Cout, Cin) of the forward, or a
// weight (k, Cin, Cout) itself for the adjoint. Returns a cudaError_t (0 =
// encoded).
extern "C" int dm_conv1d_wmap(const void* w, int k, int kdim, int ndim, void* map) {
  alignas(64) CUtensorMap m;
  const int rc = tc::encode_taps(&m, w, k, kdim, ndim);
  if (rc == 0) memcpy(map, &m, sizeof(CUtensorMap));
  return rc;
}

extern "C" size_t dm_conv1d_fused_smem(int dtype, int k, int dil) {
  return dtype == 1 ? tc::SMEM : fused_smem<float>(k, dil);
}

extern "C" size_t dm_conv1d_pair_smem(int dtype, int C, int k, int dil) {
  return dtype == 1 ? tc::SMEM : pair_smem<float>(C, k, dil);
}
