// HiFi-GAN upsampler forward on Hopper: phase-decomposed ConvTranspose1d.
//
// Replaces diffmusic_tpu/pallas/upsampler_kernel.py::phase_convtranspose
// (_phase_ct_pallas). With p_ct = (k - stride) / 2 and t = stride * tp + rho,
// torch ConvTranspose1d semantics give
//     y[stride*tp + rho] = sum_d x[tp + d] @ W[rho + p_ct - stride*d]
// over the d that make the tap index valid. Layout (B, T, C); W (k, Cin, Cout).
//
// Bound: tensor-core work. Per phase the taps are k / stride shifted
// products of (rows x Cin) @ (Cin x Cout): 16.8, 21.0 and 10.5 GFLOP at the
// 10-s slice's three upsamplers, 0.049 ms a guided step at the card's bf16
// peak; the bytes (x, w, y once each) take less. The lhs-dilated form would
// multiply the interleaved zeros too; the phases skip them.
//
// bf16: `phase_ct_wgmma_kernel`, an implicit GEMM on wgmma fed by TMA, one
// phase per block: D (output rows tp x Cout) = sum over (channel slice,
// tap) of X_d (rows x BK) @ W_j (BK x Cout).
//   - A block owns BM = 128 rows tp of one phase rho x BN = 128 output
//     channels; the grid is (row tiles, Cout tiles, batch x phase), so the
//     1000-row input of upsampler 0 still gives 160 blocks.
//   - It walks (channel slice of BK = 64, tap j of its phase). Each step's
//     operands arrive by TMA into a 3-stage shared-memory ring with an
//     mbarrier per stage (two blocks share an SM), fed by one producer thread
//     while two consumer warpgroups multiply:
//       A, the input window: one box (64 channels, 128 rows) of x (B, T, Cin)
//         starting at row tp0 + d. Channels are innermost, so the tap's row
//         shift d moves whole 128-byte rows (a TMA box must start 16-byte
//         aligned in its innermost dimension) and needs no copy of x; TMA
//         fills rows before 0 or past T with zeros, the transposed conv's
//         missing inputs, with no predicate.
//       B, the tap's weights: one box (64 channels, 128 outputs) of the
//         tap-major copy (k, Cout, Cin) that the wrapper makes once per
//         weight tensor.
//     Both land as K-major rows of 64 channels (128 B), swizzled 128 B: the
//     layout wgmma reads at full rate.
//   - Each consumer warpgroup runs wgmma m64n128k16 (bf16 -> fp32 registers)
//     on its 64 rows, keeping one group in flight, and releases a stage as
//     soon as its products are done.
//   - Epilogue: the bias added in fp32, one rounding to bf16, the tile staged
//     in the drained ring, then each output row stride * tp + rho written as
//     256 contiguous bytes of 16-byte vectors; rows at or past t_out are not.
// So loads overlap the products, each weight box is read by the TMA engine
// and not by the threads, and every store is a full 16-byte vector.
//
// fp32: `phase_ct_kernel`, the exact scalar path (dm::TileAcc, fp32 FMAs on
// a staged window), which serves the 1e-4 checks and the card-against-CPU
// reference runs (TF32 would break them).
#include "common.cuh"
#include "hopper.cuh"

namespace {

using dm::bf16;

// ------------------------------------------------------ the exact scalar path
constexpr int BM = 64, BN = 64, BK = 32, THREADS = 128;

__global__ void __launch_bounds__(THREADS)
phase_ct_kernel(const float* __restrict__ x, const float* __restrict__ w,
                const float* __restrict__ bias, float* __restrict__ y, int Tin, int Cin, int Cout,
                int k, int stride, int d_lo, int d_hi, int t_out) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int lda = dm::smem_ld<float>(BK), ldb = dm::smem_ld<float>(BN), ldc = dm::acc_ld(BN);
  const int win_rows = BM + d_hi - d_lo;
  float* win = reinterpret_cast<float*>(smem);
  float* wt = reinterpret_cast<float*>(smem + dm::align128((size_t)win_rows * lda * 4));
  float* stage = reinterpret_cast<float*>(
      reinterpret_cast<unsigned char*>(wt) + dm::align128((size_t)BK * ldb * 4));

  const int tp0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int b = blockIdx.z / stride, rho = blockIdx.z % stride;
  const int p_ct = (k - stride) / 2;
  const float* xb = x + (size_t)b * Tin * Cin;

  dm::TileAcc<float, BM, BN, 2, 2> acc;
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
    y[((size_t)b * t_out + t) * Cout + n0 + c] = stage[r * ldc + c] + bias[n0 + c];
  }
}

size_t ct_smem(int d_lo, int d_hi) {
  return dm::align128((size_t)(BM + d_hi - d_lo) * dm::smem_ld<float>(BK) * 4) +
         dm::align128((size_t)BK * dm::smem_ld<float>(BN) * 4) +
         (size_t)BM * dm::acc_ld(BN) * 4;
}

int run_fp32(const void* x, const void* w, const void* b, void* y, int B, int Tin, int Cin,
             int Cout, int k, int stride, int d_lo, int d_hi, int t_out, cudaStream_t s) {
  const int rows = (t_out + stride - 1) / stride;
  dim3 grid((rows + BM - 1) / BM, Cout / BN, B * stride);
  return dm::launch(phase_ct_kernel, grid, dim3(THREADS), ct_smem(d_lo, d_hi), s,
                    (const float*)x, (const float*)w, (const float*)b, (float*)y, Tin, Cin, Cout,
                    k, stride, d_lo, d_hi, t_out);
}

// ------------------------------------------------- the bf16 TMA + wgmma path
namespace tc {

using namespace dm::hopper;

constexpr int BM = 128;                      // output rows of one phase per block (2 x 64)
constexpr int BN = 128;                      // output channels per block
constexpr int BK = 64;                       // input channels per step
constexpr int STAGES = 3;                    // depth of the shared-memory ring
constexpr int A_BYTES = BM * BK * 2;         // 16 KB of input window per stage
constexpr int B_BYTES = BN * BK * 2;         // 16 KB of weights per stage
constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
constexpr int CONSUMER_WARPS = 8;            // warpgroups 0-1
constexpr int THREADS = 32 * CONSUMER_WARPS + 32;   // + one producer warp
constexpr int PRODUCER = 32 * CONSUMER_WARPS;
constexpr int OUT_LD = BN + 8;   // staged output rows: 272 bytes, 8 rows on 8 bank quarters
static_assert(BM * OUT_LD * 2 <= STAGES * STAGE_BYTES, "the staged tile fits the ring");
constexpr size_t SMEM = (size_t)STAGES * STAGE_BYTES + 2 * STAGES * sizeof(uint64_t) + 1024;

// Two blocks share an SM (99 KB of shared memory each), so one block's
// epilogue and ring fill overlap the other's products.
__global__ void __launch_bounds__(THREADS, 2)
phase_ct_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                      const __grid_constant__ CUtensorMap wmap, const bf16* __restrict__ bias,
                      bf16* __restrict__ y, int Cin, int Cout, int k, int stride, int t_out) {
  extern __shared__ unsigned char smem_raw[];
  // 1024-byte alignment: the 128-B swizzle pattern repeats every 8 rows
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + STAGES * STAGE_BYTES);
  uint64_t* empty = full + STAGES;

  const int tp0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int b = blockIdx.z / stride, rho = blockIdx.z % stride;
  const int p_ct = (k - stride) / 2;
  // the phase's taps: j = j0, j0 + stride, ... < k, each at row offset
  // d = (rho + p_ct - j) / stride (exact)
  const int j0 = (rho + p_ct) % stride;
  const int taps = (k - j0 + stride - 1) / stride;
  const int iters = (Cin + BK - 1) / BK * taps;

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
        const int kc = (it / taps) * BK, j = j0 + (it % taps) * stride;
        const int d = (rho + p_ct - j) / stride;
        unsigned char* a = smem + s * STAGE_BYTES;
        mbar_expect_tx(&full[s], STAGE_BYTES);
        tma_load_3d(a, &xmap, &full[s], kc, tp0 + d, b);
        tma_load_3d(a + A_BYTES, &wmap, &full[s], kc, n0, j);
      }
    }
    return;
  }

  // consumers: warpgroup wg multiplies output rows [tp0 + 64 wg, + 64)
  float d[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) d[i] = 0.f;
  const int lane = threadIdx.x % 32, warp = (threadIdx.x % 128) / 32;
  for (int it = 0; it < iters; ++it) {
    const int s = it % STAGES;
    mbar_wait(&full[s], (it / STAGES) & 1);
    const uint32_t a = smem_u32(smem + s * STAGE_BYTES) + wg * 64 * 128;
    const uint32_t bw = smem_u32(smem + s * STAGE_BYTES + A_BYTES);
    asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
    fence_operands(d);
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma_m64n128k16(d, kmajor_desc(a + 32 * kk), kmajor_desc(bw + 32 * kk));
    asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
    fence_operands(d);
    // the previous step's products are done: release its stage
    asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
    fence_operands(d);
    if (it > 0 && lane == 0) mbar_arrive(&empty[(it - 1) % STAGES]);
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
  fence_operands(d);

  // d[4j + e]: row warp * 16 + lane / 4 (+8 for e >= 2), channel
  // 8j + 2 (lane % 4) + e % 2. Stage the warpgroup's 64 x 128 tile in the
  // drained ring, then write each output row's 128 channels as 16-byte
  // vectors.
  asm volatile("bar.sync 1, %0;" ::"n"(32 * CONSUMER_WARPS) : "memory");   // ring drained
  bf16* tile = reinterpret_cast<bf16*>(smem) + wg * 64 * OUT_LD;
  const int r = warp * 16 + lane / 4;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int n = 8 * j + 2 * (lane % 4);
    const float b0 = n0 + n < Cout ? __bfloat162float(bias[n0 + n]) : 0.f;
    const float b1 = n0 + n + 1 < Cout ? __bfloat162float(bias[n0 + n + 1]) : 0.f;
    *reinterpret_cast<__nv_bfloat162*>(tile + r * OUT_LD + n) =
        __floats2bfloat162_rn(d[4 * j] + b0, d[4 * j + 1] + b1);
    *reinterpret_cast<__nv_bfloat162*>(tile + (r + 8) * OUT_LD + n) =
        __floats2bfloat162_rn(d[4 * j + 2] + b0, d[4 * j + 3] + b1);
  }
  asm volatile("bar.sync %0, 128;" ::"r"(2 + wg) : "memory");   // this warpgroup's tile
#pragma unroll
  for (int v = 0; v < 64 * BN / 8 / 128; ++v) {
    const int idx = threadIdx.x % 128 + v * 128, rr = idx / (BN / 8), n = idx % (BN / 8) * 8;
    const long t = (long)(tp0 + wg * 64 + rr) * stride + rho;
    if (t < t_out && n0 + n < Cout)
      *reinterpret_cast<uint4*>(y + ((size_t)b * t_out + t) * Cout + n0 + n) =
          *reinterpret_cast<const uint4*>(tile + rr * OUT_LD + n);
  }
}

int launch(const void* x, const void* w_taps, const void* b, void* y, int B, int Tin, int Cin,
           int Cout, int k, int stride, int t_out, cudaStream_t s) {
  alignas(64) CUtensorMap xmap, wmap;
  // x (B, Tin, Cin) as (Cin, Tin, B): a box (BK, BM) lands as 128 K-major
  // rows of 64 channels; a tap's row shift moves whole 128-B rows
  const cuuint64_t xdim[3] = {(cuuint64_t)Cin, (cuuint64_t)Tin, (cuuint64_t)B};
  const cuuint64_t xstride[2] = {(cuuint64_t)Cin * 2, (cuuint64_t)Tin * Cin * 2};
  const cuuint32_t xbox[3] = {BK, BM, 1};
  int rc = encode_bf16(&xmap, x, 3, xdim, xstride, xbox);
  if (rc != 0) return rc;
  // the tap-major weights (k, Cout, Cin) as (Cin, Cout, k)
  const cuuint64_t wdim[3] = {(cuuint64_t)Cin, (cuuint64_t)Cout, (cuuint64_t)k};
  const cuuint64_t wstride[2] = {(cuuint64_t)Cin * 2, (cuuint64_t)Cout * Cin * 2};
  const cuuint32_t wbox[3] = {BK, BN, 1};
  rc = encode_bf16(&wmap, w_taps, 3, wdim, wstride, wbox);
  if (rc != 0) return rc;
  cudaError_t err = cudaFuncSetAttribute(phase_ct_wgmma_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM);
  if (err != cudaSuccess) return (int)err;
  const int rows = (t_out + stride - 1) / stride;
  const dim3 grid((rows + BM - 1) / BM, (Cout + BN - 1) / BN, B * stride);
  phase_ct_wgmma_kernel<<<grid, THREADS, SMEM, s>>>(xmap, wmap, (const bf16*)b, (bf16*)y, Cin,
                                                     Cout, k, stride, t_out);
  return (int)cudaGetLastError();
}

}  // namespace tc

}  // namespace

// x (B, Tin, Cin), w (k, Cin, Cout), b (Cout,), y (B, t_out, Cout); Cin % 32
// == 0, Cout % 64 == 0, k >= stride; d_lo, d_hi the taps' row offsets.
// dtype: 0 = float32, 1 = bfloat16. For bf16, w_taps is w's tap-major copy
// (k, Cout, Cin), which the TMA + wgmma kernel reads instead of w; fp32 reads
// w and takes null. Returns a cudaError_t (0 = launched).
extern "C" int dm_phase_convtranspose(int dtype, const void* x, const void* w,
                                      const void* w_taps, const void* b, void* y, int B, int Tin,
                                      int Cin, int Cout, int k, int stride, int d_lo, int d_hi,
                                      int t_out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 1) {
    if (w_taps == nullptr) return (int)cudaErrorInvalidValue;
    return tc::launch(x, w_taps, b, y, B, Tin, Cin, Cout, k, stride, t_out, s);
  }
  return run_fp32(x, w, b, y, B, Tin, Cin, Cout, k, stride, d_lo, d_hi, t_out, s);
}

extern "C" size_t dm_phase_convtranspose_smem(int dtype, int d_lo, int d_hi) {
  return dtype == 1 ? tc::SMEM : ct_smem(d_lo, d_hi);
}
