// 'same' 2-D convolution (stride 1, odd kh x kw, + bias) over NCHW on Hopper.
//
// Replaces diffmusic_tpu/pallas/conv2d_kernel.py::conv2d_same_fused
// (_conv2d_pallas), forward only.
//
// Bound: tensor-core work. The UNet's and the VAE decoder's 3x3 convs are
// GEMMs of N = H*W output pixels, M = Cout, K = kh*kw*Cin: 19 GFLOP at
// (250, 16) with 512 channels, 75 at (500, 32), 0.65 ms per guided step at
// the card's bf16 peak (989 TFLOP/s). The product is the transposed one,
// y^T (Cout x pixels) = W (Cout x K) @ X (K x pixels), so that an output row
// is one output channel's pixels, written contiguously into NCHW y.
//
// bf16: `conv2d_wgmma_kernel`, an implicit GEMM on wgmma fed by TMA.
//   - A block owns BM = 128 output channels x BN = 128 pixels: R whole image
//     rows of wp columns, wp = W rounded up to a power of two (wider images
//     take 128-column tiles), so a tile never splits an image row.
//   - It walks (channel slice of BK = 64, tap). Each step's operands arrive by
//     TMA into a 3-stage shared-memory ring with an mbarrier per stage (two
//     blocks share an SM), fed by one producer thread while two consumer
//     warpgroups multiply:
//       A, the tap's weights: one box of the tap-major copy (kh*kw, Cout, Cin)
//         that the wrapper makes once per weight tensor;
//       B, the tap's input window: one box (64 channels, wp, R) of the NHWC
//         copy of x that `nchw_to_nhwc_kernel` writes first in the same call
//         (64 x 64 tiles through shared memory), started at the tap's own
//         (w + dw, h + dh). TMA fills what lies outside the image with zeros,
//         which is the 'same' padding, with no predicate and no padded copy.
//     Both land as K-major rows of 64 channels (128 B), swizzled 128 B: the
//     layout wgmma reads at full rate.
//   - Why NHWC: a TMA box must start 16-byte aligned in the innermost
//     dimension. Over NCHW rows the tap's +-1 column shift is a 2-byte start,
//     which the card refuses (an illegal-instruction fault, found on the
//     H100); with channels innermost the shift moves whole 128-byte rows.
//   - Each consumer warpgroup runs wgmma m64n128k16 (bf16 -> fp32 registers)
//     on its 64 output channels, keeping one group in flight, and releases a
//     stage as soon as its products are done. The epilogue adds the bias in
//     registers; where the tile is whole image rows (W = wp, every slice
//     geometry) it stages the bf16 tile in the drained ring and writes each
//     channel's 128 pixels as 16-byte vectors, else bf16 pairs straight into
//     NCHW y.
//   - A grid smaller than the card (the 1000-pixel geometries: 16 blocks)
//     splits the steps across a cluster of up to 8 blocks along z, up to a
//     block an SM; their fp32 partial tiles are summed through distributed
//     shared memory, each block its share of the rows, with no extra launch.
// So the weights are read once per block and channel slice by the TMA engine
// (not per tap, 2 bytes a thread), every tap's window is one asynchronous
// copy, and loads overlap the products.
//
// fp32: `conv2d_same_kernel`, the exact scalar path (dm::TileAcc, fp32 FMAs)
// with per-pixel predicated loads, which serves the 1e-4 checks and the
// card-against-CPU reference runs (TF32 would break them).
#include "common.cuh"
#include "hopper.cuh"

namespace {

using dm::bf16;

// ------------------------------------------------------ the exact scalar path
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

// ------------------------------------------------- the bf16 TMA + wgmma path
namespace tc {

using namespace dm::hopper;

constexpr int BM = 128;                      // output channels per block (2 x 64)
constexpr int BN = 128;                      // output pixels per block
constexpr int BK = 64;                       // input channels per step
constexpr int STAGES = 3;                    // depth of the shared-memory ring
constexpr int A_BYTES = BM * BK * 2;         // 16 KB of weights per stage
constexpr int B_BYTES = BN * BK * 2;         // 16 KB of input window per stage
constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
constexpr int CONSUMER_WARPS = 8;            // warpgroups 0-1
constexpr int THREADS = 32 * CONSUMER_WARPS + 32;   // + one producer warp
constexpr int PRODUCER = 32 * CONSUMER_WARPS;
constexpr int OUT_LD = BN + 8;   // staged output rows: 272 bytes, 8 rows on 8 bank quarters
constexpr int PART_LD = BN + 4;  // fp32 partial-sum rows of a split-K cluster
constexpr int MAX_SPLITS = 8;    // the portable cluster size
static_assert((size_t)BM * PART_LD * 4 <= (size_t)STAGES * STAGE_BYTES, "partials fit the ring");
constexpr size_t SMEM = (size_t)STAGES * STAGE_BYTES + 2 * STAGES * sizeof(uint64_t) + 1024;

// log2_wp: log2 of the pixel tile's width wp (wp x BN / wp pixels). Two
// blocks share an SM (99 KB of shared memory each), so one block's epilogue
// and ring fill overlap the other's products. splits > 1 (small grids): the
// `splits` blocks of a cluster along z share one output tile, each taking a
// contiguous share of the (channel slice, tap) steps; their fp32 partial
// tiles meet in shared memory, and each block sums its share of the rows
// across the cluster and writes them.
__global__ void __launch_bounds__(THREADS, 2)
conv2d_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                    const __grid_constant__ CUtensorMap wmap, const bf16* __restrict__ bias,
                    bf16* __restrict__ y, int Cin, int Cout, int H, int W, int kh, int kw,
                    int log2_wp, int col_tiles, int splits) {
  const int wp = 1 << log2_wp, rows = BN >> log2_wp;
  extern __shared__ unsigned char smem_raw[];
  // 1024-byte alignment: the 128-B swizzle pattern repeats every 8 rows
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + STAGES * STAGE_BYTES);
  uint64_t* empty = full + STAGES;

  const int h0 = (blockIdx.x / col_tiles) * rows, w0 = (blockIdx.x % col_tiles) * wp;
  const int m0 = blockIdx.y * BM, b = blockIdx.z / splits, split = blockIdx.z % splits;
  const int taps = kh * kw, total = (Cin + BK - 1) / BK * taps;
  const int it0 = total * split / splits, iters = total * (split + 1) / splits - it0;

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
        const int kc = ((it0 + it) / taps) * BK, t = (it0 + it) % taps;
        unsigned char* a = smem + s * STAGE_BYTES;
        mbar_expect_tx(&full[s], STAGE_BYTES);
        tma_load_3d(a, &wmap, &full[s], kc, m0, t);
        tma_load_4d(a + A_BYTES, &xmap, &full[s], kc, w0 + t % kw - kw / 2,
                    h0 + t / kw - kh / 2, b);
      }
    }
    if (splits > 1) {   // the cluster's two barriers count every thread
      cluster_sync();
      cluster_sync();
    }
    return;
  }

  // consumers: warpgroup wg multiplies output channels [m0 + 64 wg, + 64)
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
    for (int k = 0; k < BK / 16; ++k)
      wgmma_m64n128k16(d, kmajor_desc(a + 32 * k), kmajor_desc(bw + 32 * k));
    asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
    fence_operands(d);
    // the previous step's products are done: release its stage
    asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
    fence_operands(d);
    if (it > 0 && lane == 0) mbar_arrive(&empty[(it - 1) % STAGES]);
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
  fence_operands(d);

  if (splits > 1) {
    asm volatile("bar.sync 1, %0;" ::"n"(32 * CONSUMER_WARPS) : "memory");   // ring drained
    float* part = reinterpret_cast<float*>(smem);   // [BM][PART_LD] fp32
    const int r = wg * 64 + warp * 16 + lane / 4;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int n = 8 * j + 2 * (lane % 4);
      *reinterpret_cast<float2*>(part + r * PART_LD + n) = make_float2(d[4 * j], d[4 * j + 1]);
      *reinterpret_cast<float2*>(part + (r + 8) * PART_LD + n) =
          make_float2(d[4 * j + 2], d[4 * j + 3]);
    }
    cluster_sync();   // every block's partial tile is in its shared memory
    const int rows_per = BM / splits, items = rows_per * (BN / 4);
    for (int i = threadIdx.x; i < items; i += 32 * CONSUMER_WARPS) {
      const int rr = split * rows_per + i / (BN / 4), n = i % (BN / 4) * 4;
      const int m = m0 + rr;
      const float4* mine = reinterpret_cast<const float4*>(part + rr * PART_LD + n);
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int q = 0; q < splits; ++q) {
        const float4 v = *cluster_peer(mine, q);
        acc.x += v.x; acc.y += v.y; acc.z += v.z; acc.w += v.w;
      }
      if (m >= Cout) continue;
      const float bb = __bfloat162float(bias[m]);
      const float vals[4] = {acc.x + bb, acc.y + bb, acc.z + bb, acc.w + bb};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = h0 + ((n + e) >> log2_wp), w = w0 + ((n + e) & (wp - 1));
        if (h < H && w < W)
          y[(((size_t)b * Cout + m) * H + h) * W + w] = __float2bfloat16_rn(vals[e]);
      }
    }
    cluster_sync();   // no block leaves while its partials may still be read
    return;
  }

  // d[4j + e]: channel row0 (+8 for e >= 2), pixel 8j + 2 (lane % 4) + e % 2
  const int row0 = m0 + wg * 64 + warp * 16 + lane / 4;
  const float bias0 = row0 < Cout ? __bfloat162float(bias[row0]) : 0.f;
  const float bias1 = row0 + 8 < Cout ? __bfloat162float(bias[row0 + 8]) : 0.f;
  if (wp == W && W % 8 == 0) {
    // the tile's pixels are whole image rows, contiguous in each channel row
    // of y: stage the warpgroup's 64 x 128 tile in the drained ring, then
    // write 256-byte runs of 16-byte vectors
    asm volatile("bar.sync 1, %0;" ::"n"(32 * CONSUMER_WARPS) : "memory");   // ring drained
    bf16* tile = reinterpret_cast<bf16*>(smem) + wg * 64 * OUT_LD;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int n = 8 * j + 2 * (lane % 4), r = warp * 16 + lane / 4;
      *reinterpret_cast<__nv_bfloat162*>(tile + r * OUT_LD + n) =
          __floats2bfloat162_rn(d[4 * j] + bias0, d[4 * j + 1] + bias0);
      *reinterpret_cast<__nv_bfloat162*>(tile + (r + 8) * OUT_LD + n) =
          __floats2bfloat162_rn(d[4 * j + 2] + bias1, d[4 * j + 3] + bias1);
    }
    asm volatile("bar.sync %0, 128;" ::"r"(2 + wg) : "memory");   // this warpgroup's tile
    const size_t pix0 = (size_t)h0 * W, npix = (size_t)H * W;
#pragma unroll
    for (int v = 0; v < 64 * BN / 8 / 128; ++v) {
      const int idx = threadIdx.x % 128 + v * 128, r = idx / (BN / 8), n = idx % (BN / 8) * 8;
      const int m = m0 + wg * 64 + r;
      if (m < Cout && pix0 + n < npix)
        *reinterpret_cast<uint4*>(y + ((size_t)b * Cout + m) * npix + pix0 + n) =
            *reinterpret_cast<const uint4*>(tile + r * OUT_LD + n);
    }
    return;
  }
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int n = 8 * j + 2 * (lane % 4);
    const int h = h0 + (n >> log2_wp), w = w0 + (n & (wp - 1));
    if (h >= H || w >= W) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = row0 + 8 * half;
      if (m >= Cout) continue;
      const float bb = half ? bias1 : bias0;
      const size_t at = (((size_t)b * Cout + m) * H + h) * W + w;
      const float v0 = d[4 * j + 2 * half] + bb, v1 = d[4 * j + 2 * half + 1] + bb;
      bf16* dst = y + at;
      if (w + 1 < W && at % 2 == 0) {
        *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(v0, v1);
      } else {   // odd W: the pair straddles a row or an odd address
        dst[0] = __float2bfloat16_rn(v0);
        if (w + 1 < W) dst[1] = __float2bfloat16_rn(v1);
      }
    }
  }
}

// x (B, C, P) -> x_nhwc (B, P, C), P = H*W, C % 8 == 0: one 64 x 64 tile
// per block through shared memory. Loads are 16 bytes along the pixels (2
// where P % 8 != 0) and land as 128-byte rows, one per quarter warp; a warp
// reads back 8 pixels x 4 groups of 8 channels and stores 64 contiguous
// bytes per pixel. The tile's 16-byte columns are swizzled by the channel
// group (column ^ c / 8), so those 4 groups read 4 different bank quarters.
constexpr int TT = 64;           // tile edge
constexpr int TT_THREADS = 256;
constexpr int TT_VECS = TT * TT / 8 / TT_THREADS;   // 16-byte vectors per thread

__global__ void __launch_bounds__(TT_THREADS)
nchw_to_nhwc_kernel(const bf16* __restrict__ x, bf16* __restrict__ xh, int C, int P) {
  __shared__ __align__(16) bf16 tile[TT][TT];   // [channel][swizzled pixel]
  auto at = [](int c, int p) { return ((p / 8) ^ (c / 8 % 8)) * 8 + p % 8; };
  const int p0 = blockIdx.x * TT, c0 = blockIdx.y * TT;
  const bf16* src = x + ((size_t)blockIdx.z * C + c0) * P;
#pragma unroll
  for (int r = 0; r < TT_VECS; ++r) {
    const int i = threadIdx.x + r * TT_THREADS;
    const int c = i / (TT / 8), p = (i % (TT / 8)) * 8;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (c0 + c < C) {
      const bf16* row = src + (size_t)c * P + p0 + p;
      if (P % 8 == 0) {
        if (p0 + p < P) v = *reinterpret_cast<const uint4*>(row);
      } else {
        bf16* e = reinterpret_cast<bf16*>(&v);
#pragma unroll
        for (int q = 0; q < 8; ++q)
          if (p0 + p + q < P) e[q] = row[q];
      }
    }
    *reinterpret_cast<uint4*>(&tile[c][at(c, p)]) = v;
  }
  __syncthreads();
  bf16* dst = xh + (size_t)blockIdx.z * P * C + c0;
#pragma unroll
  for (int r = 0; r < TT_VECS; ++r) {
    const int i = threadIdx.x + r * TT_THREADS, lane = i % 32, w = i / 32;
    const int p = (w % 8) * 8 + lane % 8, c = ((w / 8) * 4 + lane / 8) * 8;
    if (p0 + p >= P || c0 + c >= C) continue;
    uint4 v;
    bf16* e = reinterpret_cast<bf16*>(&v);
#pragma unroll
    for (int q = 0; q < 8; ++q) e[q] = tile[c + q][at(c, p)];
    *reinterpret_cast<uint4*>(dst + (size_t)(p0 + p) * C + c) = v;
  }
}

int launch(const void* x, void* x_nhwc, const void* w_taps, const void* b, void* y, int B,
           int Cin, int Cout, int H, int W, int kh, int kw, cudaStream_t s) {
  if (encoder() == nullptr) return (int)cudaErrorNotSupported;
  nchw_to_nhwc_kernel<<<dim3((H * W + TT - 1) / TT, (Cin + TT - 1) / TT, B), TT_THREADS, 0, s>>>(
      (const bf16*)x, (bf16*)x_nhwc, Cin, H * W);
  // pixel tile: W rounded up to a power of two (at most BN) columns x R rows
  int log2_wp = 0;
  while ((1 << log2_wp) < W && (1 << log2_wp) < BN) ++log2_wp;
  const int wp = 1 << log2_wp, rows = BN / wp;
  alignas(64) CUtensorMap xmap, wmap;
  // x in NHWC as (C, W, H, B): a box (BK, wp, rows) lands as 128 K-major
  // pixel rows of 64 channels; the tap's (dw, dh) moves whole 128-B rows
  const cuuint64_t xdim[4] = {(cuuint64_t)Cin, (cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t xstride[3] = {(cuuint64_t)Cin * 2, (cuuint64_t)W * Cin * 2,
                                 (cuuint64_t)H * W * Cin * 2};
  const cuuint32_t xbox[4] = {BK, (cuuint32_t)wp, (cuuint32_t)rows, 1};
  int rc = encode_bf16(&xmap, x_nhwc, 4, xdim, xstride, xbox);
  if (rc != 0) return rc;
  // the tap-major weights (kh*kw, Cout, Cin) as (Cin, Cout, taps)
  const cuuint64_t wdim[3] = {(cuuint64_t)Cin, (cuuint64_t)Cout, (cuuint64_t)(kh * kw)};
  const cuuint64_t wstride[2] = {(cuuint64_t)Cin * 2, (cuuint64_t)Cout * Cin * 2};
  const cuuint32_t wbox[3] = {BK, BM, 1};
  rc = encode_bf16(&wmap, w_taps, 3, wdim, wstride, wbox);
  if (rc != 0) return rc;
  const int col_tiles = (W + wp - 1) / wp;
  const int blocks = ((H + rows - 1) / rows) * col_tiles * ((Cout + BM - 1) / BM) * B;
  const int steps = (Cin + BK - 1) / BK * kh * kw;
  // a grid that fills less than the card splits K across a cluster, up to a
  // block an SM, as long as each block keeps 4 or more steps for its ring
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  int splits = 1;
  while (splits < MAX_SPLITS && blocks * splits * 2 <= sms && steps >= 8 * splits) splits *= 2;
  err = cudaFuncSetAttribute(conv2d_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)SMEM);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(((H + rows - 1) / rows) * col_tiles, (Cout + BM - 1) / BM, B * splits);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = SMEM;
  cfg.stream = s;
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = 1;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = splits;
  cfg.attrs = &cluster;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, conv2d_wgmma_kernel, xmap, wmap, (const bf16*)b, (bf16*)y, Cin,
                           Cout, H, W, kh, kw, log2_wp, col_tiles, splits);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

}  // namespace tc

}  // namespace

// x (B, Cin, H, W), w (Cout, Cin, kh, kw), b (Cout,), y (B, Cout, H, W);
// Cin % 32 == 0, Cout % 64 == 0, kh and kw odd. dtype:
// 0 = float32, 1 = bfloat16. For bf16, x_nhwc is scratch for x's NHWC copy
// (B, H, W, Cin), which a transpose kernel writes first, and w_taps w's
// tap-major copy (kh*kw, Cout, Cin): the TMA + wgmma kernel reads the two.
// fp32 reads x and w and takes null for both. Returns a cudaError_t
// (0 = launched).
extern "C" int dm_conv2d_same(int dtype, const void* x, const void* w, void* x_nhwc,
                              const void* w_taps, const void* b, void* y, int B, int Cin,
                              int Cout, int H, int W, int kh, int kw, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 1) {
    if (x_nhwc == nullptr || w_taps == nullptr) return (int)cudaErrorInvalidValue;
    return tc::launch(x, x_nhwc, w_taps, b, y, B, Cin, Cout, H, W, kh, kw, s);
  }
  return run_conv2d<float>(x, w, b, y, B, Cin, Cout, H, W, kh, kw, s);
}

extern "C" size_t dm_conv2d_same_smem(int dtype) {
  return dtype == 1 ? tc::SMEM : conv2d_smem<float>();
}
