// Flash self-attention on Hopper, at head_dim 8 and at head_dim 32-512.
//
// Replaces diffmusic_tpu/pallas/attention_kernel.py::flash_attention: unmasked
// softmax(Q K^T / sqrt(D)) V over (B, T, H, D) tensors, which in memory are
// (B, T, C) rows with C = H * D. The (T, T) logits never reach device memory.
// Head_dim 8 is the UNets' attention (below); head_dim 32-512 in steps of 32
// the VAE's mid-block (one head of D = C channels: 512 at published widths,
// 32 in the tiny configs), further below.
//
// Bound: at head_dim 8 the products are small (4 T^2 H 8 FLOPs, 0.01 ms of
// tensor-core time at T = 4000, H = 16) and the bytes smaller still; what
// every logit needs is one exp2, T^2 H of them, at 16 per clock per SM (the
// MUFU): 256 M at T = 4000, H = 16, some 0.06-0.07 ms at 1.75-1.98 GHz.
// Depth 8 is not below the tensor cores' reach: mma.sync has
// m16n8k8.row.col.f32.bf16.bf16.f32 (only WMMA and wgmma need depth 16).
//
// bf16: `flash_mma_kernel`, on the warp core of mma_attention.cuh (shared
// with the fused transformer block). One warp owns 16 query rows of one head:
// QK^T on mma.sync m16n8k8 from ldmatrix fragments, an online softmax per
// chunk of KC = 64 keys with the logit scale folded into exp2's FMA, P
// rounded to bf16 in registers for PV on m16n8k16 (the JAX kernel rounds P
// the same way, attention_kernel.py:52). A block is 2 row groups (32 query
// rows) x up to 8 heads, one warp each, and stages the key and value chunks
// of its heads, 128 contiguous bytes a key, through a double-buffered
// cp.async ring.
//
// fp32: `flash_attention_kernel`, the exact scalar core it shares with the
// transformer block (common.cuh, HeadAttention: one thread per (row, head)
// pair, fp32 FMAs), which the card-against-CPU reference runs use.
//
// Head_dim 32-512 ("wide"). Bound on the H100: the tensor cores. At (1, 4000,
// 1, 512) the products are 4 T^2 D = 3.3e10 FLOP, 0.033 ms at 989 TFLOP/s,
// against 0.005 ms for the 16.4 MB of q, k, v and out and 0.004 ms for the
// T^2 exp2. What the head_dim-8 design cannot do here: a 64-row fp32 output
// tile over D = 512 is 256 registers a thread for one warpgroup, QK^T
// contracts over 512, and a 64-key chunk of K is 64 KB. So:
//   - bf16, `flash_hopper_kernel<AW>`: a block owns 64 query rows (one wgmma
//     M) of one (batch, head), ALL D output columns, and one of `splits` key
//     splits; the splits of a query tile are a cluster along z, chosen on the
//     host (`splits_for`: doubled while the grid fits the SMs and each split
//     keeps two chunks), 63 tiles x 2 = 126 blocks at T = 4000.
//     Warp-specialised: a producer warpgroup (24 registers after setmaxnreg;
//     one thread issues the loads) brings Q's 64 x D tile once and K and V in
//     chunks of WKC = 64 keys, each into a slot of its own with mbarriers of
//     its own (K of chunk i + 1 loads during chunk i's softmax and PV, V
//     during the next QK^T), by TMA from 4-D maps (D, H, T, B) in 64-channel
//     boxes that land as 128-byte swizzled rows, zeros past D and T (a ragged
//     tile, a batch boundary and D rounded up to 128 need no predicate). Two
//     consumer warpgroups (240 registers) own half of the channels each, AW =
//     D / 128 rounded up 64-channel atoms: each contracts QK^T over its own
//     atoms on wgmma m64n64k16 (Q and K K-major as TMA wrote them), the two
//     fp32 partial S tiles are summed through shared memory between two
//     named barriers, and both run the same online softmax on the whole S:
//     keys past T get -inf, the running max, one rescale a chunk, the scale
//     folded into exp2's FMA. P is rounded to bf16 in registers and is
//     wgmma's A operand from registers for PV, m64n(64 AW)k16 over the
//     warpgroup's columns, V read MN-major as it lies ([key][channel])
//     through the transpose bit. So S is computed once: the kernel issues the
//     useful 4 T^2 D FLOPs (a block per 128-column output slice would
//     recompute S in each, 82 GFLOP for 33 at D = 512). After the loop each
//     block leaves its fp32 partial O (64 x D) and its rows' (m, l) where Q
//     and the ring were; after a cluster barrier block r finishes rows [r 64
//     / splits, (r + 1) 64 / splits) from every peer through distributed
//     shared memory, out = sum_s w_s O_s / sum_s w_s l_s with w_s = 2^((m_s
//     - max m) c), and writes bf16 rows: no second launch and no partials in
//     device memory. A split with no key (m = -inf, l = 0) weighs 0. 230,440
//     B of dynamic shared memory at D = 512 (Q 64 KB, K and V 128 KB, the
//     exchange 32 KB), one block an SM. The chunk, the slots, the exchange
//     and the split rule are the fastest of the alternatives measured on the
//     H100 (32-key chunks in a 2-stage ring, each warpgroup computing the
//     whole S, 1 or 4 splits; the next QK^T in flight during the softmax
//     made ptxas serialise the wgmma, C7514, and ran slower).
//   - fp32, `flash_wide_f32_kernel`: exact scalar FMAs, 16 query rows a
//     block over all D output columns, a thread per (row, 16th of the
//     columns): S per 16-key chunk in shared memory (one logit a thread, a
//     D-long dot product), then each thread's online softmax of its row and
//     its 2-32 output columns.
#include "common.cuh"
#include "hopper.cuh"
#include "mma_attention.cuh"

namespace {

using dm::bf16;

// ------------------------------------------------------------- fp32: scalar
constexpr int THREADS = 256;
constexpr int KT = 32;   // keys per staged chunk

template <typename T>
__host__ __device__ int key_ld(int C) { return C + 16 / (int)sizeof(T); }

template <typename T>
size_t smem_bytes(int C) {
  return dm::align128((size_t)2 * KT * key_ld<T>(C) * sizeof(T));
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int Tlen, int heads,
                       float scale_log2e) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int C = heads * 8, ldk = key_ld<T>(C);
  T* ks = reinterpret_cast<T*>(smem);
  T* vs = ks + (size_t)KT * ldk;
  const int rows = max(1, THREADS / heads);
  const int t0 = blockIdx.x * rows, b = blockIdx.y;
  const int valid = min(rows, Tlen - t0);
  const size_t base = (size_t)b * Tlen * C;

  dm::HeadAttention<T, 1, KT> att;
  att.begin(q + base + (size_t)t0 * C, C, heads, rows, valid, scale_log2e);
  att.run(k + base, v + base, C, Tlen, nullptr, ks, vs, ldk, nullptr);
  att.end(out + base + (size_t)t0 * C, C, valid);
}

template <typename T>
int run(const void* q, const void* k, const void* v, void* out, int B, int Tlen, int heads,
        float scale_log2e, cudaStream_t s) {
  const int rows = THREADS / heads > 1 ? THREADS / heads : 1;
  dim3 grid((Tlen + rows - 1) / rows, B);
  return dm::launch(flash_attention_kernel<T>, grid, dim3(THREADS), smem_bytes<T>(heads * 8), s,
                    (const T*)q, (const T*)k, (const T*)v, (T*)out, Tlen, heads, scale_log2e);
}

// ------------------------------------------------------ bf16: tensor cores
namespace tc {

using namespace dm::mma;

constexpr int ROW_GROUPS = 2;   // 16-row groups per block
constexpr int THREADS = 32 * ROW_GROUPS * HEADS;
constexpr size_t SMEM = KV_BYTES;
static_assert(THREADS == STAGE_THREADS, "one staged (key, head) slot per thread");

__global__ void __launch_bounds__(THREADS)
flash_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ out, int Tlen, int heads,
                 float scale_log2e) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* ks = reinterpret_cast<bf16*>(smem);            // [stage][key][LD]
  bf16* vs = ks + (size_t)STAGES * KC * LD;
  const int C = heads * 8;
  const int hb0 = blockIdx.y * HEADS, nh = min(HEADS, heads - hb0);
  const size_t base = (size_t)blockIdx.z * Tlen * C;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int hl = warp % HEADS;                           // head within the block
  const int r0 = blockIdx.x * (16 * ROW_GROUPS) + (warp / HEADS) * 16;
  const bool active = hl < nh;

  // the warp's Q fragment: rows r0 + g and r0 + g + 8, d = 2 t4, 2 t4 + 1
  WarpAttention att;
  {
    const bf16* qp = q + base + (size_t)(hb0 + hl) * 8 + 2 * t4;
    att.begin(load_pair(qp + (size_t)(r0 + g) * C, active && r0 + g < Tlen),
              load_pair(qp + (size_t)(r0 + g + 8) * C, active && r0 + g + 8 < Tlen));
  }

  const int chunks = (Tlen + KC - 1) / KC;
  stage_kv(ks, vs, k + base, v + base, C, hb0, nh, Tlen, 0);
  for (int c = 0; c < chunks; ++c) {
    if (c + 1 < chunks) {
      stage_kv(ks, vs, k + base, v + base, C, hb0, nh, Tlen, c + 1);
      asm volatile("cp.async.wait_group 1;" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;" ::: "memory");
    }
    __syncthreads();   // chunk c is in shared memory for every warp

    if (active) {
      const int s = c % STAGES;
      att.chunk<false, false>(ks + ((size_t)s * KC + lane) * LD + hl * 8,
                              vs + ((size_t)s * KC + lane) * LD + hl * 8, Tlen - c * KC,
                              scale_log2e, nullptr);
    }
    __syncthreads();   // every warp is done with chunk c's stage
  }

  if (!active) return;
  __nv_bfloat162 o[2];
  att.finish(o, false);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + g + 8 * r;
    if (row < Tlen)
      *reinterpret_cast<__nv_bfloat162*>(out + base + (size_t)row * C + (hb0 + hl) * 8 +
                                         2 * t4) = o[r];
  }
}

int run(const void* q, const void* k, const void* v, void* out, int B, int Tlen, int heads,
        float scale_log2e, cudaStream_t s) {
  dim3 grid((Tlen + 16 * ROW_GROUPS - 1) / (16 * ROW_GROUPS), (heads + HEADS - 1) / HEADS, B);
  return dm::launch(flash_mma_kernel, grid, dim3(THREADS), SMEM, s, (const bf16*)q,
                    (const bf16*)k, (const bf16*)v, (bf16*)out, Tlen, heads, scale_log2e);
}

}  // namespace tc

// ------------------------------------------------ head_dim 32-512: bf16
namespace wide {

using namespace dm::hopper;
using dm::mma::ex2;
using dm::mma::pack_bf16;

constexpr int ROWS = 64;            // query rows per block: one wgmma M
constexpr int WKC = 64;             // keys per chunk
constexpr int MIN_CHUNKS = 2;       // chunks a key split keeps at least
constexpr int MAX_SPLITS = 8;       // the portable cluster size
constexpr int ATOM = 64;            // channels per 128-byte swizzled row
constexpr int THREADS = 384;        // a producer warpgroup and two consumer warpgroups
constexpr int CONSUMERS = 256;
constexpr int PRODUCER_REGS = 24, CONSUMER_REGS = 240;

// 64-channel atoms a consumer warpgroup owns: D rounded up to an even count
__host__ __device__ constexpr int wg_atoms(int D) { return ((D + ATOM - 1) / ATOM + 1) / 2; }

// Shared memory of the kernel whose warpgroups own AW atoms each, in bytes
// from its 1024-aligned base: Q [2 AW atoms][ROWS rows][128 B]; the K slot and
// the V slot, a chunk each [2 AW atoms][WKC keys][128 B]; the S exchange [2
// warpgroups][WKC / 8][128 threads] float4 (after the loop: the rows' (m, l)
// and the combine's weights); the mbarriers (Q, K full, V full, K empty, V
// empty). After the loop the fp32 partial O [ROWS][PART_LD] overwrites Q and
// the slots.
template <int AW>
struct Tile {
  static constexpr int Q_BYTES = 2 * AW * ROWS * 128;
  static constexpr int KV_BYTES = 2 * AW * WKC * 128;
  static constexpr int K_OFF = Q_BYTES, V_OFF = K_OFF + KV_BYTES;
  static constexpr int X_OFF = V_OFF + KV_BYTES;
  static constexpr int X_BYTES = 2 * ROWS * WKC * 4;
  static constexpr int BAR_OFF = X_OFF + X_BYTES;
  static constexpr int SMEM = BAR_OFF + 5 * 8 + 1024;   // + alignment
  static constexpr int PART_LD = 2 * AW * ATOM + 8;   // 8 rows of a warp's stores: 2 wavefronts
  static_assert(ROWS * PART_LD * 4 <= X_OFF, "the partial O fits where Q and the ring were");
  static_assert(ROWS * 8 + ROWS * MAX_SPLITS * 4 <= X_BYTES, "(m, l) and weights fit");
  static_assert(SMEM <= 232448, "one block an SM");
};

// Block (x, y, z): query rows [64 x, 64 x + 64) of (batch, head) y, over key
// split z of `splits`: the chunks [chunks z / splits, chunks (z + 1) / splits)
// of WKC keys. The splits of a tile are one cluster along z. Warpgroup 0 is
// the producer (one thread issues the TMA loads); consumer warpgroup cw owns
// the output columns of atoms [cw AW, cw AW + AW) and contracts QK^T over the
// same channels, so each touches only its own atoms of Q, K and V.
template <int AW>
__global__ void __launch_bounds__(THREADS, 1)
flash_hopper_kernel(const __grid_constant__ CUtensorMap qmap,
                    const __grid_constant__ CUtensorMap kmap,
                    const __grid_constant__ CUtensorMap vmap, bf16* __restrict__ out, int Tlen,
                    int heads, int D, float scale_log2e, int splits) {
  using L = Tile<AW>;
  constexpr int NS = WKC / 2;   // S values a consumer thread holds
  constexpr int NO = AW * 32;   // O values a consumer thread holds (64 x 64 AW)
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* qbar = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);
  uint64_t* kfull = qbar + 1;
  uint64_t* vfull = qbar + 2;
  uint64_t* kempty = qbar + 3;
  uint64_t* vempty = qbar + 4;

  const int q0 = blockIdx.x * ROWS, b = blockIdx.y / heads, h = blockIdx.y % heads;
  const int split = blockIdx.z;   // the block's rank in its cluster
  const int chunks = (Tlen + WKC - 1) / WKC;
  const int c0 = chunks * split / splits, n = chunks * (split + 1) / splits - c0;
  constexpr int ATOMS = 2 * AW;   // D rounded up to 128 channels: TMA fills zeros past D

  if (threadIdx.x == 0) {
    mbar_init(qbar, 1);
    mbar_init(kfull, 1);
    mbar_init(vfull, 1);
    mbar_init(kempty, CONSUMERS / 32);
    mbar_init(vempty, CONSUMERS / 32);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // producer: Q once, then the split's K and V chunks, each into its slot
    // once the consumers have released the last chunk's
    setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == 0) {
      mbar_expect_tx(qbar, ATOMS * ROWS * 128);
      for (int a = 0; a < ATOMS; ++a)
        tma_load_4d(smem + a * ROWS * 128, &qmap, qbar, a * ATOM, h, q0, b);
      constexpr uint32_t kv_bytes = ATOMS * WKC * 128;
      for (int i = 0; i < n; ++i) {
        const int key0 = (c0 + i) * WKC;
        const uint32_t parity = (i & 1) ^ 1;   // chunk i - 1's release
        if (i > 0) mbar_wait(kempty, parity);
        mbar_expect_tx(kfull, kv_bytes);
        for (int a = 0; a < ATOMS; ++a)
          tma_load_4d(smem + L::K_OFF + a * WKC * 128, &kmap, kfull, a * ATOM, h, key0, b);
        if (i > 0) mbar_wait(vempty, parity);
        mbar_expect_tx(vfull, kv_bytes);
        for (int a = 0; a < ATOMS; ++a)
          tma_load_4d(smem + L::V_OFF + a * WKC * 128, &vmap, vfull, a * ATOM, h, key0, b);
      }
    }
    cluster_sync();   // the cluster's two barriers count every thread
    cluster_sync();
    return;
  }

  setmaxnreg_inc<CONSUMER_REGS>();
  const int cw = wg - 1, t = threadIdx.x % 128, ct = threadIdx.x - 128;
  const int warp = t / 32, lane = t % 32;
  const uint32_t base = smem_u32(smem);
  const uint32_t kst = base + L::K_OFF, vst = base + L::V_OFF;

  // o[4j + e]: row 16 warp + lane / 4 (+ 8 for e >= 2), column cw 64 AW + 8 j
  // + 2 (lane % 4) + e % 2; sc the same over the chunk's keys
  float o[NO], sc[NS];
#pragma unroll
  for (int i = 0; i < NO; ++i) o[i] = 0.f;
#pragma unroll
  for (int i = 0; i < NS; ++i) sc[i] = 0.f;
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F}, l[2] = {0.f, 0.f};

  mbar_wait(qbar, 0);   // also before a split with no chunk reuses Q's bytes
  for (int i = 0; i < n; ++i) {
    const uint32_t parity = i & 1;

    // S = Q K^T over this warpgroup's channels, all of the chunk's keys; the
    // atom count known to the compiler keeps every wgmma on a path all warps
    // of the warpgroup take (no serialising WG.AR)
    mbar_wait(kfull, parity);
    wgmma_fence();
    fence_operands<NS>(sc);
#pragma unroll
    for (int a = 0; a < AW; ++a) {
#pragma unroll
      for (int kk = 0; kk < ATOM / 16; ++kk) {
        const uint64_t dq = kmajor_desc(base + (cw * AW + a) * ROWS * 128 + 32 * kk);
        const uint64_t dk = kmajor_desc(kst + (cw * AW + a) * WKC * 128 + 32 * kk);
        wgmma_m64n64k16(sc, dq, dk, a > 0 || kk > 0);
      }
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands<NS>(sc);
    if (lane == 0) mbar_arrive(kempty);

    {
      // the other warpgroup's half: the same (row, key) in the same thread
      // slot, so the two sums are bitwise equal and both softmaxes agree
      float4* xb = reinterpret_cast<float4*>(smem + L::X_OFF);
#pragma unroll
      for (int v = 0; v < NS / 4; ++v)
        xb[(cw * (NS / 4) + v) * 128 + t] =
            make_float4(sc[4 * v], sc[4 * v + 1], sc[4 * v + 2], sc[4 * v + 3]);
      asm volatile("bar.sync 1, %0;" ::"n"(CONSUMERS) : "memory");
#pragma unroll
      for (int v = 0; v < NS / 4; ++v) {
        const float4 p = xb[((1 - cw) * (NS / 4) + v) * 128 + t];
        sc[4 * v] += p.x;
        sc[4 * v + 1] += p.y;
        sc[4 * v + 2] += p.z;
        sc[4 * v + 3] += p.w;
      }
      // both halves read before the next chunk's writes
      asm volatile("bar.sync 1, %0;" ::"n"(CONSUMERS) : "memory");
    }

    const int nvalid = Tlen - (c0 + i) * WKC;
    if (nvalid < WKC) {   // keys past T (zeros from TMA) weigh nothing
#pragma unroll
      for (int j = 0; j < NS / 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (8 * j + 2 * (lane % 4) + (e & 1) >= nvalid) sc[4 * j + e] = -CUDART_INF_F;
    }
    // the online softmax: running max, one rescale of o and l per chunk
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < NS / 4; ++j) {
      mx[0] = fmaxf(mx[0], fmaxf(sc[4 * j], sc[4 * j + 1]));
      mx[1] = fmaxf(mx[1], fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float corr = ex2((m[r] - mx[r]) * scale_log2e);   // 0 on the first chunk
      l[r] *= corr;
#pragma unroll
      for (int j = 0; j < NO / 4; ++j) {
        o[4 * j + 2 * r] *= corr;
        o[4 * j + 2 * r + 1] *= corr;
      }
      m[r] = mx[r];
    }
    const float neg0 = -m[0] * scale_log2e, neg1 = -m[1] * scale_log2e;
#pragma unroll
    for (int j = 0; j < NS / 4; ++j) {
      sc[4 * j] = ex2(fmaf(sc[4 * j], scale_log2e, neg0));
      sc[4 * j + 1] = ex2(fmaf(sc[4 * j + 1], scale_log2e, neg0));
      sc[4 * j + 2] = ex2(fmaf(sc[4 * j + 2], scale_log2e, neg1));
      sc[4 * j + 3] = ex2(fmaf(sc[4 * j + 3], scale_log2e, neg1));
      l[0] += sc[4 * j] + sc[4 * j + 1];
      l[1] += sc[4 * j + 2] + sc[4 * j + 3];
    }
    // P rounded to bf16 in registers: S's layout is the A operand's
    uint32_t pa[WKC / 16][4];
#pragma unroll
    for (int kk = 0; kk < WKC / 16; ++kk) {
      pa[kk][0] = pack_bf16(sc[8 * kk], sc[8 * kk + 1]);
      pa[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
      pa[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
      pa[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
    }

    // O += P V over this warpgroup's columns, V as it lies ([key][channel])
    mbar_wait(vfull, parity);
    wgmma_fence();
    fence_operands<NO>(o);
#pragma unroll
    for (int kk = 0; kk < WKC / 16; ++kk) {
      const uint64_t dv =
          mnmajor_desc(vst + cw * AW * WKC * 128 + kk * 16 * 128, WKC * 128);
      if constexpr (AW == 1) wgmma_m64n64k16_rt(o, pa[kk], dv);
      if constexpr (AW == 2) wgmma_m64n128k16_rt(o, pa[kk], dv);
      if constexpr (AW == 3) wgmma_m64n192k16_rt(o, pa[kk], dv);
      if constexpr (AW == 4) wgmma_m64n256k16_rt(o, pa[kk], dv);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands<NO>(o);
    if (lane == 0) mbar_arrive(vempty);
  }

  // The combine: every block leaves its fp32 partial O and its rows' (m, l)
  // in its shared memory; block r of the cluster then finishes rows [r 64 /
  // splits, (r + 1) 64 / splits) from all of them: out = sum_s w_s O_s /
  // sum_s w_s l_s, w_s = 2^((m_s - max m) c). A split with no key has m =
  // -inf, l = 0 and O = 0: weight 0.
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  asm volatile("bar.sync 1, %0;" ::"n"(CONSUMERS) : "memory");   // Q and the slots are read
  float* part = reinterpret_cast<float*>(smem);
  float2* ml = reinterpret_cast<float2*>(smem + L::X_OFF);
  float* coef = reinterpret_cast<float*>(ml + ROWS);   // [ROWS / splits][MAX_SPLITS]
  const int row = warp * 16 + lane / 4;
#pragma unroll
  for (int j = 0; j < NO / 4; ++j) {
    const int col = cw * AW * ATOM + 8 * j + 2 * (lane % 4);
    *reinterpret_cast<float2*>(part + row * L::PART_LD + col) = make_float2(o[4 * j], o[4 * j + 1]);
    *reinterpret_cast<float2*>(part + (row + 8) * L::PART_LD + col) =
        make_float2(o[4 * j + 2], o[4 * j + 3]);
  }
  if (cw == 0 && lane % 4 == 0) {
    ml[row] = make_float2(m[0], l[0]);
    ml[row + 8] = make_float2(m[1], l[1]);
  }
  cluster_sync();   // every block's partials are in its shared memory

  const int rows_per = ROWS / splits, row0 = split * rows_per;
  if (ct < rows_per) {
    float mmax = -CUDART_INF_F;
    for (int q = 0; q < splits; ++q) mmax = fmaxf(mmax, cluster_peer(ml + row0 + ct, q)->x);
    float lsum = 0.f;
    for (int q = 0; q < splits; ++q) {
      const float2 v = *cluster_peer(ml + row0 + ct, q);
      const float w = ex2((v.x - mmax) * scale_log2e);
      coef[ct * MAX_SPLITS + q] = w;
      lsum += w * v.y;
    }
    const float inv = 1.f / lsum;
    for (int q = 0; q < splits; ++q) coef[ct * MAX_SPLITS + q] *= inv;
  }
  asm volatile("bar.sync 1, %0;" ::"n"(CONSUMERS) : "memory");
  const int vecs = D / 4;
  for (int it = ct; it < rows_per * vecs; it += CONSUMERS) {
    const int rr = it / vecs, col = (it % vecs) * 4, tq = q0 + row0 + rr;
    const float4* mine =
        reinterpret_cast<const float4*>(part + (row0 + rr) * L::PART_LD + col);
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int q = 0; q < splits; ++q) {
      const float w = coef[rr * MAX_SPLITS + q];
      const float4 v = *cluster_peer(mine, q);
      acc.x = fmaf(w, v.x, acc.x);
      acc.y = fmaf(w, v.y, acc.y);
      acc.z = fmaf(w, v.z, acc.z);
      acc.w = fmaf(w, v.w, acc.w);
    }
    if (tq < Tlen) {
      __nv_bfloat162 pair[2] = {__floats2bfloat162_rn(acc.x, acc.y),
                                __floats2bfloat162_rn(acc.z, acc.w)};
      *reinterpret_cast<uint2*>(out + (((size_t)b * Tlen + tq) * heads + h) * D + col) =
          *reinterpret_cast<const uint2*>(pair);
    }
  }
  cluster_sync();   // no block leaves while its partials may still be read
}

// The key splits of a query tile: doubled while the grid stays within the
// card's SMs and each split keeps MIN_CHUNKS chunks (one loads while another
// is multiplied).
int splits_for(int blocks, int chunks, int sms) {
  int n = 1;
  while (n < MAX_SPLITS && blocks * n * 2 <= sms && chunks >= MIN_CHUNKS * n * 2) n *= 2;
  return n;
}

size_t smem_bytes(int D) {
  switch (wg_atoms(D)) {
    case 1: return Tile<1>::SMEM;
    case 2: return Tile<2>::SMEM;
    case 3: return Tile<3>::SMEM;
    default: return Tile<4>::SMEM;
  }
}

// The launch at (B, Tlen, heads) on the current device: the grid (query
// tiles, batch x heads, key splits), the splits a cluster along z.
int plan(int B, int Tlen, int heads, dim3* grid) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const int tiles = (Tlen + ROWS - 1) / ROWS;
  *grid = dim3(tiles, B * heads, splits_for(tiles * B * heads, (Tlen + WKC - 1) / WKC, sms));
  return 0;
}

template <int AW>
int launch_aw(const CUtensorMap& qm, const CUtensorMap& km, const CUtensorMap& vm, void* out,
              dim3 grid, int Tlen, int heads, int D, float scale_log2e, cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(flash_hopper_kernel<AW>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         Tile<AW>::SMEM);
  if (err != cudaSuccess) return (int)err;
  const int splits = (int)grid.z;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = Tile<AW>::SMEM;
  cfg.stream = s;
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = 1;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = splits;
  cfg.attrs = &cluster;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, flash_hopper_kernel<AW>, qm, km, vm, (bf16*)out, Tlen, heads, D,
                           scale_log2e, splits);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

int run(const void* q, const void* k, const void* v, void* out, int B, int Tlen, int heads,
        int D, float scale_log2e, cudaStream_t s) {
  if (encoder() == nullptr) return (int)cudaErrorNotSupported;
  if (B * heads > 65535) return (int)cudaErrorInvalidConfiguration;
  dim3 grid;
  const int err = plan(B, Tlen, heads, &grid);
  if (err != 0) return err;
  // (B, T, H, D) as (D, H, T, B): a box of 64 channels lands as 128-byte rows,
  // zeros past D, past T and (so) never the next batch's rows
  alignas(64) CUtensorMap maps[3];
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)heads, (cuuint64_t)Tlen, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)heads * D * 2,
                                 (cuuint64_t)Tlen * heads * D * 2};
  const void* ptrs[3] = {q, k, v};
  for (int i = 0; i < 3; ++i) {
    const cuuint32_t box[4] = {ATOM, 1, (cuuint32_t)(i == 0 ? ROWS : WKC), 1};
    const int rc = encode_bf16(&maps[i], ptrs[i], 4, dims, strides, box);
    if (rc != 0) return rc;
  }
  switch (wg_atoms(D)) {
    case 1: return launch_aw<1>(maps[0], maps[1], maps[2], out, grid, Tlen, heads, D,
                                scale_log2e, s);
    case 2: return launch_aw<2>(maps[0], maps[1], maps[2], out, grid, Tlen, heads, D,
                                scale_log2e, s);
    case 3: return launch_aw<3>(maps[0], maps[1], maps[2], out, grid, Tlen, heads, D,
                                scale_log2e, s);
    default: return launch_aw<4>(maps[0], maps[1], maps[2], out, grid, Tlen, heads, D,
                                 scale_log2e, s);
  }
}

// ------------------------------------------------ head_dim 32-512: fp32
constexpr int F_THREADS = 256;
constexpr int F_ROWS = 16;                      // query rows per block
constexpr int F_KT = 16;                        // keys per staged chunk
constexpr int F_COLS = F_THREADS / F_ROWS;      // threads per row
constexpr int F_MAXJ = 512 / F_COLS;            // output columns per thread at D = 512

size_t smem_bytes_f32(int D) {
  return (size_t)(F_ROWS * (D + 1) + F_KT * (D + 1) + F_KT * D + F_ROWS * F_KT) * sizeof(float);
}

__global__ void __launch_bounds__(F_THREADS)
flash_wide_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, float* __restrict__ out, int Tlen, int heads,
                      int D, float scale_log2e) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int ldq = D + 1;                                 // odd stride: the 16 keys' dot
  float* qs = reinterpret_cast<float*>(smem);            // products hit 16 banks
  float* ks = qs + (size_t)F_ROWS * ldq;
  float* vs = ks + (size_t)F_KT * ldq;
  float* ss = vs + (size_t)F_KT * D;                     // [row][key] logits of the chunk
  const int b = blockIdx.y / heads, h = blockIdx.y % heads;
  const size_t rs = (size_t)heads * D;
  const size_t base = (size_t)b * Tlen * rs + (size_t)h * D;
  const float *qg = q + base, *kg = k + base, *vg = v + base;
  const int t0 = blockIdx.x * F_ROWS;
  const int r = threadIdx.x / F_COLS, cl = threadIdx.x % F_COLS;
  const int nj = D / F_COLS;                             // this thread's columns cl + 16 j

  for (int i = threadIdx.x; i < F_ROWS * D; i += F_THREADS) {
    const int rr = i / D, d = i % D;
    qs[rr * ldq + d] = t0 + rr < Tlen ? qg[(size_t)(t0 + rr) * rs + d] : 0.f;
  }
  float o[F_MAXJ];
#pragma unroll
  for (int j = 0; j < F_MAXJ; ++j) o[j] = 0.f;
  float m = -CUDART_INF_F, l = 0.f;

  for (int k0 = 0; k0 < Tlen; k0 += F_KT) {
    const int nk = min(F_KT, Tlen - k0);
    __syncthreads();   // the last chunk's readers are done (and Q is staged)
    for (int i = threadIdx.x; i < F_KT * D; i += F_THREADS) {
      const int kk = i / D, d = i % D;
      const bool ok = kk < nk;
      ks[kk * ldq + d] = ok ? kg[(size_t)(k0 + kk) * rs + d] : 0.f;
      vs[kk * D + d] = ok ? vg[(size_t)(k0 + kk) * rs + d] : 0.f;
    }
    __syncthreads();
    float acc = 0.f;
    for (int d = 0; d < D; ++d) acc = fmaf(qs[r * ldq + d], ks[cl * ldq + d], acc);
    ss[r * F_KT + cl] = cl < nk ? acc : -CUDART_INF_F;
    __syncthreads();
    float mc = m;
#pragma unroll
    for (int j = 0; j < F_KT; ++j) mc = fmaxf(mc, ss[r * F_KT + j]);
    const float corr = exp2f((m - mc) * scale_log2e);   // 0 on the first chunk (m = -inf)
    l *= corr;
#pragma unroll
    for (int j = 0; j < F_MAXJ; ++j) o[j] *= corr;
    m = mc;
    for (int kk = 0; kk < F_KT; ++kk) {
      const float p = exp2f((ss[r * F_KT + kk] - mc) * scale_log2e);
      l += p;
#pragma unroll
      for (int j = 0; j < F_MAXJ; ++j)
        if (j < nj) o[j] = fmaf(p, vs[kk * D + cl + F_COLS * j], o[j]);
    }
  }
  if (t0 + r >= Tlen) return;
  const float inv = 1.f / l;
  float* og = out + base + (size_t)(t0 + r) * rs;
#pragma unroll
  for (int j = 0; j < F_MAXJ; ++j)
    if (j < nj) og[cl + F_COLS * j] = o[j] * inv;
}

int run_f32(const void* q, const void* k, const void* v, void* out, int B, int Tlen, int heads,
            int D, float scale_log2e, cudaStream_t s) {
  dim3 grid((Tlen + F_ROWS - 1) / F_ROWS, B * heads);
  return dm::launch(flash_wide_f32_kernel, grid, dim3(F_THREADS), smem_bytes_f32(D), s,
                    (const float*)q, (const float*)k, (const float*)v, (float*)out, Tlen, heads,
                    D, scale_log2e);
}

}  // namespace wide

}  // namespace

// q, k, v, out: (B, T, heads, 8) contiguous; heads <= 256. dtype: 0 = float32,
// 1 = bfloat16. scale_log2e = log2(e) / sqrt(8).
extern "C" int dm_flash_attention(int dtype, const void* q, const void* k, const void* v,
                                  void* out, int B, int Tlen, int heads, float scale_log2e,
                                  void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 1) return tc::run(q, k, v, out, B, Tlen, heads, scale_log2e, s);
  return run<float>(q, k, v, out, B, Tlen, heads, scale_log2e, s);
}

extern "C" size_t dm_flash_attention_smem(int dtype, int heads) {
  return dtype == 1 ? tc::SMEM : smem_bytes<float>(heads * 8);
}

// q, k, v, out: (B, T, heads, D) contiguous, 32 <= D <= 512, D % 32 == 0.
// dtype: 0 = float32, 1 = bfloat16. scale_log2e = log2(e) / sqrt(D).
extern "C" int dm_flash_attention_wide(int dtype, const void* q, const void* k, const void* v,
                                       void* out, int B, int Tlen, int heads, int D,
                                       float scale_log2e, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 1) return wide::run(q, k, v, out, B, Tlen, heads, D, scale_log2e, s);
  return wide::run_f32(q, k, v, out, B, Tlen, heads, D, scale_log2e, s);
}

extern "C" size_t dm_flash_attention_wide_smem(int dtype, int D) {
  return dtype == 1 ? wide::smem_bytes(D) : wide::smem_bytes_f32(D);
}

// The bf16 head_dim 32-512 kernel's launch at (B, T, heads, D) on the current
// device, as dm_flash_attention_wide makes it: plan[0..5] = the grid's x
// (query tiles), y (B x heads) and z (key splits, a cluster), the query rows
// of a tile, the keys of a chunk and the channels D is rounded up to.
// Returns a cudaError_t.
extern "C" int dm_flash_attention_wide_plan(int B, int Tlen, int heads, int D, int* plan) {
  dim3 grid;
  const int err = wide::plan(B, Tlen, heads, &grid);
  if (err != 0) return err;
  const int out[6] = {(int)grid.x, (int)grid.y, (int)grid.z, wide::ROWS, wide::WKC,
                      2 * wide::wg_atoms(D) * wide::ATOM};
  for (int i = 0; i < 6; ++i) plan[i] = out[i];
  return 0;
}
