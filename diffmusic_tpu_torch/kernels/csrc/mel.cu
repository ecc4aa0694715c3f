// The fused mel spectrogram on Hopper: reflect pad -> frames -> windowed DFT
// -> |X|^power -> mel, one launch, fp32.
//
// Replaces diffmusic_tpu/pallas/mel_kernel.py::fused_mel_spectrogram
// (_mel_block_kernel).
//
// The function's least work is an FFT's (about 2.5 n_fft log2 n_fft fp32
// operations per frame), which leaves it bound by its bytes. Two paths, the
// plan's choice per geometry (kernels/mel.py::mel_plan); both run in fp32
// FMAs (TF32 would miss the fp32 tolerance) and keep every intermediate on
// the chip.
//
// mel_fft_kernel, the factored path (n_fft = n1 * n2, both at most 64): a
// Cooley-Tukey DFT in two stages of small products, n_fft (n1 + 2 n2) FMAs
// a frame (24 k at n_fft 400, 98 k at 1024), only the n_fft / 2 + 1 bins;
// each bin sums n1 + n2 terms, so it rounds no worse than the dense sum.
// Tiles of 8 frames, so that a batch-1 clip of 1001 frames gives 126 tiles;
// a block stages the tables once and takes tiles in turn (at most as many
// blocks as the card holds at once); the filterbank from its nonzeros, about
// 2 n_freqs FMAs a frame against 64 x m_pad a frequency tile. Details below.
//
// mel_kernel, the dense path (an n_fft without such a split): the DFT as a
// dense product, n_fft x 2 n_freqs FMAs per frame (10-20x the FFT's count):
//   - one block per (clip, tile of FT = 64 frames); the tile's signal span,
//     63 * hop + n_fft_pad samples (41 KB at n_fft 400, hop 160), is staged in
//     shared memory once, with the reflect pad done by index (16-byte loads
//     where the span lies inside the signal and is aligned). Frame j, sample
//     n is span[j * hop + n]: the frames are never materialised;
//   - the basis (window folded in) is cut into tiles of NT = 64 frequencies:
//     64 cos and 64 sin columns, each column's depth contiguous and zero-padded
//     to a multiple of KT = 32 (1.6 MB at n_fft 400: it stays in L2). Chunks of
//     KT rows are staged in shared memory, column-major with a skew, so that a
//     thread reads four depths of a column as one float4;
//   - the DFT of a frequency tile is a register-tiled FMA product: warp w
//     owns frames w, w + 8, ..., w + 56, lane l frequencies l and l + 32, and
//     holds both the cos and the sin sums of each, so |X|^2 forms in
//     registers (32 accumulators); per four depths it reads 8 float4 of
//     frames (broadcast) and 4 float4 of basis for 128 FMAs;
//   - the tile's power (64 frames x 64 frequencies) goes to shared memory
//     frequency-major and is multiplied by the matching 64 rows of the
//     filterbank into a (64 frames x n_mels) register accumulator: lane l
//     owns frames l and l + 32, warp w mels [w * MPW, (w + 1) * MPW). Only
//     the mel tile is written, transposed on the way to (B, n_mels, T): a
//     warp's stores are 32 consecutive frames of one mel.
// Frequencies past n_freqs (the last tile's padding) have zero basis columns
// and zero filterbank rows; frames past T are computed from zeros and not
// stored.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;   // 8 warps
constexpr int FT = 64;         // frames per block
constexpr int NT = 64;         // frequencies per basis tile (128 columns)
constexpr int KT = 32;         // basis depth per staged chunk
constexpr int BLD = KT + 4;    // shared row stride of a staged column (float4 aligned)
constexpr int PLD = FT + 1;    // shared row stride of the power tile

struct MelArgs {
  int L, T, k_pad, hop, pad, tiles, mels, m_pad, mode;
  float power;
};

__host__ __device__ constexpr int round4(int n) { return (n + 3) & ~3; }
__host__ __device__ constexpr int span_floats(int hop, int k_pad) {
  return round4((FT - 1) * hop + k_pad);
}

template <int MPW, bool HOP4>
__global__ void __launch_bounds__(THREADS)
mel_kernel(const float* __restrict__ x, const float* __restrict__ basis,
           const float* __restrict__ fb, float* __restrict__ out, MelArgs a) {
  extern __shared__ __align__(16) float smem[];
  const int n_span = span_floats(a.hop, a.k_pad);
  float* span = smem;                    // n_span
  float* bs = span + n_span;             // 2 * NT columns x BLD
  float* ps = bs + 2 * NT * BLD;         // NT frequencies x PLD frames
  float* fbs = ps + NT * PLD;            // NT x m_pad
  const int b = blockIdx.y, t0 = blockIdx.x * FT;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const float* xr = x + (size_t)b * a.L;

  // the span: padded samples [t0 * hop, t0 * hop + n_span) of the reflect-padded
  // clip, i.e. clip samples from `start`, reflected at both ends; past the
  // padded length (L + 2 pad) zeros
  const long start = (long)t0 * a.hop - a.pad;
  if (start >= 0 && start + n_span <= a.L && ((size_t)b * a.L + start) % 4 == 0) {
    for (int i = threadIdx.x; i < n_span / 4; i += THREADS)
      reinterpret_cast<float4*>(span)[i] = reinterpret_cast<const float4*>(xr + start)[i];
  } else {
    for (int i = threadIdx.x; i < n_span; i += THREADS) {
      long s = start + i;
      float v = 0.f;
      if (s < (long)a.L + a.pad) {
        if (s < 0) s = -s;
        else if (s >= a.L) s = 2L * (a.L - 1) - s;
        v = xr[s];
      }
      span[i] = v;
    }
  }

  float macc[2][MPW];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < MPW; ++j) macc[i][j] = 0.f;

  for (int tile = 0; tile < a.tiles; ++tile) {
    float re[8][2], im[8][2];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) re[i][j] = im[i][j] = 0.f;
    const float* bt = basis + (size_t)tile * 2 * NT * a.k_pad;

    for (int k0 = 0; k0 < a.k_pad; k0 += KT) {
      __syncthreads();   // the span is staged; the previous chunk (and tile) consumed
      for (int i = threadIdx.x; i < 2 * NT * KT / 4; i += THREADS) {
        const int col = i / (KT / 4), q = i % (KT / 4);
        *reinterpret_cast<float4*>(bs + col * BLD + 4 * q) =
            __ldg(reinterpret_cast<const float4*>(bt + (size_t)col * a.k_pad + k0) + q);
      }
      __syncthreads();
#pragma unroll 2
      for (int kk = 0; kk < KT; kk += 4) {
        float4 c[2], s[2];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          c[j] = *reinterpret_cast<const float4*>(bs + (lane + 32 * j) * BLD + kk);
          s[j] = *reinterpret_cast<const float4*>(bs + (NT + lane + 32 * j) * BLD + kk);
        }
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float* fp = span + (warp + 8 * i) * a.hop + k0 + kk;
          float4 f;
          if (HOP4) {
            f = *reinterpret_cast<const float4*>(fp);
          } else {
            f = make_float4(fp[0], fp[1], fp[2], fp[3]);
          }
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            re[i][j] = fmaf(f.x, c[j].x, re[i][j]);
            im[i][j] = fmaf(f.x, s[j].x, im[i][j]);
            re[i][j] = fmaf(f.y, c[j].y, re[i][j]);
            im[i][j] = fmaf(f.y, s[j].y, im[i][j]);
            re[i][j] = fmaf(f.z, c[j].z, re[i][j]);
            im[i][j] = fmaf(f.z, s[j].z, im[i][j]);
            re[i][j] = fmaf(f.w, c[j].w, re[i][j]);
            im[i][j] = fmaf(f.w, s[j].w, im[i][j]);
          }
        }
      }
    }

    // |X|^power of the tile, frequency-major, and the tile's filterbank rows
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float m2 = fmaf(re[i][j], re[i][j], im[i][j] * im[i][j]);
        const float p = a.mode == 2   ? m2
                        : a.mode == 1 ? sqrtf(m2 + 1e-24f)
                                      : powf(m2 + 1e-24f, 0.5f * a.power);
        ps[(lane + 32 * j) * PLD + warp + 8 * i] = p;
      }
    const float* fbt = fb + (size_t)tile * NT * a.m_pad;
    for (int i = threadIdx.x; i < NT * a.m_pad / 4; i += THREADS)
      reinterpret_cast<float4*>(fbs)[i] = __ldg(reinterpret_cast<const float4*>(fbt) + i);
    __syncthreads();
#pragma unroll 4
    for (int f = 0; f < NT; ++f) {
      const float p0 = ps[f * PLD + lane], p1 = ps[f * PLD + lane + 32];
      const float* w = fbs + f * a.m_pad + warp * MPW;
#pragma unroll
      for (int j = 0; j < MPW; ++j) {
        macc[0][j] = fmaf(p0, w[j], macc[0][j]);
        macc[1][j] = fmaf(p1, w[j], macc[1][j]);
      }
    }
    // the next tile's first __syncthreads keeps ps and fbs until every warp is done
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int t = t0 + lane + 32 * i;
    if (t >= a.T) continue;
#pragma unroll
    for (int j = 0; j < MPW; ++j) {
      const int m = warp * MPW + j;
      if (m < a.mels) out[((size_t)b * a.mels + m) * a.T + t] = macc[i][j];
    }
  }
}

size_t mel_smem(int hop, int k_pad, int m_pad) {
  return sizeof(float) *
         ((size_t)span_floats(hop, k_pad) + 2 * NT * BLD + NT * PLD + (size_t)NT * m_pad);
}

template <int MPW>
int run_mel(bool hop4, const float* x, const float* basis, const float* fb, float* out, int B,
            const MelArgs& a, cudaStream_t s) {
  const dim3 grid((a.T + FT - 1) / FT, B);
  const size_t smem = mel_smem(a.hop, a.k_pad, a.m_pad);
  if (hop4) return dm::launch(mel_kernel<MPW, true>, grid, dim3(THREADS), smem, s, x, basis, fb, out, a);
  return dm::launch(mel_kernel<MPW, false>, grid, dim3(THREADS), smem, s, x, basis, fb, out, a);
}

// ------------------------------------------------------ the factored path
// n_fft = n1 * n2 (n1, n2 <= S, the kernel's size class). A frame's sample
// n = n2 * m + b (m < n1, b < n2) and bin k = k1 + n1 * k2:
//   stage 1: Y[b][k1] = sum_m w[n] x[n] W_n1^(m k1), n2 real DFTs of length
//     n1 over the stride-n2 samples, as n1 real columns (cos k1 = 0..n1/2,
//     -sin k1 = 1..(n1-1)/2): the other half is their conjugate;
//   stage 2: X[k] = sum_b (Y[b][k1] W_n^(b k1)) W_n2^(b k2), only for the
//     bins k <= n_fft / 2: k2 < (n_fft / 2 - k1) / n1 + 1.
// Tables (host, float64 rounded to fp32, one buffer `tabf`): the window
// (n_fft, zero outside win_length), the stage-1 matrix d1 (n1 rows of n1p =
// round4(n1) columns), the twiddles tw (n2 x n1 complex), the stage-2 matrix
// w2 (n2 x k2s complex, k2s = n2 / 2 + 1) and the filterbank's nonzeros;
// `tabi` holds the filterbank's CSR: row_ptr (n_mels + 1), then the column
// (bin) of each nonzero. kernels/mel.py::fft_tables builds both.
struct FftArgs {
  int L, T, hop, pad, n_fft, n1, n2, mels, frames, mode;
  float power;
  int tiles, items;                              // frame tiles a clip, B * tiles
  int n1p, k2s, ys, ps;                          // row strides (floats / float2)
  int off_d1, off_tw, off_w2, off_val, nf, ni;   // table layout (floats, ints)
  int span;                                      // staged samples (floats)
};

__host__ __device__ constexpr int odd(int n) { return n | 1; }

FftArgs fft_args(int L, int T, int hop, int n_fft, int n1, int n2, int mels, int nnz,
                 int frames, int mode, float power, int B) {
  FftArgs a{};
  a.L = L; a.T = T; a.hop = hop; a.pad = n_fft / 2; a.n_fft = n_fft; a.n1 = n1; a.n2 = n2;
  a.mels = mels; a.frames = frames; a.mode = mode; a.power = power;
  a.tiles = (T + frames - 1) / frames;
  a.items = B * a.tiles;
  a.n1p = round4(n1);
  a.k2s = n2 / 2 + 1;
  a.ys = odd(n1);                 // a Y row: n1 columns, odd stride (stage 1 stores)
  a.ps = odd(n_fft / 2 + 1);      // a power row: n_freqs bins, odd stride (filterbank reads)
  a.off_d1 = round4(n_fft);
  a.off_tw = a.off_d1 + n1 * a.n1p;
  a.off_w2 = a.off_tw + 2 * n2 * n1;
  a.off_val = a.off_w2 + 2 * n2 * a.k2s;
  a.nf = round4(a.off_val + nnz);
  a.ni = round4(mels + 1 + nnz);
  a.span = round4((frames - 1) * hop + n_fft);
  return a;
}

size_t fft_smem(const FftArgs& a) {
  return sizeof(float) * ((size_t)a.nf + a.ni + a.span + (size_t)a.frames * a.n2 * a.ys +
                          (size_t)a.frames * a.ps);
}

int fft_threads(const FftArgs& a) {
  const int work = a.frames * (a.n1 > a.n2 ? a.n1 : a.n2);
  return (work + 31) / 32 * 32;
}

constexpr int FFT_MAX_THREADS = 512;

// One block takes tiles of `frames` frames of a clip in turn (items
// blockIdx.x, blockIdx.x + gridDim.x, ...), after staging the tables once:
// the span of the tile (reflect pad by index) -> stage 1, thread (f, b) ->
// Y in shared memory -> stage 2, thread (f, k1), |X|^power -> the power rows
// -> each (frame, mel) sums its nonzeros -> out (B, n_mels, T), a warp's
// stores 32-byte runs of 8 frames of a mel.
template <int S>
__global__ void __launch_bounds__(FFT_MAX_THREADS)
mel_fft_kernel(const float* __restrict__ x, const float* __restrict__ tabf,
               const int* __restrict__ tabi, float* __restrict__ out, FftArgs a) {
  extern __shared__ __align__(16) float smem[];
  float* tf = smem;
  int* ti = reinterpret_cast<int*>(tf + a.nf);
  float* span = reinterpret_cast<float*>(ti + a.ni);
  float* ys = span + a.span;
  float* ps = ys + a.frames * a.n2 * a.ys;
  const float* win = tf;
  const float* d1 = tf + a.off_d1;
  const float2* tw = reinterpret_cast<const float2*>(tf + a.off_tw);
  const float2* w2 = reinterpret_cast<const float2*>(tf + a.off_w2);
  const float* val = tf + a.off_val;
  const int* row = ti;
  const int* col = ti + a.mels + 1;
  const int tid = threadIdx.x, nt = blockDim.x;

  for (int i = tid; i < a.nf / 4; i += nt)
    reinterpret_cast<float4*>(tf)[i] = __ldg(reinterpret_cast<const float4*>(tabf) + i);
  for (int i = tid; i < a.ni; i += nt) ti[i] = __ldg(tabi + i);

  // stage 2's column of Y: k1 <= n1 / 2 reads its own columns, k1 above
  // reads those of n1 - k1 and conjugates; sin is zero at k1 = 0 and n1 / 2
  const int h = a.n1 / 2;
  const int k1 = tid % a.n1, kk = k1 <= h ? k1 : a.n1 - k1;
  const bool real_bin = kk == 0 || 2 * kk == a.n1;
  const int cim = real_bin ? 0 : h + kk;
  const float sim = real_bin ? 0.f : (k1 <= h ? 1.f : -1.f);
  const int nk2 = (a.n_fft / 2 - k1) / a.n1 + 1;

  for (int item = blockIdx.x; item < a.items; item += gridDim.x) {
    const int bi = item / a.tiles, t0 = (item % a.tiles) * a.frames;
    const float* xr = x + (size_t)bi * a.L;
    __syncthreads();   // the tables are staged; the last item's span, Y and P consumed
    // the span: padded samples [t0 hop, t0 hop + span) of the reflect-padded clip
    const long start = (long)t0 * a.hop - a.pad;
    if (start >= 0 && start + a.span <= a.L && ((size_t)bi * a.L + start) % 4 == 0) {
      for (int i = tid; i < a.span / 4; i += nt)
        reinterpret_cast<float4*>(span)[i] = __ldg(reinterpret_cast<const float4*>(xr + start) + i);
    } else {
      for (int i = tid; i < a.span; i += nt) {
        long s = start + i;
        float v = 0.f;
        if (s < (long)a.L + a.pad) {
          if (s < 0) s = -s;
          else if (s >= a.L) s = 2L * (a.L - 1) - s;
          v = __ldg(xr + s);
        }
        span[i] = v;
      }
    }
    __syncthreads();

    // stage 1: thread (f, b) sums its n1 windowed samples into n1 columns
    if (tid < a.frames * a.n2) {
      const int f = tid / a.n2, b = tid % a.n2;
      float acc[S];
#pragma unroll
      for (int c = 0; c < S; ++c) acc[c] = 0.f;
      const float* fr = span + f * a.hop + b;
      for (int m = 0; m < a.n1; ++m) {
        const float v = fr[m * a.n2] * win[m * a.n2 + b];
        const float4* drow = reinterpret_cast<const float4*>(d1 + m * a.n1p);
#pragma unroll
        for (int c4 = 0; c4 < S / 4; ++c4) {
          if (4 * c4 < a.n1) {
            const float4 d = drow[c4];
            acc[4 * c4] = fmaf(v, d.x, acc[4 * c4]);
            acc[4 * c4 + 1] = fmaf(v, d.y, acc[4 * c4 + 1]);
            acc[4 * c4 + 2] = fmaf(v, d.z, acc[4 * c4 + 2]);
            acc[4 * c4 + 3] = fmaf(v, d.w, acc[4 * c4 + 3]);
          }
        }
      }
      float* yrow = ys + (f * a.n2 + b) * a.ys;
#pragma unroll
      for (int c = 0; c < S; ++c)
        if (c < a.n1) yrow[c] = acc[c];
    }
    __syncthreads();

    // stage 2: thread (f, k1), the twiddle, then the bins k1 + n1 k2 <= n_fft / 2
    if (tid < a.frames * a.n1) {
      const int f = tid / a.n1;
      float2 acc[S / 2 + 1];
#pragma unroll
      for (int j = 0; j < S / 2 + 1; ++j) acc[j] = make_float2(0.f, 0.f);
      for (int b = 0; b < a.n2; ++b) {
        const float* yrow = ys + (f * a.n2 + b) * a.ys;
        const float yr = yrow[kk], yi = sim * yrow[cim];
        const float2 t = tw[b * a.n1 + k1];
        const float zr = fmaf(yr, t.x, -yi * t.y), zi = fmaf(yr, t.y, yi * t.x);
        const float2* wrow = w2 + b * a.k2s;
#pragma unroll
        for (int j = 0; j < S / 2 + 1; ++j) {
          if (j < nk2) {
            const float2 w = wrow[j];
            acc[j].x = fmaf(zr, w.x, fmaf(-zi, w.y, acc[j].x));
            acc[j].y = fmaf(zr, w.y, fmaf(zi, w.x, acc[j].y));
          }
        }
      }
      float* prow = ps + f * a.ps;
#pragma unroll
      for (int j = 0; j < S / 2 + 1; ++j) {
        if (j < nk2) {
          const float m2 = fmaf(acc[j].x, acc[j].x, acc[j].y * acc[j].y);
          prow[k1 + a.n1 * j] = a.mode == 2   ? m2
                                : a.mode == 1 ? sqrtf(m2 + 1e-24f)
                                              : powf(m2 + 1e-24f, 0.5f * a.power);
        }
      }
    }
    __syncthreads();

    // the filterbank: (frame, mel) sums the mel's nonzero bins
    for (int i = tid; i < a.frames * a.mels; i += nt) {
      const int f = i % a.frames, m = i / a.frames, t = t0 + f;
      const float* prow = ps + f * a.ps;
      float acc = 0.f;
      for (int j = row[m]; j < row[m + 1]; ++j) acc = fmaf(prow[col[j]], val[j], acc);
      if (t < a.T) out[((size_t)bi * a.mels + m) * a.T + t] = acc;
    }
  }
}

// Lets each instantiation use all the shared memory a block may have, once
// a process: the launch need not ask again.
template <int S>
int fft_opt_in() {
  static const cudaError_t err = cudaFuncSetAttribute(
      mel_fft_kernel<S>, cudaFuncAttributeMaxDynamicSharedMemorySize, 232448);
  return (int)err;
}

template <int S>
int run_fft(const float* x, const float* tabf, const int* tabi, float* out, const FftArgs& a,
            int max_blocks, cudaStream_t s) {
  const int threads = fft_threads(a);
  if (threads > FFT_MAX_THREADS || max_blocks < 1) return (int)cudaErrorInvalidValue;
  const int rc = fft_opt_in<S>();
  if (rc != 0) return rc;
  const int grid = a.items < max_blocks ? a.items : max_blocks;
  mel_fft_kernel<S><<<grid, threads, fft_smem(a), s>>>(x, tabf, tabi, out, a);
  return (int)cudaGetLastError();
}

int size_class(int n1, int n2) {
  const int m = n1 > n2 ? n1 : n2;
  return m <= 16 ? 16 : m <= 32 ? 32 : m <= 64 ? 64 : 0;
}

}  // namespace

// x (B, L) fp32; basis (tiles, 128, k_pad) fp32 (per tile 64 cos then 64 sin
// columns, window folded in, zero past n_fft and n_freqs); fb (tiles * 64,
// m_pad) fp32 (zero past n_freqs and n_mels); out (B, n_mels, T) fp32. mode: 2
// for power 2, 1 for power 1, 0 for powf(|X|^2 + 1e-24, power / 2). m_pad is
// 64 or 128. Returns a cudaError_t (0 = launched).
extern "C" int dm_fused_mel(const void* x, const void* basis, const void* fb, void* out, int B,
                            int L, int T, int k_pad, int hop, int pad, int tiles, int n_mels,
                            int m_pad, int mode, float power, void* stream) {
  const MelArgs a{L, T, k_pad, hop, pad, tiles, n_mels, m_pad, mode, power};
  cudaStream_t s = (cudaStream_t)stream;
  const bool hop4 = hop % 4 == 0;
  const float *xf = (const float*)x, *bf = (const float*)basis, *ff = (const float*)fb;
  float* of = (float*)out;
  if (m_pad == 64) return run_mel<8>(hop4, xf, bf, ff, of, B, a, s);
  if (m_pad == 128) return run_mel<16>(hop4, xf, bf, ff, of, B, a, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" size_t dm_fused_mel_smem(int hop, int k_pad, int m_pad) {
  return mel_smem(hop, k_pad, m_pad);
}

// The factored path. x (B, L) fp32; tabf / tabi the tables of
// kernels/mel.py::fft_tables for n_fft = n1 * n2 (n1, n2 <= 64) and n_mels
// mels with nnz nonzeros; out (B, n_mels, T) fp32; `frames` frames a tile;
// at most `max_blocks` blocks, each taking tiles in turn. mode as above.
extern "C" int dm_fused_mel_fft(const void* x, const void* tabf, const void* tabi, void* out,
                                int B, int L, int T, int hop, int n_fft, int n1, int n2,
                                int n_mels, int nnz, int frames, int mode, float power,
                                int max_blocks, void* stream) {
  if (n1 * n2 != n_fft || n1 < 2 || n2 < 2 || frames < 1) return (int)cudaErrorInvalidValue;
  const FftArgs a = fft_args(L, T, hop, n_fft, n1, n2, n_mels, nnz, frames, mode, power, B);
  cudaStream_t s = (cudaStream_t)stream;
  const float *xf = (const float*)x, *tf = (const float*)tabf;
  const int* ti = (const int*)tabi;
  float* of = (float*)out;
  switch (size_class(n1, n2)) {
    case 16: return run_fft<16>(xf, tf, ti, of, a, max_blocks, s);
    case 32: return run_fft<32>(xf, tf, ti, of, a, max_blocks, s);
    case 64: return run_fft<64>(xf, tf, ti, of, a, max_blocks, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The blocks of the factored path an SM can hold at this geometry, for the
// plan; 0 where none fits (more shared memory than a block may have).
extern "C" int dm_fused_mel_fft_blocks(int hop, int n_fft, int n1, int n2, int n_mels, int nnz,
                                       int frames) {
  const FftArgs a = fft_args(1, 1, hop, n_fft, n1, n2, n_mels, nnz, frames, 2, 2.f, 1);
  const size_t smem = fft_smem(a);
  const int threads = fft_threads(a);
  int blocks = 0;
  cudaError_t err = cudaSuccess;
  const auto query = [&](auto kernel, int opt_in) {
    err = (cudaError_t)opt_in;
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads, smem);
  };
  switch (size_class(n1, n2)) {
    case 16: query(mel_fft_kernel<16>, fft_opt_in<16>()); break;
    case 32: query(mel_fft_kernel<32>, fft_opt_in<32>()); break;
    case 64: query(mel_fft_kernel<64>, fft_opt_in<64>()); break;
    default: return 0;
  }
  return err == cudaSuccess ? blocks : 0;
}
