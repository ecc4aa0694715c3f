// The fused mel spectrogram on Hopper: reflect pad -> frames -> windowed DFT
// -> |X|^power -> mel, one launch, fp32.
//
// Replaces diffmusic_tpu/pallas/mel_kernel.py::fused_mel_spectrogram
// (_mel_block_kernel).
//
// The function's least work is an FFT's (about 2.5 n_fft log2 n_fft fp32
// operations per frame), which leaves it bound by its bytes. This design
// does the DFT as a dense product instead: n_fft x 2 n_freqs FMAs per frame
// (10-20x the FFT's count) at 67 TFLOP/s outside the tensor cores; TF32
// would miss the fp32 tolerance over a 400-1024-term sum. It keeps every
// intermediate on the chip:
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
