// GroupNorm over NCHW on Hopper: the fused GroupNorm(+SiLU) and the
// per-channel moments.
//
// Replace diffmusic_tpu/pallas/groupnorm_kernel.py::fused_group_norm
// (_gn_kernel) and ::channel_moments (_moments_kernel).
//
// Bound: device memory. About ten operations per element against the card's
// ~295 bf16 operations per byte, so the design reads each element once from
// device memory and writes it once:
//   - group_norm_kernel: in NCHW a group (C/G channels x H*W) is one
//     contiguous run, so one block per (batch, group) sums x and x^2 in fp32
//     (16-byte loads where the run is aligned), reduces them across the
//     block, then re-reads its run (from L2: at most 2^20 / G elements under
//     the JAX routing rule) to normalise, scale, shift, apply the optional
//     SiLU and write in x's dtype. var = E[x^2] - mu^2, as the JAX kernel.
//   - moments_bf16_kernel, the bf16 channel moments: a team of threads per
//     (batch, channel) row of N elements, as many as the row has loads of V
//     elements (V = 8, 16 bytes, or the largest of 4, 2, 1 dividing N, so
//     that every load is aligned), up to 512: the UNet's short rows (N
//     62-1000) a team of 32-128 and several rows a block, the long ones (N
//     4000-64000) a block of 512 threads each, one to sixteen loads a
//     thread. The plan is made per geometry by the wrapper
//     (kernels/group_norm.py::moments_plan). On the H100 fewer loads a
//     thread and more threads beat more loads a thread (PERF.md): a call's
//     loads are few, so what counts is how many are in flight at once; a
//     row split across a cluster of blocks spent its time on the cluster's
//     barriers. Sums in fp32: each thread over its loads in order, the
//     team's butterfly, then a butterfly over its warps' sums.
//   - channel_moments_kernel<float>, the exact fp32 path: one block per
//     (batch, channel) row writes its fp32 (sum, sum of squares).
// Both write out[b][0|1][c].
#include "common.cuh"

namespace {

using dm::bf16;
constexpr int THREADS = 512;

// (sum, sum of squares) over the block, returned to every thread.
__device__ __forceinline__ float2 block_sum2(float a, float b) {
  __shared__ float2 red[THREADS / 32 + 1];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, o);
    b += __shfl_xor_sync(0xffffffffu, b, o);
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) red[warp] = make_float2(a, b);
  __syncthreads();
  if (warp == 0) {
    float2 v = lane < THREADS / 32 ? red[lane] : make_float2(0.f, 0.f);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      v.x += __shfl_xor_sync(0xffffffffu, v.x, o);
      v.y += __shfl_xor_sync(0xffffffffu, v.y, o);
    }
    if (lane == 0) red[THREADS / 32] = v;
  }
  __syncthreads();
  return red[THREADS / 32];
}

// fp32 (sum, sum of squares) of src[0, n), 8 elements a load where `vec`.
template <typename T>
__device__ __forceinline__ float2 run_sums(const T* src, size_t n, bool vec) {
  float s = 0.f, ss = 0.f;
  if (vec) {
    for (size_t i = (size_t)threadIdx.x * 8; i < n; i += (size_t)THREADS * 8) {
      float v[8];
      dm::load8<T>(src + i, v);
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        s += v[q];
        ss = fmaf(v[q], v[q], ss);
      }
    }
  } else {
    for (size_t i = threadIdx.x; i < n; i += THREADS) {
      const float v = dm::to_f(src[i]);
      s += v;
      ss = fmaf(v, v, ss);
    }
  }
  return block_sum2(s, ss);
}

// y = (x - mu) * (inv * w_c) + b_c [then SiLU]; coef holds (inv * w_c, b_c)
// for the group's cpg channels.
__device__ __forceinline__ float gn_apply(float v, float mu, const float* coef, int ch,
                                          int silu) {
  const float y = fmaf(v - mu, coef[2 * ch], coef[2 * ch + 1]);
  return silu ? y / (1.f + __expf(-y)) : y;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
group_norm_kernel(const T* __restrict__ x, const T* __restrict__ w, const T* __restrict__ bias,
                  T* __restrict__ y, int C, int HW, int G, float eps, int silu) {
  extern __shared__ float coef[];   // 2 * cpg floats
  const int g = blockIdx.x, b = blockIdx.y, cpg = C / G;
  const size_t n = (size_t)cpg * HW;
  const size_t off = ((size_t)b * C + (size_t)g * cpg) * HW;
  const T* xg = x + off;
  T* yg = y + off;
  const bool vec = n % 8 == 0 && off % 8 == 0;   // every 8-element load 16-byte aligned

  const float2 tot = run_sums(xg, n, vec);
  const float mu = tot.x / (float)n;
  const float inv = rsqrtf(tot.y / (float)n - mu * mu + eps);
  for (int i = threadIdx.x; i < cpg; i += THREADS) {
    coef[2 * i] = inv * dm::to_f(w[g * cpg + i]);
    coef[2 * i + 1] = dm::to_f(bias[g * cpg + i]);
  }
  __syncthreads();

  if (vec) {
    for (size_t i = (size_t)threadIdx.x * 8; i < n; i += (size_t)THREADS * 8) {
      float v[8];
      dm::load8<T>(xg + i, v);
#pragma unroll
      for (int q = 0; q < 8; ++q) v[q] = gn_apply(v[q], mu, coef, (int)((i + q) / HW), silu);
      dm::store8<T>(yg + i, v);
    }
  } else {
    for (size_t i = threadIdx.x; i < n; i += THREADS)
      yg[i] = dm::from_f<T>(gn_apply(dm::to_f(xg[i]), mu, coef, (int)(i / HW), silu));
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
channel_moments_kernel(const T* __restrict__ x, float* __restrict__ out, int C, int N) {
  const int c = blockIdx.x, b = blockIdx.y;
  const size_t off = ((size_t)b * C + c) * N;
  const float2 tot = run_sums(x + off, (size_t)N, N % 8 == 0 && off % 8 == 0);
  if (threadIdx.x == 0) {
    out[((size_t)b * 2 + 0) * C + c] = tot.x;
    out[((size_t)b * 2 + 1) * C + c] = tot.y;
  }
}

size_t gn_smem(int cpg) { return (size_t)2 * cpg * sizeof(float); }

template <typename T>
int run_group_norm(const void* x, const void* w, const void* b, void* y, int B, int C, int HW,
                   int G, float eps, int silu, cudaStream_t s) {
  return dm::launch(group_norm_kernel<T>, dim3(G, B), dim3(THREADS), gn_smem(C / G), s,
                    (const T*)x, (const T*)w, (const T*)b, (T*)y, C, HW, G, eps, silu);
}

// ------------------------------------------------------- bf16 moments
constexpr int MOM_MAX_THREADS = 1024;   // a block

template <int V> struct alignas(2 * V) Vec { bf16 e[V]; };

// Rows of N elements, B * C of them; a team of `team` threads a row,
// blockDim.x / team rows a block. Lane j of a row's team reads the loads of
// V elements j, j + team, j + 2 team, ... and sums them in order; then the
// team's butterfly (xor shuffles) and, for a team of several warps, a
// butterfly over the warps' sums in the team's first warp.
template <int V>
__global__ void __launch_bounds__(MOM_MAX_THREADS)
moments_bf16_kernel(const bf16* __restrict__ x, float* __restrict__ out, int C, int N, int rows,
                    int team) {
  __shared__ float2 warp_sums[MOM_MAX_THREADS / 32];
  const int lane = threadIdx.x % team;
  const int row = blockIdx.x * (blockDim.x / team) + threadIdx.x / team;
  const int loads = N / V;
  float s = 0.f, ss = 0.f;
  if (row < rows) {
    const Vec<V>* src = reinterpret_cast<const Vec<V>*>(x + (size_t)row * N);
#pragma unroll 4
    for (int i = lane; i < loads; i += team) {
      const Vec<V> v = src[i];
#pragma unroll
      for (int q = 0; q < V; ++q) {
        const float f = __bfloat162float(v.e[q]);
        s += f;
        ss = fmaf(f, f, ss);
      }
    }
  }
  for (int o = (team < 32 ? team : 32) / 2; o > 0; o >>= 1) {
    s += __shfl_xor_sync(0xffffffffu, s, o);
    ss += __shfl_xor_sync(0xffffffffu, ss, o);
  }
  if (team > 32) {   // the team's warps: lane w of its first warp takes warp w's sums
    const int warp = threadIdx.x / 32, first = warp - lane / 32;
    if (threadIdx.x % 32 == 0) warp_sums[warp] = make_float2(s, ss);
    __syncthreads();
    if (lane < 32) {
      const float2 v = lane < team / 32 ? warp_sums[first + lane] : make_float2(0.f, 0.f);
      s = v.x;
      ss = v.y;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        s += __shfl_xor_sync(0xffffffffu, s, o);
        ss += __shfl_xor_sync(0xffffffffu, ss, o);
      }
    }
  }
  if (lane == 0 && row < rows) {
    const int b = row / C, c = row % C;
    out[((size_t)b * 2 + 0) * C + c] = s;
    out[((size_t)b * 2 + 1) * C + c] = ss;
  }
}

int run_moments_bf16(const void* x, void* out, int B, int C, int N, int vec, int team,
                     int threads, cudaStream_t s) {
  const auto pow2 = [](int v) { return v >= 1 && (v & (v - 1)) == 0; };
  if (!pow2(team) || !pow2(threads) || threads < 32 || threads > MOM_MAX_THREADS ||
      team > threads || vec < 1 || N % vec != 0)
    return (int)cudaErrorInvalidValue;
  const int rows = B * C, per_block = threads / team;
  const dim3 grid((rows + per_block - 1) / per_block);
  switch (vec) {
    case 8: moments_bf16_kernel<8><<<grid, threads, 0, s>>>((const bf16*)x, (float*)out, C, N,
                                                            rows, team); break;
    case 4: moments_bf16_kernel<4><<<grid, threads, 0, s>>>((const bf16*)x, (float*)out, C, N,
                                                            rows, team); break;
    case 2: moments_bf16_kernel<2><<<grid, threads, 0, s>>>((const bf16*)x, (float*)out, C, N,
                                                            rows, team); break;
    case 1: moments_bf16_kernel<1><<<grid, threads, 0, s>>>((const bf16*)x, (float*)out, C, N,
                                                            rows, team); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t (0 = launched).
extern "C" int dm_group_norm(int dtype, const void* x, const void* w, const void* b, void* y,
                             int B, int C, int HW, int G, float eps, int silu, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 1) return run_group_norm<bf16>(x, w, b, y, B, C, HW, G, eps, silu, s);
  return run_group_norm<float>(x, w, b, y, B, C, HW, G, eps, silu, s);
}

extern "C" size_t dm_group_norm_smem(int cpg) { return gn_smem(cpg); }

// x: (B, C, N); out: (B, 2, C) float32. bf16 takes the plan (vec, team,
// threads) of kernels/group_norm.py::moments_plan; fp32 ignores it.
extern "C" int dm_channel_moments(int dtype, const void* x, void* out, int B, int C, int N,
                                  int vec, int team, int threads, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 1) return run_moments_bf16(x, out, B, C, N, vec, team, threads, s);
  return dm::launch(channel_moments_kernel<float>, dim3(C, B), dim3(THREADS), 0, s,
                    (const float*)x, (float*)out, C, N);
}
