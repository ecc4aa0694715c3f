// GroupNorm over NCHW on Hopper: the fused GroupNorm(+SiLU) and the
// per-channel moments.
//
// Replace diffmusic_tpu/pallas/groupnorm_kernel.py::fused_group_norm
// (_gn_kernel) and ::channel_moments (_moments_kernel).
//
// Bound: device memory. About ten operations per element against the card's
// ~295 bf16 operations per byte, so the design reads each element once from
// device memory and writes it once:
//   - gn_cluster_kernel, the fused GroupNorm(+SiLU): in NCHW a group (C/G
//     channels x H*W) is one contiguous run. Each (batch, group) run goes to
//     a cluster of k blocks (k in 1, 2, 4, 8; launched with
//     cudaLaunchKernelEx and a cluster dimension), so that a batch-1 call
//     of 32 groups fills more than 32 SMs. The plan, made once per
//     geometry (kernels/group_norm.py::fused_plan), gives k, the threads a
//     block and the loads a thread (at most 8, of V = 16 bytes where the run
//     allows). Each thread issues all its loads into registers before it
//     sums any of them; each block sums its fp32 (sum, sum of squares) by
//     warp butterflies, and the cluster's blocks read each other's sums
//     through distributed shared memory behind one cluster barrier, adding
//     them in rank order. Each thread then normalises, scales, shifts and
//     applies the optional SiLU from its registers and stores: one read of
//     device memory and one write, no second pass. The channel of each
//     element follows a running index. var = E[x^2] - mu^2 in fp32, as the
//     JAX kernel. fp32 runs the same design with 4 elements a load.
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
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

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

// ------------------------------------------------- the fused GroupNorm
constexpr int GN_MAX_THREADS = 512;    // 128 registers a thread: the 8 loads need no spills
constexpr int GN_MAX_LOADS = 8;     // loads a thread, all in registers at once
constexpr int GN_MAX_CLUSTER = 8;   // the portable cluster size

template <typename T, int V> struct alignas(sizeof(T) * V) Pack { T e[V]; };

struct GnArgs {
  int HW, cpg, G, n_loads;   // n_loads: the group's loads of V elements
  int k, loads;              // blocks a group (the cluster), loads a thread
  float eps;
  int silu;
};

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;" ::: "memory");
}

// One (batch, group) run of n = cpg * HW contiguous elements per cluster of
// k blocks (grid (G * k, B), cluster (k, 1, 1)); block r of the cluster
// takes loads [r * loads * threads, (r + 1) * loads * threads) of the run,
// its thread j loads r * loads * threads + i * threads + j for i < loads.
template <typename T, int V>
__global__ void __launch_bounds__(GN_MAX_THREADS)
gn_cluster_kernel(const T* __restrict__ x, const T* __restrict__ w, const T* __restrict__ bias,
                  T* __restrict__ y, GnArgs a) {
  using P = Pack<T, V>;
  extern __shared__ float wb[];              // the group's weight, then bias, in fp32
  __shared__ float2 warp_part[GN_MAX_THREADS / 32];
  __shared__ float2 block_part;              // read by the cluster's other blocks
  __shared__ float2 parts[GN_MAX_CLUSTER];
  const int rank = blockIdx.x % a.k, g = blockIdx.x / a.k, b = blockIdx.y;
  const int nt = blockDim.x, tid = threadIdx.x;
  const size_t off = ((size_t)b * a.G + g) * ((size_t)a.cpg * a.HW);
  const P* src = reinterpret_cast<const P*>(x + off);
  P* dst = reinterpret_cast<P*>(y + off);
  const int first = rank * a.loads * nt + tid;

  // every load in flight before any is summed
  P r[GN_MAX_LOADS];
#pragma unroll
  for (int i = 0; i < GN_MAX_LOADS; ++i)
    if (i < a.loads && first + i * nt < a.n_loads) r[i] = src[first + i * nt];
  for (int i = tid; i < a.cpg; i += nt) {
    wb[i] = dm::to_f(w[g * a.cpg + i]);
    wb[a.cpg + i] = dm::to_f(bias[g * a.cpg + i]);
  }

  // fp32 sums: the thread's loads in order, the warp's butterfly, the
  // block's warps in warp 0, then the cluster's blocks in rank order
  float s = 0.f, ss = 0.f;
#pragma unroll
  for (int i = 0; i < GN_MAX_LOADS; ++i)
    if (i < a.loads && first + i * nt < a.n_loads) {
#pragma unroll
      for (int q = 0; q < V; ++q) {
        const float f = dm::to_f(r[i].e[q]);
        s += f;
        ss = fmaf(f, f, ss);
      }
    }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    s += __shfl_xor_sync(0xffffffffu, s, o);
    ss += __shfl_xor_sync(0xffffffffu, ss, o);
  }
  if (tid % 32 == 0) warp_part[tid / 32] = make_float2(s, ss);
  __syncthreads();
  if (tid < 32) {
    float2 v = tid < nt / 32 ? warp_part[tid] : make_float2(0.f, 0.f);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      v.x += __shfl_xor_sync(0xffffffffu, v.x, o);
      v.y += __shfl_xor_sync(0xffffffffu, v.y, o);
    }
    if (tid == 0) block_part = v;
  }
  float2 tot;
  if (a.k > 1) {
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();   // every block's partial sums are in its shared memory
    if (tid < a.k) parts[tid] = *cluster.map_shared_rank(&block_part, tid);
    cluster_arrive();   // this block's reads of the others are done
    __syncthreads();
    tot = parts[0];
    for (int i = 1; i < a.k; ++i) {
      tot.x += parts[i].x;
      tot.y += parts[i].y;
    }
  } else {
    __syncthreads();
    tot = block_part;
  }
  const float count = (float)a.cpg * (float)a.HW;
  const float mu = tot.x / count;
  const float inv = rsqrtf(tot.y / count - mu * mu + a.eps);

  // normalise, scale, shift and SiLU from the registers; the channel of
  // each element by a running index (one division a thread, not one an
  // element)
  const int e0 = first * V, step = nt * V;
  int ch = e0 / a.HW, rem = e0 - ch * a.HW;
  const int step_ch = step / a.HW, step_rem = step - step_ch * a.HW;
#pragma unroll
  for (int i = 0; i < GN_MAX_LOADS; ++i) {
    if (i < a.loads && first + i * nt < a.n_loads) {
      P out;
      int c = ch, e = rem;
#pragma unroll
      for (int q = 0; q < V; ++q) {
        if (e == a.HW) {
          ++c;
          e = 0;
        }
        const float t = (dm::to_f(r[i].e[q]) - mu) * inv;
        float v = fmaf(t, wb[c], wb[a.cpg + c]);
        if (a.silu) v = v / (1.f + __expf(-v));
        out.e[q] = dm::from_f<T>(v);
        ++e;
      }
      dst[first + i * nt] = out;
    }
    ch += step_ch;
    rem += step_rem;
    if (rem >= a.HW) {
      rem -= a.HW;
      ++ch;
    }
  }
  if (a.k > 1) cluster_wait();   // no block leaves while its sums may still be read
}

size_t gn_smem(int cpg) { return (size_t)2 * cpg * sizeof(float); }

template <typename T, int V>
int launch_gn(const void* x, const void* w, const void* b, void* y, int B, int G,
              const GnArgs& a, int threads, cudaStream_t s) {
  auto kernel = gn_cluster_kernel<T, V>;
  const size_t smem = gn_smem(a.cpg);
  cudaError_t err = cudaSuccess;
  if (smem > 48 * 1024)   // the default limit: opt in above it
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(G * a.k, B);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = a.k;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  cfg.attrs = &cluster;
  cfg.numAttrs = a.k > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, kernel, (const T*)x, (const T*)w, (const T*)b, (T*)y, a);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

// x, y: (B, C, HW) contiguous; w, b: (C,). The plan (vec, k, threads,
// loads) of kernels/group_norm.py::fused_plan: V = vec elements a load
// (dividing cpg * HW), k blocks a group, `threads` a block, `loads` a thread.
template <typename T>
int run_group_norm(const void* x, const void* w, const void* b, void* y, int B, int C, int HW,
                   int G, float eps, int silu, int vec, int k, int threads, int loads,
                   cudaStream_t s) {
  const auto pow2 = [](int v) { return v >= 1 && (v & (v - 1)) == 0; };
  if (G < 1 || C % G != 0) return (int)cudaErrorInvalidValue;
  const long n = (long)(C / G) * HW;
  if (!pow2(k) || k > GN_MAX_CLUSTER || !pow2(threads) || threads < 32 ||
      threads > GN_MAX_THREADS || loads < 1 || loads > GN_MAX_LOADS || vec < 1 ||
      vec * (int)sizeof(T) > 16 || n % vec != 0 || (long)k * threads * loads * vec < n)
    return (int)cudaErrorInvalidValue;
  const GnArgs a{HW, C / G, G, (int)(n / vec), k, loads, eps, silu};
  switch (vec) {
    case 8:
      if constexpr (sizeof(T) == 2) return launch_gn<T, 8>(x, w, b, y, B, G, a, threads, s);
      return (int)cudaErrorInvalidValue;
    case 4: return launch_gn<T, 4>(x, w, b, y, B, G, a, threads, s);
    case 2: return launch_gn<T, 2>(x, w, b, y, B, G, a, threads, s);
    case 1: return launch_gn<T, 1>(x, w, b, y, B, G, a, threads, s);
    default: return (int)cudaErrorInvalidValue;
  }
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
// x, y: (B, C, HW); w, b: (C,); all of one dtype. (vec, k, threads, loads)
// is the plan of kernels/group_norm.py::fused_plan.
extern "C" int dm_group_norm(int dtype, const void* x, const void* w, const void* b, void* y,
                             int B, int C, int HW, int G, float eps, int silu, int vec, int k,
                             int threads, int loads, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 1)
    return run_group_norm<bf16>(x, w, b, y, B, C, HW, G, eps, silu, vec, k, threads, loads, s);
  return run_group_norm<float>(x, w, b, y, B, C, HW, G, eps, silu, vec, k, threads, loads, s);
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
