// InstanceNorm2d (affine=False), forward, optional fused ReLU, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel opticalflowfromdepth_tpu/ops/instance_norm.py:
// _in_kernel (launched by _instance_norm_fwd_pallas). Same function, per
// (sample, channel) row of n = H * W contiguous NCHW values: f32 sum and
// sum of squares, variance E[x^2] - mean^2 clamped at 0, rstd =
// 1 / sqrt(var + eps), y = (x - mean) * rstd in f32 (ReLU'd if asked),
// cast to x's dtype; f32 mean and rstd per row.
//
// What bounds it: bytes, x read once and y written once. A row is read
// from device memory once: each block holds its part of the rows on chip
// (shared memory) between the statistics and the normalisation. The host
// plan (ops/instance_norm.py:plan) gives each launch one of three forms:
//   - short rows: one block takes `k` (<= 8) whole consecutive rows;
//   - long rows: a thread block cluster of `cs` (2, 4 or 8) blocks splits
//     each row into slices of `slice` values, one a block; the blocks add
//     their partial sums through distributed shared memory (each reads the
//     cluster's partials in rank order, so every block gets the same bits)
//     and normalise their own slices; the cluster's rank 0 writes mean and
//     rstd;
//   - rows too long for the cluster's shared memory: each block streams
//     its slice through shared memory twice (statistics, then normalise),
//     `piece` values at a time, reading x twice.
// A block brings a piece in by one bulk copy (the 16-byte aligned middle;
// the unaligned ends by plain loads) under an mbarrier, sums in f32 (each
// thread its values in order, then a fixed tree), and writes y with
// 16-byte stores. No atomics: every launch on the same inputs gives the
// same bits.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace cg = cooperative_groups;
using namespace hopper;

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_ROWS = 8;   // rows a block at most
constexpr int MAX_CLUSTER = 8;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f(__half v) { return __half2float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}
template <>
__device__ __forceinline__ __half from_f<__half>(float v) {
  return __float2half_rn(v);
}

// The values [a, b) of the tensor split for 16-byte access: `head` values
// up to the first 16-byte aligned address, `nv` vectors, then the rest.
template <typename T>
struct Split {
  long long head, nv, tail;
};

template <typename T>
__device__ __forceinline__ Split<T> split(const T* base, long long a,
                                          long long b) {
  constexpr int V = 16 / sizeof(T);
  const uintptr_t addr = reinterpret_cast<uintptr_t>(base + a);
  long long head = (long long)(((16 - (addr & 15)) & 15) / sizeof(T));
  if (head > b - a) head = b - a;
  const long long nv = (b - a - head) / V;
  return {head, nv, b - a - head - nv * V};
}

// sum and sum of squares over the block: each thread's pair, then a fixed
// tree; thread 0 gets the result
__device__ __forceinline__ void block_sum(float& s, float& q,
                                          float (&red)[2][WARPS]) {
#pragma unroll
  for (int m = 16; m; m >>= 1) {
    s += __shfl_xor_sync(0xffffffffu, s, m);
    q += __shfl_xor_sync(0xffffffffu, q, m);
  }
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
    red[0][warp] = s;
    red[1][warp] = q;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    s = q = 0.f;
    for (int w = 0; w < WARPS; ++w) {
      s += red[0][w];
      q += red[1][w];
    }
  }
  __syncthreads();
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
instance_norm_fwd(const T* __restrict__ x, T* __restrict__ y,
                  float* __restrict__ mean, float* __restrict__ rstd,
                  long long rows, long long n, int cs, long long slice, int k,
                  int piece, float inv_n, float eps, int relu) {
  constexpr int V = 16 / sizeof(T);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ uint64_t bar;
  __shared__ float red[2][WARPS];
  __shared__ float row_s[MAX_ROWS], row_q[MAX_ROWS];
  __shared__ float row_m[MAX_ROWS], row_r[MAX_ROWS];
  __shared__ float part[2];
  const int tid = threadIdx.x;

  // the block's values [s, e) and rows [r0, r1)
  const long long grp = blockIdx.x / cs;
  const int rank = (int)(blockIdx.x % cs);
  long long r0, r1, s, e;
  if (cs == 1) {
    r0 = grp * k;
    r1 = r0 + k < rows ? r0 + k : rows;
    s = r0 * n;
    e = r1 * n;
  } else {
    r0 = grp;
    r1 = grp + 1;
    s = r0 * n + rank * slice;
    e = s + slice < r1 * n ? s + slice : r1 * n;
  }
  const bool resident = e - s <= piece;
  if (tid == 0) {
    mbar_init(&bar, 1);
    mbar_fence_init();
  }
  if (tid < MAX_ROWS) row_s[tid] = row_q[tid] = 0.f;
  __syncthreads();
  uint32_t phase = 0;
  T* buf = nullptr;  // value ps + i of the tensor at buf[i]

  // bring the values [ps, pe) of x into shared memory, at the same
  // 16-byte phase as in device memory
  auto load = [&](long long ps, long long pe) {
    buf = reinterpret_cast<T*>(
        smem_raw + (reinterpret_cast<uintptr_t>(x + ps) & 15));
    const Split<T> sp = split(x, ps, pe);
    if (sp.nv > 0 && tid == 0) {
      const uint32_t bytes = (uint32_t)(sp.nv * 16);
      mbar_expect_tx(&bar, bytes);
      bulk_load(buf + sp.head, x + ps + sp.head, bytes, &bar);
    }
    const long long body = sp.head + sp.nv * V;
    for (long long i = tid; i < sp.head; i += THREADS) buf[i] = x[ps + i];
    for (long long i = body + tid; i < pe - ps; i += THREADS)
      buf[i] = x[ps + i];
    if (sp.nv > 0) {
      mbar_wait(&bar, phase);
      phase ^= 1;
    }
    __syncthreads();
  };
  // before the next piece overwrites what this one read
  auto release = [&]() {
    fence_proxy_async();
    __syncthreads();
  };

  // pass 1: the rows' sums over the block's values
  for (long long ps = s; ps < e; ps += piece) {
    const long long pe = ps + piece < e ? ps + piece : e;
    load(ps, pe);
    for (long long j = ps / n; j * n < pe; ++j) {
      const long long a = j * n > ps ? j * n : ps;
      const long long b = (j + 1) * n < pe ? (j + 1) * n : pe;
      const Split<T> sp = split(x, a, b);
      const T* p = buf + (a - ps);
      float sum = 0.f, sq = 0.f;
      for (long long i = tid; i < sp.head; i += THREADS) {
        const float v = to_f(p[i]);
        sum += v;
        sq += v * v;
      }
      for (long long i = tid; i < sp.nv; i += THREADS) {
        const uint4 u =
            *reinterpret_cast<const uint4*>(p + sp.head + i * V);
        const T* ev = reinterpret_cast<const T*>(&u);
#pragma unroll
        for (int c = 0; c < V; ++c) {
          const float v = to_f(ev[c]);
          sum += v;
          sq += v * v;
        }
      }
      for (long long i = sp.head + sp.nv * V + tid; i < b - a; i += THREADS) {
        const float v = to_f(p[i]);
        sum += v;
        sq += v * v;
      }
      block_sum(sum, sq, red);
      if (tid == 0) {
        row_s[j - r0] += sum;
        row_q[j - r0] += sq;
      }
    }
    if (!resident) release();
  }

  // a row split across the cluster: add the blocks' partials in rank order
  if (cs > 1) {
    cg::cluster_group cluster = cg::this_cluster();
    if (tid == 0) {
      part[0] = row_s[0];
      part[1] = row_q[0];
    }
    cluster.sync();
    if (tid == 0) {
      float sum = 0.f, sq = 0.f;
      for (int rk = 0; rk < cs; ++rk) {
        const float* p = cluster.map_shared_rank(part, rk);
        sum += p[0];
        sq += p[1];
      }
      row_s[0] = sum;
      row_q[0] = sq;
    }
    cluster.sync();  // no block leaves while another reads its partials
  }
  if (tid < r1 - r0) {
    const float m = row_s[tid] * inv_n;
    const float var = fmaxf(row_q[tid] * inv_n - m * m, 0.f);
    const float r = 1.f / sqrtf(var + eps);
    row_m[tid] = m;
    row_r[tid] = r;
    if (rank == 0) {
      mean[r0 + tid] = m;
      rstd[r0 + tid] = r;
    }
  }
  __syncthreads();

  // pass 2: normalise from shared memory (streamed slices load again)
  for (long long ps = s; ps < e; ps += piece) {
    const long long pe = ps + piece < e ? ps + piece : e;
    if (!resident) load(ps, pe);
    for (long long j = ps / n; j * n < pe; ++j) {
      const long long a = j * n > ps ? j * n : ps;
      const long long b = (j + 1) * n < pe ? (j + 1) * n : pe;
      const Split<T> sp = split(x, a, b);
      const T* p = buf + (a - ps);
      T* o = y + a;
      const float m = row_m[j - r0], r = row_r[j - r0];
      auto norm = [&](float v) {
        const float t = (v - m) * r;
        return relu ? fmaxf(t, 0.f) : t;
      };
      for (long long i = tid; i < sp.head; i += THREADS)
        o[i] = from_f<T>(norm(to_f(p[i])));
      for (long long i = tid; i < sp.nv; i += THREADS) {
        const uint4 u =
            *reinterpret_cast<const uint4*>(p + sp.head + i * V);
        const T* ev = reinterpret_cast<const T*>(&u);
        uint4 w;
        T* ew = reinterpret_cast<T*>(&w);
#pragma unroll
        for (int c = 0; c < V; ++c) ew[c] = from_f<T>(norm(to_f(ev[c])));
        *reinterpret_cast<uint4*>(o + sp.head + i * V) = w;
      }
      for (long long i = sp.head + sp.nv * V + tid; i < b - a; i += THREADS)
        o[i] = from_f<T>(norm(to_f(p[i])));
    }
    if (!resident) release();
  }
}

template <typename T>
int launch(const void* x, void* y, float* mean, float* rstd, long long rows,
           long long n, int cs, long long slice, int k, int piece,
           float inv_n, float eps, int relu, cudaStream_t st) {
  const size_t smem = (size_t)piece * sizeof(T) + 16;
  static size_t allowed = 0;  // the largest dynamic shared memory set yet
  int e;
  if (smem > allowed) {  // and the most shared memory a SM can give
    if ((e = (int)cudaFuncSetAttribute(
             instance_norm_fwd<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
             (int)smem)) ||
        (e = (int)cudaFuncSetAttribute(
             instance_norm_fwd<T>,
             cudaFuncAttributePreferredSharedMemoryCarveout,
             cudaSharedmemCarveoutMaxShared)))
      return e;
    allowed = smem;
  }
  const long long blocks = cs == 1 ? (rows + k - 1) / k : rows * cs;
  if (blocks >= (1ll << 31)) return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)blocks);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if ((e = (int)cudaLaunchKernelEx(&cfg, instance_norm_fwd<T>,
                                   static_cast<const T*>(x),
                                   static_cast<T*>(y), mean, rstd, rows, n,
                                   cs, slice, k, piece, inv_n, eps, relu)))
    return e;
  return (int)cudaGetLastError();
}

}  // namespace

// x, y: [rows, n] contiguous, 16-byte aligned; dtype 0 f32, 1 bf16, 2
// f16; mean, rstd: [rows] f32. The plan (ops/instance_norm.py:plan):
// cluster (1, 2, 4 or 8) blocks a row of `slice` values each, or with a
// cluster of 1, `rows_per_block` (1-8) whole rows a block; `piece` the
// values a block holds in shared memory at once (its whole part when that
// fits). Returns the first CUDA error (0 on success).
extern "C" int ofd_instance_norm_fwd(const void* x, void* y, float* mean,
                                     float* rstd, long long rows, long long n,
                                     int dtype, int cluster, long long slice,
                                     int rows_per_block, int piece,
                                     float inv_n, float eps, int relu,
                                     void* stream) {
  const bool ok =
      rows >= 0 && n >= 0 && piece > 0 &&
      (cluster == 1 || cluster == 2 || cluster == 4 ||
       cluster == MAX_CLUSTER) &&
      rows_per_block >= 1 && rows_per_block <= MAX_ROWS &&
      (cluster == 1 ? slice == n
                    : rows_per_block == 1 && slice > 0 &&
                          (cluster - 1) * slice < n && cluster * slice >= n) &&
      (((uintptr_t)x | (uintptr_t)y) & 15) == 0;
  if (!ok) return (int)cudaErrorInvalidValue;
  if (rows == 0 || n == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  switch (dtype) {
    case 0:
      return launch<float>(x, y, mean, rstd, rows, n, cluster, slice,
                           rows_per_block, piece, inv_n, eps, relu, st);
    case 1:
      return launch<__nv_bfloat16>(x, y, mean, rstd, rows, n, cluster, slice,
                                   rows_per_block, piece, inv_n, eps, relu,
                                   st);
    case 2:
      return launch<__half>(x, y, mean, rstd, rows, n, cluster, slice,
                            rows_per_block, piece, inv_n, eps, relu, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
