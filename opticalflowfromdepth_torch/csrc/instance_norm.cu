// InstanceNorm2d (affine=False), forward and backward, optional fused ReLU,
// for Hopper (sm_90a).
//
// The forward:
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
//
// The backward (instance_norm_bwd) replaces no TPU kernel: the JAX package
// computes its closed form, _in_bwd, in XLA. Per row, in f32, cast to x's
// dtype at the end:
//   g' = g * [y > 0]          (with a fused ReLU; y the forward's output)
//   yhat = (x - mean) * rstd  (the forward's saved f32 statistics)
//   dx = rstd * (g' - sum(g') / n - yhat * sum(g' yhat) / n)
// What bounds it: bytes, g, x (and y) read once and dx written once. It
// keeps the forward's design with 2 or 3 operands in place of one: each
// block brings its part of the rows of g, x (and y) into shared memory by
// bulk copies under one mbarrier, takes both row sums from there, adds them
// across a cluster in rank order where a row is split, and writes dx from
// the same shared memory with 16-byte stores; only rows too long for the
// cluster stream twice. The host plan (plan(..., operands)) sizes the cut
// by the bytes of all the operands together.

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

// The backward, over the same cut of the rows as the forward; RELU: the
// forward had a fused ReLU, so y is read and gates g. g, x, y and dx are
// 16-byte aligned, so one split serves all of them.
template <typename T, bool RELU>
__global__ void __launch_bounds__(THREADS)
instance_norm_bwd(const T* __restrict__ g, const T* __restrict__ x,
                  const T* __restrict__ y, const float* __restrict__ mean,
                  const float* __restrict__ rstd, T* __restrict__ dx,
                  long long rows, long long n, int cs, long long slice, int k,
                  int piece, float inv_n) {
  constexpr int V = 16 / sizeof(T);
  constexpr int OPS = RELU ? 3 : 2;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ uint64_t bar;
  __shared__ float red[2][WARPS];
  __shared__ float row_s[MAX_ROWS], row_q[MAX_ROWS];
  __shared__ float row_m[MAX_ROWS], row_r[MAX_ROWS];
  __shared__ float part[2];
  const int tid = threadIdx.x;
  // each operand's buffer: a piece at any 16-byte phase
  const size_t stride = ((size_t)piece * sizeof(T) + 31) / 16 * 16;
  const T* const src[3] = {g, x, y};

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
  if (tid < r1 - r0) {
    row_m[tid] = mean[r0 + tid];
    row_r[tid] = rstd[r0 + tid];
  }
  __syncthreads();
  uint32_t phase = 0;
  const T* buf[3] = {nullptr, nullptr, nullptr};  // value ps + i at [i]

  // bring the values [ps, pe) of every operand into shared memory
  auto load = [&](long long ps, long long pe) {
    const uintptr_t off = reinterpret_cast<uintptr_t>(x + ps) & 15;
    const Split<T> sp = split(x, ps, pe);
    const long long body = sp.head + sp.nv * V;
#pragma unroll
    for (int o = 0; o < OPS; ++o) {
      T* b = reinterpret_cast<T*>(smem_raw + o * stride + off);
      buf[o] = b;
      if (sp.nv > 0 && tid == 0) {
        if (o == 0) mbar_expect_tx(&bar, (uint32_t)(sp.nv * 16 * OPS));
        bulk_load(b + sp.head, src[o] + ps + sp.head, (uint32_t)(sp.nv * 16),
                  &bar);
      }
      for (long long i = tid; i < sp.head; i += THREADS) b[i] = src[o][ps + i];
      for (long long i = body + tid; i < pe - ps; i += THREADS)
        b[i] = src[o][ps + i];
    }
    if (sp.nv > 0) {
      mbar_wait(&bar, phase);
      phase ^= 1;
    }
    __syncthreads();
  };
  auto release = [&]() {
    fence_proxy_async();
    __syncthreads();
  };
  // g' and yhat of the value at i of the piece's buffers
  auto terms = [&](const T* pg, const T* px, const T* py, long long i,
                   float m, float r, float& gp, float& yh) {
    gp = to_f(pg[i]);
    if (RELU && !(to_f(py[i]) > 0.f)) gp = 0.f;
    yh = (to_f(px[i]) - m) * r;
  };

  // pass 1: the rows' sum(g') and sum(g' yhat) over the block's values
  for (long long ps = s; ps < e; ps += piece) {
    const long long pe = ps + piece < e ? ps + piece : e;
    load(ps, pe);
    for (long long j = ps / n; j * n < pe; ++j) {
      const long long a = j * n > ps ? j * n : ps;
      const long long b = (j + 1) * n < pe ? (j + 1) * n : pe;
      const Split<T> sp = split(x, a, b);
      const T* pg = buf[0] + (a - ps);
      const T* px = buf[1] + (a - ps);
      const T* py = buf[OPS - 1] + (a - ps);
      const float m = row_m[j - r0], r = row_r[j - r0];
      float sg = 0.f, sgy = 0.f, gp, yh;
      for (long long i = tid; i < sp.head; i += THREADS) {
        terms(pg, px, py, i, m, r, gp, yh);
        sg += gp;
        sgy += gp * yh;
      }
      for (long long i = tid; i < sp.nv; i += THREADS) {
        const long long v = sp.head + i * V;
        uint4 ug = *reinterpret_cast<const uint4*>(pg + v);
        uint4 ux = *reinterpret_cast<const uint4*>(px + v);
        uint4 uy = RELU ? *reinterpret_cast<const uint4*>(py + v) : ux;
#pragma unroll
        for (int c = 0; c < V; ++c) {
          terms(reinterpret_cast<const T*>(&ug),
                reinterpret_cast<const T*>(&ux),
                reinterpret_cast<const T*>(&uy), c, m, r, gp, yh);
          sg += gp;
          sgy += gp * yh;
        }
      }
      for (long long i = sp.head + sp.nv * V + tid; i < b - a; i += THREADS) {
        terms(pg, px, py, i, m, r, gp, yh);
        sg += gp;
        sgy += gp * yh;
      }
      block_sum(sg, sgy, red);
      if (tid == 0) {
        row_s[j - r0] += sg;
        row_q[j - r0] += sgy;
      }
    }
    if (!resident) release();
  }
  __syncthreads();

  // a row split across the cluster: add the blocks' partials in rank order
  if (cs > 1) {
    cg::cluster_group cluster = cg::this_cluster();
    if (tid == 0) {
      part[0] = row_s[0];
      part[1] = row_q[0];
    }
    cluster.sync();
    if (tid == 0) {
      float sg = 0.f, sgy = 0.f;
      for (int rk = 0; rk < cs; ++rk) {
        const float* p = cluster.map_shared_rank(part, rk);
        sg += p[0];
        sgy += p[1];
      }
      row_s[0] = sg;
      row_q[0] = sgy;
    }
    cluster.sync();  // no block leaves while another reads its partials
  }
  if (tid < r1 - r0) {  // the means of g' and of g' yhat
    row_s[tid] *= inv_n;
    row_q[tid] *= inv_n;
  }
  __syncthreads();

  // pass 2: dx from shared memory (streamed slices load again)
  for (long long ps = s; ps < e; ps += piece) {
    const long long pe = ps + piece < e ? ps + piece : e;
    if (!resident) load(ps, pe);
    for (long long j = ps / n; j * n < pe; ++j) {
      const long long a = j * n > ps ? j * n : ps;
      const long long b = (j + 1) * n < pe ? (j + 1) * n : pe;
      const Split<T> sp = split(x, a, b);
      const T* pg = buf[0] + (a - ps);
      const T* px = buf[1] + (a - ps);
      const T* py = buf[OPS - 1] + (a - ps);
      T* o = dx + a;
      const float m = row_m[j - r0], r = row_r[j - r0];
      const float mg = row_s[j - r0], mgy = row_q[j - r0];
      float gp, yh;
      for (long long i = tid; i < sp.head; i += THREADS) {
        terms(pg, px, py, i, m, r, gp, yh);
        o[i] = from_f<T>(r * ((gp - mg) - yh * mgy));
      }
      for (long long i = tid; i < sp.nv; i += THREADS) {
        const long long v = sp.head + i * V;
        uint4 ug = *reinterpret_cast<const uint4*>(pg + v);
        uint4 ux = *reinterpret_cast<const uint4*>(px + v);
        uint4 uy = RELU ? *reinterpret_cast<const uint4*>(py + v) : ux;
        uint4 w;
        T* ew = reinterpret_cast<T*>(&w);
#pragma unroll
        for (int c = 0; c < V; ++c) {
          terms(reinterpret_cast<const T*>(&ug),
                reinterpret_cast<const T*>(&ux),
                reinterpret_cast<const T*>(&uy), c, m, r, gp, yh);
          ew[c] = from_f<T>(r * ((gp - mg) - yh * mgy));
        }
        *reinterpret_cast<uint4*>(o + v) = w;
      }
      for (long long i = sp.head + sp.nv * V + tid; i < b - a; i += THREADS) {
        terms(pg, px, py, i, m, r, gp, yh);
        o[i] = from_f<T>(r * ((gp - mg) - yh * mgy));
      }
    }
    if (!resident) release();
  }
}

// Launch `kernel` on `blocks` blocks of THREADS in clusters of `cs` with
// `smem` bytes of dynamic shared memory; `allowed`: the largest set for
// this kernel yet. Returns the first CUDA error.
template <typename... P, typename... A>
int launch_clustered(void (*kernel)(P...), size_t smem, size_t& allowed,
                     long long blocks, int cs, cudaStream_t st, A... args) {
  int e;
  if (smem > allowed) {  // and the most shared memory a SM can give
    if ((e = (int)cudaFuncSetAttribute(
             kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
             (int)smem)) ||
        (e = (int)cudaFuncSetAttribute(
             kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
             cudaSharedmemCarveoutMaxShared)))
      return e;
    allowed = smem;
  }
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
  if ((e = (int)cudaLaunchKernelEx(&cfg, kernel, args...))) return e;
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* x, void* y, float* mean, float* rstd, long long rows,
           long long n, int cs, long long slice, int k, int piece,
           float inv_n, float eps, int relu, cudaStream_t st) {
  static size_t allowed = 0;
  const long long blocks = cs == 1 ? (rows + k - 1) / k : rows * cs;
  return launch_clustered(instance_norm_fwd<T>,
                          (size_t)piece * sizeof(T) + 16, allowed, blocks, cs,
                          st, static_cast<const T*>(x), static_cast<T*>(y),
                          mean, rstd, rows, n, cs, slice, k, piece, inv_n, eps,
                          relu);
}

template <typename T, bool RELU>
int launch_bwd_as(const void* g, const void* x, const void* y,
                  const float* mean, const float* rstd, void* dx,
                  long long rows, long long n, int cs, long long slice, int k,
                  int piece, float inv_n, cudaStream_t st) {
  static size_t allowed = 0;
  const size_t stride = ((size_t)piece * sizeof(T) + 31) / 16 * 16;
  const long long blocks = cs == 1 ? (rows + k - 1) / k : rows * cs;
  return launch_clustered(
      instance_norm_bwd<T, RELU>, stride * (RELU ? 3 : 2), allowed, blocks,
      cs, st, static_cast<const T*>(g), static_cast<const T*>(x),
      static_cast<const T*>(y), mean, rstd, static_cast<T*>(dx), rows, n, cs,
      slice, k, piece, inv_n);
}

template <typename T>
int launch_bwd(const void* g, const void* x, const void* y, const float* mean,
               const float* rstd, void* dx, long long rows, long long n,
               int cs, long long slice, int k, int piece, float inv_n,
               int relu, cudaStream_t st) {
  return relu ? launch_bwd_as<T, true>(g, x, y, mean, rstd, dx, rows, n, cs,
                                       slice, k, piece, inv_n, st)
              : launch_bwd_as<T, false>(g, x, y, mean, rstd, dx, rows, n, cs,
                                        slice, k, piece, inv_n, st);
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

// The backward: g, x, y (read only when relu; may be null otherwise), dx:
// [rows, n] contiguous, 16-byte aligned, of the dtype (0 f32, 1 bf16, 2
// f16); mean, rstd: [rows] f32, the forward's. The plan as the forward's,
// made for 2 operands (g, x) or 3 (g, x, y) by plan(..., operands). Returns
// the first CUDA error (0 on success).
extern "C" int ofd_instance_norm_bwd(const void* g, const void* x,
                                     const void* y, const float* mean,
                                     const float* rstd, void* dx,
                                     long long rows, long long n, int dtype,
                                     int cluster, long long slice,
                                     int rows_per_block, int piece,
                                     float inv_n, int relu, void* stream) {
  const bool ok =
      rows >= 0 && n >= 0 && piece > 0 &&
      (cluster == 1 || cluster == 2 || cluster == 4 ||
       cluster == MAX_CLUSTER) &&
      rows_per_block >= 1 && rows_per_block <= MAX_ROWS &&
      (cluster == 1 ? slice == n
                    : rows_per_block == 1 && slice > 0 &&
                          (cluster - 1) * slice < n && cluster * slice >= n) &&
      (((uintptr_t)g | (uintptr_t)x | (uintptr_t)dx |
        (relu ? (uintptr_t)y : 0)) & 15) == 0 &&
      (!relu || y != nullptr);
  if (!ok) return (int)cudaErrorInvalidValue;
  if (rows == 0 || n == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  switch (dtype) {
    case 0:
      return launch_bwd<float>(g, x, y, mean, rstd, dx, rows, n, cluster,
                               slice, rows_per_block, piece, inv_n, relu, st);
    case 1:
      return launch_bwd<__nv_bfloat16>(g, x, y, mean, rstd, dx, rows, n,
                                       cluster, slice, rows_per_block, piece,
                                       inv_n, relu, st);
    case 2:
      return launch_bwd<__half>(g, x, y, mean, rstd, dx, rows, n, cluster,
                                slice, rows_per_block, piece, inv_n, relu, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
