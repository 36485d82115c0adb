// Fused RAFT correlation window lookup, forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel opticalflowfromdepth_tpu/ops/fused_corr.py:
// _fwd_kernel (launched by _cat_fwd). Same function: for every query q
// and pyramid level l, the (2r+1)^2 bilinear window of
// corr = f2cat . f1[q] / sqrt(C) around coords[q] / 2^l, x-major
// (k = kx*(2r+1) + ky), with out-of-range taps exactly 0.
//
// The TPU design forms the dense [R, block] correlation tile for all
// levels in VMEM (35.5 GFLOP per lookup at Sintel size). A Hopper block
// has 227 KB of shared memory, not the ~15 MB that needs, so this kernel
// uses the window form instead (equal by linearity, as the reference's
// alt_cuda_corr): per query and level it takes the dot products of f1[q]
// with the f2 rows at the (2r+2)^2 integer neighbours of the centre,
// then combines them with the bilinear weights. That is ~1.4 GFLOP per
// lookup, so the kernel is bound by bytes: f1 and the output once from
// device memory, and f2cat (5 MB at Sintel size) re-read from L2.
//
// Layout: one warp per query; each lane holds 8 channels of f1[q] per
// 256-channel chunk in registers (16-byte loads), reduces each dot with
// warp shuffles, and lane 0 parks the dots in shared memory for the
// bilinear combination. f2cat keeps the packed layout of cat_meta: per
// level, x-major rows with y padded to hp, so the K+1 y-neighbours of one
// column are contiguous rows. Accumulation is f32; the output is written
// in f1's dtype.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define MAX_LEVELS 8
#define WARPS 8
#define VEC 8
#define MAX_CHUNKS 2            // C <= MAX_CHUNKS * 32 * VEC = 512
#define MAX_TAPS 128            // (2r+2)^2, so r <= 4

struct Meta {
  int hl[MAX_LEVELS], wl[MAX_LEVELS], hp[MAX_LEVELS], off[MAX_LEVELS];
};

__device__ __forceinline__ void load8(const float* p, float* v) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* v) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store1(float* p, float v) { *p = v; }

__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <typename T>
__global__ void __launch_bounds__(WARPS * 32)
fused_corr_fwd_kernel(const T* __restrict__ f1, const T* __restrict__ f2cat,
                      const float* __restrict__ coords, T* __restrict__ out,
                      int B, int N, int C, int R, int L, Meta meta,
                      int radius, float scale) {
  __shared__ float dots[WARPS][MAX_TAPS];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long q = (long long)blockIdx.x * WARPS + warp;  // flat (b, n)
  if (q >= (long long)B * N) return;  // uniform over the warp
  const int b = (int)(q / N);
  const int K = 2 * radius + 1;
  const int K1 = K + 1;
  const int taps = K1 * K1;

  float f1r[MAX_CHUNKS][VEC];
  const T* f1q = f1 + q * C;
#pragma unroll
  for (int ch = 0; ch < MAX_CHUNKS; ++ch) {
    const int c = (ch * 32 + lane) * VEC;
    if (c < C) {
      load8(f1q + c, f1r[ch]);
    } else {
#pragma unroll
      for (int i = 0; i < VEC; ++i) f1r[ch][i] = 0.f;
    }
  }
  const float cx = coords[2 * q];
  const float cy = coords[2 * q + 1];
  const T* f2b = f2cat + (long long)b * R * C;
  T* outq = out + q * (long long)(L * K * K);
  float* dq = dots[warp];

  for (int l = 0; l < L; ++l) {
    const int hl = meta.hl[l], wl = meta.wl[l], hp = meta.hp[l];
    const int off = meta.off[l];
    T* o = outq + l * K * K;
    if (hl == 0 || wl == 0) {  // level pooled away: zero lookups
      for (int t = lane; t < K * K; t += 32) store1(o + t, 0.f);
      continue;
    }
    const float s = 1.0f / (float)(1 << l);
    const float x = cx * s, y = cy * s;
    const float x0 = floorf(x), y0 = floorf(y);
    const float fx = x - x0, fy = y - y0;
    // Clamp before the int conversion (defined for any coordinate); a
    // centre clamped this way still has no tap inside the level.
    const int ix0 =
        (int)fminf(fmaxf(x0, -radius - 2.f), (float)(wl + radius)) - radius;
    const int iy0 =
        (int)fminf(fmaxf(y0, -radius - 2.f), (float)(hl + radius)) - radius;

#pragma unroll 4
    for (int t = 0; t < taps; ++t) {
      const int xx = ix0 + t / K1;
      const int yy = iy0 + t % K1;
      float d = 0.f;
      if (xx >= 0 && xx < wl && yy >= 0 && yy < hl) {  // uniform branch
        const T* row = f2b + ((long long)off + (long long)xx * hp + yy) * C;
        float acc = 0.f;
#pragma unroll
        for (int ch = 0; ch < MAX_CHUNKS; ++ch) {
          const int c = (ch * 32 + lane) * VEC;
          if (c < C) {
            float v[VEC];
            load8(row + c, v);
#pragma unroll
            for (int i = 0; i < VEC; ++i) acc = fmaf(f1r[ch][i], v[i], acc);
          }
        }
#pragma unroll
        for (int m = 16; m; m >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, m);
        d = acc * scale;
      }
      if (lane == 0) dq[t] = d;
    }
    __syncwarp();
    // y first, then x: the TPU kernel's stage order
    for (int t = lane; t < K * K; t += 32) {
      const int kx = t / K, ky = t % K;
      const float* d0 = dq + kx * K1 + ky;
      const float* d1 = d0 + K1;
      const float v = (1.f - fx) * ((1.f - fy) * d0[0] + fy * d0[1]) +
                      fx * ((1.f - fy) * d1[0] + fy * d1[1]);
      store1(o + t, v);
    }
    __syncwarp();
  }
}

// Backward of the lookup, for Hopper (sm_90a).
//
// Replaces the TPU kernel opticalflowfromdepth_tpu/ops/fused_corr.py:
// _bwd_kernel (launched by _cat_bwd). For every query q and level l it
// spreads the cotangent g[q, l, kx, ky] over the (2r+2)^2 integer taps
// around coords[q] / 2^l with the transposed bilinear weights (x-stage,
// then y-stage), keeps the taps inside the level, and adds
// d_tap * s * f2cat[row] to df1[q] and d_tap * s * f1[q] to df2cat[row],
// s = 1/sqrt(C). Coordinates get no gradient, by contract.
//
// The TPU kernel builds the dense [R, block] d_corr tile in VMEM and sums
// df2cat in an output block that every query tile revisits in order.
// Neither carries over: a Hopper block has 227 KB of shared memory, and
// blocks run in no order. So this kernel mirrors the forward: one warp per
// query, f1[q] in registers, the tap gradients in shared memory, df1[q]
// summed in registers and written once. df2cat rows are shared between
// neighbouring queries, so each lane adds its 8 channels of
// d_tap * s * f1[q] into a zeroed f32 scratch [B, R, C] with atomics
// (vectorised float4 atomics on sm_90); the wrapper casts the scratch to
// f2cat's dtype. The order of those sums changes from run to run, so
// df2cat is not bit-reproducible: it agrees with the plain version to the
// f32 rounding of a sum of a few hundred terms (about 1e-4 absolute at
// the training shapes). The kernel is bound by the atomics' traffic to L2
// (256 f32 adds per query and in-range tap), not by device memory.
//
// The centre is clamped before the int conversion exactly as in the
// forward, so a query far out of range has no tap in range and gives
// exactly zero gradients.

__device__ __forceinline__ float load1(const float* p) { return *p; }

__device__ __forceinline__ float load1(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

__device__ __forceinline__ void atomic_add8(float* p, const float* v,
                                            float d) {
#if defined(__CUDA_ARCH__) && __CUDA_ARCH__ >= 900 && \
    (__CUDACC_VER_MAJOR__ > 12 ||                   \
     (__CUDACC_VER_MAJOR__ == 12 && __CUDACC_VER_MINOR__ >= 1))
  atomicAdd(reinterpret_cast<float4*>(p),
            make_float4(d * v[0], d * v[1], d * v[2], d * v[3]));
  atomicAdd(reinterpret_cast<float4*>(p + 4),
            make_float4(d * v[4], d * v[5], d * v[6], d * v[7]));
#else
#pragma unroll
  for (int i = 0; i < VEC; ++i) atomicAdd(p + i, d * v[i]);
#endif
}

template <typename T>
__global__ void __launch_bounds__(WARPS * 32)
fused_corr_bwd_kernel(const T* __restrict__ g, const T* __restrict__ f1,
                      const T* __restrict__ f2cat,
                      const float* __restrict__ coords, T* __restrict__ df1,
                      float* __restrict__ df2, int B, int N, int C, int R,
                      int L, Meta meta, int radius, float scale) {
  __shared__ float gs[WARPS][MAX_TAPS];
  __shared__ float dtap[WARPS][MAX_TAPS];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long q = (long long)blockIdx.x * WARPS + warp;  // flat (b, n)
  if (q >= (long long)B * N) return;  // uniform over the warp
  const int b = (int)(q / N);
  const int K = 2 * radius + 1;
  const int K1 = K + 1;
  const int taps = K1 * K1;

  float f1r[MAX_CHUNKS][VEC];
  float acc[MAX_CHUNKS][VEC];
  const T* f1q = f1 + q * C;
#pragma unroll
  for (int ch = 0; ch < MAX_CHUNKS; ++ch) {
    const int c = (ch * 32 + lane) * VEC;
    if (c < C) {
      load8(f1q + c, f1r[ch]);
    } else {
#pragma unroll
      for (int i = 0; i < VEC; ++i) f1r[ch][i] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[ch][i] = 0.f;
  }
  const float cx = coords[2 * q];
  const float cy = coords[2 * q + 1];
  const T* f2b = f2cat + (long long)b * R * C;
  float* df2b = df2 + (long long)b * R * C;
  const T* gq = g + q * (long long)(L * K * K);
  float* gw = gs[warp];
  float* dw = dtap[warp];

  for (int l = 0; l < L; ++l) {
    const int hl = meta.hl[l], wl = meta.wl[l], hp = meta.hp[l];
    const int off = meta.off[l];
    if (hl == 0 || wl == 0) continue;  // level pooled away: no gradient
    const float s = 1.0f / (float)(1 << l);
    const float x = cx * s, y = cy * s;
    const float x0 = floorf(x), y0 = floorf(y);
    const float fx = x - x0, fy = y - y0;
    const int ix0 =
        (int)fminf(fmaxf(x0, -radius - 2.f), (float)(wl + radius)) - radius;
    const int iy0 =
        (int)fminf(fmaxf(y0, -radius - 2.f), (float)(hl + radius)) - radius;
    if (ix0 + K1 <= 0 || ix0 >= wl || iy0 + K1 <= 0 || iy0 >= hl)
      continue;  // no tap inside the level (uniform)

    for (int t = lane; t < K * K; t += 32) gw[t] = load1(gq + l * K * K + t);
    __syncwarp();
    // transpose of the forward's two stages: tap (i, j) takes window
    // (kx, ky) = (i, j) with weights (1-fx)(1-fy), (i-1, j) with fx(1-fy),
    // (i, j-1) with (1-fx)fy and (i-1, j-1) with fx fy
    for (int t = lane; t < taps; t += 32) {
      const int i = t / K1, j = t % K1;
      float v = 0.f;
      if (i < K) {
        if (j < K) v += (1.f - fx) * (1.f - fy) * gw[i * K + j];
        if (j > 0) v += (1.f - fx) * fy * gw[i * K + j - 1];
      }
      if (i > 0) {
        if (j < K) v += fx * (1.f - fy) * gw[(i - 1) * K + j];
        if (j > 0) v += fx * fy * gw[(i - 1) * K + j - 1];
      }
      dw[t] = v * scale;
    }
    __syncwarp();

    for (int t = 0; t < taps; ++t) {
      const int xx = ix0 + t / K1;
      const int yy = iy0 + t % K1;
      if (xx < 0 || xx >= wl || yy < 0 || yy >= hl) continue;  // uniform
      const float d = dw[t];
      const long long row = (long long)off + (long long)xx * hp + yy;
      const T* f2row = f2b + row * C;
      float* df2row = df2b + row * C;
#pragma unroll
      for (int ch = 0; ch < MAX_CHUNKS; ++ch) {
        const int c = (ch * 32 + lane) * VEC;
        if (c < C) {
          float v[VEC];
          load8(f2row + c, v);
#pragma unroll
          for (int i = 0; i < VEC; ++i) acc[ch][i] = fmaf(d, v[i], acc[ch][i]);
          atomic_add8(df2row + c, f1r[ch], d);
        }
      }
    }
    __syncwarp();
  }

  T* o = df1 + q * C;
#pragma unroll
  for (int ch = 0; ch < MAX_CHUNKS; ++ch) {
    const int c = (ch * 32 + lane) * VEC;
    if (c < C) {
#pragma unroll
      for (int i = 0; i < VEC; ++i) store1(o + c + i, acc[ch][i]);
    }
  }
}

static bool unpack_meta(int L, int C, int radius, const int* meta, Meta* m) {
  if (L < 0 || L > MAX_LEVELS || C % VEC != 0 || C > MAX_CHUNKS * 32 * VEC ||
      (2 * radius + 2) * (2 * radius + 2) > MAX_TAPS || radius < 0)
    return false;
  *m = Meta{};
  for (int l = 0; l < L; ++l) {
    m->hl[l] = meta[4 * l];
    m->wl[l] = meta[4 * l + 1];
    m->hp[l] = meta[4 * l + 2];
    m->off[l] = meta[4 * l + 3];
  }
  return true;
}

// g: [B, N, L*(2r+1)^2] in the features' dtype; df1: [B, N, C] in that
// dtype, written in full; df2: [B, R, C] f32, zeroed by the caller.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int ofd_fused_corr_bwd(const void* g, const void* f1,
                                  const void* f2cat, const void* coords,
                                  void* df1, void* df2, int B, int N, int C,
                                  int R, int L, const int* meta, int radius,
                                  float scale, int is_bf16, void* stream) {
  Meta m;
  if (!unpack_meta(L, C, radius, meta, &m)) return (int)cudaErrorInvalidValue;
  const long long total = (long long)B * N;
  if (total == 0) return 0;
  const dim3 grid((unsigned)((total + WARPS - 1) / WARPS));
  cudaStream_t st = (cudaStream_t)stream;
  if (is_bf16) {
    fused_corr_bwd_kernel<__nv_bfloat16><<<grid, WARPS * 32, 0, st>>>(
        (const __nv_bfloat16*)g, (const __nv_bfloat16*)f1,
        (const __nv_bfloat16*)f2cat, (const float*)coords,
        (__nv_bfloat16*)df1, (float*)df2, B, N, C, R, L, m, radius, scale);
  } else {
    fused_corr_bwd_kernel<float><<<grid, WARPS * 32, 0, st>>>(
        (const float*)g, (const float*)f1, (const float*)f2cat,
        (const float*)coords, (float*)df1, (float*)df2, B, N, C, R, L, m,
        radius, scale);
  }
  return (int)cudaGetLastError();
}

// meta: 4*L host ints (hl, wl, hp, row_offset) per level, as cat_meta.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int ofd_fused_corr_fwd(const void* f1, const void* f2cat,
                                  const void* coords, void* out, int B, int N,
                                  int C, int R, int L, const int* meta,
                                  int radius, float scale, int is_bf16,
                                  void* stream) {
  Meta m;
  if (!unpack_meta(L, C, radius, meta, &m)) return (int)cudaErrorInvalidValue;
  const long long total = (long long)B * N;
  if (total == 0) return 0;
  const dim3 grid((unsigned)((total + WARPS - 1) / WARPS));
  cudaStream_t st = (cudaStream_t)stream;
  if (is_bf16) {
    fused_corr_fwd_kernel<__nv_bfloat16><<<grid, WARPS * 32, 0, st>>>(
        (const __nv_bfloat16*)f1, (const __nv_bfloat16*)f2cat,
        (const float*)coords, (__nv_bfloat16*)out, B, N, C, R, L, m, radius,
        scale);
  } else {
    fused_corr_fwd_kernel<float><<<grid, WARPS * 32, 0, st>>>(
        (const float*)f1, (const float*)f2cat, (const float*)coords,
        (float*)out, B, N, C, R, L, m, radius, scale);
  }
  return (int)cudaGetLastError();
}
