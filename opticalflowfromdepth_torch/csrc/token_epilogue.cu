// The per-token epilogues of GMFlow's transformer layers, each in one pass
// over device memory, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package leaves its LayerNorm and its exact
// GELU to XLA, which fuses each into the ops around it. In PyTorch each is a
// chain of elementwise launches (the layer norm: bf16 -> f32, the f32 norm,
// f32 -> bf16, then the residual add; the GELU: four passes), so the kernels
// below take the forms ops/token_epilogue.py's plain versions compute and
// make each one pass. What bounds both: bytes, each input read once and the
// output written once.
//
// token_norm_fwd<T, VPL, RESIDUAL>: rows [rows, C] of T (f32 or bf16), C a
// multiple of 8 up to 512. Per row: f32 mean, then the f32 centred sum of
// squares (two passes over registers), rstd = 1 / sqrt(var + eps),
// n = T(weight * ((x - mean) * rstd) + bias) with f32 weight and bias; with
// RESIDUAL, y = T(float(res) + float(n)), which is `res + n` in T. A row is
// `lanes` threads (a power of two up to 32), each holding up to VPL 16-byte
// vectors of it (lane, lane + lanes, ...); the sums go through shuffles
// within the lanes; weight and bias stay in the thread's registers for its
// whole life; groups of lanes walk the rows in a grid-stride loop, a warp's
// groups in step, so that a shuffle never leaves a lane behind. At C = 128
// in bf16 a half-warp holds a 256-byte row, a 16-byte load a lane.
//
// gelu_exact_fwd<T>: y = GELU(x) as the op-by-op form rounds it:
//   t = T(x * c), c = T(-sqrt(1/2)) (from the host)
//   e = T(erfcf(t))
//   h = T(0.5 * x)
//   y = T(h * e)
// every product in f32 and rounded to T (round to nearest even by
// cvt.rn.bf16.f32, as PyTorch's kernels round), erfcf from libdevice with no
// fast-math flags: bit for bit the plain version. In bf16, erfcf is what
// bounds the pass (~30 instructions an element against 4 bytes), and t
// takes only 65536 values: e comes from a table of T(erfcf(t)) at every
// bf16 pattern, made on the card once by erfc_table_bf16 with the same
// erfcf. One flat grid-stride pass of 16-byte vectors, two in flight a
// thread, the scalar tail after them.
//
// No atomics and no shared memory: every launch on the same inputs gives the
// same bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

// A type's 16-byte vector as floats, and rounding to the type.
template <typename T>
struct Io;

template <>
struct Io<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void unpack(const uint4& r, float* f) {
    f[0] = __uint_as_float(r.x);
    f[1] = __uint_as_float(r.y);
    f[2] = __uint_as_float(r.z);
    f[3] = __uint_as_float(r.w);
  }
  __device__ __forceinline__ static uint4 pack(const float* f) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                      __float_as_uint(f[2]), __float_as_uint(f[3]));
  }
  __device__ __forceinline__ static float round(float v) { return v; }
  __device__ __forceinline__ static float load1(const float* p) { return *p; }
  __device__ __forceinline__ static void store1(float* p, float v) { *p = v; }
};

template <>
struct Io<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ __forceinline__ static uint32_t bits(float v) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(v));
  }
  __device__ __forceinline__ static void unpack(const uint4& r, float* f) {
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  __device__ __forceinline__ static uint4 pack(const float* f) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) w[i] = bits(f[2 * i]) | (bits(f[2 * i + 1]) << 16);
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
  __device__ __forceinline__ static float round(float v) {
    return __uint_as_float(bits(v) << 16);
  }
  __device__ __forceinline__ static float load1(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
  }
  __device__ __forceinline__ static void store1(__nv_bfloat16* p, float v) {
    *p = __float2bfloat16_rn(v);
  }
};

// The resident 256-thread blocks an SM for a thread holding `floats` values
// of each of weight, bias, x (and res): 4 (64 registers) up to 8 values, 2
// up to 16, else 1; ops/token_epilogue.py:plan sizes the grid by the same.
constexpr int blocks_per_sm(int floats) {
  return floats <= 8 ? 4 : floats <= 16 ? 2 : 1;
}

template <typename T, int VPL, bool RESIDUAL>
__global__ void __launch_bounds__(THREADS, blocks_per_sm(VPL * Io<T>::N))
token_norm_fwd(const T* __restrict__ x, const T* __restrict__ res,
               const float* __restrict__ weight,
               const float* __restrict__ bias, T* __restrict__ y,
               long long rows, int c, int log2_lanes, float eps) {
  using IO = Io<T>;
  constexpr int N = IO::N;
  const int lanes = 1 << log2_lanes;
  const int vecs = c / N;
  const int lane = threadIdx.x & (lanes - 1);
  const int groups = THREADS >> log2_lanes;            // a block's rows
  // the warp's first row and this group's offset from it: the warp's
  // groups take consecutive rows and leave the loop together
  const int warp_groups = 32 >> log2_lanes;
  const int in_warp = (threadIdx.x & 31) >> log2_lanes;
  const long long first =
      (long long)blockIdx.x * groups + (threadIdx.x >> 5) * warp_groups;
  const long long stride = (long long)gridDim.x * groups;
  const float inv_c = 1.0f / (float)c;

  bool on[VPL];
  float w[VPL][N], b[VPL][N];
#pragma unroll
  for (int v = 0; v < VPL; ++v) {
    const int col = (lane + v * lanes) * N;
    on[v] = lane + v * lanes < vecs;
#pragma unroll
    for (int i = 0; i < N; ++i) {
      w[v][i] = on[v] ? weight[col + i] : 0.f;
      b[v][i] = on[v] ? bias[col + i] : 0.f;
    }
  }

  for (long long r0 = first; r0 < rows; r0 += stride) {
    const long long row = r0 + in_warp;
    const bool live = row < rows;
    const long long base = row * c;
    float xv[VPL][N];
    float rv[RESIDUAL ? VPL : 1][N];
#pragma unroll
    for (int v = 0; v < VPL; ++v) {
      const long long at = base + (long long)(lane + v * lanes) * N;
      uint4 raw = make_uint4(0u, 0u, 0u, 0u);
      if (live && on[v]) raw = *reinterpret_cast<const uint4*>(x + at);
      IO::unpack(raw, xv[v]);
      if constexpr (RESIDUAL) {
        uint4 rr = make_uint4(0u, 0u, 0u, 0u);
        if (live && on[v]) rr = *reinterpret_cast<const uint4*>(res + at);
        IO::unpack(rr, rv[v]);
      }
    }
    float s = 0.f;
#pragma unroll
    for (int v = 0; v < VPL; ++v)
#pragma unroll
      for (int i = 0; i < N; ++i) s += xv[v][i];
    for (int m = lanes >> 1; m; m >>= 1) s += __shfl_xor_sync(0xffffffffu, s, m);
    const float mean = s * inv_c;
    float q = 0.f;
#pragma unroll
    for (int v = 0; v < VPL; ++v)
#pragma unroll
      for (int i = 0; i < N; ++i) {
        const float d = on[v] ? xv[v][i] - mean : 0.f;
        q = fmaf(d, d, q);
      }
    for (int m = lanes >> 1; m; m >>= 1) q += __shfl_xor_sync(0xffffffffu, q, m);
    const float rstd = 1.0f / sqrtf(q * inv_c + eps);
    if (!live) continue;
#pragma unroll
    for (int v = 0; v < VPL; ++v) {
      if (!on[v]) continue;
      float o[N];
#pragma unroll
      for (int i = 0; i < N; ++i) {
        o[i] = fmaf(w[v][i], (xv[v][i] - mean) * rstd, b[v][i]);
        if constexpr (RESIDUAL) o[i] = rv[v][i] + IO::round(o[i]);
      }
      const long long at = base + (long long)(lane + v * lanes) * N;
      *reinterpret_cast<uint4*>(y + at) = IO::pack(o);
    }
  }
}

// e = T(erfcf(t)) of a t already rounded to T: in f32 erfcf itself; in
// bf16 t is one of 65536 patterns, so e is the entry of t's bits in a table
// that erfc_table_bf16 made by the same erfcf, one 2-byte load (the hot
// entries stay in L1) in place of erfcf's ~30 instructions.
__device__ __forceinline__ float erfc_rounded(float t, const uint16_t*,
                                              float) {
  return erfcf(t);
}
__device__ __forceinline__ float erfc_rounded(float t,
                                              const uint16_t* __restrict__ tab,
                                              __nv_bfloat16) {
  return __uint_as_float((uint32_t)__ldg(tab + (__float_as_uint(t) >> 16))
                         << 16);
}

template <typename T>
__device__ __forceinline__ float gelu_exact(float v, float c,
                                            const uint16_t* __restrict__ tab) {
  const float t = Io<T>::round(v * c);
  const float e = erfc_rounded(t, tab, T());
  const float h = Io<T>::round(0.5f * v);
  return h * e;
}

__global__ void erfc_table_bf16(uint16_t* __restrict__ tab) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < 65536)
    tab[i] = (uint16_t)Io<__nv_bfloat16>::bits(
        erfcf(__uint_as_float((uint32_t)i << 16)));
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 4)
gelu_exact_fwd(const T* __restrict__ x, T* __restrict__ y, long long n,
               float c, const uint16_t* __restrict__ tab) {
  using IO = Io<T>;
  constexpr int N = IO::N;
  const long long vecs = n / N;
  const long long stride = (long long)gridDim.x * THREADS;
  const long long tid = (long long)blockIdx.x * THREADS + threadIdx.x;
  for (long long i = tid; i < vecs; i += 2 * stride) {
    const long long j = i + stride;
    const uint4 r0 = reinterpret_cast<const uint4*>(x)[i];
    uint4 r1 = make_uint4(0u, 0u, 0u, 0u);
    if (j < vecs) r1 = reinterpret_cast<const uint4*>(x)[j];
    float f0[N], f1[N];
    IO::unpack(r0, f0);
    IO::unpack(r1, f1);
#pragma unroll
    for (int k = 0; k < N; ++k) {
      f0[k] = gelu_exact<T>(f0[k], c, tab);
      f1[k] = gelu_exact<T>(f1[k], c, tab);
    }
    reinterpret_cast<uint4*>(y)[i] = IO::pack(f0);
    if (j < vecs) reinterpret_cast<uint4*>(y)[j] = IO::pack(f1);
  }
  const long long t = vecs * N + tid;          // the scalar tail
  if (t < n) IO::store1(y + t, gelu_exact<T>(IO::load1(x + t), c, tab));
}

template <typename T, int VPL>
int launch_norm(const void* x, const void* res, const float* weight,
                const float* bias, void* y, long long rows, int c,
                int log2_lanes, int blocks, float eps, cudaStream_t st) {
  const T* xt = static_cast<const T*>(x);
  T* yt = static_cast<T*>(y);
  if (res)
    token_norm_fwd<T, VPL, true><<<blocks, THREADS, 0, st>>>(
        xt, static_cast<const T*>(res), weight, bias, yt, rows, c,
        log2_lanes, eps);
  else
    token_norm_fwd<T, VPL, false><<<blocks, THREADS, 0, st>>>(
        xt, nullptr, weight, bias, yt, rows, c, log2_lanes, eps);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_norm_vpl(const void* x, const void* res, const float* weight,
                    const float* bias, void* y, long long rows, int c,
                    int log2_lanes, int vpl, int blocks, float eps,
                    cudaStream_t st) {
  switch (vpl) {
    case 1:
      return launch_norm<T, 1>(x, res, weight, bias, y, rows, c, log2_lanes,
                               blocks, eps, st);
    case 2:
      return launch_norm<T, 2>(x, res, weight, bias, y, rows, c, log2_lanes,
                               blocks, eps, st);
    case 4:
      return launch_norm<T, 4>(x, res, weight, bias, y, rows, c, log2_lanes,
                               blocks, eps, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// The layer norm (+ residual): x, res (null: no residual), y [rows, c] of
// the dtype (0 f32, 1 bf16), contiguous, 16-byte aligned; weight, bias [c]
// f32. The host plan (ops/token_epilogue.py:plan): 2^log2_lanes threads a
// row, vpl (1, 2 or 4) vectors a thread, `blocks` blocks of 256 threads.
// Returns the first CUDA error (0 on success).
extern "C" int ofd_token_norm_fwd(const void* x, const void* res,
                                  const float* weight, const float* bias,
                                  void* y, long long rows, int c, int dtype,
                                  int log2_lanes, int vpl, int blocks,
                                  float eps, void* stream) {
  const int per_vec = dtype == 1 ? 8 : 4;
  const int vecs = c / per_vec;
  const bool ok =
      (dtype == 0 || dtype == 1) && rows >= 0 && c > 0 && c <= 512 &&
      c % 8 == 0 && log2_lanes >= 0 && log2_lanes <= 5 &&
      (vpl == 1 || log2_lanes == 5) && (vpl << log2_lanes) >= vecs &&
      blocks > 0 && weight != nullptr && bias != nullptr &&
      (((uintptr_t)x | (uintptr_t)y | (uintptr_t)res) & 15) == 0;
  if (!ok) return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 1)
    return launch_norm_vpl<__nv_bfloat16>(x, res, weight, bias, y, rows, c,
                                          log2_lanes, vpl, blocks, eps, st);
  return launch_norm_vpl<float>(x, res, weight, bias, y, rows, c, log2_lanes,
                                vpl, blocks, eps, st);
}

// The bf16 GELU's erfc table: tab [65536] 2-byte entries, bf16(erfcf(t))
// at the bits of each bf16 t. Returns the first CUDA error (0 on success).
extern "C" int ofd_erfc_table(void* tab, void* stream) {
  if (tab == nullptr || ((uintptr_t)tab & 1)) return (int)cudaErrorInvalidValue;
  erfc_table_bf16<<<65536 / THREADS, THREADS, 0, (cudaStream_t)stream>>>(
      static_cast<uint16_t*>(tab));
  return (int)cudaGetLastError();
}

// The exact GELU: x, y [n] of the dtype (0 f32, 1 bf16), contiguous, 16-byte
// aligned; c = T(-sqrt(1/2)) as a float; tab: the erfc table (bf16; unread
// in f32); `blocks` blocks of 256 threads. Returns the first CUDA error (0
// on success).
extern "C" int ofd_gelu_exact_fwd(const void* x, void* y, long long n,
                                  int dtype, float c, const void* tab,
                                  int blocks, void* stream) {
  const bool ok = (dtype == 0 || dtype == 1) && n >= 0 && blocks > 0 &&
                  (dtype == 0 || tab != nullptr) &&
                  (((uintptr_t)x | (uintptr_t)y) & 15) == 0;
  if (!ok) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  const uint16_t* t = static_cast<const uint16_t*>(tab);
  if (dtype == 1)
    gelu_exact_fwd<__nv_bfloat16><<<blocks, THREADS, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<__nv_bfloat16*>(y),
        n, c, t);
  else
    gelu_exact_fwd<float><<<blocks, THREADS, 0, st>>>(
        static_cast<const float*>(x), static_cast<float*>(y), n, c, t);
  return (int)cudaGetLastError();
}
