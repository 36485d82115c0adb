// The split-TF32 ("tf32x3") pieces shared by the flash kernels' f32 routes
// at GMFlow's widths (flash.cu, the forward; flash_bwd.cu, dq and dk/dv).
//
// An f32 product a . b runs on the tensor cores as three TF32 products:
// each operand x is split in registers into hi = x rounded to TF32 (ties
// away from zero) and lo = x - hi (exact in f32; the tensor cores read its
// top 10 mantissa bits), and a . b = a_lo b_hi + a_hi b_lo + a_hi b_hi with
// mma.sync m16n8k8, accumulated in f32 (what is dropped, the lo * lo term
// and lo's low bits, is ~2^-21 of |a||b|). A warp owns 16 rows of the
// output in registers; the operands sit in shared rows of STR = 132 floats,
// so every fragment load, of a row (A . B^T) or of a column (P . B), hits
// 32 banks; tiles come in by cp.async, rows past L zero-filled. Where the
// blocks fill less than one wave, a kernel's sweep is cut into runs of
// whole tiles (tiles_per_split), each run's partial sums merged by a
// second launch in run order.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace tf32x3 {

using namespace hopper;

constexpr int W = 128;        // C, and D where D = 128
constexpr int STR = W + 4;    // floats a shared row: conflict-free fragments
constexpr int STAGES = 2;
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ void cp_async_8(void* dst, const void* src,
                                           uint32_t nbytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(nbytes)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Rows [r0, r0 + n) of a [L, 128] f32 matrix into [n][STR] shared rows;
// rows past L are zeros.
template <int T>
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          int r0, int n, int L) {
  for (int i = threadIdx.x; i < n * 32; i += T) {
    const int r = i >> 5, c = (i & 31) * 4;
    const bool ok = r0 + r < L;
    cp_async_16(dst + r * STR + c, ok ? src + (long long)(r0 + r) * W + c : src,
                ok ? 16u : 0u);
  }
}

// Rows [r0, r0 + n) of a [L, E] f32 matrix, E = 1 or 2 (lse and delta,
// the D = 2 payloads), packed; rows past L are zeros.
template <int T, int E>
__device__ __forceinline__ void load_small(float* dst, const float* src,
                                           int r0, int n, int L) {
  for (int i = threadIdx.x; i < n; i += T) {
    const bool ok = r0 + i < L;
    const float* at = ok ? src + (long long)(r0 + i) * E : src;
    if constexpr (E == 2)
      cp_async_8(dst + 2 * i, at, ok ? 8u : 0u);
    else
      cp_async_4(dst + i, at, ok ? 4u : 0u);
  }
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// x = hi + lo: hi rounded to TF32 (to nearest, ties away from zero: its
// low 13 bits cleared), lo = x - hi exactly (the tensor cores read lo's
// top 10 mantissa bits).
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a . b in split TF32, the small products first
__device__ __forceinline__ void mma3(float (&c)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], uint32_t bh0,
                                     uint32_t bh1, uint32_t bl0, uint32_t bl1) {
  mma_tf32(c, al, bh0, bh1);
  mma_tf32(c, ah, bl0, bl1);
  mma_tf32(c, ah, bh0, bh1);
}

// acc[16 x 8NT] = A . B^T over the 128 columns: a the warp's first row of
// a [.][STR] resident tile, b the first of the ring tile's 8NT rows. Per
// k8 step the A fragment holds rows g, g + 8 at columns t, t + 4 and the
// B fragment row 8n + g at the same columns.
template <int NT>
__device__ __forceinline__ void prod_rows(float (&acc)[NT][4], const float* a,
                                          const float* b, int gq, int t) {
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < W / 8; ++kk) {
    const float* ap = a + gq * STR + kk * 8 + t;
    uint32_t ah[4], al[4];
    split(ap[0], ah[0], al[0]);
    split(ap[8 * STR], ah[1], al[1]);
    split(ap[4], ah[2], al[2]);
    split(ap[8 * STR + 4], ah[3], al[3]);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const float* bp = b + (8 * n + gq) * STR + kk * 8 + t;
      uint32_t bh0, bl0, bh1, bl1;
      split(bp[0], bh0, bl0);
      split(bp[4], bh1, bl1);
      mma3(acc[n], ah, al, bh0, bh1, bl0, bl1);
    }
  }
}

// acc[16 x 128] += P . B: P[16 x 8NK] in accumulator fragments (rows g, g
// + 8; columns 8j + 2t, 2t + 1), B the ring tile's 8NK rows. Within k8
// step j the A fragment's column t is P's column 8j + 2t and t + 4 is 8j
// + 2t + 1; B's rows follow the same order.
template <int NK>
__device__ __forceinline__ void prod_pb(float (&acc)[W / 8][4],
                                        const float (&p)[NK][4],
                                        const float* b, int gq, int t) {
#pragma unroll
  for (int j = 0; j < NK; ++j) {
    uint32_t ah[4], al[4];
    split(p[j][0], ah[0], al[0]);
    split(p[j][2], ah[1], al[1]);
    split(p[j][1], ah[2], al[2]);
    split(p[j][3], ah[3], al[3]);
    const float* bp = b + (8 * j + 2 * t) * STR + gq;
#pragma unroll
    for (int n = 0; n < W / 8; ++n) {
      uint32_t bh0, bl0, bh1, bl1;
      split(bp[8 * n], bh0, bl0);
      split(bp[STR + 8 * n], bh1, bl1);
      mma3(acc[n], ah, al, bh0, bh1, bl0, bl1);
    }
  }
}

// rows row0 and row0 + 8 of a [16 x 128] accumulator, times mult, into a
// [., 128] f32 matrix at `out` (rows at or past L skipped)
__device__ __forceinline__ void store_rows(float* out,
                                           const float (&acc)[W / 8][4],
                                           int row0, int L, int t,
                                           float mult) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row0 + 8 * r >= L) continue;
    float* o = out + (long long)(row0 + 8 * r) * W + 2 * t;
#pragma unroll
    for (int n = 0; n < W / 8; ++n)
      *reinterpret_cast<float2*>(o + 8 * n) =
          make_float2(acc[n][2 * r] * mult, acc[n][2 * r + 1] * mult);
  }
}

// The widths this route takes: C = 128 and D = 128 or 2, B * L within
// int32 rows.
static bool takes(int B, int Lq, int Lk, int C, int D) {
  return C == 128 && (D == 128 || D == 2) &&
         (long long)B * (Lq > Lk ? Lq : Lk) < (1ll << 31);
}

// The sweep of `L_other` rows cut into `splits` runs of whole tiles: the
// tiles a split takes, or 0 if `splits` is not the number of runs that
// length gives (the caller's plan and this route disagree).
static int tiles_per_split(int L_other, int tile, int splits) {
  const int all = (L_other + tile - 1) / tile;
  if (splits < 1 || splits > all) return 0;
  const int per = (all + splits - 1) / splits;
  return (all + per - 1) / per == splits ? per : 0;
}

}  // namespace tf32x3
