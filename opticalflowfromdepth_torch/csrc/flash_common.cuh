// Pieces shared by the flash kernels of this directory (flash.cu, the
// forward; flash_bwd.cu, the backward): the routes' codes, the analytic
// Swin mask, the mma.sync helpers of the narrow-width routes, and, in
// namespace sm90, the tile products, fragment conversions and warpgroup
// turns of the wgmma routes (C = 128; 64-row tiles of two
// 128-byte-swizzled 64-column panels, as hopper.cuh's tensor maps lay
// them out).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

#ifndef NEG_INF
#define NEG_INF (-1e30f)
#endif

typedef __nv_bfloat16 bf16;

// The routes of the flash kernels, as ops/flash.py:ROUTES names them.
enum Route { F32 = 0, TF32X3 = 1, MMA_SYNC = 2, WGMMA = 3 };

struct Swin {
  int k, wh, ww, sh, sw;  // k == 0: no mask
};

// (y region, x region) of a token of window (last_y, last_x)
__device__ __forceinline__ int swin_region(const Swin& s, bool last_y,
                                           bool last_x, int idx) {
  const bool y = last_y && (idx / s.ww >= s.wh - s.sh);
  const bool x = last_x && (idx % s.ww >= s.ww - s.sw);
  return (int)y * 2 + (int)x;
}

// The window of batch entry b: whether it is in the last window row /
// column; only such windows hold more than one region.
__device__ __forceinline__ bool swin_window(const Swin& s, int b, bool* ly,
                                            bool* lx) {
  *ly = *lx = false;
  if (!s.k) return false;
  const int win = b % (s.k * s.k);
  *ly = win / s.k == s.k - 1;
  *lx = win % s.k == s.k - 1;
  return *ly || *lx;
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats -> bf16x2 (round to nearest even), `lo` in the low half
__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_bf16(bf16 lo, bf16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) |
         ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

__device__ __forceinline__ uint32_t load_u32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// The dense bias of columns c and c + 1 of one query row (0 past Lk): one
// 8-byte load where Lk is even (every row then starts 8-byte aligned, the
// wrapper aligning the base to 16 bytes), two 4-byte loads where it is
// odd. In the mma fragments a lane holds columns 8j + 2t and 8j + 2t + 1,
// so a quad reads 32 bytes of a row: whole sectors.
__device__ __forceinline__ float2 bias_pair(const float* __restrict__ row,
                                            int c, int Lk) {
  if ((Lk & 1) == 0)
    return c < Lk ? __ldg(reinterpret_cast<const float2*>(row + c))
                  : make_float2(0.f, 0.f);
  return make_float2(c < Lk ? __ldg(row + c) : 0.f,
                     c + 1 < Lk ? __ldg(row + c + 1) : 0.f);
}

// The running max a row's exponentials are taken against: m itself, or 0
// while the row has met no finite score (m = -inf, every score so far
// -inf), so that exp(x - m) never meets (-inf) - (-inf). The running max
// starts at -inf and the key padding is -inf, so a row that a bias masks
// whole (-1e30 on every key, -1.44e30 once folded into base 2) still has
// its own max and gives the mean of v over the real keys.
__device__ __forceinline__ float max_offset(float m) {
  return m == -INFINITY ? 0.f : m;
}

namespace sm90 {

using namespace hopper;

constexpr int TILE = 64;                  // rows per warpgroup and ring tile
constexpr int PANEL = 64 * 64;            // bf16 of a [64 rows][64] panel
constexpr uint32_t PANEL_BYTES = PANEL * 2;

// acc[64 x 64] = A . B^T over C = 128 (eight k16 steps): A the warpgroup's
// resident [64][128] rows at `a`, B the ring's [64][128] rows at `b`, both
// K-major. Within a 128-byte swizzle atom a k16 step is 32 bytes on.
__device__ __forceinline__ void product_c128(float (&acc)[32], const bf16* a,
                                             const bf16* b) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    const int off = (kk >> 2) * PANEL + (kk & 3) * 16;
    wgmma_m64n64_ss(acc, desc_sw128(a + off, 16, 1024),
                    desc_sw128(b + off, 16, 1024), kk > 0);
  }
}

// acc[64 x 128] += F . B: F the bf16 A fragments of a [64][64] tile (four
// k16 steps), B the ring's [64][128] rows read MN-major, 16 rows a step.
__device__ __forceinline__ void product_rs(float (&acc)[64],
                                           const uint32_t (&f)[16],
                                           const bf16* b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_m64n128_rs_tb(acc, &f[4 * kk],
                        desc_sw128(b + kk * 16 * 64, PANEL_BYTES, 1024));
}

// Columns 16kk..16kk+15 of a 64-column accumulator (d[4j + e]: row g + 8
// (e >> 1), column 8j + 2t + (e & 1)) rounded to bf16 as the A fragment of
// k16 step kk.
__device__ __forceinline__ void to_a_frag(const float (&d)[32],
                                          uint32_t (&f)[16], int kk) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
    f[4 * kk + i] = pack_f32(d[8 * kk + 2 * i], d[8 * kk + 2 * i + 1]);
}

// The 2-bit Swin regions of the 16 columns c0 + 8j + 2t + e (j < 8, e < 2)
// of a 64-column accumulator, bit pair 2j + e; idx % ww carried along
// instead of divided per column.
__device__ __forceinline__ uint32_t col_regions(const Swin& s, bool last_y,
                                                bool last_x, int c0, int t) {
  const int ylim = (s.wh - s.sh) * s.ww, xlim = s.ww - s.sw;
  int m = (c0 + 2 * t) % s.ww;
  uint32_t regs = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      int mx = m + e;
      if (mx >= s.ww) mx -= s.ww;
      const uint32_t r = (uint32_t)(last_y && c0 + 8 * j + 2 * t + e >= ylim)
                             * 2u + (uint32_t)(last_x && mx >= xlim);
      regs |= r << (2 * (2 * j + e));
    }
    m += 8;
    while (m >= s.ww) m -= s.ww;
  }
  return regs;
}

// Two warpgroups (a block of 256 threads) take turns to issue a tile's first products (named
// barriers 1 and 2, 256 threads: one side waits, the other arrives), so
// that one's exponentials run while the other's products do.
__device__ __forceinline__ void turn_wait(int wg) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + wg), "n"(256) : "memory");
}

__device__ __forceinline__ void turn_pass(int wg) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(2 - wg), "n"(256)
               : "memory");
}

__device__ __forceinline__ bool other_region(uint32_t cregs, int j, int e,
                                             int row_region) {
  return ((cregs >> (2 * (2 * j + (e & 1)))) & 3u) != (uint32_t)row_region;
}

}  // namespace sm90
