// 3x3 stride-1 SAME convolution, NHWC in and out, for Hopper (sm_90a).
//
// Replaces the TPU kernel opticalflowfromdepth_tpu/ops/conv2d.py:
// _conv3x3_kernel (launched by _conv3x3_s1_pallas). Same function:
//   y[b, h, w, co] = sum_{dy, dx, c} xpad[b, h + dy, w + dx, c] * w[dy, dx, c, co]
// with zero padding of one pixel, products accumulated in f32, y in x's
// dtype. The TPU kernel DMAs a haloed row band into VMEM once and adds
// nine [rows*W, C] x [C, CO] tap products.
//
// What bounds it on this card: at the backbones' widths (C = CO = 64..128)
// the 2 * B*H*W * 9C * CO operations over the bf16 tensor cores, and the
// bytes (x once, y once) about as much (RAFT's and GMFlow's first layers
// sit near the ridge of both). So each route is an implicit GEMM that
// reads x from device memory about once and keeps the nine shifted copies
// of it out of device memory, over 16 x 16 tiles of output pixels, K = 9 *
// C. ops/conv2d.py:plan picks the route and its parameters; the host
// function below takes them as given.
//
// wgmma route (bf16, C % 8 == 0, x and w 16-byte aligned): the weights are
// the wgmma's A (M = 64 output channels, a CO tile) and the pixels its B,
// so each product is m64n144k16, both operands read from shared memory.
// Persistent blocks, one an SM, each walking its share of the (CO tile,
// image, 16 x 16 tile) items in a fixed order. Per block:
// - one loading warp issues, per (item, 64-channel chunk), the haloed band
//   18 x 18 pixels x 64 channels by one 4-D TMA box that starts at (c0,
//   x0 - 1, y0 - 1, b): TMA zero-fills the padding past the image's edges
//   and the channels past C, so nothing tests an edge. A ring of two bands
//   under mbarriers keeps the next band in flight;
// - the CO tile's weights, as HWIO has them (MN-major for wgmma's A),
//   in slabs of one tap x 64 input channels x 64 output channels (8 KB,
//   128-byte swizzled): where all of C fits (C <= 64) the consumers copy
//   every slab in once (again only when the block's CO tile changes),
//   else the loading warp streams them, one TMA box a slab, through a
//   ring of 12 under mbarriers, each waited for just before its tap's
//   products. The wrapper pads w's output channels to a multiple of 8
//   where they are not (TMA and 16-byte copies need whole pieces);
// - two consumer warpgroups, 8 output rows each. A warpgroup computes its
//   rows on the band's grid, 18 positions a row (the last two of each row
//   fall past the tile and are dropped), so at tap (dy, dx) its 144
//   positions read the 144 consecutive band pixels from 18 dy + dx on: one
//   B descriptor per (tap, k16 step), starting inside the swizzle pattern
//   (desc_sw128_at). Nine taps x four k16 steps of m64n144k16 per chunk,
//   no fragments in registers, no ldmatrix. The warpgroups take turns to
//   issue them, so one's epilogue runs under the other's products;
// - epilogue: the f32 accumulators rounded to bf16 and written transposed
//   (stmatrix) into the warpgroup's own output tile in shared memory, 64
//   channels a pixel in 128-byte swizzled rows, then one TMA store of the
//   tile through a 4-D map of y, which drops what falls past its edges
//   (where CO % 8 == 0; else element by element, masked).
// The summation order of each output is fixed (chunk, tap, k step), so two
// launches give the same bits.
//
// mma_sync route (bf16 inputs the wgmma route does not take: C % 8 != 0,
// pointers off the 16-byte grid): one block of 8 warps per (16 x 16 pixel
// tile, 64 output channels, image).
// Per chunk of 32 input channels, the haloed input band (18 x 18 pixels x
// 32 channels) and the nine taps' weights ([9][32][64], as w's HWIO layout
// has them) are staged in shared memory, zero outside the image and past C
// and CO, rows padded by 8 bf16 so that the 8 rows of each ldmatrix phase
// hit distinct banks. Each warp owns two rows of 16 output pixels (two m16
// fragments) and all 64 output channels, and runs mma.sync m16n8k16 (bf16
// in, f32 accumulate) over the nine taps: a tap is only an offset into the
// staged band, so the A fragments are read straight from it (ldmatrix),
// and the B fragments from the weights' K rows (ldmatrix.trans). Global
// loads are 16-byte vectors of 8 channels where C (for x) or CO (for w) is
// a multiple of 8, else element by element; the K steps past C are
// skipped. Loads and products do not overlap.
//
// f32 (f32 models, parity runs): the same band and tap structure on the
// CUDA cores, no TF32: 16-channel chunks, 32 output channels a block, each
// thread 8 pixels x 4 output channels.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <climits>
#include <stdint.h>

#include "hopper.cuh"

#define TH 16          // output rows per block
#define TW 16          // output columns per block (one m16 fragment)
#define HALO_H (TH + 2)
#define HALO_W (TW + 2)
#define CK 32          // input channels per chunk (bf16)
#define COT 64         // output channels per block (bf16)
#define NF (COT / 8)   // n8 fragments per warp
#define PAD 8          // bf16 appended to each shared row
#define CKP (CK + PAD)   // bf16 per staged pixel
#define WSTR (COT + PAD) // bf16 per staged weight row (one tap, one k)
#define WARPS 8
#define F32_CK 16      // input channels per chunk (f32)
#define F32_COT 32     // output channels per block (f32)

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8x8 bf16 matrices from shared memory; lanes 8m .. 8m+7 give the
// rows of matrix m, r[m] receives it in the mma fragment layout (.trans:
// transposed).
__device__ __forceinline__ void ldsm_x4(uint32_t* r, const bf16* p) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t* r, const bf16* p) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// The first n (<= 8, may be <= 0) of the 8 bf16 at p, zeros after them: one
// 16-byte load when all 8 are wanted and p is 16-byte aligned (vec).
__device__ __forceinline__ uint4 load8(const bf16* p, int n, bool vec) {
  if (vec && n >= 8) return *reinterpret_cast<const uint4*>(p);
  union {
    uint4 u;
    unsigned short h[8];  // the bf16 bits
  } r;
  r.u = make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
  for (int e = 0; e < 8; ++e)
    if (e < n) r.h[e] = reinterpret_cast<const unsigned short*>(p)[e];
  return r.u;
}

// x [B, H, W, C], w [3, 3, C, CO] (HWIO), y [B, H, W, CO], all bf16.
// vec_x: C % 8 == 0 and x 16-byte aligned; vec_w: CO % 8 == 0 and w
// 16-byte aligned. Grid: (tiles * n_cot, B); the CO tile is the fastest
// index, so the blocks that share a band run together.
__global__ void __launch_bounds__(WARPS * 32)
conv3x3_bf16(const bf16* __restrict__ x, const bf16* __restrict__ w,
             bf16* __restrict__ y, int H, int W, int C, int CO, int tiles_x,
             int n_cot, bool vec_x, bool vec_w) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Xs = reinterpret_cast<bf16*>(smem);          // [HALO_H*HALO_W][CKP]
  bf16* Ws = Xs + HALO_H * HALO_W * CKP;             // [9*CK][WSTR]

  const int cot = blockIdx.x % n_cot;
  const int tile = blockIdx.x / n_cot;
  const int y0 = (tile / tiles_x) * TH, x0 = (tile % tiles_x) * TW;
  const int co0 = cot * COT;
  const int b = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int lm = lane >> 3, lr = lane & 7;  // ldmatrix: matrix, row
  const bf16* xb = x + (long long)b * H * W * C;

  float acc[2][NF][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < NF; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  for (int c0 = 0; c0 < C; c0 += CK) {
    __syncthreads();  // the previous chunk is consumed
    // the haloed band, 8 channels at a time, zero outside the image and C
    for (int i = threadIdx.x; i < HALO_H * HALO_W * (CK / 8);
         i += WARPS * 32) {
      const int pix = i / (CK / 8), v = i - pix * (CK / 8);
      const int gy = y0 - 1 + pix / HALO_W, gx = x0 - 1 + pix % HALO_W;
      const int c = c0 + v * 8;
      const bool in = gy >= 0 && gy < H && gx >= 0 && gx < W;
      *reinterpret_cast<uint4*>(Xs + pix * CKP + v * 8) =
          load8(xb + ((long long)gy * W + gx) * C + c, in ? C - c : 0,
                vec_x);
    }
    // the nine taps' weights of this chunk and CO tile, Ws[tap * CK + k]
    // [n] = w[tap][c0 + k][co0 + n], 8 output channels at a time, zero past
    // C and CO
    for (int i = threadIdx.x; i < 9 * CK * (COT / 8); i += WARPS * 32) {
      const int n8 = i % (COT / 8), r = i / (COT / 8);
      const int k = r % CK, tap = r / CK;
      const int co = co0 + n8 * 8;
      *reinterpret_cast<uint4*>(Ws + r * WSTR + n8 * 8) =
          load8(w + ((long long)tap * C + c0 + k) * CO + co,
                c0 + k < C ? CO - co : 0, vec_w);
    }
    __syncthreads();

    const int ksteps = min(CK, (C - c0 + 15) & ~15) / 16;  // past C: zeros
#pragma unroll 1
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3, dx = tap % 3;
      for (int kk = 0; kk < ksteps; ++kk) {
        // B of two n8 fragments per ldmatrix.x4.trans: matrices (k 0-7,
        // n 0-7), (k 8-15, n 0-7), (k 0-7, n 8-15), (k 8-15, n 8-15)
        uint32_t bw[NF][2];
#pragma unroll
        for (int jj = 0; jj < NF / 2; ++jj)
          ldsm_x4_trans(&bw[2 * jj][0],
                        Ws + (tap * CK + kk * 16 + (lm & 1) * 8 + lr) * WSTR +
                            jj * 16 + (lm >> 1) * 8);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          // output row warp*2+i of the tile: its 16 pixels read the band at
          // row (that + dy) from column dx. A: matrices (pixels 0-7, k
          // 0-7), (8-15, 0-7), (0-7, 8-15), (8-15, 8-15)
          uint32_t a[4];
          ldsm_x4(a, Xs + ((warp * 2 + i + dy) * HALO_W + (lm & 1) * 8 + lr +
                           dx) * CKP + kk * 16 + (lm >> 1) * 8);
#pragma unroll
          for (int j = 0; j < NF; ++j) mma_bf16(acc[i][j], a, bw[j][0],
                                                bw[j][1]);
        }
      }
    }
  }

  // c0, c1: pixel g, channels 2t, 2t+1; c2, c3: pixel g + 8
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int gy = y0 + warp * 2 + i;
    if (gy >= H) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int gx = x0 + g + 8 * h;
      if (gx >= W) continue;
      bf16* yrow = y + (((long long)b * H + gy) * W + gx) * CO;
#pragma unroll
      for (int j = 0; j < NF; ++j) {
        const int co = co0 + j * 8 + 2 * t;
        const float v0 = acc[i][j][2 * h], v1 = acc[i][j][2 * h + 1];
        if (co + 1 < CO && (CO & 1) == 0) {
          *reinterpret_cast<__nv_bfloat162*>(yrow + co) =
              __floats2bfloat162_rn(v0, v1);
        } else {
          if (co < CO) yrow[co] = __float2bfloat16(v0);
          if (co + 1 < CO) yrow[co + 1] = __float2bfloat16(v1);
        }
      }
    }
  }
}

// x [B, H, W, C], w [3, 3, C, CO] (HWIO), y [B, H, W, CO], all f32. 256
// threads: thread (ty, tx) owns pixels ty*8 .. ty*8+7 of the 16 x 16 tile
// (half a row) and output channels tx*4 .. tx*4+3 of the CO tile.
__global__ void __launch_bounds__(256)
conv3x3_f32(const float* __restrict__ x, const float* __restrict__ w,
            float* __restrict__ y, int H, int W, int C, int CO, int tiles_x,
            int n_cot) {
  __shared__ float Xs[HALO_H * HALO_W][F32_CK + 1];
  __shared__ __align__(16) float Ws[9][F32_CK][F32_COT];

  const int cot = blockIdx.x % n_cot;
  const int tile = blockIdx.x / n_cot;
  const int y0 = (tile / tiles_x) * TH, x0 = (tile % tiles_x) * TW;
  const int co0 = cot * F32_COT;
  const int b = blockIdx.y;
  const int tx = threadIdx.x & 7, ty = threadIdx.x >> 3;
  const int prow = ty >> 1, pcol = (ty & 1) * 8;  // first of 8 pixels
  const float* xb = x + (long long)b * H * W * C;

  float acc[8][4];
#pragma unroll
  for (int p = 0; p < 8; ++p)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[p][j] = 0.f;

  for (int c0 = 0; c0 < C; c0 += F32_CK) {
    __syncthreads();
    for (int i = threadIdx.x; i < HALO_H * HALO_W * F32_CK; i += 256) {
      const int pix = i / F32_CK, c = i - pix * F32_CK;
      const int gy = y0 - 1 + pix / HALO_W, gx = x0 - 1 + pix % HALO_W;
      float val = 0.f;
      if (gy >= 0 && gy < H && gx >= 0 && gx < W && c0 + c < C)
        val = xb[((long long)gy * W + gx) * C + c0 + c];
      Xs[pix][c] = val;
    }
    for (int i = threadIdx.x; i < 9 * F32_CK * F32_COT; i += 256) {
      const int n = i % F32_COT, r = i / F32_COT;
      const int c = r % F32_CK, tap = r / F32_CK;
      Ws[tap][c][n] = c0 + c < C && co0 + n < CO
                          ? w[((long long)tap * C + c0 + c) * CO + co0 + n]
                          : 0.f;
    }
    __syncthreads();

#pragma unroll 1
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3, dx = tap % 3;
      for (int c = 0; c < F32_CK; ++c) {
        const float4 wv = *reinterpret_cast<const float4*>(&Ws[tap][c][tx * 4]);
#pragma unroll
        for (int p = 0; p < 8; ++p) {
          const float a = Xs[(prow + dy) * HALO_W + pcol + p + dx][c];
          acc[p][0] = fmaf(a, wv.x, acc[p][0]);
          acc[p][1] = fmaf(a, wv.y, acc[p][1]);
          acc[p][2] = fmaf(a, wv.z, acc[p][2]);
          acc[p][3] = fmaf(a, wv.w, acc[p][3]);
        }
      }
    }
  }

  const int gy = y0 + prow;
  if (gy >= H) return;
#pragma unroll
  for (int p = 0; p < 8; ++p) {
    const int gx = x0 + pcol + p;
    if (gx >= W) continue;
    float* yrow = y + (((long long)b * H + gy) * W + gx) * CO;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int co = co0 + tx * 4 + j;
      if (co < CO) yrow[co] = acc[p][j];
    }
  }
}

// ---------------------------------------------------------------------------
// bf16, C % 8 == 0, x and w 16-byte aligned: the wgmma route
// ---------------------------------------------------------------------------

namespace conv_sm90 {

using namespace hopper;

constexpr int TILE = 16;                  // output tile, TILE x TILE pixels
constexpr int BAND = TILE + 2;            // the haloed band, BAND x BAND
constexpr int CB = 64;                    // channels per band box: 128 bytes
constexpr int BAND_BYTES = BAND * BAND * CB * 2;               // 41,472
constexpr int STAGE_BYTES = (BAND_BYTES + 1023) & ~1023;       // 41,984
constexpr int STAGES = 2;
constexpr int M = 64;                     // output channels a CO tile
constexpr int SLAB_BYTES = M * CB * 2;    // one tap's weights of a chunk
constexpr int NW = 144;                   // positions a warpgroup: 8 x 18
constexpr int OUT_BYTES = NW * M * 2;     // a warpgroup's output, 18 KB
constexpr int SLABS = 12;                 // the ring of streamed slabs
constexpr int CONSUMERS = 256;            // two warpgroups
constexpr int THREADS = CONSUMERS + 32;   // and the loading warp

// Shared memory of a block (ops/conv2d.py:plan repeats it): the slack to
// align to 1 KB, the ring of bands, the weights (resident: nine taps x
// every chunk's slabs; streamed: a ring of SLABS slabs), the two
// warpgroups' output tiles, the rings' barriers.
constexpr size_t smem_bytes(bool resident, int nch) {
  const int slabs = resident ? 9 * nch : SLABS;
  return 1024 + (size_t)STAGES * STAGE_BYTES + (size_t)slabs * SLAB_BYTES +
         2 * OUT_BYTES + 2 * (STAGES + (resident ? 0 : SLABS)) *
                             sizeof(uint64_t);
}

__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMERS) : "memory");
}

__device__ __forceinline__ void warpgroup_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(2 + wg) : "memory");
}

// The two warpgroups take turns to issue a chunk's products (named
// barriers 4 and 5, 256 threads: one side waits, the other arrives), so
// that the tensor cores run one's products while the other's epilogue
// writes its tile.
__device__ __forceinline__ void turn_wait(int wg) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(4 + wg) : "memory");
}

__device__ __forceinline__ void turn_pass(int wg) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(5 - wg) : "memory");
}

// One tap's products of a warpgroup: KS k16 steps of m64n144k16, A the
// tap's weight slab (MN-major), B the band from row 18 dy + dx on
// (K-major).
template <int KS>
__device__ __forceinline__ void tap_products(float (&acc)[72],
                                             const unsigned char* slab,
                                             uint32_t band, int tap) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
    wgmma_m64n144_ss_ta(
        acc, desc_sw128(slab + kk * 2048, SLAB_BYTES, 1024),
        desc_sw128_at(band + ((tap / 3) * BAND + tap % 3) * 128 + kk * 32));
}

// One chunk's products: nine taps, tap t's slab at wsl + t * wstride
// (resident), or slab sl0 + t of the ring, waited for (streamed).
template <int KS>
__device__ __forceinline__ void products(float (&acc)[72],
                                         const unsigned char* wsl,
                                         int wstride, uint64_t* sfull,
                                         int sl0, uint32_t band) {
#pragma unroll
  for (int tap = 0; tap < 9; ++tap) {
    const unsigned char* slab = wsl + tap * wstride;
    if (sfull) {
      const int sl = sl0 + tap;
      mbar_wait(&sfull[sl % SLABS], (sl / SLABS) & 1);
      slab = wsl + (sl % SLABS) * SLAB_BYTES;
    }
    tap_products<KS>(acc, slab, band, tap);
  }
}

// item -> its CO tile, image and tile origin; the CO tile varies slowest,
// so a block's items share one CO tile but for at most n_cot - 1 changes
struct Item {
  int cot, b, y0, x0;
  __device__ __forceinline__ Item(int item, int B, int tiles, int tiles_x) {
    cot = item / (B * tiles);
    const int r = item - cot * B * tiles;
    b = r / tiles;
    const int t = r - b * tiles;
    y0 = (t / tiles_x) * TILE;
    x0 = (t % tiles_x) * TILE;
  }
};

// Every chunk of the CO tile [co0, co0 + 64), all nine taps, into ws as
// w's HWIO layout has them (MN-major for wgmma's A): row k of slab (tap,
// chunk) holds w[tap][64 chunk + k][co0 .. co0 + 63], its 16-byte pieces
// XORed with k & 7 (the 128-byte swizzle); zeros past C and CO. w's rows
// hold wco (a multiple of 8) channels: 16-byte copies, all in flight at
// once.
__device__ __forceinline__ void stage_weights(unsigned char* ws,
                                              const bf16* __restrict__ w,
                                              int C, int wco, int co0,
                                              int nch) {
  const int total = 9 * nch * CB * (M / 8);
#pragma unroll 8
  for (int i = threadIdx.x; i < total; i += CONSUMERS) {
    const int m8 = i % (M / 8), r = i / (M / 8);
    const int k = r % CB, slab = r / CB;
    const int tap = slab / nch, c = (slab - tap * nch) * CB + k;
    const int co = co0 + m8 * 8;
    const bool in = c < C && co < wco;
    cp_async_16(
        ws + (size_t)slab * SLAB_BYTES + k * 128 + ((m8 ^ (k & 7)) << 4),
        in ? w + ((long long)tap * C + c) * wco + co : w, in ? 16 : 0);
  }
  cp_async_wait_all();
}

// x [B, H, W, C] through tm_x (4-D, [C, W, H, B] innermost first, boxes
// [64, 18, 18, 1], 128-byte swizzled), w [3, 3, C, wco] (HWIO, wco >= CO a
// multiple of 8; through tm_w, [wco, C, 9] in [64, 64, 1] boxes, where
// streamed), y [B, H, W, CO] (through tm_y, [CO, W, H, B] in [64, 16, 8,
// 1] boxes, where CO % 8 == 0), all bf16. items = n_cot * B * tiles;
// block k takes items k, k + gridDim.x, ... resident: every chunk's
// weights stay in shared memory (C <= 64), else the loading warp streams
// them a (tap, chunk) slab at a time through a ring of SLABS.
__global__ void __launch_bounds__(THREADS, 1)
conv3x3_wgmma(const __grid_constant__ CUtensorMap tm_x,
              const __grid_constant__ CUtensorMap tm_w,
              const __grid_constant__ CUtensorMap tm_y,
              const bf16* __restrict__ w, bf16* __restrict__ y, int B, int H,
              int W, int C, int CO, int wco, int tiles_x, int tiles,
              int items, bool resident) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* const base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);
  const int nch = (C + CB - 1) / CB;
  const int slabs = resident ? 9 * nch : SLABS;
  unsigned char* const ws = base + STAGES * STAGE_BYTES;
  unsigned char* const outs = ws + (size_t)slabs * SLAB_BYTES;
  uint64_t* const full = reinterpret_cast<uint64_t*>(outs + 2 * OUT_BYTES);
  uint64_t* const empty = full + STAGES;
  uint64_t* const sfull = resident ? nullptr : empty + STAGES;
  uint64_t* const sempty = sfull + SLABS;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);           // the loading lane arrives
      mbar_init(&empty[s], CONSUMERS);  // every consumer thread arrives
    }
    for (int s = 0; s < (resident ? 0 : SLABS); ++s) {
      mbar_init(&sfull[s], 1);
      mbar_init(&sempty[s], CONSUMERS);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int mine =
      items > (int)blockIdx.x
          ? (items - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x
          : 0;
  const int total = mine * nch;

  // the warp's index, read from lane 0 so that the compiler sees it
  // uniform across the warp: the consumers' wgmmas are then not in a
  // divergent path (ptxas would serialise them, C7520)
  const int warp_id = __shfl_sync(0xffffffffu, (int)threadIdx.x / 32, 0);
  if (warp_id >= CONSUMERS / 32) {  // the loading warp: one lane issues
    if (threadIdx.x == CONSUMERS) {
      for (int it = 0; it < total; ++it) {
        const int s = it % STAGES, cc = it % nch;
        if (it >= STAGES) mbar_wait(&empty[s], (it / STAGES - 1) & 1);
        const Item t(blockIdx.x + (it / nch) * gridDim.x, B, tiles, tiles_x);
        mbar_expect_tx(&full[s], BAND_BYTES);
        tma_load_4d(base + s * STAGE_BYTES, &tm_x, &full[s], cc * CB,
                    t.x0 - 1, t.y0 - 1, t.b);
        for (int tap = 0; tap < (resident ? 0 : 9); ++tap) {
          const int sl = it * 9 + tap, ss = sl % SLABS;
          if (sl >= SLABS) mbar_wait(&sempty[ss], (sl / SLABS - 1) & 1);
          mbar_expect_tx(&sfull[ss], SLAB_BYTES);
          tma_load_3d(ws + ss * SLAB_BYTES, &tm_w, &sfull[ss], t.cot * M,
                      cc * CB, tap);
        }
      }
    }
    return;
  }

  const int wg = warp_id >> 2, warp = warp_id & 3, tid = threadIdx.x & 127;
  const int lane = tid & 31;
  unsigned char* const out = outs + wg * OUT_BYTES;
  const bool co8 = (CO & 7) == 0;

  float acc[72];
  int cur_cot = -1, it = 0;
  if (wg == 1) turn_pass(1);  // warpgroup 0 goes first
  for (int k = 0; k < mine; ++k) {
    const Item item(blockIdx.x + k * gridDim.x, B, tiles, tiles_x);
    for (int cc = 0; cc < nch; ++cc, ++it) {
      if (resident && item.cot != cur_cot) {
        consumers_sync();  // every product that read the old weights is done
        stage_weights(ws, w, C, wco, item.cot * M, nch);
        fence_proxy_async();  // the copies, before wgmma reads them
        consumers_sync();
        cur_cot = item.cot;
      }
      if (cc == 0) {
#pragma unroll
        for (int i = 0; i < 72; ++i) acc[i] = 0.f;
      }
      const int s = it % STAGES;
      mbar_wait(&full[s], (it / STAGES) & 1);
      // positions q = 0..143 of this warpgroup (band rows 8 wg.., 18 a row,
      // the last two of each row past the tile) read band row q + 18 dy +
      // dx at tap (dy, dx): one descriptor per (tap, k16 step)
      const uint32_t band = smem_addr(base + s * STAGE_BYTES) + wg * NW * 128;
      const unsigned char* wsl = ws + (resident ? cc * SLAB_BYTES : 0);
      const int wstride = nch * SLAB_BYTES;
      const int ksteps = min(4, (C - cc * CB + 15) >> 4);  // past C: zeros
      turn_wait(wg);
      wgmma_fence();
      switch (ksteps) {
        case 1: products<1>(acc, wsl, wstride, sfull, it * 9, band); break;
        case 2: products<2>(acc, wsl, wstride, sfull, it * 9, band); break;
        case 3: products<3>(acc, wsl, wstride, sfull, it * 9, band); break;
        default: products<4>(acc, wsl, wstride, sfull, it * 9, band); break;
      }
      wgmma_commit();
      if (wg == 0 || it + 1 < total) turn_pass(wg);  // each matched by a wait
      wgmma_wait<0>();
      fence_regs(acc);
      mbar_arrive(&empty[s]);  // this thread's products read the band
      if (!resident)           // ... and the chunk's nine slabs
        for (int tap = 0; tap < 9; ++tap)
          mbar_arrive(&sempty[(it * 9 + tap) % SLABS]);
    }

    // epilogue: d[4i + 2h + e] is channel 16 warp + lane / 4 + 8h of
    // position 8i + 2 (lane % 4) + e. stmatrix writes them transposed into
    // this warpgroup's output tile [8][16][64] (the positions past the tile,
    // x = 16, 17 of each row, into 16 rows after it), 128-byte rows with the
    // 16-byte pieces XORed with the row & 7, as TMA reads a 128-byte-
    // swizzled box; then one TMA store of the box through tm_y, which drops
    // what falls outside y (where CO % 8 == 0), else 16 bytes a thread
    if (co8 && tid == 0) bulk_wait_read<0>();  // the last box is read
    warpgroup_sync(wg);  // the previous item's output tile is read
    {
      const uint32_t o = smem_addr(out);
      const int jm = lane >> 3, rr = lane & 7;
#pragma unroll
      for (int i = 0; i < 18; i += 2) {
        uint32_t r[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const __nv_bfloat162 v = __floats2bfloat162_rn(
              acc[4 * (i + (j >> 1)) + 2 * (j & 1)],
              acc[4 * (i + (j >> 1)) + 2 * (j & 1) + 1]);
          r[j] = *reinterpret_cast<const uint32_t*>(&v);
        }
        const int pos = 8 * (i + (jm >> 1)) + rr, row = pos / BAND;
        const int xq = pos - row * BAND;
        const int slot =
            xq < TILE ? row * TILE + xq : 128 + 2 * row + xq - TILE;
        const int piece = 2 * warp + (jm & 1);
        stmatrix_x4_trans(o + slot * 128 + ((piece ^ (slot & 7)) << 4), r);
      }
    }
    const int co0 = item.cot * M;
    if (co8) {
      fence_proxy_async();  // the tile, before TMA reads it
      warpgroup_sync(wg);
      if (tid == 0) {
        tma_store_4d(&tm_y, out, co0, item.x0, item.y0 + 8 * wg, item.b);
        bulk_commit();
      }
      continue;
    }
    warpgroup_sync(wg);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int idx = tid + 128 * j, px = idx >> 3, piece = idx & 7;
      const int gy = item.y0 + 8 * wg + px / TILE, gx = item.x0 + px % TILE;
      const int co = co0 + piece * 8;
      if (gy >= H || gx >= W || co >= CO) continue;
      const uint4 v = *reinterpret_cast<const uint4*>(
          out + px * 128 + ((piece ^ (px & 7)) << 4));
      bf16* dst = y + (((long long)item.b * H + gy) * W + gx) * CO + co;
      const bf16* h8 = reinterpret_cast<const bf16*>(&v);
      for (int e = 0; e < 8 && co + e < CO; ++e) dst[e] = h8[e];
    }
  }
  if (co8 && tid == 0) bulk_wait<0>();  // every box written
}

static int launch(const void* x, const void* w, void* y, int B, int H, int W,
                  int C, int CO, int wco, int grid, bool resident,
                  cudaStream_t st) {
  const int nch = (C + CB - 1) / CB;
  const size_t smem = smem_bytes(resident, nch);
  cudaError_t e = cudaFuncSetAttribute(
      conv3x3_wgmma, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int tiles_x = (W + TILE - 1) / TILE;
  const long long tiles = (long long)((H + TILE - 1) / TILE) * tiles_x;
  const long long items = (long long)((CO + M - 1) / M) * B * tiles;
  if (items > INT_MAX || grid < 1 || grid > items || wco < CO || wco % 8)
    return (int)cudaErrorInvalidValue;
  CUtensorMap tm_x, tm_w, tm_y;
  const uint64_t dims[4] = {(uint64_t)C, (uint64_t)W, (uint64_t)H,
                            (uint64_t)B};
  const uint32_t box[4] = {CB, BAND, BAND, 1};
  int r = tensor_map_bf16_4d(&tm_x, x, dims, box);
  if (r) return r;
  tm_w = tm_y = tm_x;  // not read where not used
  if (!resident && (r = tensor_map_bf16_3d(&tm_w, w, wco, C, 9, CB)))
    return r;
  if (CO % 8 == 0) {  // y by TMA where its rows are whole 16-byte pieces
    const uint64_t ydims[4] = {(uint64_t)CO, (uint64_t)W, (uint64_t)H,
                               (uint64_t)B};
    const uint32_t ybox[4] = {M, TILE, 8, 1};
    if ((r = tensor_map_bf16_4d(&tm_y, y, ydims, ybox))) return r;
  }
  conv3x3_wgmma<<<grid, THREADS, smem, st>>>(
      tm_x, tm_w, tm_y, (const bf16*)w, (bf16*)y, B, H, W, C, CO, wco,
      tiles_x, (int)tiles, (int)items, resident);
  return (int)cudaGetLastError();
}

}  // namespace conv_sm90

// x [B, H, W, C], w [3, 3, C, CO] (HWIO) and y [B, H, W, CO], contiguous,
// all bf16 or all f32, on the route ops/conv2d.py:plan chose: 0 the f32
// kernel, 1 the bf16 mma.sync kernel, 2 the bf16 wgmma kernel (w's rows
// padded to wco output channels, weights resident or streamed, `grid`
// persistent blocks). Returns cudaGetLastError() after the launch (0 on
// success), or cudaErrorInvalidValue for what the route does not take.
extern "C" int ofd_conv3x3_fwd(const void* x, const void* w, void* y, int B,
                               int H, int W, int C, int CO, int wco,
                               int route, int resident, int grid,
                               void* stream) {
  if (B < 1 || B > 65535 || H < 1 || W < 1 || C < 1 || CO < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (route == 2) {
    if (C % 8 != 0 || (uintptr_t)x % 16 != 0 || (uintptr_t)w % 16 != 0)
      return (int)cudaErrorInvalidValue;
    return conv_sm90::launch(x, w, y, B, H, W, C, CO, wco, grid,
                             resident != 0, st);
  }
  if (route != 0 && route != 1) return (int)cudaErrorInvalidValue;
  const bool is_bf16 = route == 1;
  const int tiles_x = (W + TW - 1) / TW;
  const long long tiles = (long long)((H + TH - 1) / TH) * tiles_x;
  const int n_cot = (CO + (is_bf16 ? COT : F32_COT) - 1) /
                    (is_bf16 ? COT : F32_COT);
  if (tiles * n_cot > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const dim3 grid2((unsigned)(tiles * n_cot), (unsigned)B);
  if (!is_bf16) {
    conv3x3_f32<<<grid2, 256, 0, st>>>((const float*)x, (const float*)w,
                                       (float*)y, H, W, C, CO, tiles_x, n_cot);
    return (int)cudaGetLastError();
  }
  const size_t smem =
      (size_t)(HALO_H * HALO_W * CKP + 9 * CK * WSTR) * sizeof(bf16);
  const cudaError_t e = cudaFuncSetAttribute(
      conv3x3_bf16, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const bool vec_x = C % 8 == 0 && (uintptr_t)x % 16 == 0;
  const bool vec_w = CO % 8 == 0 && (uintptr_t)w % 16 == 0;
  conv3x3_bf16<<<grid2, WARPS * 32, smem, st>>>(
      (const bf16*)x, (const bf16*)w, (bf16*)y, H, W, C, CO, tiles_x, n_cot,
      vec_x, vec_w);
  return (int)cudaGetLastError();
}
