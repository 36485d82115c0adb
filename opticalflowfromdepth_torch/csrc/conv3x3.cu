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
// sit near the ridge of both). So this is an implicit GEMM that reads x
// from device memory about once and keeps the nine shifted copies of it
// out of device memory: M is a 16 x 16 tile of output pixels, N a tile of
// output channels, K = 9 * C.
//
// bf16: one block of 8 warps per (16 x 16 pixel tile, 64 output channels,
// image). Per chunk of 32 input channels, the haloed input band (18 x 18
// pixels x 32 channels) and the nine taps' weights ([9][32][64], as w's
// HWIO layout has them) are staged in shared memory, zero outside the image
// and past C and CO, rows padded by 8 bf16 so that the 8 rows of each
// ldmatrix phase hit distinct banks. Each warp owns two rows of 16 output
// pixels (two m16 fragments) and all 64 output channels, and runs mma.sync
// m16n8k16 (bf16 in, f32 accumulate) over the nine taps: a tap is only an
// offset into the staged band, so the A fragments are read straight from
// it (ldmatrix), and the B fragments from the weights' K rows
// (ldmatrix.trans). Global loads are 16-byte vectors of 8 channels where C
// (for x) or CO (for w) is a multiple of 8, else element by element; the K
// steps past C are skipped.
//
// f32 (f32 models, parity runs): the same band and tap structure on the
// CUDA cores, no TF32: 16-channel chunks, 32 output channels a block, each
// thread 8 pixels x 4 output channels.
//
// Simple and right first: no wgmma, no TMA, no ring of stages (loads and
// products do not overlap). Later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

// x [B, H, W, C], w [3, 3, C, CO] (HWIO) and y [B, H, W, CO], contiguous,
// all bf16 or all f32. Returns cudaGetLastError() after the launch (0 on
// success).
extern "C" int ofd_conv3x3_fwd(const void* x, const void* w, void* y, int B,
                               int H, int W, int C, int CO, int is_bf16,
                               void* stream) {
  if (B < 1 || B > 65535 || H < 1 || W < 1 || C < 1 || CO < 1)
    return (int)cudaErrorInvalidValue;
  const int tiles_x = (W + TW - 1) / TW;
  const long long tiles = (long long)((H + TH - 1) / TH) * tiles_x;
  const int n_cot = (CO + (is_bf16 ? COT : F32_COT) - 1) /
                    (is_bf16 ? COT : F32_COT);
  if (tiles * n_cot > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)(tiles * n_cot), (unsigned)B);
  cudaStream_t st = (cudaStream_t)stream;
  if (!is_bf16) {
    conv3x3_f32<<<grid, 256, 0, st>>>((const float*)x, (const float*)w,
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
  conv3x3_bf16<<<grid, WARPS * 32, smem, st>>>(
      (const bf16*)x, (const bf16*)w, (bf16*)y, H, W, C, CO, tiles_x, n_cot,
      vec_x, vec_w);
  return (int)cudaGetLastError();
}
