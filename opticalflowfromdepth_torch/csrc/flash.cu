// Flash (streaming-softmax) attention forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel opticalflowfromdepth_tpu/ops/flash.py:
// _flash_kernel (launched by _flash_forward). Same function:
//   out = softmax(q . k^T * scale [- 100 across Swin regions]
//                 [key padding -1e30]) . v,
// q [B, Lq, C], k [B, Lk, C], v [B, Lk, D], out [B, Lq, D] f32, with an
// online softmax over key tiles (running max from -1e30, running
// denominator, f32 accumulator), the output divided by max(l, 1e-30) and
// optionally lse = m + log(max(l, 1e-30)) [B, Lq] f32.
//
// The Swin shifted-window mask is computed from the global query and key
// indices, as the TPU kernel does: the window id is the batch index mod
// K^2 (batches ordered [b, wy, wx]); only the last window row / column
// holds a wrap, at in-window row wh - sh / column ww - sw; a query and a
// key in different regions get -100. Each key tile's regions are computed
// once into shared memory, and windows with a single region skip it.
//
// What bounds it on this card: at GMFlow's shapes (C = 128) the two
// products, 2 * B * Lq * Lk * (C + D) operations, over the bf16 tensor
// cores, and the B * Lq * Lk exponentials over the special-function
// units; the bytes (q, k, v once, out once) are ~1000x less. So the
// design keeps the [Lq, Lk] scores out of device memory entirely and
// feeds the tensor cores:
//
// bf16 operands (the serving path): one block of 4 warps per (batch
// entry, 64-query tile); each warp owns 16 query rows, whose Q fragments
// stay in registers for the whole key sweep. Per 64-key tile, K (and V)
// are staged in shared memory (rows padded by 8 bf16, so the fragment
// loads hit 32 distinct banks); S = Q K^T with mma.sync m16n8k16 (bf16 in,
// f32 accumulate); the scale, the Swin mask and the key padding; the
// running max and denominator per row, reduced over the 4 lanes that share
// a row with shuffles. As in the TPU kernel the unnormalized P is rounded
// to bf16 before P . V (and the denominator sums the unrounded P).
//   D % 16 == 0: P . V on the tensor cores too; S's accumulator fragments
//     are P's A fragments, so P never leaves registers.
//   D == 2 (the matching grid and the propagated flow): P . V on the CUDA
//     cores in f32, each lane summing its own keys, reduced over the quad
//     at the end (the tensor-core path would waste 63/64 of its work on
//     the padding of D to 128, as the TPU kernel pads its lanes).
//   Every load is bounds-checked, so Lq and Lk need no padding copy.
//
// f32 operands (f32 models, the card-vs-CPU parity runs): f32 FMA on the
// CUDA cores, no TF32: one thread per query row (64 a block), the query
// tile and the row accumulators in shared memory, K and V in 32-key tiles
// read by every thread at the same address (broadcast).
//
// Not ported: the TPU kernel's optional dense `bias` operand (no caller
// passes one).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define NEG_INF (-1e30f)
#define BQ 64         // query rows per block (bf16 path)
#define BK 64         // keys per tile (bf16 path)
#define WARPS 4
#define PAD 8         // bf16 elements appended to each shared row
#define F32_BQ 64     // query rows (= threads) per block (f32 path)
#define F32_BK 32     // keys per tile (f32 path)

typedef __nv_bfloat16 bf16;

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

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats -> bf16x2, `lo` in the low half (the lower column index)
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

// Copy rows [r0, r0 + BK) of a [L, W] bf16 matrix into a [BK, W + PAD]
// shared tile with 16-byte vectors; rows >= L are zero.
__device__ __forceinline__ void stage_rows(bf16* dst, const bf16* src,
                                           int r0, int L, int W) {
  const int vecs = W / 8;
  const int stride = W + PAD;
  for (int i = threadIdx.x; i < BK * vecs; i += WARPS * 32) {
    const int r = i / vecs, c = (i - r * vecs) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < L)
      val = *reinterpret_cast<const uint4*>(src + (long long)(r0 + r) * W + c);
    *reinterpret_cast<uint4*>(dst + r * stride + c) = val;
  }
}

template <int CMAX, int DMAX, bool PAYLOAD2>
__global__ void __launch_bounds__(WARPS * 32)
flash_fwd_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, float* __restrict__ out,
               float* __restrict__ lse, int Lq, int Lk, int C, int D,
               float scale, Swin sw) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);                 // [BK][C + PAD]
  bf16* Vs = Ks + BK * (C + PAD);                           // [BK][D + PAD]
  float2* V2 = reinterpret_cast<float2*>(Vs);               // [BK] (D == 2)
  __shared__ int kreg_s[BK];          // Swin region of each key of the tile
  const int cs = C + PAD, ds = D + PAD;

  const int b = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int rows[2] = {blockIdx.x * BQ + warp * 16 + g,
                       blockIdx.x * BQ + warp * 16 + g + 8};
  const bf16* qb = q + (long long)b * Lq * C;
  const bf16* kb = k + (long long)b * Lk * C;
  const bf16* vb = v + (long long)b * Lk * D;

  // the Swin window of this batch entry and the region of each own row;
  // only windows in the last row or column hold more than one region
  bool last_y = false, last_x = false;
  int qreg[2] = {0, 0};
  if (sw.k) {
    const int win = b % (sw.k * sw.k);
    last_y = win / sw.k == sw.k - 1;
    last_x = win % sw.k == sw.k - 1;
    qreg[0] = swin_region(sw, last_y, last_x, rows[0]);
    qreg[1] = swin_region(sw, last_y, last_x, rows[1]);
  }
  const bool masked = sw.k && (last_y || last_x);

  // Q's A fragments (16 rows x 16 channels per k-step), kept for the sweep
  constexpr int KSTEPS = CMAX / 16;
  uint32_t qa[KSTEPS][4];
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk) {
#pragma unroll
    for (int i = 0; i < 4; ++i) qa[kk][i] = 0u;
    if (kk * 16 < C) {
      const int c = kk * 16 + 2 * t;
      if (rows[0] < Lq) {
        const bf16* p = qb + (long long)rows[0] * C + c;
        qa[kk][0] = load_u32(p);
        qa[kk][2] = load_u32(p + 8);
      }
      if (rows[1] < Lq) {
        const bf16* p = qb + (long long)rows[1] * C + c;
        qa[kk][1] = load_u32(p);
        qa[kk][3] = load_u32(p + 8);
      }
    }
  }

  constexpr int DTILES = PAYLOAD2 ? 1 : DMAX / 8;
  float o[DTILES][4];
#pragma unroll
  for (int i = 0; i < DTILES; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[i][e] = 0.f;
  float m[2] = {NEG_INF, NEG_INF};
  float l[2] = {0.f, 0.f};  // this lane's share of each row's denominator

  for (int k0 = 0; k0 < Lk; k0 += BK) {
    __syncthreads();  // the previous tile is consumed
    stage_rows(Ks, kb, k0, Lk, C);
    if (PAYLOAD2) {
      for (int r = threadIdx.x; r < BK; r += WARPS * 32) {
        float2 val = make_float2(0.f, 0.f);
        if (k0 + r < Lk) {
          const __nv_bfloat162 x =
              *reinterpret_cast<const __nv_bfloat162*>(vb + (k0 + r) * 2LL);
          val = __bfloat1622float2(x);
        }
        V2[r] = val;
      }
    } else {
      stage_rows(Vs, vb, k0, Lk, D);
    }
    if (masked)
      for (int r = threadIdx.x; r < BK; r += WARPS * 32)
        kreg_s[r] = swin_region(sw, last_y, last_x, k0 + r);
    __syncthreads();

    // S = Q K^T: 16 rows x 64 keys per warp, 8 n-tiles of 8 keys
    float s[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
      if (kk * 16 < C) {
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          const bf16* kr = Ks + (nt * 8 + g) * cs + kk * 16 + 2 * t;
          mma_bf16(s[nt], qa[kk], load_u32(kr), load_u32(kr + 8));
        }
      }
    }

    // scale, Swin mask, key padding; the tile's max per row
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kl = nt * 8 + 2 * t + (e & 1);
        float x = s[nt][e] * scale;
        if (masked && kreg_s[kl] != qreg[e >> 1]) x = x - 100.f;
        if (k0 + kl >= Lk) x = NEG_INF;
        s[nt][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float mn = fmaxf(m[r], mx[r]);
      alpha[r] = expf(m[r] - mn);
      m[r] = mn;
    }
    float ls[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(s[nt][e] - m[e >> 1]);
        s[nt][e] = p;
        ls[e >> 1] += p;
      }
    }
    l[0] = l[0] * alpha[0] + ls[0];
    l[1] = l[1] * alpha[1] + ls[1];
#pragma unroll
    for (int i = 0; i < DTILES; ++i) {
      o[i][0] *= alpha[0];
      o[i][1] *= alpha[0];
      o[i][2] *= alpha[1];
      o[i][3] *= alpha[1];
    }

    if (PAYLOAD2) {
      // o[0] = {row0 d0, row0 d1, row1 d0, row1 d1}, this lane's keys only
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float pb = __bfloat162float(__float2bfloat16(s[nt][e]));
          const float2 vv = V2[nt * 8 + 2 * t + (e & 1)];
          const int r = e >> 1;
          o[0][2 * r] = fmaf(pb, vv.x, o[0][2 * r]);
          o[0][2 * r + 1] = fmaf(pb, vv.y, o[0][2 * r + 1]);
        }
      }
    } else {
      // P . V on the tensor cores: S's fragments are P's A fragments
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        const uint32_t a[4] = {pack_f32(s[2 * ks][0], s[2 * ks][1]),
                               pack_f32(s[2 * ks][2], s[2 * ks][3]),
                               pack_f32(s[2 * ks + 1][0], s[2 * ks + 1][1]),
                               pack_f32(s[2 * ks + 1][2], s[2 * ks + 1][3])};
        const bf16* vr = Vs + (ks * 16 + 2 * t) * ds + g;
#pragma unroll
        for (int dt = 0; dt < DTILES; ++dt) {
          if (dt * 8 < D) {
            const bf16* p = vr + dt * 8;
            mma_bf16(o[dt], a, pack_bf16(p[0], p[ds]),
                     pack_bf16(p[8 * ds], p[9 * ds]));
          }
        }
      }
    }
  }

  // the denominators (and the D == 2 sums) over the quad
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  const float den[2] = {fmaxf(l[0], 1e-30f), fmaxf(l[1], 1e-30f)};
  float* ob = out + (long long)b * Lq * D;
  if (PAYLOAD2) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      o[0][e] += __shfl_xor_sync(0xffffffffu, o[0][e], 1);
      o[0][e] += __shfl_xor_sync(0xffffffffu, o[0][e], 2);
    }
    if (t == 0) {
#pragma unroll
      for (int r = 0; r < 2; ++r)
        if (rows[r] < Lq)
          *reinterpret_cast<float2*>(ob + (long long)rows[r] * 2) =
              make_float2(o[0][2 * r] / den[r], o[0][2 * r + 1] / den[r]);
    }
  } else {
#pragma unroll
    for (int dt = 0; dt < DTILES; ++dt) {
      if (dt * 8 < D) {
#pragma unroll
        for (int r = 0; r < 2; ++r)
          if (rows[r] < Lq)
            *reinterpret_cast<float2*>(ob + (long long)rows[r] * D + dt * 8 +
                                       2 * t) =
                make_float2(o[dt][2 * r] / den[r], o[dt][2 * r + 1] / den[r]);
      }
    }
  }
  if (lse != nullptr && t == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r)
      if (rows[r] < Lq)
        lse[(long long)b * Lq + rows[r]] = m[r] + logf(den[r]);
  }
}

__global__ void __launch_bounds__(F32_BQ)
flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ out,
              float* __restrict__ lse, int Lq, int Lk, int C, int D,
              float scale, Swin sw) {
  extern __shared__ __align__(16) float fsm[];
  __shared__ int kreg_s[F32_BK];      // Swin region of each key of the tile
  float* Qs = fsm;                           // [F32_BQ][C + 1]
  float* Ks = Qs + F32_BQ * (C + 1);         // [F32_BK][C]
  float* Vs = Ks + F32_BK * C;               // [F32_BK][D]
  float* As = Vs + F32_BK * D;               // [F32_BQ][D + 1] accumulators
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * F32_BQ;
  const int row = q0 + tid;
  const float* qb = q + (long long)b * Lq * C;
  const float* kb = k + (long long)b * Lk * C;
  const float* vb = v + (long long)b * Lk * D;

  for (int i = tid; i < F32_BQ * C; i += F32_BQ) {
    const int r = i / C, c = i - r * C;
    Qs[r * (C + 1) + c] = q0 + r < Lq ? qb[(long long)(q0 + r) * C + c] : 0.f;
  }
  float* acc = As + tid * (D + 1);
  for (int d = 0; d < D; ++d) acc[d] = 0.f;
  const float* qr = Qs + tid * (C + 1);

  bool last_y = false, last_x = false;
  int qreg = 0;
  if (sw.k) {
    const int win = b % (sw.k * sw.k);
    last_y = win / sw.k == sw.k - 1;
    last_x = win % sw.k == sw.k - 1;
    qreg = swin_region(sw, last_y, last_x, row);
  }
  const bool masked = sw.k && (last_y || last_x);
  float m = NEG_INF, l = 0.f;

  for (int k0 = 0; k0 < Lk; k0 += F32_BK) {
    __syncthreads();
    for (int i = tid; i < F32_BK * C; i += F32_BQ) {
      const int r = i / C;
      Ks[i] = k0 + r < Lk ? kb[(long long)k0 * C + i] : 0.f;
    }
    for (int i = tid; i < F32_BK * D; i += F32_BQ) {
      const int r = i / D;
      Vs[i] = k0 + r < Lk ? vb[(long long)k0 * D + i] : 0.f;
    }
    if (masked && tid < F32_BK)
      kreg_s[tid] = swin_region(sw, last_y, last_x, k0 + tid);
    __syncthreads();

    float s[F32_BK];
#pragma unroll
    for (int j = 0; j < F32_BK; ++j) s[j] = 0.f;
    for (int c = 0; c < C; ++c) {
      const float qv = qr[c];
#pragma unroll
      for (int j = 0; j < F32_BK; ++j) s[j] = fmaf(qv, Ks[j * C + c], s[j]);
    }
    float mx = NEG_INF;
#pragma unroll
    for (int j = 0; j < F32_BK; ++j) {
      const int kj = k0 + j;
      float x = s[j] * scale;
      if (masked && kreg_s[j] != qreg) x = x - 100.f;
      if (kj >= Lk) x = NEG_INF;
      s[j] = x;
      mx = fmaxf(mx, x);
    }
    const float mn = fmaxf(m, mx);
    const float alpha = expf(m - mn);
    m = mn;
    float ls = 0.f;
#pragma unroll
    for (int j = 0; j < F32_BK; ++j) {
      s[j] = expf(s[j] - mn);
      ls += s[j];
    }
    l = l * alpha + ls;
    for (int d = 0; d < D; ++d) {
      float a = acc[d] * alpha;
#pragma unroll
      for (int j = 0; j < F32_BK; ++j) a = fmaf(s[j], Vs[j * D + d], a);
      acc[d] = a;
    }
  }

  if (row < Lq) {
    const float den = fmaxf(l, 1e-30f);
    float* orow = out + ((long long)b * Lq + row) * D;
    for (int d = 0; d < D; ++d) orow[d] = acc[d] / den;
    if (lse != nullptr) lse[(long long)b * Lq + row] = m + logf(den);
  }
}

template <int CMAX, int DMAX, bool PAYLOAD2>
static int launch_bf16(const void* q, const void* k, const void* v, void* out,
                       void* lse, int B, int Lq, int Lk, int C, int D,
                       float scale, Swin sw, cudaStream_t st) {
  auto kern = flash_fwd_bf16<CMAX, DMAX, PAYLOAD2>;
  const size_t smem = (size_t)BK * (C + PAD) * sizeof(bf16) +
                      (PAYLOAD2 ? BK * sizeof(float2)
                                : (size_t)BK * (D + PAD) * sizeof(bf16));
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((unsigned)((Lq + BQ - 1) / BQ), (unsigned)B);
  kern<<<grid, WARPS * 32, smem, st>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (float*)out,
      (float*)lse, Lq, Lk, C, D, scale, sw);
  return (int)cudaGetLastError();
}

// q [B, Lq, C], k [B, Lk, C], v [B, Lk, D], all bf16 or all f32,
// contiguous, 16-byte aligned; out [B, Lq, D] f32; lse [B, Lq] f32 or null.
// swin_k = 0: no Swin mask; else (swin_k, wh, ww, sh, sw) as the TPU
// kernel's `swin`. Takes C % 16 == 0, C <= 128, and D == 2 or D % 16 == 0,
// D <= 128: GMFlow's widths (wider ones need their own instantiations).
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int ofd_flash_fwd(const void* q, const void* k, const void* v,
                             void* out, void* lse, int B, int Lq, int Lk,
                             int C, int D, float scale, int swin_k, int wh,
                             int ww, int sh, int swd, int is_bf16,
                             void* stream) {
  if (B < 1 || B > 65535 || Lq < 1 || Lk < 1 || C < 16 || C > 128 ||
      C % 16 || !(D == 2 || (D % 16 == 0 && D >= 16 && D <= 128)) ||
      swin_k < 0)
    return (int)cudaErrorInvalidValue;
  const Swin sw{swin_k, wh, ww, sh, swd};
  cudaStream_t st = (cudaStream_t)stream;
  if (!is_bf16) {
    const size_t smem = sizeof(float) * ((size_t)F32_BQ * (C + 1) +
                                         (size_t)F32_BK * (C + D) +
                                         (size_t)F32_BQ * (D + 1));
    if (smem > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          flash_fwd_f32, cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)smem);
      if (e != cudaSuccess) return (int)e;
    }
    const dim3 grid((unsigned)((Lq + F32_BQ - 1) / F32_BQ), (unsigned)B);
    flash_fwd_f32<<<grid, F32_BQ, smem, st>>>(
        (const float*)q, (const float*)k, (const float*)v, (float*)out,
        (float*)lse, Lq, Lk, C, D, scale, sw);
    return (int)cudaGetLastError();
  }
  return D == 2 ? launch_bf16<128, 16, true>(q, k, v, out, lse, B, Lq, Lk, C,
                                            D, scale, sw, st)
                : launch_bf16<128, 128, false>(q, k, v, out, lse, B, Lq, Lk,
                                               C, D, scale, sw, st);
}
