// Flash (streaming-softmax) attention forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel opticalflowfromdepth_tpu/ops/flash.py:
// _flash_kernel (launched by _flash_forward). Same function:
//   out = softmax(q . k^T * scale [+ bias] [- 100 across Swin regions]
//                 [key padding]) . v,
// q [B, Lq, C], k [B, Lk, C], v [B, Lk, D], out [B, Lq, D] f32, an
// optional dense f32 bias [B, Lq, Lk], with an online softmax over key
// tiles (running denominator, f32 accumulator), the output divided by
// max(l, 1e-30) and optionally lse = m + log(max(l, 1e-30)) [B, Lq] f32.
// The running max starts at -inf and the key padding is -inf (the TPU
// kernel: -1e30 both), so a row that the bias masks whole (-1e30 on every
// key) gives the mean of v over the real keys, as JAX's dense oracle does;
// exponentials are taken against 0 while a row has met no finite score
// (flash_common.cuh:max_offset).
//
// The bias: every route adds it to its scores where they sit in
// registers, each lane reading its own accumulator elements (columns 8j +
// 2t and + 1 of rows g and g + 8: a quad reads whole 32-byte sectors) as
// one float2 where Lk is even, two floats where it is odd, so no padded
// copy of the bias is made (flash_common.cuh:bias_pair). With a bias the
// scores' bound is its bytes, B Lq Lk 4, read once at 3.35 TB/s.
//
// Widths: C % 16 == 0 and D == 2 or D % 16 == 0, any width up to MAX_WIDTH
// (65,535 chunks of 128 columns on a grid axis; ops/flash.py pads other
// widths with zero columns and slices the output back). Only C = 128 with
// D = 128 or 2 takes the tf32x3 route, and only that and C = 256 with D =
// 256 or 2 the wgmma route; every other width the mma.sync route (bf16) or
// the CUDA-core route (f32).
//
// The Swin shifted-window mask is computed from the global query and key
// indices, as the TPU kernel does: the window id is the batch index mod
// K^2 (batches ordered [b, wy, wx]); only the last window row / column
// holds a wrap, at in-window row wh - sh / column ww - sw; a query and a
// key in different regions get -100. Each key tile's regions are computed
// once into shared memory, and windows with a single region skip it.
//
// What bounds it on this card: at GMFlow's shapes (C = 128) the two
// products, 2 * B * Lq * Lk * (C + D) operations, over the tensor cores
// (bf16, or f32 in split TF32: three TF32 products each), and the B * Lq *
// Lk exponentials over the special-function units; the bytes (q, k, v
// once, out once) are ~1000x less. So every route keeps the [Lq, Lk]
// scores out of device memory, and four feed it (the caller,
// ops/flash.py:plan, names the route; the C side checks it again):
//
// bf16 at C = 128 with D = 128 or 2 (every GMFlow call) and at C = 256 with
// D = 256 or 2 (every call of GMFlow at 256 channels): the wgmma route,
// namespace sm90, one kernel templated on the width W = C. A block holds
// warpgroups of 64 queries each: at D = 128 three where the blocks then
// fill every SM twice, else two; at D = 256 two (O's 128 registers a thread
// leave three warpgroups' cap of 168 no room); at D = 2 one, whose small
// blocks fit four a SM at C = 128 and two at C = 256 (batch-1 matching: 112
// blocks of 64 queries, against 56 of 128, for 132 SMs). Q is resident,
// loaded once by TMA; K and V stream in tiles of 64 keys through a 2-stage
// ring under mbarriers (full: the TMA bytes and the loading warp's 32
// cp.async arrivals; empty: every thread). TMA boxes of [64 rows][64
// columns] land 128-byte swizzled, as wgmma's descriptors read them, and
// zero-fill the rows past L, so Lq and Lk need no padding copy. Per tile a
// warpgroup computes S = Q K^T with wgmma m64n64k16 (W / 16 k-steps), both
// operands from shared memory, K-major; then the online softmax in
// registers, in base 2: log2(e) is folded into the scale (and into the Swin
// mask's -100), and p = ex2.approx(x - m), which differs from expf in the
// last bits of p only, inside ops/flash.py:bf16_tolerance's allowance for
// another exp (ops/flash.py:flash_softmax_matmul_plain with exp2=True
// repeats the base-2 form); the Swin mask is applied only where a column's
// region differs from a row's, the key padding only in the last tile. P is
// rounded to bf16 straight into the A fragments, as the TPU kernel rounds
// it per 64-key block (the denominator sums the unrounded P), and O += P V
// is wgmma m64n128k16, A from registers, V read MN-major through the
// transpose bit; at D = 256 O is two 64 x 128 accumulators (128 registers a
// thread), each over two of V's four panels from the same P fragments, so S
// and its exponentials are computed once for all 256 columns (the mma.sync
// route computes them once for each 128-column chunk). At C = 256, D = 256
// a block's shared memory is two warpgroups' Q (64 KB) and two ring stages
// of K and V (64 KB each): 198,656 bytes, one block an SM; at D = 2,
// 100,352 bytes (ptxas, nvcc 12.9: 208 registers at D = 256, 213 with a
// bias; 109 and 117 at D = 2; no spills, no stack). Two warpgroups of a
// block take turns (named barriers) to issue their S products, so that
// one's exponentials overlap the other's products; three run free
// (pipelining S of tile j with P V of tile j - 1 inside a warpgroup
// measured slower: PERF.md, section 6); there is no producer warpgroup
// (PERF.md, section 6: setmaxnreg did not raise ptxas's budget). At D = 2 (the
// matching grid and the propagated flow) V's rows are 4 bytes, below TMA's
// 16-byte box: the loading warp copies them into the ring with cp.async,
// counted on the stage's barrier, and P . V runs on the CUDA cores in f32
// (the tensor cores would waste 63/64 of their work on padding D). What it
// does about the mma.sync route's limits: every C- and D-wide product is a
// wgmma; no B fragment is built from 16-bit shared loads; no synchronous
// staging. Its limits: a warpgroup's S, softmax and P . V follow each
// other, and the key sweep is not split, so batch-1 matching fills 112 of
// 132 SMs (and at C = 256, D = 256 the serving windows' 112 blocks of 128
// queries fill 112 of 132 SMs once).
//
// Other bf16 widths (C % 16 == 0; D = 2 or D % 16 == 0; any width, GMFlow
// at 512 channels' C = 512 with D = 512 or 2 among them): the mma.sync
// route, one block of 4 warps per (batch entry, 64-query tile, chunk of 128
// output columns: at D > 128 each chunk's blocks recompute S, which keeps
// the accumulators at 64 registers at any D); each warp owns 16 query rows,
// whose Q fragments stay in registers for the whole key sweep at C <= 128
// and are loaded per k-step from the block's Q rows in shared memory at C >
// 128: resident for the sweep where they fit a block (C up to about 1,500),
// else staged a 128-column panel at a time beside K's. Per 64-key tile, K
// is staged in panels of 128 columns (so a block's shared memory stays
// within 227 KB at any C: 101 KB at C = D = 512, Q resident) and V's chunk
// with the first, by 16-byte cp.async (rows padded by 8 bf16, so the
// fragment loads hit 32 distinct banks); S = Q K^T with mma.sync m16n8k16
// (bf16 in, f32 accumulate, k-step after k-step in C's order at any width); the
// scale, the Swin mask and the key padding; the running max and
// denominator per row, reduced over the 4 lanes that share a row with
// shuffles; P rounded to bf16 as above. D % 16 == 0: P . V on the tensor
// cores too, S's accumulator fragments being P's A fragments; D == 2: P .
// V on the CUDA cores in f32. Every call of GMFlow at 512 channels takes
// it (at 256 channels the wgmma route replaced it;
// ops/flash.py:launcher(route="mma_sync") still forces it there, to time
// it beside that route). Its limits: K's panels are staged synchronously
// (no ring), and at D > 128 each chunk recomputes S over all of C.
//
// f32 at C = 128 and D = 128 or 2 (every sequence-parallel ring step,
// whatever the model's dtype, and every flash call of an f32 GMFlow): the
// tf32x3 route, namespace tf32x3 (the split-TF32 products of tf32x3.cuh,
// shared with the backward). One warp owns 16 query rows in registers; a
// block's Q rows are resident in shared rows of 132 floats, K (and V at D
// = 128; v's pairs at D = 2) stream through a 2-stage cp.async ring, rows
// past L zero-filled. Per tile S = Q K^T in split TF32 (a_lo b_hi + a_hi
// b_lo + a_hi b_hi, mma.sync m16n8k8: the lo terms keep it within f32's
// tolerance, TF32 alone would not be), then the online softmax in
// registers in base 2, as the wgmma route's (log2(e) in the scale and the
// Swin mask's -100, ex2.approx, the running max from -1e30, the row's max
// and sum over its quad by shuffles, the Swin regions once per key tile
// and no mask in a single-region window, the key padding in the last tile
// only); then O += P V: at D = 128 in split TF32 too, P's accumulator
// fragments being the A fragments (each k8 step's keys relabelled); at D
// = 2 on the CUDA cores in f32, a lane's keys summed over its quad at the
// end. Where B x row blocks fill less than one wave of the card (batch-1
// matching, the ring's B = 1 slices) the key sweep is cut into runs of
// whole tiles (plan's splits, the count from the shape alone): each run
// writes its f32 partials (the running max m in base 2, the denominator
// l, the unnormalised O) to a scratch, and a second launch merges them in
// run order, so no atomics and the same bits every launch. Its limits:
// every warp splits the tile's K (and V) again, and S, the softmax and P V
// follow each other within a warp. Why not wgmma: as in the backward, its
// tf32 operands are read K-major only, so P . V would need V transposed,
// in hi and lo pieces, in shared memory.
//
// Other f32 widths (C % 16 == 0; D = 2 or D % 16 == 0; any width; and the
// route that GMFlow's widths took before the tf32x3 one, when a caller
// forces it): f32 FMA on the CUDA cores, no TF32: one thread per query row
// (64 a block), one block per chunk of 128 output columns (a grid axis;
// each chunk's blocks recompute S), the query tile (resident where it fits,
// else a 128-column panel at a time) and the row accumulators in shared
// memory, K in 32-key tiles of 128-column panels and V's chunk read by
// every thread at the same address (broadcast), staged by 4-byte cp.async.
// A block's shared memory stays within 227 KB at any width (197 KB at C =
// D = 512, Q resident; 99 KB where Q is staged in panels).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_common.cuh"
#include "tf32x3.cuh"

#define BQ 64         // query rows per block (mma.sync route)
#define BK 64         // keys per tile (both bf16 routes)
#define WARPS 4
#define PAD 8         // bf16 elements appended to each shared row
#define PCOLS 128     // columns of C a panel (mma.sync and CUDA-core routes)
#define F32_BQ 64     // query rows (= threads) per block (f32 path)
#define F32_BK 32     // keys per tile (f32 path)
#define F32_DC 128    // output columns a block (f32 path; a grid axis)
// Dynamic shared memory above which a launch must raise the kernel's limit
// first: the default 48 KB holds the static shared memory too (under 1 KB
// in these kernels).
#define SMEM_DEFAULT (48 * 1024 - 1024)
// Dynamic shared memory a block of the mma.sync and CUDA-core routes may
// take: 227 KB less 1 KB for its static shared memory.
#define SMEM_BLOCK (232448 - 1024)

using hopper::cp_async_4;
using hopper::cp_async_16;
using hopper::cp_async_wait_all;

// Copy rows [r0, r0 + BK) of W columns (W % 8 == 0) of a bf16 matrix whose
// rows are `stride` apart into [BK][ld] shared rows by 16-byte cp.async
// copies; rows >= L are zeros. The caller waits and syncs.
__device__ __forceinline__ void stage_rows(bf16* dst, int ld, const bf16* src,
                                           int r0, int L, int W, int stride) {
  const int vecs = W / 8;
  for (int i = threadIdx.x; i < BK * vecs; i += WARPS * 32) {
    const int r = i / vecs, c = (i - r * vecs) * 8;
    const bool ok = r0 + r < L;
    cp_async_16(dst + r * ld + c,
                ok ? src + (long long)(r0 + r) * stride + c : src,
                ok ? 16u : 0u);
  }
}

// Rows [r0, r0 + n) of W columns of an f32 matrix whose rows are `stride`
// apart into [n][ld] shared rows by 4-byte cp.async copies (any ld, so rows
// may be padded to an odd count of floats); rows >= L are zeros. The caller
// waits and syncs.
__device__ __forceinline__ void stage_f32(float* dst, int ld, const float* src,
                                          int r0, int n, int L, int W,
                                          int stride) {
  for (int i = threadIdx.x; i < n * W; i += blockDim.x) {
    const int r = i / W, c = i - r * W;
    const bool ok = r0 + r < L;
    cp_async_4(dst + r * ld + c,
               ok ? src + (long long)(r0 + r) * stride + c : src,
               ok ? 4u : 0u);
  }
}

// The mma.sync route. One block per (64 query rows, batch entry, chunk of
// DMAX output columns: blockIdx.z; each chunk's blocks recompute S). S =
// Q K^T is summed over C in panels of PCOLS columns, each key tile's K staged
// a panel at a time, k-step after k-step in the order of C at any width.
// QREG (C <= 128): Q's A fragments stay in registers for the sweep. Else
// each k-step loads them from Q's rows in shared memory: resident for the
// sweep where they fit (qres: [BQ][C + PAD], staged once), else staged a
// panel at a time beside K's ([BQ][PCOLS + PAD]).
template <bool QREG, int DMAX, bool PAYLOAD2, bool BIAS>
__global__ void __launch_bounds__(WARPS * 32)
flash_fwd_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, const float* __restrict__ bias,
               float* __restrict__ out, float* __restrict__ lse, int Lq,
               int Lk, int C, int D, float scale, Swin sw, int qres) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int d0 = PAYLOAD2 ? 0 : blockIdx.z * DMAX;
  const int Dc = PAYLOAD2 ? 2 : min(DMAX, D - d0);  // this chunk's columns
  const int ks = min(C, PCOLS) + PAD, ds = Dc + PAD;
  const int qs = qres ? C + PAD : PCOLS + PAD;         // a shared row of Q
  bf16* Ks = reinterpret_cast<bf16*>(smem);                 // [BK][ks]
  bf16* Vs = Ks + BK * ks;                                  // [BK][ds]
  float2* V2 = reinterpret_cast<float2*>(Vs);               // [BK] (D == 2)
  bf16* Qs = Vs + (PAYLOAD2 ? 4 * BK : BK * (min(D, DMAX) + PAD));  // [BQ][qs]
  __shared__ int kreg_s[BK];          // Swin region of each key of the tile

  const int b = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = (int)blockIdx.x * BQ;
  const int rows[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
  const bf16* qb = q + (long long)b * Lq * C;
  const bf16* kb = k + (long long)b * Lk * C;
  const bf16* vb = v + (long long)b * Lk * D;
  const float* brow[2] = {nullptr, nullptr};   // each own row's bias
  if (BIAS)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      if (rows[r] < Lq) brow[r] = bias + ((long long)b * Lq + rows[r]) * Lk;

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
  // (C <= 128), or Q's resident rows staged once (the first panel's wait
  // and barrier publish them)
  constexpr int KSTEPS = PCOLS / 16;
  uint32_t qa[QREG ? KSTEPS : 1][4];
  if constexpr (QREG) {
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
  } else if (qres) {
    stage_rows(Qs, qs, qb, q0, Lq, C, C);
  }

  constexpr int DTILES = PAYLOAD2 ? 1 : DMAX / 8;
  float o[DTILES][4];
#pragma unroll
  for (int i = 0; i < DTILES; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[i][e] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};  // this lane's share of each row's denominator

  for (int k0 = 0; k0 < Lk; k0 += BK) {
    // S = Q K^T: 16 rows x 64 keys per warp, 8 n-tiles of 8 keys, over the
    // panels of C; the tile's V (and the keys' regions) with the first
    float s[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
    for (int c0 = 0; c0 < C; c0 += PCOLS) {
      const int cw = min(PCOLS, C - c0);
      __syncthreads();  // the previous panel (and tile) is consumed
      stage_rows(Ks, ks, kb + c0, k0, Lk, cw, C);
      if (!QREG && !qres) stage_rows(Qs, qs, qb + c0, q0, Lq, cw, C);
      if (c0 == 0) {
        if (PAYLOAD2) {
          for (int r = threadIdx.x; r < BK; r += WARPS * 32) {
            float2 val = make_float2(0.f, 0.f);
            if (k0 + r < Lk) {
              const __nv_bfloat162 x = *reinterpret_cast<
                  const __nv_bfloat162*>(vb + (k0 + r) * 2LL);
              val = __bfloat1622float2(x);
            }
            V2[r] = val;
          }
        } else {
          stage_rows(Vs, ds, vb + d0, k0, Lk, Dc, D);
        }
        if (masked)
          for (int r = threadIdx.x; r < BK; r += WARPS * 32)
            kreg_s[r] = swin_region(sw, last_y, last_x, k0 + r);
      }
      cp_async_wait_all();
      __syncthreads();
      const bf16* qp = Qs + (qres ? c0 : 0) + (warp * 16 + g) * qs + 2 * t;
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk) {
        if (kk * 16 < cw) {
          uint32_t a[4];
          if constexpr (QREG) {
#pragma unroll
            for (int i = 0; i < 4; ++i) a[i] = qa[kk][i];
          } else {
            const bf16* p = qp + kk * 16;
            a[0] = load_u32(p);
            a[1] = load_u32(p + 8 * qs);
            a[2] = load_u32(p + 8);
            a[3] = load_u32(p + 8 * qs + 8);
          }
#pragma unroll
          for (int nt = 0; nt < 8; ++nt) {
            const bf16* kr = Ks + (nt * 8 + g) * ks + kk * 16 + 2 * t;
            mma_bf16(s[nt], a, load_u32(kr), load_u32(kr + 8));
          }
        }
      }
    }

    // scale, bias, Swin mask, key padding; the tile's max per row
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      float2 bp[2] = {make_float2(0.f, 0.f), make_float2(0.f, 0.f)};
      if (BIAS)
#pragma unroll
        for (int r = 0; r < 2; ++r)
          if (brow[r] != nullptr) bp[r] = bias_pair(brow[r], k0 + nt * 8 + 2 * t, Lk);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kl = nt * 8 + 2 * t + (e & 1);
        float x = s[nt][e] * scale;
        if (BIAS) x = __fadd_rn(x, (e & 1) ? bp[e >> 1].y : bp[e >> 1].x);
        if (masked && kreg_s[kl] != qreg[e >> 1]) x = x - 100.f;
        if (k0 + kl >= Lk) x = -INFINITY;
        s[nt][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float alpha[2], ms[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float mn = fmaxf(m[r], mx[r]);
      ms[r] = max_offset(mn);
      alpha[r] = expf(m[r] - ms[r]);
      m[r] = mn;
    }
    float ls[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(s[nt][e] - ms[e >> 1]);
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
      for (int kst = 0; kst < 4; ++kst) {
        const uint32_t a[4] = {pack_f32(s[2 * kst][0], s[2 * kst][1]),
                               pack_f32(s[2 * kst][2], s[2 * kst][3]),
                               pack_f32(s[2 * kst + 1][0], s[2 * kst + 1][1]),
                               pack_f32(s[2 * kst + 1][2], s[2 * kst + 1][3])};
        const bf16* vr = Vs + (kst * 16 + 2 * t) * ds + g;
#pragma unroll
        for (int dt = 0; dt < DTILES; ++dt) {
          if (dt * 8 < Dc) {
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
  float* ob = out + (long long)b * Lq * D + d0;
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
      if (dt * 8 < Dc) {
#pragma unroll
        for (int r = 0; r < 2; ++r)
          if (rows[r] < Lq)
            *reinterpret_cast<float2*>(ob + (long long)rows[r] * D + dt * 8 +
                                       2 * t) =
                make_float2(o[dt][2 * r] / den[r], o[dt][2 * r + 1] / den[r]);
      }
    }
  }
  if (lse != nullptr && t == 0 && blockIdx.z == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r)
      if (rows[r] < Lq)
        lse[(long long)b * Lq + rows[r]] = m[r] + logf(den[r]);
  }
}

// The CUDA-core route: one thread per query row (F32_BQ a block), one
// block per (query rows, batch entry, chunk of F32_DC output columns:
// blockIdx.z; each chunk's blocks recompute S), the row accumulators in
// shared memory. S is summed over C in panels of PCOLS columns, each key
// tile's K staged a panel at a time, in the order of C at any width; Q's
// rows resident for the sweep where they fit (qres: [F32_BQ][C + 1]),
// else staged a panel at a time beside K's ([F32_BQ][PCOLS + 1]).
template <bool BIAS>
__global__ void __launch_bounds__(F32_BQ)
flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ bias,
              float* __restrict__ out, float* __restrict__ lse, int Lq,
              int Lk, int C, int D, float scale, Swin sw, int qres) {
  extern __shared__ __align__(16) float fsm[];
  __shared__ int kreg_s[F32_BK];      // Swin region of each key of the tile
  const int d0 = blockIdx.z * F32_DC, Dc = min(F32_DC, D - d0);
  const int kw = min(C, PCOLS), qw = qres ? C : kw;
  float* Qs = fsm;                            // [F32_BQ][qw + 1]
  float* Ks = Qs + F32_BQ * (qw + 1);         // [F32_BK][kw]
  float* Vs = Ks + F32_BK * kw;               // [F32_BK][Dc]
  float* As = Vs + F32_BK * min(D, F32_DC);   // [F32_BQ][Dc + 1] sums
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * F32_BQ;
  const int row = q0 + tid;
  const float* qb = q + (long long)b * Lq * C;
  const float* kb = k + (long long)b * Lk * C;
  const float* vb = v + (long long)b * Lk * D;

  if (qres) stage_f32(Qs, qw + 1, qb, q0, F32_BQ, Lq, C, C);
  float* acc = As + tid * (Dc + 1);
  for (int d = 0; d < Dc; ++d) acc[d] = 0.f;

  bool last_y = false, last_x = false;
  int qreg = 0;
  if (sw.k) {
    const int win = b % (sw.k * sw.k);
    last_y = win / sw.k == sw.k - 1;
    last_x = win % sw.k == sw.k - 1;
    qreg = swin_region(sw, last_y, last_x, row);
  }
  const bool masked = sw.k && (last_y || last_x);
  const float* brow =
      BIAS && row < Lq ? bias + ((long long)b * Lq + row) * Lk : nullptr;
  float m = -INFINITY, l = 0.f;

  for (int k0 = 0; k0 < Lk; k0 += F32_BK) {
    float s[F32_BK];
#pragma unroll
    for (int j = 0; j < F32_BK; ++j) s[j] = 0.f;
    for (int c0 = 0; c0 < C; c0 += PCOLS) {
      const int cw = min(PCOLS, C - c0);
      __syncthreads();  // the previous panel (and tile) is consumed
      stage_f32(Ks, kw, kb + c0, k0, F32_BK, Lk, cw, C);
      if (!qres) stage_f32(Qs, qw + 1, qb + c0, q0, F32_BQ, Lq, cw, C);
      if (c0 == 0) {
        stage_f32(Vs, Dc, vb + d0, k0, F32_BK, Lk, Dc, D);
        if (masked && tid < F32_BK)
          kreg_s[tid] = swin_region(sw, last_y, last_x, k0 + tid);
      }
      cp_async_wait_all();
      __syncthreads();
      const float* qr = Qs + tid * (qw + 1) + (qres ? c0 : 0);
      for (int c = 0; c < cw; ++c) {
        const float qv = qr[c];
#pragma unroll
        for (int j = 0; j < F32_BK; ++j) s[j] = fmaf(qv, Ks[j * kw + c], s[j]);
      }
    }
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < F32_BK; ++j) {
      const int kj = k0 + j;
      float x = s[j] * scale;
      if (BIAS && brow != nullptr && kj < Lk) x = __fadd_rn(x, __ldg(brow + kj));
      if (masked && kreg_s[j] != qreg) x = x - 100.f;
      if (kj >= Lk) x = -INFINITY;
      s[j] = x;
      mx = fmaxf(mx, x);
    }
    const float mn = fmaxf(m, mx);
    const float ms = max_offset(mn);
    const float alpha = expf(m - ms);
    m = mn;
    float ls = 0.f;
#pragma unroll
    for (int j = 0; j < F32_BK; ++j) {
      s[j] = expf(s[j] - ms);
      ls += s[j];
    }
    l = l * alpha + ls;
    for (int d = 0; d < Dc; ++d) {
      float a = acc[d] * alpha;
#pragma unroll
      for (int j = 0; j < F32_BK; ++j) a = fmaf(s[j], Vs[j * Dc + d], a);
      acc[d] = a;
    }
  }

  if (row < Lq) {
    const float den = fmaxf(l, 1e-30f);
    float* orow = out + ((long long)b * Lq + row) * D + d0;
    for (int d = 0; d < Dc; ++d) orow[d] = acc[d] / den;
    if (lse != nullptr && blockIdx.z == 0)
      lse[(long long)b * Lq + row] = m + logf(den);
  }
}

// ---------------------------------------------------------------------------
// bf16 operands at C = 128 or 256 with D = C or 2: the wgmma route
// ---------------------------------------------------------------------------

namespace sm90 {

constexpr int STAGES = 2;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// One block's shared memory at width W = C (128 or 256): Q resident (W /
// 64 64-column panels a warpgroup), K and V streamed through a ring of
// STAGES tiles of 64 keys (V as W / 64 panels, D = W, or as 64 bf16 pairs
// when D = 2, which the loading warp copies with cp.async: rows of 4
// bytes start wherever b * Lk puts them, and TMA wants 16-byte aligned
// boxes).
template <int WGS, bool P2, int W>
struct FwdSmem {
  static constexpr int CP = W / 64;
  alignas(1024) bf16 q[WGS * CP][PANEL];
  alignas(1024) bf16 k[STAGES][CP][PANEL];
  alignas(1024) bf16 v[STAGES][P2 ? 1 : CP][P2 ? 2 * TILE : PANEL];
  uint64_t q_full, full[STAGES], empty[STAGES];
};

template <int WGS, bool P2, int W>
constexpr size_t fwd_smem_bytes() {
  return sizeof(FwdSmem<WGS, P2, W>) + 1024;  // + the slack to align to 1 KB
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The loads of one block. Thread 0 issues Q's TMA loads once. The loading
// warp (the first of the last warpgroup, which takes its turns second)
// fills ring stages: lane 0 issues the TMA loads of K's (and V's) panels;
// at D = 2 the 32 lanes copy V's pairs with cp.async (zeros past Lk), each
// lane's arrival on the stage's barrier made when its copies land.
template <int WGS, bool P2, int W>
struct FwdLoads {
  using SM = FwdSmem<WGS, P2, W>;
  static constexpr int CP = SM::CP;
  const CUtensorMap *q, *k, *v;
  const uint32_t* pairs;
  int b, q0, Lk;
  static constexpr int LOADER = (WGS - 1) * 4;

  __device__ __forceinline__ void stage(SM& sm, int it, int lane) const {
    const int s = it % STAGES, k0 = it * TILE;
    if (lane == 0) {
      mbar_expect_tx_only(&sm.full[s], (P2 ? 1 : 2) * CP * PANEL_BYTES);
      for (int p = 0; p < CP; ++p) {
        tma_load_3d(sm.k[s][p], k, &sm.full[s], p * 64, k0, b);
        if constexpr (!P2) tma_load_3d(sm.v[s][p], v, &sm.full[s], p * 64, k0, b);
      }
    }
    __syncwarp();  // the bytes are expected before any lane can arrive
    if constexpr (P2) {
#pragma unroll
      for (int i = lane; i < TILE; i += 32) {
        const bool ok = k0 + i < Lk;
        cp_async_4(&sm.v[s][0][2 * i], pairs + (ok ? (long long)b * Lk + k0 + i : 0),
                   ok ? 4 : 0);
      }
    }
    cp_async_arrive(&sm.full[s]);
  }

  __device__ __forceinline__ void start(SM& sm, int n_tiles) const {
    if (threadIdx.x == 0) {
      mbar_expect_tx(&sm.q_full, WGS * CP * PANEL_BYTES);
      for (int w = 0; w < WGS; ++w)
        for (int p = 0; p < CP; ++p)
          tma_load_3d(sm.q[w * CP + p], q, &sm.q_full, p * 64, q0 + w * TILE, b);
    }
    if (threadIdx.x / 32 == LOADER)
      for (int it = 0; it < STAGES && it < n_tiles; ++it)
        stage(sm, it, threadIdx.x & 31);
  }

  // after tile `it` is released: once every thread has released it, the
  // loading warp refills its stage with tile it + STAGES
  __device__ __forceinline__ void refill(SM& sm, int it, int n_tiles) const {
    if (threadIdx.x / 32 == LOADER && it + STAGES < n_tiles) {
      mbar_wait(&sm.empty[it % STAGES], (it / STAGES) & 1);
      stage(sm, it + STAGES, threadIdx.x & 31);
    }
  }
};

// One block per (batch entry, 64 * WGS queries), 64 queries per
// warpgroup; the keys stream. tm_q, tm_k and (at D = W) tm_v are 3-D maps
// of [B, L, W] in [1, 64, 64] boxes; at D = 2 v's pairs are read from the
// pointer. scale2 = scale * log2(e): the scores, the Swin mask's -100 and
// the running max are kept in base 2, so p = ex2(x - m); with a bias, x =
// s * scale2 + bias * f32(log2(e)), each product rounded. At D = W a
// warpgroup's O is W / 128 accumulators of 64 x 128 (o[h]: columns [128
// h, 128 h + 128)), each a product_rs over two of V's panels from the same
// P fragments, so S and its exponentials are computed once for every
// column of O.
template <int WGS, bool P2, bool BIAS, int W>
__global__ void __launch_bounds__(WGS * 128, 1)
flash_fwd_wgmma(const __grid_constant__ CUtensorMap tm_q,
                const __grid_constant__ CUtensorMap tm_k,
                const __grid_constant__ CUtensorMap tm_v,
                const bf16* __restrict__ v, const float* __restrict__ bias,
                float* __restrict__ out, float* __restrict__ lse, int Lq,
                int Lk, float scale2, Swin sw) {
  using SM = FwdSmem<WGS, P2, W>;
  constexpr int CP = SM::CP;
  constexpr int OH = P2 ? 1 : W / 128;   // O's 64 x 128 accumulators
  constexpr int ON = P2 ? 4 : 64;        // registers of each
  extern __shared__ unsigned char smem_raw[];
  SM& sm = *reinterpret_cast<SM*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);
  const int b = blockIdx.y, q0 = blockIdx.x * WGS * TILE;
  const int n_tiles = (Lk + TILE - 1) / TILE;
  const int wg = threadIdx.x / 128;
  if (threadIdx.x == 0) {
    mbar_init(&sm.q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&sm.full[s], 32);          // every loading lane arrives
      mbar_init(&sm.empty[s], WGS * 128);  // every thread arrives
    }
    mbar_fence_init();
  }
  __syncthreads();
  const FwdLoads<WGS, P2, W> loads{&tm_q, &tm_k, &tm_v,
                                   reinterpret_cast<const uint32_t*>(v), b,
                                   q0, Lk};
  loads.start(sm, n_tiles);

  const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, t = lane & 3;
  const int row0 = q0 + wg * TILE + warp * 16 + gq;  // rows row0, row0 + 8
  const bool idle = q0 + wg * TILE >= Lq;
  bool last_y, last_x;
  const bool masked = swin_window(sw, b, &last_y, &last_x);
  int qreg[2] = {0, 0};
  uint32_t same[2] = {0u, 0u};  // the row's region in every 2-bit field
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (masked) qreg[r] = swin_region(sw, last_y, last_x, row0 + 8 * r);
    same[r] = (uint32_t)qreg[r] * 0x55555555u;
  }
  const float swin_pen = 100.f * LOG2E;
  const float* brow[2] = {nullptr, nullptr};   // each own row's bias
  if (BIAS)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      if (row0 + 8 * r < Lq)
        brow[r] = bias + ((long long)b * Lq + row0 + 8 * r) * Lk;

  float o[OH][ON];
#pragma unroll
  for (int h = 0; h < OH; ++h)
#pragma unroll
    for (int i = 0; i < ON; ++i) o[h][i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};  // this lane's share of each row's denominator
  const bf16* qres = sm.q[wg * CP];

  // A tile's base-2 scores in sa -> p = ex2(x - m) in sa, with the bias,
  // the Swin mask only where a column's region differs from a row's and
  // the key padding only in the last tile; the running max updated, each
  // row's rescale of what came before in alpha, this lane's sum of p in
  // ls.
  auto softmax_tile = [&](float (&sa)[32], int k0, float (&alpha)[2],
                          float (&ls)[2]) {
    const uint32_t cregs =
        masked ? col_regions(sw, last_y, last_x, k0, t) : 0u;
    const bool swin_tile = masked && (cregs != same[0] || cregs != same[1]);
    const bool tail = k0 + TILE > Lk;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float2 bp[2] = {make_float2(0.f, 0.f), make_float2(0.f, 0.f)};
      if (BIAS)
#pragma unroll
        for (int r = 0; r < 2; ++r)
          if (brow[r] != nullptr)
            bp[r] = bias_pair(brow[r], k0 + 8 * j + 2 * t, Lk);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1, i = 4 * j + e;
        float x = sa[i] * scale2;
        if (BIAS)
          x = __fadd_rn(x, __fmul_rn((e & 1) ? bp[r].y : bp[r].x, LOG2E));
        if (swin_tile && other_region(cregs, j, e, qreg[r])) x -= swin_pen;
        if (tail && k0 + 8 * j + 2 * t + (e & 1) >= Lk) x = -INFINITY;
        sa[i] = x;
        mx[r] = fmaxf(mx[r], x);
      }
    }
    float ms[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float mn = fmaxf(m[r], mx[r]);
      ms[r] = max_offset(mn);
      alpha[r] = ex2(m[r] - ms[r]);
      m[r] = mn;
      ls[r] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const float p = ex2(sa[i] - ms[(i >> 1) & 1]);
      sa[i] = p;
      ls[(i >> 1) & 1] += p;
    }
  };
  // D = 2: O += P V on the CUDA cores in f32, P rounded to bf16; this
  // lane's keys only (o[0] = {row 0 d0, d1, row 1 d0, d1}), summed over
  // the quad at the end
  auto pv_cuda = [&](const float (&p)[32], int stage) {
    const __nv_bfloat162* v2 =
        reinterpret_cast<const __nv_bfloat162*>(sm.v[stage][0]);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const float2 vv = __bfloat1622float2(v2[8 * j + 2 * t + (e & 1)]);
        const float pb = __bfloat162float(__float2bfloat16(p[4 * j + e]));
        o[0][2 * r] = fmaf(pb, vv.x, o[0][2 * r]);
        o[0][2 * r + 1] = fmaf(pb, vv.y, o[0][2 * r + 1]);
      }
    }
  };

  // The sweep. Per tile: S (wgmma), the softmax (CUDA cores and the
  // special-function units), then P . V; the other warpgroup's products
  // run while this one's exponentials do.
  mbar_wait(&sm.q_full, 0);
  if (WGS == 2 && wg == 1) turn_pass(1);  // warpgroup 0 goes first

  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % STAGES;
    mbar_wait(&sm.full[s], (it / STAGES) & 1);
    const bool pass = wg == 0 || it + 1 < n_tiles;  // matched by a wait
    if (WGS == 2) turn_wait(wg);
    if (idle) {
      if (WGS == 2 && pass) turn_pass(wg);
    } else {
      float sa[32];
      wgmma_fence();
      product_c<W, 64>(sa, qres, sm.k[s][0]);  // S = Q K^T, 64 x 64
      wgmma_commit();
      if (WGS == 2 && pass) turn_pass(wg);
      wgmma_wait<0>();
      fence_regs(sa);
      float alpha[2], ls[2];
      softmax_tile(sa, it * TILE, alpha, ls);
#pragma unroll
      for (int h = 0; h < OH; ++h)
#pragma unroll
        for (int i = 0; i < ON; ++i) o[h][i] *= alpha[(i >> 1) & 1];
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + ls[r];
      if constexpr (P2) {
        pv_cuda(sa, s);
      } else {
        // O += P V: P rounded to bf16 into the A fragments, V the ring
        // tile read MN-major, 128 columns (two panels) an accumulator
        uint32_t pa[16];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) to_a_frag(sa, pa, kk);
        wgmma_fence();
#pragma unroll
        for (int h = 0; h < OH; ++h) product_rs(o[h], pa, sm.v[s][2 * h]);
        wgmma_commit();
        wgmma_wait<0>();
#pragma unroll
        for (int h = 0; h < OH; ++h) fence_regs(o[h]);
      }
    }
    mbar_arrive(&sm.empty[s]);
    loads.refill(sm, it, n_tiles);
  }

  if (idle) return;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  if constexpr (P2) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      o[0][e] += __shfl_xor_sync(0xffffffffu, o[0][e], 1);
      o[0][e] += __shfl_xor_sync(0xffffffffu, o[0][e], 2);
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= Lq) continue;
    const float den = fmaxf(l[r], 1e-30f);
    const long long at = (long long)b * Lq + row;
    if constexpr (P2) {
      if (t == 0)
        *reinterpret_cast<float2*>(out + at * 2) =
            make_float2(o[0][2 * r] / den, o[0][2 * r + 1] / den);
    } else {
#pragma unroll
      for (int h = 0; h < OH; ++h)
#pragma unroll
        for (int j = 0; j < 16; ++j)
          *reinterpret_cast<float2*>(out + at * W + 128 * h + 8 * j + 2 * t) =
              make_float2(o[h][4 * j + 2 * r] / den,
                          o[h][4 * j + 2 * r + 1] / den);
    }
    if (lse != nullptr && t == 0) lse[at] = m[r] * LN2 + logf(den);
  }
}

// The widths this route takes: GMFlow's (C = 128; D = 128, or 2 for the
// matching grid and the propagated flow) and GMFlow at 256 channels' (C =
// 256; D = 256 or 2), with B * L within TMA's int32 coordinates.
static bool takes(int B, int Lq, int Lk, int C, int D) {
  return (C == 128 || C == 256) && (D == C || D == 2) &&
         (long long)B * (Lq > Lk ? Lq : Lk) < (1ll << 31);
}

// Blocks of this instantiation that fit an SM (its shared-memory limit
// set first); looked up once per device.
template <int WGS, bool P2, bool BIAS, int W>
static int occupancy(int dev, int* per_sm) {
  static int cached[16] = {0};
  if (dev >= 0 && dev < 16 && cached[dev] > 0) {
    *per_sm = cached[dev];
    return 0;
  }
  const size_t smem = fwd_smem_bytes<WGS, P2, W>();
  int e = (int)cudaFuncSetAttribute(
      flash_fwd_wgmma<WGS, P2, BIAS, W>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e) return e;
  if ((e = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           per_sm, flash_fwd_wgmma<WGS, P2, BIAS, W>, WGS * 128, smem)))
    return e;
  if (*per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  if (dev >= 0 && dev < 16) cached[dev] = *per_sm;
  return 0;
}

// The query tile. D = 2: one warpgroup (64 queries) a block, whose small
// blocks fit up to four a SM at W = 128 and two at W = 256. D = 128: three
// warpgroups (192 queries, sharing the key stream) where such blocks fill
// every SM at least twice (the training and refinement windows), else two
// (128 queries, taking turns), which leave fewer SMs idle on small batches
// (the serving windows: 80 blocks of three against 112 of two for 132
// SMs). With a bias, and at D = 256, always two: the bias loads and O's
// 128 registers a thread need more than three warpgroups' cap of 168.
// plan = {warpgroups a block, blocks, blocks per SM, waves}.
template <bool P2, bool BIAS, int W>
static int choose(int B, int Lq, int* plan) {
  int dev, sms, per_sm, e;
  if ((e = (int)cudaGetDevice(&dev))) return e;
  if ((e = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                       dev)))
    return e;
  const auto blocks = [&](int wgs) {
    return (long long)B * ((Lq + wgs * TILE - 1) / (wgs * TILE));
  };
  int wgs;
  if constexpr (P2) {
    wgs = 1;
    e = occupancy<1, true, BIAS, W>(dev, &per_sm);
  } else if constexpr (BIAS || W == 256) {
    wgs = 2;
    e = occupancy<2, false, BIAS, W>(dev, &per_sm);
  } else {
    wgs = blocks(3) >= 2ll * sms ? 3 : 2;
    e = wgs == 3 ? occupancy<3, false, false, W>(dev, &per_sm)
                 : occupancy<2, false, false, W>(dev, &per_sm);
  }
  if (e) return e;
  const long long n = blocks(wgs);
  plan[0] = wgs;
  plan[1] = (int)n;
  plan[2] = per_sm;
  plan[3] = (int)((n + (long long)per_sm * sms - 1) / ((long long)per_sm * sms));
  return 0;
}

template <int WGS, bool P2, bool BIAS, int W>
static int launch(const CUtensorMap (&m)[3], const void* v, const void* bias,
                  void* out, void* lse, int B, int Lq, int Lk, float scale,
                  Swin sw, cudaStream_t st) {
  const dim3 grid((unsigned)((Lq + WGS * TILE - 1) / (WGS * TILE)),
                  (unsigned)B);
  flash_fwd_wgmma<WGS, P2, BIAS, W>
      <<<grid, WGS * 128, fwd_smem_bytes<WGS, P2, W>(), st>>>(
          m[0], m[1], m[2], (const bf16*)v, (const float*)bias, (float*)out,
          (float*)lse, Lq, Lk, scale * LOG2E, sw);
  return (int)cudaGetLastError();
}

template <bool P2, bool BIAS, int W>
static int forward(const void* q, const void* k, const void* v,
                   const void* bias, void* out, void* lse, int B, int Lq,
                   int Lk, float scale, Swin sw, cudaStream_t st) {
  int plan[4], e;
  if ((e = choose<P2, BIAS, W>(B, Lq, plan))) return e;  // sets smem limits
  CUtensorMap m[3];
  if ((e = tensor_map_bf16_3d(&m[0], q, W, Lq, B, TILE))) return e;
  if ((e = tensor_map_bf16_3d(&m[1], k, W, Lk, B, TILE))) return e;
  if (P2)
    m[2] = m[1];  // not read: v's pairs come from the pointer
  else if ((e = tensor_map_bf16_3d(&m[2], v, W, Lk, B, TILE)))
    return e;
  if constexpr (P2)
    return launch<1, true, BIAS, W>(m, v, bias, out, lse, B, Lq, Lk, scale,
                                    sw, st);
  else if constexpr (BIAS || W == 256)
    return launch<2, false, BIAS, W>(m, v, bias, out, lse, B, Lq, Lk, scale,
                                     sw, st);
  else
    return plan[0] == 3
               ? launch<3, false, false, W>(m, v, bias, out, lse, B, Lq, Lk,
                                            scale, sw, st)
               : launch<2, false, false, W>(m, v, bias, out, lse, B, Lq, Lk,
                                            scale, sw, st);
}

// The launch of ofd_flash_fwd's wgmma route at C = W (D = W or 2), with a
// bias or none.
template <int W>
static int forward_at(const void* q, const void* k, const void* v,
                      const void* bias, void* out, void* lse, int B, int Lq,
                      int Lk, int D, float scale, Swin sw, cudaStream_t st) {
  if (D == 2)
    return bias != nullptr
               ? forward<true, true, W>(q, k, v, bias, out, lse, B, Lq, Lk,
                                        scale, sw, st)
               : forward<true, false, W>(q, k, v, bias, out, lse, B, Lq, Lk,
                                         scale, sw, st);
  return bias != nullptr
             ? forward<false, true, W>(q, k, v, bias, out, lse, B, Lq, Lk,
                                       scale, sw, st)
             : forward<false, false, W>(q, k, v, bias, out, lse, B, Lq, Lk,
                                        scale, sw, st);
}

}  // namespace sm90

// ---------------------------------------------------------------------------
// f32 operands at C = 128 and D = 128 or 2: the tf32x3 route
// ---------------------------------------------------------------------------

namespace tf32x3 {

constexpr float LN2 = 0.6931471805599453f;
constexpr int MAX_SPLITS = 16;    // runs of a split sweep at most
constexpr int RUN_OVERHEAD = 2;   // a block's fixed work, in tiles

// The block of each width: warps (16 query rows each), keys a ring tile
// and their 8-wide tiles of S, blocks an SM (the launch bounds), and the
// shared memory in floats: Q's resident rows, then a ring stage (the K
// tile, and V's tile or its pairs, PAY).
template <bool P2>
struct FwdCfg {
  static constexpr int NW = P2 ? 4 : 8;
  static constexpr int THREADS = NW * 32;
  static constexpr int BROWS = NW * 16;
  static constexpr int TILE = P2 ? 64 : 32;
  static constexpr int NT = TILE / 8;
  static constexpr int PER_SM = P2 ? 2 : 1;
  static constexpr int PAY = P2 ? 2 * TILE : TILE * STR;
  static constexpr int STAGE = TILE * STR + PAY;
  static constexpr size_t SMEM =
      sizeof(float) * (BROWS * STR + STAGES * STAGE);
};

// One block per (BROWS queries, run of the key tiles, batch entry): the
// key tiles [split * per, split * per + per) stream past the resident Q.
// With one run the block writes out (and lse); with more, its partials
// into run `split` of the scratches: out [splits, B, Lq, D] the
// unnormalised O, lse [splits, B, Lq] as float2 (m in base 2, l). Each
// run adds the bias of its own key tiles.
template <bool P2, bool BIAS>
__global__ void __launch_bounds__(FwdCfg<P2>::THREADS, FwdCfg<P2>::PER_SM)
flash_fwd_tf32(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ bias,
               float* __restrict__ out, float* __restrict__ lse, int Lq,
               int Lk, float scale, Swin sw, int per) {
  using K = FwdCfg<P2>;
  constexpr int TILE = K::TILE, NT = K::NT, T = K::THREADS, SF = K::STAGE;
  constexpr int DW = P2 ? 2 : W;
  extern __shared__ __align__(16) float fsm[];
  float* qs = fsm;                              // [BROWS][STR]
  float* ring = fsm + K::BROWS * STR;           // STAGES x SF
  const int b = blockIdx.z, split_i = blockIdx.y, q0 = blockIdx.x * K::BROWS;
  const int all = (Lk + TILE - 1) / TILE;
  const int first = split_i * per;
  const int n_tiles = min(all, first + per) - first;
  const float* kb = k + (long long)b * Lk * W;
  const float* vb = v + (long long)b * Lk * DW;

  auto load_tile = [&](int it) {
    float* st = ring + (it % STAGES) * SF;
    const int k0 = (first + it) * TILE;
    load_rows<T>(st, kb, k0, TILE, Lk);
    if constexpr (P2)
      load_small<T, 2>(st + TILE * STR, vb, k0, TILE, Lk);
    else
      load_rows<T>(st + TILE * STR, vb, k0, TILE, Lk);
  };
  load_rows<T>(qs, q + (long long)b * Lq * W, q0, K::BROWS, Lq);
  load_tile(0);
  cp_commit();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, t = lane & 3;
  const int row0 = q0 + warp * 16 + gq;             // rows row0, row0 + 8
  const bool idle = q0 + warp * 16 >= Lq;
  bool last_y, last_x;
  const bool masked = swin_window(sw, b, &last_y, &last_x);
  int qreg[2] = {0, 0};
  uint32_t same[2];             // the row's region in every 2-bit field
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (masked) qreg[r] = swin_region(sw, last_y, last_x, row0 + 8 * r);
    same[r] = (uint32_t)qreg[r] * 0x55555555u;
  }
  const float scale2 = scale * LOG2E, mask2 = 100.f * LOG2E;
  const float* brow[2] = {nullptr, nullptr};   // each own row's bias
  if (BIAS)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      if (row0 + 8 * r < Lq)
        brow[r] = bias + ((long long)b * Lq + row0 + 8 * r) * Lk;
  float o[P2 ? 1 : W / 8][4];
#pragma unroll
  for (int i = 0; i < (P2 ? 1 : W / 8); ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[i][e] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};      // this lane's share of each row's denominator

  for (int it = 0; it < n_tiles; ++it) {
    if (it + 1 < n_tiles) load_tile(it + 1);
    cp_commit();
    cp_wait<1>();       // tile it (and Q) landed
    __syncthreads();
    const float* st = ring + (it % STAGES) * SF;
    if (!idle) {
      const int k0 = (first + it) * TILE;
      // S = Q K^T: 16 queries x TILE keys
      float s[NT][4];
      prod_rows<NT>(s, qs + warp * 16 * STR, st, gq, t);
      // base-2 scores with the bias; the Swin mask only where a column's
      // region differs from a row's, the key padding only in the last tile
      const uint32_t cregs =
          masked ? sm90::col_regions(sw, last_y, last_x, k0, t) : 0u;
      const bool swin_tile = masked && (cregs != same[0] || cregs != same[1]);
      const bool tail = k0 + TILE > Lk;
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        float2 bp[2] = {make_float2(0.f, 0.f), make_float2(0.f, 0.f)};
        if (BIAS)
#pragma unroll
          for (int r = 0; r < 2; ++r)
            if (brow[r] != nullptr)
              bp[r] = bias_pair(brow[r], k0 + 8 * j + 2 * t, Lk);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          float x = s[j][e] * scale2;
          if (BIAS)
            x = __fadd_rn(x, __fmul_rn((e & 1) ? bp[r].y : bp[r].x, LOG2E));
          if (swin_tile && sm90::other_region(cregs, j, e, qreg[r]))
            x -= mask2;
          if (tail && k0 + 8 * j + 2 * t + (e & 1) >= Lk) x = -INFINITY;
          s[j][e] = x;
          mx[r] = fmaxf(mx[r], x);
        }
      }
      float alpha[2], ms[2], ls[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float mn = fmaxf(m[r], mx[r]);
        ms[r] = max_offset(mn);
        alpha[r] = ex2(m[r] - ms[r]);
        m[r] = mn;
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = ex2(s[j][e] - ms[e >> 1]);
          s[j][e] = p;
          ls[e >> 1] += p;
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + ls[r];
#pragma unroll
      for (int i = 0; i < (P2 ? 1 : W / 8); ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[i][e] *= alpha[e >> 1];
      if constexpr (P2) {
        // O += P V on the CUDA cores in f32, this lane's keys only (o[0] =
        // {row 0 d0, d1, row 1 d0, d1})
        const float2* vp = reinterpret_cast<const float2*>(st + TILE * STR);
#pragma unroll
        for (int j = 0; j < NT; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = e >> 1;
            const float2 vv = vp[8 * j + 2 * t + (e & 1)];
            o[0][2 * r] = fmaf(s[j][e], vv.x, o[0][2 * r]);
            o[0][2 * r + 1] = fmaf(s[j][e], vv.y, o[0][2 * r + 1]);
          }
        }
      } else {
        prod_pb<NT>(o, s, st + TILE * STR, gq, t);   // O += P V
      }
    }
    __syncthreads();    // the stage is consumed before it is refilled
  }
  if (idle) return;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  if constexpr (P2) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      o[0][e] += __shfl_xor_sync(0xffffffffu, o[0][e], 1);
      o[0][e] += __shfl_xor_sync(0xffffffffu, o[0][e], 2);
    }
  }
  const bool whole = gridDim.y == 1;
  const long long at = (long long)(split_i * gridDim.z + b) * Lq;  // row 0
  float den[2] = {1.f, 1.f};
  if (whole) {
#pragma unroll
    for (int r = 0; r < 2; ++r) den[r] = fmaxf(l[r], 1e-30f);
  }
  if constexpr (P2) {
    if (t == 0) {
#pragma unroll
      for (int r = 0; r < 2; ++r)
        if (row0 + 8 * r < Lq)
          *reinterpret_cast<float2*>(out + (at + row0 + 8 * r) * 2) =
              make_float2(o[0][2 * r] / den[r], o[0][2 * r + 1] / den[r]);
    }
  } else {
    if (whole) {
#pragma unroll
      for (int n = 0; n < W / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[n][e] /= den[e >> 1];
    }
    store_rows(out + at * W, o, row0, Lq, t, 1.f);
  }
  if (lse == nullptr || t != 0) return;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= Lq) continue;
    if (whole)
      lse[at + row] = m[r] * LN2 + logf(den[r]);
    else
      reinterpret_cast<float2*>(lse)[at + row] = make_float2(m[r], l[r]);
  }
}

// A split sweep's runs merged, one thread per output element: per row, M
// = the largest of the runs' m_s, L = sum_s l_s 2^(m_s - M), out = sum_s
// O_s 2^(m_s - M) / max(L, 1e-30) and lse = M ln 2 + log(max(L, 1e-30)),
// each sum in run order. part_o [splits, rows, D], part_ml [splits, rows]
// (m, l); lse may be null.
__global__ void __launch_bounds__(256)
merge_splits(const float* __restrict__ part_o,
             const float2* __restrict__ part_ml, float* __restrict__ out,
             float* __restrict__ lse, long long rows, int D, int splits) {
  const long long n = rows * D;
  for (long long i = blockIdx.x * 256ll + threadIdx.x; i < n;
       i += (long long)gridDim.x * 256) {
    const long long row = i / D;
    float mx = -INFINITY;
    for (int s = 0; s < splits; ++s) mx = fmaxf(mx, part_ml[s * rows + row].x);
    const float ms = max_offset(mx);
    float den = 0.f, acc = 0.f;
    for (int s = 0; s < splits; ++s) {
      const float2 ml = part_ml[s * rows + row];
      const float w = ex2(ml.x - ms);
      den += ml.y * w;
      acc += part_o[s * n + i] * w;
    }
    den = fmaxf(den, 1e-30f);
    out[i] = acc / den;
    if (lse != nullptr && i == row * D) lse[row] = mx * LN2 + logf(den);
  }
}

// How many runs to cut a sweep of `tiles` tiles into, for `blocks` blocks
// on a card that holds `slots` at once (ops/flash.py:split_count): 1 if
// the blocks fill the slots; else the count whose waves times a block's
// work (its run's tiles and RUN_OVERHEAD) is least, the fewest runs among
// equals, at most MAX_SPLITS, none empty.
static int split_count(long long blocks, int tiles, long long slots) {
  if (blocks >= slots) return 1;
  int best = 1;
  long long cost = ((blocks + slots - 1) / slots) * (tiles + RUN_OVERHEAD);
  for (int s = 2; s <= (tiles < MAX_SPLITS ? tiles : MAX_SPLITS); ++s) {
    const int per = (tiles + s - 1) / s;
    if ((tiles + per - 1) / per != s) continue;   // a run would be empty
    const long long c =
        ((blocks * s + slots - 1) / slots) * (per + RUN_OVERHEAD);
    if (c < cost) {
      best = s;
      cost = c;
    }
  }
  return best;
}

// Blocks of the route's kernel at this width that fit an SM (its shared
// memory limit set first).
template <bool P2, bool BIAS>
static int occupancy(int* per_sm) {
  using K = FwdCfg<P2>;
  int e = (int)cudaFuncSetAttribute(
      flash_fwd_tf32<P2, BIAS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)K::SMEM);
  if (e) return e;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      per_sm, flash_fwd_tf32<P2, BIAS>, K::THREADS, K::SMEM);
}

// plan = {rows a block, keys a tile, blocks (all runs), blocks per SM,
// waves, runs of the key sweep}
template <bool P2, bool BIAS>
static int choose(int B, int Lq, int Lk, int sms, int* plan) {
  using K = FwdCfg<P2>;
  int per_sm, e;
  if ((e = occupancy<P2, BIAS>(&per_sm))) return e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const long long blocks = (long long)B * ((Lq + K::BROWS - 1) / K::BROWS);
  const long long slots = (long long)sms * per_sm;
  const int splits = split_count(blocks, (Lk + K::TILE - 1) / K::TILE, slots);
  const long long n = blocks * splits;
  plan[0] = K::BROWS;
  plan[1] = K::TILE;
  plan[2] = (int)n;
  plan[3] = per_sm;
  plan[4] = (int)((n + slots - 1) / slots);
  plan[5] = splits;
  return 0;
}

template <bool P2, bool BIAS>
static int launch(const void* q, const void* k, const void* v,
                  const void* bias, void* out, void* lse, int B, int Lq,
                  int Lk, float scale, Swin sw, int splits, cudaStream_t st) {
  using K = FwdCfg<P2>;
  const int per = tiles_per_split(Lk, K::TILE, splits);
  if (!per) return (int)cudaErrorInvalidValue;
  int e;
  if ((e = (int)cudaFuncSetAttribute(
           flash_fwd_tf32<P2, BIAS>,
           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)K::SMEM)))
    return e;
  const dim3 grid((unsigned)((Lq + K::BROWS - 1) / K::BROWS),
                  (unsigned)splits, (unsigned)B);
  flash_fwd_tf32<P2, BIAS><<<grid, K::THREADS, K::SMEM, st>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)bias,
      (float*)out, (float*)lse, Lq, Lk, scale, sw, per);
  return (int)cudaGetLastError();
}

}  // namespace tf32x3

// Output columns a block of the mma.sync route takes (a grid axis)
#define DCHUNK 128

// The shared memory of a block of the CUDA-core route (Q's rows, resident
// or a panel; K's panel; V's chunk; the row sums) and of the mma.sync route
// (K's panel, V's chunk or its 64 pairs, Q's rows past C = 128, resident or
// a panel), bytes.
static size_t f32_smem(int C, int D, bool qres) {
  const size_t kw = C < PCOLS ? C : PCOLS, qw = qres ? C : kw;
  const size_t dc = D < F32_DC ? D : F32_DC;
  return sizeof(float) * (F32_BQ * (qw + 1) + F32_BK * kw + F32_BK * dc +
                          F32_BQ * (dc + 1));
}

static size_t bf16_smem(int C, int D, bool qres) {
  const size_t ks = (C < PCOLS ? C : PCOLS) + PAD;
  const size_t dc = D < DCHUNK ? D : DCHUNK;
  const size_t v =
      D == 2 ? BK * sizeof(float2) : BK * (dc + PAD) * sizeof(bf16);
  const size_t qs = C <= PCOLS ? 0 : (size_t)BQ * ((qres ? C : PCOLS) + PAD);
  return BK * ks * sizeof(bf16) + v + qs * sizeof(bf16);
}

// The mma.sync or CUDA-core route's launch at these widths: the kernel
// (the mma.sync instantiation: Q in registers at C <= 128, D = 2 apart),
// its dynamic shared memory, whether Q's rows stay resident (where they
// fit a block), rows and threads a block, keys a tile, D chunks (the
// grid's z).
struct Narrow {
  const void* fn;
  size_t smem;
  int qres, rows, threads, keys, chunks;
};

static Narrow narrow(bool is_bf16, int C, int D, bool bias) {
  if (!is_bf16) {
    const bool qres = C <= PCOLS || f32_smem(C, D, true) <= SMEM_BLOCK;
    return {bias ? (const void*)flash_fwd_f32<true>
                 : (const void*)flash_fwd_f32<false>,
            f32_smem(C, D, qres), qres, F32_BQ, F32_BQ, F32_BK,
            (D + F32_DC - 1) / F32_DC};
  }
  const bool qreg = C <= PCOLS, p2 = D == 2;
  const bool qres = !qreg && bf16_smem(C, D, true) <= SMEM_BLOCK;
  const void* fn;
  if (bias)
    fn = qreg ? (p2 ? (const void*)flash_fwd_bf16<true, 16, true, true>
                    : (const void*)flash_fwd_bf16<true, DCHUNK, false, true>)
              : (p2 ? (const void*)flash_fwd_bf16<false, 16, true, true>
                    : (const void*)flash_fwd_bf16<false, DCHUNK, false, true>);
  else
    fn = qreg ? (p2 ? (const void*)flash_fwd_bf16<true, 16, true, false>
                    : (const void*)flash_fwd_bf16<true, DCHUNK, false, false>)
              : (p2 ? (const void*)flash_fwd_bf16<false, 16, true, false>
                    : (const void*)flash_fwd_bf16<false, DCHUNK, false,
                                                  false>);
  return {fn, bf16_smem(C, D, qres), qres, BQ, WARPS * 32, BK,
          p2 ? 1 : (D + DCHUNK - 1) / DCHUNK};
}

// Whether `route` takes these operands (bf16 or f32) and widths.
static bool route_takes(int route, int is_bf16, int B, int Lq, int Lk, int C,
                        int D) {
  switch (route) {
    case F32: return !is_bf16;
    case TF32X3: return !is_bf16 && tf32x3::takes(B, Lq, Lk, C, D);
    case MMA_SYNC: return is_bf16;
    case WGMMA: return is_bf16 && sm90::takes(B, Lq, Lk, C, D);
    default: return false;
  }
}

// The widths every route's checks start from: C % 16 == 0, D == 2 or D %
// 16 == 0, and at most 65,535 chunks of 128 columns on the grid's z axis
// (the mma.sync and CUDA-core routes' D chunks; the backward's C and D
// chunks), so C and D <= 65535 * 128.
#define MAX_WIDTH (65535 * 128)
static bool widths_ok(int C, int D) {
  return C >= 16 && C <= MAX_WIDTH && C % 16 == 0 &&
         (D == 2 || (D >= 16 && D <= MAX_WIDTH && D % 16 == 0));
}

// q [B, Lq, C], k [B, Lk, C], v [B, Lk, D], all bf16 or all f32,
// contiguous, 16-byte aligned; bias [B, Lq, Lk] f32, contiguous, 16-byte
// aligned, or null (no bias); out [B, Lq, D] f32; lse [B, Lq] f32 or null.
// swin_k = 0: no Swin mask; else (swin_k, wh, ww, sh, sw) as the TPU
// kernel's `swin`. Takes C % 16 == 0 and D == 2 or D % 16 == 0, up to
// MAX_WIDTH (ops/flash.py pads other widths with zero columns), on the
// route the caller names (enum Route; ops/flash.py:plan names bf16 at C =
// 128 and D = 128 or 2, and at C = 256 and D = 256 or 2, the wgmma route,
// other bf16 the mma.sync route, f32 at C = 128 and D = 128 or 2 the
// tf32x3 route, other f32 the CUDA-core route).
// splits > 1 (the tf32x3 route only) cuts the key sweep into that many
// runs of whole tiles: out is then a [splits, B, Lq, D] scratch of the
// runs' unnormalised outputs and lse a [splits, B, Lq] scratch of their
// (m, l) float2s, for ofd_flash_fwd_merge. Returns cudaGetLastError()
// after the launch (0 on success).
extern "C" int ofd_flash_fwd(const void* q, const void* k, const void* v,
                             const void* bias, void* out, void* lse, int B,
                             int Lq, int Lk, int C, int D, float scale,
                             int swin_k, int wh, int ww, int sh, int swd,
                             int is_bf16, int route, int splits,
                             void* stream) {
  if (B < 1 || B > 65535 || Lq < 1 || Lk < 1 || !widths_ok(C, D) ||
      swin_k < 0 || !route_takes(route, is_bf16, B, Lq, Lk, C, D) ||
      (splits != 1 && route != TF32X3) || (splits > 1 && lse == nullptr))
    return (int)cudaErrorInvalidValue;
  Swin sw{swin_k, wh, ww, sh, swd};
  cudaStream_t st = (cudaStream_t)stream;
  const bool has_bias = bias != nullptr;
  if (route == TF32X3) {
    if (has_bias)
      return D == 2 ? tf32x3::launch<true, true>(q, k, v, bias, out, lse, B,
                                                 Lq, Lk, scale, sw, splits, st)
                    : tf32x3::launch<false, true>(q, k, v, bias, out, lse, B,
                                                  Lq, Lk, scale, sw, splits,
                                                  st);
    return D == 2 ? tf32x3::launch<true, false>(q, k, v, bias, out, lse, B,
                                                Lq, Lk, scale, sw, splits, st)
                  : tf32x3::launch<false, false>(q, k, v, bias, out, lse, B,
                                                 Lq, Lk, scale, sw, splits, st);
  }
  if (route == WGMMA)
    return C == 256 ? sm90::forward_at<256>(q, k, v, bias, out, lse, B, Lq,
                                            Lk, D, scale, sw, st)
                    : sm90::forward_at<128>(q, k, v, bias, out, lse, B, Lq,
                                            Lk, D, scale, sw, st);
  Narrow kn = narrow(is_bf16 != 0, C, D, has_bias);
  if (kn.smem > SMEM_DEFAULT) {
    const cudaError_t e = cudaFuncSetAttribute(
        kn.fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kn.smem);
    if (e != cudaSuccess) return (int)e;
  }
  void* args[] = {(void*)&q,  (void*)&k,     (void*)&v,  (void*)&bias,
                  (void*)&out, (void*)&lse,  (void*)&Lq, (void*)&Lk,
                  (void*)&C,  (void*)&D,     (void*)&scale, (void*)&sw,
                  (void*)&kn.qres};
  const dim3 grid((unsigned)((Lq + kn.rows - 1) / kn.rows), (unsigned)B,
                  (unsigned)kn.chunks);
  const cudaError_t e =
      cudaLaunchKernel(kn.fn, grid, dim3(kn.threads), args, kn.smem, st);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// out [rows, D] (and lse [rows], or null) from a split sweep's scratches:
// part_o [splits, rows, D], part_ml [splits, rows] (m, l) float2s, merged
// in run order (the tf32x3 route). Returns cudaGetLastError().
extern "C" int ofd_flash_fwd_merge(const void* part_o, const void* part_ml,
                                   void* out, void* lse, long long rows,
                                   int D, int splits, void* stream) {
  if (rows < 1 || D < 1 || splits < 1) return (int)cudaErrorInvalidValue;
  const long long blocks = (rows * D + 255) / 256;
  tf32x3::merge_splits<<<(unsigned)(blocks < 1056 ? blocks : 1056), 256, 0,
                         (cudaStream_t)stream>>>(
      (const float*)part_o, (const float2*)part_ml, (float*)out, (float*)lse,
      rows, D, splits);
  return (int)cudaGetLastError();
}

// A forward kernel as it launches: the kernel, its dynamic shared memory
// and threads a block.
struct FwdKernel {
  const void* fn;
  size_t smem;
  int threads;
};

template <bool P2, bool BIAS>
static FwdKernel tf32_kernel() {
  using K = tf32x3::FwdCfg<P2>;
  return {(const void*)tf32x3::flash_fwd_tf32<P2, BIAS>, K::SMEM, K::THREADS};
}

template <int WGS, bool P2, bool BIAS, int W>
static FwdKernel wgmma_kernel() {
  return {(const void*)sm90::flash_fwd_wgmma<WGS, P2, BIAS, W>,
          sm90::fwd_smem_bytes<WGS, P2, W>(), WGS * 128};
}

template <int W>
static FwdKernel wgmma_kernel(int wgs, bool p2, bool bias) {
  if (p2)
    return bias ? wgmma_kernel<1, true, true, W>()
                : wgmma_kernel<1, true, false, W>();
  if (bias) return wgmma_kernel<2, false, true, W>();
  if constexpr (W == 256)
    return wgmma_kernel<2, false, false, W>();
  else
    return wgs == 3 ? wgmma_kernel<3, false, false, W>()
                    : wgmma_kernel<2, false, false, W>();
}

// The wgmma route's plan (sm90::choose's) and kernel at C = W.
template <int W>
static int wgmma_plan(int B, int Lq, bool p2, bool bias, int* wg,
                      FwdKernel* kern) {
  const int e = p2 ? (bias ? sm90::choose<true, true, W>(B, Lq, wg)
                           : sm90::choose<true, false, W>(B, Lq, wg))
                   : (bias ? sm90::choose<false, true, W>(B, Lq, wg)
                           : sm90::choose<false, false, W>(B, Lq, wg));
  if (!e) *kern = wgmma_kernel<W>(wg[0], p2, bias);
  return e;
}

// What ofd_flash_fwd would launch for these operands (padded widths, with
// a bias or without) on the route C picks by the rule above: plan =
// {route (enum Route), query rows a block, keys a tile, blocks (every
// run's and D chunk's), blocks per SM, waves over the card's SMs, runs of
// the key sweep, D chunks (a grid axis of the mma.sync and CUDA-core
// routes; 1 elsewhere), dynamic shared memory, static shared memory
// (bytes), threads a block, registers a thread, local memory a thread
// (bytes: spills and stack)}. Returns a cudaError_t (0 on success): a
// block the SM cannot hold fails here.
extern "C" int ofd_flash_fwd_plan(int B, int Lq, int Lk, int C, int D,
                                  int is_bf16, int has_bias, int* plan) {
  int dev, sms, per_sm = 0, e;
  if (B < 1 || Lq < 1 || Lk < 1 || !widths_ok(C, D))
    return (int)cudaErrorInvalidValue;
  if ((e = (int)cudaGetDevice(&dev))) return e;
  if ((e = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                       dev)))
    return e;
  const bool p2 = D == 2, bias = has_bias != 0;
  FwdKernel kern;
  int chunks = 1;
  if (!is_bf16 && tf32x3::takes(B, Lq, Lk, C, D)) {
    plan[0] = TF32X3;
    if (bias)
      e = p2 ? tf32x3::choose<true, true>(B, Lq, Lk, sms, plan + 1)
             : tf32x3::choose<false, true>(B, Lq, Lk, sms, plan + 1);
    else
      e = p2 ? tf32x3::choose<true, false>(B, Lq, Lk, sms, plan + 1)
             : tf32x3::choose<false, false>(B, Lq, Lk, sms, plan + 1);
    if (e) return e;
    kern = p2 ? (bias ? tf32_kernel<true, true>() : tf32_kernel<true, false>())
              : (bias ? tf32_kernel<false, true>()
                      : tf32_kernel<false, false>());
  } else if (is_bf16 && sm90::takes(B, Lq, Lk, C, D)) {
    int wg[4];   // {warpgroups a block, blocks, blocks per SM, waves}
    e = C == 256 ? wgmma_plan<256>(B, Lq, p2, bias, wg, &kern)
                 : wgmma_plan<128>(B, Lq, p2, bias, wg, &kern);
    if (e) return e;
    const int got[7] = {WGMMA, wg[0] * sm90::TILE, sm90::TILE, wg[1], wg[2],
                        wg[3], 1};
    for (int i = 0; i < 7; ++i) plan[i] = got[i];
  } else {
    const Narrow kn = narrow(is_bf16 != 0, C, D, bias);
    kern = FwdKernel{kn.fn, kn.smem, kn.threads};
    chunks = kn.chunks;
    const long long n =
        (long long)B * ((Lq + kn.rows - 1) / kn.rows) * kn.chunks;
    // raised as the launch raises it, never lowered: one kernel serves
    // every width, and a launch below the default limit does not set it
    if (kern.smem > SMEM_DEFAULT &&
        (e = (int)cudaFuncSetAttribute(
             kern.fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
             (int)kern.smem)))
      return e;
    if ((e = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, kern.fn, kern.threads, kern.smem)))
      return e;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    const int got[7] = {
        is_bf16 ? MMA_SYNC : F32, kn.rows, kn.keys, (int)n, per_sm,
        (int)((n + (long long)per_sm * sms - 1) / ((long long)per_sm * sms)),
        1};
    for (int i = 0; i < 7; ++i) plan[i] = got[i];
  }
  cudaFuncAttributes attr;
  if ((e = (int)cudaFuncGetAttributes(&attr, kern.fn))) return e;
  const int more[6] = {chunks, (int)kern.smem, (int)attr.sharedSizeBytes,
                       kern.threads, attr.numRegs, (int)attr.localSizeBytes};
  for (int i = 0; i < 6; ++i) plan[7 + i] = more[i];
  return 0;
}
