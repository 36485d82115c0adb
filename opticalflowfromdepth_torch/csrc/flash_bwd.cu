// Flash (streaming-softmax) attention backward, for Hopper (sm_90a).
//
// Replaces the two TPU kernels of opticalflowfromdepth_tpu/ops/flash_bwd.py
// (launched by flash_backward): _bwd_dq_kernel and _bwd_dkv_kernel. Given
// q [B, Lq, C], k [B, Lk, C], v [B, Lk, D], the output gradient g
// [B, Lq, D], the forward's lse [B, Lq] and delta = rowsum(g * out) [B, Lq]
// (both f32), with s = q . k^T * scale [- 100 across Swin regions] [key
// padding -1e30] recomputed per tile:
//   p = exp(s - lse),  dp = g . v^T,  ds = p * (dp - delta)
//   dq = ds . k * scale            (ofd_flash_bwd_dq)
//   dk = ds^T . q * scale, dv = p^T . g      (ofd_flash_bwd_dkv)
// all three f32. The TPU's two passes are kept, so nothing needs atomics
// and every gradient is bit-reproducible:
//   dq: one block per (batch entry, query tile) sweeps the key tiles;
//   dk/dv: one block per (batch entry, key tile) sweeps the query tiles.
// Padded query rows get p = 0 (they add nothing to dk and dv, as the TPU
// kernels' s_eff = -1e30); padded keys get s = -1e30 (p = 0); loads past
// Lq or Lk read zeros, so Lq and Lk need no padding copy. The Swin mask is
// the forward's analytic one (window id = batch index mod K^2, batches
// ordered [b, wy, wx]), the regions computed per row and per column.
//
// What bounds it on this card: at GMFlow's widths (C = 128 or 256, D = C
// or 2) the products, 2 * B * Lq * Lk * (4C + 3D) operations over both
// kernels (each recomputes S and dP; dq adds dS . K, dk/dv P^T . G and
// dS^T . Q), over the tensor cores, and the B * Lq * Lk exponentials of
// each pass over the special-function units; the bytes (q, k, v, g, lse,
// delta read, dq, dk, dv written) are ~1000x less. So each kernel keeps
// the [Lq, Lk] tiles out of device memory, and four routes feed it (the
// caller, ops/flash_bwd.py:plan, names the route):
//
// bf16 at C = 128 and D = 128 or 2 (every GMFlow call), and at C = 256 and
// D = 256 or 2 (GMFlow at 256 channels): the wgmma route, namespace sm90,
// its kernels templated on the width W = C. At C = 128: one block of two
// warpgroups (256 threads) per (batch entry, 128 rows of the output
// side), 64 rows each. The resident side (K and V for dk/dv; Q and G for
// dq) is loaded once by TMA; the other side
// streams in 64-row tiles through a 2-stage ring under mbarriers (full:
// the TMA bytes and the loading warp's 32 cp.async arrivals; empty: every
// thread). TMA boxes of [64 rows][64 columns] land 128-byte swizzled, as
// wgmma's descriptors read them, and zero-fill the rows past L. Per tile
// a warpgroup computes S^T = K Q^T and dP^T = V G^T (dk/dv) or S = Q K^T
// and dP = G V^T (dq) with wgmma m64n64k16, A and B from shared memory,
// both K-major; then p, ds, the mask and the bf16 rounding in registers
// (each 16-column step rounded into its A fragment once final; exp as
// ex2.approx, within the tolerance's allowance for exp); then dV += P^T G
// and dK += dS^T Q (dk/dv) or dQ += dS K (dq) with wgmma m64n128k16, A the
// fragments in registers, B the same ring tile read MN-major through the
// transpose bit. What it does about the mma.sync route's limits:
//   (1) only wgmma reaches the full tensor-core rate: every C- and D-wide
//       product is a wgmma;
//   (2) no B fragment is built from 16-bit shared loads: wgmma reads both
//       layouts of the swizzled tiles itself;
//   (3) no synchronous staging: TMA keeps the next tile in flight while a
//       tile is computed, and the two warpgroups take turns (named
//       barriers) to issue their first products, so that one's
//       exponentials overlap the other's products; warpgroup 1's first
//       warp refills a stage once both have released it;
//   (4) registers: no producer warpgroup, so the launch gives each thread
//       up to 255 (dK's and dV's 64 x 128 f32 accumulators take 64 + 64,
//       S^T and dP^T 32 + 32). With a producer warpgroup (384 threads)
//       ptxas compiled the consumers within the launch's 168 registers
//       whatever setmaxnreg asked, and dk/dv spilled (PERF.md, section 6).
// Registers (ptxas): dk/dv 232 at D = 128, 150 at D = 2; dq 186 and 148;
// no spills. Shared memory a block: 134,144 bytes at D = 128 (K, V or Q, G
// resident; two ring stages), 70,656 at D = 2; one block per SM. At D = 2
// (the matching grid and the propagated flow) the payload rows are 4
// bytes, below TMA's 16-byte box: the loading warp copies them into the
// ring with cp.async (as lse and delta, whose tiles start at unaligned
// b * L), and dP and dv run on the CUDA cores in f32 (the tensor cores
// would waste 63/64 of their work on padding D).
//
// At C = 256 the same kernels (two warpgroups, TMA boxes of 64 columns,
// four panels a row, a 2-stage ring under mbarriers, the turns,
// ex2.approx, dS and P^T rounded to bf16 into A fragments) take other
// tiles, since the C = 128 layout would not fit: two warpgroups' resident
// rows and two 64-row ring stages of both operands take 256 KB, and dK and
// dV of 256 columns would take 256 accumulator registers. So:
//   dq: each warpgroup keeps its 64 queries' Q (and G) resident and its
//   64 x 256 dQ in two 64 x 128 accumulators (128 registers); keys stream
//   in tiles of 32 at D = 256 (S and dP on wgmma m64n32k16, 16 k-steps
//   each; 198,656 bytes a block) and of 64 at D = 2 (m64n64; 135,168);
//   dQ += dS K as two m64n128 products a k16 step, K read MN-major with
//   its 64-column groups one ring panel (32 or 64 rows x 128 bytes) apart.
//   204 registers at D = 256, 214 at D = 2, no spills.
//   dk/dv at D = 256: a block of 64 keys whose K and V both warpgroups
//   share; warpgroup w holds columns [128 w, 128 w + 128) of dK and of dV
//   (64 + 64 registers, as at C = 128), so each computes S^T and dP^T whole
//   over C and D (1.5x the useful products; a build that takes them over
//   half of C and D, tools/flash_bwd_variants.py, runs 10% faster at the
//   windows: the kernel is not bound by the tensor cores, PERF.md);
//   queries stream in 64-row tiles; 199,680 bytes a block, 232
//   registers, no spills.
//   dk/dv at D = 2: a block of 128 keys, 64 a warpgroup, each holding all
//   256 columns of dK (two m64n128 accumulators), dv on the CUDA cores;
//   135,168 bytes, 214 registers, no spills.
//
// Other bf16 widths (C % 16 == 0; D = 2 or D % 16 == 0; any width up to
// MAX_WIDTH, GMFlow at 512 channels' C = 512 with D = 512 or 2 among them;
// ops/flash_bwd.py pads other widths with zero columns): the mma.sync
// route, mma.sync m16n8k16 with 4 warps a block, each owning 16 rows of
// the output; staging by 16-byte cp.async, each stage waited for before a
// barrier (no ring), shared rows padded by 8 bf16. A block takes 128
// columns of its outputs (a grid axis: dq's chunks of C, dk/dv's of C and
// D together), so its accumulators stay at 64 + 64 registers at any width;
// each chunk's blocks recompute S and dP, summed over C and D in panels of
// 128 columns, k-step after k-step in their order at any width. The
// resident side's rows stay in shared memory whole where they fit a block
// (C = D = 512: dq 185,344 bytes, dk/dv 167,936), else a panel at a time
// beside the other side's, so a block fits 227 KB at any width. Every call
// of GMFlow at 512 channels takes it (at 256 channels the wgmma route
// replaced it; launchers(route="mma_sync") still forces it there, to time
// it beside that route).
//   dq: Q and G rows resident (or a panel a time); per 64-key tile K and V
//   a panel at a time, and past C = 128 the tile's 128 chunk columns of K;
//   S = Q K^T and dP = G V^T, then p and ds per element in registers; ds
//   rounded to bf16 and its accumulator fragments used directly as the A
//   fragments of dq += dS . K, so dS never leaves registers.
//   dk/dv: K and V of the block's 64 keys resident (or a panel a time); per
//   32-query tile Q and G a panel at a time, their chunk columns past 128,
//   lse and delta; S^T = K Q^T and dP^T = V G^T computed directly, so P^T
//   (bf16) and dS^T (bf16) are A fragments of dv += P^T . G and dk += dS^T
//   . Q. D == 2: dP and dv on the CUDA cores.
//
// f32 at C = 128 and D = 128 or 2 (every sequence-parallel ring step, and
// every flash call of an f32 GMFlow): the tf32x3 route, namespace tf32x3
// (its products, loads and stores in tf32x3.cuh, shared with the forward).
// Each C- and D-wide product runs on the tensor cores in split TF32: an
// operand x is split in registers into hi = x rounded to TF32 (ties away)
// and lo = x - hi (exact in f32; the tensor cores read its top 10 mantissa
// bits), and a b is summed as a_lo b_hi + a_hi b_lo + a_hi b_hi with
// mma.sync m16n8k8, accumulated in f32 (the lo * lo term and the bits of
// lo that the cores drop are ~2^-21 of |a||b|). One warp owns 16 output
// rows and keeps them in registers; the block's resident rows (Q and G
// for dq, K and V for dk/dv: 64 rows at D = 2, 128 at D = 128) and a
// 2-stage ring of the other side's tiles (64 rows at D = 2, 32 at D = 128;
// with lse and delta for dk/dv) come in by 16-byte cp.async, rows past L
// zero-filled. Shared rows are 132 floats: every fragment load, of a row
// (S = Q K^T) or of a column (dS . K), hits 32 banks. dS's accumulator
// fragments are the A fragments of the next product (its keys relabelled
// within each k8 step), so P and dS stay in registers; exponentials as
// ex2.approx on log2(e)-scaled scores; at D = 2, dP and dv on the CUDA
// cores in f32. Where the card would hold less than one wave of resident
// blocks, the other side's sweep is split (plan's splits): each split
// writes f32 partial sums to a scratch, and a second launch sums them in
// split order, so no atomics and the same bits every launch. Why not
// wgmma: its tf32 operands are read K-major only, so the products over
// the key or query axis (dS . K, dS^T . Q, P^T . G) would need transposed
// copies, and hi and lo pieces of each, in shared memory: four times a
// stage's bytes, past 227 KB at 64-row tiles. mma.sync loads every
// fragment from one row-major copy and splits it in registers.
// Registers (ptxas): dq 181 at D = 2, 183 at D = 128; dk/dv 184 and 239;
// no spills. Shared memory a block: dq 102,400 / 202,752 bytes, dk/dv
// 103,424 / 203,264: two blocks an SM at D = 2, one at D = 128.
//
// Other f32 widths (C % 16 == 0; D = 2 or D % 16 == 0; any width up to
// MAX_WIDTH): f32 FMA on the CUDA cores, no TF32: one thread per output
// row, 64 a block, each block one chunk of 128 output columns (a grid
// axis, as the mma.sync route's; its row sums in shared memory), S and dP
// recomputed per chunk over panels of 128 columns of C and D, the resident
// side whole where it fits a block, else a panel at a time (C = D = 512:
// dq 148,224 bytes, dk/dv 197,632), the other side's tiles read by every
// thread at the same address (broadcast), staged by 4-byte cp.async.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_common.cuh"
#include "tf32x3.cuh"
#define WARPS 4
#define ROWS 64       // output rows per block (16 per warp), bf16 path
#define BK 64         // keys per tile of the dq sweep
#define QT 32         // queries per tile of the dk/dv sweep
#define PAD 8         // bf16 elements appended to each shared row
#define CHUNK 128     // output columns a block takes (a grid axis)
#define PCOLS 128     // columns of C and of D a panel
#define F32_ROWS 64   // output rows (= threads) per block, f32 path
#define F32_T 32      // other-side rows per tile, f32 path
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

// Copy rows [r0, r0 + n) of W columns (W % 8 == 0) of a bf16 matrix whose
// rows are `stride` apart into [n][ld] shared rows by 16-byte cp.async
// copies; rows >= L are zeros. The caller waits and syncs.
__device__ __forceinline__ void stage_rows(bf16* dst, int ld, const bf16* src,
                                           int r0, int n, int L, int W,
                                           int stride) {
  const int vecs = W / 8;
  for (int i = threadIdx.x; i < n * vecs; i += WARPS * 32) {
    const int r = i / vecs, c = (i - r * vecs) * 8;
    const bool ok = r0 + r < L;
    cp_async_16(dst + r * ld + c,
                ok ? src + (long long)(r0 + r) * stride + c : src,
                ok ? 16u : 0u);
  }
}

// Rows [r0, r0 + n) of a [L, 2] bf16 payload as float2; rows >= L are 0.
__device__ __forceinline__ void stage_pairs(float2* dst, const bf16* src,
                                            int r0, int n, int L) {
  for (int r = threadIdx.x; r < n; r += WARPS * 32) {
    float2 val = make_float2(0.f, 0.f);
    if (r0 + r < L)
      val = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(src + (r0 + r) * 2LL));
    dst[r] = val;
  }
}

// A fragment (16 rows x 16 columns, k-step kk) of a shared [.., stride]
// tile whose row `row0` is the warp's first row
__device__ __forceinline__ void load_a(uint32_t* a, const bf16* tile,
                                       int stride, int row0, int kk, int g,
                                       int t) {
  const bf16* p = tile + (row0 + g) * stride + kk * 16 + 2 * t;
  a[0] = load_u32(p);
  a[1] = load_u32(p + 8 * stride);
  a[2] = load_u32(p + 8);
  a[3] = load_u32(p + 8 * stride + 8);
}

// acc[16 x 8NT] += A . B^T over one panel of `w` <= PCOLS columns: A the
// warp's 16 rows of a shared tile (row stride sa) from row `row0`, B the
// 8NT rows of another (row stride sb), both from the panel's first column
template <int NT>
__device__ __forceinline__ void panel_product(float (&acc)[NT][4],
                                              const bf16* a_tile, int sa,
                                              int row0, const bf16* b_tile,
                                              int sb, int w, int g, int t) {
#pragma unroll
  for (int kk = 0; kk < PCOLS / 16; ++kk) {
    if (kk * 16 < w) {
      uint32_t a[4];
      load_a(a, a_tile, sa, row0, kk, g, t);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const bf16* br = b_tile + (nt * 8 + g) * sb + kk * 16 + 2 * t;
        mma_bf16(acc[nt], a, load_u32(br), load_u32(br + 8));
      }
    }
  }
}

// ---------------------------------------------------------------------------
// dq, bf16 operands
// ---------------------------------------------------------------------------

// One block per (64 query rows, batch entry, chunk of CHUNK columns of dq:
// blockIdx.z); each chunk's blocks recompute S and dP. S = Q K^T and dP =
// G V^T are summed over C and D in panels of PCOLS columns (k-step after
// k-step in the order of C and of D at any width): each key tile's K and V
// are staged a panel at a time, with the tile's CHUNK columns of K that
// dS . K reads (past C = PCOLS; within it the one panel is those columns).
// Q's and G's rows are resident for the sweep where they fit a block (res:
// [ROWS][C + PAD] and [ROWS][D + PAD]), else staged a panel at a time
// beside K's and V's.
template <bool PAYLOAD2>
__global__ void __launch_bounds__(WARPS * 32)
flash_bwd_dq_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, const bf16* __restrict__ g,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta, float* __restrict__ dq,
                  int Lq, int Lk, int C, int D, float scale, Swin sw,
                  int res) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int kps = min(C, PCOLS) + PAD, vps = min(D, PCOLS) + PAD;  // panel rows
  const int qs = res ? C + PAD : kps, gs = res ? D + PAD : vps;
  const bool kc_own = C > PCOLS;        // K's chunk apart from its panels
  bf16* Kp = reinterpret_cast<bf16*>(smem);                 // [BK][kps]
  bf16* Vp = Kp + BK * kps;                                 // [BK][vps]
  float2* V2 = reinterpret_cast<float2*>(Vp);               // [BK] (D == 2)
  bf16* Kc = Vp + (PAYLOAD2 ? 4 * BK : BK * vps);           // [BK][kps]
  bf16* Qs = Kc + (kc_own ? BK * kps : 0);                  // [ROWS][qs]
  bf16* Gs = Qs + ROWS * qs;                                // [ROWS][gs]
  if (!kc_own) Kc = Kp;
  __shared__ int kreg_s[BK];          // Swin region of each key of the tile

  const int b = blockIdx.y, q0 = blockIdx.x * ROWS, c0 = blockIdx.z * CHUNK;
  const int cwc = min(CHUNK, C - c0);                 // the chunk's columns
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gi = lane >> 2, t = lane & 3;
  const int rows[2] = {q0 + warp * 16 + gi, q0 + warp * 16 + gi + 8};
  const bf16* qb = q + (long long)b * Lq * C;
  const bf16* kb = k + (long long)b * Lk * C;
  const bf16* vb = v + (long long)b * Lk * D;
  const bf16* gb = g + (long long)b * Lq * D;

  bool last_y, last_x;
  const bool masked = swin_window(sw, b, &last_y, &last_x);
  int qreg[2] = {0, 0};
  float lse_r[2], delta_r[2];
  float2 g2[2] = {make_float2(0.f, 0.f), make_float2(0.f, 0.f)};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const bool ok = rows[r] < Lq;
    lse_r[r] = ok ? lse[(long long)b * Lq + rows[r]] : 0.f;
    delta_r[r] = ok ? delta[(long long)b * Lq + rows[r]] : 0.f;
    if (masked) qreg[r] = swin_region(sw, last_y, last_x, rows[r]);
    if (PAYLOAD2 && ok)
      g2[r] = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
          gb + (long long)rows[r] * 2));
  }
  if (res) {   // published by the first panel's wait and barrier
    stage_rows(Qs, qs, qb, q0, ROWS, Lq, C, C);
    if (!PAYLOAD2) stage_rows(Gs, gs, gb, q0, ROWS, Lq, D, D);
  }
  const int npc = (C + PCOLS - 1) / PCOLS;
  const int npd = PAYLOAD2 ? 0 : (D + PCOLS - 1) / PCOLS;
  const int np = max(npc, npd);

  float acc[CHUNK / 8][4];
#pragma unroll
  for (int i = 0; i < CHUNK / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;

  for (int k0 = 0; k0 < Lk; k0 += BK) {
    // S = Q K^T and dP = G V^T: 16 rows x 64 keys per warp, a panel of C
    // and one of D at a time
    float s[8][4], dp[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.f;
    for (int p = 0; p < np; ++p) {
      const int p0 = p * PCOLS, cw = min(PCOLS, C - p0);
      const int dw = min(PCOLS, D - p0);
      __syncthreads();  // the previous panel (and tile) is consumed
      if (p < npc) {
        stage_rows(Kp, kps, kb + p0, k0, BK, Lk, cw, C);
        if (!res) stage_rows(Qs, qs, qb + p0, q0, ROWS, Lq, cw, C);
      }
      if (p < npd) {
        stage_rows(Vp, vps, vb + p0, k0, BK, Lk, dw, D);
        if (!res) stage_rows(Gs, gs, gb + p0, q0, ROWS, Lq, dw, D);
      }
      if (p == 0) {
        if (PAYLOAD2) stage_pairs(V2, vb, k0, BK, Lk);
        if (kc_own) stage_rows(Kc, kps, kb + c0, k0, BK, Lk, cwc, C);
        if (masked)
          for (int r = threadIdx.x; r < BK; r += WARPS * 32)
            kreg_s[r] = swin_region(sw, last_y, last_x, k0 + r);
      }
      cp_async_wait_all();
      __syncthreads();
      if (p < npc)
        panel_product(s, Qs + (res ? p0 : 0), qs, warp * 16, Kp, kps, cw, gi,
                      t);
      if (p < npd)
        panel_product(dp, Gs + (res ? p0 : 0), gs, warp * 16, Vp, vps, dw,
                      gi, t);
    }
    if (PAYLOAD2) {
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 vv = V2[nt * 8 + 2 * t + (e & 1)];
          const float2 gg = g2[e >> 1];
          dp[nt][e] = fmaf(gg.x, vv.x, gg.y * vv.y);
        }
    }

    // p = exp(s - lse) with the scale, the Swin mask and the key padding;
    // ds = p (dp - delta), kept in s
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kl = nt * 8 + 2 * t + (e & 1), r = e >> 1;
        float x = s[nt][e] * scale;
        if (masked && kreg_s[kl] != qreg[r]) x = x - 100.f;
        if (k0 + kl >= Lk) x = NEG_INF;
        const float p = rows[r] < Lq ? expf(x - lse_r[r]) : 0.f;
        s[nt][e] = p * (dp[nt][e] - delta_r[r]);
      }
    }

    // dq += dS . K: dS's accumulator fragments (rounded to bf16) are the A
    // fragments; K's rows 2t, 2t+1 (+8) of each 16-key step the B ones
#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks) {
      const uint32_t a[4] = {pack_f32(s[2 * ks][0], s[2 * ks][1]),
                             pack_f32(s[2 * ks][2], s[2 * ks][3]),
                             pack_f32(s[2 * ks + 1][0], s[2 * ks + 1][1]),
                             pack_f32(s[2 * ks + 1][2], s[2 * ks + 1][3])};
      const bf16* kr = Kc + (ks * 16 + 2 * t) * kps + gi;
#pragma unroll
      for (int nt = 0; nt < CHUNK / 8; ++nt) {
        if (nt * 8 < cwc) {
          const bf16* p = kr + nt * 8;
          mma_bf16(acc[nt], a, pack_bf16(p[0], p[kps]),
                   pack_bf16(p[8 * kps], p[9 * kps]));
        }
      }
    }
  }

  float* dqb = dq + (long long)b * Lq * C + c0;
#pragma unroll
  for (int nt = 0; nt < CHUNK / 8; ++nt) {
    if (nt * 8 < cwc) {
#pragma unroll
      for (int r = 0; r < 2; ++r)
        if (rows[r] < Lq)
          *reinterpret_cast<float2*>(dqb + (long long)rows[r] * C + nt * 8 +
                                     2 * t) =
              make_float2(acc[nt][2 * r] * scale, acc[nt][2 * r + 1] * scale);
    }
  }
}

// ---------------------------------------------------------------------------
// dk and dv, bf16 operands
// ---------------------------------------------------------------------------

// One block per (64 key rows, batch entry, chunk z of CHUNK columns: dk's
// columns [z CHUNK, (z + 1) CHUNK) and dv's the same); each chunk's blocks
// recompute S^T and dP^T, summed over C and D in panels of PCOLS columns:
// each query tile's Q and G are staged a panel at a time, with the tile's
// chunk columns of Q (for dS^T . Q) and of G (for P^T . G) past C or D =
// PCOLS. K's and V's rows are resident for the sweep where they fit a block
// (res), else staged a panel at a time beside Q's and G's.
template <bool PAYLOAD2>
__global__ void __launch_bounds__(WARPS * 32)
flash_bwd_dkv_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, const bf16* __restrict__ g,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta, float* __restrict__ dk,
                   float* __restrict__ dv, int Lq, int Lk, int C, int D,
                   float scale, Swin sw, int res) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int kps = min(C, PCOLS) + PAD, vps = min(D, PCOLS) + PAD;  // panel rows
  const int ks_ = res ? C + PAD : kps, vs_ = res ? D + PAD : vps;
  const bool qc_own = C > PCOLS, gc_own = !PAYLOAD2 && D > PCOLS;
  bf16* Qp = reinterpret_cast<bf16*>(smem);                 // [QT][kps]
  bf16* Gp = Qp + QT * kps;                                 // [QT][vps]
  float2* G2 = reinterpret_cast<float2*>(Gp);               // [QT] (D == 2)
  bf16* Qc = Gp + (PAYLOAD2 ? 4 * QT : QT * vps);           // [QT][kps]
  bf16* Gc = Qc + (qc_own ? QT * kps : 0);                  // [QT][vps]
  bf16* Ks = Gc + (gc_own ? QT * vps : 0);                  // [ROWS][ks_]
  bf16* Vs = Ks + ROWS * ks_;                               // [ROWS][vs_]
  if (!qc_own) Qc = Qp;
  if (!gc_own) Gc = Gp;
  __shared__ float lse_s[QT], delta_s[QT];
  __shared__ int qreg_s[QT];

  const int b = blockIdx.y, k0 = blockIdx.x * ROWS, c0 = blockIdx.z * CHUNK;
  const int cwk = min(CHUNK, C - c0), cwv = min(CHUNK, D - c0);  // may be <= 0
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gi = lane >> 2, t = lane & 3;
  const int rows[2] = {k0 + warp * 16 + gi, k0 + warp * 16 + gi + 8};
  const bf16* qb = q + (long long)b * Lq * C;
  const bf16* kb = k + (long long)b * Lk * C;
  const bf16* vb = v + (long long)b * Lk * D;
  const bf16* gb = g + (long long)b * Lq * D;

  bool last_y, last_x;
  const bool masked = swin_window(sw, b, &last_y, &last_x);
  int kreg[2] = {0, 0};
  float2 v2[2] = {make_float2(0.f, 0.f), make_float2(0.f, 0.f)};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (masked) kreg[r] = swin_region(sw, last_y, last_x, rows[r]);
    if (PAYLOAD2 && rows[r] < Lk)
      v2[r] = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
          vb + (long long)rows[r] * 2));
  }
  if (res) {   // published by the first panel's wait and barrier
    stage_rows(Ks, ks_, kb, k0, ROWS, Lk, C, C);
    if (!PAYLOAD2) stage_rows(Vs, vs_, vb, k0, ROWS, Lk, D, D);
  }
  const int npc = (C + PCOLS - 1) / PCOLS;
  const int npd = PAYLOAD2 ? 0 : (D + PCOLS - 1) / PCOLS;
  const int np = max(npc, npd);

  constexpr int DT = PAYLOAD2 ? 1 : CHUNK / 8;
  float dka[CHUNK / 8][4], dva[DT][4];
#pragma unroll
  for (int i = 0; i < CHUNK / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[i][e] = 0.f;
#pragma unroll
  for (int i = 0; i < DT; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dva[i][e] = 0.f;

  for (int q0 = 0; q0 < Lq; q0 += QT) {
    // S^T = K Q^T and dP^T = V G^T: 16 keys x 32 queries per warp, a panel
    // of C and one of D at a time
    float s[QT / 8][4], dp[QT / 8][4];
#pragma unroll
    for (int nt = 0; nt < QT / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.f;
    for (int p = 0; p < np; ++p) {
      const int p0 = p * PCOLS, cw = min(PCOLS, C - p0);
      const int dw = min(PCOLS, D - p0);
      __syncthreads();  // the previous panel (and tile) is consumed
      if (p < npc) {
        stage_rows(Qp, kps, qb + p0, q0, QT, Lq, cw, C);
        if (!res) stage_rows(Ks, ks_, kb + p0, k0, ROWS, Lk, cw, C);
      }
      if (p < npd) {
        stage_rows(Gp, vps, gb + p0, q0, QT, Lq, dw, D);
        if (!res) stage_rows(Vs, vs_, vb + p0, k0, ROWS, Lk, dw, D);
      }
      if (p == 0) {
        if (PAYLOAD2) stage_pairs(G2, gb, q0, QT, Lq);
        if (qc_own && cwk > 0) stage_rows(Qc, kps, qb + c0, q0, QT, Lq, cwk, C);
        if (gc_own && cwv > 0) stage_rows(Gc, vps, gb + c0, q0, QT, Lq, cwv, D);
        for (int r = threadIdx.x; r < QT; r += WARPS * 32) {
          const bool ok = q0 + r < Lq;
          lse_s[r] = ok ? lse[(long long)b * Lq + q0 + r] : 0.f;
          delta_s[r] = ok ? delta[(long long)b * Lq + q0 + r] : 0.f;
          if (masked) qreg_s[r] = swin_region(sw, last_y, last_x, q0 + r);
        }
      }
      cp_async_wait_all();
      __syncthreads();
      if (p < npc)
        panel_product(s, Ks + (res ? p0 : 0), ks_, warp * 16, Qp, kps, cw,
                      gi, t);
      if (p < npd)
        panel_product(dp, Vs + (res ? p0 : 0), vs_, warp * 16, Gp, vps, dw,
                      gi, t);
    }
    if (PAYLOAD2) {
#pragma unroll
      for (int nt = 0; nt < QT / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 gg = G2[nt * 8 + 2 * t + (e & 1)];
          const float2 vv = v2[e >> 1];
          dp[nt][e] = fmaf(gg.x, vv.x, gg.y * vv.y);
        }
    }

    // p^T in s, ds^T in dp
#pragma unroll
    for (int nt = 0; nt < QT / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ql = nt * 8 + 2 * t + (e & 1), r = e >> 1;
        float x = s[nt][e] * scale;
        if (masked && qreg_s[ql] != kreg[r]) x = x - 100.f;
        if (rows[r] >= Lk) x = NEG_INF;
        const float p = q0 + ql < Lq ? expf(x - lse_s[ql]) : 0.f;
        s[nt][e] = p;
        dp[nt][e] = p * (dp[nt][e] - delta_s[ql]);
      }
    }

    // dv += P^T . G and dk += dS^T . Q, P^T and dS^T rounded to bf16
#pragma unroll
    for (int ks = 0; ks < QT / 16; ++ks) {
      if (PAYLOAD2) {
        // dva[0] = {key row 0 d0, d1, key row 1 d0, d1}, own queries only
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float pb =
                __bfloat162float(__float2bfloat16(s[2 * ks + h][e]));
            const float2 gg = G2[(2 * ks + h) * 8 + 2 * t + (e & 1)];
            const int r = e >> 1;
            dva[0][2 * r] = fmaf(pb, gg.x, dva[0][2 * r]);
            dva[0][2 * r + 1] = fmaf(pb, gg.y, dva[0][2 * r + 1]);
          }
      } else {
        const uint32_t a[4] = {pack_f32(s[2 * ks][0], s[2 * ks][1]),
                               pack_f32(s[2 * ks][2], s[2 * ks][3]),
                               pack_f32(s[2 * ks + 1][0], s[2 * ks + 1][1]),
                               pack_f32(s[2 * ks + 1][2], s[2 * ks + 1][3])};
        const bf16* gr = Gc + (ks * 16 + 2 * t) * vps + gi;
#pragma unroll
        for (int nt = 0; nt < DT; ++nt) {
          if (nt * 8 < cwv) {
            const bf16* p = gr + nt * 8;
            mma_bf16(dva[nt], a, pack_bf16(p[0], p[vps]),
                     pack_bf16(p[8 * vps], p[9 * vps]));
          }
        }
      }
      const uint32_t a[4] = {pack_f32(dp[2 * ks][0], dp[2 * ks][1]),
                             pack_f32(dp[2 * ks][2], dp[2 * ks][3]),
                             pack_f32(dp[2 * ks + 1][0], dp[2 * ks + 1][1]),
                             pack_f32(dp[2 * ks + 1][2], dp[2 * ks + 1][3])};
      const bf16* qr = Qc + (ks * 16 + 2 * t) * kps + gi;
#pragma unroll
      for (int nt = 0; nt < CHUNK / 8; ++nt) {
        if (nt * 8 < cwk) {
          const bf16* p = qr + nt * 8;
          mma_bf16(dka[nt], a, pack_bf16(p[0], p[kps]),
                   pack_bf16(p[8 * kps], p[9 * kps]));
        }
      }
    }
  }

  float* dkb = dk + (long long)b * Lk * C + c0;
  float* dvb = dv + (long long)b * Lk * D + c0;
#pragma unroll
  for (int nt = 0; nt < CHUNK / 8; ++nt) {
    if (nt * 8 < cwk) {
#pragma unroll
      for (int r = 0; r < 2; ++r)
        if (rows[r] < Lk)
          *reinterpret_cast<float2*>(dkb + (long long)rows[r] * C + nt * 8 +
                                     2 * t) =
              make_float2(dka[nt][2 * r] * scale, dka[nt][2 * r + 1] * scale);
    }
  }
  if (PAYLOAD2) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      dva[0][e] += __shfl_xor_sync(0xffffffffu, dva[0][e], 1);
      dva[0][e] += __shfl_xor_sync(0xffffffffu, dva[0][e], 2);
    }
    if (t == 0 && c0 == 0) {
#pragma unroll
      for (int r = 0; r < 2; ++r)
        if (rows[r] < Lk)
          *reinterpret_cast<float2*>(dvb + (long long)rows[r] * 2) =
              make_float2(dva[0][2 * r], dva[0][2 * r + 1]);
    }
  } else {
#pragma unroll
    for (int nt = 0; nt < DT; ++nt) {
      if (nt * 8 < cwv) {
#pragma unroll
        for (int r = 0; r < 2; ++r)
          if (rows[r] < Lk)
            *reinterpret_cast<float2*>(dvb + (long long)rows[r] * D +
                                       nt * 8 + 2 * t) =
                make_float2(dva[nt][2 * r], dva[nt][2 * r + 1]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 operands at C = 128 and D = 128 or 2, and at C = 256 and D = 256 or
// 2: the wgmma route
// ---------------------------------------------------------------------------

namespace sm90 {

using namespace hopper;

constexpr int WG = 2;                     // warpgroups a block
constexpr int THREADS = WG * 128;
constexpr int STAGES = 2;
constexpr int LOADER = 4;  // the warp that refills the ring: warpgroup 1's
                           // first, as warpgroup 1 takes its turns second

// One block's shared memory: RG resident groups of 64 rows (the C-wide
// operand in CP 64-column panels, and the D-wide one when D = C) loaded
// once, and a ring of STAGES tiles of ST streamed rows (the C-wide operand,
// the D-wide one or its bf16 pairs at D = 2, and for dk/dv lse and delta).
// Every panel is a TMA box in the 128-byte swizzle that wgmma reads; a
// ring panel is [ST rows][64], so its 64-column groups lie ST * 128 bytes
// apart. The pairs, lse and delta are rows of 4 bytes, whose tiles start
// wherever b * L puts them (TMA wants 16-byte aligned boxes), so the
// loading warp copies them itself.
template <int RG, int ST, int CP, bool P2>
struct Smem {
  alignas(1024) bf16 rc[RG][CP][PANEL];
  alignas(1024) bf16 rd[P2 ? 1 : RG][P2 ? 1 : CP][P2 ? 8 : PANEL];
  alignas(1024) bf16 sc[STAGES][CP][ST * 64];
  alignas(1024) bf16 sd[STAGES][P2 ? 1 : CP][P2 ? 2 * ST : ST * 64];
  float lse[STAGES][ST], delta[STAGES][ST];
  uint64_t res_full, full[STAGES], empty[STAGES];
};

// The kernels' layouts at width W = C (128 or 256). dq: two warpgroups'
// 64 queries resident, the keys streamed in tiles of KT; at W = 256, D =
// 256 tiles of 32 (64-row tiles would put the block past 227 KB). dk/dv:
// the queries streamed in tiles of 64; the resident keys two groups of 64,
// one a warpgroup with all W columns of dK and dV, except at W = 256, D =
// 256 (SPLIT): one group of 64 keys that both warpgroups share, warpgroup w
// holding columns [128 w, 128 w + 128) of dK and of dV.
template <bool P2, int W>
struct Dq {
  static constexpr int KT = W == 256 && !P2 ? 32 : 64;
  using SM = Smem<2, KT, W / 64, P2>;
};

template <bool P2, int W>
struct Dkv {
  static constexpr bool SPLIT = W == 256 && !P2;
  static constexpr int RG = SPLIT ? 1 : 2;
  using SM = Smem<RG, TILE, W / 64, P2>;
};

template <class SM>
constexpr size_t smem_bytes() {
  return sizeof(SM) + 1024;  // + the slack to align the base to 1 KB
}

template <class SM>
__device__ __forceinline__ SM& shared_storage() {
  extern __shared__ unsigned char smem_raw[];
  return *reinterpret_cast<SM*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);
}

template <class SM>
__device__ __forceinline__ void init_barriers(SM& sm) {
  if (threadIdx.x == 0) {
    mbar_init(&sm.res_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&sm.full[s], 32);         // every loading lane arrives
      mbar_init(&sm.empty[s], THREADS);   // every thread arrives
    }
    mbar_fence_init();
  }
  __syncthreads();
}

// The loads of one block. Thread 0 issues the resident tiles' TMA loads
// once. The loading warp fills ring stages: its lane 0 issues the TMA
// loads of a tile's panels; its 32 lanes copy the tile's 4-byte rows (lse
// and delta for dk/dv, the bf16 pairs at D = 2; zeros past Ls) with
// cp.async, each lane's arrival on the stage's barrier made when its
// copies land; the barrier also waits for the TMA bytes.
template <int RG, int ST, int CP, bool P2, bool DKV>
struct Loads {
  using SM = Smem<RG, ST, CP, P2>;
  const CUtensorMap *rc, *rd, *sc, *sd;  // resident, then streamed, maps
  const uint32_t* pairs;
  const float *lse, *delta;
  int b, r0, Ls;  // batch entry, first resident row, streamed length

  __device__ __forceinline__ void resident(SM& sm) const {
    mbar_expect_tx(&sm.res_full, (P2 ? 1 : 2) * RG * CP * PANEL_BYTES);
    for (int w = 0; w < RG; ++w)
      for (int p = 0; p < CP; ++p) {
        tma_load_3d(sm.rc[w][p], rc, &sm.res_full, p * 64, r0 + w * TILE, b);
        if constexpr (!P2)
          tma_load_3d(sm.rd[w][p], rd, &sm.res_full, p * 64, r0 + w * TILE,
                      b);
      }
  }

  __device__ __forceinline__ void stage(SM& sm, int it, int lane) const {
    const int s = it % STAGES, s0 = it * ST;
    if (lane == 0) {
      mbar_expect_tx_only(&sm.full[s], (P2 ? 1 : 2) * CP * ST * 128);
      for (int p = 0; p < CP; ++p) {
        tma_load_3d(sm.sc[s][p], sc, &sm.full[s], p * 64, s0, b);
        if constexpr (!P2)
          tma_load_3d(sm.sd[s][p], sd, &sm.full[s], p * 64, s0, b);
      }
    }
    __syncwarp();  // the bytes are expected before any lane can arrive
    const long long base = (long long)b * Ls + s0;
#pragma unroll
    for (int i = lane; i < ST; i += 32) {
      const long long at = s0 + i < Ls ? base + i : 0;  // row, or zeros
      const uint32_t n = s0 + i < Ls ? 4 : 0;
      if constexpr (P2) cp_async_4(&sm.sd[s][0][2 * i], pairs + at, n);
      if constexpr (DKV) {
        cp_async_4(&sm.lse[s][i], lse + at, n);
        cp_async_4(&sm.delta[s][i], delta + at, n);
      }
    }
    cp_async_arrive(&sm.full[s]);
  }

  // the resident tiles and the first ring stages, before the sweep
  __device__ __forceinline__ void start(SM& sm, int n_tiles) const {
    if (threadIdx.x == 0) resident(sm);
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

// dk/dv: one block per (batch entry, 64 RG keys); the query side streams
// in tiles of 64. tm_q, tm_k and (at D = C) tm_v and tm_g are 3-D maps of
// [B, L, W] in [1, 64, 64] boxes; at D = 2 the pairs of v and g are read
// from the pointers.
template <bool P2, int W>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dkv_wgmma(const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v,
                    const __grid_constant__ CUtensorMap tm_g,
                    const bf16* __restrict__ v, const bf16* __restrict__ g,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, float* __restrict__ dk,
                    float* __restrict__ dv, int Lq, int Lk, float scale,
                    Swin sw) {
  using K = Dkv<P2, W>;
  constexpr int RG = K::RG;
  constexpr int DKH = K::SPLIT ? 1 : W / 128;  // 128-column parts of dK held
  using SM = typename K::SM;
  SM& sm = shared_storage<SM>();
  const int b = blockIdx.y, k0 = blockIdx.x * RG * TILE;
  const int n_tiles = (Lq + TILE - 1) / TILE;
  const int wg = threadIdx.x / 128;
  init_barriers(sm);
  const Loads<RG, TILE, W / 64, P2, true> loads{
      &tm_k, &tm_v, &tm_q, &tm_g, reinterpret_cast<const uint32_t*>(g), lse,
      delta, b, k0, Lq};
  loads.start(sm, n_tiles);
  const int kg = K::SPLIT ? 0 : wg;        // the warpgroup's group of keys
  const int c0 = K::SPLIT ? 128 * wg : 0;  // its first column of dK and dV
  const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, t = lane & 3;
  const int row0 = k0 + kg * TILE + warp * 16 + gq;  // keys row0, row0 + 8
  const bool idle = k0 + kg * TILE >= Lk;
  bool last_y, last_x;
  const bool masked = swin_window(sw, b, &last_y, &last_x);
  int kreg[2] = {0, 0};
  bool kok[2];
  float2 v2[2] = {make_float2(0.f, 0.f), make_float2(0.f, 0.f)};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = row0 + 8 * r;
    kok[r] = key < Lk;
    if (masked) kreg[r] = swin_region(sw, last_y, last_x, key);
    if (P2 && kok[r])
      v2[r] = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
          v + ((long long)b * Lk + key) * 2));
  }
  float dka[DKH][64], dva[P2 ? 4 : 64];
#pragma unroll
  for (int h = 0; h < DKH; ++h)
#pragma unroll
    for (int i = 0; i < 64; ++i) dka[h][i] = 0.f;
#pragma unroll
  for (int i = 0; i < (P2 ? 4 : 64); ++i) dva[i] = 0.f;
  const bf16* kres = sm.rc[kg][0];
  const bf16* vres = sm.rd[P2 ? 0 : kg][0];
  mbar_wait(&sm.res_full, 0);
  if (wg == 1) turn_pass(1);  // warpgroup 0 goes first

  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % STAGES, q0 = it * TILE;
    mbar_wait(&sm.full[s], (it / STAGES) & 1);
    // S^T = K Q^T and dP^T = V G^T: 64 keys x 64 queries
    const bool pass = wg == 0 || it + 1 < n_tiles;  // matched by a wait
    turn_wait(wg);
    if (idle) {
      if (pass) turn_pass(wg);
    } else {
      float st[32], dpt[32];
      wgmma_fence();
      product_c<W, TILE>(st, kres, sm.sc[s][0]);
      if constexpr (!P2) product_c<W, TILE>(dpt, vres, sm.sd[s][0]);
      wgmma_commit();
      if (pass) turn_pass(wg);
      wgmma_wait<0>();
      fence_regs(st);
      if constexpr (!P2) fence_regs(dpt);

      // p^T into st, ds^T into dpt; at D = 2, dP^T and dv on the CUDA
      // cores from the pairs
      const uint32_t cregs =
          masked ? col_regions(sw, last_y, last_x, q0, t) : 0u;
      const float2* lse2 = reinterpret_cast<const float2*>(sm.lse[s]);
      const float2* del2 = reinterpret_cast<const float2*>(sm.delta[s]);
      const __nv_bfloat162* g2 =
          reinterpret_cast<const __nv_bfloat162*>(sm.sd[s][0]);
      uint32_t pa[16], da[16];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = 8 * j + 2 * t;
        const float2 l = lse2[c >> 1], dl = del2[c >> 1];
        float2 gp[2];
        if constexpr (P2) {
#pragma unroll
          for (int e = 0; e < 2; ++e)
            gp[e] = q0 + c + e < Lq ? __bfloat1622float2(g2[c + e])
                                    : make_float2(0.f, 0.f);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int ce = e & 1, r = e >> 1, i = 4 * j + e;
          const bool qok = q0 + c + ce < Lq;
          float x = st[i] * scale;
          if (masked && other_region(cregs, j, e, kreg[r])) x = x - 100.f;
          if (!kok[r]) x = NEG_INF;
          const float p = qok ? __expf(x - (ce ? l.y : l.x)) : 0.f;
          float dp;
          if constexpr (P2) {
            dp = fmaf(gp[ce].x, v2[r].x, gp[ce].y * v2[r].y);
            const float pb = __bfloat162float(__float2bfloat16(p));
            dva[2 * r] = fmaf(pb, gp[ce].x, dva[2 * r]);
            dva[2 * r + 1] = fmaf(pb, gp[ce].y, dva[2 * r + 1]);
          } else {
            dp = dpt[i];
          }
          st[i] = p;
          dpt[i] = qok ? p * (dp - (ce ? dl.y : dl.x)) : 0.f;
        }
        if (j & 1) {  // a k16 step done: round it into its fragments
          to_a_frag(dpt, da, j >> 1);
          if constexpr (!P2) to_a_frag(st, pa, j >> 1);
        }
      }

      // dv += P^T G and dk += dS^T Q, P^T and dS^T rounded to bf16 in
      // registers, G and Q the same ring tiles read MN-major, 128 columns
      // a product
      wgmma_fence();
      if constexpr (!P2) product_rs(dva, pa, sm.sd[s][c0 / 64]);
#pragma unroll
      for (int h = 0; h < DKH; ++h)
        product_rs(dka[h], da, sm.sc[s][c0 / 64 + 2 * h]);
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int h = 0; h < DKH; ++h) fence_regs(dka[h]);
      if constexpr (!P2) fence_regs(dva);
    }
    mbar_arrive(&sm.empty[s]);
    loads.refill(sm, it, n_tiles);
  }

  if (!idle) {
    if constexpr (P2) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        dva[e] += __shfl_xor_sync(0xffffffffu, dva[e], 1);
        dva[e] += __shfl_xor_sync(0xffffffffu, dva[e], 2);
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (!kok[r]) continue;
      const long long row = (long long)b * Lk + row0 + 8 * r;
#pragma unroll
      for (int h = 0; h < DKH; ++h)
#pragma unroll
        for (int j = 0; j < 16; ++j)
          *reinterpret_cast<float2*>(dk + row * W + c0 + 128 * h + 8 * j +
                                     2 * t) =
              make_float2(dka[h][4 * j + 2 * r] * scale,
                          dka[h][4 * j + 2 * r + 1] * scale);
      if constexpr (P2) {
        if (t == 0)
          *reinterpret_cast<float2*>(dv + row * 2) =
              make_float2(dva[2 * r], dva[2 * r + 1]);
      } else {
#pragma unroll
        for (int j = 0; j < 16; ++j)
          *reinterpret_cast<float2*>(dv + row * W + c0 + 8 * j + 2 * t) =
              make_float2(dva[4 * j + 2 * r], dva[4 * j + 2 * r + 1]);
      }
    }
  }
}

// dq: one block per (batch entry, 128 queries), 64 queries per warpgroup,
// each holding its rows' W columns of dQ (W / 128 accumulators of 64 x
// 128); the key side streams in tiles of KT. tm_q and tm_g are 3-D maps of
// [B, L, W] in [1, 64, 64] boxes, tm_k and tm_v in [1, KT, 64] boxes; each
// thread reads lse, delta and (at D = 2) g's pair for its two rows itself.
template <bool P2, int W>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dq_wgmma(const __grid_constant__ CUtensorMap tm_q,
                   const __grid_constant__ CUtensorMap tm_k,
                   const __grid_constant__ CUtensorMap tm_v,
                   const __grid_constant__ CUtensorMap tm_g,
                   const bf16* __restrict__ v, const bf16* __restrict__ g,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta, float* __restrict__ dq,
                   int Lq, int Lk, float scale, Swin sw) {
  constexpr int KT = Dq<P2, W>::KT, H = W / 128;
  using SM = typename Dq<P2, W>::SM;
  SM& sm = shared_storage<SM>();
  const int b = blockIdx.y, q0 = blockIdx.x * WG * TILE;
  const int n_tiles = (Lk + KT - 1) / KT;
  const int wg = threadIdx.x / 128;
  init_barriers(sm);
  const Loads<2, KT, W / 64, P2, false> loads{
      &tm_q, &tm_g, &tm_k, &tm_v, reinterpret_cast<const uint32_t*>(v),
      nullptr, nullptr, b, q0, Lk};
  loads.start(sm, n_tiles);
  const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, t = lane & 3;
  const int row0 = q0 + wg * TILE + warp * 16 + gq;  // rows row0, row0 + 8
  const bool idle = q0 + wg * TILE >= Lq;
  bool last_y, last_x;
  const bool masked = swin_window(sw, b, &last_y, &last_x);
  int qreg[2] = {0, 0};
  bool qok[2];
  float lse_r[2] = {0.f, 0.f}, delta_r[2] = {0.f, 0.f};
  float2 g2[2] = {make_float2(0.f, 0.f), make_float2(0.f, 0.f)};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    qok[r] = row < Lq;
    if (masked) qreg[r] = swin_region(sw, last_y, last_x, row);
    if (qok[r]) {
      lse_r[r] = lse[(long long)b * Lq + row];
      delta_r[r] = delta[(long long)b * Lq + row];
      if (P2)
        g2[r] = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
            g + ((long long)b * Lq + row) * 2));
    }
  }
  float dqa[H][64];
#pragma unroll
  for (int h = 0; h < H; ++h)
#pragma unroll
    for (int i = 0; i < 64; ++i) dqa[h][i] = 0.f;
  const bf16* qres = sm.rc[wg][0];
  const bf16* gres = sm.rd[P2 ? 0 : wg][0];
  mbar_wait(&sm.res_full, 0);
  if (wg == 1) turn_pass(1);  // warpgroup 0 goes first

  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % STAGES, k0 = it * KT;
    mbar_wait(&sm.full[s], (it / STAGES) & 1);
    // S = Q K^T and dP = G V^T: 64 queries x KT keys
    const bool pass = wg == 0 || it + 1 < n_tiles;  // matched by a wait
    turn_wait(wg);
    if (idle) {
      if (pass) turn_pass(wg);
    } else {
      float sa[KT / 2], dp[KT / 2];
      wgmma_fence();
      product_c<W, KT>(sa, qres, sm.sc[s][0]);
      if constexpr (!P2) product_c<W, KT>(dp, gres, sm.sd[s][0]);
      wgmma_commit();
      if (pass) turn_pass(wg);
      wgmma_wait<0>();
      fence_regs(sa);
      if constexpr (!P2) fence_regs(dp);

      // ds = p (dp - delta) into sa
      const uint32_t cregs =
          masked ? col_regions<KT / 8>(sw, last_y, last_x, k0, t) : 0u;
      const __nv_bfloat162* v2 =
          reinterpret_cast<const __nv_bfloat162*>(sm.sd[s][0]);
      uint32_t da[KT / 4];
#pragma unroll
      for (int j = 0; j < KT / 8; ++j) {
        const int c = 8 * j + 2 * t;
        float2 vp[2];
        if constexpr (P2) {
#pragma unroll
          for (int e = 0; e < 2; ++e)
            vp[e] = k0 + c + e < Lk ? __bfloat1622float2(v2[c + e])
                                    : make_float2(0.f, 0.f);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int ce = e & 1, r = e >> 1, i = 4 * j + e;
          float x = sa[i] * scale;
          if (masked && other_region(cregs, j, e, qreg[r])) x = x - 100.f;
          if (k0 + c + ce >= Lk) x = NEG_INF;
          const float p = qok[r] ? __expf(x - lse_r[r]) : 0.f;
          float dpv;
          if constexpr (P2)
            dpv = fmaf(g2[r].x, vp[ce].x, g2[r].y * vp[ce].y);
          else
            dpv = dp[i];
          sa[i] = qok[r] ? p * (dpv - delta_r[r]) : 0.f;
        }
        if (j & 1) to_a_frag(sa, da, j >> 1);
      }

      // dq += dS K: dS rounded to bf16 in registers, K the ring tile
      // read MN-major, 128 columns a product
      wgmma_fence();
#pragma unroll
      for (int h = 0; h < H; ++h)
        product_rs<KT>(dqa[h], da, sm.sc[s][2 * h]);
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int h = 0; h < H; ++h) fence_regs(dqa[h]);
    }
    mbar_arrive(&sm.empty[s]);
    loads.refill(sm, it, n_tiles);
  }

  if (!idle) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (!qok[r]) continue;
      const long long row = (long long)b * Lq + row0 + 8 * r;
#pragma unroll
      for (int h = 0; h < H; ++h)
#pragma unroll
        for (int j = 0; j < 16; ++j)
          *reinterpret_cast<float2*>(dq + row * W + 128 * h + 8 * j +
                                     2 * t) =
              make_float2(dqa[h][4 * j + 2 * r] * scale,
                          dqa[h][4 * j + 2 * r + 1] * scale);
    }
  }
}

// The widths this route takes: GMFlow's (C = 128; D = 128, or 2 for the
// matching grid and the propagated flow) and GMFlow at 256 channels' (C =
// 256; D = 256 or 2), with B * L within TMA's int32 coordinates.
static bool takes(int B, int Lq, int Lk, int C, int D) {
  return (C == 128 || C == 256) && (D == C || D == 2) &&
         (long long)B * (Lq > Lk ? Lq : Lk) < (1ll << 31);
}

// The 3-D maps of q, k and, at D = W, of v and g ([B, L, W] bf16 in [1,
// rows, 64] boxes: q and g 64 rows, k and v `krows`); at D = 2 the maps of
// v and g are copies of k's and q's that the kernels do not read.
static int tensor_maps(CUtensorMap (&m)[4], const void* q, const void* k,
                       const void* v, const void* g, int B, int Lq, int Lk,
                       int W, int D, int krows) {
  int e;
  if ((e = tensor_map_bf16_3d(&m[0], q, W, Lq, B, TILE))) return e;
  if ((e = tensor_map_bf16_3d(&m[1], k, W, Lk, B, krows))) return e;
  if (D == 2) {
    m[2] = m[1];
    m[3] = m[0];
    return 0;
  }
  if ((e = tensor_map_bf16_3d(&m[2], v, W, Lk, B, krows))) return e;
  return tensor_map_bf16_3d(&m[3], g, W, Lq, B, TILE);
}

template <bool P2, int W>
static int launch_dkv(const void* q, const void* k, const void* v,
                      const void* g, const void* lse, const void* delta,
                      void* dk, void* dv, int B, int Lq, int Lk, float scale,
                      Swin sw, cudaStream_t st) {
  CUtensorMap m[4];
  int e;
  if ((e = tensor_maps(m, q, k, v, g, B, Lq, Lk, W, P2 ? 2 : W, TILE)))
    return e;
  const size_t smem = smem_bytes<typename Dkv<P2, W>::SM>();
  if ((e = (int)cudaFuncSetAttribute(
           flash_bwd_dkv_wgmma<P2, W>,
           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem)))
    return e;
  const int rows = Dkv<P2, W>::RG * TILE;
  const dim3 grid((unsigned)((Lk + rows - 1) / rows), (unsigned)B);
  flash_bwd_dkv_wgmma<P2, W><<<grid, THREADS, smem, st>>>(
      m[0], m[1], m[2], m[3], (const bf16*)v, (const bf16*)g,
      (const float*)lse, (const float*)delta, (float*)dk, (float*)dv, Lq, Lk,
      scale, sw);
  return (int)cudaGetLastError();
}

template <bool P2, int W>
static int launch_dq(const void* q, const void* k, const void* v,
                     const void* g, const void* lse, const void* delta,
                     void* dq, int B, int Lq, int Lk, float scale, Swin sw,
                     cudaStream_t st) {
  CUtensorMap m[4];
  int e;
  if ((e = tensor_maps(m, q, k, v, g, B, Lq, Lk, W, P2 ? 2 : W,
                       Dq<P2, W>::KT)))
    return e;
  const size_t smem = smem_bytes<typename Dq<P2, W>::SM>();
  if ((e = (int)cudaFuncSetAttribute(
           flash_bwd_dq_wgmma<P2, W>,
           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem)))
    return e;
  const dim3 grid((unsigned)((Lq + WG * TILE - 1) / (WG * TILE)),
                  (unsigned)B);
  flash_bwd_dq_wgmma<P2, W><<<grid, THREADS, smem, st>>>(
      m[0], m[1], m[2], m[3], (const bf16*)v, (const bf16*)g,
      (const float*)lse, (const float*)delta, (float*)dq, Lq, Lk, scale, sw);
  return (int)cudaGetLastError();
}

// One kernel's launch at these widths (C = 128 or 256; D = C or 2): dk/dv
// (out0 = dk, out1 = dv) or dq (out0).
template <bool P2, int W>
static int launch_at(bool dkv, const void* q, const void* k, const void* v,
                     const void* g, const void* lse, const void* delta,
                     void* out0, void* out1, int B, int Lq, int Lk,
                     float scale, Swin sw, cudaStream_t st) {
  return dkv ? launch_dkv<P2, W>(q, k, v, g, lse, delta, out0, out1, B, Lq,
                                 Lk, scale, sw, st)
             : launch_dq<P2, W>(q, k, v, g, lse, delta, out0, B, Lq, Lk,
                                scale, sw, st);
}

static int launch(bool dkv, const void* q, const void* k, const void* v,
                  const void* g, const void* lse, const void* delta,
                  void* out0, void* out1, int B, int Lq, int Lk, int C, int D,
                  float scale, Swin sw, cudaStream_t st) {
  if (C == 256)
    return D == 2 ? launch_at<true, 256>(dkv, q, k, v, g, lse, delta, out0,
                                         out1, B, Lq, Lk, scale, sw, st)
                  : launch_at<false, 256>(dkv, q, k, v, g, lse, delta, out0,
                                          out1, B, Lq, Lk, scale, sw, st);
  return D == 2 ? launch_at<true, 128>(dkv, q, k, v, g, lse, delta, out0,
                                       out1, B, Lq, Lk, scale, sw, st)
                : launch_at<false, 128>(dkv, q, k, v, g, lse, delta, out0,
                                        out1, B, Lq, Lk, scale, sw, st);
}

}  // namespace sm90

// ---------------------------------------------------------------------------
// f32 operands at C = 128 and D = 128 or 2: the tf32x3 route
// ---------------------------------------------------------------------------

namespace tf32x3 {

using namespace hopper;

// The block of each width: warps (16 output rows each), the resident rows,
// the streamed rows a ring stage and their 8-wide tiles of S.
template <bool P2>
struct Cfg {
  static constexpr int NW = P2 ? 4 : 8;
  static constexpr int THREADS = NW * 32;
  static constexpr int BROWS = NW * 16;
  static constexpr int TILE = P2 ? 64 : 32;
  static constexpr int NT = TILE / 8;
  // floats: the resident rows (the C-wide side, and the D-wide one at D =
  // 128), then a ring stage (the streamed C-wide tile, the D-wide tile or
  // its pairs (PAY), and for dk/dv lse and delta)
  static constexpr int RES = BROWS * STR * (P2 ? 1 : 2);
  static constexpr int PAY = P2 ? 2 * TILE : TILE * STR;
  static constexpr int STAGE_DQ = TILE * STR + PAY;
  static constexpr int STAGE_DKV = STAGE_DQ + 2 * TILE;
  static constexpr size_t SMEM_DQ = sizeof(float) * (RES + STAGES * STAGE_DQ);
  static constexpr size_t SMEM_DKV =
      sizeof(float) * (RES + STAGES * STAGE_DKV);
};

// dq: one block per (BROWS queries, split of the key tiles, batch entry).
// The block's Q (and G at D = 128) rows are resident; the key tiles
// [split * per, split * per + per) stream. With one split the block
// writes dq = scale * sum; with more, its partial sum (unscaled) into
// dq[split] of a [splits, B, Lq, 128] scratch.
template <bool P2>
__global__ void __launch_bounds__(Cfg<P2>::THREADS, P2 ? 2 : 1)
flash_bwd_dq_tf32(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ g,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta, float* __restrict__ dq,
                  int Lq, int Lk, float scale, Swin sw, int per) {
  using K = Cfg<P2>;
  constexpr int TILE = K::TILE, NT = K::NT, T = K::THREADS;
  constexpr int SF = K::STAGE_DQ;
  extern __shared__ __align__(16) float fsm[];
  float* qs = fsm;                              // [BROWS][STR]
  float* gs = fsm + K::BROWS * STR;             // [BROWS][STR] (D = 128)
  float* ring = fsm + K::RES;                   // STAGES x SF
  const int b = blockIdx.z, split_i = blockIdx.y, q0 = blockIdx.x * K::BROWS;
  const int all = (Lk + TILE - 1) / TILE;
  const int first = split_i * per;
  const int n_tiles = min(all, first + per) - first;
  const float* kb = k + (long long)b * Lk * W;
  const float* vb = v + (long long)b * Lk * (P2 ? 2 : W);

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
  if constexpr (!P2)
    load_rows<T>(gs, g + (long long)b * Lq * W, q0, K::BROWS, Lq);
  load_tile(0);
  cp_commit();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, t = lane & 3;
  const int row0 = q0 + warp * 16 + gq;             // rows row0, row0 + 8
  const bool idle = q0 + warp * 16 >= Lq;
  bool last_y, last_x;
  const bool masked = swin_window(sw, b, &last_y, &last_x);
  int qreg[2] = {0, 0};
  bool qok[2];
  float lse2[2] = {0.f, 0.f}, dl[2] = {0.f, 0.f};
  float2 g2[2] = {make_float2(0.f, 0.f), make_float2(0.f, 0.f)};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    qok[r] = row < Lq;
    if (masked) qreg[r] = swin_region(sw, last_y, last_x, row);
    if (qok[r]) {
      lse2[r] = lse[(long long)b * Lq + row] * LOG2E;
      dl[r] = delta[(long long)b * Lq + row];
      if (P2)
        g2[r] = *reinterpret_cast<const float2*>(g + ((long long)b * Lq + row)
                                                 * 2);
    }
  }
  const float scale2 = scale * LOG2E, mask2 = 100.f * LOG2E;
  float acc[W / 8][4];
#pragma unroll
  for (int i = 0; i < W / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    if (it + 1 < n_tiles) load_tile(it + 1);
    cp_commit();
    cp_wait<1>();       // tile it (and the resident rows) landed
    __syncthreads();
    const float* st = ring + (it % STAGES) * SF;
    if (!idle) {
      const int k0 = (first + it) * TILE;
      // S = Q K^T and (D = 128) dP = G V^T: 16 queries x TILE keys
      float s[NT][4], dp[P2 ? 1 : NT][4];
      prod_rows<NT>(s, qs + warp * 16 * STR, st, gq, t);
      if constexpr (!P2)
        prod_rows<NT>(dp, gs + warp * 16 * STR, st + TILE * STR, gq, t);
      // ds = p (dp - delta) into s
      const uint32_t cregs =
          masked ? sm90::col_regions(sw, last_y, last_x, k0, t) : 0u;
      const float2* vp = reinterpret_cast<const float2*>(st + TILE * STR);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int ce = e & 1, r = e >> 1, kl = 8 * j + 2 * t + ce;
          float x = fmaf(s[j][e], scale2, -lse2[r]);
          if (masked && sm90::other_region(cregs, j, e, qreg[r])) x -= mask2;
          const float p = qok[r] && k0 + kl < Lk ? ex2(x) : 0.f;
          float dpv;
          if constexpr (P2)
            dpv = fmaf(g2[r].x, vp[kl].x, g2[r].y * vp[kl].y);
          else
            dpv = dp[j][e];
          s[j][e] = p * (dpv - dl[r]);
        }
      }
      // dq += dS K
      prod_pb<NT>(acc, s, st, gq, t);
    }
    __syncthreads();    // the stage is consumed before it is refilled
  }
  if (idle) return;
  const bool whole = gridDim.y == 1;
  store_rows(dq + (long long)(split_i * gridDim.z + b) * Lq * W, acc, row0, Lq,
             t, whole ? scale : 1.f);
}

// dk and dv: one block per (BROWS keys, split of the query tiles, batch
// entry). The block's K (and V at D = 128) rows are resident; the query
// tiles stream with their lse and delta. With one split the block writes
// dk = scale * sum and dv; with more, its partial sums (unscaled) into
// dk[split] and dv[split] of [splits, B, Lk, 128 | D] scratches.
template <bool P2>
__global__ void __launch_bounds__(Cfg<P2>::THREADS, P2 ? 2 : 1)
flash_bwd_dkv_tf32(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, const float* __restrict__ g,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta, float* __restrict__ dk,
                   float* __restrict__ dv, int Lq, int Lk, float scale,
                   Swin sw, int per) {
  using K = Cfg<P2>;
  constexpr int TILE = K::TILE, NT = K::NT, T = K::THREADS;
  constexpr int SF = K::STAGE_DKV, PAY = K::PAY;   // PAY: the D-wide tile
  extern __shared__ __align__(16) float fsm[];
  float* ks = fsm;                              // [BROWS][STR]
  float* vs = fsm + K::BROWS * STR;             // [BROWS][STR] (D = 128)
  float* ring = fsm + K::RES;
  const int b = blockIdx.z, split_i = blockIdx.y, k0 = blockIdx.x * K::BROWS;
  const int all = (Lq + TILE - 1) / TILE;
  const int first = split_i * per;
  const int n_tiles = min(all, first + per) - first;
  const float* qb = q + (long long)b * Lq * W;
  const float* gb = g + (long long)b * Lq * (P2 ? 2 : W);
  const float* lb = lse + (long long)b * Lq;
  const float* db = delta + (long long)b * Lq;

  auto load_tile = [&](int it) {
    float* st = ring + (it % STAGES) * SF;
    const int q0 = (first + it) * TILE;
    load_rows<T>(st, qb, q0, TILE, Lq);
    if constexpr (P2)
      load_small<T, 2>(st + TILE * STR, gb, q0, TILE, Lq);
    else
      load_rows<T>(st + TILE * STR, gb, q0, TILE, Lq);
    load_small<T, 1>(st + TILE * STR + PAY, lb, q0, TILE, Lq);
    load_small<T, 1>(st + TILE * STR + PAY + TILE, db, q0, TILE, Lq);
  };
  load_rows<T>(ks, k + (long long)b * Lk * W, k0, K::BROWS, Lk);
  if constexpr (!P2)
    load_rows<T>(vs, v + (long long)b * Lk * W, k0, K::BROWS, Lk);
  load_tile(0);
  cp_commit();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, t = lane & 3;
  const int row0 = k0 + warp * 16 + gq;             // keys row0, row0 + 8
  const bool idle = k0 + warp * 16 >= Lk;
  bool last_y, last_x;
  const bool masked = swin_window(sw, b, &last_y, &last_x);
  int kreg[2] = {0, 0};
  bool kok[2];
  float2 v2[2] = {make_float2(0.f, 0.f), make_float2(0.f, 0.f)};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = row0 + 8 * r;
    kok[r] = key < Lk;
    if (masked) kreg[r] = swin_region(sw, last_y, last_x, key);
    if (P2 && kok[r])
      v2[r] = *reinterpret_cast<const float2*>(v + ((long long)b * Lk + key)
                                               * 2);
  }
  const float scale2 = scale * LOG2E, mask2 = 100.f * LOG2E;
  float dka[W / 8][4], dva[P2 ? 1 : W / 8][4];
#pragma unroll
  for (int i = 0; i < W / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[i][e] = 0.f;
#pragma unroll
  for (int i = 0; i < (P2 ? 1 : W / 8); ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dva[i][e] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    if (it + 1 < n_tiles) load_tile(it + 1);
    cp_commit();
    cp_wait<1>();
    __syncthreads();
    const float* st = ring + (it % STAGES) * SF;
    if (!idle) {
      const int q0 = (first + it) * TILE;
      const float* gt = st + TILE * STR;
      const float2* lse_2 = reinterpret_cast<const float2*>(gt + PAY);
      const float2* del_2 = reinterpret_cast<const float2*>(gt + PAY + TILE);
      // S^T = K Q^T and (D = 128) dP^T = V G^T: 16 keys x TILE queries
      float st_[NT][4], dpt[NT][4];
      prod_rows<NT>(st_, ks + warp * 16 * STR, st, gq, t);
      if constexpr (!P2)
        prod_rows<NT>(dpt, vs + warp * 16 * STR, gt, gq, t);
      // p^T into st_ (D = 128), ds^T into dpt; at D = 2, dP^T and dv on
      // the CUDA cores from the pairs
      const uint32_t cregs =
          masked ? sm90::col_regions(sw, last_y, last_x, q0, t) : 0u;
      const float2* gp = reinterpret_cast<const float2*>(gt);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int c = 8 * j + 2 * t;
        const float2 l = lse_2[c >> 1], dl = del_2[c >> 1];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int ce = e & 1, r = e >> 1;
          float x = fmaf(ce ? l.y : l.x, -LOG2E, st_[j][e] * scale2);
          if (masked && sm90::other_region(cregs, j, e, kreg[r])) x -= mask2;
          const float p = kok[r] && q0 + c + ce < Lq ? ex2(x) : 0.f;
          float dp;
          if constexpr (P2) {
            const float2 gg = gp[c + ce];
            dp = fmaf(gg.x, v2[r].x, gg.y * v2[r].y);
            dva[0][2 * r] = fmaf(p, gg.x, dva[0][2 * r]);
            dva[0][2 * r + 1] = fmaf(p, gg.y, dva[0][2 * r + 1]);
          } else {
            dp = dpt[j][e];
          }
          st_[j][e] = p;
          dpt[j][e] = p * (dp - (ce ? dl.y : dl.x));
        }
      }
      // dv += P^T G (D = 128) and dk += dS^T Q
      if constexpr (!P2) prod_pb<NT>(dva, st_, gt, gq, t);
      prod_pb<NT>(dka, dpt, st, gq, t);
    }
    __syncthreads();
  }
  if (idle) return;
  const bool whole = gridDim.y == 1;
  const long long part = (long long)(split_i * gridDim.z + b) * Lk;
  store_rows(dk + part * W, dka, row0, Lk, t, whole ? scale : 1.f);
  if constexpr (P2) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      dva[0][e] += __shfl_xor_sync(0xffffffffu, dva[0][e], 1);
      dva[0][e] += __shfl_xor_sync(0xffffffffu, dva[0][e], 2);
    }
    if (t == 0) {
#pragma unroll
      for (int r = 0; r < 2; ++r)
        if (kok[r])
          *reinterpret_cast<float2*>(dv + (part + row0 + 8 * r) * 2) =
              make_float2(dva[0][2 * r], dva[0][2 * r + 1]);
    }
  } else {
    store_rows(dv + part * W, dva, row0, Lk, t, 1.f);
  }
}

// out[i] = mult * (part[0][i] + part[1][i] + ... + part[splits - 1][i]),
// summed in that order
__global__ void __launch_bounds__(256)
reduce_splits(const float* __restrict__ part, float* __restrict__ out,
              long long n, int splits, float mult) {
  for (long long i = blockIdx.x * 256ll + threadIdx.x; i < n;
       i += (long long)gridDim.x * 256) {
    float s = part[i];
    for (int p = 1; p < splits; ++p) s += part[p * n + i];
    out[i] = s * mult;
  }
}

template <bool P2>
static int launch_dq(const void* q, const void* k, const void* v,
                     const void* g, const void* lse, const void* delta,
                     void* dq, int B, int Lq, int Lk, float scale, Swin sw,
                     int splits, cudaStream_t st) {
  using K = Cfg<P2>;
  const int per = tiles_per_split(Lk, K::TILE, splits);
  if (!per) return (int)cudaErrorInvalidValue;
  const size_t smem = K::SMEM_DQ;
  int e;
  if ((e = (int)cudaFuncSetAttribute(
           flash_bwd_dq_tf32<P2>, cudaFuncAttributeMaxDynamicSharedMemorySize,
           (int)smem)))
    return e;
  const dim3 grid((unsigned)((Lq + K::BROWS - 1) / K::BROWS), (unsigned)splits,
                  (unsigned)B);
  flash_bwd_dq_tf32<P2><<<grid, K::THREADS, smem, st>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)g,
      (const float*)lse, (const float*)delta, (float*)dq, Lq, Lk, scale, sw,
      per);
  return (int)cudaGetLastError();
}

template <bool P2>
static int launch_dkv(const void* q, const void* k, const void* v,
                      const void* g, const void* lse, const void* delta,
                      void* dk, void* dv, int B, int Lq, int Lk, float scale,
                      Swin sw, int splits, cudaStream_t st) {
  using K = Cfg<P2>;
  const int per = tiles_per_split(Lq, K::TILE, splits);
  if (!per) return (int)cudaErrorInvalidValue;
  const size_t smem = K::SMEM_DKV;
  int e;
  if ((e = (int)cudaFuncSetAttribute(
           flash_bwd_dkv_tf32<P2>, cudaFuncAttributeMaxDynamicSharedMemorySize,
           (int)smem)))
    return e;
  const dim3 grid((unsigned)((Lk + K::BROWS - 1) / K::BROWS), (unsigned)splits,
                  (unsigned)B);
  flash_bwd_dkv_tf32<P2><<<grid, K::THREADS, smem, st>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)g,
      (const float*)lse, (const float*)delta, (float*)dk, (float*)dv, Lq, Lk,
      scale, sw, per);
  return (int)cudaGetLastError();
}

}  // namespace tf32x3

// ---------------------------------------------------------------------------
// f32 operands: one thread per output row
// ---------------------------------------------------------------------------

// Rows [r0, r0 + n) of W columns of an f32 matrix whose rows are `stride`
// apart into [n][ld] shared rows by 4-byte cp.async copies (rows padded to
// an odd count of floats keep a thread's row on its own bank); rows >= L
// are zeros. The caller waits and syncs.
__device__ __forceinline__ void stage_f32(float* dst, int ld, const float* src,
                                          int r0, int n, int L, int W,
                                          int stride) {
  for (int i = threadIdx.x; i < n * W; i += F32_ROWS) {
    const int r = i / W, c = i - r * W;
    const bool ok = r0 + r < L;
    cp_async_4(dst + r * ld + c,
               ok ? src + (long long)(r0 + r) * stride + c : src,
               ok ? 4u : 0u);
  }
}

// dq: one block per (F32_ROWS query rows, batch entry, chunk of CHUNK
// columns of dq: blockIdx.z; each chunk's blocks recompute S and dP). S =
// Q K^T and dP = G V^T are summed over C and D in panels of PCOLS columns, in
// the order of C and of D at any width: each key tile's K and V are staged
// a panel at a time, with the tile's chunk columns of K past C = PCOLS; Q's
// and G's rows resident where they fit a block (res), else staged a panel
// at a time beside K's and V's. The chunk's row sums in shared memory.
__global__ void __launch_bounds__(F32_ROWS)
flash_bwd_dq_f32(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ g,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, float* __restrict__ dq,
                 int Lq, int Lk, int C, int D, float scale, Swin sw,
                 int res) {
  constexpr int R = F32_ROWS;
  extern __shared__ __align__(16) float fsm[];
  const int kw = min(C, PCOLS), vw = min(D, PCOLS);
  const int qs = (res ? C : kw) + 1, gs = (res ? D : vw) + 1;
  const int as = min(C, CHUNK) + 1;
  float* Qs = fsm;                              // [R][qs]
  float* Gs = Qs + R * qs;                      // [R][gs]
  float* As = Gs + R * gs;                      // [R][as] dq sums
  float* Kp = As + R * as;                      // [F32_T][kw]
  float* Vp = Kp + F32_T * kw;                  // [F32_T][vw]
  float* Kc = C > PCOLS ? Vp + F32_T * vw : Kp;    // [F32_T][kw]
  __shared__ int kreg_s[F32_T];
  const int b = blockIdx.y, tid = threadIdx.x, c0 = blockIdx.z * CHUNK;
  const int q0 = blockIdx.x * R, row = q0 + tid;
  const int cwc = min(CHUNK, C - c0);
  const float* qb = q + (long long)b * Lq * C;
  const float* kb = k + (long long)b * Lk * C;
  const float* vb = v + (long long)b * Lk * D;
  const float* gb = g + (long long)b * Lq * D;

  if (res) {   // published by the first panel's wait and barrier
    stage_f32(Qs, qs, qb, q0, R, Lq, C, C);
    stage_f32(Gs, gs, gb, q0, R, Lq, D, D);
  }
  float* acc = As + tid * as;
  for (int c = 0; c < cwc; ++c) acc[c] = 0.f;
  const bool ok = row < Lq;
  const float lse_r = ok ? lse[(long long)b * Lq + row] : 0.f;
  const float delta_r = ok ? delta[(long long)b * Lq + row] : 0.f;
  bool last_y, last_x;
  const bool masked = swin_window(sw, b, &last_y, &last_x);
  const int qreg = masked ? swin_region(sw, last_y, last_x, row) : 0;
  const int npc = (C + PCOLS - 1) / PCOLS, npd = (D + PCOLS - 1) / PCOLS;

  for (int k0 = 0; k0 < Lk; k0 += F32_T) {
    float s[F32_T], dp[F32_T];
#pragma unroll
    for (int j = 0; j < F32_T; ++j) s[j] = dp[j] = 0.f;
    for (int p = 0; p < max(npc, npd); ++p) {
      const int p0 = p * PCOLS, cw = min(PCOLS, C - p0);
      const int dw = min(PCOLS, D - p0);
      __syncthreads();  // the previous panel (and tile) is consumed
      if (p < npc) {
        stage_f32(Kp, kw, kb + p0, k0, F32_T, Lk, cw, C);
        if (!res) stage_f32(Qs, qs, qb + p0, q0, R, Lq, cw, C);
      }
      if (p < npd) {
        stage_f32(Vp, vw, vb + p0, k0, F32_T, Lk, dw, D);
        if (!res) stage_f32(Gs, gs, gb + p0, q0, R, Lq, dw, D);
      }
      if (p == 0) {
        if (C > PCOLS) stage_f32(Kc, kw, kb + c0, k0, F32_T, Lk, cwc, C);
        if (masked && tid < F32_T)
          kreg_s[tid] = swin_region(sw, last_y, last_x, k0 + tid);
      }
      cp_async_wait_all();
      __syncthreads();
      if (p < npc) {
        const float* qr = Qs + tid * qs + (res ? p0 : 0);
        for (int c = 0; c < cw; ++c) {
          const float qv = qr[c];
#pragma unroll
          for (int j = 0; j < F32_T; ++j) s[j] = fmaf(qv, Kp[j * kw + c], s[j]);
        }
      }
      if (p < npd) {
        const float* gr = Gs + tid * gs + (res ? p0 : 0);
        for (int d = 0; d < dw; ++d) {
          const float gv = gr[d];
#pragma unroll
          for (int j = 0; j < F32_T; ++j)
            dp[j] = fmaf(gv, Vp[j * vw + d], dp[j]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < F32_T; ++j) {
      float x = s[j] * scale;
      if (masked && kreg_s[j] != qreg) x = x - 100.f;
      if (k0 + j >= Lk) x = NEG_INF;
      const float p = ok ? expf(x - lse_r) : 0.f;
      s[j] = p * (dp[j] - delta_r);
    }
    for (int c = 0; c < cwc; ++c) {
      float a = acc[c];
#pragma unroll
      for (int j = 0; j < F32_T; ++j) a = fmaf(s[j], Kc[j * kw + c], a);
      acc[c] = a;
    }
  }
  if (ok) {
    float* out = dq + ((long long)b * Lq + row) * C + c0;
    for (int c = 0; c < cwc; ++c) out[c] = acc[c] * scale;
  }
}

// dk and dv: one block per (F32_ROWS key rows, batch entry, chunk z of
// CHUNK columns: dk's and dv's columns [z CHUNK, (z + 1) CHUNK)), as dq
// with the sides swapped: S^T and dP^T over panels of C and D, each query
// tile's Q and G staged a panel at a time with the tile's chunk columns of
// Q and G past C or D = PCOLS; K's and V's rows resident where they fit.
__global__ void __launch_bounds__(F32_ROWS)
flash_bwd_dkv_f32(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ g,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta, float* __restrict__ dk,
                  float* __restrict__ dv, int Lq, int Lk, int C, int D,
                  float scale, Swin sw, int res) {
  constexpr int R = F32_ROWS;
  extern __shared__ __align__(16) float fsm[];
  const int kw = min(C, PCOLS), vw = min(D, PCOLS);
  const int ks_ = (res ? C : kw) + 1, vs_ = (res ? D : vw) + 1;
  const int as_k = min(C, CHUNK) + 1, as_v = min(D, CHUNK) + 1;
  float* Ks = fsm;                              // [R][ks_]
  float* Vs = Ks + R * ks_;                     // [R][vs_]
  float* DK = Vs + R * vs_;                     // [R][as_k] sums
  float* DV = DK + R * as_k;                    // [R][as_v] sums
  float* Qp = DV + R * as_v;                    // [F32_T][kw]
  float* Gp = Qp + F32_T * kw;                  // [F32_T][vw]
  float* Qc = Gp + F32_T * vw;                  // [F32_T][kw] (C > PCOLS)
  float* Gc = Qc + (C > PCOLS ? F32_T * kw : 0);   // [F32_T][vw] (D > PCOLS)
  if (C <= PCOLS) Qc = Qp;
  if (D <= PCOLS) Gc = Gp;
  __shared__ float lse_s[F32_T], delta_s[F32_T];
  __shared__ int qreg_s[F32_T];
  const int b = blockIdx.y, tid = threadIdx.x, c0 = blockIdx.z * CHUNK;
  const int k0 = blockIdx.x * R, row = k0 + tid;
  const int cwk = min(CHUNK, C - c0), cwv = min(CHUNK, D - c0);  // may be <= 0
  const float* qb = q + (long long)b * Lq * C;
  const float* kb = k + (long long)b * Lk * C;
  const float* vb = v + (long long)b * Lk * D;
  const float* gb = g + (long long)b * Lq * D;

  if (res) {   // published by the first panel's wait and barrier
    stage_f32(Ks, ks_, kb, k0, R, Lk, C, C);
    stage_f32(Vs, vs_, vb, k0, R, Lk, D, D);
  }
  float* dka = DK + tid * as_k;
  float* dva = DV + tid * as_v;
  for (int c = 0; c < cwk; ++c) dka[c] = 0.f;
  for (int d = 0; d < cwv; ++d) dva[d] = 0.f;
  bool last_y, last_x;
  const bool masked = swin_window(sw, b, &last_y, &last_x);
  const int kreg = masked ? swin_region(sw, last_y, last_x, row) : 0;
  const int npc = (C + PCOLS - 1) / PCOLS, npd = (D + PCOLS - 1) / PCOLS;

  for (int q0 = 0; q0 < Lq; q0 += F32_T) {
    float s[F32_T], dp[F32_T];
#pragma unroll
    for (int j = 0; j < F32_T; ++j) s[j] = dp[j] = 0.f;
    for (int p = 0; p < max(npc, npd); ++p) {
      const int p0 = p * PCOLS, cw = min(PCOLS, C - p0);
      const int dw = min(PCOLS, D - p0);
      __syncthreads();  // the previous panel (and tile) is consumed
      if (p < npc) {
        stage_f32(Qp, kw, qb + p0, q0, F32_T, Lq, cw, C);
        if (!res) stage_f32(Ks, ks_, kb + p0, k0, R, Lk, cw, C);
      }
      if (p < npd) {
        stage_f32(Gp, vw, gb + p0, q0, F32_T, Lq, dw, D);
        if (!res) stage_f32(Vs, vs_, vb + p0, k0, R, Lk, dw, D);
      }
      if (p == 0) {
        if (C > PCOLS && cwk > 0)
          stage_f32(Qc, kw, qb + c0, q0, F32_T, Lq, cwk, C);
        if (D > PCOLS && cwv > 0)
          stage_f32(Gc, vw, gb + c0, q0, F32_T, Lq, cwv, D);
        if (tid < F32_T) {
          const bool ok = q0 + tid < Lq;
          lse_s[tid] = ok ? lse[(long long)b * Lq + q0 + tid] : 0.f;
          delta_s[tid] = ok ? delta[(long long)b * Lq + q0 + tid] : 0.f;
          if (masked) qreg_s[tid] = swin_region(sw, last_y, last_x, q0 + tid);
        }
      }
      cp_async_wait_all();
      __syncthreads();
      if (p < npc) {
        const float* kr = Ks + tid * ks_ + (res ? p0 : 0);
        for (int c = 0; c < cw; ++c) {
          const float kv = kr[c];
#pragma unroll
          for (int j = 0; j < F32_T; ++j) s[j] = fmaf(Qp[j * kw + c], kv, s[j]);
        }
      }
      if (p < npd) {
        const float* vr = Vs + tid * vs_ + (res ? p0 : 0);
        for (int d = 0; d < dw; ++d) {
          const float vv = vr[d];
#pragma unroll
          for (int j = 0; j < F32_T; ++j)
            dp[j] = fmaf(Gp[j * vw + d], vv, dp[j]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < F32_T; ++j) {
      float x = s[j] * scale;
      if (masked && qreg_s[j] != kreg) x = x - 100.f;
      if (row >= Lk) x = NEG_INF;
      const float p = q0 + j < Lq ? expf(x - lse_s[j]) : 0.f;
      s[j] = p;
      dp[j] = p * (dp[j] - delta_s[j]);
    }
    for (int d = 0; d < cwv; ++d) {
      float a = dva[d];
#pragma unroll
      for (int j = 0; j < F32_T; ++j) a = fmaf(s[j], Gc[j * vw + d], a);
      dva[d] = a;
    }
    for (int c = 0; c < cwk; ++c) {
      float a = dka[c];
#pragma unroll
      for (int j = 0; j < F32_T; ++j) a = fmaf(dp[j], Qc[j * kw + c], a);
      dka[c] = a;
    }
  }
  if (row < Lk) {
    float* outk = dk + ((long long)b * Lk + row) * C + c0;
    float* outv = dv + ((long long)b * Lk + row) * D + c0;
    for (int c = 0; c < cwk; ++c) outk[c] = dka[c] * scale;
    for (int d = 0; d < cwv; ++d) outv[d] = dva[d];
  }
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

static int launch(const void* kern, dim3 grid, int threads, size_t smem,
                  cudaStream_t st, void** args) {
  if (smem > SMEM_DEFAULT) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const cudaError_t e =
      cudaLaunchKernel(kern, grid, dim3(threads), args, smem, st);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// The widths every route's checks start from: C % 16 == 0, D == 2 or D %
// 16 == 0, and at most 65,535 chunks of CHUNK columns on the grid's z axis
// (dq's chunks of C, dk/dv's of C or D), so C and D <= 65535 * 128.
#define MAX_WIDTH (65535 * CHUNK)
static bool valid(int B, int Lq, int Lk, int C, int D, int swin_k) {
  return B >= 1 && B <= 65535 && Lq >= 1 && Lk >= 1 && C >= 16 &&
         C <= MAX_WIDTH && C % 16 == 0 &&
         (D == 2 || (D % 16 == 0 && D >= 16 && D <= MAX_WIDTH)) &&
         swin_k >= 0;
}

// The CUDA-core kernels' dynamic shared memory (floats): dq the rows' Q and
// G (resident, or a panel of PCOLS columns, each padded by one float) and
// their chunk's sums, the tile's panels of K and V and, past C = PCOLS, its
// chunk columns of K; dk/dv the rows' K and V, their chunk's dk and dv
// sums, the tile's panels of Q and G and, past C or D = PCOLS, their chunk
// columns.
static size_t f32_smem(int C, int D, bool dkv, bool res) {
  const size_t kw = C < PCOLS ? C : PCOLS, vw = D < PCOLS ? D : PCOLS;
  const size_t ac = (C < CHUNK ? C : CHUNK) + 1;
  const size_t av = (D < CHUNK ? D : CHUNK) + 1;
  const size_t rows = F32_ROWS * ((res ? C : kw) + 1 + (res ? D : vw) + 1 +
                                  ac + (dkv ? av : 0));
  const size_t tile = F32_T * (kw + vw + (C > PCOLS ? kw : 0) +
                               (dkv && D > PCOLS ? vw : 0));
  return sizeof(float) * (rows + tile);
}

// The mma.sync kernels' dynamic shared memory (bf16): the resident side's
// rows (Q and G for dq, K and V for dk/dv: whole, or a panel of PCOLS
// columns, each row padded by PAD), the other side's tile of a panel of
// each (V's or G's 2-wide rows as float2s at D = 2) and, past C or D = PCOLS,
// its chunk columns (dq: of K; dk/dv: of Q and G).
static size_t bf16_smem(int C, int D, bool dkv, bool res) {
  const bool p2 = D == 2;
  const size_t kps = (C < PCOLS ? C : PCOLS) + PAD;
  const size_t vps = (D < PCOLS ? D : PCOLS) + PAD;
  const size_t tile = dkv ? QT : BK;
  const size_t rows = ROWS * ((res ? C + PAD : kps) +
                              (p2 ? 0 : (res ? D + PAD : vps)));
  const size_t other = tile * (kps + (p2 ? 4 : vps) + (C > PCOLS ? kps : 0) +
                               (dkv && !p2 && D > PCOLS ? vps : 0));
  return sizeof(bf16) * (rows + other);
}

static unsigned chunks(int W) { return (unsigned)((W + CHUNK - 1) / CHUNK); }

// One backward kernel as it launches on a route at these widths: the
// kernel, its output rows and threads a block, its column chunks (a grid
// axis of the mma.sync and CUDA-core routes: dq's of C, dk/dv's of C or D,
// whichever has more; 1 elsewhere), its dynamic shared memory and, on the
// mma.sync and CUDA-core routes, whether the resident side's rows stay in
// shared memory whole (where they fit a block) or come a panel at a time.
// The entry points launch the CUDA-core and mma.sync routes from it, and
// ofd_flash_bwd_plan reports it for every route.
struct Kernel {
  const void* fn;
  int rows, threads;
  unsigned chunks;
  size_t smem;
  int res;
};

template <bool P2, int W>
static Kernel wgmma_kernel(bool dkv) {
  using namespace sm90;
  if (dkv)
    return {(const void*)flash_bwd_dkv_wgmma<P2, W>, Dkv<P2, W>::RG * TILE,
            THREADS, 1, smem_bytes<typename Dkv<P2, W>::SM>(), 0};
  return {(const void*)flash_bwd_dq_wgmma<P2, W>, WG * TILE, THREADS, 1,
          smem_bytes<typename Dq<P2, W>::SM>(), 0};
}

template <bool P2>
static Kernel tf32_kernel(bool dkv) {
  using K = tf32x3::Cfg<P2>;
  return {dkv ? (const void*)tf32x3::flash_bwd_dkv_tf32<P2>
              : (const void*)tf32x3::flash_bwd_dq_tf32<P2>,
          K::BROWS, K::THREADS, 1, dkv ? K::SMEM_DKV : K::SMEM_DQ, 0};
}

static Kernel kernel_of(int route, bool dkv, int C, int D) {
  const unsigned z =
      dkv && D != 2 && chunks(D) > chunks(C) ? chunks(D) : chunks(C);
  switch (route) {
    case WGMMA:
      if (C == 256)
        return D == 2 ? wgmma_kernel<true, 256>(dkv)
                      : wgmma_kernel<false, 256>(dkv);
      return D == 2 ? wgmma_kernel<true, 128>(dkv)
                    : wgmma_kernel<false, 128>(dkv);
    case TF32X3:
      return D == 2 ? tf32_kernel<true>(dkv) : tf32_kernel<false>(dkv);
    case F32: {
      const bool res = f32_smem(C, D, dkv, true) <= SMEM_BLOCK;
      return {dkv ? (const void*)flash_bwd_dkv_f32
                  : (const void*)flash_bwd_dq_f32,
              F32_ROWS, F32_ROWS, z, f32_smem(C, D, dkv, res), res};
    }
    default: {  // MMA_SYNC
      const bool res = bf16_smem(C, D, dkv, true) <= SMEM_BLOCK;
      const void* fn =
          dkv ? (D == 2 ? (const void*)flash_bwd_dkv_bf16<true>
                        : (const void*)flash_bwd_dkv_bf16<false>)
              : (D == 2 ? (const void*)flash_bwd_dq_bf16<true>
                        : (const void*)flash_bwd_dq_bf16<false>);
      return {fn, ROWS, WARPS * 32, z, bf16_smem(C, D, dkv, res), res};
    }
  }
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

// q [B, Lq, C], k [B, Lk, C], v [B, Lk, D], g [B, Lq, D]: all bf16 or all
// f32, contiguous, 16-byte aligned; lse and delta [B, Lq] f32; dq [B, Lq, C]
// f32. swin_k = 0: no Swin mask; else (swin_k, wh, ww, sh, sw) as the
// forward's. Takes C % 16 == 0 and D == 2 or D % 16 == 0, up to MAX_WIDTH
// (ops/flash_bwd.py pads other widths), on the route the caller
// names (enum Route; the tf32x3 route
// C = 128 and D = 128 or 2, the wgmma route the same in bf16 and C = 256
// with D = 256 or 2). splits > 1
// (the tf32x3 route only) cuts the key sweep into that many runs of whole
// tiles: dq is then a [splits, B, Lq, C] scratch of unscaled partial
// sums, for ofd_flash_bwd_reduce. Returns cudaGetLastError() after the
// launch (0 on success).
extern "C" int ofd_flash_bwd_dq(const void* q, const void* k, const void* v,
                                const void* g, const void* lse,
                                const void* delta, void* dq, int B, int Lq,
                                int Lk, int C, int D, float scale, int swin_k,
                                int wh, int ww, int sh, int swd, int is_bf16,
                                int route, int splits, void* stream) {
  if (!valid(B, Lq, Lk, C, D, swin_k) ||
      !route_takes(route, is_bf16, B, Lq, Lk, C, D) ||
      (splits != 1 && route != TF32X3))
    return (int)cudaErrorInvalidValue;
  Swin sw{swin_k, wh, ww, sh, swd};
  cudaStream_t st = (cudaStream_t)stream;
  if (route == TF32X3)
    return D == 2 ? tf32x3::launch_dq<true>(q, k, v, g, lse, delta, dq, B,
                                            Lq, Lk, scale, sw, splits, st)
                  : tf32x3::launch_dq<false>(q, k, v, g, lse, delta, dq, B,
                                             Lq, Lk, scale, sw, splits, st);
  if (route == WGMMA)
    return sm90::launch(false, q, k, v, g, lse, delta, dq, nullptr, B, Lq,
                        Lk, C, D, scale, sw, st);
  Kernel kn = kernel_of(route, false, C, D);
  void* args[] = {(void*)&q,  (void*)&k,  (void*)&v, (void*)&g,
                  (void*)&lse, (void*)&delta, (void*)&dq, (void*)&Lq,
                  (void*)&Lk, (void*)&C,  (void*)&D, (void*)&scale,
                  (void*)&sw, (void*)&kn.res};
  const dim3 grid((unsigned)((Lq + kn.rows - 1) / kn.rows), (unsigned)B,
                  kn.chunks);
  return launch(kn.fn, grid, kn.threads, kn.smem, st, args);
}

// As ofd_flash_bwd_dq; dk [B, Lk, C] and dv [B, Lk, D] f32. splits > 1 cuts
// the query sweep: dk and dv are then [splits, B, Lk, C | D] scratches of
// unscaled partial sums.
extern "C" int ofd_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                 const void* g, const void* lse,
                                 const void* delta, void* dk, void* dv, int B,
                                 int Lq, int Lk, int C, int D, float scale,
                                 int swin_k, int wh, int ww, int sh, int swd,
                                 int is_bf16, int route, int splits,
                                 void* stream) {
  if (!valid(B, Lq, Lk, C, D, swin_k) ||
      !route_takes(route, is_bf16, B, Lq, Lk, C, D) ||
      (splits != 1 && route != TF32X3))
    return (int)cudaErrorInvalidValue;
  Swin sw{swin_k, wh, ww, sh, swd};
  cudaStream_t st = (cudaStream_t)stream;
  if (route == TF32X3)
    return D == 2 ? tf32x3::launch_dkv<true>(q, k, v, g, lse, delta, dk, dv,
                                             B, Lq, Lk, scale, sw, splits, st)
                  : tf32x3::launch_dkv<false>(q, k, v, g, lse, delta, dk, dv,
                                              B, Lq, Lk, scale, sw, splits,
                                              st);
  if (route == WGMMA)
    return sm90::launch(true, q, k, v, g, lse, delta, dk, dv, B, Lq, Lk, C, D,
                        scale, sw, st);
  Kernel kn = kernel_of(route, true, C, D);
  void* args[] = {(void*)&q,  (void*)&k,     (void*)&v,  (void*)&g,
                  (void*)&lse, (void*)&delta, (void*)&dk, (void*)&dv,
                  (void*)&Lq, (void*)&Lk,    (void*)&C,  (void*)&D,
                  (void*)&scale, (void*)&sw, (void*)&kn.res};
  const dim3 grid((unsigned)((Lk + kn.rows - 1) / kn.rows), (unsigned)B,
                  kn.chunks);
  return launch(kn.fn, grid, kn.threads, kn.smem, st, args);
}

// What ofd_flash_bwd_dq (dkv = 0) or ofd_flash_bwd_dkv (dkv = 1) launches
// for these operands (padded widths) on the route of the wrapper's rule
// (ops/flash_bwd.py:plan): bf16 at C = 128 and D = 128 or 2, or C = 256 and
// D = 256 or 2, the wgmma route, other bf16 the mma.sync route; f32 at C =
// 128 and D = 128 or 2 the tf32x3
// route, other f32 the CUDA-core route. plan = {route (enum Route), output
// rows a block, threads a block, blocks of one run (row blocks x B x
// column chunks), column chunks, dynamic shared memory, static shared
// memory (bytes), blocks resident per SM, registers a thread, local memory
// a thread (bytes: spills and stack)}. Returns a cudaError_t (0 on
// success): a block the SM cannot hold fails here.
extern "C" int ofd_flash_bwd_plan(int B, int Lq, int Lk, int C, int D,
                                  int is_bf16, int dkv, int* plan) {
  if (!valid(B, Lq, Lk, C, D, 0)) return (int)cudaErrorInvalidValue;
  const int route =
      is_bf16 ? (route_takes(WGMMA, 1, B, Lq, Lk, C, D) ? WGMMA : MMA_SYNC)
              : (tf32x3::takes(B, Lq, Lk, C, D) ? TF32X3 : F32);
  const Kernel kn = kernel_of(route, dkv != 0, C, D);
  cudaFuncAttributes attr;
  int per_sm = 0, e;
  if ((e = (int)cudaFuncGetAttributes(&attr, kn.fn))) return e;
  // raised as the launch raises it, never lowered: one kernel serves
  // every width, and a launch below the default limit does not set it
  if (kn.smem > SMEM_DEFAULT &&
      (e = (int)cudaFuncSetAttribute(
           kn.fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kn.smem)))
    return e;
  if ((e = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kn.fn, kn.threads, kn.smem)))
    return e;
  const int L = dkv ? Lk : Lq;
  const int got[10] = {route, kn.rows, kn.threads,
                       B * ((L + kn.rows - 1) / kn.rows) * (int)kn.chunks,
                       (int)kn.chunks, (int)kn.smem,
                       (int)attr.sharedSizeBytes, per_sm, attr.numRegs,
                       (int)attr.localSizeBytes};
  for (int i = 0; i < 10; ++i) plan[i] = got[i];
  return 0;
}

// out [n] = mult * the sum over the `splits` partials of part [splits, n],
// in split order (the tf32x3 route's split sweeps).
extern "C" int ofd_flash_bwd_reduce(const void* part, void* out, long long n,
                                    int splits, float mult, void* stream) {
  if (n < 1 || splits < 1) return (int)cudaErrorInvalidValue;
  const long long blocks = (n + 255) / 256;
  tf32x3::reduce_splits<<<(unsigned)(blocks < 1056 ? blocks : 1056), 256, 0,
                          (cudaStream_t)stream>>>(
      (const float*)part, (float*)out, n, splits, mult);
  return (int)cudaGetLastError();
}
