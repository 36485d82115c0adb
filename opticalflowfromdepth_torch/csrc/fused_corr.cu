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

#include "hopper.cuh"

typedef __nv_bfloat16 bf16;

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

// Backward of the lookup, for Hopper (sm_90a).
//
// Replaces the TPU kernel opticalflowfromdepth_tpu/ops/fused_corr.py:
// _bwd_kernel (launched by _cat_bwd). The cotangent g[q, l, kx, ky] goes
// back through the forward's x-stage and y-stage (the transposed bilinear
// weights) to the (2r+2)^2 integer taps around coords[q] / 2^l; the taps
// inside the level form d_corr [B, N, R], and
//   df1 = s d_corr . f2cat,   df2cat = s d_corr^T . f1,   s = 1/sqrt(C).
// Coordinates get no gradient, by contract. Padded rows (hl <= y < hp)
// get exactly 0, and so does everything of a query far out of range (its
// centre is clamped before the int conversion exactly as in the forward,
// so none of its taps is inside a level).
//
// The TPU kernel forms the dense [R, block] d_corr tile and runs the two
// matmuls; this design does the same in three passes, in the image of the
// flash backward's two, with no float atomics anywhere, so every launch on
// the same inputs gives the same bits:
//   (a) corr_bwd_taps, one warp per query: per level the window origin
//       (ix0, iy0) and the (2r+2)^2 tap gradients, s folded in, into a
//       scratch dtap [B, L, Npad, taps] f32 and orig [B, L, Npad] int2
//       (queries N..Npad and levels pooled away get an origin that no row
//       matches); and the row table tab [T * 64]: the packed rows cut into
//       T tiles of 64 that never straddle a level, each row's (x << 16 | y)
//       in its level, -1 for a padded row, -2 past the level's end.
//       d_corr[q, row] is then one look-up: a row of the tile's level is
//       tap (x - ix0, y - iy0) of q if both lie in [0, 2r+2), else 0.
//   (b) df1: one block per (batch entry, 128 queries) sweeps the T row
//       tiles in order and accumulates d_corr . f2cat;
//   (c) df2cat: one block per (batch entry, two row tiles of a level)
//       sweeps the query tiles in order and accumulates d_corr^T . f1;
//       on the tensor cores (b) and (c) are one launch, so that the
//       blocks of each fill the other's tail wave.
// Each output is written once, in its input's dtype.
//
// bf16 at C = 128 or 256 (RAFT-basic's 256): (b) and (c) on the tensor
// cores, two warpgroups a block, 64 output rows each. The streamed side
// (f2cat row tiles in (b); f1 query tiles, with their dtap slab and
// origins, in (c)) comes in by TMA and bulk copies through a 2-stage ring
// under mbarriers; (b) keeps the dtap slab of its 128 queries for the
// current level in shared memory, reloaded when the sweep enters a level.
// Each thread forms its own elements of the d_corr tile straight into
// wgmma A fragments (registers), split into bf16 hi + lo (lo the bf16
// rounding of d - hi): one bf16 rounding of d_corr is too coarse for the
// coarse levels, whose rows sum over every query; the features are bf16
// already, so both products are exact and sum into one f32 accumulator.
// Then acc += hi . B + lo . B with wgmma m64n128k16, B the ring tile read
// MN-major through the transpose bit; the fragments of the next tile are
// formed while these products run. What bounds it: the dense products,
// 2 x 2 x 2 B N R C operations (hi and lo, both outputs), over the bf16
// tensor cores; the scratch (~400 B a query and level) is written once
// and read twice. Tiles that no window touches are not skipped: a query
// tile of image rows spans every column of the x-major levels.
//
// Other widths and f32 operands (f32 models, the parity runs): the same
// passes on the CUDA cores in f32: (b) one warp per query sums its
// in-range taps in tap order; (c) one warp per packed row scans the
// queries in order (their origins staged in shared memory per chunk).
// C % 8 == 0 up to 512.

namespace corr_sm90 {

using namespace hopper;

constexpr int TILE = 64;
constexpr int STAGES = 2;
constexpr int PANEL = 64 * 64;            // bf16 of a [64 rows][64] panel
constexpr uint32_t PANEL_BYTES = PANEL * 2;
constexpr int TAPS_MAX = 100;             // (2r + 2)^2 at r <= 4
constexpr int THREADS = 256;              // two warpgroups
constexpr int LOADER = 4;                 // warpgroup 1's first warp
constexpr int FAR = -(1 << 20);           // an origin that no row matches

}  // namespace corr_sm90

// Tile `tile` of the packed rows cut level by level into 64-row tiles:
// its level, first row and the rows of its level from there (may exceed
// 64). Returns false past the last tile.
__host__ __device__ __forceinline__ bool level_tile(const Meta& m, int L,
                                                    int tile, int* level,
                                                    int* row0, int* rows) {
  for (int l = 0; l < L; ++l) {
    if (m.hl[l] == 0 || m.wl[l] == 0) continue;
    const int n = m.wl[l] * m.hp[l];
    const int tiles = (n + corr_sm90::TILE - 1) / corr_sm90::TILE;
    if (tile < tiles) {
      *level = l;
      *row0 = m.off[l] + tile * corr_sm90::TILE;
      *rows = n - tile * corr_sm90::TILE;
      return true;
    }
    tile -= tiles;
  }
  return false;
}

static int count_tiles(const Meta& m, int L) {
  int t = 0;
  for (int l = 0; l < L; ++l)
    if (m.hl[l] && m.wl[l])
      t += (m.wl[l] * m.hp[l] + corr_sm90::TILE - 1) / corr_sm90::TILE;
  return t;
}

__device__ __forceinline__ float load1(const float* p) { return *p; }

__device__ __forceinline__ float load1(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

// (a) One warp per (batch entry, query < Npad); the grid's threads also
// fill the row table. The warp loads the query's whole cotangent (every
// level) into shared memory at once, then writes each level's taps.
template <typename T>
__global__ void __launch_bounds__(WARPS * 32)
corr_bwd_taps(const T* __restrict__ g, const float* __restrict__ coords,
              float* __restrict__ dtap, int2* __restrict__ orig,
              int* __restrict__ tab, int B, int N, int Npad, int L, int n_tab,
              Meta meta, int radius, float scale) {
  __shared__ float gs[WARPS][MAX_LEVELS * 81];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n_tab;
       i += gridDim.x * blockDim.x) {
    int level, row0, rows;
    int entry = -2;
    if (level_tile(meta, L, i / corr_sm90::TILE, &level, &row0, &rows) &&
        i % corr_sm90::TILE < rows) {
      const int hp = meta.hp[level];
      const int rr = row0 - meta.off[level] + i % corr_sm90::TILE;
      const int x = rr / hp, y = rr - x * hp;
      entry = y < meta.hl[level] ? (x << 16) | y : -1;
    }
    tab[i] = entry;
  }
  const long long w = (long long)blockIdx.x * WARPS + warp;  // flat (b, q)
  if (w >= (long long)B * Npad) return;  // uniform over the warp
  const int b = (int)(w / Npad), q = (int)(w - (long long)b * Npad);
  const int K = 2 * radius + 1, K1 = K + 1, taps = K1 * K1;
  // t / K1 for t < 128 as (t * inv) >> 16, exact for K1 <= 10
  const int inv = (65536 + K1 - 1) / K1;
  float* gw = gs[warp];
  const long long qi = (long long)b * N + q;
  if (q < N) {
    const T* gq = g + qi * (long long)(L * K * K);
    for (int t = lane; t < L * K * K; t += 32) gw[t] = load1(gq + t);
  }
  const float cx = q < N ? coords[2 * qi] : 0.f;
  const float cy = q < N ? coords[2 * qi + 1] : 0.f;
  __syncwarp();
  for (int l = 0; l < L; ++l) {
    const long long at = ((long long)b * L + l) * Npad + q;
    const int hl = meta.hl[l], wl = meta.wl[l];
    if (q >= N || hl == 0 || wl == 0) {
      if (lane == 0) orig[at] = make_int2(corr_sm90::FAR, corr_sm90::FAR);
      continue;
    }
    const float s = 1.0f / (float)(1 << l);
    const float x = cx * s, y = cy * s;
    const float x0 = floorf(x), y0 = floorf(y);
    const float fx = x - x0, fy = y - y0;
    const int ix0 =
        (int)fminf(fmaxf(x0, -radius - 2.f), (float)(wl + radius)) - radius;
    const int iy0 =
        (int)fminf(fmaxf(y0, -radius - 2.f), (float)(hl + radius)) - radius;
    if (lane == 0) orig[at] = make_int2(ix0, iy0);
    // transpose of the forward's two stages: tap (i, j) takes window
    // (kx, ky) = (i, j) with weights (1-fx)(1-fy), (i-1, j) with fx(1-fy),
    // (i, j-1) with (1-fx)fy and (i-1, j-1) with fx fy
    const float* gl = gw + l * K * K;
    float* dq = dtap + at * taps;
    for (int t = lane; t < taps; t += 32) {
      const int i = (t * inv) >> 16, j = t - i * K1;
      float v = 0.f;
      if (i < K) {
        if (j < K) v += (1.f - fx) * (1.f - fy) * gl[i * K + j];
        if (j > 0) v += (1.f - fx) * fy * gl[i * K + j - 1];
      }
      if (i > 0) {
        if (j < K) v += fx * (1.f - fy) * gl[(i - 1) * K + j];
        if (j > 0) v += fx * fy * gl[(i - 1) * K + j - 1];
      }
      dq[t] = v * scale;
    }
  }
}

// d_corr of one (query, row): the row's packed (x, y) against the query's
// window origin at the row's level.
__device__ __forceinline__ float dcorr(int entry, int2 o, const float* dt,
                                       int K1) {
  if (entry < 0) return 0.f;
  const int dx = (entry >> 16) - o.x, dy = (entry & 0xffff) - o.y;
  return (unsigned)dx < (unsigned)K1 && (unsigned)dy < (unsigned)K1
             ? dt[dx * K1 + dy]
             : 0.f;
}

// two f32 values -> their bf16 hi parts and the bf16 rounding of what is
// left, each as bf16x2 (`a` in the low half)
__device__ __forceinline__ void split2(float a, float b, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 r = __floats2bfloat162_rn(a - hf.x, b - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&r);
}

namespace corr_sm90 {

// acc[NP/2][64 x 128] += F . B over one 64-row tile: F the A fragments of
// the [64][64] d_corr tile (hi, then lo; four k16 steps each), B the ring
// tile [64 rows][64 * NP] read MN-major, 16 rows a step.
template <int NP>
__device__ __forceinline__ void product_split(float (&acc)[NP / 2][64],
                                              const uint32_t (&hi)[16],
                                              const uint32_t (&lo)[16],
                                              const bf16* b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int h = 0; h < NP / 2; ++h) {
      const uint64_t d =
          desc_sw128(b + h * 2 * PANEL + kk * 16 * 64, PANEL_BYTES, 1024);
      wgmma_m64n128_rs_tb(acc[h], &hi[4 * kk], d);
      wgmma_m64n128_rs_tb(acc[h], &lo[4 * kk], d);
    }
}

template <int NP>
struct Df1Smem {
  alignas(1024) bf16 f2[STAGES][NP][PANEL];
  float dtap[2 * TILE * TAPS_MAX];  // the block's queries at one level
  uint64_t full[STAGES], empty[STAGES];
};

template <int NP>
struct Df2Smem {
  alignas(1024) bf16 f1[STAGES][NP][PANEL];
  alignas(16) float dtap[STAGES][TILE * TAPS_MAX];
  alignas(16) int2 orig[STAGES][TILE];
  uint64_t full[STAGES], empty[STAGES];
};

template <typename S>
__device__ __forceinline__ S& aligned_smem() {
  extern __shared__ unsigned char smem_raw[];
  return *reinterpret_cast<S*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);
}

template <typename S>
__device__ __forceinline__ void init_ring(S& sm) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&sm.full[s], 1);          // the loading lane arrives
      mbar_init(&sm.empty[s], THREADS);   // every thread arrives
    }
    mbar_fence_init();
  }
  __syncthreads();
}

// (b) df1 [B, N, C] bf16: block (128 queries, batch entry); warpgroup wg
// owns queries q0 + 64 wg.. . tm_f2 maps f2cat [B, R, C] in [1, 64, 64]
// boxes.
template <int NP>
__device__ __forceinline__ void corr_bwd_df1(
    int bx, int b, const CUtensorMap& tm_f2, const float* __restrict__ dtap,
    const int2* __restrict__ orig, const int* __restrict__ tab,
    bf16* __restrict__ df1, int N, int Npad, int L, int n_tiles,
    const Meta& meta, int K1) {
  Df1Smem<NP>& sm = aligned_smem<Df1Smem<NP>>();
  const int q0 = bx * 2 * TILE;
  const int taps = K1 * K1;
  init_ring(sm);
  auto stage = [&](int it) {
    int level, row0, rows;
    level_tile(meta, L, it, &level, &row0, &rows);
    const int s = it % STAGES;
    mbar_expect_tx(&sm.full[s], NP * PANEL_BYTES);
    for (int p = 0; p < NP; ++p)
      tma_load_3d(sm.f2[s][p], &tm_f2, &sm.full[s], p * 64, row0, b);
  };
  if (threadIdx.x == LOADER * 32)
    for (int it = 0; it < STAGES && it < n_tiles; ++it) stage(it);

  const int wg = threadIdx.x / 128, tid = threadIdx.x & 127;
  const int warp = tid >> 5, lane = tid & 31, gq = lane >> 2, t = lane & 3;
  const int ql = wg * TILE + warp * 16 + gq;  // rows ql, ql + 8 of the block
  float acc[NP / 2][64];
#pragma unroll
  for (int h = 0; h < NP / 2; ++h)
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[h][i] = 0.f;
  int cur = -1;
  int2 o[2];
  // the A fragments of tile it's d_corr (hi, lo), formed in registers; on
  // entering a level the block first loads its queries' dtap slab
  auto form = [&](int it, uint32_t (&hi)[16], uint32_t (&lo)[16]) {
    int level, row0, rows;
    level_tile(meta, L, it, &level, &row0, &rows);
    if (level != cur) {  // uniform: every thread forms the same tile
      __syncthreads();
      const float4* src = reinterpret_cast<const float4*>(
          dtap + (((long long)b * L + level) * Npad + q0) * taps);
      float4* dst = reinterpret_cast<float4*>(sm.dtap);
      for (int i = threadIdx.x; i < 2 * TILE * taps / 4; i += THREADS)
        dst[i] = src[i];
#pragma unroll
      for (int r = 0; r < 2; ++r)
        o[r] = orig[((long long)b * L + level) * Npad + q0 + ql + 8 * r];
      cur = level;
      __syncthreads();
    }
    const int* et = tab + (long long)it * TILE;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int c = 16 * kk + 8 * half + 2 * t;
        const int e0 = __ldg(et + c), e1 = __ldg(et + c + 1);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float* dt = sm.dtap + (ql + 8 * r) * taps;
          split2(dcorr(e0, o[r], dt, K1), dcorr(e1, o[r], dt, K1),
                 hi[4 * kk + 2 * half + r], lo[4 * kk + 2 * half + r]);
        }
      }
    }
  };

  // software-pipelined by one tile: tile it + 1's fragments are formed
  // while tile it's products run
  uint32_t hi[16], lo[16], hi_n[16], lo_n[16];
  if (n_tiles > 0) form(0, hi, lo);
  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % STAGES;
    mbar_wait(&sm.full[s], (it / STAGES) & 1);
    wgmma_fence();
    product_split<NP>(acc, hi, lo, sm.f2[s][0]);
    wgmma_commit();
    if (it + 1 < n_tiles) form(it + 1, hi_n, lo_n);
    wgmma_wait<0>();
#pragma unroll
    for (int h = 0; h < NP / 2; ++h) fence_regs(acc[h]);
    fence_regs(hi);
    fence_regs(lo);
    mbar_arrive(&sm.empty[s]);
    if (threadIdx.x == LOADER * 32 && it + STAGES < n_tiles) {
      mbar_wait(&sm.empty[s], (it / STAGES) & 1);
      stage(it + STAGES);
    }
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      hi[i] = hi_n[i];
      lo[i] = lo_n[i];
    }
  }

  constexpr int C = NP * 64;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int q = q0 + ql + 8 * r;
    if (q >= N) continue;
    bf16* out = df1 + ((long long)b * N + q) * C;
#pragma unroll
    for (int h = 0; h < NP / 2; ++h)
#pragma unroll
      for (int j = 0; j < 16; ++j)
        *reinterpret_cast<__nv_bfloat162*>(out + h * 128 + 8 * j + 2 * t) =
            __floats2bfloat162_rn(acc[h][4 * j + 2 * r],
                                  acc[h][4 * j + 2 * r + 1]);
  }
}

// The row blocks of pass (c): per level, pairs of its 64-row tiles.
// Block `blk` -> its level and its first tile's index among all tiles.
__device__ __forceinline__ void row_block(const Meta& m, int L, int blk,
                                          int* level, int* tile0,
                                          int* tiles_left) {
  int base = 0;
  for (int l = 0; l < L; ++l) {
    if (m.hl[l] == 0 || m.wl[l] == 0) continue;
    const int tiles = (m.wl[l] * m.hp[l] + TILE - 1) / TILE;
    const int pairs = (tiles + 1) / 2;
    if (blk < pairs) {
      *level = l;
      *tile0 = base + 2 * blk;
      *tiles_left = tiles - 2 * blk;
      return;
    }
    blk -= pairs;
    base += tiles;
  }
  *level = -1;
  *tile0 = 0;
  *tiles_left = 0;
}

// (c) df2cat [B, R, C] bf16: block (two row tiles of one level, batch
// entry); warpgroup wg owns tile tile0 + wg. tm_f1 maps f1 [B, N, C] in
// [1, 64, 64] boxes; each query tile's dtap slab and origins at the
// block's level come in by bulk copies on the same barrier.
template <int NP>
__device__ __forceinline__ void corr_bwd_df2(
    int bx, int b, const CUtensorMap& tm_f1, const float* __restrict__ dtap,
    const int2* __restrict__ orig, const int* __restrict__ tab,
    bf16* __restrict__ df2, int N, int Npad, int R, int L, const Meta& meta,
    int K1) {
  Df2Smem<NP>& sm = aligned_smem<Df2Smem<NP>>();
  const int taps = K1 * K1;
  int level, tile0, tiles_left;
  row_block(meta, L, bx, &level, &tile0, &tiles_left);
  const int n_q = (N + TILE - 1) / TILE;
  init_ring(sm);
  const long long slab = ((long long)b * L + level) * Npad;
  auto stage = [&](int it) {
    const int s = it % STAGES, q0 = it * TILE;
    mbar_expect_tx(&sm.full[s], NP * PANEL_BYTES + TILE * taps * 4 +
                                    TILE * (uint32_t)sizeof(int2));
    for (int p = 0; p < NP; ++p)
      tma_load_3d(sm.f1[s][p], &tm_f1, &sm.full[s], p * 64, q0, b);
    bulk_load(sm.dtap[s], dtap + (slab + q0) * taps, TILE * taps * 4,
              &sm.full[s]);
    bulk_load(sm.orig[s], orig + slab + q0, TILE * sizeof(int2),
              &sm.full[s]);
  };
  if (threadIdx.x == LOADER * 32)
    for (int it = 0; it < STAGES && it < n_q; ++it) stage(it);

  const int wg = threadIdx.x / 128, tid = threadIdx.x & 127;
  const int warp = tid >> 5, lane = tid & 31, gq = lane >> 2, t = lane & 3;
  const bool idle = wg >= tiles_left;
  const int rl = warp * 16 + gq;  // rows rl, rl + 8 of the warpgroup's tile
  int entry[2];
#pragma unroll
  for (int r = 0; r < 2; ++r)
    entry[r] = idle ? -2 : tab[(long long)(tile0 + wg) * TILE + rl + 8 * r];
  float acc[NP / 2][64];
#pragma unroll
  for (int h = 0; h < NP / 2; ++h)
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[h][i] = 0.f;

  // the A fragments of query tile it's d_corr^T (hi, lo): rows the
  // warpgroup's tile's, columns the tile's queries
  auto form = [&](int it, uint32_t (&hi)[16], uint32_t (&lo)[16]) {
    const int s = it % STAGES;
    mbar_wait(&sm.full[s], (it / STAGES) & 1);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int c = 16 * kk + 8 * half + 2 * t;
        const int2 o0 = sm.orig[s][c], o1 = sm.orig[s][c + 1];
        const float* d0 = sm.dtap[s] + c * taps;
#pragma unroll
        for (int r = 0; r < 2; ++r)
          split2(dcorr(entry[r], o0, d0, K1),
                 dcorr(entry[r], o1, d0 + taps, K1),
                 hi[4 * kk + 2 * half + r], lo[4 * kk + 2 * half + r]);
      }
    }
  };

  // software-pipelined by one tile, as in pass (b)
  uint32_t hi[16], lo[16], hi_n[16], lo_n[16];
  if (!idle && n_q > 0) form(0, hi, lo);
  for (int it = 0; it < n_q; ++it) {
    const int s = it % STAGES;
    mbar_wait(&sm.full[s], (it / STAGES) & 1);
    if (!idle) {
      wgmma_fence();
      product_split<NP>(acc, hi, lo, sm.f1[s][0]);
      wgmma_commit();
      if (it + 1 < n_q) form(it + 1, hi_n, lo_n);
      wgmma_wait<0>();
#pragma unroll
      for (int h = 0; h < NP / 2; ++h) fence_regs(acc[h]);
      fence_regs(hi);
      fence_regs(lo);
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        hi[i] = hi_n[i];
        lo[i] = lo_n[i];
      }
    }
    mbar_arrive(&sm.empty[s]);
    if (threadIdx.x == LOADER * 32 && it + STAGES < n_q) {
      mbar_wait(&sm.empty[s], (it / STAGES) & 1);
      stage(it + STAGES);
    }
  }

  if (idle) return;
  constexpr int C = NP * 64;
  int lv, row0, rows;
  level_tile(meta, L, tile0 + wg, &lv, &row0, &rows);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (entry[r] == -2) continue;  // past the level's end
    const long long row = row0 + rl + 8 * r;
    if (row >= R) continue;
    bf16* out = df2 + ((long long)b * R + row) * C;
#pragma unroll
    for (int h = 0; h < NP / 2; ++h)
#pragma unroll
      for (int j = 0; j < 16; ++j)
        *reinterpret_cast<__nv_bfloat162*>(out + h * 128 + 8 * j + 2 * t) =
            __floats2bfloat162_rn(acc[h][4 * j + 2 * r],
                                  acc[h][4 * j + 2 * r + 1]);
  }
}

// (b) and (c) in one launch, so that the blocks of each fill the other's
// tail wave: blocks [0, n1) take df1 (the longer sweeps, dispatched
// first), the rest df2cat; n1 = B * Npad / 128.
template <int NP>
__global__ void __launch_bounds__(THREADS, 1)
corr_bwd_products(const __grid_constant__ CUtensorMap tm_f1,
                  const __grid_constant__ CUtensorMap tm_f2,
                  const float* __restrict__ dtap,
                  const int2* __restrict__ orig, const int* __restrict__ tab,
                  bf16* __restrict__ df1, bf16* __restrict__ df2, int N,
                  int Npad, int R, int L, int n_tiles, int n1, Meta meta,
                  int K1) {
  const int per_b1 = Npad / (2 * TILE);
  if ((int)blockIdx.x < n1) {
    corr_bwd_df1<NP>(blockIdx.x % per_b1, blockIdx.x / per_b1, tm_f2, dtap,
                     orig, tab, df1, N, Npad, L, n_tiles, meta, K1);
  } else {
    const int n2_b = (gridDim.x - n1) / (n1 / per_b1);  // row blocks an entry
    const int i = blockIdx.x - n1;
    corr_bwd_df2<NP>(i % n2_b, i / n2_b, tm_f1, dtap, orig, tab, df2, N, Npad,
                     R, L, meta, K1);
  }
}

template <int NP>
static int launch(const void* f1, const void* f2cat, const float* dtap,
                  const int2* orig, const int* tab, void* df1, void* df2,
                  int B, int N, int Npad, int R, int L, int n_tiles,
                  const Meta& meta, int K1, cudaStream_t st) {
  CUtensorMap m_f1, m_f2;
  int e;
  if ((e = tensor_map_bf16_3d(&m_f1, f1, NP * 64, N, B, TILE))) return e;
  if ((e = tensor_map_bf16_3d(&m_f2, f2cat, NP * 64, R, B, TILE))) return e;
  const size_t s1 = sizeof(Df1Smem<NP>), s2 = sizeof(Df2Smem<NP>);
  const size_t smem = (s1 > s2 ? s1 : s2) + 1024;
  if ((e = (int)cudaFuncSetAttribute(corr_bwd_products<NP>,
                                     cudaFuncAttributeMaxDynamicSharedMemorySize,
                                     (int)smem)))
    return e;
  int row_blocks = 0;
  for (int l = 0; l < L; ++l)
    if (meta.hl[l] && meta.wl[l])
      row_blocks += ((meta.wl[l] * meta.hp[l] + TILE - 1) / TILE + 1) / 2;
  const int n1 = B * (Npad / (2 * TILE));
  corr_bwd_products<NP><<<(unsigned)(n1 + B * row_blocks), THREADS, smem,
                          st>>>(m_f1, m_f2, dtap, orig, tab, (bf16*)df1,
                                (bf16*)df2, N, Npad, R, L, n_tiles, n1, meta,
                                K1);
  return (int)cudaGetLastError();
}

}  // namespace corr_sm90

// (b) on the CUDA cores: one warp per query sums d_tap * f2cat[row] over
// its in-range taps, level by level in tap order; df1 in T.
template <typename T>
__global__ void __launch_bounds__(WARPS * 32)
corr_bwd_df1_cc(const T* __restrict__ f2cat, const float* __restrict__ dtap,
                const int2* __restrict__ orig, T* __restrict__ df1, int B,
                int N, int Npad, int C, int R, int L, Meta meta, int K1) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long q = (long long)blockIdx.x * WARPS + warp;  // flat (b, n)
  if (q >= (long long)B * N) return;  // uniform over the warp
  const int b = (int)(q / N), n = (int)(q - (long long)b * N);
  const int taps = K1 * K1;
  float acc[MAX_CHUNKS][VEC];
#pragma unroll
  for (int ch = 0; ch < MAX_CHUNKS; ++ch)
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[ch][i] = 0.f;
  const T* f2b = f2cat + (long long)b * R * C;
  for (int l = 0; l < L; ++l) {
    const int hl = meta.hl[l], wl = meta.wl[l], hp = meta.hp[l];
    if (hl == 0 || wl == 0) continue;
    const long long at = ((long long)b * L + l) * Npad + n;
    const int2 o = orig[at];
    const float* dt = dtap + at * taps;
    for (int t = 0; t < taps; ++t) {
      const int xx = o.x + t / K1, yy = o.y + t % K1;
      if (xx < 0 || xx >= wl || yy < 0 || yy >= hl) continue;  // uniform
      const float d = dt[t];
      const T* f2row = f2b + ((long long)meta.off[l] + (long long)xx * hp + yy) * C;
#pragma unroll
      for (int ch = 0; ch < MAX_CHUNKS; ++ch) {
        const int c = (ch * 32 + lane) * VEC;
        if (c < C) {
          float v[VEC];
          load8(f2row + c, v);
#pragma unroll
          for (int i = 0; i < VEC; ++i) acc[ch][i] = fmaf(d, v[i], acc[ch][i]);
        }
      }
    }
  }
  T* out = df1 + q * C;
#pragma unroll
  for (int ch = 0; ch < MAX_CHUNKS; ++ch) {
    const int c = (ch * 32 + lane) * VEC;
    if (c < C)
#pragma unroll
      for (int i = 0; i < VEC; ++i) store1(out + c + i, acc[ch][i]);
  }
}

#define CC_CHUNK 256  // queries whose origins a block stages at a time

// (c) on the CUDA cores: one warp per packed row (8 rows of one tile a
// block) scans the queries in order and sums d_corr * f1[q]; df2cat in T.
template <typename T>
__global__ void __launch_bounds__(WARPS * 32)
corr_bwd_df2_cc(const T* __restrict__ f1, const float* __restrict__ dtap,
                const int2* __restrict__ orig, const int* __restrict__ tab,
                T* __restrict__ df2, int N, int Npad, int C, int R, int L,
                Meta meta, int K1) {
  __shared__ int2 os[CC_CHUNK];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.y;
  const int tile = blockIdx.x / (corr_sm90::TILE / WARPS);
  const int rl = (blockIdx.x % (corr_sm90::TILE / WARPS)) * WARPS + warp;
  int level, row0, rows;
  level_tile(meta, L, tile, &level, &row0, &rows);
  const int entry = tab[(long long)tile * corr_sm90::TILE + rl];
  const int taps = K1 * K1;
  const long long slab = ((long long)b * L + level) * Npad;
  float acc[MAX_CHUNKS][VEC];
#pragma unroll
  for (int ch = 0; ch < MAX_CHUNKS; ++ch)
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[ch][i] = 0.f;
  for (int c0 = 0; c0 < N; c0 += CC_CHUNK) {
    __syncthreads();
    for (int i = threadIdx.x; i < CC_CHUNK; i += WARPS * 32)
      os[i] = orig[slab + (c0 + i < Npad ? c0 + i : 0)];
    __syncthreads();
    if (entry < 0) continue;  // uniform over the warp
    const int n_end = N - c0 < CC_CHUNK ? N - c0 : CC_CHUNK;
    for (int i = 0; i < n_end; ++i) {
      const float d = dcorr(entry, os[i], dtap + (slab + c0 + i) * taps, K1);
      if (d == 0.f) continue;  // uniform: one row, one query
      const T* f1row = f1 + ((long long)b * N + c0 + i) * C;
#pragma unroll
      for (int ch = 0; ch < MAX_CHUNKS; ++ch) {
        const int c = (ch * 32 + lane) * VEC;
        if (c < C) {
          float v[VEC];
          load8(f1row + c, v);
#pragma unroll
          for (int k = 0; k < VEC; ++k) acc[ch][k] = fmaf(d, v[k], acc[ch][k]);
        }
      }
    }
  }
  if (entry == -2) return;  // past the level's end: another tile's row
  T* out = df2 + ((long long)b * R + row0 + rl) * C;
#pragma unroll
  for (int ch = 0; ch < MAX_CHUNKS; ++ch) {
    const int c = (ch * 32 + lane) * VEC;
    if (c < C)
#pragma unroll
      for (int i = 0; i < VEC; ++i) store1(out + c + i, acc[ch][i]);
  }
}

// g: [B, N, L*(2r+1)^2] in the features' dtype; df1 [B, N, C] and df2
// [B, R, C] in that dtype, each written in full. Scratch from the caller:
// dtap [B, L, Npad, (2r+2)^2] f32, orig [B, L, Npad] int2 and tab [T * 64]
// int32, with Npad = N rounded up to a multiple of 128 and T the 64-row
// tiles of the levels (each level's wl * hp rows rounded up to 64). bf16
// at C = 128 or 256 takes the tensor-core route, everything else the
// CUDA-core one. Returns the first CUDA error of the three launches (0 on
// success).
extern "C" int ofd_fused_corr_bwd(const void* g, const void* f1,
                                  const void* f2cat, const void* coords,
                                  void* df1, void* df2, void* dtap,
                                  void* orig, void* tab, int B, int N, int C,
                                  int R, int L, const int* meta, int radius,
                                  float scale, int is_bf16, void* stream) {
  Meta m;
  if (!unpack_meta(L, C, radius, meta, &m) || B < 1 || B > 65535)
    return (int)cudaErrorInvalidValue;
  if (N == 0) return 0;
  const int Npad = (N + 127) / 128 * 128, K1 = 2 * radius + 2;
  const int n_tiles = count_tiles(m, L);
  cudaStream_t st = (cudaStream_t)stream;
  float* dt = (float*)dtap;
  int2* og = (int2*)orig;
  int* tb = (int*)tab;
  const long long warps = (long long)B * Npad;
  const dim3 grid_a((unsigned)((warps + WARPS - 1) / WARPS));
  if (is_bf16)
    corr_bwd_taps<__nv_bfloat16><<<grid_a, WARPS * 32, 0, st>>>(
        (const __nv_bfloat16*)g, (const float*)coords, dt, og, tb, B, N, Npad,
        L, n_tiles * corr_sm90::TILE, m, radius, scale);
  else
    corr_bwd_taps<float><<<grid_a, WARPS * 32, 0, st>>>(
        (const float*)g, (const float*)coords, dt, og, tb, B, N, Npad, L,
        n_tiles * corr_sm90::TILE, m, radius, scale);
  int e = (int)cudaGetLastError();
  if (e) return e;
  if (is_bf16 && (C == 128 || C == 256) &&
      (long long)B * (N > R ? N : R) < (1ll << 31))
    return C == 256 ? corr_sm90::launch<4>(f1, f2cat, dt, og, tb, df1, df2, B,
                                           N, Npad, R, L, n_tiles, m, K1, st)
                    : corr_sm90::launch<2>(f1, f2cat, dt, og, tb, df1, df2, B,
                                           N, Npad, R, L, n_tiles, m, K1, st);
  const dim3 grid_b((unsigned)(((long long)B * N + WARPS - 1) / WARPS));
  const dim3 grid_c((unsigned)(n_tiles * (corr_sm90::TILE / WARPS)),
                    (unsigned)B);
  if (is_bf16) {
    corr_bwd_df1_cc<__nv_bfloat16><<<grid_b, WARPS * 32, 0, st>>>(
        (const __nv_bfloat16*)f2cat, dt, og, (__nv_bfloat16*)df1, B, N, Npad,
        C, R, L, m, K1);
    if ((e = (int)cudaGetLastError()) || n_tiles == 0) return e;
    corr_bwd_df2_cc<__nv_bfloat16><<<grid_c, WARPS * 32, 0, st>>>(
        (const __nv_bfloat16*)f1, dt, og, tb, (__nv_bfloat16*)df2, N, Npad, C,
        R, L, m, K1);
  } else {
    corr_bwd_df1_cc<float><<<grid_b, WARPS * 32, 0, st>>>(
        (const float*)f2cat, dt, og, (float*)df1, B, N, Npad, C, R, L, m, K1);
    if ((e = (int)cudaGetLastError()) || n_tiles == 0) return e;
    corr_bwd_df2_cc<float><<<grid_c, WARPS * 32, 0, st>>>(
        (const float*)f1, dt, og, tb, (float*)df2, N, Npad, C, R, L, m, K1);
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
