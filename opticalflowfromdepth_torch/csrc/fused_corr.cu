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
// alt_cuda_corr): per query and level the dot products of f1[q] with the
// f2 rows at the (2r+2)^2 integer neighbours of the centre, then the
// bilinear combination (y first, then x: the TPU kernel's stage order).
// f2cat keeps the packed layout of cat_meta: per level, x-major rows with
// y padded to hp, so a column's rows are contiguous. Accumulation is f32;
// the output is written in f1's dtype.
//
// bf16 at C = 128 or 256 and radius <= 4 (RAFT's 256 or 128 and 4 or
// 3), the tensor-core route: one
// block of one warpgroup per (8x8 query tile of the query image, batch
// entry, level). Neighbouring queries' windows overlap almost entirely
// (the coordinates are the pixel grid plus a smooth flow), so the block
// reads the union of its windows once instead of 64 x (2r+2)^2 rows:
//   1. the tile's window origins reduce to a box of columns [X0, X0 + bw)
//      and rows [Y0, Y0 + hb) clipped to the level, each side at most 64
//      (where the windows spread wider, the box is placed on their mean
//      centre); a query whose clipped window lies inside the box takes
//      the tile path, any other the per-query path below;
//   2. the box streams through a 2-stage ring under mbarriers in chunks
//      of 64 rows: 64 / hb8 whole columns each (hb rounded up to 8), one
//      TMA box of hb8 rows per column and 64-channel panel, 128-byte
//      swizzled; each chunk is one product f1_tile . rows^T on wgmma
//      (m64n64k16, f1 in registers as the A fragments, the rows K-major),
//      and a chunk's stage is refilled as soon as its products are done;
//   3. every accumulator element that falls in its query's window is that
//      tap's dot (times 1/sqrt(C)) in a shared dots[query][tap] table:
//      each tap has exactly one owner, so there are no atomics;
//   4. the queries whose windows overflow the box take the per-query path
//      in the same block (one warp each: the tap rows one by one, warp-
//      shuffle reductions), then all 64 combine bilinearly.
// What bounds it: not bytes (f2cat stays in L2) nor the products (~2
// MFLOP a chunk) but each block's serial steps: the set-up, one chunk
// after another, the bilinear pass. Blocks per (tile, level) keep
// enough of them in flight (448 at the serving shape, 1536 in training).
// Every launch on the same inputs gives the same bits (fixed orders, no
// atomics on floats).
//
// f32, and every other operand (any C, any radius, any level count),
// the CUDA-core route: one warp per query walks every level's taps as the
// per-query path does. Lane `lane` takes columns [8 (32 k + lane), +8) of
// each 256-column chunk k; f1's first two chunks (C <= 512) stay in its
// registers and the rest is read again per tap (L1); C % 8 != 0 takes
// scalar loads. The taps come in blocks of at most 17 x 17 (16 x 16
// window outputs), so any radius fits a warp's table; up to r = 7 one
// block holds the whole window. The levels come from a table of
// MAX_LEVELS, which holds every non-empty level of any map (level l has h
// >> l rows); the levels past them are pooled to nothing, and
// zero_levels writes their lookups as 0 on either route.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <climits>
#include <stdint.h>

#include "hopper.cuh"

typedef __nv_bfloat16 bf16;

// the non-empty levels a map can have: h >> 31 == 0 for any int h
#define MAX_LEVELS 32
#define WARPS 8
#define VEC 8
#define MAX_CHUNKS 2            // f1's columns in registers: 512
#define TB 16                   // a tap block's window outputs a side

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

__device__ __forceinline__ float load1(const float* p) { return *p; }

__device__ __forceinline__ float load1(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

__device__ __forceinline__ void store1(float* p, float v) { *p = v; }

__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// The 8 columns [c, c + 8) of a row, zeros past C: one 16-byte load where
// C % 8 == 0 (V8; the wrapper hands 16-byte aligned tensors), else one
// load a column.
template <bool V8, typename T>
__device__ __forceinline__ void load_cols(const T* row, int c, int C,
                                          float (&v)[VEC]) {
  if (V8 && c < C) {
    load8(row + c, v);
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) v[i] = c + i < C ? load1(row + c + i) : 0.f;
  }
}

// The 8 columns [c, c + 8) of acc into a row, none past C.
template <bool V8, typename T>
__device__ __forceinline__ void store_cols(T* row, int c, int C,
                                           const float (&acc)[VEC]) {
#pragma unroll
  for (int i = 0; i < VEC; ++i)
    if (V8 || c + i < C) store1(row + c + i, acc[i]);
}

// The window origin of a query at level l: the first integer tap (ix0,
// iy0) and the bilinear fractions. The centre is clamped before the int
// conversion (defined for any coordinate); a centre clamped this way
// still has no tap inside the level.
__device__ __forceinline__ void window_at(float cx, float cy, int l, int hl,
                                          int wl, int radius, int* ix0,
                                          int* iy0, float* fx, float* fy) {
  const float s = 1.0f / (float)(1 << l);
  const float x = cx * s, y = cy * s;
  const float x0 = floorf(x), y0 = floorf(y);
  *fx = x - x0;
  *fy = y - y0;
  *ix0 = (int)fminf(fmaxf(x0, -radius - 2.f), (float)(wl + radius)) - radius;
  *iy0 = (int)fminf(fmaxf(y0, -radius - 2.f), (float)(hl + radius)) - radius;
}

// The lane's registered columns of one f1 row: 8 per 256-column chunk of
// the first MAX_CHUNKS, zeros past C.
template <bool V8, typename T>
__device__ __forceinline__ void load_f1_row(const T* f1q, int C, int lane,
                                            float (&f1r)[MAX_CHUNKS][VEC]) {
#pragma unroll
  for (int ch = 0; ch < MAX_CHUNKS; ++ch)
    load_cols<V8>(f1q, (ch * 32 + lane) * VEC, C, f1r[ch]);
}

// One warp: the dot product of f1's row (its first MAX_CHUNKS chunks in
// f1r, the rest read from f1q) with one f2 row, each lane summing its
// columns chunk by chunk, then reduced with warp shuffles; every lane
// gets it.
template <bool V8, typename T>
__device__ __forceinline__ float row_dot(const float (&f1r)[MAX_CHUNKS][VEC],
                                         const T* __restrict__ f1q,
                                         const T* __restrict__ row, int C,
                                         int lane) {
  float acc = 0.f;
#pragma unroll
  for (int ch = 0; ch < MAX_CHUNKS; ++ch) {
    const int c = (ch * 32 + lane) * VEC;
    if (c < C) {
      float v[VEC];
      load_cols<V8>(row, c, C, v);
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc = fmaf(f1r[ch][i], v[i], acc);
    }
  }
  for (int c = (MAX_CHUNKS * 32 + lane) * VEC; c < C; c += 32 * VEC) {
    float u[VEC], v[VEC];
    load_cols<V8>(f1q, c, C, u);
    load_cols<V8>(row, c, C, v);
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc = fmaf(u[i], v[i], acc);
  }
#pragma unroll
  for (int m = 16; m; m >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, m);
  return acc;
}

// One warp: the (2r+2)^2 dot products of a query's window at one level,
// tap by tap, times `scale`, 0 outside the level; lane 0 writes dq[t].
// f2l is the level's first packed row. (The tensor-core route's per-query
// path, C = 128 or 256.)
template <typename T>
__device__ __forceinline__ void window_dots(
    const float (&f1r)[MAX_CHUNKS][VEC], const T* __restrict__ f2l, int C,
    int hl, int wl, int hp, int ix0, int iy0, int K1, float scale, float* dq,
    int lane) {
  const int taps = K1 * K1;
#pragma unroll 4
  for (int t = 0; t < taps; ++t) {
    const int xx = ix0 + t / K1;
    const int yy = iy0 + t % K1;
    float d = 0.f;
    if (xx >= 0 && xx < wl && yy >= 0 && yy < hl)  // uniform branch
      d = row_dot<true>(f1r, (const T*)nullptr,
                        f2l + ((long long)xx * hp + yy) * C, C, lane) * scale;
    if (lane == 0) dq[t] = d;
  }
}

// The CUDA-core route: one warp per query, every non-empty level (L of
// them; the output has Lout levels a query). Per level the window in tap
// blocks: window outputs [a, a + nb) x [b0, b0 + mb) from the dot
// products at the (nb + 1) x (mb + 1) taps under them, y first, then x
// (the TPU kernel's stage order).
template <bool V8, typename T>
__global__ void __launch_bounds__(WARPS * 32)
fused_corr_fwd_kernel(const T* __restrict__ f1, const T* __restrict__ f2cat,
                      const float* __restrict__ coords, T* __restrict__ out,
                      int B, int N, int C, int R, int L, int Lout, Meta meta,
                      int radius, float scale) {
  __shared__ float dots[WARPS][(TB + 1) * (TB + 1)];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long q = (long long)blockIdx.x * WARPS + warp;  // flat (b, n)
  if (q >= (long long)B * N) return;  // uniform over the warp
  const int b = (int)(q / N);
  const int K = 2 * radius + 1;
  const long long KK = (long long)K * K;

  const T* f1q = f1 + q * C;
  float f1r[MAX_CHUNKS][VEC];
  load_f1_row<V8>(f1q, C, lane, f1r);
  const float cx = coords[2 * q];
  const float cy = coords[2 * q + 1];
  const T* f2b = f2cat + (long long)b * R * C;
  T* outq = out + q * (Lout * KK);
  float* dq = dots[warp];

  for (int l = 0; l < L; ++l) {
    const int hl = meta.hl[l], wl = meta.wl[l], hp = meta.hp[l];
    const T* f2l = f2b + (long long)meta.off[l] * C;
    T* o = outq + l * KK;
    int ix0, iy0;
    float fx, fy;
    window_at(cx, cy, l, hl, wl, radius, &ix0, &iy0, &fx, &fy);
    for (int a = 0; a < K; a += TB) {
      for (int b0 = 0; b0 < K; b0 += TB) {
        const int nb = min(TB, K - a), mb = min(TB, K - b0), m1 = mb + 1;
        const int taps = (nb + 1) * m1;
#pragma unroll 4
        for (int t = 0; t < taps; ++t) {
          const int xx = ix0 + a + t / m1;
          const int yy = iy0 + b0 + t % m1;
          float d = 0.f;
          if (xx >= 0 && xx < wl && yy >= 0 && yy < hl)  // uniform branch
            d = row_dot<V8>(f1r, f1q, f2l + ((long long)xx * hp + yy) * C,
                            C, lane) * scale;
          if (lane == 0) dq[t] = d;
        }
        __syncwarp();
        for (int t = lane; t < nb * mb; t += 32) {
          const int kx = t / mb, ky = t - kx * mb;
          const float* d0 = dq + kx * m1 + ky;
          const float* d1 = d0 + m1;
          const float v = (1.f - fx) * ((1.f - fy) * d0[0] + fy * d0[1]) +
                          fx * ((1.f - fy) * d1[0] + fy * d1[1]);
          store1(o + (long long)(a + kx) * K + b0 + ky, v);
        }
        __syncwarp();
      }
    }
  }
}

// The lookups of the levels past the non-empty ones: out[q, from:stride]
// = 0 for every query (rows of `stride` values).
template <typename T>
__global__ void __launch_bounds__(256)
zero_levels(T* __restrict__ out, long long rows, long long stride,
            long long from) {
  const long long per = stride - from;
  for (long long i = blockIdx.x * 256ll + threadIdx.x; i < rows * per;
       i += (long long)gridDim.x * 256)
    store1(out + (i / per) * stride + from + i % per, 0.f);
}

template <typename T>
static int zero_levels_launch(void* out, long long rows, long long stride,
                              long long from, cudaStream_t st) {
  const long long n = rows * (stride - from);
  if (n <= 0) return 0;
  const long long blocks = (n + 255) / 256;
  zero_levels<T><<<(unsigned)(blocks < 4096 ? blocks : 4096), 256, 0, st>>>(
      (T*)out, rows, stride, from);
  return (int)cudaGetLastError();
}

// The table of the L non-empty levels: 4 ints each (hl, wl, hp,
// row_offset), as cat_meta.
static bool unpack_meta(int L, int C, int radius, const int* meta, Meta* m) {
  if (L < 0 || L > MAX_LEVELS || C < 1 || radius < 0) return false;
  *m = Meta{};
  for (int l = 0; l < L; ++l) {
    m->hl[l] = meta[4 * l];
    m->wl[l] = meta[4 * l + 1];
    m->hp[l] = meta[4 * l + 2];
    m->off[l] = meta[4 * l + 3];
    if (m->hl[l] < 1 || m->wl[l] < 1) return false;
  }
  return true;
}

// The tensor-core routes take bf16 at C = 128 or 256, radius <= 4 (their
// tap tables hold (2r + 2)^2 <= 100) and at least one non-empty level.
static bool tensor_cores_take(int is_bf16, int C, int radius, int L) {
  return is_bf16 && (C == 128 || C == 256) && radius <= 4 && L >= 1;
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
//   (a) corr_bwd_taps, one warp per query: per non-empty level the
//       window origin (ix0, iy0) and the (2r+2)^2 tap gradients, s folded
//       in, into a scratch dtap [B, L, Npad, taps] f32 and orig [B, L,
//       Npad] int2 (queries N..Npad get an origin that no row matches;
//       the levels pooled to nothing have no rows and no scratch); and
//       the row table tab [T * 64]: the packed rows cut into T tiles of
//       64 that never straddle a level, each row's (x << 16 | y) in its
//       level, -1 for a padded row, -2 past the level's end.
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
// bf16 at C = 128 or 256 and radius <= 4 (as the forward): (b) and (c)
// on the tensor cores, two warpgroups a block, 64 output rows each. The
// streamed side (f2cat row tiles in (b); f1 query tiles, with their dtap
// slab and origins, in (c)) comes in by TMA and bulk copies through a
// 2-stage ring under mbarriers; (b) keeps the dtap slab of its 128
// queries for the current level in shared memory, reloaded when the sweep
// enters a level.
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
// Every other operand (f32 models, the parity runs, any C, radius or
// level count): the same passes on the CUDA cores in f32: (b) one warp
// per query sums its in-range taps in tap order; (c) one warp per packed
// row scans the queries in order (their origins staged in shared memory
// per chunk); both take C in passes of 512 columns. The tap pass reads
// each level's cotangent from global memory, so it holds no per-level
// buffer; the scratch follows the taps, (2r + 2)^2 a query and level.

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
// a df2cat sweep of up to SWEEP_TILES query tiles sums in the wgmma
// accumulator alone; a longer one adds the accumulator into an f32
// scratch every FLUSH_TILES tiles (the tensor cores add into it with
// less than f32's rounding, which a coarse level's rows, each a sum over
// every query, show once the sweep is long)
constexpr int SWEEP_TILES = 64;
constexpr int FLUSH_TILES = 16;

}  // namespace corr_sm90

// Tile `tile` of the packed rows cut level by level into 64-row tiles:
// its level, first row and the rows of its level from there (may exceed
// 64). Returns false past the last tile.
__host__ __device__ __forceinline__ bool level_tile(const Meta& m, int L,
                                                    int tile, int* level,
                                                    int* row0, int* rows) {
  for (int l = 0; l < L; ++l) {
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
    t += (m.wl[l] * m.hp[l] + corr_sm90::TILE - 1) / corr_sm90::TILE;
  return t;
}

// (a) One warp per (batch entry, query < Npad); the grid's threads also
// fill the row table. Per level the warp writes the window origin and the
// taps' gradients, reading the query's cotangent of the level (gstride
// values a query) from global memory, each value by up to four taps.
template <typename T>
__global__ void __launch_bounds__(WARPS * 32)
corr_bwd_taps(const T* __restrict__ g, const float* __restrict__ coords,
              float* __restrict__ dtap, int2* __restrict__ orig,
              int* __restrict__ tab, int B, int N, int Npad, int L,
              long long gstride, int n_tab, Meta meta, int radius,
              float scale) {
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
  const long long qi = (long long)b * N + q;
  const float cx = q < N ? coords[2 * qi] : 0.f;
  const float cy = q < N ? coords[2 * qi + 1] : 0.f;
  for (int l = 0; l < L; ++l) {
    const long long at = ((long long)b * L + l) * Npad + q;
    const int hl = meta.hl[l], wl = meta.wl[l];
    if (q >= N) {
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
    const T* gl = g + qi * gstride + (long long)l * K * K;
    float* dq = dtap + at * taps;
    for (int t = lane; t < taps; t += 32) {
      const int i = t / K1, j = t - i * K1;
      float v = 0.f;
      if (i < K) {
        if (j < K) v += (1.f - fx) * (1.f - fy) * load1(gl + i * K + j);
        if (j > 0) v += (1.f - fx) * fy * load1(gl + i * K + j - 1);
      }
      if (i > 0) {
        if (j < K) v += fx * (1.f - fy) * load1(gl + (i - 1) * K + j);
        if (j > 0) v += fx * fy * load1(gl + (i - 1) * K + j - 1);
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
// block's level come in by bulk copies on the same barrier. FLUSH (the
// sweeps past SWEEP_TILES, a kernel of their own so that the others keep
// their registers): the accumulator goes into part, the f32 scratch [B,
// R, C] (each row only its block's), every FLUSH_TILES query tiles.
template <int NP, bool FLUSH>
__device__ __forceinline__ void corr_bwd_df2(
    int bx, int b, const CUtensorMap& tm_f1, const float* __restrict__ dtap,
    const int2* __restrict__ orig, const int* __restrict__ tab,
    bf16* __restrict__ df2, float* __restrict__ part, int N, int Npad,
    int R, int L, const Meta& meta, int K1) {
  constexpr int C = NP * 64;
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
  // this thread's output rows (rl, rl + 8 of the tile): their offsets in
  // df2 / part, -1 past the level's end or R
  long long rowoff[2] = {-1, -1};
  auto row_offsets = [&]() {
    int lv, row0, rows;
    level_tile(meta, L, tile0 + wg, &lv, &row0, &rows);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const long long row = row0 + rl + 8 * r;
      if (entry[r] != -2 && row < R) rowoff[r] = ((long long)b * R + row) * C;
    }
  };
  if (FLUSH && !idle) row_offsets();
  // the accumulator added into part (the first time stored) and zeroed
  auto add_to_part = [&](bool first) {
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int h = 0; h < NP / 2; ++h)
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const int i = 4 * j + 2 * r;
          if (rowoff[r] >= 0) {
            float2* p = reinterpret_cast<float2*>(part + rowoff[r] + h * 128 +
                                                  8 * j + 2 * t);
            float2 v = first ? make_float2(0.f, 0.f) : *p;
            v.x += acc[h][i];
            v.y += acc[h][i + 1];
            *p = v;
          }
          acc[h][i] = acc[h][i + 1] = 0.f;
        }
  };

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
      if (FLUSH && (it + 1) % FLUSH_TILES == 0 && it + 1 < n_q)
        add_to_part(it + 1 == FLUSH_TILES);
    }
    mbar_arrive(&sm.empty[s]);
    if (threadIdx.x == LOADER * 32 && it + STAGES < n_q) {
      mbar_wait(&sm.empty[s], (it / STAGES) & 1);
      stage(it + STAGES);
    }
  }

  if (idle) return;
  if (!FLUSH) row_offsets();
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (rowoff[r] < 0) continue;  // past the level's end or R
    bf16* out = df2 + rowoff[r];
#pragma unroll
    for (int h = 0; h < NP / 2; ++h)
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        float2 v = make_float2(acc[h][4 * j + 2 * r],
                               acc[h][4 * j + 2 * r + 1]);
        if (FLUSH) {
          const float2 p = *reinterpret_cast<const float2*>(
              part + rowoff[r] + h * 128 + 8 * j + 2 * t);
          v.x = p.x + v.x;
          v.y = p.y + v.y;
        }
        *reinterpret_cast<__nv_bfloat162*>(out + h * 128 + 8 * j + 2 * t) =
            __floats2bfloat162_rn(v.x, v.y);
      }
  }
}

// (b) and (c) in one launch, so that the blocks of each fill the other's
// tail wave: blocks [0, n1) take df1 (the longer sweeps, dispatched
// first), the rest df2cat; n1 = B * Npad / 128.
template <int NP, bool FLUSH>
__global__ void __launch_bounds__(THREADS, 1)
corr_bwd_products(const __grid_constant__ CUtensorMap tm_f1,
                  const __grid_constant__ CUtensorMap tm_f2,
                  const float* __restrict__ dtap,
                  const int2* __restrict__ orig, const int* __restrict__ tab,
                  bf16* __restrict__ df1, bf16* __restrict__ df2,
                  float* __restrict__ part, int N, int Npad, int R, int L,
                  int n_tiles, int n1, Meta meta, int K1) {
  const int per_b1 = Npad / (2 * TILE);
  if ((int)blockIdx.x < n1) {
    corr_bwd_df1<NP>(blockIdx.x % per_b1, blockIdx.x / per_b1, tm_f2, dtap,
                     orig, tab, df1, N, Npad, L, n_tiles, meta, K1);
  } else {
    const int n2_b = (gridDim.x - n1) / (n1 / per_b1);  // row blocks an entry
    const int i = blockIdx.x - n1;
    corr_bwd_df2<NP, FLUSH>(i % n2_b, i / n2_b, tm_f1, dtap, orig, tab, df2,
                            part, N, Npad, R, L, meta, K1);
  }
}

template <int NP>
static int launch(const void* f1, const void* f2cat, const float* dtap,
                  const int2* orig, const int* tab, void* df1, void* df2,
                  float* part, int B, int N, int Npad, int R, int L,
                  int n_tiles, const Meta& meta, int K1, cudaStream_t st) {
  CUtensorMap m_f1, m_f2;
  int e;
  if ((e = tensor_map_bf16_3d(&m_f1, f1, NP * 64, N, B, TILE))) return e;
  if ((e = tensor_map_bf16_3d(&m_f2, f2cat, NP * 64, R, B, TILE))) return e;
  const size_t s1 = sizeof(Df1Smem<NP>), s2 = sizeof(Df2Smem<NP>);
  const size_t smem = (s1 > s2 ? s1 : s2) + 1024;
  const bool flush = (N + TILE - 1) / TILE > SWEEP_TILES;
  const auto kernel = flush ? corr_bwd_products<NP, true>
                            : corr_bwd_products<NP, false>;
  if ((e = (int)cudaFuncSetAttribute(
           kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem)))
    return e;
  int row_blocks = 0;
  for (int l = 0; l < L; ++l)
    row_blocks += ((meta.wl[l] * meta.hp[l] + TILE - 1) / TILE + 1) / 2;
  const int n1 = B * (Npad / (2 * TILE));
  kernel<<<(unsigned)(n1 + B * row_blocks), THREADS, smem, st>>>(
      m_f1, m_f2, dtap, orig, tab, (bf16*)df1, (bf16*)df2, part, N, Npad, R,
      L, n_tiles, n1, meta, K1);
  return (int)cudaGetLastError();
}

}  // namespace corr_sm90

// (b) on the CUDA cores: one warp per query sums d_tap * f2cat[row] over
// its in-range taps, level by level in tap order; df1 in T. C in passes
// of MAX_CHUNKS chunks of 256 columns (one pass up to 512), each pass
// walking the taps again.
template <bool V8, typename T>
__global__ void __launch_bounds__(WARPS * 32)
corr_bwd_df1_cc(const T* __restrict__ f2cat, const float* __restrict__ dtap,
                const int2* __restrict__ orig, T* __restrict__ df1, int B,
                int N, int Npad, int C, int R, int L, Meta meta, int K1) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long q = (long long)blockIdx.x * WARPS + warp;  // flat (b, n)
  if (q >= (long long)B * N) return;  // uniform over the warp
  const int b = (int)(q / N), n = (int)(q - (long long)b * N);
  const int taps = K1 * K1;
  const T* f2b = f2cat + (long long)b * R * C;
  T* out = df1 + q * C;
  for (int c0 = 0; c0 < C; c0 += MAX_CHUNKS * 32 * VEC) {
    float acc[MAX_CHUNKS][VEC];
#pragma unroll
    for (int ch = 0; ch < MAX_CHUNKS; ++ch)
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc[ch][i] = 0.f;
    for (int l = 0; l < L; ++l) {
      const int hl = meta.hl[l], wl = meta.wl[l], hp = meta.hp[l];
      const long long at = ((long long)b * L + l) * Npad + n;
      const int2 o = orig[at];
      const float* dt = dtap + at * taps;
      for (int t = 0; t < taps; ++t) {
        const int xx = o.x + t / K1, yy = o.y + t % K1;
        if (xx < 0 || xx >= wl || yy < 0 || yy >= hl) continue;  // uniform
        const float d = dt[t];
        const T* f2row =
            f2b + ((long long)meta.off[l] + (long long)xx * hp + yy) * C;
#pragma unroll
        for (int ch = 0; ch < MAX_CHUNKS; ++ch) {
          const int c = c0 + (ch * 32 + lane) * VEC;
          if (c < C) {
            float v[VEC];
            load_cols<V8>(f2row, c, C, v);
#pragma unroll
            for (int i = 0; i < VEC; ++i)
              acc[ch][i] = fmaf(d, v[i], acc[ch][i]);
          }
        }
      }
    }
#pragma unroll
    for (int ch = 0; ch < MAX_CHUNKS; ++ch) {
      const int c = c0 + (ch * 32 + lane) * VEC;
      if (c < C) store_cols<V8>(out, c, C, acc[ch]);
    }
  }
}

#define CC_CHUNK 256  // queries whose origins a block stages at a time

// (c) on the CUDA cores: one warp per packed row (8 rows of one tile a
// block) scans the queries in order and sums d_corr * f1[q]; df2cat in T.
// C in passes as in (b), each scanning the queries again.
template <bool V8, typename T>
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
  T* out = df2 + ((long long)b * R + row0 + rl) * C;
  for (int c0 = 0; c0 < C; c0 += MAX_CHUNKS * 32 * VEC) {  // uniform
    float acc[MAX_CHUNKS][VEC];
#pragma unroll
    for (int ch = 0; ch < MAX_CHUNKS; ++ch)
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc[ch][i] = 0.f;
    for (int q0 = 0; q0 < N; q0 += CC_CHUNK) {
      __syncthreads();
      for (int i = threadIdx.x; i < CC_CHUNK; i += WARPS * 32)
        os[i] = orig[slab + (q0 + i < Npad ? q0 + i : 0)];
      __syncthreads();
      if (entry < 0) continue;  // uniform over the warp
      const int n_end = N - q0 < CC_CHUNK ? N - q0 : CC_CHUNK;
      for (int i = 0; i < n_end; ++i) {
        const float d =
            dcorr(entry, os[i], dtap + (slab + q0 + i) * taps, K1);
        if (d == 0.f) continue;  // uniform: one row, one query
        const T* f1row = f1 + ((long long)b * N + q0 + i) * C;
#pragma unroll
        for (int ch = 0; ch < MAX_CHUNKS; ++ch) {
          const int c = c0 + (ch * 32 + lane) * VEC;
          if (c < C) {
            float v[VEC];
            load_cols<V8>(f1row, c, C, v);
#pragma unroll
            for (int k = 0; k < VEC; ++k)
              acc[ch][k] = fmaf(d, v[k], acc[ch][k]);
          }
        }
      }
    }
    if (entry == -2) continue;  // past the level's end: another tile's row
#pragma unroll
    for (int ch = 0; ch < MAX_CHUNKS; ++ch) {
      const int c = c0 + (ch * 32 + lane) * VEC;
      if (c < C) store_cols<V8>(out, c, C, acc[ch]);
    }
  }
}

template <bool V8, typename T>
static int products_cc(const void* f1, const void* f2cat, const float* dt,
                       const int2* og, const int* tb, void* df1, void* df2,
                       int B, int N, int Npad, int C, int R, int L,
                       int n_tiles, const Meta& m, int K1, cudaStream_t st) {
  const dim3 grid_b((unsigned)(((long long)B * N + WARPS - 1) / WARPS));
  corr_bwd_df1_cc<V8, T><<<grid_b, WARPS * 32, 0, st>>>(
      (const T*)f2cat, dt, og, (T*)df1, B, N, Npad, C, R, L, m, K1);
  int e = (int)cudaGetLastError();
  if (e || n_tiles == 0) return e;
  const dim3 grid_c((unsigned)(n_tiles * (corr_sm90::TILE / WARPS)),
                    (unsigned)B);
  corr_bwd_df2_cc<V8, T><<<grid_c, WARPS * 32, 0, st>>>(
      (const T*)f1, dt, og, tb, (T*)df2, N, Npad, C, R, L, m, K1);
  return (int)cudaGetLastError();
}

// g: [B, N, Lout*(2r+1)^2] in the features' dtype; df1 [B, N, C] and df2
// [B, R, C] in that dtype, each written in full. meta: the L non-empty
// levels (4 ints each, as cat_meta; the Lout - L levels past them are
// pooled to nothing, their cotangent reaches nothing). Scratch from the
// caller: dtap [B, L, Npad, (2r+2)^2] f32, orig [B, L, Npad] int2 and tab
// [T * 64] int32, with Npad = N rounded up to a multiple of 128 and T the
// 64-row tiles of the levels (each level's wl * hp rows rounded up to
// 64); on the tensor cores with more than SWEEP_TILES query tiles of 64,
// part [B, R, C] f32 (else it may be null). tensor_cores: the tensor-core route (bf16, C = 128 or 256, radius
// <= 4, L >= 1; anything else it refuses), else the CUDA-core one. Row
// table entries pack (x << 16 | y): the caller keeps wl < 2^15 and hp <
// 2^16. Returns the first CUDA error of the launches (0 on success).
extern "C" int ofd_fused_corr_bwd(const void* g, const void* f1,
                                  const void* f2cat, const void* coords,
                                  void* df1, void* df2, void* dtap,
                                  void* orig, void* tab, void* part, int B,
                                  int N, int C, int R, int L, int Lout,
                                  const int* meta, int radius, float scale,
                                  int is_bf16, int tensor_cores,
                                  void* stream) {
  Meta m;
  if (!unpack_meta(L, C, radius, meta, &m) || B < 1 || B > 65535 ||
      Lout < L ||
      (tensor_cores && (!tensor_cores_take(is_bf16, C, radius, L) ||
                        ((N + 63) / 64 > corr_sm90::SWEEP_TILES && !part))))
    return (int)cudaErrorInvalidValue;
  if (N == 0) return 0;
  const int Npad = (N + 127) / 128 * 128, K = 2 * radius + 1, K1 = K + 1;
  const int n_tiles = count_tiles(m, L);
  cudaStream_t st = (cudaStream_t)stream;
  float* dt = (float*)dtap;
  int2* og = (int2*)orig;
  int* tb = (int*)tab;
  const long long warps = (long long)B * Npad;
  const dim3 grid_a((unsigned)((warps + WARPS - 1) / WARPS));
  const long long gstride = (long long)Lout * K * K;
  if (is_bf16)
    corr_bwd_taps<__nv_bfloat16><<<grid_a, WARPS * 32, 0, st>>>(
        (const __nv_bfloat16*)g, (const float*)coords, dt, og, tb, B, N, Npad,
        L, gstride, n_tiles * corr_sm90::TILE, m, radius, scale);
  else
    corr_bwd_taps<float><<<grid_a, WARPS * 32, 0, st>>>(
        (const float*)g, (const float*)coords, dt, og, tb, B, N, Npad, L,
        gstride, n_tiles * corr_sm90::TILE, m, radius, scale);
  int e = (int)cudaGetLastError();
  if (e) return e;
  if (tensor_cores)
    return C == 256
               ? corr_sm90::launch<4>(f1, f2cat, dt, og, tb, df1, df2,
                                      (float*)part, B, N, Npad, R, L, n_tiles,
                                      m, K1, st)
               : corr_sm90::launch<2>(f1, f2cat, dt, og, tb, df1, df2,
                                      (float*)part, B, N, Npad, R, L, n_tiles,
                                      m, K1, st);
  const bool v8 = C % VEC == 0;
  if (is_bf16)
    return v8 ? products_cc<true, bf16>(f1, f2cat, dt, og, tb, df1, df2, B, N,
                                        Npad, C, R, L, n_tiles, m, K1, st)
              : products_cc<false, bf16>(f1, f2cat, dt, og, tb, df1, df2, B,
                                         N, Npad, C, R, L, n_tiles, m, K1, st);
  return v8 ? products_cc<true, float>(f1, f2cat, dt, og, tb, df1, df2, B, N,
                                       Npad, C, R, L, n_tiles, m, K1, st)
            : products_cc<false, float>(f1, f2cat, dt, og, tb, df1, df2, B, N,
                                        Npad, C, R, L, n_tiles, m, K1, st);
}

namespace fwd_sm90 {

using namespace hopper;

constexpr int QT = 8;          // the query tile's side in the query image
constexpr int Q = QT * QT;     // queries a block, the wgmma M
constexpr int ROWS = 64;       // f2cat rows a chunk, the wgmma N
constexpr int BOX = 64;        // the box's most columns and rows
constexpr int THREADS = 128;   // one warpgroup
constexpr int TAPS_MAX = 100;  // (2r + 2)^2 at r <= 4
constexpr int PANEL = 64 * 64; // bf16 of a [64 rows][64] panel

template <int NP>
struct Smem {
  alignas(1024) bf16 f2[2][NP][PANEL];  // the ring of chunks
  float dots[Q * TAPS_MAX];
  float fx[Q], fy[Q];
  int n[Q];            // the query's index, -1 outside the query image
  int ox[Q], oy[Q];    // its window origin at the level
  int fast[Q];         // 1: the tile path
  int slow[Q];         // the per-query path's queries, in query order
  int red[2][4];
  uint64_t full[2];    // a chunk's TMA boxes have landed in the stage
};

// f2cat [B, R, C] in boxes of 64 channels x 8 m rows, m = 1..8: chunk
// columns of hb8 = 8 m rows come in one box a panel
struct RowMaps {
  CUtensorMap m[8];
};

// The placement of the box along one axis from the reduced windows
// (r: min start, max end, sum of start + end, count): their span if it
// fits BOX, else BOX placed on their mean centre within the span.
__device__ __forceinline__ void place(const int (&r)[4], int* start,
                                      int* len) {
  if (r[3] == 0) {
    *start = *len = 0;
  } else if (r[1] - r[0] <= BOX) {
    *start = r[0];
    *len = r[1] - r[0];
  } else {
    const int centre = r[2] / (2 * r[3]);
    *start = min(max(centre - BOX / 2, r[0]), r[1] - BOX);
    *len = BOX;
  }
}

// Block (query tile, batch entry, level); level-major, so the heaviest
// level's blocks go first. The query image is wq queries wide, the tile
// grid tiles_x tiles wide and `tiles` tiles in all. Each thread keeps the
// level's chunk layout for its accumulator columns in registers, so the
// chunk loop reads no layout from shared memory.
template <int NP>
__global__ void __launch_bounds__(THREADS, 2)
corr_fwd_tiles(const bf16* __restrict__ f1, const bf16* __restrict__ f2cat,
               const float* __restrict__ coords, bf16* __restrict__ out,
               const __grid_constant__ RowMaps maps, int B, int N, int R,
               int Lout, int wq, int tiles_x, int tiles, Meta meta,
               int radius, float scale, int* n_slow_total) {
  constexpr int C = NP * 64;
  extern __shared__ unsigned char smem_raw[];
  // 1024-aligned by an offset (so the accesses stay in the shared space)
  Smem<NP>& sm = *reinterpret_cast<Smem<NP>*>(
      smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023));
  int bid = blockIdx.x;
  const int l = bid / (B * tiles);
  bid -= l * B * tiles;
  const int b = bid / tiles, tile = bid - b * tiles;
  const int ty = tile / tiles_x, tx = tile - ty * tiles_x;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int K = 2 * radius + 1, K1 = K + 1, taps = K1 * K1, KK = K * K;
  const int hl = meta.hl[l], wl = meta.wl[l], hp = meta.hp[l];
  const long long ostride = (long long)Lout * KK;
  if (tid == 0) {
    mbar_init(&sm.full[0], 1);
    mbar_init(&sm.full[1], 1);
    mbar_fence_init();
  }

  // the tile's queries and their windows clipped to the level
  int xs = 0, xe = 0, ys = 0, ye = 0;
  if (tid < Q) {
    const int qx = tx * QT + (tid & (QT - 1));
    const int n = (ty * QT + tid / QT) * wq + qx;
    const bool ok = qx < wq && n < N;
    sm.n[tid] = ok ? n : -1;
    if (ok) {
      const long long qi = (long long)b * N + n;
      int ix0, iy0;
      float fx, fy;
      window_at(coords[2 * qi], coords[2 * qi + 1], l, hl, wl, radius, &ix0,
                &iy0, &fx, &fy);
      sm.ox[tid] = ix0;
      sm.oy[tid] = iy0;
      sm.fx[tid] = fx;
      sm.fy[tid] = fy;
      xs = max(ix0, 0);
      xe = min(ix0 + K1, wl);
      ys = max(iy0, 0);
      ye = min(iy0 + K1, hl);
      if (xs >= xe || ys >= ye) xs = xe = ys = ye = 0;  // nothing in range
    }
  }
  const bool live = ye > ys;

  // min start, max end, sum of start + end and count over the queries on
  auto reduce = [&](bool on, int a, int e, int (&r)[4]) {
    if (tid < Q) {
      const int v0 = __reduce_min_sync(0xffffffffu, on ? a : INT_MAX);
      const int v1 = __reduce_max_sync(0xffffffffu, on ? e : INT_MIN);
      const int v2 = __reduce_add_sync(0xffffffffu, on ? a + e : 0);
      const int v3 = __reduce_add_sync(0xffffffffu, on ? 1 : 0);
      if (lane == 0) {
        sm.red[warp][0] = v0;
        sm.red[warp][1] = v1;
        sm.red[warp][2] = v2;
        sm.red[warp][3] = v3;
      }
    }
    __syncthreads();
    r[0] = min(sm.red[0][0], sm.red[1][0]);
    r[1] = max(sm.red[0][1], sm.red[1][1]);
    r[2] = sm.red[0][2] + sm.red[1][2];
    r[3] = sm.red[0][3] + sm.red[1][3];
    __syncthreads();
  };
  int r[4], Y0, hb, X0, bw;
  reduce(live, ys, ye, r);
  place(r, &Y0, &hb);
  const bool fit_y = live && ys >= Y0 && ye <= Y0 + hb;
  reduce(fit_y, xs, xe, r);
  place(r, &X0, &bw);
  const bool fast = fit_y && xs >= X0 && xe <= X0 + bw;
  // a chunk: cpc whole columns of hb8 rows (hb rounded up to 8)
  const int hb8 = (hb + 7) & ~7;
  const int cpc = hb > 0 ? ROWS / hb8 : 0;
  const int nch = cpc > 0 ? (bw + cpc - 1) / cpc : 0;

  // the per-query path's queries, compacted in query order
  const bool slow = live && !fast;
  unsigned mask = 0;
  if (tid < Q) {
    sm.fast[tid] = fast;
    mask = __ballot_sync(0xffffffffu, slow);
    if (lane == 0) sm.red[warp][0] = __popc(mask);
  }
  float4* d4 = reinterpret_cast<float4*>(sm.dots);
  for (int i = tid; i < Q * taps / 4; i += THREADS)
    d4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncthreads();
  const int n_slow = sm.red[0][0] + sm.red[1][0];
  if (slow)
    sm.slow[(warp ? sm.red[0][0] : 0) + __popc(mask & ((1u << lane) - 1))] =
        tid;
  if (tid == 0 && n_slow_total && n_slow) atomicAdd(n_slow_total, n_slow);

  // chunk row r holds column X0 + j * cpc + r / hb8, row Y0 + r % hb8
  // (the rows past Y0 + hb are other rows, never read). This thread's
  // accumulator columns are chunk rows 8 jn + 2 t + e: their column
  // offsets in the chunk (-1: not a box row) and their y.
  const int ql = warp * 16 + (lane >> 2), t = lane & 3;
  int ccol[16], cy[16];
#pragma unroll
  for (int c = 0; c < 16; ++c) {
    const int rw = 8 * (c >> 1) + 2 * t + (c & 1);
    const int col = hb8 ? rw / hb8 : 0, y = rw - col * hb8;
    ccol[c] = col < cpc && y < hb ? col : -1;
    cy[c] = Y0 + y;
  }

  // chunk j: one TMA box of hb8 rows per column and 64-channel panel into
  // stage j % 2 (128-byte swizzled, as the wgmma descriptors read it)
  const int row0 = meta.off[l] + Y0;
  auto load_chunk = [&](int j) {
    if (tid != 0 || j >= nch) return;
    const int s = j & 1, xc = X0 + j * cpc;
    const int cols = min(cpc, X0 + bw - xc);
    mbar_expect_tx(&sm.full[s], (uint32_t)(cols * NP * hb8 * 128));
    for (int c = 0; c < cols; ++c)
#pragma unroll
      for (int p = 0; p < NP; ++p)
        tma_load_3d(sm.f2[s][p] + c * hb8 * 64, &maps.m[hb8 / 8 - 1],
                    &sm.full[s], p * 64, row0 + (xc + c) * hp, b);
  };

  if (nch > 0) {
    // f1's tile as the wgmma A fragments (rows ql, ql + 8; zeros outside
    // the query image)
    uint32_t a[NP * 16];
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int n = sm.n[ql + 8 * rr];
      const bf16* row = f1 + ((long long)b * N + (n < 0 ? 0 : n)) * C + 2 * t;
#pragma unroll
      for (int kk = 0; kk < NP * 4; ++kk)
#pragma unroll
        for (int half = 0; half < 2; ++half)
          a[4 * kk + 2 * half + rr] =
              n < 0 ? 0u
                    : *reinterpret_cast<const uint32_t*>(row + 16 * kk +
                                                         8 * half);
    }
    load_chunk(0);
    load_chunk(1);
    bool on[2];
    int ox[2], oy[2];
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      on[rr] = sm.fast[ql + 8 * rr];
      ox[rr] = sm.ox[ql + 8 * rr];
      oy[rr] = sm.oy[ql + 8 * rr];
    }
    float acc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.f;
    for (int j = 0; j < nch; ++j) {
      mbar_wait(&sm.full[j & 1], (j >> 1) & 1);
      const bf16* st = sm.f2[j & 1][0];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < NP * 4; ++kk)
        wgmma_m64n64_rs(acc, &a[4 * kk],
                        desc_sw128(st + (kk >> 2) * PANEL + (kk & 3) * 16, 16,
                                   1024),
                        kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      fence_regs(a);
      // the warpgroup's products have read stage j % 2 (a wgmma starts
      // only once all four warps have reached it, so every warp is past
      // its wait for chunk j): chunk j + 2 may land there now
      load_chunk(j + 2);
      // acc[4 jn + 2 rr + e]: query ql + 8 rr, chunk row 8 jn + 2 t + e
      const int xc = X0 + j * cpc;
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        if (!on[rr]) continue;
        float* dq = sm.dots + (ql + 8 * rr) * taps;
#pragma unroll
        for (int c = 0; c < 16; ++c) {
          const int x = xc + ccol[c];
          const int dx = x - ox[rr], dy = cy[c] - oy[rr];
          if (ccol[c] >= 0 && x < X0 + bw && (unsigned)dx < (unsigned)K1 &&
              (unsigned)dy < (unsigned)K1)
            dq[dx * K1 + dy] = acc[4 * (c >> 1) + 2 * rr + (c & 1)] * scale;
        }
      }
    }
  }
  __syncthreads();

  // the per-query path: one warp a query
  for (int i = warp; i < n_slow; i += THREADS / 32) {
    const int q = sm.slow[i];
    float f1r[MAX_CHUNKS][VEC];
    load_f1_row<true>(f1 + ((long long)b * N + sm.n[q]) * C, C, lane, f1r);
    window_dots(f1r, f2cat + ((long long)b * R + meta.off[l]) * C, C, hl,
                wl, hp, sm.ox[q], sm.oy[q], K1, scale,
                sm.dots + q * taps, lane);
  }
  __syncthreads();

  // y first, then x (the TPU kernel's stage order); a thread a (query,
  // kx) writes the K outputs of that window column (q = i / K exactly as
  // (i * ceil(2^22 / K)) >> 22 for i < Q * K)
  const unsigned inv_k = ((1u << 22) + K - 1) / K;
  for (int i = tid; i < Q * K; i += THREADS) {
    const int q = (int)(((unsigned)i * inv_k) >> 22), kx = i - q * K;
    const int n = sm.n[q];
    if (n < 0) continue;
    const float* d0 = sm.dots + q * taps + kx * K1;
    const float* d1 = d0 + K1;
    const float fx = sm.fx[q], fy = sm.fy[q];
    bf16* o = out + ((long long)b * N + n) * ostride + l * KK + kx * K;
#pragma unroll
    for (int ky = 0; ky < 9; ++ky)
      if (ky < K)
        o[ky] = __float2bfloat16(
            (1.f - fx) * ((1.f - fy) * d0[ky] + fy * d0[ky + 1]) +
            fx * ((1.f - fy) * d1[ky] + fy * d1[ky + 1]));
  }
}

// Blocks for the L non-empty levels; the output has Lout levels a query.
template <int NP>
static int launch(const void* f1, const void* f2cat, const void* coords,
                  void* out, int B, int N, int R, int L, int Lout, int wq,
                  const Meta& meta, int radius, float scale, int* n_slow,
                  cudaStream_t st) {
  const size_t smem = sizeof(Smem<NP>) + 1024;
  static bool allowed = false;  // the shared memory attribute is set
  int e;
  if (!allowed) {  // and the most shared memory a SM can give, for two
    if ((e = (int)cudaFuncSetAttribute(
             corr_fwd_tiles<NP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
             (int)smem)) ||
        (e = (int)cudaFuncSetAttribute(
             corr_fwd_tiles<NP>,
             cudaFuncAttributePreferredSharedMemoryCarveout,
             cudaSharedmemCarveoutMaxShared)))
      return e;
    allowed = true;
  }
  RowMaps maps;
  for (int m = 0; m < 8; ++m)
    if ((e = tensor_map_bf16_3d(&maps.m[m], f2cat, NP * 64, R, B, 8 * (m + 1))))
      return e;
  const int tiles_x = (wq + QT - 1) / QT;
  const int hq = (N + wq - 1) / wq;
  const int tiles = tiles_x * ((hq + QT - 1) / QT);
  const long long blocks = (long long)L * B * tiles;
  if (blocks >= (1ll << 31)) return (int)cudaErrorInvalidValue;
  corr_fwd_tiles<NP><<<(unsigned)blocks, THREADS, smem, st>>>(
      (const bf16*)f1, (const bf16*)f2cat, (const float*)coords, (bf16*)out,
      maps, B, N, R, Lout, wq, tiles_x, tiles, meta, radius, scale,
      n_slow);
  return (int)cudaGetLastError();
}

}  // namespace fwd_sm90

// meta: the L non-empty levels, 4 host ints each (hl, wl, hp,
// row_offset), as cat_meta; the output has Lout levels a query, those
// past the L pooled to nothing (written 0). wq: the query image's width
// (queries n = y * wq + x), which sets the tensor-core route's query
// tiles. n_slow: null, or an int on the card to which the tensor-core
// route adds the count of (query, level) pairs that took its per-query
// path. tensor_cores: the tensor-core route (bf16, C = 128 or 256, radius
// <= 4, L >= 1; anything else it refuses), else the CUDA-core one.
// Returns cudaGetLastError() after the launches (0 on success).
extern "C" int ofd_fused_corr_fwd(const void* f1, const void* f2cat,
                                  const void* coords, void* out, int B, int N,
                                  int C, int R, int L, int Lout,
                                  const int* meta, int radius, float scale,
                                  int is_bf16, int tensor_cores, int wq,
                                  int* n_slow, void* stream) {
  Meta m;
  if (!unpack_meta(L, C, radius, meta, &m) || wq < 1 || Lout < L ||
      (tensor_cores && !tensor_cores_take(is_bf16, C, radius, L)))
    return (int)cudaErrorInvalidValue;
  const long long total = (long long)B * N;
  if (total == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  const long long KK = (long long)(2 * radius + 1) * (2 * radius + 1);
  int e = is_bf16 ? zero_levels_launch<bf16>(out, total, Lout * KK, L * KK,
                                             st)
                  : zero_levels_launch<float>(out, total, Lout * KK, L * KK,
                                              st);
  if (e || L == 0) return e;
  if (tensor_cores)
    return C == 256 ? fwd_sm90::launch<4>(f1, f2cat, coords, out, B, N, R, L,
                                          Lout, wq, m, radius, scale, n_slow,
                                          st)
                    : fwd_sm90::launch<2>(f1, f2cat, coords, out, B, N, R, L,
                                          Lout, wq, m, radius, scale, n_slow,
                                          st);
  const dim3 grid((unsigned)((total + WARPS - 1) / WARPS));
  const bool v8 = C % VEC == 0;
  if (is_bf16) {
    if (v8)
      fused_corr_fwd_kernel<true, bf16><<<grid, WARPS * 32, 0, st>>>(
          (const bf16*)f1, (const bf16*)f2cat, (const float*)coords,
          (bf16*)out, B, N, C, R, L, Lout, m, radius, scale);
    else
      fused_corr_fwd_kernel<false, bf16><<<grid, WARPS * 32, 0, st>>>(
          (const bf16*)f1, (const bf16*)f2cat, (const float*)coords,
          (bf16*)out, B, N, C, R, L, Lout, m, radius, scale);
  } else {
    if (v8)
      fused_corr_fwd_kernel<true, float><<<grid, WARPS * 32, 0, st>>>(
          (const float*)f1, (const float*)f2cat, (const float*)coords,
          (float*)out, B, N, C, R, L, Lout, m, radius, scale);
    else
      fused_corr_fwd_kernel<false, float><<<grid, WARPS * 32, 0, st>>>(
          (const float*)f1, (const float*)f2cat, (const float*)coords,
          (float*)out, B, N, C, R, L, Lout, m, radius, scale);
  }
  return (int)cudaGetLastError();
}
