// Z-buffer forward warp for Hopper (sm_90a).
//
// Replaces the JAX package's `ops/forward_warp.py:forward_warp`, which is
// not a Pallas kernel: it sorts (target, depth bits, source index) with
// one 3-key `lax.sort` and scatters each run's head. It stands where the
// reference's L0 CUDA kernel `alt_cuda/fw_cuda` stood, which scanned the
// sources serially in raster order.
//
// What it computes, per batch entry b and source pixel p = (y, x):
//   target  t = trunc(clamp(y + fy, 0, H-1)) * W + trunc(clamp(x + fx, 0, W-1))
//   winner of t: the smallest depth; among equal depths the smallest p;
//   out[c, t] = obj[c, winner] if the winner's depth < 1000, else 0;
//   valid[t] = 1 if any p targets t; collision[t] = valid and not < 1000.
//
// The winner is the minimum of the 64-bit key (sortable(depth) << 32) | p.
// The order-preserving map sends negative floats to their inverted bits
// and the others to their bits with the sign bit set, so -0.0 < +0.0 as in
// the JAX package's `_float_to_sortable_int`; it is a bijection, so the
// key's top half is the winner's depth, NaN included. A minimum does not
// depend on the order in which writers arrive: the result is
// deterministic, and bit-equal to the plain version.
//
// Design: one cooperative launch of persistent blocks (kBlocksPerSm a
// SM at most, all resident), three phases split by grid syncs:
//   0. the u64 z-buffer (scratch, B*H*W) is set to ~0, kVec entries a
//      lane a step;
//   1. the z-test, a pixel a lane a step. Where a lane's target is that of
//      the lane 1 or 2 below it (a pile-up: clamped runs, contractions),
//      the warp groups its lanes by target (__match_any_sync) and a
//      shuffle tree takes each group's smallest key; a group's first lane
//      alone goes on. Where sources pile up (a group, a border target), it
//      loads the stored key first and issues the atomicMin only if its key
//      is smaller: keys only decrease, so a stale load never skips a
//      needed write. Elsewhere the atomic goes straight out: the load
//      would cost a round trip a pixel;
//   2. kVec adjacent targets a lane a step: each reads its key (past L1:
//      phase 1's loads may be stale there; one vector load), takes valid,
//      collision and the write test from it, and gathers the winner's C
//      channels: the depth is not read again. valid, collision and each
//      plane of out are vector stores.
// Consecutive lanes take consecutive pixels, so every load, store and
// (for smooth flows) atomic of a warp is coalesced. The z-test keeps a
// pixel a lane: with kVec a lane, a warp's atomics spread over kVec times
// the sectors, and the synthesis path's warps took longer (PERF.md,
// section 6). kPlanes = 4 keeps the gather of two targets within the 40
// registers that 6 blocks a SM leave. The vector stores need H*W a
// multiple of kVec (33x17 takes the same steps with scalar ones).
// Bound: bytes (flow, depth and obj read once, out, valid and collision
// written once). What it moves beyond them: the z-buffer (reset, one
// atomic a source where nothing piles up, one read; it fits in L2 at B =
// 15) and the C gathers of a target, a 32-byte sector each where winners
// are scattered (i.i.d. flow); smooth flows gather neighbouring sources.
// tools/warp_variants.py times this kernel at other kVec and
// kBlocksPerSm, and its phases alone.
//
// `plant_fault` = 1 makes each group keep its peers' largest key: the
// planted fault that chip_smoke.py [3h] must catch. Every path passes 0.
//
// The wrapper (ops/forward_warp.py) checks shapes and dtypes, plans the
// grid (`plan`), allocates out, valid, collision and the z-buffer, and
// passes PyTorch's stream.

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;      // ops/forward_warp.py:THREADS
constexpr int kVec = 2;            // ops/forward_warp.py:VEC
constexpr int kBlocksPerSm = 6;    // ops/forward_warp.py:BLOCKS_PER_SM
constexpr int kPlanes = 4;         // channels gathered before they are stored
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kNoTarget = 0xffffffffu;
constexpr unsigned long long kEmpty = ~0ull;
static_assert(kVec == 1 || kVec == 2 || kVec == 4, "kVec: 1, 2 or 4");

__device__ __forceinline__ unsigned int sortable_u32(float d) {
    const unsigned int bits = __float_as_uint(d);
    return (bits & 0x80000000u) ? ~bits : (bits | 0x80000000u);
}

// the inverse of sortable_u32 on a key's top half
__device__ __forceinline__ float key_depth(unsigned long long key) {
    const unsigned int s = (unsigned int)(key >> 32);
    return __uint_as_float((s & 0x80000000u) ? (s & 0x7fffffffu) : ~s);
}

__device__ __forceinline__ void store_vec(float* p, const float (&v)[kVec]) {
    if constexpr (kVec == 4) {
        *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
    } else if constexpr (kVec == 2) {
        *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
    } else {
        p[0] = v[0];
    }
}

struct WarpArgs {
    const float* obj;            // [B, C, H, W]
    const float* flow;           // [B, 2, H, W]
    const float* depth;          // [B, 1, H, W]
    unsigned long long* zbuf;    // B*H*W
    float* out;                  // [B, C, H, W]
    float* valid;                // [B, 1, H, W]
    float* collision;            // [B, 1, H, W]
    unsigned total;              // B*H*W < 2^31
    unsigned n;                  // H*W
    int w, h, c;
    int vec;                     // 1: phase 2's vector loads and stores
    int plant_fault;
};

// The smallest (with plant_fault, the largest) key of this lane's group
// `peers`, in the group's first lane: a tree over the group's ranks, each
// step pulling from the lane 2^s ranks up. Every lane of the warp calls it
// with the same `steps` (the shuffles name the whole warp).
__device__ __forceinline__ unsigned long long group_min(
        unsigned peers, unsigned long long key, unsigned lane, int steps,
        bool largest) {
    // the peers above this lane; bit 0 is never among them, so __fns from
    // base 0 counts set bits strictly upward
    const unsigned above = lane == 31 ? 0u : peers & (~0u << (lane + 1));
    for (int s = 0; s < steps; ++s) {
        const unsigned src = __fns(above, 0, 1 << s);
        const unsigned long long v =
            __shfl_sync(kFull, key, src < 32 ? (int)src : (int)lane);
        if (src < 32) key = largest ? (v > key ? v : key)
                                    : (v < key ? v : key);
    }
    return key;
}

// phase 2 for one target f < total, scalar loads and stores
__device__ __forceinline__ void gather_one(const WarpArgs& a, unsigned f) {
    const unsigned long long key = __ldcg(a.zbuf + f);
    const unsigned b = f / a.n;
    const unsigned p = f - b * a.n;
    const bool hit = key != kEmpty;
    const bool near = key_depth(key) < 1000.0f;   // false for NaN
    a.valid[f] = hit ? 1.0f : 0.0f;
    a.collision[f] = hit && !near ? 1.0f : 0.0f;
    const bool ok = hit && near;
    const float* ob = a.obj + (size_t)b * a.c * a.n + (unsigned)key;
    float* oo = a.out + (size_t)b * a.c * a.n + p;
    for (int c0 = 0; c0 < a.c; c0 += kPlanes) {
        float v[kPlanes];
#pragma unroll
        for (int k = 0; k < kPlanes; ++k)
            v[k] = c0 + k < a.c && ok ? __ldg(ob + (size_t)(c0 + k) * a.n)
                                      : 0.0f;
#pragma unroll
        for (int k = 0; k < kPlanes; ++k)
            if (c0 + k < a.c) oo[(size_t)(c0 + k) * a.n] = v[k];
    }
}

// phase 2 for the kVec targets f0 ... f0 + kVec - 1 of one image, vector
// loads of their keys and vector stores
__device__ __forceinline__ void gather_vec(const WarpArgs& a, unsigned f0) {
    if constexpr (kVec > 1) {
        const unsigned b = f0 / a.n;
        const unsigned p0 = f0 - b * a.n;
        unsigned long long key[kVec];
#pragma unroll
        for (int v = 0; v < kVec; v += 2) {
            const ulonglong2 k2 =
                __ldcg(reinterpret_cast<const ulonglong2*>(a.zbuf + f0 + v));
            key[v] = k2.x;
            key[v + 1] = k2.y;
        }
        float hit[kVec], coll[kVec];
        bool ok[kVec];
#pragma unroll
        for (int v = 0; v < kVec; ++v) {
            const bool h = key[v] != kEmpty;
            const bool near = key_depth(key[v]) < 1000.0f;   // false for NaN
            hit[v] = h ? 1.0f : 0.0f;
            coll[v] = h && !near ? 1.0f : 0.0f;
            ok[v] = h && near;
        }
        store_vec(a.valid + f0, hit);
        store_vec(a.collision + f0, coll);
        const float* ob = a.obj + (size_t)b * a.c * a.n;
        float* oo = a.out + (size_t)b * a.c * a.n + p0;
        // every load of a group of planes before its stores
        for (int c0 = 0; c0 < a.c; c0 += kPlanes) {
            float g[kPlanes][kVec];
#pragma unroll
            for (int k = 0; k < kPlanes; ++k)
#pragma unroll
                for (int v = 0; v < kVec; ++v)
                    g[k][v] = c0 + k < a.c && ok[v]
                        ? __ldg(ob + (size_t)(c0 + k) * a.n + (unsigned)key[v])
                        : 0.0f;
#pragma unroll
            for (int k = 0; k < kPlanes; ++k)
                if (c0 + k < a.c) store_vec(oo + (size_t)(c0 + k) * a.n, g[k]);
        }
    }
}

__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
warp_kernel(const WarpArgs a) {
    cg::grid_group grid = cg::this_grid();
    const unsigned lane = threadIdx.x & 31;
    const unsigned first = blockIdx.x * kThreads + threadIdx.x;
    const unsigned stride = gridDim.x * kThreads;
    // phases 0 and 2: a lane's unit u is pixels u * kVec ... + kVec - 1
    const unsigned units = (a.total + kVec - 1) / kVec;
    // phase 1: every lane of a warp takes the same steps, the loop runs
    // while the warp's first pixel is in range
    const unsigned end = (a.total + 31) & ~31u;

    // phase 0: the z-buffer to ~0
    for (unsigned u = first; u < units; u += stride) {
        const unsigned f0 = u * kVec;
        if constexpr (kVec > 1) {
            if (a.vec) {
#pragma unroll
                for (int v = 0; v < kVec; v += 2)
                    *reinterpret_cast<ulonglong2*>(a.zbuf + f0 + v) =
                        make_ulonglong2(kEmpty, kEmpty);
                continue;
            }
        }
#pragma unroll
        for (int v = 0; v < kVec; ++v)
            if (f0 + v < a.total) a.zbuf[f0 + v] = kEmpty;
    }
    grid.sync();

    // phase 1: the z-test, a pixel a lane a step
    for (unsigned f = first; f < end; f += stride) {
        const bool in = f < a.total;
        const unsigned b = f / a.n;
        const unsigned p = f - b * a.n;
        const int y = (int)(p / a.w);
        const int x = (int)p - y * a.w;
        const float* fx = a.flow + f + b * a.n;   // [b, 0, p]
        // clamp then truncate (>= 0 after the clamp)
        const float px = fminf(fmaxf((float)x + (in ? __ldg(fx) : 0.0f), 0.0f),
                               (float)(a.w - 1));
        const float py = fminf(fmaxf((float)y + (in ? __ldg(fx + a.n) : 0.0f),
                                     0.0f), (float)(a.h - 1));
        const unsigned tgt = in
            ? b * a.n + (unsigned)((int)py * a.w + (int)px) : kNoTarget;
        unsigned long long key =
            ((unsigned long long)sortable_u32(in ? __ldg(a.depth + f) : 0.0f)
             << 32) | p;
        // group the warp's lanes by target where a lane shares one with
        // the lane 1 or 2 below it (a pile-up); elsewhere each lane stands
        // alone
        const unsigned up1 = __shfl_up_sync(kFull, tgt, 1);
        const unsigned up2 = __shfl_up_sync(kFull, tgt, 2);
        unsigned peers = 1u << lane;
        if (__any_sync(kFull, tgt != kNoTarget
                                  && ((lane >= 1 && up1 == tgt)
                                      || (lane >= 2 && up2 == tgt)))) {
            peers = __match_any_sync(kFull, tgt);
            const unsigned most = __reduce_max_sync(
                kFull, tgt == kNoTarget ? 1u : (unsigned)__popc(peers));
            key = group_min(peers, key, lane, 32 - __clz(most - 1),
                            a.plant_fault == 1);
        }
        if (tgt == kNoTarget || __ffs(peers) - 1 != (int)lane) continue;
        // where sources pile up (a group, a border target that gathers the
        // clamped ones), a load first: the atomic only if it lowers
        const bool hot = peers != 1u << lane || px == 0.0f || py == 0.0f
            || px == (float)(a.w - 1) || py == (float)(a.h - 1);
        if (!hot || key < a.zbuf[tgt]) atomicMin(a.zbuf + tgt, key);
    }
    grid.sync();

    // phase 2: a target's key gives valid, collision and the winner
    for (unsigned u = first; u < units; u += stride) {
        const unsigned f0 = u * kVec;
        if (kVec > 1 && a.vec) {
            gather_vec(a, f0);
            continue;
        }
#pragma unroll
        for (int v = 0; v < kVec; ++v)
            if (f0 + v < a.total) gather_one(a, f0 + v);
    }
}

}  // namespace

// obj [B, C, H, W], flow [B, 2, H, W], depth [B, 1, H, W] f32, contiguous;
// zbuf B*H*W u64 scratch; out [B, C, H, W], valid and collision [B, 1, H,
// W]; B*H*W < 2^31. `blocks` persistent blocks (ops/forward_warp.py:plan;
// at most kBlocksPerSm a SM, or the cooperative launch is refused). The
// vector loads and stores where H*W is a multiple of kVec and their
// pointers are aligned to them.
// Returns the CUDA error of the launch (0 on success).
extern "C" int ofd_forward_warp(const void* obj, const void* flow,
                                const void* depth, void* zbuf, void* out,
                                void* valid, void* collision, int b, int c,
                                int h, int w, int blocks, int plant_fault,
                                void* stream) {
    WarpArgs a;
    a.obj = static_cast<const float*>(obj);
    a.flow = static_cast<const float*>(flow);
    a.depth = static_cast<const float*>(depth);
    a.zbuf = static_cast<unsigned long long*>(zbuf);
    a.out = static_cast<float*>(out);
    a.valid = static_cast<float*>(valid);
    a.collision = static_cast<float*>(collision);
    a.n = (unsigned)(h * w);
    a.total = (unsigned)b * a.n;
    a.w = w;
    a.h = h;
    a.c = c;
    a.plant_fault = plant_fault;
    const std::uintptr_t bits = reinterpret_cast<std::uintptr_t>(out)
        | reinterpret_cast<std::uintptr_t>(valid)
        | reinterpret_cast<std::uintptr_t>(collision);
    a.vec = kVec > 1 && a.n % kVec == 0 && bits % (4 * kVec) == 0
        && reinterpret_cast<std::uintptr_t>(zbuf) % 16 == 0;
    if (a.total == 0) return 0;
    void* args[] = {&a};
    cudaError_t err = cudaLaunchCooperativeKernel(
        reinterpret_cast<const void*>(warp_kernel), dim3(blocks),
        dim3(kThreads), args, 0, static_cast<cudaStream_t>(stream));
    if (err != cudaSuccess) return err;
    return cudaGetLastError();
}
